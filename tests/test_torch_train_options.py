"""Port parity: the training options of the ported models in torch vs the
JAX package — quantile training (streamed and through the grid cache),
gradient accumulation (``optax.MultiSteps``), ``precision: bf16`` for
SceneNet, ``Trainer.predict``, the smart GENEO init and the observer
responses.

At the small size of ``tests/test_torch_train.py`` (16³ grid, batch 2,
4096 padded points, kernel (9,5,5), the defaults' criterion weights), on
the CPU, where a cached step runs eagerly; on a card the captured steps
are held against eager ones by ``tests/test_torch_cuda.py`` and the smoke.

Tolerances: f32 losses and parameters rtol 1e-5 (atol 1e-6 for the
parameters that end near 0), confusion counts exact. Accumulation is held
at the same rtol: the running mean ``acc + (g − acc)/(n + 1)`` is taken
in optax's order. bf16 against the JAX package's bf16 at the JAX
package's own bf16-vs-f32 budget (loss rtol 5e-2, prediction atol 3e-2,
``tests/test_train.py``), with the distance measured stated where it is
held. Adam's first step moves a parameter by about lr·sign(g), so the
quantile seed is one whose every nonzero gradient of every member is at
least 1e-6 (asserted); a gradient that is exactly 0 (a clamped cone_inc)
moves nothing in either package.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import scenenet_tpu.train.loop as jax_loop
from scenenet_tpu.data import PointPadding as JaxPointPadding
from scenenet_tpu.data import TS40K as JaxTS40K
from scenenet_tpu.data.device_cache import DeviceGridCache as JaxGridCache
from scenenet_tpu.data.device_cache import DevicePointCache as JaxPointCache
from scenenet_tpu.data.loader import Subset as JaxSubset
from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import GENEONet as JaxGENEONet
from scenenet_tpu.models import QuantileSceneNet as JaxQuantileSceneNet
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.ops.conv3d import geneo_conv as jax_geneo_conv
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu.train import make_device_voxelize_prep as jax_prep
from scenenet_tpu.train import metrics as jmetrics
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu_torch.data import PointCloudLoader, PointPadding, Subset, TS40K
from scenenet_tpu_torch.data.device_cache import DeviceGridCache, DevicePointCache
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import GENEONet, QuantileSceneNet, SceneNet
from scenenet_tpu_torch.ops.conv3d import geneo_conv
from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train import metrics as tmetrics
from scenenet_tpu_torch.train.state import MultiSteps, cast_half

GRID = (16, 16, 16)
KS = (9, 5, 5)
MAX_POINTS = 4096
LR = 1e-3
SEED = 55            # SceneNet: every first gradient well away from 0
QSEED = 62           # QuantileSceneNet (members 62, 63, 64): see the module docstring
QUANTILES = (0.1, 0.5, 0.9)
DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)
QKW = dict(DEFAULTS, quantiles=QUANTILES)
ONE_BATCH = [1, 5]  # a cache of one batch: the epoch's permutation only reorders it


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts40k_options")
    rng = np.random.default_rng(0)
    for split, n in [("fit", 8), ("test", 2)]:
        (root / split).mkdir()
        for i in range(n):
            m = int(rng.integers(2000, 4000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return str(root)


@pytest.fixture(scope="module")
def batches(dataset):
    ds = TS40K(dataset, "fit", transform=PointPadding(max_points=MAX_POINTS,
                                                      compute_indices=False))
    return list(PointCloudLoader(ds, 2, shuffle=True, num_workers=1, seed=0, drop_last=True))


def _jflat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _losses(run_dir):
    return [json.loads(line)["train_loss"] for line in open(run_dir / "metrics.jsonl")
            if "train_loss" in json.loads(line)]


def _model(kind, backend="torch"):
    if kind == "quantile":
        return QuantileSceneNet.create(kernel_size=KS, seed=QSEED, quantiles=QUANTILES,
                                       backend=backend)
    return SceneNet.create(kernel_size=KS, seed=SEED, backend=backend)


def _jax_model(kind, backend="xla"):
    if kind == "quantile":
        return JaxQuantileSceneNet.create(kernel_size=KS, seed=QSEED, quantiles=QUANTILES,
                                          backend=backend)
    return JaxSceneNet.create(kernel_size=KS, seed=SEED, backend=backend)


def _criterion_name(kind):
    return "quantile_geneo" if kind == "quantile" else "geneo_tversky"


def _port_trainer(tmp_path, kind, tag="port", backend="torch", **cfg):
    cfg.setdefault("max_epochs", 1)
    config = TrainConfig(run_dir=str(tmp_path / f"run_{tag}"),
                         checkpoint_dir=str(tmp_path / f"ckpt_{tag}"), learning_rate=LR,
                         early_stop_metric=None, **cfg)
    return Trainer(_model(kind, backend), resolve_criterion(_criterion_name(kind))(**QKW),
                   config, batch_prep=make_device_voxelize_prep(GRID, (15,), use_indices=False))


def _jax_trainer(tmp_path, kind, backend="xla", **cfg):
    cfg.setdefault("max_epochs", 1)
    jnet, jparams = _jax_model(kind, backend)
    config = JaxTrainConfig(run_dir=str(tmp_path / "run_jax"),
                            checkpoint_dir=str(tmp_path / "ckpt_jax"), learning_rate=LR,
                            early_stop_metric=None, **cfg)
    trainer = JaxTrainer(jnet, jax_criterion(_criterion_name(kind))(**QKW), config,
                         batch_prep=jax_prep(GRID, (15,), use_indices=False))
    return trainer, jnet, jparams


def _param_items(model):
    """(JAX flat name, member index or None, parameter) of every parameter."""
    if isinstance(model, QuantileSceneNet):
        return [(n, q, p) for q, m in enumerate(model.members) for n, p in m.named_parameters()]
    return [(n, None, p) for n, p in model.named_parameters()]


def _assert_params(model, want):
    for name, q, p in _param_items(model):
        ref = want[name] if q is None else want[name][q]
        np.testing.assert_allclose(float(p.detach()), ref, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {q}")


class _CountsOfFit:
    """Patches the JAX loop's ``compute_metrics`` to keep every epoch's
    confusion counts (its fits return the scores only)."""

    def __enter__(self):
        self.counts = []
        orig = jax_loop.compute_metrics
        self.patch = pytest.MonkeyPatch()
        self.patch.setattr(jax_loop, "compute_metrics", lambda m, b: (
            self.counts.append(jmetrics.metric_counts(m)), orig(m, b))[1])
        return self.counts

    def __exit__(self, *exc):
        self.patch.undo()


# ---- quantile training ------------------------------------------------------------

def test_quantile_seed_gradients_are_away_from_zero(batches):
    """The seed's premise: every nonzero first gradient of every member is
    at least 1e-6, so Adam's first step takes the same sign in both."""
    net = _model("quantile")
    x, y = make_device_voxelize_prep(GRID, (15,), use_indices=False)(*(torch.as_tensor(a) for a in batches[0]))
    crit = resolve_criterion("quantile_geneo")(**QKW)
    crit(net(x), y, net.cvx_coefficients(), net.geneo_params_flat(),
         net.last_lambda).backward()
    grads = [abs(float(p.grad)) for _, _, p in _param_items(net) if p.requires_grad]
    assert min(g for g in grads if g != 0) >= 1e-6
    assert sum(g != 0 for g in grads) >= len(grads) - 3


@pytest.fixture(scope="module")
def jax_quantile_steps(batches, tmp_path_factory):
    """Three JAX train steps of the quantile ensemble: loss and counts a
    step, and the parameters after them."""
    trainer, jnet, jparams = _jax_trainer(tmp_path_factory.mktemp("jq"), "quantile")
    state, tx = create_train_state(jparams, "adam", LR, jnet.trainable_mask(jparams))
    step, _ = trainer._build_steps(tx)
    losses, counts = [], []
    for b in batches[:3]:
        state, m, loss, _ = step(state, jmetrics.init_metric_state(),
                                 *(jnp.asarray(a) for a in b))
        losses.append(float(loss))
        counts.append(jmetrics.metric_counts(m))
    return losses, counts, _jflat(state.params)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_three_quantile_train_steps_match_jax(backend, batches, jax_quantile_steps, tmp_path):
    """Each member through its own conv (K2 forward and K4 for dk on the
    kernel backend, their plain versions here), the members' penalties
    summed; member 0's trainable mask for every member."""
    want_losses, want_counts, want_params = jax_quantile_steps
    trainer = _port_trainer(tmp_path, "quantile", backend=backend)
    trainer.setup_optimizer()
    for i, b in enumerate(batches[:3]):
        m, loss = trainer.train_step(tmetrics.init_metric_state(), *trainer.to_device(b))
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=1e-5)
        assert tmetrics.metric_counts(m) == want_counts[i]
    assert sum(c[0] for c in want_counts) > 0  # some tower voxels predicted
    _assert_params(trainer.model, want_params)
    frozen = {n for n, _, p in _param_items(trainer.model) if not p.requires_grad}
    assert frozen == {n for n, ok in _jflat(trainer.model.trainable_mask()).items() if not ok}


def test_quantile_fit_matches_jax(batches, tmp_path):
    """Trainer.fit over 3 batches (one epoch) with validation: the epoch's
    loss and counts, the final parameters, the stacked checkpoint."""
    jt, _, jparams = _jax_trainer(tmp_path, "quantile")
    with _CountsOfFit() as want_counts:
        want_params, want_best = jt.fit(jparams, batches[:3], val_loader=batches[3:])
    trainer = _port_trainer(tmp_path, "quantile")
    _, best = trainer.fit(batches[:3], val_loader=batches[3:])
    np.testing.assert_allclose(best["train_loss"], want_best["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(best["val_loss"], want_best["val_loss"], rtol=1e-5)
    assert trainer.train_counts == want_counts[:1]
    _assert_params(trainer.model, _jflat(want_params))
    with np.load(tmp_path / "ckpt_port" / "last.npz") as data:
        assert data["geneo/cy_0/radius"].shape == (len(QUANTILES),)


def _jax_grid_fit(dataset, tmp_path, kind, samples, **cfg):
    trainer, _, jparams = _jax_trainer(tmp_path, kind, max_epochs=cfg.pop("max_epochs", 3),
                                       **cfg)
    jds = JaxSubset(JaxTS40K(dataset, "fit", transform=JaxPointPadding(
        max_points=MAX_POINTS, compute_indices=False)), samples)
    with _CountsOfFit() as counts:
        params, _ = trainer.fit_grid_cached(
            jparams, JaxGridCache(JaxPointCache(jds), jax_prep(GRID, (15,), use_indices=False)),
            batch_size=2, augment=False, key=jax.random.PRNGKey(0))
    return _losses(tmp_path / "run_jax"), counts, _jflat(params)


def _port_grid_fit(dataset, tmp_path, kind, samples, **cfg):
    cfg.setdefault("max_epochs", 3)
    trainer = _port_trainer(tmp_path, kind, **cfg)
    cache = DevicePointCache(Subset(TS40K(dataset, "fit", transform=PointPadding(
        max_points=MAX_POINTS, compute_indices=False)), samples), "cpu")
    trainer.fit_grid_cached(DeviceGridCache(cache, trainer.batch_prep), batch_size=2,
                            augment=False, generator=torch.Generator().manual_seed(0))
    return trainer


def test_quantile_grid_cached_fit_matches_jax(dataset, tmp_path):
    """fit_grid_cached on a one-batch cache, 3 epochs (3 steps): per-epoch
    losses and counts, and the parameters, against the JAX package's."""
    want_losses, want_counts, want_params = _jax_grid_fit(dataset, tmp_path, "quantile",
                                                          ONE_BATCH)
    trainer = _port_grid_fit(dataset, tmp_path, "quantile", ONE_BATCH)
    assert trainer.step == 3 and trainer.cached_epochs.runner.eager_calls == 3
    np.testing.assert_allclose(_losses(tmp_path / "run_port"), want_losses, rtol=1e-5)
    assert trainer.train_counts == want_counts
    _assert_params(trainer.model, want_params)


# ---- gradient accumulation (optax.MultiSteps) ---------------------------------------

@pytest.mark.parametrize("k,epochs", [(2, 1), (3, 2)])
def test_accumulated_fit_matches_jax_multisteps(k, epochs, batches, tmp_path):
    """accumulate_grad_batches=k over 4 batches an epoch: the epoch's
    losses and counts every call, the update every k-th, carried over the
    epoch's end (k=3: updates at calls 3 and 6 of 8)."""
    jt, _, jparams = _jax_trainer(tmp_path, "scenenet", accumulate_grad_batches=k,
                                  max_epochs=epochs)
    with _CountsOfFit() as want_counts:
        want_params, _ = jt.fit(jparams, batches[:4])
    trainer = _port_trainer(tmp_path, "scenenet", accumulate_grad_batches=k,
                            max_epochs=epochs)
    trainer.fit(batches[:4])
    assert trainer.step == 4 * epochs and trainer.multi_steps.calls == (4 * epochs) % k
    np.testing.assert_allclose(_losses(tmp_path / "run_port"), _losses(tmp_path / "run_jax"),
                               rtol=1e-5)
    assert trainer.train_counts == want_counts
    _assert_params(trainer.model, _jflat(want_params))


def test_accumulated_grid_cached_fit_matches_jax(dataset, tmp_path):
    """The cached route under accumulate_grad_batches=2: a one-batch cache,
    4 epochs, so every update takes the mean of two epochs' gradients."""
    want_losses, want_counts, want_params = _jax_grid_fit(
        dataset, tmp_path, "scenenet", ONE_BATCH, max_epochs=4,
        accumulate_grad_batches=2)
    trainer = _port_grid_fit(dataset, tmp_path, "scenenet", ONE_BATCH, max_epochs=4,
                             accumulate_grad_batches=2)
    epochs = trainer.cached_epochs
    assert epochs.runner.eager_calls == epochs.accumulate_runner.eager_calls == 2
    np.testing.assert_allclose(_losses(tmp_path / "run_port"), want_losses, rtol=1e-5)
    assert trainer.train_counts == want_counts
    _assert_params(trainer.model, want_params)


def test_multisteps_running_mean_moves_nothing_between_updates():
    """The mean in optax's order, the parameters and Adam's step count still
    between updates, one update of the mean at every k-th call."""
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = torch.optim.Adam([w], lr=0.1)
    ms = MultiSteps(opt, 3)
    grads = [torch.tensor([0.3, -0.7]), torch.tensor([0.1, 0.2]), torch.tensor([-0.9, 0.4])]
    acc = torch.zeros(2)
    for n, g in enumerate(grads):
        w.grad = g.clone()
        apply = ms.advance()
        assert apply == (n == 2)
        ms.step(apply)
        acc = acc + (g - acc) / (n + 1)
        if not apply:
            assert torch.equal(w.detach(), torch.tensor([1.0, -2.0])) and not opt.state
    assert torch.equal(w.grad, acc)  # the update took the mean
    assert int(opt.state[w]["step"]) == 1 and float(ms.count) == 0 and ms.calls == 0
    assert not any(a.any() for a in ms.acc)


# ---- precision: bf16 ------------------------------------------------------------------

def _interpret_pallas():
    """The JAX package's Pallas conv in interpret mode (its CPU form)."""
    import scenenet_tpu.ops.pallas_conv as pc

    orig = pc.fused_geneo_conv
    patch = pytest.MonkeyPatch()
    patch.setattr(pc, "fused_geneo_conv", lambda x_, k_, interpret=False: orig(x_, k_, True))
    return patch


@pytest.mark.parametrize("backend,jax_backend", [("torch", "xla"), ("cuda", "pallas")])
def test_bf16_loss_and_pred_match_jax_bf16(backend, jax_backend, batches, tmp_path):
    """Trainer._loss under precision bf16: kernel synthesis on bf16 copies
    of the parameters, x in bf16; the conv in bf16 (torch/xla) or in f32
    on the widened kernel (cuda/pallas); pred back in f32, the loss on the
    f32 masters. Held against the JAX package's bf16 loss and prediction
    far inside that package's own bf16 budget (loss rtol 5e-2, prediction
    atol 3e-2): measured on these batches, the predictions are
    bit-identical (torch/xla) or 1.8e-7 apart (cuda/pallas), the losses
    1.9e-5 apart relative (f32 sums over the grid in another order), where
    JAX's own bf16 and f32 predictions are 0.036 apart."""
    jt, jnet, jparams = _jax_trainer(tmp_path, "scenenet", jax_backend, precision="bf16")
    j32, _, _ = _jax_trainer(tmp_path, "scenenet", jax_backend)
    trainer = _port_trainer(tmp_path, "scenenet", backend=backend, precision="bf16")
    prep = make_device_voxelize_prep(GRID, (15,), use_indices=False)
    patch = _interpret_pallas()
    try:
        for b in batches[:2]:
            x, y = prep(*(torch.as_tensor(a) for a in b))
            jl, (jp, _) = jt._loss(jparams, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
            jl32, (jp32, _) = j32._loss(jparams, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
            loss, pred = trainer._loss(x, y)
            assert pred.dtype == torch.float32 and float(pred.detach().max()) > 0
            np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
            np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jp), rtol=0,
                                       atol=1e-6)
            # no farther from JAX's bf16 than JAX's bf16 is from its f32
            d_port = np.abs(pred.detach().numpy() - np.asarray(jp)).max()
            d_jax = np.abs(np.asarray(jp32) - np.asarray(jp)).max()
            assert d_port <= max(d_jax, 1e-6), (d_port, d_jax)
            loss.backward()
            for n, p in trainer.model.named_parameters():
                if p.requires_grad:
                    assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad), n
    finally:
        patch.undo()


def test_bf16_train_steps_match_jax_bf16(batches, tmp_path):
    """Three bf16 train steps: the losses against the JAX package's jitted
    bf16 steps within rtol 5e-3, a tenth of its budget of 5e-2 (measured
    4.0e-4, 2.2e-3, 2.1e-3: under jit XLA fuses kernel synthesis's bf16
    operations and rounds them in another order than its op-by-op form,
    which the port matches to 1.9e-5, and a master that an update moves
    across a bf16 rounding boundary then differs by one bf16 ulp); the f32
    masters stay f32."""
    jt, jnet, jparams = _jax_trainer(tmp_path, "scenenet", precision="bf16")
    state, tx = create_train_state(jparams, "adam", LR, jnet.trainable_mask(jparams))
    step, _ = jt._build_steps(tx)
    trainer = _port_trainer(tmp_path, "scenenet", precision="bf16")
    trainer.setup_optimizer()
    for b in batches[:3]:
        state, jm, jloss, _ = step(state, jmetrics.init_metric_state(),
                                   *(jnp.asarray(a) for a in b))
        m, loss = trainer.train_step(tmetrics.init_metric_state(), *trainer.to_device(b))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-3)
    for n, p in trainer.model.named_parameters():
        assert p.dtype == torch.float32, n


def test_cast_half_copies_floats_only():
    params = {"a": torch.ones(2, requires_grad=True), "i": torch.arange(3)}
    half = cast_half(params)
    assert half["a"].dtype == torch.bfloat16 and half["i"] is params["i"]
    half["a"].float().sum().backward()
    assert params["a"].grad.dtype == torch.float32


# ---- predict, smart init, observer responses -------------------------------------------

@pytest.mark.parametrize("kind", ["scenenet", "quantile"])
def test_predict_matches_jax(kind, batches, tmp_path):
    """Trainer.predict: the batch prep and the eval forward, numpy out, the
    same arrays as the JAX package's predict within 1e-5; without a batch
    prep it takes x as the batch."""
    jt, jnet, jparams = _jax_trainer(tmp_path, kind)
    trainer = _port_trainer(tmp_path, kind)
    got = list(trainer.predict(batches[:2]))
    want = list(jt.predict(jparams, batches[:2]))
    assert len(got) == len(want) == 2
    # on {0, 1} grids a voxel's conv differs by at most the L1 norm of the
    # two packages' folded-kernel difference (kernel synthesis rounds in
    # another order, ~2e-7 a tap), and relu∘tanh does not widen it: the
    # bound these dense grids (30–50% occupied) are held to, 1e-5 at most
    # for SceneNet's seed and 4e-5 for the quantile members'
    members = trainer.model.members if kind == "quantile" else [trainer.model]
    jmembers = ([(jnet.net, jax.tree.map(lambda a, q=q: a[q], jparams))
                 for q in range(len(QUANTILES))] if kind == "quantile" else [(jnet, jparams)])
    bound = 1e-6 + max(
        float((m.combined_kernel().detach() - torch.from_numpy(np.asarray(jnp.sum(
            jn.effective_lambdas(jp)[:, None, None, None] * jn.synthesize_kernels(jp),
            axis=0)))).abs().sum())
        for m, (jn, jp) in zip(members, jmembers))
    assert bound <= (4e-5 if kind == "quantile" else 1e-5)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=bound)
    grids = [make_device_voxelize_prep(GRID, (15,), use_indices=False)(*(torch.as_tensor(a) for a in b))
             for b in batches[:1]]
    bare = Trainer(trainer.model, trainer.criterion, trainer.config)
    np.testing.assert_array_equal(next(bare.predict([(grids[0][0], grids[0][1])])), got[0])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_smart_init_equals_jax(seed, version):
    """geneo_init: smart — the hand-tuned scalars, the λ draws from the seed:
    bit-identical to the JAX package's parameters."""
    net = SceneNet.create(kernel_size=KS, version=version, seed=seed, smart=True)
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, version=version, seed=seed, smart=True)
    want = _jflat(jparams)
    assert net.last_lambda == jnet.last_lambda
    assert set(net.state_dict()) == set(want)
    for n, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[n], err_msg=n)
    assert float(net.geneo["cone_0"]["apex"]) == 3.0


def _occupied(seed, shape=(2, 1, 12, 12, 12)):
    return (np.random.default_rng(seed).random(shape) > 0.85).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2])
def test_observer_responses_and_unfused_forward_match_jax(seed):
    """observer_responses (B, G, ...) and forward(fuse_observers=False)
    against the JAX package's within 1e-5; the unfused forward equals the
    fused one to f32 rounding; geneo_conv and the GENEONet alias too."""
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=seed)
    net = SceneNet.create(kernel_size=KS, seed=seed)
    x = _occupied(seed)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        resp = net.observer_responses(xt)
        unfused = net(xt, fuse_observers=False)
        fused = net(xt)
        masked = net(xt, tau=0.5, fuse_observers=False)
    assert resp.shape == (2, 3, 12, 12, 12)
    np.testing.assert_allclose(resp.numpy(), np.asarray(jnet.observer_responses(
        jparams, jnp.asarray(x))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(unfused.numpy(), np.asarray(jnet.apply(
        jparams, jnp.asarray(x), fuse_observers=False)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(masked, (unfused >= 0.5).float())
    kernels = net.synthesize_kernels().detach()
    np.testing.assert_allclose(geneo_conv(xt, kernels).numpy(), np.asarray(jax_geneo_conv(
        jnp.asarray(x), jnp.asarray(kernels.numpy()))), rtol=0, atol=1e-5)
    g, (jg, jgp) = GENEONet(kernel_size=KS, seed=seed), JaxGENEONet(kernel_size=KS, seed=seed)
    assert g.version == jg.version == "v1" and g.last_lambda == jg.last_lambda
    for n, v in g.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), _jflat(jgp)[n], err_msg=n)


def test_unfused_forward_trains_on_every_backend():
    """fuse_observers=False takes the plain conv on every backend (the JAX
    package's XLA conv): the parameter gradients agree across backends."""
    x = torch.from_numpy(_occupied(4))
    grads = []
    for backend in ("torch", "cuda", "cuda_mxu"):
        net = SceneNet.create(kernel_size=KS, seed=4, backend=backend)
        net(x, fuse_observers=False).sum().backward()
        grads.append([float(p.grad) for p in net.parameters() if p.requires_grad])
    assert grads[0] == grads[1] == grads[2]
