"""Port parity: L-BFGS with the zoom linesearch against ``optax.lbfgs``.

- The optimizer alone on float64 quadratics and Rosenbrock functions, 10
  steps, against optax under ``jax.enable_x64`` (a context manager, so
  that no other test sees 64-bit mode): parameters rtol 1e-10 and the
  same linesearch trial count every step. Both sides do the same float64
  arithmetic, the inner products summed in another order.
- Three SceneNet steps through the port's ``Trainer(optimizer="lbfgs")``
  against the JAX ``Trainer`` on the same batches: parameters rtol 1e-5
  and the same trial counts. Both run in float32, where the loss's sums
  over 4096 voxels round in another order (about 1e-6 relative); the seed
  is one whose every linesearch decision sits further than 1e-4 (relative,
  a hundred times that rounding) from its threshold, which the test
  asserts, so that rounding cannot flip a decision.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu.train import metrics as jmetrics
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train import TrainConfig, Trainer
from scenenet_tpu_torch.train import metrics as tmetrics
from scenenet_tpu_torch.train.lbfgs import LBFGS, ZoomLinesearch
from scenenet_tpu_torch.train.state import optimizer_needs_value_fn, resolve_optimizer

KS = (9, 5, 5)
GRID = 16
SEED = 3  # a draw whose linesearch decisions are all clear of f32 rounding (asserted)
LR = 0.8  # experiments/admm.yaml's
CRIT = dict(tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


def _quadratic(n=8, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, n))
    a, b = m @ m.T + n * np.eye(n), rng.normal(size=n)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    return (lambda x: 0.5 * x @ jnp.asarray(a) @ x - jnp.asarray(b) @ x,
            lambda x: 0.5 * x @ at @ x - bt @ x, rng.normal(size=n))


def _rosenbrock():
    return (lambda x: jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2),
            lambda x: torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2),
            np.array([-1.2, 1.0, -1.2, 1.0, 0.5]))


def _ls_state(opt_state):
    """The zoom linesearch's state inside optax.lbfgs's chain state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "info") and hasattr(s, "learning_rate"))
        if hasattr(s, "info")]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("problem,lr", [("quadratic", 1.0), ("quadratic", 5.0),
                                        ("rosenbrock", 1.0), ("rosenbrock", 0.8)])
def test_lbfgs_matches_optax_in_float64(problem, lr):
    f_jax, f_torch, x0 = _quadratic() if problem == "quadratic" else _rosenbrock()
    want, want_trials = [], []
    with jax.enable_x64(True):
        opt = optax.lbfgs(lr)
        p = jnp.asarray(x0, jnp.float64)
        state = opt.init(p)
        value_and_grad = jax.value_and_grad(f_jax)
        for _ in range(10):
            v, g = value_and_grad(p)
            u, state = opt.update(g, state, p, value=v, grad=g, value_fn=f_jax)
            p = optax.apply_updates(p, u)
            want.append(np.asarray(p))
            want_trials.append(int(_ls_state(state).info.num_linesearch_steps))
    w = torch.nn.Parameter(torch.tensor(x0, dtype=torch.float64))
    port = LBFGS([w], lr)

    def closure():
        port.zero_grad()
        v = f_torch(w)
        v.backward()
        return v.detach()

    got, trials = [], []
    for _ in range(10):
        v = closure()
        port.step(closure, v)
        got.append(w.detach().numpy().copy())
        trials.append(port.trials)
    assert trials == want_trials
    assert max(want_trials) >= 1 and port.evaluations == sum(trials)
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-300, err_msg=f"step {step}")
    if (problem, lr) == ("quadratic", 5.0):
        assert max(want_trials) > 1, "a long first step must make the search zoom"


def test_zoom_linesearch_phases_on_a_line():
    """The linesearch alone on φ(η) = f(w + η·d) for a quartic with a far
    minimum (the interval search doubles) and a near one (the zoom
    interpolates), against optax's ``zoom_linesearch`` in float64."""
    from optax._src.linesearch import zoom_linesearch

    for scale in (0.05, 40.0):
        def phi(eta, scale=scale):
            t = eta * scale - 3.0
            return 0.25 * t ** 4 - t

        with jax.enable_x64(True):
            init, step, cond = zoom_linesearch(max_linesearch_steps=20)
            vg = jax.value_and_grad(lambda w: phi(w[0]))
            w0 = jnp.zeros(1, jnp.float64)
            d = jnp.ones(1, jnp.float64)
            v0, g0 = vg(w0)
            state = init(d, w0, value=v0, grad=g0, initial_guess_strategy="one")
            while bool(cond(state)):
                state = step(state, value_and_grad_fn=vg, fn_kwargs={})
            want_eta, want_count = float(state.stepsize), int(state.count)
        ls = ZoomLinesearch(np.float64)
        dphi = jax.grad(phi)
        with jax.enable_x64(True):
            eta, count = ls.run(lambda e: (float(phi(float(e))), float(dphi(float(e)))),
                                float(phi(0.0)), float(dphi(0.0)))
        assert count == want_count
        np.testing.assert_allclose(float(eta), want_eta, rtol=1e-12)


def test_resolve_optimizer_lbfgs():
    net = SceneNet.create(kernel_size=(3, 3, 3), seed=0)
    opt = resolve_optimizer("lbfgs", net.parameters(), 0.5)
    assert isinstance(opt, LBFGS) and optimizer_needs_value_fn("lbfgs")
    assert optimizer_needs_value_fn(opt) and not optimizer_needs_value_fn("adam")
    # frozen parameters stay out of the optimizer
    assert len(opt.plist) == net.num_trainable_params() < net.num_total_params()


def _grid_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [((rng.random((2, 1, GRID, GRID, GRID)) > 0.9).astype(np.float32),
             (rng.random((2, 1, GRID, GRID, GRID)) > 0.97).astype(np.float32))
            for _ in range(n)]


def _margins(ls: ZoomLinesearch):
    """Each decision of the last search, as its distance from its threshold
    relative to the value or the slope it is measured against."""
    v0, s0 = float(ls.value_init), float(ls.slope_init)
    out, prev = [], v0
    for i, (eta, v, s) in enumerate(ls.trace):
        eta, v, s = float(eta), float(v), float(s)
        out += [(v - v0 - 1e-4 * eta * s0) / abs(v0),        # Armijo
                (v - v0 - 1e-6 * abs(v0)) / abs(v0),          # near-minimum decrease
                (s - (2e-4 - 1.0) * s0) / abs(s0),            # approximate Wolfe
                (abs(s) - 0.9 * abs(s0)) / abs(s0),           # curvature
                s / abs(s0)]                                  # the slope's sign
        if i:
            out.append((v - prev) / abs(v0))                  # against the last trial
        prev = v
    return out


def test_three_lbfgs_steps_match_jax_trainer(tmp_path):
    batches = _grid_batches()
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=SEED, backend="xla")
    jtrainer = JaxTrainer(jnet, jax_criterion("focal_tversky")(**CRIT), JaxTrainConfig(
        run_dir=str(tmp_path / "rj"), checkpoint_dir=str(tmp_path / "cj"),
        optimizer="lbfgs", learning_rate=LR, early_stop_metric=None))
    state, tx = create_train_state(jparams, "lbfgs", LR, jnet.trainable_mask(jparams))
    step, _ = jtrainer._build_steps(tx)
    want, want_trials, want_losses = [], [], []
    for x, y in batches:
        state, _, loss, _ = step(state, jmetrics.init_metric_state(), jnp.asarray(x),
                                 jnp.asarray(y))
        want_trials.append(int(_ls_state(state.opt_state).info.num_linesearch_steps))
        want_losses.append(float(loss))
        want.append({".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]})

    net = SceneNet.create(kernel_size=KS, seed=SEED)
    trainer = Trainer(net, resolve_criterion("focal_tversky")(**CRIT), TrainConfig(
        run_dir=str(tmp_path / "rt"), checkpoint_dir=str(tmp_path / "ct"),
        optimizer="lbfgs", learning_rate=LR, early_stop_metric=None))
    trainer.setup_optimizer()
    margins = []
    for i, (x, y) in enumerate(batches):
        _, loss = trainer.train_step(tmetrics.init_metric_state(), torch.from_numpy(x),
                                     torch.from_numpy(y))
        assert trainer.optimizer.trials == want_trials[i], f"step {i}"
        margins += _margins(trainer.optimizer.linesearch)
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=1e-5)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[i][name], rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {name}")
    assert min(abs(m) for m in margins) > 1e-4, sorted(abs(m) for m in margins)[:3]
    assert sum(want_trials) >= 3
