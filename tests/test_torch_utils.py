"""Port parity: the host utilities (viz, tower proposals, plots, profiling),
the wandb adapter and random sweeps, against the JAX package.

Every function here is host numpy in both packages, so the same inputs
(made from a numpy seed) give exactly the same arrays, PLY bytes,
proposals and series; the sweep draws are the same dicts. A two-draw
``--sweep`` through each package's train CLI names the same best draw.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from scenenet_tpu.cli import train as jax_cli
from scenenet_tpu.utils import plots as jplots
from scenenet_tpu.utils import profiling as jprof
from scenenet_tpu.utils import proposals as jprop
from scenenet_tpu.utils import viz as jviz
from scenenet_tpu.utils.config import sample_sweep as jax_sample_sweep
from scenenet_tpu.utils.logging import RunLogger as JaxRunLogger
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.utils import plots, profiling, proposals, viz
from scenenet_tpu_torch.utils.config import sample_sweep
from scenenet_tpu_torch.utils.logging import RunLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- viz ---------------------------------------------------------------------

def _grid(seed, shape=(16, 20, 24), signed=False):
    rng = np.random.default_rng(seed)
    g = rng.random(shape) * (rng.random(shape) > 0.7)
    return (2 * g - (g > 0)) if signed else g


@pytest.mark.parametrize("seed", [0, 1])
def test_viz_arrays_equal_jax(seed):
    g, s = _grid(seed), _grid(seed + 10, signed=True)
    for mode, grid in (("density", s), ("ranges", g)):
        for drop in (True, False):
            np.testing.assert_array_equal(viz.voxelgrid_to_points(grid, mode, drop),
                                          jviz.voxelgrid_to_points(grid, mode, drop))
    pred, gt = _grid(seed + 1) > 0.5, _grid(seed + 2) > 0.3
    np.testing.assert_array_equal(viz.pred_vs_gt_points(pred[None], gt),
                                  jviz.pred_vs_gt_points(pred[None], gt))
    xy = np.random.default_rng(seed).uniform(0, 16, (3, 2))
    np.testing.assert_array_equal(viz.proposals_to_points(xy, (2, 9)),
                                  jviz.proposals_to_points(xy, (2, 9)))
    assert viz.proposals_to_points(np.empty((0, 2))).shape == (0, 6)
    q = np.stack([_grid(seed + 3), _grid(seed + 3) + 0.2 * _grid(seed + 4)])
    np.testing.assert_array_equal(viz.quantile_uncertainty_points(q),
                                  jviz.quantile_uncertainty_points(q))
    with pytest.raises(ValueError, match="color_mode"):
        viz.voxelgrid_to_points(g, "jet")


@pytest.mark.parametrize("cols", [3, 6])
def test_write_ply_bytes_equal_jax(cols, tmp_path):
    pts = viz.voxelgrid_to_points(_grid(3, signed=True), "density")[:, :cols]
    viz.write_ply(str(tmp_path / "port.ply"), pts)
    jviz.write_ply(str(tmp_path / "jax.ply"), pts)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert len(pts) > 100


# ---- tower proposals ---------------------------------------------------------

def _tower_grid(shape, seed, towers=(), wall=None, noise=0.0):
    """A (Z, X, Y) probability grid: each tower a column of 3×3 voxels from
    z0 to z1 at (x, y), a wall a flat wide slab, random noise below τ."""
    rng = np.random.default_rng(seed)
    g = rng.random(shape) * noise
    for x, y, z0, z1 in towers:
        g[z0:z1, x - 1:x + 2, y - 1:y + 2] = 0.7 + 0.3 * rng.random((z1 - z0, 3, 3))
    if wall is not None:
        x0, x1, y0, y1, z0, z1 = wall
        g[z0:z1, x0:x1, y0:y1] = 0.9
    return g


CASES = {
    # one tower at the centre
    "one": ((32, 32, 32), dict(towers=[(16, 16, 2, 26)])),
    # two clusters in one column, apart in z: their centroids merge (<1.5)
    "merge": ((48, 32, 32), dict(towers=[(16, 16, 1, 15), (16, 17, 24, 44)])),
    # a tower and a flat wide wall (dropped by its height and xy extent)
    "wall": ((32, 32, 32), dict(towers=[(15, 17, 0, 24)], wall=(6, 26, 4, 7, 0, 4))),
    # a tower near the centre and one at the border (dropped)
    "border": ((32, 32, 32), dict(towers=[(17, 15, 0, 20), (2, 2, 0, 20)], noise=0.5)),
    # a non-cubic grid: the centre comes from dims 1 and 2
    "noncubic": ((24, 40, 28), dict(towers=[(20, 14, 0, 22), (21, 15, 0, 20)], noise=0.6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("density", [False, True])
def test_proposals_equal_jax(case, density):
    shape, kw = CASES[case]
    pred = _tower_grid(shape, 0, **kw)
    gt = _tower_grid(shape, 1, towers=kw["towers"])
    dens = (_tower_grid(shape, 2, noise=1.0) > 0.5).astype(float) if density else None
    got = proposals.get_tower_proposals(pred, density_grid=dens)
    want = jprop.get_tower_proposals(pred, density_grid=dens)
    np.testing.assert_array_equal(got, want)
    if not density:
        assert len(got) == {"one": 1, "merge": 1, "wall": 1, "border": 1,
                            "noncubic": 1}[case], got
    for a, b in zip(proposals.extract_towers_from_grid(pred, tau=0.65),
                    jprop.extract_towers_from_grid(pred, tau=0.65)):
        if isinstance(a, list):
            assert len(a) == len(b) and all(np.array_equal(p, q) for p, q in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)
    got_d = proposals.compute_euc_dists(pred, gt)
    want_d = jprop.compute_euc_dists(pred, gt)
    assert len(got_d) == len(want_d) > 0
    for (g1, p1, d1), (g2, p2, d2) in zip(got_d, want_d):
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_array_equal(p1, p2)
        assert d1 == d2


def test_proposals_empty_and_unmerged_equal_jax():
    empty = np.zeros((16, 16, 16))
    assert proposals.get_tower_proposals(empty).shape == (0, 2)
    c = np.random.default_rng(4).uniform(0, 10, (7, 3))
    np.testing.assert_array_equal(proposals.aggregate_centroids(c),
                                  jprop.aggregate_centroids(c))
    gt = _tower_grid((32, 32, 32), 0, towers=[(16, 16, 0, 20)])
    got, want = proposals.compute_euc_dists(empty, gt), jprop.compute_euc_dists(empty, gt)
    assert [(list(g), p, d) for g, p, d in got] == [(list(g), p, d) for g, p, d in want]
    assert got and got[0][1] is None


# ---- plots and profiling -----------------------------------------------------

def _run_logs(run_dir):
    rng = np.random.default_rng(0)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "params.jsonl"), "w") as f:
        for step in range(4):
            f.write(json.dumps({"step": step, "cy_0.radius": float(rng.random()),
                                "lambda_cy_0": float(rng.random()),
                                "grad/geneo/cy_0/radius": 0.5, "note": "x"}) + "\n")
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as f:
        for step in range(4):
            f.write(json.dumps({"step": step, "train_loss": float(rng.random()),
                                "val_FBetaScore": float(rng.random()),
                                "epoch_time_s": 1.0}) + "\n")


def test_plots_series_equal_jax(tmp_path):
    run = str(tmp_path / "run")
    _run_logs(run)
    for name in ("params.jsonl", "metrics.jsonl"):
        assert plots.load_series(os.path.join(run, name)) == \
            jplots.load_series(os.path.join(run, name))
    for fn in ("plot_lambda_trajectories", "plot_geneo_trajectories", "plot_metric_curves"):
        png = str(tmp_path / f"{fn}.png")
        got = getattr(plots, fn)(run, png)
        assert got == getattr(jplots, fn)(run) and got, fn
    assert set(plots.plot_metric_curves(run)) == {"train_loss", "val_FBetaScore"}


def test_plots_without_matplotlib_return_series(tmp_path, monkeypatch):
    run = str(tmp_path / "run")
    _run_logs(run)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    png = str(tmp_path / "none.png")
    assert plots.plot_lambda_trajectories(run, png) == jplots.plot_lambda_trajectories(run)
    assert not os.path.exists(png)


def test_step_timer_stats_equal_jax(monkeypatch):
    ticks = np.cumsum(np.random.default_rng(0).uniform(0.001, 0.02, 40)).tolist()
    timers = []
    for mod in (profiling, jprof):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        t = mod.StepTimer(window=7)
        assert t.stats() == {}
        for _ in range(20):
            t.start()
            t.stop()
        timers.append(t)
    assert timers[0].times == timers[1].times and len(timers[0].times) == 7
    assert timers[0].stats() == timers[1].stats()
    with pytest.raises(AssertionError, match="start"):
        profiling.StepTimer().stop()


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert [p for p in os.listdir(tmp_path / "tb") if p.endswith(".pt.trace.json")]
    # no card here: nothing to report, as JAX reports nothing for the CPU
    assert profiling.device_memory_stats() == {}


# ---- wandb -------------------------------------------------------------------

class _FakeRun:
    def __init__(self, calls):
        self.calls = calls

    def log(self, data, step=None):
        self.calls.append(("log", dict(data), step))

    def finish(self):
        self.calls.append(("finish",))


@pytest.fixture
def fake_wandb(monkeypatch):
    calls = []
    mod = types.ModuleType("wandb")

    def init(**kw):
        calls.append(("init", kw))
        return _FakeRun(calls)

    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return calls


def test_run_logger_mirrors_to_wandb_like_jax(fake_wandb, tmp_path):
    for cls, name in ((RunLogger, "port"), (JaxRunLogger, "jax")):
        logger = cls(str(tmp_path / name), use_wandb=True, wandb_kwargs={"project": "p"})
        logger.log_metrics({"train_loss": 0.5}, step=3)
        logger.log_params({"lambda_cy_0": 0.25}, step=3)
        logger.close()
    half = len(fake_wandb) // 2
    port, jax_calls = fake_wandb[:half], fake_wandb[half:]
    assert port[0] == ("init", {"dir": str(tmp_path / "port"), "project": "p"})
    assert port[1:] == jax_calls[1:] == [("log", {"train_loss": 0.5}, 3),
                                         ("log", {"lambda_cy_0": 0.25}, 3), ("finish",)]


def test_wandb_missing_prints_and_trains_on(tmp_path, monkeypatch, capsys):
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import TrainConfig, Trainer

    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    JaxRunLogger(str(tmp_path / "jax"), use_wandb=True).close()
    want = capsys.readouterr().out
    assert want.startswith("[RunLogger] wandb disabled (")
    cfg = TrainConfig(run_dir=str(tmp_path / "r"), checkpoint_dir=str(tmp_path / "c"),
                      max_epochs=2, early_stop_metric=None, use_wandb=True)
    trainer = Trainer(SceneNet.create(kernel_size=(3, 3, 3)), resolve_criterion("mse")(), cfg)
    assert capsys.readouterr().out == want
    rng = np.random.default_rng(0)
    grids = [tuple(torch.from_numpy((rng.random((2, 1, 8, 8, 8)) > p).astype(np.float32))
                   for p in (0.8, 0.95)) for _ in range(2)]
    _, best = trainer.fit(grids)
    assert trainer.step == 4 and np.isfinite(best["train_loss"])
    assert len(open(tmp_path / "r" / "metrics.jsonl").readlines()) == 2


# ---- sweeps ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_sweep_equals_jax(seed):
    path = os.path.join(ROOT, "experiments", "sweep.yaml")
    got = sample_sweep(path, 5, seed=seed)
    assert got == jax_sample_sweep(path, 5, seed=seed)
    assert len(got) == 5 and all(d["optimizer"] in ("adam", "sgd", "rmsprop") for d in got)
    assert all(1.0 <= d["convex_weight"] <= 10.0 for d in got)


def test_sample_sweep_fixed_and_integer_ranges(tmp_path):
    spec = tmp_path / "s.yaml"
    spec.write_text("parameters:\n  a: {min: 1, max: 4}\n  b: {value: 3}\n"
                    "  c: {values: [x, y]}\n  d: {min: 0.5, max: 1.5}\n")
    got = sample_sweep(str(spec), 6, seed=3)
    assert got == jax_sample_sweep(str(spec), 6, seed=3)
    assert all(isinstance(d["a"], int) and d["b"] == 3 for d in got)


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_ds")
    rng = np.random.default_rng(0)
    for split, n in (("fit", 5), ("test", 2)):
        (root / split).mkdir()
        for i in range(n):
            m = int(rng.integers(300, 500))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return str(root)


def test_sweep_cli_names_the_same_best_draw_as_jax(sweep_data, tmp_path, capsys):
    spec = os.path.join(ROOT, "experiments", "sweep.yaml")
    common = [f"data_path={sweep_data}", "batch_size=2", "voxel_grid_size=(8, 8, 8)",
              "max_points=512", "max_epochs=1", "num_workers=1", "kernel_size=(3, 3, 3)",
              "val_split=0.4"]
    best = tcli.main(["--device", "cpu", "--sweep", spec, "--sweep-runs", "2", "--set",
                      *common, f"output_dir={tmp_path / 'port'}"])
    port_out = capsys.readouterr().out
    jax_cli.main(["--sweep", spec, "--sweep-runs", "2", "--set", *common,
                  f"output_dir={tmp_path / 'jax'}"])
    jax_out = capsys.readouterr().out

    def lines(out, tag):
        return [ln for ln in out.splitlines() if ln.startswith(tag)]

    assert len(lines(port_out, "[sweep ")) == len(lines(jax_out, "[sweep ")) == 2
    assert [ln.split("draw=")[1] for ln in lines(port_out, "[sweep ")] == \
        [ln.split("draw=")[1] for ln in lines(jax_out, "[sweep ")]
    assert lines(port_out, "[sweep] best")[0].split(" with ")[1] == \
        lines(jax_out, "[sweep] best")[0].split(" with ")[1]
    assert best["best_draw"] in sample_sweep(spec, 2)
    for i in range(2):  # each draw is its own project
        assert os.path.isdir(tmp_path / "port" / f"scenenet_ts40k_sweep{i}")


# ---- the visualize CLI -------------------------------------------------------

def test_visualize_cli_equals_jax(sweep_data, tmp_path, capsys):
    """The same checkpoint and test split through both CLIs: the same PLYs
    byte for byte (the prediction's values agree within the f32 forward's
    1e-5; none sits within that of a color range's edge) and a summary.json
    with the same voxel counts and proposals (1e-9), as
    ``tests/test_cli.py::test_visualize_cli`` runs the JAX CLI."""
    from scenenet_tpu.cli import visualize as jax_visualize
    from scenenet_tpu_torch.cli import visualize
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train.checkpoint import save_checkpoint

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"data_path: {sweep_data}\nvoxel_grid_size: (24, 24, 24)\n"
                   "kernel_size: (9, 5, 5)\nseed: 2\n")
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, SceneNet.create(kernel_size=(9, 5, 5), seed=6))
    args = ["--config", str(cfg), "--checkpoint", ckpt, "--n", "2", "--tau", "0.5"]
    summary = visualize.main([*args, "--out", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    jax_visualize.main([*args, "--out", str(tmp_path / "jax")])
    got = json.load(open(tmp_path / "port" / "summary.json"))
    want = json.load(open(tmp_path / "jax" / "summary.json"))
    assert got == summary and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["sample"], g["pred_voxels"], g["gt_voxels"]) == \
            (w["sample"], w["pred_voxels"], w["gt_voxels"])
        np.testing.assert_allclose(np.reshape(g["proposals"], (-1, 2)),
                                   np.reshape(w["proposals"], (-1, 2)), rtol=0, atol=1e-9)
    assert sum(g["pred_voxels"] for g in got) > 0 and sum(g["gt_voxels"] for g in got) > 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 9
    for name in names:
        if name.endswith(".ply"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    assert all(len(g["proposals"]) == 1 for g in got)
    lines = [ln for ln in port_out.splitlines() if ln.startswith("sample ")]
    assert len(lines) == 2 and "ms: forward" in lines[0]
