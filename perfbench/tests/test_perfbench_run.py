"""A run on the CPU at a small size, with the harness's look for a card
skipped: the result line's shape, the import check, and ``correct``
coming out false for every fault a cell can have."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from perfbench import harness, spec

SMALL = {
    "scenenet.train.grid64": {
        "config": {"voxel_grid_size": [16, 16, 16]},
        "traffic": {"crops": 32, "batch_size": 4, "trace_epochs": 1,
                    "points": {"min": 2000, "max": 4096, "pad": 4096}}},
    "unet3d.train.stream64": {
        "config": {"voxel_grid_size": [32, 32, 32]},
        "traffic": {"crops": 16, "batch_size": 4, "loader_threads": 2, "trace_steps": 2,
                    "points": {"min": 2000, "max": 4096, "pad": 4096}}},
    "scenenet.infer.b64": {
        "config": {"voxel_grid_size": [16, 16, 16]},
        "traffic": {"pool": 16, "batch_size": 4, "sample_range": 8, "check_dispatches": 3,
                    "trace_dispatches": 2, "points": {"min": 2000, "max": 4096, "pad": 4096}}},
}
SEED = 2**31 + 12345
# the faults each cell can have (no cell spans chips: no exchange to leave out)
FAULTS = [("scenenet.train.grid64", "frozen_step"), ("scenenet.train.grid64", "half_batch"),
          ("unet3d.train.stream64", "frozen_step"), ("unet3d.train.stream64", "half_batch"),
          ("scenenet.infer.b64", "frozen_step"), ("scenenet.infer.b64", "half_batch"),
          ("scenenet.infer.b64", "altered_answer")]


def small_run(cell, faults=(), traced=False):
    return harness.run(cell, SEED, 0.5, traced, time.perf_counter(), device="cpu",
                       faults=faults, overrides=SMALL[cell])


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["scenenet_tpu_torch", "scenenet_tpu_torch.ops", "jaxtyping", "jax",
              "jaxlib.xla_client", "flax.linen", "scenenet_tpu", "scenenet_tpu.ops", "numpy"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jaxlib.xla_client", "scenenet_tpu", "scenenet_tpu.ops"]


def test_harness_and_program_load_no_jax():
    code = ("import perfbench.harness, perfbench.calibrate\n"
            "from perfbench import spec\n"
            "for r in ('grid_cache_train', 'stream_train', 'batch_infer'): spec.load_route(r)\n"
            "for m in spec.metric_files(): spec.load_metric(m)\n"
            "import scenenet_tpu_torch.cli.serve, scenenet_tpu_torch.cli.train\n"
            "import scenenet_tpu_torch.data, scenenet_tpu_torch.train.loop\n"
            "from perfbench.harness import forbidden_modules\n"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, env={**os.environ, "PYTHONPATH": str(spec.ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "scenenet.infer.b64", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time; from perfbench import harness; "
            "harness.run('scenenet.infer.b64', 1, 1.0, False, time.perf_counter(), "
            "device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0 and "scenenet_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", list(SMALL))
def test_result_line_shape(cell):
    result = small_run(cell)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = harness.report(result)
    assert code == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    c = spec.Cell(cell)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in c.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    checks = err.getvalue().strip().splitlines()
    assert len(checks) == len(line["checks"])
    for text, (name, c) in zip(checks, line["checks"].items()):
        assert text.startswith(f"[check] {name} ") and f"limit {c['limit']!r}" in text


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result = small_run(cell, faults=(fault,))
    assert result["correct"] is False, result["checks"]
