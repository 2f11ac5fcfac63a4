"""The control of each cell, the plain reference computed in TF32 and put
in the program's place, comes out as not correct; the program, at the same
small size on the CPU, as correct. On the card the same control ran at
each cell's own size (``python3 -m perfbench.calibrate``; readings in
``PERF.md`` §2)."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec
from perfbench.tests.test_perfbench_run import SEED, SMALL


def _route(cell):
    c = spec.Cell(cell)
    for part, values in SMALL[cell].items():
        getattr(c, part).update(values)
    return spec.load_route(c.traffic["route"]).Route(c, SEED, torch.device("cpu"))


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct_and_the_program_is(cell):
    route = _route(cell)
    try:
        route.setup()
        if cell == "scenenet.infer.b64":
            route.window(0.2)
        route.release()
        program = route.check()
        control = route.control()
    finally:
        route.close()
    assert all(c.ok for c in program), [(c.name, c.value, c.limit) for c in program]
    assert not all(c.ok for c in control), [(c.name, c.value, c.limit) for c in control]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from perfbench.reference import tf32

    v = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -12])
    assert tf32(v).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "scenenet.infer.b64", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
