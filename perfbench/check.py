"""The numbers that decide ``correct``, each held to a limit of its own.

A training cell compares the program's first steps with the plain
reference's on the same inputs and weights: each step's loss, the first
gradient as the optimizer received it (by the worst leaf), the change of
the parameters over the steps (by the worst leaf), and the confusion
counts. A leaf's gap is ``| ‖program‖ − ‖reference‖ |`` over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch


class Compare:
    """One number compared, its limit, and whether it holds."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN is never within a limit


def loss_gap(program: List[float], reference: List[float]) -> float:
    """The largest relative gap of a step's loss; inf where the step counts
    differ."""
    if len(program) != len(reference) or not reference:
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             leaves: Optional[List[str]] = None) -> float:
    """The worst leaf's gap of norms (see the module's doc); inf where a
    leaf is missing."""
    leaves = list(reference) if leaves is None else leaves
    if any(n not in program for n in leaves) or not leaves:
        return float("inf")
    ref = {n: _norm(reference[n]) for n in leaves}
    median = statistics.median(ref.values())
    return max(abs(_norm(program[n].to(reference[n].device)) - ref[n]) / max(ref[n], median, 1e-30)
               for n in leaves)


def moving_leaves(grads: Dict[str, torch.Tensor], names: List[str]) -> List[str]:
    """The leaves of ``names`` whose reference gradient is at least a
    thousandth of the median leaf's; names without a gradient (running
    statistics) are kept."""
    norms = {n: _norm(g) for n, g in grads.items()}
    median = statistics.median(norms.values())
    return [n for n in names if n not in norms or norms[n] >= 1e-3 * median]


def change(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    return {n: after[n].double().cpu() - before[n].double().cpu() for n in after}


def flip_share(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The share of voxels whose thresholded prediction differs between
    the two confusion counts (tp, fp, fn, tn): half the summed gaps over
    the voxels."""
    p, r = program.double().cpu(), reference.double().cpu()
    if float(p.sum()) != float(r.sum()):
        return float("inf")
    return float((p - r).abs().sum() / 2 / r.sum())


def training_numbers(prog: dict, ref: dict, before: Dict[str, torch.Tensor],
                     limits: Dict[str, float]) -> List[Compare]:
    """The training comparisons of a cell, from the program's readings and
    the reference's (``losses``, ``grads``, ``params``, ``counts``) and the
    weights both started from."""
    moving = moving_leaves(ref["grads"], list(ref["params"]))
    ref_change = change(ref["params"], before)
    prog_change = change({n: prog["params"][n] for n in ref["params"] if n in prog["params"]},
                         before)
    return [Compare("loss_gap", loss_gap(prog["losses"], ref["losses"]), limits["loss_gap"]),
            Compare("grad_gap", leaf_gap(prog["grads"], ref["grads"]), limits["grad_gap"]),
            Compare("change_gap", leaf_gap(prog_change, ref_change, moving),
                    limits["change_gap"]),
            Compare("flip_share", flip_share(prog["counts"], ref["counts"]),
                    limits["flip_share"])]
