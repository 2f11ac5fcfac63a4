"""L-BFGS with the zoom linesearch, as ``optax.lbfgs(learning_rate)`` computes it.

PyTorch twin of the JAX package's ``optimizer: lbfgs``
(``scenenet_tpu.train.state.resolve_optimizer``), which is optax's chain

- ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the two-loop
  recursion over the last ``memory_size`` parameter and gradient
  differences, the identity scaled by ``(Δu·Δw)/(Δu·Δu)`` and, on the first
  step, by ``min(1, 1/‖g‖)``;
- ``scale_by_learning_rate``: the direction times ``-learning_rate``;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` at its defaults: a trial step of 1, an
  interval search that doubles it, then zooms by cubic, quadratic or
  bisection interpolation until the sufficient decrease (Armijo, or Hager
  and Zhang's approximate form near a minimum) and the curvature conditions
  hold; a search that runs out of steps takes the best step that
  decreased enough.

``torch.optim.LBFGS`` is a different algorithm (its strong-Wolfe search, its
history update and its first step), so it is not used.

The memory lives on the device as (memory, P) matrices over the flattened
trainable parameters, so the direction costs a few dozen launches and no
host sync. The linesearch's trip count depends on values: each trial is one
value-and-gradient evaluation on the device, after which the host reads
the trial's value and slope (one sync) and takes the search's decision in
the parameters' dtype, with optax's arithmetic in that dtype. A step is
therefore never captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# optax.scale_by_zoom_linesearch's defaults, as optax.lbfgs takes them
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class ZoomLinesearch:
    """optax's ``zoom_linesearch`` as host arithmetic in ``dtype``: ``trial(η)``
    evaluates the objective at the step η along the direction and returns
    its value and slope; :meth:`run` returns the accepted step.

    ``trace`` holds every trial of the last run as (η, value, slope), and
    ``value_init``/``slope_init`` its start, so a caller can read how far
    each decision was from its threshold."""

    def __init__(self, dtype, max_steps: int = MAX_LINESEARCH_STEPS):
        self.f = np.dtype(dtype).type
        self.max_steps = max_steps
        self.trace: List[tuple] = []
        self.value_init = self.slope_init = None

    def _errors(self, stepsize, value, slope, value_init, slope_init):
        f = self.f
        dec = value - value_init - f(SLOPE_RTOL) * stepsize * slope_init
        approx = slope - f(2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = value - value_init - f(APPROX_DEC_RTOL) * np.abs(value_init)
        approx = np.maximum(approx, delta_values)
        dec = np.maximum(np.minimum(approx, dec), f(0))
        dec = f(np.inf) if np.isnan(dec) else dec
        curv = np.maximum(np.abs(slope) - f(CURV_RTOL) * np.abs(slope_init), f(0))
        curv = f(np.inf) if np.isnan(curv) else curv
        return dec, curv

    def _cubicmin(self, a, fa, fpa, b, fb, c, fc):
        f = self.f
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) * (db * dc) * (db - dc)
        v0, v1 = fb - fa - C * db, fc - fa - C * dc
        A = (dc * dc * v0 + -(db * db) * v1) / denom
        B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
        radical = B * B - f(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (f(3.0) * A)

    def _quadmin(self, a, fa, fpa, b, fb):
        f = self.f
        db = b - a
        B = (fb - fa - fpa * db) / (db * db)
        return a - fpa / (f(2.0) * B)

    def run(self, trial: Callable, value_init, slope_init):
        f = self.f
        value_init, slope_init = f(value_init), f(slope_init)
        self.value_init, self.slope_init = value_init, slope_init
        self.trace = []
        count = 0
        stepsize, value, slope = f(0), value_init, slope_init
        dec = curv = f(np.inf)
        interval_found = done = failed = False
        low, value_low, slope_low = f(0), value_init, slope_init
        high, value_high, slope_high = f(0), value_init, slope_init
        cubic_ref, value_cubic_ref = f(0), value_init
        safe_stepsize, safe_value = f(0), value_init
        with np.errstate(all="ignore"):
            while not (done or failed):
                if not interval_found:  # Algorithm 3.5 of Nocedal and Wright
                    new = f(1.0) if count == 0 else f(INCREASE_FACTOR) * stepsize
                    new_value, new_slope = (f(v) for v in trial(new))
                    self.trace.append((new, new_value, new_slope))
                    dec, curv = self._errors(new, new_value, new_slope, value_init, slope_init)
                    error = np.maximum(dec, curv)
                    if dec <= 0:
                        safe_stepsize, safe_value = new, new_value
                    set_high = bool(dec > 0) or (bool(new_value >= value) and count > 0)
                    set_low = bool(new_slope >= 0) and not set_high
                    if set_low:
                        low, value_low, slope_low = new, new_value, new_slope
                        high, value_high, slope_high = stepsize, value, slope
                    else:
                        low, value_low, slope_low = stepsize, value, slope
                        high, value_high, slope_high = new, new_value, new_slope
                    interval_found = set_high or set_low or bool(error <= 0)
                    done = bool(error <= 0)
                    failed = count + 1 >= self.max_steps and not done
                    cubic_ref, value_cubic_ref = low, value_low
                    stepsize, value, slope = new, new_value, new_slope
                else:  # Algorithm 3.6: zoom into [low, high]
                    delta = np.abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    cubic_chk, quad_chk = f(0.2) * delta, f(0.1) * delta
                    too_small = bool(delta <= f(STEPSIZE_PRECISION))
                    mc = self._cubicmin(low, value_low, slope_low, high, value_high,
                                        cubic_ref, value_cubic_ref)
                    use_cubic = bool(mc > left + cubic_chk) and bool(mc < right - cubic_chk)
                    mq = self._quadmin(low, value_low, slope_low, high, value_high)
                    use_quad = (not use_cubic and bool(mq > left + quad_chk)
                                and bool(mq < right - quad_chk))
                    middle = (mc if use_cubic else mq if use_quad
                              else (low + high) / f(2.0))
                    v_mid, s_mid = (f(v) for v in trial(middle))
                    self.trace.append((middle, v_mid, s_mid))
                    dec, curv = self._errors(middle, v_mid, s_mid, value_init, slope_init)
                    error = np.maximum(dec, curv)
                    if dec <= 0 and bool(v_mid < safe_value):
                        safe_stepsize, safe_value = middle, v_mid
                    done = bool(error <= 0)
                    set_high_mid = bool(dec > 0) or bool(v_mid >= value_low)
                    set_high_low = bool(s_mid * (high - low) >= 0) and not set_high_mid
                    # the next cubic reference: the old high where high moves,
                    # else the old low
                    if set_high_mid or set_high_low:
                        cubic_ref, value_cubic_ref = high, value_high
                    else:
                        cubic_ref, value_cubic_ref = low, value_low
                    if set_high_mid:
                        high, value_high, slope_high = middle, v_mid, s_mid
                    elif set_high_low:
                        high, value_high, slope_high = low, value_low, slope_low
                    if not set_high_mid:
                        low, value_low, slope_low = middle, v_mid, s_mid
                    failed = ((count + 1 >= self.max_steps
                               or (too_small and bool(safe_stepsize > 0))) and not done)
                    stepsize, value, slope = middle, v_mid, s_mid
                count += 1
                if failed and (bool(safe_stepsize > 0) or bool(np.isinf(dec))):
                    # the search ran out: the best step that decreased enough
                    stepsize, value = safe_stepsize, safe_value
        return stepsize, count


class LBFGS(torch.optim.Optimizer):
    """``optax.lbfgs(learning_rate)`` over the trainable ones of ``params``.

    :meth:`step` takes the objective's value at the current parameters and
    a ``closure`` that re-evaluates it (zeroes the gradients, computes the
    loss at the parameters as they stand, runs the backward, returns the
    loss), as ``torch.optim.LBFGS``'s closure does; the gradients at the
    current parameters are in ``.grad`` when it is called. ``updates``
    replaces them as the direction's input where the caller averaged them
    (gradient accumulation, where optax's ``MultiSteps`` hands the inner
    update the mean and the last batch's value, gradient and objective).
    Frozen parameters (``requires_grad=False``) stay out, which is the JAX
    package's arithmetic: it zeroes their gradients first, so their
    coordinates add nothing to any inner product.

    After a step the parameters hold the accepted point and ``.grad`` the
    gradients the step was given. ``trials`` counts the linesearch's
    evaluations of the last step, ``evaluations`` and ``host_syncs`` all of
    them so far.
    """

    def __init__(self, params, lr: float = 1.0, memory_size: int = MEMORY_SIZE,
                 max_linesearch_steps: int = MAX_LINESEARCH_STEPS):
        super().__init__([p for p in params if p.requires_grad], {"lr": lr})
        self.memory_size = memory_size
        self.plist = [p for g in self.param_groups for p in g["params"]]
        ref = self.plist[0]
        size = sum(p.numel() for p in self.plist)
        self.count = 0  # the updates made, a host count: it only ever names slots
        self.prev_params = torch.zeros(size, dtype=ref.dtype, device=ref.device)
        self.prev_updates = torch.zeros_like(self.prev_params)
        self.dw = torch.zeros((memory_size, size), dtype=ref.dtype, device=ref.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(memory_size, dtype=ref.dtype, device=ref.device)
        self.linesearch = ZoomLinesearch(torch.empty((), dtype=ref.dtype).numpy().dtype,
                                         max_linesearch_steps)
        self.trials = 0
        self.evaluations = 0
        self.host_syncs = 0
        # the inner product of two flat vectors; under channel tensor
        # parallelism one over the whole vector, whose split parts lie on
        # other ranks (parallel/gspmd.py global_dot)
        self.dot = torch.dot

    # ---- state, for the resumable snapshots ----------------------------------

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        return {"count": torch.tensor(self.count, dtype=torch.int64),
                "prev_params": self.prev_params, "prev_updates": self.prev_updates,
                "dw": self.dw, "du": self.du, "rho": self.rho}

    def load_state_tensors(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy ``state`` (as :meth:`state_tensors` gives it) into the
        optimizer's own tensors, in place."""
        self.count = int(state["count"])
        for k in ("prev_params", "prev_updates", "dw", "du", "rho"):
            getattr(self, k).copy_(state[k])

    # ---- the step ---------------------------------------------------------------

    def _grads(self) -> torch.Tensor:
        return _flat([p.grad if p.grad is not None else torch.zeros_like(p)
                      for p in self.plist])

    def _set(self, flat: torch.Tensor) -> None:
        offset = 0
        for p in self.plist:
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()

    def _direction(self, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``scale_by_lbfgs``: update the memory with this step's differences,
        then the two-loop product P·g."""
        m = self.memory_size
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dw, du = w - self.prev_params, g - self.prev_updates
            vdot = self.dot(du, dw)
            self.dw[prev].copy_(dw)
            self.du[prev].copy_(du)
            self.rho[prev].copy_(torch.where(vdot == 0, torch.zeros_like(vdot), 1.0 / vdot))
            den = self.dot(du, du)
            scale = torch.where(den > 0, vdot / den, torch.ones_like(den))
        else:  # a capped reciprocal of the gradient norm
            norm = (torch.linalg.vector_norm(g) if self.dot is torch.dot
                    else torch.sqrt(self.dot(g, g)))
            scale = torch.clamp(1.0 / norm, max=1.0)
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * self.dot(self.dw[i], vec)
            vec = vec + (-alphas[i]) * self.du[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * self.dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.prev_params.copy_(w)
        self.prev_updates.copy_(g)
        self.count += 1
        return vec

    @torch.no_grad()
    def step(self, closure: Callable[[], torch.Tensor], value: torch.Tensor,
             updates: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        lr = self.param_groups[0]["lr"]
        w = _flat([p.detach() for p in self.plist])
        grad = self._grads()
        given = [p.grad.clone() if p.grad is not None else None for p in self.plist]
        g = grad if updates is None else _flat(updates)
        u = -lr * self._direction(w, g)
        slope_init = self.dot(u, grad)

        def trial(stepsize):
            self._set(w + float(stepsize) * u)
            with torch.enable_grad():
                v = closure()
            s = self.dot(self._grads(), u)
            self.evaluations += 1
            self.host_syncs += 1
            return torch.stack([v.detach().to(s.dtype), s]).tolist()

        value_init, slope_init = torch.stack([value.detach().to(slope_init.dtype),
                                              slope_init]).tolist()
        self.host_syncs += 1
        stepsize, self.trials = self.linesearch.run(trial, value_init, slope_init)
        self._set(w + float(stepsize) * u)
        for p, gv in zip(self.plist, given):
            p.grad = gv
        return value
