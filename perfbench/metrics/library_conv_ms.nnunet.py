"""Device milliseconds a train step spends in the library's strided and
transposed convs (``ops/library_conv.py``: ``conv3d_strided``,
``conv_transpose3d_k2``), forward and backward.

The rule that finds them: a device operation counts where the runtime call
that launched it (matched by the trace's ``correlation``) was made inside
one of the host ops the two wrappers' autograd Functions appear as, on the
thread that made the call: ``_StridedConv3d`` and ``_ConvTranspose3dK2``
(the forward, on the loop's thread) and ``_StridedConv3dBackward`` and
``_ConvTranspose3dK2Backward`` (autograd's thread). K10's launches sit in
``_FusedConv3dMc`` and its backward, and the heads' products in
``aten::matmul`` outside all four, so neither matches. The forward ops in
the window must number the wrappers' own calls over the traced steps (the
route's ``launches`` of ``conv3d_strided`` and ``conv_transpose3d_k2``);
where they do not, or none ran, nothing is read.
"""

from collections import defaultdict

FORWARD = ("_StridedConv3d", "_ConvTranspose3dK2")
HOST_OPS = FORWARD + tuple(f"{n}Backward" for n in FORWARD)
COUNTERS = ("conv3d_strided", "conv_transpose3d_k2")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_seconds(trace, names=HOST_OPS) -> float:
    """Device seconds of the operations launched inside a host op of
    ``names``, on the launching thread."""
    inside = defaultdict(list)
    for e in trace.host:
        if e.get("cat") == "cpu_op" and e["name"] in names:
            inside[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e["dur"]))
    launched = {e["args"]["correlation"]: ((e.get("pid"), e.get("tid")), e["ts"])
                for e in trace.host
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    total = 0.0
    for e in trace.device:
        at = launched.get(e.get("args", {}).get("correlation"))
        if at is not None and any(s <= at[1] <= f for s, f in inside.get(at[0], ())):
            total += e["dur"]
    return total * 1e-6


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    calls = sum(ctx.counters.get("launches", {}).get(k, 0) for k in COUNTERS)
    forward = sum(1 for e in ctx.trace.host if e.get("cat") == "cpu_op" and e["name"] in FORWARD)
    if not steps or not calls or forward != calls:
        return None
    return device_seconds(ctx.trace) / steps * 1e3
