"""Device times of the multi-channel conv's bf16 form (K10 bf16) against the
earlier bf16 form and the other staging design, on one card.

Run on a machine with the card, from the root of a checkout:

    python3 scenenet_tpu_torch/csrc/bench/conv_mc_bf16_times.py

It builds the bench copies of this directory (``conv3d_mc_bf16_*.cu``, one
nvcc process each, into ``build/bench/``) beside the kernel library, checks
each against the plain version within one bf16 unit, and times, as one call
captured in a CUDA graph and replayed (medians of five, ms), in turns:

- the 32->32 layer at 64^3, batch 16: the current form, the earlier form
  (bf16 widened into the f32 form's tile by plain loads, one TF32 mma a tap
  and 8 channels) and the form that pairs the channels at the fragment load
  (``conv3d_mc_bf16_fragpair.cu``: the planar raw tile read by the mma loop
  itself, two 16-bit loads and a ``__byte_perm`` a fragment register);
- the 1->32 layer at 64^3, batch 16: the FMA kernel's bf16 form, the earlier
  form (the tensor-core tile, padded to 8 channels) and the f32 FMA kernel;
- UNet3D's 18 forward convs at 64^3, batch 16, one after the other in one
  graph: the current form, the earlier form, the f32 form and cuDNN bf16;
- the K split of the UNet's forward and dx convs at 16^3 and below (batch
  16 and 1): every split up to 16 and the plan's, beside cuDNN bf16.

``chip_smoke.py`` loads this file to build the earlier form
(``load_bench(("conv3d_mc_bf16_widened",))``) and time it beside the current
one (``widened_conv``). Not part of the kernel
library; the numbers in PERF.md name this script or the smoke.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
BENCH = Path(__file__).resolve().parent
OUT = ROOT / "build" / "bench"
ENTRIES = {"conv3d_mc_bf16_widened": "snt_widened_conv3d_mc_tc_bf16",
           "conv3d_mc_bf16_fragpair": "snt_fragpair_conv3d_mc_tc_bf16"}
SOURCES = tuple(ENTRIES)
UNET_CONVS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
              (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (256, 256, 4),
              (512, 256, 8), (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32),
              (64, 32, 32), (64, 32, 64), (32, 32, 64)]

# (batch, C_in, C_out, extent): the UNet's forward and dx convs at 16^3 and below
SPLIT_CASES = [(16, 64, 128, 16), (16, 128, 64, 16), (16, 128, 128, 16), (16, 256, 128, 16),
               (16, 128, 256, 8), (16, 256, 128, 8), (16, 256, 256, 8), (16, 512, 256, 8),
               (16, 256, 512, 8), (16, 256, 256, 4), (1, 256, 256, 4), (1, 128, 256, 8),
               (1, 256, 256, 8)]

_lock = threading.Lock()
_libs: dict = {}


def _import_port():
    sys.path.insert(0, str(ROOT))
    from scenenet_tpu_torch.ops import _build, cuda_conv_mc

    return _build, cuda_conv_mc


def load_bench(names=SOURCES) -> dict:
    """The bench copies ``names``, each built (once, all nvcc processes
    started together) into its own library and loaded: name -> ctypes.CDLL."""
    _build, _ = _import_port()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    with _lock:
        OUT.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            if name in _libs:
                continue
            src = BENCH / f"{name}.cu"
            h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + src.read_bytes())
            lib = OUT / f"lib{name}_{h.hexdigest()[:16]}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
            procs[name] = (lib, None if lib.exists() else subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, (lib, proc) in procs.items():
            if proc is not None:
                out, err = proc.communicate()
                lib.with_suffix(".log").write_text(out + err)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}.cu:\n{(out + err)[-4000:]}")
            cdll = ctypes.CDLL(str(lib))
            # x, w, frag, out, partial, B, C_in, C_out, Z, X, Y, w strides, tile,
            # k_splits, stream: the arguments of snt_conv3d_mc_tc_bf16
            fn = getattr(cdll, ENTRIES[name])
            fn.argtypes = (P, P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, I, I, P)
            fn.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs


def widened_plan(b, c_in, c_out, z, x, y):
    """The earlier form's plan: a tensor-core tile for every layer (C_in <= 4
    zero-filled to 8 channels), the f32 form's tiles and K split of chunks
    of 8 channels."""
    _, mc = _import_port()
    tile = (0 if y > 8 else 1) if c_out <= 32 else (3 if max(z, x, y) <= 4 else 2)
    blocks = mc.conv3d_mc_blocks(tile, 1, b, c_out, z, x, y)
    return tile, min(-(-c_in // mc.K_STEP), mc.MAX_K_SPLITS, -(-mc.TARGET_BLOCKS // blocks))


def _run(entry, x, w, tile, k_splits, frag_words):
    _, mc = _import_port()
    x = x.contiguous()
    b, c_in, z, xx, yy = x.shape
    out = torch.empty((b, w.shape[0], z, xx, yy), dtype=x.dtype, device=x.device)
    frag = torch.empty((frag_words,), dtype=torch.float32, device=x.device)
    partial = (torch.empty((k_splits, *out.shape), dtype=torch.float32, device=x.device)
               if k_splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = entry(x.data_ptr(), w.data_ptr(), frag.data_ptr(), out.data_ptr(),
                partial.data_ptr() if partial is not None else None, b, c_in, w.shape[0], z, xx,
                yy, *w.stride(), tile, k_splits, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"bench conv: CUDA error {err} at launch")
    return out


def widened_conv(x, w):
    """The earlier bf16 form on bf16 x (B, C_in, Z, X, Y) and w."""
    _, mc = _import_port()
    b, c_in, z, xx, yy = x.shape
    tile, k = widened_plan(b, c_in, w.shape[0], z, xx, yy)
    bn = mc.TC_TILES[tile][1]
    return _run(load_bench(("conv3d_mc_bf16_widened",))["conv3d_mc_bf16_widened"]
                .snt_widened_conv3d_mc_tc_bf16, x, w,
                tile, k, -(-w.shape[0] // bn) * -(-c_in // mc.K_STEP) * 27 * bn * 16)


def fragpair_conv(x, w):
    """The form that pairs channels at the fragment load, under the current
    form's plan (C_in > 4)."""
    _, mc = _import_port()
    b, c_in, z, xx, yy = x.shape
    tile, k = mc.conv3d_mc_plan(b, c_in, w.shape[0], z, xx, yy, bf16=True)
    bn = mc.TC_TILES[tile][1]
    return _run(load_bench()["conv3d_mc_bf16_fragpair"].snt_fragpair_conv3d_mc_tc_bf16, x, w,
                tile, k, -(-w.shape[0] // bn) * -(-c_in // mc.K_STEP_BF16) * 27 * bn * 8)


def loop_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return loop_ms(graph.replay, iters)


def in_turns(fns: dict, rounds=5, iters=20) -> dict:
    """Graph ms of each function, in turns (forward order, then reversed),
    medians over the rounds."""
    acc = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            acc[k].append(graph_ms(fns[k], iters))
    return {k: float(np.median(v)) for k, v in acc.items()}


def case(seed, b, c_in, c_out, n, dev):
    """x ~ U(0, 1), weights of variance 1/(27 C_in), both rounded to bf16."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.rand((b, c_in, n, n, n), device=dev, generator=gen)
    w = torch.randn((c_out, c_in, 3, 3, 3), device=dev, generator=gen) / (27 * c_in) ** 0.5
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def within_a_unit(got, want):
    d = (got.float() - want.float()).abs()
    return bool((d <= 2e-5 + 2.0 ** -7 * want.float().abs()).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_mc_bf16_times: no CUDA device", file=sys.stderr)
        return 1
    _build, mc = _import_port()
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    threading.Thread(target=load_bench).start()
    _build.load()
    load_bench()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    b = 16
    with torch.no_grad():
        x, w = case(1, b, 32, 32, 64, dev)
        want = mc.conv3d_mc_same_plain(x, w)
        forms = {"current": lambda: mc.conv3d_mc_same(x, w),
                 "earlier (widened, TF32)": lambda: widened_conv(x, w),
                 "pair at the fragment load": lambda: fragpair_conv(x, w)}
        for k, fn in forms.items():
            ok = within_a_unit(fn(), want)
            print(f"32->32 64^3 B={b} {k}: within one bf16 unit of the plain version: {ok}")
        t = in_turns(forms)
        print("32->32 64^3 B=16, graph ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()),
              flush=True)
        x, w = case(2, b, 1, 32, 64, dev)
        xf, wf = x.float(), w.float()
        t = in_turns({"bf16 FMA form": lambda: mc.conv3d_mc_same(x, w),
                      "earlier (tensor-core tile, 8 channels)": lambda: widened_conv(x, w),
                      "f32 FMA kernel": lambda: mc.conv3d_mc_same(xf, wf)})
        print("1->32 64^3 B=16, graph ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()),
              flush=True)
        layer16, layer32 = {}, {}
        for c_in, c_out, n in dict.fromkeys(UNET_CONVS):
            layer16[c_in, c_out, n] = case(c_in + c_out + n, b, c_in, c_out, n, dev)
            layer32[c_in, c_out, n] = tuple(v.float() for v in layer16[c_in, c_out, n])
        t = in_turns({
            "current": lambda: [mc.conv3d_mc_same(*layer16[c]) for c in UNET_CONVS],
            "earlier": lambda: [widened_conv(*layer16[c]) for c in UNET_CONVS],
            "f32 form": lambda: [mc.conv3d_mc_same(*layer32[c]) for c in UNET_CONVS],
            "cuDNN bf16": lambda: [F.conv3d(*layer16[c], padding=1) for c in UNET_CONVS]},
            rounds=3, iters=5)
        print("the 18 forward convs at 64^3 B=16, graph ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
        del layer16, layer32
        # the K split of the layers the plan may split (forward and dx shapes at
        # 16^3 and below, batch 16 and 1): every split up to 16 and the plan's
        for bb, c_in, c_out, n in SPLIT_CASES:
            x, w = case(c_in + n, bb, c_in, c_out, n, dev)
            tile, plan_k = mc.conv3d_mc_plan(bb, c_in, c_out, n, n, n, bf16=True)
            cap = mc.conv3d_mc_split_cap(tile, c_in, bf16=True)
            fns = {f"K/{k}": (lambda k=k: mc._launch_tc(x, w, tile, k))
                   for k in sorted({1, 2, 4, 8, 16, plan_k}) if k <= cap}
            fns["cuDNN bf16"] = lambda: F.conv3d(x, w, padding=1)
            t = in_turns(fns, rounds=3, iters=10)
            print(f"K split, B={bb} {c_in}->{c_out} {n}^3 (tile {tile}, "
                  f"{mc.conv3d_mc_blocks(tile, 1, bb, c_out, n, n, n)} blocks unsplit, the "
                  f"plan's K/{plan_k}), graph ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
