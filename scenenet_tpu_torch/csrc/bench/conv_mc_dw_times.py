"""The multi-channel conv's weight gradient (K10 dw) at every tile and at the
splits around the plan's, for each of the UNet's 18 convs at batch 16 and
64^3, on one card: the sweep that ``conv3d_mc_dw_plan`` was chosen from.

Run on a machine with the card, from the root of a checkout:

    python3 scenenet_tpu_torch/csrc/bench/conv_mc_dw_times.py

Each time is one call captured in a CUDA graph and replayed (ms a call).
The layer list, the graph timing and the bound are ``chip_smoke.py``'s; its
``[K10 dw]`` phase checks the kernel and times the plan's pick beside the
library's dw. Not part of the kernel library.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
BATCH = 16


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from scenenet_tpu_torch.ops import cuda_conv_mc as mc

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    rows, total = [], {"plan": 0.0, "best": 0.0, "bound": 0.0}
    for cin, cout, n in smoke.UNET_CONVS:
        gen = torch.Generator(dev).manual_seed(cin + cout + n)
        x = torch.rand((BATCH, cin, n, n, n), device=dev, generator=gen)
        g = torch.randn((BATCH, cout, n, n, n), device=dev, generator=gen)
        tile0, s0 = mc.conv3d_mc_dw_plan(BATCH, cin, cout, n, n, n)
        times = {}
        for tile in mc.DW_TILES:
            for s in sorted({max(1, s0 // 2), s0, s0 * 2}):
                if s <= mc.conv3d_mc_dw_stages(tile, BATCH, n, n, n):
                    times[tile, s] = smoke.graph_ms(lambda: mc._launch_dw(x, g, tile, s), 20)
        planned = times[tile0, s0]
        bound = smoke.dw_bound_ms(BATCH, cin, cout, n)[0]
        total["plan"] += planned
        total["best"] += min(times.values())
        total["bound"] += bound
        rows.append(f"{cin}->{cout} {n}^3 plan ({tile0}, {s0}) {planned:.4f}, bound {bound:.4f} ["
                    + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + "]")
        del x, g
        torch.cuda.empty_cache()
    print(f"[tiles] dw B={BATCH} ({smi}), in a CUDA graph, ms by (tile, splits): "
          + " | ".join(rows), flush=True)
    print(f"[tiles] the 18 convs: the plan's picks {total['plan']:.4f} ms, the fastest pick of "
          f"each layer {total['best']:.4f} ms, bound {total['bound']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
