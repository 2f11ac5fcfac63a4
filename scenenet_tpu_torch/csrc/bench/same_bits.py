"""Bit-for-bit comparison of the SAME stencil conv (K2) and its kernel
gradient (K4) between this checkout and another.

Run on a machine with the card, from the root of a checkout:

    python3 scenenet_tpu_torch/csrc/bench/same_bits.py --root DIR

DIR is another checkout (an unpacked earlier commit). Each checkout's
package runs in its own process, builds its own kernel library and writes
K2's outputs (both kernels, with and without the head) and K4's (both
kernels) on the same seeded inputs; the script prints, for each case,
whether the two checkouts' results are bit-identical, and exits non-zero
where one is not. The inputs: (9,5,5) and (9,6,6) kernels on 64^3 ~20%
occupancy at batch 2, and ragged volumes (13 x 37 x 70, 9 x 17 x 35) on
which the tiles and the 4-byte staging come in. Not part of the kernel
library.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

SHAPES = [(2, 64, 64, 64), (1, 13, 37, 70), (2, 9, 17, 35)]
KERNELS = [(9, 5, 5), (9, 6, 6), (3, 3, 3)]

WORKER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from scenenet_tpu_torch.ops import cuda_conv

dev = torch.device("cuda")
out = {}
for si, shape in enumerate(%(shapes)r):
    rng = np.random.default_rng(si)
    x = torch.from_numpy((rng.random(shape) > 0.8).astype(np.float32))[:, None].to(dev)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))[:, None].to(dev)
    for ks in %(kernels)r:
        k = torch.from_numpy(rng.normal(0, 0.3, ks).astype(np.float32)).to(dev)
        routes = ("fast", "generic") if cuda_conv.stencil_route(ks) == "fast" else ("generic",)
        for r in routes:
            for act in (True, False):
                out[f"K2 {shape} {ks} {r} act={act}"] = cuda_conv._launch_stencil(
                    x, k, act, r).cpu().numpy()
            out[f"K4 {shape} {ks} {r}"] = cuda_conv._launch_dk(x, g, ks, r).cpu().numpy()
torch.cuda.synchronize()
np.savez(sys.argv[2], **out)
"""


def results(root: str, path: str) -> dict:
    code = WORKER % {"shapes": SHAPES, "kernels": KERNELS}
    subprocess.run([sys.executable, "-c", code, root, path], check=True)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="the other checkout")
    args = parser.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    with tempfile.TemporaryDirectory() as tmp:
        mine = results(here, os.path.join(tmp, "here.npz"))
        other = results(os.path.abspath(args.root), os.path.join(tmp, "other.npz"))
    differ = [k for k in mine if mine[k].tobytes() != other[k].tobytes()]
    print(f"[same bits] K2 and K4, SAME form, this checkout vs {args.root}: "
          f"{len(mine) - len(differ)} of {len(mine)} cases bit-identical"
          + (f"; differ: {differ}" if differ else ""))
    return 1 if differ or set(mine) != set(other) else 0


if __name__ == "__main__":
    sys.exit(main())
