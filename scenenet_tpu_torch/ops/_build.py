"""Build and load the hand-written CUDA kernels of ``scenenet_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object file,
one compiler process per source, all started together, and links them
into one shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout; ``ctypes`` loads it. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. A missing compiler or a failed build or load raises.

No PyTorch header is compiled (seconds to build, not minutes): the
wrappers pass ``data_ptr()`` ints and the current stream's handle as
``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No fast math anywhere: the histogram kernels' bin ids must match the f32
# recipe bit for bit, and the stencil's tanhf must be the accurate one.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # pts, mask, out, bitmap, nonempty, partials, B, N, n_x, n_y, n_z, chunks,
    # chunk_len, mark_len, stream
    "snt_points_occupancy": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # pts, mask, tower, out_x, out_y, bitmap, tower bitmap, nonempty, partials, B, N,
    # n_x, n_y, n_z, chunks, chunk_len, mark_len, stream
    "snt_points_binary": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    # pts, mask, tower, counts, towers, partials, B, N, n_x, n_y, n_z, chunks,
    # chunk_len, stream
    "snt_points_bin_counts": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # pts, mask, ids, partials, B, N, n_x, n_y, n_z, invalid, chunks, chunk_len, stream
    "snt_flat_ids": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # ids, id bytes, mask, flag, flag bytes, flag is float, cells, counts, flagged, B,
    # N, size, stream
    "snt_bin_counts": (_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    # ids, mask, weights, counts, wsum, B, N, size, stream
    "snt_bin_counts_weighted": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ids, mask, flag, counts, flagged, scratch, B, N, size, shift, chunks,
    # chunk_len, stream
    "snt_sorted_bin_counts": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, kernel, out, B, Z, X, Y, k_z, k_x, k_y, activation, fast, stream
    "snt_stencil_conv": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, kernel, out, B, Z, X, Y, k_z, k_x, k_y, activation, split, has_tau, tau,
    # z tile, stream
    "snt_stencil_mma": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # k_z, k_x, k_y, z tile -> bytes of shared memory a block of the mma kernel needs
    "snt_stencil_mma_smem": (_I, _I, _I, _I),
    # x, g, dk, partial, B, Z, X, Y, k_z, k_x, k_y, fast, z tiles a block, stream
    "snt_stencil_dk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # B, Z, X, Y, fast, z tiles a block -> blocks of the dk kernel's first pass
    "snt_stencil_dk_blocks": (_I, _I, _I, _I, _I, _I),
    # x, wt, out, B, C_in, C_out, Z, X, Y, x strides (sample, channel, voxel),
    # out strides (sample, channel, voxel), vec_out, stream
    "snt_conv3d_mc": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, _P),
    # x, w, frag, out, partial, B, C_in, C_out, Z, X, Y, w strides (C_out, C_in, dz,
    # dx, dy), tile, k_splits, stream
    "snt_conv3d_mc_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                         _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall time of this process's nvcc run, 0 if none ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsnt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(sources, objs))]
    runs = []  # (command, return code, stdout + stderr) of every nvcc run
    for cmd, proc in procs:
        out, err = proc.communicate()
        runs.append((cmd, proc.returncode, out + err))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if all(rc == 0 for _, rc, _ in runs):
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        runs.append((cmd, link.returncode, link.stdout + link.stderr))
    build_seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text("".join(
        " ".join(cmd) + "\n" + text for cmd, _, text in runs))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(cmd, rc, text) for cmd, rc, text in runs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, text = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


class LaunchCounter:
    """Count of a kernel's launches; the wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n
