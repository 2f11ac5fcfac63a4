"""ctypes bindings for the native (C++) host kernels of the data pipeline.

The port's own counterpart of :mod:`scenenet_tpu.native`, built from the
port's own copies of its sources (``voxel_native.cpp``,
``batch_loader.cpp``, beside this file). At first use ``g++ -O3 -shared
-fPIC -pthread`` compiles both into one library under ``build/native/`` at
the root of the checkout, named by a hash of the sources and the flags, so
an edited source is rebuilt and a stale library is never loaded. Each
builder writes a file of its own and moves it into place with
``os.replace``, so processes that build at once (test workers) do not
collide.

As in the JAX package, the native layer is optional: :func:`available` is
False where the sources are missing, no C++ compiler exists, the compile
fails or the library does not load, with the reason printed once, and
every caller then takes its numpy route. :func:`build` itself raises on a
failed compile, with the compiler's output. No loader thread touches the
card: these are host kernels, not device ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / f
                for f in ("voxel_native.cpp", "batch_loader.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native: its FMA contraction moves results off the numpy oracles'
# (the JAX package's library, built with it, decodes LAS a rounding away)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # xyz, labels, n, vxg, vox, use_vox, keep, n_keep, mins, maxs, shape, hist, reg, idx
    "snt_voxelize": ((_P, _P, _L, _P, _P, _I, _P, _L, _P, _P, _P, _P, _P, _P), _I),
    # xyz, n, vxg, vox, use_vox, mins, maxs, shape
    "snt_fit_spec": ((_P, _L, _P, _P, _I, _P, _P, _P), _I),
    # xyz, n, eps, min_points, labels
    "snt_dbscan": ((_P, _L, ctypes.c_double, _L, _P), _I),
    # path, xyz, classes -> points (or a negative error code)
    "snt_read_las": ((ctypes.c_char_p, _P, _P), _L),
    # NUL-separated paths, files, max_points, threads, pts, labels, mask
    "snt_load_batch": ((ctypes.c_char_p, _I, _L, _I, _P, _P, _P), _I),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Dict[str, str] = {}  # what could not be built or loaded -> why


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsnt_native_{h.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the sources with ``cxx`` unless their library exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({run.returncode}):\n"
                           f"{(run.stdout + run.stderr)[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _unavailable(key: str, reason: str) -> None:
    """Record why the library is unavailable, printing it the first time."""
    if key not in _failed:
        _failed[key] = reason
        print(f"[native] library unavailable ({reason}); the numpy routes run instead",
              flush=True)


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use and loaded once per process;
    None, with the reason printed once, where the sources are missing, no
    C++ compiler exists, the compile fails or the library does not load
    (the JAX package's ``load_native`` returns None in the same cases)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = library_path()
        except OSError as exc:
            _unavailable("sources", f"sources missing: {exc}")
            return None
        key = str(path)
        if key in _failed:
            return None
        if not path.exists():
            cxx = _compiler()
            if cxx is None:
                _unavailable(key, "no C++ compiler (g++) to build it")
                return None
            try:
                path = build(cxx)
            except RuntimeError as exc:
                _unavailable(key, f"build failed: {str(exc).splitlines()[0]}")
                return None
        try:
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        except (OSError, AttributeError) as exc:
            _unavailable(key, f"{path.name} does not load: {exc}")
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load_native() is not None


def _require() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        reason = list(_failed.values())[-1] if _failed else "not loaded"
        raise RuntimeError(f"native library unavailable: {reason}")
    return lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def voxelize_native(
    xyz: np.ndarray,
    labels: Optional[np.ndarray],
    keep_labels: Sequence[float] = (15,),
    vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
    vox_size: Optional[Tuple[float, float, float]] = None,
    want_indices: bool = False,
):
    """Fused host voxelization: returns (hist_counts, reg, spec_dict[, idx]).

    ``hist_counts`` are raw per-voxel counts in (z, x, y) layout; apply
    :func:`scenenet_tpu_torch.ops.voxel_np.normalize_per_column_np` for the
    model input convention. ``idx`` is each point's (z, x, y)-flattened bin,
    bit-exact with :func:`~scenenet_tpu_torch.ops.voxel_np.voxel_indices_np`.
    """
    lib = _require()
    xyz = np.ascontiguousarray(xyz, np.float64)
    n = len(xyz)
    labels_arr = None if labels is None else np.ascontiguousarray(labels, np.float64)
    keep = np.ascontiguousarray(np.asarray(keep_labels, np.float64).reshape(-1))

    use_vox = vox_size is not None
    vxg = np.asarray(vxg_size if vxg_size else (64, 64, 64), np.int64)
    vox = np.asarray(vox_size if use_vox else (0, 0, 0), np.float64)
    mins, maxs = np.zeros(3), np.zeros(3)
    shape = np.zeros(3, np.int64)

    # with voxel sizes the shape depends on the data: size the outputs by the
    # C++ fit itself, which the main call below repeats, so the shapes agree
    # by construction (a numpy refit could disagree by one truncated bin)
    if use_vox:
        ret = lib.snt_fit_spec(_ptr(xyz), n, _ptr(vxg), _ptr(vox), 1,
                               _ptr(mins), _ptr(maxs), _ptr(shape))
        if ret != 0:
            raise RuntimeError(f"snt_fit_spec failed (code {ret})")
    else:
        shape[:] = vxg
    alloc_shape = shape.copy()

    size = int(shape[0] * shape[1] * shape[2])
    hist = np.zeros(size, np.float64)
    reg = np.zeros(size, np.float64)
    idx = np.zeros(n, np.int64) if want_indices else None
    ret = lib.snt_voxelize(_ptr(xyz), _ptr(labels_arr), n, _ptr(vxg), _ptr(vox),
                           1 if use_vox else 0, _ptr(keep), len(keep), _ptr(mins),
                           _ptr(maxs), _ptr(shape), _ptr(hist), _ptr(reg), _ptr(idx))
    if ret != 0:
        raise RuntimeError(f"snt_voxelize failed (code {ret})")
    if not (shape == alloc_shape).all():
        raise RuntimeError(f"snt_voxelize fit shape {shape} differs from {alloc_shape}")
    n_x, n_y, n_z = (int(s) for s in shape)
    zxy = (n_z, n_x, n_y)
    spec = {"xyzmin": mins, "xyzmax": maxs, "shape": (n_x, n_y, n_z)}
    out = (hist.reshape(zxy), reg.reshape(zxy), spec)
    return out + ((idx,) if want_indices else ())


def dbscan_native(xyz: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Grid-hashed DBSCAN: (N,) int64 labels, -1 for noise."""
    lib = _require()
    xyz = np.ascontiguousarray(xyz, np.float64)
    labels = np.zeros(len(xyz), np.int64)
    lib.snt_dbscan(_ptr(xyz), len(xyz), float(eps), int(min_points), _ptr(labels))
    return labels


def read_las_native(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz (N, 3) float64 in world units, classification (N,) uint8)."""
    lib = _require()
    n = lib.snt_read_las(path.encode(), None, None)
    if n < 0:
        raise ValueError(f"snt_read_las failed (code {n}) for {path}")
    xyz = np.zeros((n, 3), np.float64)
    classes = np.zeros(n, np.uint8)
    ret = lib.snt_read_las(path.encode(), _ptr(xyz), _ptr(classes))
    if ret != n:
        raise ValueError(f"snt_read_las short read ({ret}/{n}) for {path}")
    return xyz, classes


def load_batch_native(paths: Sequence[str], max_points: int, threads: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parallel batch prep: .npy crop files → (points (B, M, 3) f32
    min-centred, labels (B, M) i32, mask (B, M) bool), padded to
    ``max_points``, in C++ threads with the GIL released for the whole
    call. ``threads=0`` → one a file, at most the CPU count."""
    lib = _require()
    b = len(paths)
    pts = np.empty((b, max_points, 3), np.float32)
    labels = np.empty((b, max_points), np.int32)
    mask = np.empty((b, max_points), np.uint8)
    blob = b"".join(os.fsencode(p) + b"\0" for p in paths)
    if threads <= 0:
        threads = min(b, os.cpu_count() or 1)
    rc = lib.snt_load_batch(blob, b, max_points, threads, _ptr(pts), _ptr(labels),
                            _ptr(mask))
    if rc != 0:
        raise ValueError(f"snt_load_batch failed on {paths[rc - 1]!r}")
    return pts, labels, mask.astype(bool)
