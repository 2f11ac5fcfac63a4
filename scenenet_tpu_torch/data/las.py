"""Minimal LAS reader: xyz coordinates + classification, zero dependencies.

The port's own copy of :mod:`scenenet_tpu.data.las`.

Replaces the reference's laspy ingestion (``utils/pcd_processing.py:99-120``,
which only consumes ``las.x/y/z`` and ``las.classification``). Supports
uncompressed LAS 1.1-1.4, point record formats 0-10. LAZ (compressed) is
not supported — decompress offline first.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

# classification byte offset inside a point record, per point format
_CLASS_OFFSET = {0: 15, 1: 15, 2: 15, 3: 15, 4: 15, 5: 15,
                 6: 16, 7: 16, 8: 16, 9: 16, 10: 16}


def read_las_xyz_class(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) float64 in world units, classification (N,) uint8)."""
    with open(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        ver_minor = header[25]
        offset_to_points = struct.unpack_from("<I", header, 96)[0]
        point_format = header[104] & 0x3F  # mask LAZ compression bits
        record_len = struct.unpack_from("<H", header, 105)[0]
        n_points = struct.unpack_from("<I", header, 107)[0]
        scale = np.array(struct.unpack_from("<3d", header, 131))
        offset = np.array(struct.unpack_from("<3d", header, 155))
        if ver_minor >= 4:
            n64 = struct.unpack_from("<Q", header, 247)[0]
            if n64:
                n_points = n64
        if header[104] & 0xC0:
            raise ValueError(f"{path}: LAZ-compressed points are not supported")
        if point_format not in _CLASS_OFFSET:
            raise ValueError(f"{path}: unsupported point format {point_format}")

        f.seek(offset_to_points)
        raw = f.read(n_points * record_len)

    rec = np.frombuffer(raw, dtype=np.uint8).reshape(n_points, record_len)
    xyz_int = rec[:, :12].copy().view("<i4").reshape(n_points, 3)
    xyz = xyz_int.astype(np.float64) * scale + offset
    cls_off = _CLASS_OFFSET[point_format]
    classification = rec[:, cls_off].copy()
    if point_format < 6:
        classification = classification & 0x1F  # low 5 bits in legacy formats
    return xyz, classification


def write_las(path: str, xyz: np.ndarray, classification: np.ndarray) -> None:
    """Write a minimal LAS 1.2 / point-format-0 file (test fixture helper)."""
    xyz = np.asarray(xyz, np.float64)
    classification = np.asarray(classification, np.uint8)
    n = len(xyz)
    offset = xyz.min(0)
    scale = np.array([1e-3, 1e-3, 1e-3])
    header_size = 227
    record_len = 20

    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, header_size)  # offset to points
    header[104] = 0
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, *scale)
    struct.pack_into("<3d", header, 155, *offset)
    mins, maxs = xyz.min(0), xyz.max(0)
    struct.pack_into("<6d", header, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2])

    rec = np.zeros((n, record_len), np.uint8)
    ints = np.round((xyz - offset) / scale).astype("<i4")
    rec[:, :12] = ints.view(np.uint8).reshape(n, 12)
    rec[:, 15] = classification & 0x1F
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())
