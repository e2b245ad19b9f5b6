"""Raw-volume slab IO for the checkpoints.

A numpy-only copy of what ``checkpoint.py`` needs from ``tpuflow3d.volume``
(``VolumeMeta``, ``read_raw_slab``, ``write_raw_slab``), so that the port
runs on a machine without JAX. The format is the reference's: headerless,
z-major (z slowest, x fastest), so a Z slab is one contiguous byte range
and each package reads the other's files. The reference's optional
threaded C++ fast path is not copied: these are the plain numpy routes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VolumeMeta:
    """Shape and dtype of a raw volume (arrays are dense: no pitch)."""
    shape: tuple[int, int, int]  # (D, H, W) = (z, y, x)
    dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize


def read_raw_slab(path: str, meta: VolumeMeta, z0: int, nz: int) -> np.ndarray:
    """Read planes [z0, z0+nz) only."""
    d, h, w = meta.shape
    if not (0 <= z0 and z0 + nz <= d):
        raise ValueError(f"slab [{z0},{z0 + nz}) out of range for D={d}")
    itemsize = np.dtype(meta.dtype).itemsize
    plane = h * w
    with open(path, "rb") as f:
        f.seek(z0 * plane * itemsize)
        raw = f.read(nz * plane * itemsize)
    return np.frombuffer(raw, dtype=meta.dtype).reshape(nz, h, w).copy()


def write_raw_slab(path: str, meta: VolumeMeta, z0: int,
                   slab: np.ndarray) -> None:
    """Write planes [z0, z0+len(slab)) into a raw file of the volume's size,
    creating it if absent. The file is opened without truncation and only
    ever extended, so concurrent writers of disjoint slabs cannot zero each
    other's planes."""
    d, h, w = meta.shape
    itemsize = np.dtype(meta.dtype).itemsize
    slab = np.ascontiguousarray(slab.astype(meta.dtype, copy=False))
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    with os.fdopen(fd, "r+b") as f:
        if os.fstat(f.fileno()).st_size < meta.nbytes:
            f.truncate(meta.nbytes)
        f.seek(z0 * h * w * itemsize)
        f.write(slab.tobytes())
