"""Volume descriptor and headerless raw-volume IO.

Port of ``tpuflow3d.volume`` (numpy only, the port's own copy, so that it
runs on a machine without JAX). The format is the reference's, byte for
byte: headerless, z-major (z slowest, x fastest), so a Z slab is one
contiguous byte range; dimensions and dtype come from the command line or
a JSON sidecar (``<file>.json``). Each package reads the other's files.

The threaded C++ route of ``utils/native.py`` reads, writes and widens
where its library is built; otherwise numpy does, with the same bytes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from tpuflow3d_torch.utils import native


@dataclass(frozen=True)
class VolumeMeta:
    """Shape and dtype of a raw volume (arrays are dense: no pitch)."""
    shape: tuple[int, int, int]  # (D, H, W) = (z, y, x)
    dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize

    def sidecar(self) -> dict:
        return {"shape": list(self.shape), "dtype": self.dtype,
                "order": "zyx"}


def write_sidecar(path: str, meta: VolumeMeta) -> None:
    with open(path + ".json", "w") as f:
        json.dump(meta.sidecar(), f)


def read_sidecar(path: str) -> VolumeMeta | None:
    p = path + ".json"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        d = json.load(f)
    return VolumeMeta(shape=tuple(d["shape"]), dtype=d["dtype"])


def read_raw(path: str, meta: VolumeMeta | None = None,
             mmap: bool = False) -> np.ndarray:
    """Read a whole headerless raw volume (shape and dtype from ``meta``
    or the sidecar)."""
    if meta is None:
        meta = read_sidecar(path)
        if meta is None:
            raise ValueError(f"no dims given and no sidecar for {path}")
    if mmap:
        return np.memmap(path, dtype=meta.dtype, mode="r", shape=meta.shape)
    n_expected = int(np.prod(meta.shape))
    actual = os.path.getsize(path)
    if actual != meta.nbytes:
        raise ValueError(f"{path}: {actual // np.dtype(meta.dtype).itemsize} "
                         f"elements, expected {n_expected} for {meta.shape}")
    buf = native.read_bytes(path, 0, meta.nbytes)
    if buf is not None:
        return buf.view(meta.dtype).reshape(meta.shape)
    return np.fromfile(path, dtype=meta.dtype).reshape(meta.shape)


def read_raw_slab(path: str, meta: VolumeMeta, z0: int, nz: int) -> np.ndarray:
    """Read planes [z0, z0+nz) only."""
    d, h, w = meta.shape
    if not (0 <= z0 and z0 + nz <= d):
        raise ValueError(f"slab [{z0},{z0 + nz}) out of range for D={d}")
    itemsize = np.dtype(meta.dtype).itemsize
    plane = h * w
    nbytes = nz * plane * itemsize
    offset = z0 * plane * itemsize
    buf = native.read_bytes(path, offset, nbytes)
    if buf is not None:
        return buf.view(meta.dtype).reshape(nz, h, w)
    with open(path, "rb") as f:
        f.seek(offset)
        raw = f.read(nbytes)
    return np.frombuffer(raw, dtype=meta.dtype).reshape(nz, h, w).copy()


def write_raw(path: str, arr: np.ndarray, sidecar: bool = True) -> None:
    arr = np.ascontiguousarray(arr)
    arr.tofile(path)
    if sidecar:
        write_sidecar(path, VolumeMeta(tuple(arr.shape), str(arr.dtype)))


def write_raw_slab(path: str, meta: VolumeMeta, z0: int,
                   slab: np.ndarray) -> None:
    """Write planes [z0, z0+len(slab)) into a raw file of the volume's size,
    creating it if absent. The file is opened without truncation and only
    ever extended, so concurrent writers of disjoint slabs cannot zero each
    other's planes."""
    d, h, w = meta.shape
    itemsize = np.dtype(meta.dtype).itemsize
    offset = z0 * h * w * itemsize
    slab = np.ascontiguousarray(slab.astype(meta.dtype, copy=False))
    if native.write_bytes(path, offset, slab, meta.nbytes):
        return
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    with os.fdopen(fd, "r+b") as f:
        if os.fstat(f.fileno()).st_size < meta.nbytes:
            f.truncate(meta.nbytes)
        f.seek(offset)
        f.write(slab.tobytes())


def pad_to_multiple(vol: np.ndarray, m: int) -> np.ndarray:
    """Edge-replicate pad Z so D % m == 0."""
    d = vol.shape[0]
    d_pad = m * ((d + m - 1) // m)
    if d_pad == d:
        return vol
    return np.concatenate(
        [vol, np.repeat(vol[-1:], d_pad - d, axis=0)], axis=0)


# The flow array is (3, D, H, W) with components (z, y, x); the files follow
# the (u, v, w) = (x, y, z) displacement convention.
FLOW_COMPONENT_FILES = {"u": 2, "v": 1, "w": 0}


def write_flow(prefix: str, flow: np.ndarray, magnitude: bool = True) -> None:
    """Write <prefix>u.raw, v.raw, w.raw (and magnitude.raw), each with its
    sidecar."""
    for name, ci in FLOW_COMPONENT_FILES.items():
        write_raw(f"{prefix}{name}.raw", np.asarray(flow[ci]))
    if magnitude:
        mag = np.sqrt((np.asarray(flow) ** 2).sum(axis=0))
        write_raw(f"{prefix}magnitude.raw", mag)
