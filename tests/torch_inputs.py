"""Inputs of the port's warp and median tests, on the CPU and on the card
(this module imports no JAX: the card's machine has none).

Flows (``make_flow``):
- a float ``m``: uniform random displacements in [-m, m];
- ``"smooth2"``: a smooth flow within +-2 (|flow| <= 1.9), the kind of
  displacement ``accurate`` warps with (flow_clamp 2);
- ``"outlier"``: the smooth flow with one voxel displaced by +40 along each
  axis, which sends the kernel's slabs that sample it to the device-memory
  gathers.
"""

import numpy as np


def smooth_flow(shape) -> np.ndarray:
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape),
                          indexing="ij")
    return np.stack([1.9 * np.sin(2 * np.pi * (x / 23 + y / 31 + z / 37
                                               + k / 3))
                     for k in range(3)]).astype(np.float32)


def make_flow(kind, shape, rng) -> np.ndarray:
    if kind == "smooth2":
        return smooth_flow(shape)
    if kind == "outlier":
        flow = smooth_flow(shape)
        flow[:, shape[0] // 2, shape[1] // 2, shape[2] // 2] = 40.0
        return flow
    return rng.uniform(-kind, kind, (3, *shape)).astype(np.float32)


def median_input(kind, shape, rng) -> np.ndarray:
    """(3, *shape) float32: "normal"; "ties", few distinct values (many
    ties in every window); "const", one value; "zeros", +0.0 and -0.0 with
    a fifth of ones."""
    x = rng.normal(size=(3, *shape)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2.0) / 2.0
    elif kind == "const":
        x[:] = 0.25
    elif kind == "zeros":
        sign = np.where(rng.random(x.shape) < 0.5, -1.0, 1.0)
        x = np.where(rng.random(x.shape) < 0.2, 1.0, sign * 0.0)
    return np.ascontiguousarray(x, np.float32)
