"""A sharded cell's volumes read slab by Z slab, so that no card holds more
than a slab:

- ``epe``: ``gen.epe``'s quantity, the gradient mask's quantile taken over
  the whole volume (the magnitudes kept on the host in float64, two order
  statistics selected there), the sums over ``gen``'s own slabs in its
  order: it equals ``gen.epe`` bit for bit.
- ``compare``: the widest and the mean |difference| of two flows in
  float64, one slab at a time on the device.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flowbench import gen


def _gradient_magnitude(i0: np.ndarray, z0: int, z1: int,
                        device) -> torch.Tensor:
    """|np.gradient(i0)| (float64) on planes [z0, z1): the slab with a
    plane on each side where there is one, so that its central and
    one-sided differences are the whole volume's."""
    a, b = max(z0 - 1, 0), min(z1 + 1, i0.shape[0])
    v = torch.as_tensor(i0[a:b], device=device).double()
    mag = torch.sqrt(sum(g * g for g in torch.gradient(v)))
    return mag[z0 - a:z1 - a]


def _threshold(i0: np.ndarray, quantile: float, device) -> torch.Tensor:
    """``gen.gradient_mask``'s threshold: the ``quantile`` of the whole
    volume's gradient magnitude, np.quantile's linear interpolation."""
    flat = np.empty(i0.size, np.float64)
    plane = i0.shape[1] * i0.shape[2]
    for z0, z1 in gen._slabs(i0.shape):
        flat[z0 * plane:z1 * plane] = _gradient_magnitude(
            i0, z0, z1, device).flatten().cpu().numpy()
    pos = quantile * (flat.size - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, flat.size - 1)
    flat.partition([lo, hi])
    a, b = torch.tensor(flat[[lo, hi]], dtype=torch.float64)
    del flat
    return a + (b - a) * (pos - lo)


def _interior(shape, border: int, z0: int, z1: int, device) -> torch.Tensor:
    """Planes [z0, z1) of ``gen.interior_mask(shape, border)``."""
    d, h, w = shape
    m = torch.zeros((z1 - z0, h, w), dtype=torch.bool, device=device)
    lo, hi = max(border, z0), min(d - border, z1)
    if hi > lo:
        m[lo - z0:hi - z0, border:h - border, border:w - border] = True
    return m


def epe(flow: np.ndarray, i0: np.ndarray, deformation: dict,
        quantile: float, border: int, device) -> float:
    """``gen.epe(flow, i0, ...)`` computed slab by slab."""
    shape = i0.shape
    thr = _threshold(i0, quantile, device)
    total, count = 0.0, 0
    for z0, z1 in gen._slabs(shape):
        m = _gradient_magnitude(i0, z0, z1, device) > thr.to(device)
        m &= _interior(shape, border, z0, z1, device)
        true = gen.true_flow_slab(shape, deformation, z0, z1, device).double()
        est = torch.as_tensor(flow[:, z0:z1], device=device).double()
        err = torch.sqrt(((est - true) ** 2).sum(0))
        total += float(err[m].sum())
        count += int(m.sum())
    if count == 0:
        raise ValueError("epe: empty mask")
    return total / count


def compare(got: np.ndarray, want, device) -> tuple[float, float]:
    """(the widest, the mean) |got - want| over every voxel and component
    of two (3, D, H, W) flows, in float64, one slab at a time on
    ``device``; ``want`` is an array or a tensor on any device. Infinite
    where a difference is not finite."""
    worst, total, count = 0.0, 0.0, 0
    for z0, z1 in gen._slabs(got.shape[1:]):
        a = torch.as_tensor(got[:, z0:z1], device=device).double()
        b = torch.as_tensor(want[:, z0:z1]).to(device).double()
        diff = (a - b).abs()
        del a, b
        if not bool(torch.isfinite(diff).all()):
            return float("inf"), float("inf")
        worst = max(worst, float(diff.max()))
        total += float(diff.sum())
        count += diff.numel()
    return worst, total / count
