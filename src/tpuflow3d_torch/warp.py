"""Backward trilinear warping.

Port of ``tpuflow3d.warp`` for one device: I1w(x) = I1(x + s(x)) by
backward trilinear interpolation with clamp-to-edge sampling. Coordinates
are computed in float32 exactly as the reference does: clip to
[0, dim-1], then floor, then the upper corner min(i+1, dim-1).
"""

from __future__ import annotations

import math

import torch

from tpuflow3d_torch.grid import HaloCtx


def warp_halo(max_disp: float, interp: str = "trilinear") -> int:
    """Z halo planes needed to warp with |s_z| <= max_disp: the farthest
    integer tap is ceil(|s|)+1 for the trilinear cell, one more for the
    cubic kernel's outer taps."""
    return int(math.ceil(max_disp)) + 1 + (1 if interp == "tricubic" else 0)


def _trilinear_gather(vol: torch.Tensor, cz, cy, cx) -> torch.Tensor:
    """Trilinear sample of vol (D,H,W) at real coords; coords must already
    be within [0, dim-1] (clamped by the caller)."""
    d, h, w = vol.shape[-3:]
    z0 = torch.floor(cz)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    fz, fy, fx = cz - z0, cy - y0, cx - x0
    z0 = z0.long()
    y0 = y0.long()
    x0 = x0.long()
    z1 = (z0 + 1).clamp_max(d - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    flat = vol.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    c000 = at(z0, y0, x0)
    c001 = at(z0, y0, x1)
    c010 = at(z0, y1, x0)
    c011 = at(z0, y1, x1)
    c100 = at(z1, y0, x0)
    c101 = at(z1, y0, x1)
    c110 = at(z1, y1, x0)
    c111 = at(z1, y1, x1)

    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def warp_volume(i1: torch.Tensor, flow: torch.Tensor, ctx: HaloCtx = HaloCtx(),
                interp: str = "trilinear") -> torch.Tensor:
    """Backward-warp the moving volume i1 (D, H, W) by ``flow`` (3, D, H, W:
    z, y, x displacements in voxels of the current level). On one device
    no displacement bound is needed (the sharded reference needs
    ``max_disp`` to size its Z halo, see ``warp_halo``)."""
    if interp != "trilinear":
        raise NotImplementedError(
            "interp='tricubic' is not ported yet (ROADMAP queue 2, K5)")
    d, h, w = i1.shape
    d_global = ctx.d_global(d)
    kw = dict(dtype=flow.dtype, device=flow.device)
    zi = torch.arange(d, **kw).reshape(d, 1, 1)
    yi = torch.arange(h, **kw).reshape(1, h, 1)
    xi = torch.arange(w, **kw).reshape(1, 1, w)
    cz = (zi + flow[0]).clamp(0.0, d_global - 1)
    cy = (yi + flow[1]).clamp(0.0, h - 1)
    cx = (xi + flow[2]).clamp(0.0, w - 1)
    return _trilinear_gather(i1, cz, cy, cx)
