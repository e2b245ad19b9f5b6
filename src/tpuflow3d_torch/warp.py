"""Backward warping, trilinear or tricubic.

Port of ``tpuflow3d.warp``: I1w(x) = I1(x + s(x)) by
backward trilinear or tricubic (separable Catmull-Rom) interpolation with
clamp-to-edge sampling. Coordinates are computed in float32 exactly as the
reference does: clip to [0, dim-1], then floor; the trilinear upper corner
is min(i+1, dim-1), and each of the 4x4x4 tricubic taps is clamped to the
volume on its own. These are the plain versions of kernels K2 and K5
(with ``derivatives.derivatives``).
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


def _trilinear_gather(vol: torch.Tensor, cz, cy, cx,
                      z_offset: int = 0) -> torch.Tensor:
    """Trilinear sample of vol (D,H,W) at real coords; coords must already
    be within [0, dim-1] (clamped by the caller), z after ``z_offset``,
    which shifts the floor of cz into vol's planes (a padded shard's,
    sampled at global coordinates)."""
    d, h, w = vol.shape[-3:]
    z0 = torch.floor(cz)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    fz, fy, fx = cz - z0, cy - y0, cx - x0
    z0 = z0.long() + z_offset
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


def _cubic_weights(f):
    """Catmull-Rom weights for taps (-1, 0, +1, +2) at fraction f in [0,1)
    (interpolating, C^1, 4-point support)."""
    f2 = f * f
    f3 = f2 * f
    return (0.5 * (-f3 + 2.0 * f2 - f),
            0.5 * (3.0 * f3 - 5.0 * f2 + 2.0),
            0.5 * (-3.0 * f3 + 4.0 * f2 + f),
            0.5 * (f3 - f2))


def _tricubic_gather(vol: torch.Tensor, cz, cy, cx,
                     z_offset: int = 0) -> torch.Tensor:
    """Tricubic (separable Catmull-Rom) sample of vol (D,H,W) at real
    coords already within [0, dim-1]; out-of-range taps clamp to the
    boundary. Accumulated in the reference's order (per z tap, pz +=
    wy * (wx * v), then acc += wz * pz), which sets the rounding. Each
    tap's index volume is dropped before the next is made, so only a few
    are ever live (the reference's Z-chunking for TPU memory is not
    needed). ``z_offset`` as in ``_trilinear_gather``."""
    d, h, w = vol.shape[-3:]
    z0 = torch.floor(cz)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    wz = _cubic_weights(cz - z0)
    wy = _cubic_weights(cy - y0)
    wx = _cubic_weights(cx - x0)
    z0 = z0.long() + z_offset
    y0 = y0.long()
    x0 = x0.long()
    flat = vol.reshape(-1)
    acc = None
    for iz in range(4):
        zrow = (z0 + (iz - 1)).clamp_(0, d - 1) * h
        pz = None
        for iy in range(4):
            row = (zrow + (y0 + (iy - 1)).clamp_(0, h - 1)) * w
            for ix in range(4):
                v = flat[row + (x0 + (ix - 1)).clamp_(0, w - 1)]
                term = wy[iy] * (wx[ix] * v)
                pz = term if pz is None else pz + term
            del row
        term = wz[iz] * pz
        acc = term if acc is None else acc + term
    return acc


def warp_volume(i1: torch.Tensor, flow: torch.Tensor, ctx: HaloCtx = HaloCtx(),
                max_disp: float = 0.0,
                interp: str = "trilinear") -> torch.Tensor:
    """Backward-warp the moving volume i1 (D, H, W: the local slab) by
    ``flow`` (3, D, H, W: z, y, x displacements in voxels of the current
    level).

    Under a window context (a streamed slab that already carries its
    margin planes) z is clipped to the true volume in the slab's frame,
    then to the slab itself: clip(clip(z + s_z, -z0, dg-1-z0), 0, D-1).
    Voxels near the slab's faces may then sample a margin plane's replica;
    the streaming loop crops them.

    Under a sharded context ``max_disp`` must bound |s_z| (the pipeline
    passes ``flow_clamp``): the slab is padded by ``warp_halo(max_disp,
    interp)`` planes through ``ctx.zpad``, and z is sampled at global
    coordinates, clip(z0 + z + s_z, 0, dg-1), its floor shifted into the
    padded slab as the integer nh - z0: the one-device
    arithmetic, so a shard's warp has the one-device run's bits. (The
    reference clips in the slab's frame, clip(z + s_z, -z0, dg-1-z0) + nh,
    whose rounding moves with the slab's origin; on ``accurate`` at 256^3
    that put the two-rank flow 2.1e-3 from the one-device flow, past its
    own 2e-4 gate.) One device and the window need no bound."""
    if interp not in ("trilinear", "tricubic"):
        raise ValueError(f"interp must be 'trilinear' or 'tricubic', got "
                         f"{interp!r}")
    d, h, w = i1.shape
    kw = dict(dtype=flow.dtype, device=flow.device)
    zi = torch.arange(d, **kw).reshape(d, 1, 1)
    yi = torch.arange(h, **kw).reshape(1, h, 1)
    xi = torch.arange(w, **kw).reshape(1, 1, w)
    gather = _tricubic_gather if interp == "tricubic" else _trilinear_gather
    cy = (yi + flow[1]).clamp(0.0, h - 1)
    cx = (xi + flow[2]).clamp(0.0, w - 1)
    if ctx.has_z_neighbors:
        if not max_disp > 0.0:
            raise ValueError("a sharded warp needs max_disp > 0 (a flow "
                             "clamp bounds its Z halo)")
        nh = warp_halo(max_disp, interp)
        z0 = ctx.z0(d)
        # z0 + z is exact: the sum rounds as the one-device z + s_z does.
        cz = ((zi + float(z0)) + flow[0]).clamp(0.0, ctx.d_global(d) - 1)
        return gather(ctx.zpad(i1, nh), cz, cy, cx, nh - z0)
    d_global = ctx.d_global(d)
    if ctx.is_window:
        z0 = ctx.z0(d)
        if isinstance(z0, torch.Tensor):
            # A device origin: the bounds as float32 tensors, the values
            # the Python floats below hold (integers, exact in float32).
            lo, hi = (-z0).to(flow.dtype), (d_global - 1 - z0).to(flow.dtype)
        else:
            lo, hi = float(-z0), float(d_global - 1 - z0)
        cz = (zi + flow[0]).clamp(lo, hi).clamp(0.0, d - 1)
    else:
        cz = (zi + flow[0]).clamp(0.0, d_global - 1)
    return gather(i1, cz, cy, cx)
