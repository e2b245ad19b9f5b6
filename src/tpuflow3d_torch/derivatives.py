"""Spatiotemporal derivative stencils.

Port of ``tpuflow3d.derivatives``: central differences (order 2: the
3-point stencil; order 4: the 5-point one) of the averaged volume
Ibar = (I0 + I1w)/2 give the spatial gradient (Iz, Iy, Ix), and
It = I1w - I0; ``grad_constancy_terms`` linearizes the gradient-constancy
assumption. Neumann boundaries via replicate padding;
Z margins through HaloCtx.zpad.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch.grid import HaloCtx, Z_AXIS, neighbor_slices, replicate_pad


def central_diff(x: torch.Tensor, axis: int,
                 ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """0.5 * (x[p + e] - x[p - e]) with replicate edges (one-sided halves at
    the global boundary)."""
    if axis in (Z_AXIS, x.ndim + Z_AXIS):
        xp = ctx.zpad(x, 1)
        axis = Z_AXIS
    else:
        xp = replicate_pad(x, 1, axis=axis)
    return 0.5 * (neighbor_slices(xp, 1, axis, +1)
                  - neighbor_slices(xp, 1, axis, -1))


def central_diff4(x: torch.Tensor, axis: int,
                  ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """4th-order 5-point stencil (-x[p+2] + 8x[p+1] - 8x[p-1] + x[p-2])/12
    with replicate edges (``FlowParams.deriv_order=4``)."""
    if axis in (Z_AXIS, x.ndim + Z_AXIS):
        xp = ctx.zpad(x, 2)
        axis = Z_AXIS
    else:
        xp = replicate_pad(x, 2, axis=axis)
    nb = {d: neighbor_slices(xp, 2, axis, d) for d in (-2, -1, 1, 2)}
    return (-nb[2] + 8.0 * nb[1] - 8.0 * nb[-1] + nb[-2]) * (1.0 / 12.0)


def _diff(order: int):
    if order not in (2, 4):
        raise ValueError("deriv_order must be 2 or 4")
    return central_diff if order == 2 else central_diff4


def grad_constancy_terms(i0: torch.Tensor, i1w: torch.Tensor,
                         ctx: HaloCtx = HaloCtx(), order: int = 2,
                         g: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Linearization terms of the gradient-constancy assumption (Brox et
    al. 2004). For each spatial axis a the residual is r_a = gc_it[a] +
    gc_g[a] . du, with

        gc_it[a] = d_a(I1w) - d_a(I0)
        gc_g[a]  = grad(d_a((I0 + I1w)/2))

    Returns (gc_g (3, 3, D, H, W) indexed [a, component], gc_it (3, D, H,
    W)). Pass ``g``, the gradient ``derivatives`` (or the fused kernel)
    already produced from the same (i0, i1w), to reuse it as the inner
    first derivative."""
    diff = _diff(order)
    axes = (Z_AXIS, -2, -1)
    if g is None:
        ibar = 0.5 * (i0 + i1w)
        g = torch.stack([diff(ibar, a, ctx) for a in axes])
    gc_g = []
    gc_it = []
    for i, a in enumerate(axes):
        gc_g.append(torch.stack([diff(g[i], b, ctx) for b in axes]))
        gc_it.append(diff(i1w, a, ctx) - diff(i0, a, ctx))
    return torch.stack(gc_g), torch.stack(gc_it)


def derivatives(i0: torch.Tensor, i1w: torch.Tensor,
                ctx: HaloCtx = HaloCtx(),
                order: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (g, it): g = (3, D, H, W) spatial gradient (Iz, Iy, Ix) of
    the averaged volume, it = I1w - I0. order: 2 (3-point central) or 4
    (5-point)."""
    diff = _diff(order)
    ibar = 0.5 * (i0 + i1w)
    g = torch.stack([diff(ibar, a, ctx) for a in (Z_AXIS, -2, -1)])
    it = i1w - i0
    return g, it
