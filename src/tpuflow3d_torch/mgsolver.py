"""Geometric multigrid V-cycles on the linearized Euler-Lagrange system.

Port of ``tpuflow3d.mgsolver`` for one device, selected by
``FlowParams(solver="multigrid")``. Per nonlinearity update (frozen psi
weights) the per-voxel system is (sw*I + D) du_p - sum_q w_pq du_q = c
(solver.py). A V-cycle is mg_pre red-black sweeps -> residual -> trilinear
restriction to a ~half-resolution grid -> recursive correction solve ->
trilinear prolongation -> mg_post sweeps, at the damped ``mg_omega``.

- Coarse smoothness weights are rediscretized: psi_s is restricted and the
  directional weights rebuilt at the coarse dims, scaled per axis by
  (coarse_dim/fine_dim)^2, the 1/h^2 of the stencil.
- The data block D (psi_d g g^T, plus the gradient-constancy block when
  gamma > 0) is Galerkin-averaged: its six symmetric entries are restricted
  as a quadratic form. Restricting psi_d and g separately destroys the
  near-rank-1 pointwise structure and the cycle diverges.
- Every level point-solves the general SPD 3x3 through its precomputed
  symmetric inverse. On CUDA tensors every level's smoother is kernel K6
  (``kernels/sor_gc.py``), which takes a half-alpha per axis, so the
  anisotropic levels need no second route (the reference sweeps them in
  XLA), one launch per sweep, or one per smoothing call on a level of at
  most 4096 voxels; the plain version is ``solver.sor_halfsweep`` on the
  level terms.

The streamed out-of-core mode (``piecewise._stream_mg_solve``) stores only
the fine system's constituents (c, psi_s, d6) on the host and rebuilds the
weights and the inverse per slab visit (``assemble_fine_system``,
``fine_residual``); its coarse chain starts from restricted inputs
(``build_coarse_chain(..., inputs_at_first=True)``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuflow3d_torch.backend import use_kernels
from tpuflow3d_torch.grid import HaloCtx, Z_AXIS, neighbor_slices, replicate_pad
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.pyramid import resize3
from tpuflow3d_torch.solver import (SolveTerms, _DIRECTIONS, _face_masks,
                                    _neighbors6, _sym3_inverse, parity_mask,
                                    sor_halfsweep)

_MAX_MG_LEVELS = 8
_COARSEST_MIN = 8  # stop coarsening once any dim would drop below ~4


class MGLevel(NamedTuple):
    """One grid of the hierarchy. (The reference's ``alpha_eff``, which
    gates its one-alpha TPU smoother to uniform levels, has no use here:
    K6 takes ``axis_alpha``.)"""
    terms: SolveTerms      # c=None; w, psi_s and ainv set; rhs set per cycle
    d6: torch.Tensor       # (6, D, H, W) data-matrix entries
                           # (00,01,02,11,12,22), for the residual
    sw: torch.Tensor       # (D, H, W) sum of neighbour weights
    parity: torch.Tensor
    shape_global: tuple[int, int, int]
    psi_s: torch.Tensor    # (D, H, W) smoothness weight at this level
    axis_alpha: tuple      # effective alpha per axis (z, y, x): alpha/h^2


def mg_shapes(shape_global: tuple[int, int, int],
              z_multiple: int) -> list[tuple[int, int, int]]:
    """Global grid shapes, fine -> coarse: halve each axis (Z rounded up
    to z_multiple, the shard count) until any axis hits the floor."""
    shapes = [tuple(shape_global)]
    while len(shapes) < _MAX_MG_LEVELS:
        d, h, w = shapes[-1]
        if min(d, h, w) < _COARSEST_MIN:
            break
        dc = max(z_multiple,
                 z_multiple * ((d // 2 + z_multiple - 1) // z_multiple))
        hc, wc = max(4, (h + 1) // 2), max(4, (w + 1) // 2)
        if (dc, hc, wc) == (d, h, w):
            break
        shapes.append((dc, hc, wc))
    return shapes


def _weights(psi_s, axis_scale, alpha, ctx: HaloCtx):
    """Directional smoothness weights (z+, z-, y+, y-, x+, x-) and their
    sum for one grid, with the per-axis 1/h^2 scale (compute_terms'
    weight block at any dims)."""
    masks = _face_masks(tuple(psi_s.shape), ctx, psi_s.dtype, psi_s.device)
    psi_zp = ctx.zpad(psi_s, 1)
    sw = torch.zeros_like(psi_s)
    w_dirs = []
    for i, (mask, (axis, delta)) in enumerate(zip(masks, _DIRECTIONS)):
        if axis == Z_AXIS:
            pnb = neighbor_slices(psi_zp, 1, Z_AXIS, delta)
        else:
            pnb = neighbor_slices(replicate_pad(psi_s, 1, axis), 1, axis,
                                  delta)
        a_eff = alpha * axis_scale[i // 2]
        wd = a_eff * 0.5 * (psi_s + pnb) * mask
        sw = sw + wd
        w_dirs.append(wd)
    return tuple(w_dirs), sw


def _assemble_level(w, sw, d6, shape_global, parity, psi_s,
                    axis_alpha) -> MGLevel:
    ainv = _sym3_inverse(sw + d6[0], d6[1], d6[2],
                         sw + d6[3], d6[4], sw + d6[5])
    t = SolveTerms(c=None, g=None, w=w, sw_inv=None, smt=None, psi_s=psi_s,
                   ainv=ainv)
    return MGLevel(terms=t, d6=d6, sw=sw, parity=parity,
                   shape_global=shape_global, psi_s=psi_s,
                   axis_alpha=axis_alpha)


def data_block_d6(t: SolveTerms) -> torch.Tensor:
    """The six symmetric data-matrix entries (00,01,02,11,12,22): the
    full block compute_terms assembled when gamma > 0, otherwise the
    rank-1 psi_d g g^T."""
    if t.d6 is not None:
        return t.d6
    g, pd = t.g.to(t.psi_s.dtype), t.psi_d  # g may be stored in bfloat16
    return torch.stack([pd * g[0] * g[0], pd * g[0] * g[1],
                        pd * g[0] * g[2], pd * g[1] * g[1],
                        pd * g[1] * g[2], pd * g[2] * g[2]])


def build_mg_levels(t: SolveTerms, p: FlowParams,
                    ctx: HaloCtx) -> list[MGLevel]:
    """The hierarchy for one frozen nonlinearity update. Level 0 forms D
    from the fine terms; coarser levels restrict psi_s and the six D
    entries."""
    shape = tuple(t.psi_s.shape)
    gshape = (ctx.d_global(shape[0]), shape[1], shape[2])
    shapes = mg_shapes(gshape, ctx.n_shards)
    d6 = data_block_d6(t)
    # (w, sw) rebuilt from psi_s rather than reusing t.w and 1/t.sw_inv:
    # the same weights, but sw as the direct sum instead of the double
    # reciprocal, as the reference.
    w0, sw0 = _weights(t.psi_s, (1.0, 1.0, 1.0), p.alpha, ctx)
    levels = [_assemble_level(w0, sw0, d6, shapes[0],
                              parity_mask(shape, ctx, t.psi_s.device),
                              t.psi_s, (p.alpha,) * 3)]
    levels += build_coarse_chain(t.psi_s, d6, shapes[1:], gshape, p, ctx)
    return levels


def build_coarse_chain(psi_s, d6, shapes, gshape_fine, p: FlowParams,
                       ctx: HaloCtx,
                       inputs_at_first: bool = False) -> list[MGLevel]:
    """Levels for the coarse ``shapes``: psi_s and the six data-matrix
    entries restricted level by level (resize3, the Galerkin quadratic
    form for d6), the weights rebuilt with the cumulative per-axis 1/h^2
    scale against the fine global shape. ``inputs_at_first``: psi_s and d6
    are already at shapes[0] (the streamed mode restricts them while it
    streams), so the first level takes them as they are."""
    levels = []
    for i, shp in enumerate(shapes):
        if i > 0 or not inputs_at_first:
            d6 = resize3(d6, shp, ctx)
            psi_s = resize3(psi_s, shp, ctx)
        axis_scale = tuple((shp[a] / gshape_fine[a]) ** 2 for a in range(3))
        w, sw = _weights(psi_s, axis_scale, p.alpha, ctx)
        levels.append(_assemble_level(
            w, sw, d6, shp, parity_mask(tuple(psi_s.shape), ctx,
                                        psi_s.device),
            psi_s, tuple(p.alpha * s for s in axis_scale)))
    return levels


def assemble_fine_system(c, psi_s, d6, p: FlowParams, ctx: HaloCtx):
    """(SolveTerms of the general system: c, w, psi_s, ainv; and sw) for
    the fine system rebuilt from its streamed constituents (c, psi_s, d6),
    with the arithmetic of ``build_mg_levels``' level 0."""
    w, sw = _weights(psi_s, (1.0, 1.0, 1.0), p.alpha, ctx)
    ainv = _sym3_inverse(sw + d6[0], d6[1], d6[2],
                         sw + d6[3], d6[4], sw + d6[5])
    t = SolveTerms(c=c, g=None, w=w, sw_inv=None, smt=None, psi_s=psi_s,
                   ainv=ainv)
    return t, sw


def fine_residual(du, c, psi_s, d6, p: FlowParams, ctx: HaloCtx):
    """``mg_residual`` on the fine system from its streamed constituents
    (the streamed residual phase), the weights and their sum rebuilt from
    psi_s as the reference's residual does (it takes the sum as an
    argument; here one ``_weights`` call gives both)."""
    w, sw = _weights(psi_s, (1.0, 1.0, 1.0), p.alpha, ctx)
    t = SolveTerms(c=c, g=None, w=w, sw_inv=None, smt=None, psi_s=psi_s)
    lvl = MGLevel(terms=t, d6=d6, sw=sw, parity=None, shape_global=None,
                  psi_s=psi_s, axis_alpha=(p.alpha,) * 3)
    return mg_residual(du, lvl, c, ctx)


def _smooth(du, lvl: MGLevel, rhs, p: FlowParams, n: int, ctx: HaloCtx):
    """n red-black sweeps on lvl's system with right-hand side rhs: K6 on
    CUDA tensors, the plain half-sweep otherwise."""
    t = lvl.terms._replace(c=rhs)
    if use_kernels(p, du):
        from tpuflow3d_torch.kernels.sor_gc import sor_gc_sweeps
        return sor_gc_sweeps(du, t, lvl.axis_alpha, p.mg_omega, n, ctx)
    for _ in range(n):
        du = sor_halfsweep(du, t, p.mg_omega, lvl.parity, 0, ctx)
        du = sor_halfsweep(du, t, p.mg_omega, lvl.parity, 1, ctx)
    return du


def mg_residual(du, lvl: MGLevel, rhs, ctx: HaloCtx):
    """r = rhs + sum_q w du_q - (sw*I + D) du_p, the defect of the
    linearized system at any level. The reference recomputes w from psi_s
    here (so XLA can drop the stored weights); the stored ``terms.w`` are
    the same numbers."""
    r = rhs.to(du.dtype)  # the fine right-hand side may be stored bfloat16
    for wd, dnb in zip(lvl.terms.w, _neighbors6(du, ctx)):
        r = r + wd[None] * dnb
    a = lvl.d6
    d_du = torch.stack([
        a[0] * du[0] + a[1] * du[1] + a[2] * du[2],
        a[1] * du[0] + a[3] * du[1] + a[4] * du[2],
        a[2] * du[0] + a[4] * du[1] + a[5] * du[2],
    ])
    return r - (du * lvl.sw[None] + d_du)


def _vcycle(du, rhs, levels: list[MGLevel], li: int, p: FlowParams,
            ctx: HaloCtx):
    lvl = levels[li]
    du = _smooth(du, lvl, rhs, p, p.mg_pre, ctx)
    if li == len(levels) - 1:
        return _smooth(du, lvl, rhs, p, p.mg_coarse_sweeps, ctx)
    r = mg_residual(du, lvl, rhs, ctx)
    rc = resize3(r, levels[li + 1].shape_global, ctx)
    ec = _vcycle(torch.zeros_like(rc), rc, levels, li + 1, p, ctx)
    du = du + resize3(ec, lvl.shape_global, ctx)
    return _smooth(du, lvl, rhs, p, p.mg_post, ctx)


def mg_solve(du, t: SolveTerms, p: FlowParams, ctx: HaloCtx = HaloCtx(),
             residuals_slot=None, slot_offset: int = 0):
    """Up to p.mg_cycles V-cycles on the frozen linear system ``t`` (c is
    the right-hand side), starting from ``du``; returns the new du.

    With residual_tol > 0 the cycles stop once the mean |update| of a
    cycle falls below it, one host sync per cycle. When ``residuals_slot``
    is given, each cycle's mean |update| is written into it in place at
    [slot_offset + cycle]."""
    levels = build_mg_levels(t, p, ctx)
    track = residuals_slot is not None
    n_global = 3.0 * ctx.d_global(du.shape[-3]) * du.shape[-2] * du.shape[-1]
    for k in range(p.mg_cycles):
        du_new = _vcycle(du, t.c, levels, 0, p, ctx)
        if track or p.residual_tol > 0.0:
            delta = ctx.psum((du_new - du).abs().sum()) / n_global
            if track:
                residuals_slot[slot_offset + k] = delta
        du = du_new
        if p.residual_tol > 0.0 and not bool(delta > p.residual_tol):
            break
    return du
