"""Relaxation solver for the coupled Euler-Lagrange system.

Port of ``tpuflow3d.solver`` (rank-1 data term; SOR and Jacobi). Per
nonlinearity update the Charbonnier weights and the constant part of the
right-hand side are computed once; each sweep is then a 6-neighbour
stencil over the increment field, with the exact Sherman-Morrison solve
of the per-voxel system A = sw*I + psi_d*g g^T:

    A^-1 b = b/sw - g * (psi_d * (g.b)) / (sw * (sw + psi_d*|g|^2))

Red/black colouring uses the *global* parity of (z+y+x). On CUDA tensors
the SOR half-sweep runs the hand-written kernel (``kernels/sor.py``);
``sor_halfsweep`` here is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuflow3d_torch.backend import use_kernels
from tpuflow3d_torch.derivatives import central_diff
from tpuflow3d_torch.grid import HaloCtx, Z_AXIS, neighbor_slices, replicate_pad
from tpuflow3d_torch.params import FlowParams

_DIRECTIONS = ((Z_AXIS, +1), (Z_AXIS, -1), (-2, +1), (-2, -1),
               (-1, +1), (-1, -1))  # z+, z-, y+, y-, x+, x-


class SolveTerms(NamedTuple):
    """Per-nonlinear-iteration constants consumed by the sweeps. The kernel
    reads only (c, g, psi_s, psi_d) and recomputes the weights; the plain
    sweep reads (c, g, w, sw_inv, smt)."""
    c: torch.Tensor       # (3, D, H, W) constant RHS part
    g: torch.Tensor       # (3, D, H, W) spatial gradient
    w: tuple              # 6 x (D, H, W) neighbour weights z+, z-, y+, y-, x+, x-
    sw_inv: torch.Tensor  # (D, H, W) 1 / sum_q w_pq
    smt: torch.Tensor     # (D, H, W) psi_d / (sw * (sw + psi_d*|g|^2))
    psi_s: torch.Tensor   # (D, H, W) smoothness penalizer derivative
    psi_d: torch.Tensor   # (D, H, W) data penalizer derivative


def _psi_deriv(q2: torch.Tensor, penalizer: str, eps: float) -> torch.Tensor:
    """Psi'(q^2) up to a constant: Charbonnier 1/sqrt(q^2 + eps^2)."""
    if penalizer == "quadratic":
        return torch.ones_like(q2)
    return torch.rsqrt(q2 + eps * eps)


def parity_mask(shape_local: tuple[int, int, int], ctx: HaloCtx,
                device=None) -> torch.Tensor:
    """(D,H,W) global parity of (z + y + x): 0 = red, 1 = black."""
    d, h, w = shape_local
    zg = ctx.z_global(d, device)
    iy = torch.arange(h, device=device).reshape(1, h, 1)
    ix = torch.arange(w, device=device).reshape(1, 1, w)
    return (zg + iy + ix) & 1


def _neighbors6(x: torch.Tensor, ctx: HaloCtx) -> list[torch.Tensor]:
    """Values at the 6 neighbours (z+, z-, y+, y-, x+, x-), replicate edges.
    Works for (D,H,W) and (3,D,H,W)."""
    xp = ctx.zpad(x, 1)
    out = [neighbor_slices(xp, 1, Z_AXIS, +1),
           neighbor_slices(xp, 1, Z_AXIS, -1)]
    for axis in (-2, -1):
        xp = replicate_pad(x, 1, axis=axis)
        out.append(neighbor_slices(xp, 1, axis, +1))
        out.append(neighbor_slices(xp, 1, axis, -1))
    return out


def _face_masks(shape_local: tuple[int, int, int], ctx: HaloCtx,
                dtype, device=None) -> list[torch.Tensor]:
    """Validity of each of the 6 neighbours (0 at global faces -> true
    Neumann: missing neighbours are excluded from the system)."""
    d, h, w = shape_local
    dg = ctx.d_global(d)
    zg = ctx.z_global(d, device)
    iy = torch.arange(h, device=device).reshape(1, h, 1)
    ix = torch.arange(w, device=device).reshape(1, 1, w)
    zeros = torch.zeros((d, h, w), dtype=dtype, device=device)
    return [
        (zg < dg - 1).to(dtype) + zeros,
        (zg > 0).to(dtype) + zeros,
        (iy < h - 1).to(dtype) + zeros,
        (iy > 0).to(dtype) + zeros,
        (ix < w - 1).to(dtype) + zeros,
        (ix > 0).to(dtype) + zeros,
    ]


def compute_terms(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                  du: torch.Tensor, p: FlowParams,
                  ctx: HaloCtx = HaloCtx()) -> SolveTerms:
    """Nonlinearity update: recompute psi' weights and RHS constants for the
    current increment estimate."""
    if p.gamma > 0.0:
        raise NotImplementedError(
            "gamma > 0 is not ported yet (ROADMAP queue 2, K6)")
    if p.terms_dtype != str(g.dtype).removeprefix("torch."):
        raise NotImplementedError(
            "terms_dtype other than the solver dtype is not ported yet "
            "(ROADMAP queue 1, item 5)")
    dtype = g.dtype
    shape = tuple(it.shape)

    # Data term weight from the linearized residual.
    r = it + (g * du).sum(0)
    psi_d = _psi_deriv(r * r, p.penalizer_data, p.eps_data)

    # Smoothness weight from |grad(total flow)|^2 (flow-driven isotropic).
    total = flow + du
    s2 = torch.zeros(shape, dtype=dtype, device=g.device)
    for axis in (Z_AXIS, -2, -1):
        dgrad = central_diff(total, axis, ctx)
        s2 = s2 + (dgrad * dgrad).sum(0)
    psi_s = _psi_deriv(s2, p.penalizer_smooth, p.eps_smooth)

    # Directional weights w_pq = alpha*(psi_s[p]+psi_s[q])/2, zero across
    # global faces, and the constant RHS -psi_d*g*It + sum_q
    # w_pq*(u[q]-u[p]) (smoothness acts on the total flow u+du; the du[q]
    # part is added fresh each sweep). One direction at a time, in the
    # order z+, z-, y+, y-, x+, x-: the order sets the rounding.
    masks = _face_masks(shape, ctx, dtype, g.device)
    half_alpha = float(np.float32(p.alpha)) * 0.5
    sw = torch.zeros(shape, dtype=dtype, device=g.device)
    nbu = torch.zeros_like(flow)
    flow_zp = ctx.zpad(flow, 1)
    psi_zp = ctx.zpad(psi_s, 1)

    def nb(src, src_zp, axis, delta):
        if axis == Z_AXIS:
            return neighbor_slices(src_zp, 1, Z_AXIS, delta)
        return neighbor_slices(replicate_pad(src, 1, axis), 1, axis, delta)

    w_dirs = []
    for mask, (axis, delta) in zip(masks, _DIRECTIONS):
        wd = half_alpha * (psi_s + nb(psi_s, psi_zp, axis, delta)) * mask
        sw = sw + wd
        nbu = nbu + wd[None] * (nb(flow, flow_zp, axis, delta) - flow)
        w_dirs.append(wd)
    c = -(psi_d * it)[None] * g + nbu
    sw_inv = 1.0 / sw
    q = psi_d * (g * g).sum(0)
    smt = psi_d * sw_inv / (sw + q)
    return SolveTerms(c=c, g=g, w=tuple(w_dirs), sw_inv=sw_inv, smt=smt,
                      psi_s=psi_s, psi_d=psi_d)


def _du_star(du: torch.Tensor, t: SolveTerms, ctx: HaloCtx) -> torch.Tensor:
    """Exact pointwise solution A^-1 b given current neighbour values of du."""
    b = t.c
    for wd, dnb in zip(t.w, _neighbors6(du, ctx)):
        b = b + wd[None] * dnb
    gb = (t.g * b).sum(0)
    return b * t.sw_inv[None] - t.g * (gb * t.smt)[None]


def sor_halfsweep(du: torch.Tensor, t: SolveTerms, omega: float,
                  parity: torch.Tensor, color: int,
                  ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """One red-black half-sweep: relax the voxels of ``color``, keep the
    others (plain version of kernel K1)."""
    star = _du_star(du, t, ctx)
    new = (1.0 - omega) * du + omega * star
    return torch.where((parity == color)[None], new, du)


def jacobi_sweep(du: torch.Tensor, t: SolveTerms, omega: float,
                 ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    star = _du_star(du, t, ctx)
    return (1.0 - omega) * du + omega * star


def solve_increment(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                    p: FlowParams, ctx: HaloCtx, parity: torch.Tensor,
                    residuals_slot: torch.Tensor | None = None):
    """Full inner solve: nonlinearity loop x sweep loop. Returns the flow
    increment; when ``residuals_slot`` (an (inner*sweeps,) tensor) is
    given, writes the per-sweep mean update norm into it in place.

    With ``residual_tol`` > 0 the sweeps of each inner iteration stop once
    the mean update norm falls below it; the test costs one host sync per
    sweep."""
    if p.solver == "multigrid":
        raise NotImplementedError(
            "solver='multigrid' is not ported yet (ROADMAP queue 1, item 9)")
    du = torch.zeros_like(flow)
    track = residuals_slot is not None
    n_global = 3.0 * ctx.d_global(it.shape[-3]) * it.shape[-2] * it.shape[-1]
    kernel_sweeps = p.solver == "sor" and use_kernels(p, g)
    if kernel_sweeps:
        from tpuflow3d_torch.kernels.sor import sor_halfsweep as sor_kernel

    def one_sweep(du, t):
        if kernel_sweeps:
            for color in (0, 1):
                du = sor_kernel(du, t, p.alpha, p.omega, color, ctx)
            return du
        if p.solver == "sor":
            du = sor_halfsweep(du, t, p.omega, parity, 0, ctx)
            return sor_halfsweep(du, t, p.omega, parity, 1, ctx)
        return jacobi_sweep(du, t, p.jacobi_omega(), ctx)

    def mean_update(du1, du):
        return ctx.psum((du1 - du).abs().sum()) / n_global

    for k in range(p.inner_iterations):
        t = compute_terms(g, it, flow, du, p, ctx)
        for s in range(p.sweeps):
            du1 = one_sweep(du, t)
            if track or p.residual_tol > 0.0:
                r = mean_update(du1, du)
                if track:
                    residuals_slot[k * p.sweeps + s] = r
            du = du1
            if p.residual_tol > 0.0 and not bool(r > p.residual_tol):
                break
    return du
