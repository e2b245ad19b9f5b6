"""Relaxation solver for the coupled Euler-Lagrange system.

Port of ``tpuflow3d.solver`` (SOR, Jacobi, and the dispatch to multigrid).
Per nonlinearity update the Charbonnier weights and the constant part of
the right-hand side are computed once; each sweep is then a 6-neighbour
stencil over the increment field, with an exact point solve of the
per-voxel system. Intensity constancy alone gives A = sw*I + psi_d*g g^T,
solved by Sherman-Morrison:

    A^-1 b = b/sw - g * (psi_d * (g.b)) / (sw * (sw + psi_d*|g|^2))

With gradient constancy (gamma > 0) A gains psi_g * sum_a h_a h_a^T and is
a general SPD 3x3, whose symmetric inverse is precomputed per nonlinearity
update (``SolveTerms.ainv``).

Red/black colouring uses the *global* parity of (z+y+x). On CUDA tensors
the SOR sweeps run hand-written kernels. With
``sweep_layout="flat"``, and on any level of odd W: K1
(``kernels/sor.py``) for the rank-1 system, K6 (``kernels/sor_gc.py``) for
the general one, red and black fused in one launch per sweep, all sweeps
of an inner iteration in one wrapper call unless the early stop or the
residual track needs each sweep's update; ``sor_halfsweep`` here is the
plain version of both. With
``sweep_layout="packed"`` at even W: K4 (``kernels/sor_packed.py``) and K7
(``kernels/sor_gc_packed.py``) on colour-packed arrays, each with its
plain version beside its wrapper. ``backend="plain"`` always sweeps flat
and plain, and multigrid always smooths flat (K6).

``terms_dtype="bfloat16"`` stores ``c`` and ``g`` in bfloat16 (storage
only: every consumer widens them and computes in float32). ``SolveTerms``
is then the reference's, ``smt`` of the unrounded g included; the rank-1
sweeps, kernel and plain, solve with the stored g as the reference's Pallas
kernels do, which its XLA sweep does not (``_du_star``).
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
    """Per-nonlinear-iteration constants consumed by the sweeps. K1 reads
    only (c, g, psi_s, psi_d) and K6 only (c, ainv, psi_s); both recompute
    the weights. The plain sweep reads (c, w) and either (g, sw_inv, smt)
    or ainv."""
    c: torch.Tensor       # (3, D, H, W) constant RHS part
    g: torch.Tensor       # (3, D, H, W) spatial gradient
    w: tuple              # 6 x (D, H, W) neighbour weights z+, z-, y+, y-, x+, x-
    sw_inv: torch.Tensor  # (D, H, W) 1 / sum_q w_pq
    smt: torch.Tensor     # (D, H, W) psi_d / (sw * (sw + psi_d*|g|^2))
    psi_s: torch.Tensor = None  # (D, H, W) smoothness penalizer derivative
    psi_d: torch.Tensor = None  # (D, H, W) data penalizer derivative
    ainv: torch.Tensor = None   # (6, D, H, W) symmetric A^-1 rows
                                # (00,01,02,11,12,22): gamma > 0 and
                                # multigrid, where A is a general SPD 3x3
    d6: torch.Tensor = None     # (6, D, H, W) data-matrix entries D =
                                # psi_d g g^T + psi_g sum_a h_a h_a^T (no sw
                                # on the diagonal): gamma > 0 only; the
                                # multigrid hierarchy restricts them


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


def _sym3_inverse(m00, m01, m02, m11, m12, m22) -> torch.Tensor:
    """Inverse of a symmetric 3x3 (SPD here: sw*I + PSD data terms) via
    the adjugate; rows (00,01,02,11,12,22) stacked on a leading axis."""
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det_inv = 1.0 / (m00 * c00 + m01 * c01 + m02 * c02)
    return torch.stack([c00, c01, c02, c11, c12, c22]) * det_inv


def _nb(src, src_zp, axis, delta):
    """src's neighbour along (axis, delta), replicate edges; src_zp is src
    padded by one plane along Z (through the context)."""
    if axis == Z_AXIS:
        return neighbor_slices(src_zp, 1, Z_AXIS, delta)
    return neighbor_slices(replicate_pad(src, 1, axis), 1, axis, delta)


def _weight_block(psi_s: torch.Tensor, alpha: float, ctx: HaloCtx):
    """Directional weights w_pq = alpha*(psi_s[p]+psi_s[q])/2, zero across
    global faces, in the order z+, z-, y+, y-, x+, x-, and their sum sw
    accumulated in that order (the order sets the rounding)."""
    shape = tuple(psi_s.shape)
    masks = _face_masks(shape, ctx, psi_s.dtype, psi_s.device)
    half_alpha = float(np.float32(alpha)) * 0.5
    psi_zp = ctx.zpad(psi_s, 1)
    sw = torch.zeros(shape, dtype=psi_s.dtype, device=psi_s.device)
    w_dirs = []
    for mask, (axis, delta) in zip(masks, _DIRECTIONS):
        wd = half_alpha * (psi_s + _nb(psi_s, psi_zp, axis, delta)) * mask
        sw = sw + wd
        w_dirs.append(wd)
    return tuple(w_dirs), sw


def sweep_terms(c: torch.Tensor, g, psi_s: torch.Tensor, aux: torch.Tensor,
                p: FlowParams, ctx: HaloCtx = HaloCtx()) -> SolveTerms:
    """The SolveTerms of a sweep rebuilt from the compact constants that
    the kernels read: (c, g, psi_s, psi_d) of the rank-1 system (aux =
    psi_d), or (c, psi_s, ainv) of the general one (g None, aux = ainv).
    The weights, sw_inv and smt are made with ``compute_terms``' arithmetic,
    so they are its bits wherever psi_s and its neighbours are; c and g
    are stored as ``p.terms_dtype`` (g float32 and unrounded on entry, as
    ``compute_terms`` takes it). The streamed mode keeps only these on the
    host and rebuilds the rest per slab."""
    w, sw = _weight_block(psi_s, p.alpha, ctx)
    store = getattr(torch, p.terms_dtype)
    if g is None:
        return SolveTerms(c=c.to(store), g=None, w=w, sw_inv=None, smt=None,
                          psi_s=psi_s, ainv=aux)
    sw_inv = 1.0 / sw
    smt = aux * sw_inv / (sw + aux * (g * g).sum(0))
    return SolveTerms(c=c.to(store), g=g.to(store), w=w, sw_inv=sw_inv,
                      smt=smt, psi_s=psi_s, psi_d=aux)


def compute_terms(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                  du: torch.Tensor, p: FlowParams,
                  ctx: HaloCtx = HaloCtx(), gc=None) -> SolveTerms:
    """Nonlinearity update: recompute psi' weights and RHS constants for the
    current increment estimate.

    ``gc``: (gc_g, gc_it) from ``derivatives.grad_constancy_terms``,
    required exactly when p.gamma > 0. It adds gamma*psi_g * sum_a h_a
    h_a^T to the point system, whose exact symmetric inverse is then
    precomputed (``ainv``) together with the data block (``d6``)."""
    if (p.gamma > 0.0) != (gc is not None):
        raise ValueError("gamma > 0 requires grad_constancy_terms (and "
                         "vice versa)")
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
    w_dirs, sw = _weight_block(psi_s, p.alpha, ctx)
    nbu = torch.zeros_like(flow)
    flow_zp = ctx.zpad(flow, 1)
    for wd, (axis, delta) in zip(w_dirs, _DIRECTIONS):
        nbu = nbu + wd[None] * (_nb(flow, flow_zp, axis, delta) - flow)
    c = -(psi_d * it)[None] * g + nbu
    sw_inv = 1.0 / sw
    q = psi_d * (g * g).sum(0)
    smt = psi_d * sw_inv / (sw + q)

    ainv = d6 = None
    if gc is not None:
        # Gradient constancy: one robust penalizer over the summed per-axis
        # derivative residuals r_a = gc_it[a] + gc_g[a].du, weighted by
        # gamma; A = sw*I + psi_d g g^T + psi_g sum_a h_a h_a^T.
        gc_g, gc_it = gc
        r_g = gc_it + (gc_g * du[None]).sum(1)
        psi_g = float(np.float32(p.gamma)) * _psi_deriv(
            (r_g * r_g).sum(0), p.penalizer_grad, p.eps_grad)
        c = c - ((psi_g[None] * gc_it)[:, None] * gc_g).sum(0)

        def d_entry(i, j):
            return (psi_d * g[i] * g[j]
                    + psi_g * (gc_g[:, i] * gc_g[:, j]).sum(0))
        d6 = torch.stack([d_entry(0, 0), d_entry(0, 1), d_entry(0, 2),
                          d_entry(1, 1), d_entry(1, 2), d_entry(2, 2)])
        ainv = _sym3_inverse(d6[0] + sw, d6[1], d6[2],
                             d6[3] + sw, d6[4], d6[5] + sw)
    # Storage-only downcast of the sweep constants c and g, at the end as
    # in the reference: smt, ainv and d6 are those of the unrounded g.
    store = getattr(torch, p.terms_dtype)
    return SolveTerms(c=c.to(store), g=g.to(store), w=w_dirs,
                      sw_inv=sw_inv, smt=smt, psi_s=psi_s, psi_d=psi_d,
                      ainv=ainv, d6=d6)


def _du_star(du: torch.Tensor, t: SolveTerms, ctx: HaloCtx) -> torch.Tensor:
    """Exact pointwise solution A^-1 b given current neighbour values of du."""
    b = t.c.to(du.dtype)  # the terms may be stored in bfloat16
    for wd, dnb in zip(t.w, _neighbors6(du, ctx)):
        b = b + wd[None] * dnb
    if t.ainv is not None:
        # General SPD system: x = A^-1 b with the precomputed symmetric
        # inverse (rows 00,01,02,11,12,22); g is not read.
        a = t.ainv
        return torch.stack([
            a[0] * b[0] + a[1] * b[1] + a[2] * b[2],
            a[1] * b[0] + a[3] * b[1] + a[4] * b[2],
            a[2] * b[0] + a[4] * b[1] + a[5] * b[2],
        ])
    g = t.g.to(du.dtype)
    smt = t.smt
    if t.g.dtype != du.dtype:
        # g is stored rounded: sw*I + psi_d g g^T has the Sherman-Morrison
        # inverse only with smt made from the g the sweep multiplies with,
        # so it is remade from the stored g, as the kernels (and the
        # reference's Pallas kernels) do. The reference's XLA sweep keeps
        # t.smt, that of the unrounded g.
        sw = torch.zeros_like(t.sw_inv)
        for wd in t.w:
            sw = sw + wd
        smt = t.psi_d * t.sw_inv / (sw + t.psi_d * (g * g).sum(0))
    gb = (g * b).sum(0)
    return b * t.sw_inv[None] - g * (gb * smt)[None]


def sor_halfsweep(du: torch.Tensor, t: SolveTerms, omega: float,
                  parity: torch.Tensor, color: int,
                  ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """One red-black half-sweep: relax the voxels of ``color``, keep the
    others (plain version of kernel K1, and of K6 when ``t.ainv`` is set)."""
    star = _du_star(du, t, ctx)
    new = (1.0 - omega) * du + omega * star
    return torch.where((parity == color)[None], new, du)


def jacobi_sweep(du: torch.Tensor, t: SolveTerms, omega: float,
                 ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    star = _du_star(du, t, ctx)
    return (1.0 - omega) * du + omega * star


def _packed_sweeper(du: torch.Tensor, t: SolveTerms, p: FlowParams,
                    ctx: HaloCtx):
    """The colour-packed form of one inner iteration's sweeps: packs du and
    the sweep constants ((c, ainv, psi_s) with gamma > 0, else (c, g,
    psi_s, psi_d)) once, an exact permutation amortized over p.sweeps
    sweeps, and fetches the psi_s halos once, or none on a whole volume
    (the kernels replicate its faces in place). Returns the packed (red,
    black) pair of du and the function that runs one red+black sweep on
    such a pair through K4 or K7 (their plain versions for CPU tensors)."""
    from tpuflow3d_torch.kernels.sor_packed import pack_color
    d = du.shape[-3]
    z0, dg = int(ctx.z0(d)), ctx.d_global(d)
    if p.gamma > 0.0:
        from tpuflow3d_torch.kernels.sor_gc_packed import (
            sor_halfsweep_gc_packed as halfsweep)
        fields = (t.c, t.ainv)
    else:
        from tpuflow3d_torch.kernels.sor_packed import (
            sor_halfsweep_packed as halfsweep)
        fields = (t.c, t.g)
    # Per colour: the fields before psi_s, psi_s, the fields after it.
    head = [[pack_color(a, col, z0) for a in fields] for col in (0, 1)]
    ps = [pack_color(t.psi_s, col, z0) for col in (0, 1)]
    tail = [[] if p.gamma > 0.0 else [pack_color(t.psi_d, col, z0)]
            for col in (0, 1)]
    whole = ctx.is_whole(d)
    ps_halos = [(None, None) if whole else ctx.z_halo_planes(x) for x in ps]

    def one_sweep(pair):
        pair = list(pair)
        for col in (0, 1):
            other = 1 - col
            lo, hi = ((None, None) if whole
                      else ctx.z_halo_planes(pair[other]))
            pair[col] = halfsweep(
                pair[col], pair[other], *head[col], ps[col], ps[other],
                *tail[col], lo, hi, *ps_halos[other], z0, p.alpha, p.omega,
                col, dg)
        return tuple(pair)

    return (pack_color(du, 0, z0), pack_color(du, 1, z0)), one_sweep


def solve_increment(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                    p: FlowParams, ctx: HaloCtx, parity: torch.Tensor,
                    residuals_slot: torch.Tensor | None = None, gc=None):
    """Full inner solve: nonlinearity loop x (sweep loop or multigrid
    V-cycles). Returns the flow increment; when ``residuals_slot`` (an
    (inner*sweeps,) tensor) is given, writes the per-sweep (per-cycle for
    multigrid) mean update norm into it in place. ``gc``: the
    gradient-constancy terms, required exactly when p.gamma > 0; SOR then
    sweeps the general SPD system (K6, or K7 packed, on CUDA).

    SOR sweeps colour-packed when ``p.sweep_layout == "packed"``, W is
    even and the backend is not "plain", on any device: the wrappers run
    K4/K7 for CUDA tensors and their plain versions for CPU tensors. A
    level of odd W sweeps flat, as in the reference; the reference's
    W >= 256 gate is about the TPU's 128-lane tile and is not copied.

    With ``residual_tol`` > 0 the sweeps (cycles) of each inner iteration
    stop once the mean update norm falls below it; the test costs one host
    sync per sweep (cycle)."""
    du = torch.zeros_like(flow)
    track = residuals_slot is not None
    n_global = 3.0 * ctx.d_global(it.shape[-3]) * it.shape[-2] * it.shape[-1]
    kernel_sweeps = p.solver == "sor" and use_kernels(p, g)
    packed = (p.solver == "sor" and p.sweep_layout == "packed"
              and p.backend != "plain" and it.shape[-1] % 2 == 0)
    if kernel_sweeps and not packed:
        if p.gamma > 0.0:
            from tpuflow3d_torch.kernels.sor_gc import sor_gc_sweeps
        else:
            from tpuflow3d_torch.kernels.sor import sor_sweeps

    def flat_sweeps(du, t, n):
        """n sweeps; the kernels take all n in one call (out-of-place: the
        du passed in survives)."""
        if kernel_sweeps:
            if p.gamma > 0.0:
                return sor_gc_sweeps(du, t, (p.alpha,) * 3, p.omega, n, ctx)
            return sor_sweeps(du, t, p.alpha, p.omega, n, ctx)
        for _ in range(n):
            if p.solver == "sor":
                du = sor_halfsweep(du, t, p.omega, parity, 0, ctx)
                du = sor_halfsweep(du, t, p.omega, parity, 1, ctx)
            else:
                du = jacobi_sweep(du, t, p.jacobi_omega(), ctx)
        return du

    def mean_update(new, old):
        """Mean |update| of a sweep; over the colour pair when packed."""
        if packed:
            total = sum((a - b).abs().sum() for a, b in zip(new, old))
        else:
            total = (new - old).abs().sum()
        return ctx.psum(total) / n_global

    for k in range(p.inner_iterations):
        t = compute_terms(g, it, flow, du, p, ctx, gc=gc)
        if p.solver == "multigrid":
            from tpuflow3d_torch.mgsolver import mg_solve
            du = mg_solve(du, t, p, ctx, residuals_slot, k * p.sweeps)
            continue
        if packed:
            state, one_sweep = _packed_sweeper(du, t, p, ctx)
        elif not (track or p.residual_tol > 0.0):
            du = flat_sweeps(du, t, p.sweeps)
            continue
        else:
            # The early stop and the residual track compare each sweep with
            # the one before: one sweep at a time.
            state, one_sweep = du, lambda x: flat_sweeps(x, t, 1)
        for s in range(p.sweeps):
            new = one_sweep(state)
            if track or p.residual_tol > 0.0:
                r = mean_update(new, state)
                if track:
                    residuals_slot[k * p.sweeps + s] = r
            state = new
            if p.residual_tol > 0.0 and not bool(r > p.residual_tol):
                break
        if packed:
            from tpuflow3d_torch.kernels.sor_packed import unpack_colors
            du = unpack_colors(*state, int(ctx.z0(du.shape[-3])))
        else:
            du = state
    return du
