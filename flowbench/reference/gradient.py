"""The plain reference with gradient constancy: ``solve.py``'s float32
coarse-to-fine solve with the gradient-constancy term of Brox, Bruhn,
Papenberg and Weickert (ECCV 2004) weighted by ``gamma`` >= 0.

What gamma adds is written here operation for operation as
``tpuflow3d_torch``'s plain versions compute it, so that it rounds as
they do: the terms of ``derivatives.grad_constancy_terms`` (2-point,
the gradient of the averaged volume reused as the inner derivative);
``solver.compute_terms``' gradient-constancy branch (the residuals
``r_g``, ``psi_g`` with ``penalizer_grad``/``eps_grad``, the right-hand
side, the data block ``d6`` and its symmetric inverse ``ainv``); the
general-SPD point solve of the SOR half-sweep; and a multigrid hierarchy
restricted from the full ``d6``. Everything else is ``solve.py``'s,
imported and not copied: the pyramids, the warp, the rank-1 terms, the
sweeps, the V-cycle, the early stop and the median. At gamma 0 it is
``solve.solve``, bit for bit. Served: in core, ``deriv_order`` 2, SOR or
multigrid, trilinear or tricubic, float32; anything else raises. It
imports nothing of the program.

Memory: the gradient-constancy terms and ``compute_terms``' branch run
over slabs of Z planes (``solve._slabs``) into whole-volume results;
each voxel is computed from the whole input as unsliced (the Z stencils
read their neighbour planes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from flowbench.reference import solve as S

_AXES = (S.Z, -2, -1)
# d6's entries (00, 01, 02, 11, 12, 22), in compute_terms' order.
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


@dataclass(frozen=True)
class Params(S.Params):
    """``solve.Params`` with the gradient-constancy penalizer, which is
    arithmetic here, and gamma >= 0."""
    penalizer_grad: str = "charbonnier"
    eps_grad: float = 1e-3

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        gamma = float(d.get("gamma", 0.0))
        if gamma < 0.0:
            raise ValueError("reference: gamma must be >= 0")
        # Everything else is checked as solve.py checks it.
        fields = dataclasses.asdict(S.Params.from_dict({**d, "gamma": 0.0}))
        fields.update(gamma=gamma,
                      penalizer_grad=d.get("penalizer_grad", "charbonnier"),
                      eps_grad=float(d.get("eps_grad", 1e-3)))
        return cls(**fields)


def _slab_diff(x, axis: int, z0: int, z1: int):
    """``central_diff(x, axis)`` at planes [z0, z1) of x (..., D, H, W),
    from those planes and one on each side."""
    lo, hi = max(z0 - 1, 0), min(z1 + 1, x.shape[-3])
    return S.central_diff(x[..., lo:hi, :, :], axis)[..., z0 - lo:z1 - lo,
                                                     :, :]


def grad_constancy_terms(i0, i1w, g):
    """(gc_g (3, 3, D, H, W) indexed [a, component], gc_it (3, D, H, W)):
    gc_it[a] = d_a(I1w) - d_a(I0), gc_g[a] = grad(d_a(Ibar)) with
    d_a(Ibar) = g[a], slab by slab."""
    gc_g = torch.empty((3, 3, *i0.shape), dtype=g.dtype, device=g.device)
    gc_it = torch.empty((3, *i0.shape), dtype=g.dtype, device=g.device)
    for z0, z1 in S._slabs(tuple(i0.shape)):
        for i, a in enumerate(_AXES):
            for j, b in enumerate(_AXES):
                gc_g[i, j, z0:z1] = _slab_diff(g[i], b, z0, z1)
            gc_it[i, z0:z1] = (_slab_diff(i1w, a, z0, z1)
                               - _slab_diff(i0, a, z0, z1))
    return gc_g, gc_it


def compute_terms(g, it, flow, du, p: Params, gc=None):
    """(terms, d6): ``solve.compute_terms``' rank-1 terms, and with the
    gradient-constancy terms ``gc`` the general system: c less the
    gradient-constancy right-hand side, ``ainv`` the inverse of sw*I + d6,
    and d6 = psi_d g g^T + psi_g sum_a h_a h_a^T (None without ``gc``)."""
    t = S.compute_terms(g, it, flow, du, p)
    if gc is None:
        return t, None
    gc_g, gc_it = gc
    gamma = float(np.float32(p.gamma))
    c = t.c
    d6 = torch.empty((6, *it.shape), dtype=g.dtype, device=g.device)
    ainv = torch.empty_like(d6)
    for z0, z1 in S._slabs(tuple(it.shape)):
        z = slice(z0, z1)
        h, h_it = gc_g[:, :, z], gc_it[:, z]
        r_g = h_it + (h * du[None, :, z]).sum(1)
        psi_g = gamma * S._psi((r_g * r_g).sum(0), p.penalizer_grad,
                               p.eps_grad)
        c[:, z] = c[:, z] - ((psi_g[None] * h_it)[:, None] * h).sum(0)
        gz = g[:, z]
        for k, (i, j) in enumerate(_PAIRS):
            d6[k, z] = (t.psi_d[z] * gz[i] * gz[j]
                        + psi_g * (h[:, i] * h[:, j]).sum(0))
        sw = torch.zeros_like(psi_g)
        for wd in t.w:      # compute_terms' sum of the weights, in order
            sw = sw + wd[z]
        ainv[:, z] = S._sym3_inverse(d6[0, z] + sw, d6[1, z], d6[2, z],
                                     d6[3, z] + sw, d6[4, z], d6[5, z] + sw)
    return t._replace(c=c, ainv=ainv), d6


def mg_levels(t, d6, p: Params) -> list:
    """``solve.mg_levels``, its data block the full ``d6`` where there is
    one."""
    if d6 is None:
        return S.mg_levels(t, p)
    shape = tuple(t.psi_s.shape)
    psi_s = t.psi_s
    w, sw = S._weights(psi_s, (1.0, 1.0, 1.0), p.alpha)
    shapes = S.mg_shapes(shape)
    levels = [S._level(w, sw, d6, shapes[0], psi_s)]
    for shp in shapes[1:]:
        d6 = S.resize3(d6, shp)
        psi_s = S.resize3(psi_s, shp)
        scale = tuple((shp[a] / shape[a]) ** 2 for a in range(3))
        w, sw = S._weights(psi_s, scale, p.alpha)
        levels.append(S._level(w, sw, d6, shp, psi_s))
    return levels


def solve_increment(g, it, flow, p: Params, parity, gc):
    du = torch.zeros_like(flow)
    for _ in range(p.inner_iterations):
        t, d6 = compute_terms(g, it, flow, du, p, gc)
        if p.solver == "multigrid":
            levels = mg_levels(t, d6, p)
            du = S._relax(lambda x: S.vcycle(x, t.c, levels, 0, p), du,
                          p.mg_cycles, p)
        else:
            du = S._relax(lambda x: S.sor_sweep(x, t, p.omega, parity), du,
                          p.sweeps, p)
        del t, d6
    return du


def warp_iteration(i0l, i1l, flow, p: Params, parity):
    i1w = S.warp(i1l, flow, p.interp)
    g, it = S.derivatives(i0l, i1w)
    gc = grad_constancy_terms(i0l, i1w, g) if p.gamma > 0.0 else None
    del i1w
    du = solve_increment(g, it, flow, p, parity, gc)
    del g, it, gc
    if p.median:
        du = S.median3(du)
    flow = flow + du
    if p.flow_clamp > 0.0:
        flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return flow


def solve(i0, i1, p: Params, stream_chunk: int | None = None
          ) -> torch.Tensor:
    """The (3, D, H, W) float32 flow of a (D, H, W) pair of tensors, on
    their device, in core (``stream_chunk`` must be None)."""
    if stream_chunk is not None:
        raise ValueError("reference: gradient constancy is reproduced in "
                         "core only")
    d = i0.shape[0]
    zm = p.z_multiple
    d_pad = zm * ((d + zm - 1) // zm)
    if d_pad != d:
        i0 = torch.cat([i0, i0[-1:].expand(d_pad - d, -1, -1)], dim=0)
        i1 = torch.cat([i1, i1[-1:].expand(d_pad - d, -1, -1)], dim=0)
    pyr0, pyr1, shapes = S.prepare_pyramids(i0, i1, p)
    flow = torch.zeros((3, *shapes[-1]), dtype=torch.float32,
                       device=i0.device)
    for li in range(len(shapes) - 1, -1, -1):
        parity = S.parity_mask(shapes[li], i0.device)
        for _ in range(p.warps):
            flow = warp_iteration(pyr0[li], pyr1[li], flow, p, parity)
        pyr0[li] = pyr1[li] = None
        if li > 0:
            flow = S.upsample_flow(flow, shapes[li - 1])
            if p.flow_clamp > 0.0:
                flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return flow[:, :d]
