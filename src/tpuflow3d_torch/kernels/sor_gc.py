"""K6 wrapper: red-black SOR half-sweep of the general SPD system
(``csrc/sor_gc.cu``).

Replaces ``tpuflow3d/pallas/sor_gc.py:sor_halfsweep_gc_pallas``. The kernel
reads (c, ainv, psi_s; c stored in float32 or bfloat16) and recomputes the
neighbour weights from psi_s with one alpha per axis (z, y, x): (alpha,
alpha, alpha) for the fine
gamma > 0 sweep, alpha/h^2 per axis on a multigrid level. The plain
version, run for CPU tensors, is ``solver.sor_halfsweep`` on the same
SolveTerms, which reads the precomputed weights ``t.w`` (made with the
same alphas).

Out-of-place, as the plain version: returns a new tensor.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.solver import SolveTerms, parity_mask, sor_halfsweep as _plain


def sor_halfsweep_gc(du: torch.Tensor, t: SolveTerms, axis_alpha: tuple,
                     omega: float, color: int,
                     ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """One half-sweep of ``color`` over du (3, D, H, W) on the system (c,
    ainv, psi_s) of ``t``, with ``axis_alpha`` = (alpha_z, alpha_y,
    alpha_x): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if du.device.type == "cpu":
        parity = parity_mask(tuple(du.shape[1:]), ctx, du.device)
        return _plain(du, t, omega, parity, color, ctx)
    if du.device.type != "cuda":
        raise RuntimeError(f"sor_halfsweep_gc: no kernel for {du.device}")
    if t.ainv is None:
        raise ValueError("sor_halfsweep_gc: the terms carry no ainv")
    _, d, h, w = du.shape
    dev = du.device
    vol3, vol1 = (3, d, h, w), (d, h, w)
    du_lo, du_hi = ctx.z_halo_planes(du)
    ps_lo, ps_hi = ctx.z_halo_planes(t.psi_s)
    td = kernels.terms_dtype(t.c)
    kernels.check_tensor("c", t.c, vol3, dev, td)
    for name, x, shape in (("du", du, vol3),
                           ("ainv", t.ainv, (6, d, h, w)),
                           ("psi_s", t.psi_s, vol1),
                           ("du_lo", du_lo, (3, 1, h, w)),
                           ("du_hi", du_hi, (3, 1, h, w)),
                           ("ps_lo", ps_lo, (1, h, w)),
                           ("ps_hi", ps_hi, (1, h, w))):
        kernels.check_tensor(name, x, shape, dev)
    out = torch.empty_like(du)
    lib = kernels.load_library()
    # Half-alphas as the plain weights make them: float32(alpha * 0.5).
    hz, hy, hx = (float(a) * 0.5 for a in axis_alpha)
    with torch.cuda.device(dev):
        kernels.launch(
            "sor_gc", lib.tf3d_sor_halfsweep_gc,
            du.data_ptr(), t.c.data_ptr(), t.ainv.data_ptr(),
            t.psi_s.data_ptr(), du_lo.data_ptr(), du_hi.data_ptr(),
            ps_lo.data_ptr(), ps_hi.data_ptr(), out.data_ptr(), d, h, w,
            int(ctx.z0(d)), ctx.d_global(d), hz, hy, hx, omega, 1.0 - omega,
            int(color), int(td == torch.bfloat16),
            kernels.stream_handle(dev))
    return out
