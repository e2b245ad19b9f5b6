"""K1 wrapper: red-black SOR half-sweep (``csrc/sor.cu``).

Replaces ``tpuflow3d/pallas/sor.py:sor_halfsweep_pallas``. The kernel reads
the compact terms (c, g, psi_s, psi_d; c and g stored in float32 or
bfloat16) and recomputes the neighbour weights and the Sherman-Morrison
factors per voxel from the stored g, so the precomputed
``SolveTerms.w/sw_inv/smt`` are read only by the plain version,
``solver.sor_halfsweep``, which this wrapper runs for CPU tensors (it too
remakes ``smt`` where g is stored in bfloat16).

Out-of-place, as the plain version: returns a new tensor (the voxels of
the other colour are copied), so a caller may keep the previous iterate.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.solver import SolveTerms, parity_mask, sor_halfsweep as _plain


def sor_halfsweep(du: torch.Tensor, t: SolveTerms, alpha: float, omega: float,
                  color: int, ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """One half-sweep of ``color`` over du (3, D, H, W): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if du.device.type == "cpu":
        parity = parity_mask(tuple(du.shape[1:]), ctx, du.device)
        return _plain(du, t, omega, parity, color, ctx)
    if du.device.type != "cuda":
        raise RuntimeError(f"sor_halfsweep: no kernel for {du.device}")
    _, d, h, w = du.shape
    dev = du.device
    vol3, vol1 = (3, d, h, w), (d, h, w)
    du_lo, du_hi = ctx.z_halo_planes(du)
    ps_lo, ps_hi = ctx.z_halo_planes(t.psi_s)
    td = kernels.terms_dtype(t.c)
    kernels.check_tensor("c", t.c, vol3, dev, td)
    kernels.check_tensor("g", t.g, vol3, dev, td)
    for name, x, shape in (("du", du, vol3), ("psi_s", t.psi_s, vol1),
                           ("psi_d", t.psi_d, vol1),
                           ("du_lo", du_lo, (3, 1, h, w)),
                           ("du_hi", du_hi, (3, 1, h, w)),
                           ("ps_lo", ps_lo, (1, h, w)),
                           ("ps_hi", ps_hi, (1, h, w))):
        kernels.check_tensor(name, x, shape, dev)
    out = torch.empty_like(du)
    lib = kernels.load_library()
    half_alpha = float(np.float32(alpha)) * 0.5
    with torch.cuda.device(dev):
        kernels.launch(
            "sor_halfsweep", lib.tf3d_sor_halfsweep,
            du.data_ptr(), t.c.data_ptr(), t.g.data_ptr(),
            t.psi_s.data_ptr(), t.psi_d.data_ptr(), du_lo.data_ptr(),
            du_hi.data_ptr(), ps_lo.data_ptr(), ps_hi.data_ptr(),
            out.data_ptr(), d, h, w, int(ctx.z0(d)), ctx.d_global(d),
            half_alpha, omega, 1.0 - omega, int(color),
            int(td == torch.bfloat16), kernels.stream_handle(dev))
    return out
