"""K8 wrapper: the rank-1 nonlinearity update (``csrc/terms.cu``).

The JAX package computes ``solver.compute_terms`` in XLA; here, on a whole
volume with gamma = 0, one launch makes the three fields that the rank-1
sweeps (K1, K4) and the multigrid hierarchy read: c, psi_s and psi_d. The
plain version, run for CPU tensors, is ``solver.rank1_terms``; the two
agree bitwise. ``solver.compute_terms`` decides when to call it
(``solver.terms_on_kernel``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.solver import rank1_terms as _plain


def grid_fits(d: int, h: int, w: int) -> bool:
    """Whether K8 takes a (D, H, W) grid: D and the 16-row tiles along H on
    the launch grid (at most 65535 each), a plane below 2^31 voxels."""
    return d <= 65535 and h <= 16 * 65535 and h * w < 2 ** 31


def terms_rank1(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                du: torch.Tensor, p: FlowParams, ctx: HaloCtx = HaloCtx()):
    """(c, psi_s, psi_d) of the rank-1 system at the increment du: the CUDA
    kernel for CUDA tensors of a whole volume, the plain version for CPU
    tensors."""
    if g.device.type == "cpu":
        return _plain(g, it, flow, du, p, ctx)
    if g.device.type != "cuda":
        raise RuntimeError(f"terms_rank1: no kernel for {g.device}")
    d, h, w = it.shape
    if ctx.is_window or not ctx.is_whole(d):
        raise ValueError("terms_rank1: the kernel takes a whole volume (no "
                         "window, no Z neighbours)")
    if not grid_fits(d, h, w):
        raise ValueError(f"terms_rank1: grid {(d, h, w)} past the kernel's "
                         f"limits (D <= 65535, H <= 1048560, H*W < 2^31)")
    dev = g.device
    for name, t, shape in (("g", g, (3, d, h, w)), ("it", it, (d, h, w)),
                           ("flow", flow, (3, d, h, w)),
                           ("du", du, (3, d, h, w))):
        kernels.check_tensor(name, t, shape, dev)
    c = torch.empty_like(flow)
    psi_s = torch.empty_like(it)
    psi_d = torch.empty_like(it)
    lib = kernels.load_library()
    with kernels.on_device(dev):
        kernels.launch(
            "terms", lib.tf3d_terms_rank1, g.data_ptr(), it.data_ptr(),
            flow.data_ptr(), du.data_ptr(), c.data_ptr(), psi_s.data_ptr(),
            psi_d.data_ptr(), d, h, w, float(np.float32(p.alpha)) * 0.5,
            # As the plain version adds eps*eps, a Python float, to a
            # float32 tensor: the float32 nearest to it.
            p.eps_data * p.eps_data, p.eps_smooth * p.eps_smooth,
            int(p.penalizer_data != "quadratic"),
            int(p.penalizer_smooth != "quadratic"),
            kernels.stream_handle(dev))
    return c, psi_s, psi_d
