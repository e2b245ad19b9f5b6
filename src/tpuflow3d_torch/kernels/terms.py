"""K8 and K9 wrappers: the nonlinearity update (``csrc/terms.cu``).

The JAX package computes ``solver.compute_terms`` in XLA; here, on a whole
volume, one launch makes the fields that the sweeps read. K8
(``terms_rank1``, gamma = 0): c, psi_s and psi_d, read by the rank-1 sweeps
(K1, K4) and the multigrid hierarchy. K9 (``terms_general``, gamma > 0):
c, psi_s and ainv, read by the general system's SOR sweeps (K6, K7). The
plain versions, run for CPU tensors, are ``solver.rank1_terms`` and
``solver.general_terms``; each kernel agrees bitwise with its own.
``solver.compute_terms`` decides when to call them
(``solver.terms_on_kernel``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.solver import general_terms as _plain_general
from tpuflow3d_torch.solver import rank1_terms as _plain
from tpuflow3d_torch.utils import profiling


def grid_fits(d: int, h: int, w: int) -> bool:
    """Whether K8 and K9 take a (D, H, W) grid: D and the 16-row tiles
    along H on the launch grid (at most 65535 each), a plane below 2^31
    voxels."""
    return d <= 65535 and h <= 16 * 65535 and h * w < 2 ** 31


def _check_inputs(name: str, ctx: HaloCtx, **fields) -> tuple:
    """Raise unless the fields (each named with its shape's leading
    components, () for a scalar field) are contiguous float32 tensors of
    one whole volume on one CUDA device that the kernels take; returns its
    (D, H, W)."""
    it = fields["it"][0]
    if it.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {it.device}")
    d, h, w = it.shape
    if ctx.is_window or not ctx.is_whole(d):
        raise ValueError(f"{name}: the kernel takes a whole volume (no "
                         "window, no Z neighbours)")
    if not grid_fits(d, h, w):
        raise ValueError(f"{name}: grid {(d, h, w)} past the kernel's "
                         f"limits (D <= 65535, H <= 1048560, H*W < 2^31)")
    for field, (t, lead) in fields.items():
        kernels.check_tensor(field, t, (*lead, d, h, w), it.device)
    return d, h, w


def _penalizers(p: FlowParams) -> tuple:
    """The scalars the kernels share: half alpha and the squared epsilons
    of the data and smoothness terms (as the plain version adds eps*eps, a
    Python float, to a float32 tensor: the float32 nearest to it)."""
    return (float(np.float32(p.alpha)) * 0.5, p.eps_data * p.eps_data,
            p.eps_smooth * p.eps_smooth)


def terms_rank1(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                du: torch.Tensor, p: FlowParams, ctx: HaloCtx = HaloCtx()):
    """(c, psi_s, psi_d) of the rank-1 system at the increment du: the CUDA
    kernel for CUDA tensors of a whole volume, the plain version for CPU
    tensors."""
    if g.device.type == "cpu":
        return _plain(g, it, flow, du, p, ctx)
    d, h, w = _check_inputs("terms_rank1", ctx, it=(it, ()), g=(g, (3,)),
                            flow=(flow, (3,)), du=(du, (3,)))
    c = torch.empty_like(flow)
    psi_s = torch.empty_like(it)
    psi_d = torch.empty_like(it)
    dev = g.device
    with kernels.on_device(dev):
        kernels.launch(
            "terms", kernels.load_library().tf3d_terms_rank1, g.data_ptr(),
            it.data_ptr(), flow.data_ptr(), du.data_ptr(), c.data_ptr(),
            psi_s.data_ptr(), psi_d.data_ptr(), d, h, w, *_penalizers(p),
            int(p.penalizer_data != "quadratic"),
            int(p.penalizer_smooth != "quadratic"),
            kernels.stream_handle(dev))
    return c, psi_s, psi_d


def terms_general(g: torch.Tensor, it: torch.Tensor, flow: torch.Tensor,
                  du: torch.Tensor, gc_g: torch.Tensor, gc_it: torch.Tensor,
                  p: FlowParams, ctx: HaloCtx = HaloCtx()):
    """(c, psi_s, ainv) of the general system (gamma > 0) at the increment
    du, with the gradient-constancy terms gc_g (3, 3, D, H, W) and gc_it
    (3, D, H, W): the CUDA kernel for CUDA tensors of a whole volume, the
    plain version for CPU tensors. The launch is traced as the plain gc
    branch is: ``tf3d.gc.terms``, its voxels counted in
    ``gc.terms_voxels``."""
    if g.device.type == "cpu":
        return _plain_general(g, it, flow, du, gc_g, gc_it, p, ctx)
    d, h, w = _check_inputs("terms_general", ctx, it=(it, ()), g=(g, (3,)),
                            flow=(flow, (3,)), du=(du, (3,)),
                            gc_g=(gc_g, (3, 3)), gc_it=(gc_it, (3,)))
    c = torch.empty_like(flow)
    psi_s = torch.empty_like(it)
    ainv = it.new_empty((6, d, h, w))
    dev = g.device
    with kernels.on_device(dev), profiling.span("tf3d.gc.terms"):
        profiling.count("gc.terms_voxels", it.numel())
        kernels.launch(
            "terms_gc", kernels.load_library().tf3d_terms_gc, g.data_ptr(),
            it.data_ptr(), flow.data_ptr(), du.data_ptr(), gc_g.data_ptr(),
            gc_it.data_ptr(), c.data_ptr(), psi_s.data_ptr(),
            ainv.data_ptr(), d, h, w, *_penalizers(p),
            p.eps_grad * p.eps_grad, float(np.float32(p.gamma)),
            int(p.penalizer_data != "quadratic"),
            int(p.penalizer_smooth != "quadratic"),
            int(p.penalizer_grad != "quadratic"),
            kernels.stream_handle(dev))
    return c, psi_s, ainv
