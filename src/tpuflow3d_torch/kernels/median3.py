"""K3 wrapper: exact 3x3x3 median (``csrc/median3.cu``).

Replaces ``tpuflow3d/pallas/median3.py:median3_pallas``. The kernel takes
the two Z halo planes from ``HaloCtx.z_halo_planes`` (as K1 does) instead
of a Z-padded copy of the field. The plain version, run for CPU tensors,
is ``median.median3``; the two agree bitwise.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.median import median3 as _plain


def median3(x: torch.Tensor, ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """27-point median of each component of x (C, D, H, W)."""
    if x.device.type == "cpu":
        return _plain(x, ctx)
    if x.device.type != "cuda":
        raise RuntimeError(f"median3: no kernel for {x.device}")
    if x.ndim != 4:
        raise ValueError(f"median3: expected (C, D, H, W), got "
                         f"{tuple(x.shape)}")
    cch, d, h, w = x.shape
    dev = x.device
    lo, hi = ctx.z_halo_planes(x)
    kernels.check_tensor("x", x, (cch, d, h, w), dev)
    kernels.check_tensor("lo", lo, (cch, 1, h, w), dev)
    kernels.check_tensor("hi", hi, (cch, 1, h, w), dev)
    out = torch.empty_like(x)
    lib = kernels.load_library()
    with torch.cuda.device(dev):
        kernels.launch("median3", lib.tf3d_median3,
                       x.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                       out.data_ptr(), cch, d, h, w,
                       kernels.stream_handle(dev))
    return out
