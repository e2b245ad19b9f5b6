"""K3 wrapper: exact 3x3x3 median (``csrc/median3.cu``).

Replaces ``tpuflow3d/pallas/median3.py:median3_pallas``. A slab with Z
neighbours passes the two Z halo planes from ``HaloCtx.z_halo_planes``; on
one device the kernel replicates the face planes itself and no plane is
copied. The plain version, run for CPU tensors, is ``median.median3``; the
two agree bitwise.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.median import median3 as _plain


def grid_fits(c: int, d: int, h: int, w: int) -> bool:
    """Whether K3 takes a (C, D, H, W) tensor: 32-bit indices and 16 rows
    a block on the launch grid, so C*D*H*W below 2^31 and H at most
    1048560."""
    return c * d * h * w < 2 ** 31 and h <= 16 * 65535


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
    if not grid_fits(cch, d, h, w):
        raise ValueError(f"median3: {tuple(x.shape)} past the kernel's "
                         f"limits (C*D*H*W < 2^31, H <= 1048560)")
    dev = x.device
    kernels.check_tensor("x", x, (cch, d, h, w), dev)
    planes = ()
    if ctx.has_z_neighbors:
        planes = ctx.z_halo_planes(x)
        for name, plane in zip(("lo", "hi"), planes):
            kernels.check_tensor(name, plane, (cch, 1, h, w), dev)
    plane_ptrs = [p.data_ptr() for p in planes] or [None, None]
    out = torch.empty_like(x)
    lib = kernels.load_library()
    with kernels.on_device(dev):
        kernels.launch("median3", lib.tf3d_median3, x.data_ptr(),
                       *plane_ptrs, out.data_ptr(), cch, d, h, w,
                       kernels.stream_handle(dev))
    return out
