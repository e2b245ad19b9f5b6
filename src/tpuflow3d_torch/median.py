"""3x3x3 median filtering of flow increments.

Port of ``tpuflow3d.median``: a 27-neighbourhood median of each component
of the flow increment after the inner solve, with clamp-replicated edges.
``median3`` (stack the 27 shifted volumes, sort, take index 13) is the
plain version of kernel K3 (``kernels/median3.py``), which it matches
bitwise: the median is an exact order statistic.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch.backend import use_kernels
from tpuflow3d_torch.grid import HaloCtx, pad_yx


def median3_op(x: torch.Tensor, ctx: HaloCtx, p) -> torch.Tensor:
    """Backend-dispatching 27-point median (kernel on CUDA tensors)."""
    if use_kernels(p, x):
        from tpuflow3d_torch.kernels.median3 import median3 as median3_kernel
        return median3_kernel(x, ctx)
    return median3(x, ctx)


def median3(x: torch.Tensor, ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """27-point median of a (..., D, H, W) array (leading axes mapped)."""
    xp = pad_yx(ctx.zpad(x, 1), 1)
    d, h, w = x.shape[-3:]
    stack = [xp[..., 1 + dz:1 + dz + d, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
             for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.sort(torch.stack(stack), dim=0).values[13]
