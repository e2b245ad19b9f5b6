"""K2 wrapper: fused trilinear warp + derivatives (``csrc/warp_grad.cu``).

Replaces ``tpuflow3d/pallas/warp_grad.py:warp_grad_pallas`` with
``interp="trilinear"``. Unlike the TPU kernel it serves any displacement
(a CUDA gather has no clamp cap). The plain version, run for CPU tensors,
is ``warp.warp_volume`` followed by ``derivatives.derivatives``.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.derivatives import derivatives
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.warp import warp_volume


def warp_grad(i1: torch.Tensor, flow: torch.Tensor, i0: torch.Tensor,
              ctx: HaloCtx = HaloCtx()) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp i1 (D, H, W) by flow (3, D, H, W) and return (g, it): the
    gradient (3, D, H, W) of (i0 + i1w)/2 and it = i1w - i0 (D, H, W)."""
    if i1.device.type == "cpu":
        return derivatives(i0, warp_volume(i1, flow, ctx), ctx)
    if i1.device.type != "cuda":
        raise RuntimeError(f"warp_grad: no kernel for {i1.device}")
    d, h, w = i1.shape
    dev = i1.device
    kernels.check_tensor("i1", i1, (d, h, w), dev)
    kernels.check_tensor("flow", flow, (3, d, h, w), dev)
    kernels.check_tensor("i0", i0, (d, h, w), dev)
    g = torch.empty((3, d, h, w), dtype=torch.float32, device=dev)
    it = torch.empty((d, h, w), dtype=torch.float32, device=dev)
    lib = kernels.load_library()
    with torch.cuda.device(dev):
        kernels.launch("warp_grad", lib.tf3d_warp_grad,
                       i1.data_ptr(), flow.data_ptr(), i0.data_ptr(),
                       g.data_ptr(), it.data_ptr(), d, h, w,
                       kernels.stream_handle(dev))
    return g, it
