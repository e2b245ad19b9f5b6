"""K2 and K5 wrapper: fused warp + derivatives (``csrc/warp_grad.cu``).

Replaces ``tpuflow3d/pallas/warp_grad.py:warp_grad_pallas``: K2 with
``interp="trilinear"``, K5 with ``interp="tricubic"`` (Catmull-Rom, 4x4x4
taps, each clamped to the volume). Unlike the TPU kernel it serves any
displacement and any width (a CUDA gather has no clamp cap and no VMEM
budget). With ``emit_warped`` it also returns the warped volume, which
the gradient-constancy terms read. The plain version, run for CPU
tensors, is ``warp.warp_volume`` followed by ``derivatives.derivatives``.
The two interpolations count their launches apart (``warp_grad`` and
``warp_grad_tricubic``). Under a window context (a streamed slab of a
larger volume) the kernel clips z as the plain ``warp_volume`` does there,
from the slab's global z0 and the volume's depth.

The tricubic kernel gathers each slab's taps from a box of I1 staged in
shared memory where that box fits, else from device memory; both give the
same bits (the trilinear one stages no box: its taps hit L1 as well).
``staged=False`` sends every slab to device memory, and
``tile_counts``, a CUDA int32 tensor of 2, receives how many slabs took
each branch (staged, device memory): both are for tests and measurement.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.derivatives import derivatives
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.warp import warp_volume


def warp_grad(i1: torch.Tensor, flow: torch.Tensor, i0: torch.Tensor,
              ctx: HaloCtx = HaloCtx(), interp: str = "trilinear",
              emit_warped: bool = False, staged: bool = True,
              tile_counts: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, ...]:
    """Warp i1 (D, H, W) by flow (3, D, H, W) and return (g, it): the
    gradient (3, D, H, W) of (i0 + i1w)/2 and it = i1w - i0 (D, H, W);
    (g, it, i1w) with ``emit_warped``."""
    if interp not in ("trilinear", "tricubic"):
        raise ValueError(f"interp must be 'trilinear' or 'tricubic', got "
                         f"{interp!r}")
    if i1.device.type == "cpu":
        i1w = warp_volume(i1, flow, ctx, interp=interp)
        g, it = derivatives(i0, i1w, ctx)
        return (g, it, i1w) if emit_warped else (g, it)
    if i1.device.type != "cuda":
        raise RuntimeError(f"warp_grad: no kernel for {i1.device}")
    d, h, w = i1.shape
    # 32-bit indices (flow's third component at 2*D*H*W); 16 rows a block
    # on the launch grid.
    if 3 * d * h * w >= 2 ** 31 or h > 16 * 65535:
        raise ValueError(f"warp_grad: {tuple(i1.shape)} past the kernel's "
                         f"limits (3*D*H*W < 2^31, H <= 1048560)")
    dev = i1.device
    kernels.check_tensor("i1", i1, (d, h, w), dev)
    kernels.check_tensor("flow", flow, (3, d, h, w), dev)
    kernels.check_tensor("i0", i0, (d, h, w), dev)
    if tile_counts is not None:
        kernels.check_tensor("tile_counts", tile_counts, (2,), dev,
                             torch.int32)
    g = torch.empty((3, d, h, w), dtype=torch.float32, device=dev)
    it = torch.empty((d, h, w), dtype=torch.float32, device=dev)
    i1w = torch.empty_like(it) if emit_warped else None
    cubic = interp == "tricubic"
    lib = kernels.load_library()
    with kernels.on_device(dev):
        kernels.launch("warp_grad_tricubic" if cubic else "warp_grad",
                       lib.tf3d_warp_grad,
                       i1.data_ptr(), flow.data_ptr(), i0.data_ptr(),
                       g.data_ptr(), it.data_ptr(),
                       i1w.data_ptr() if emit_warped else None, d, h, w,
                       int(ctx.z0(d)), ctx.d_global(d), int(cubic),
                       int(staged),
                       None if tile_counts is None else tile_counts.data_ptr(),
                       kernels.stream_handle(dev))
    return (g, it, i1w) if emit_warped else (g, it)
