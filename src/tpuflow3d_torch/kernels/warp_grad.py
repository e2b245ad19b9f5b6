"""K2 and K5 wrapper: fused warp + derivatives (``csrc/warp_grad.cu``).

Replaces ``tpuflow3d/pallas/warp_grad.py:warp_grad_pallas``: K2 with
``interp="trilinear"``, K5 with ``interp="tricubic"`` (Catmull-Rom, 4x4x4
taps, each clamped to the volume). Unlike the TPU kernel it serves any
displacement on one device and any width (a CUDA gather has no clamp cap
and no VMEM budget). With ``emit_warped`` it also returns the warped
volume, which the gradient-constancy terms read. The plain version, run
for CPU tensors, is ``warp.warp_volume`` followed by
``derivatives.derivatives``. The two interpolations count their launches
apart (``warp_grad`` and ``warp_grad_tricubic``).

- Under a window context (a streamed slab of a larger volume) the kernel
  clips z as the plain ``warp_volume`` does there, from the slab's global
  z0 and the volume's depth; a z0 held in a 0-d int32 tensor (a slab
  replayed from a CUDA graph) is read by the kernel from device memory.
- Under a sharded context (the halo form) ``max_disp`` bounds |s_z|, as
  in the plain sharded warp: I1 is padded by ``warp_halo(max_disp) + 1``
  planes (ceil(max_disp) + 2, + 3 tricubic) and the flow and i0 by one,
  all through ``HaloCtx.zpad``, and the kernel samples every plane, those
  beyond an interior face included, at global coordinates as the plain
  sharded warp does (see ``csrc/warp_grad.cu``), so it gives the
  one-device bits. ``warp_grad_halo`` launches on inputs already padded
  so.

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
from tpuflow3d_torch.warp import warp_halo, warp_volume


def grid_fits(d: int, h: int, w: int, halo: int = 0) -> bool:
    """Whether K2/K5 take a (D, H, W) volume: 32-bit indices (the flow's
    third component starts at 2*D*H*W) and 16 rows a block on the launch
    grid, so 3*D*H*W below 2^31 and H at most 1048560. In the halo form
    (``halo``: the I1 pad planes) the padded arrays count: 3*(D+2)*H*W and
    (D + 2*halo)*H*W below 2^31."""
    flow_planes = d + (2 if halo else 0)
    return (3 * flow_planes * h * w < 2 ** 31
            and (d + 2 * halo) * h * w < 2 ** 31 and h <= 16 * 65535)


def _check_interp(interp: str) -> None:
    if interp not in ("trilinear", "tricubic"):
        raise ValueError(f"interp must be 'trilinear' or 'tricubic', got "
                         f"{interp!r}")


def warp_grad(i1: torch.Tensor, flow: torch.Tensor, i0: torch.Tensor,
              ctx: HaloCtx = HaloCtx(), interp: str = "trilinear",
              emit_warped: bool = False, staged: bool = True,
              tile_counts: torch.Tensor | None = None,
              max_disp: float = 0.0) -> tuple[torch.Tensor, ...]:
    """Warp i1 (D, H, W) by flow (3, D, H, W) and return (g, it): the
    gradient (3, D, H, W) of (i0 + i1w)/2 and it = i1w - i0 (D, H, W);
    (g, it, i1w) with ``emit_warped``. Under a sharded context
    ``max_disp`` (> 0) bounds |s_z| (the halo form)."""
    _check_interp(interp)
    if i1.device.type == "cpu":
        i1w = warp_volume(i1, flow, ctx, max_disp=max_disp, interp=interp)
        g, it = derivatives(i0, i1w, ctx)
        return (g, it, i1w) if emit_warped else (g, it)
    if i1.device.type != "cuda":
        raise RuntimeError(f"warp_grad: no kernel for {i1.device}")
    d = i1.shape[0]
    if ctx.has_z_neighbors:
        if not max_disp > 0.0:
            raise ValueError("warp_grad: a sharded warp needs max_disp > 0 "
                             "(a flow clamp bounds its Z halo)")
        nh = warp_halo(max_disp, interp)
        return warp_grad_halo(
            ctx.zpad(i1, nh + 1).contiguous(),
            ctx.zpad(flow, 1).contiguous(), ctx.zpad(i0, 1).contiguous(),
            int(ctx.z0(d)), ctx.d_global(d), nh, interp, emit_warped,
            staged, tile_counts)
    return _launch(i1, flow, i0, ctx.z0(d), ctx.d_global(d), 0, interp,
                   emit_warped, staged, tile_counts)


def warp_grad_halo(i1p: torch.Tensor, flp: torch.Tensor, i0p: torch.Tensor,
                   z0: int, d_global: int, nh: int,
                   interp: str = "trilinear", emit_warped: bool = False,
                   staged: bool = True,
                   tile_counts: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """The halo form on padded CUDA inputs: i1p (D + 2*(nh+1), H, W), flp
    (3, D + 2, H, W) and i0p (D + 2, H, W) of the slab of D planes whose
    plane 0 is global plane ``z0`` of a volume of ``d_global``; ``nh`` =
    ``warp_halo(max_disp, interp)``. Returns what ``warp_grad`` does for
    the slab."""
    _check_interp(interp)
    if i1p.device.type != "cuda":
        raise RuntimeError(f"warp_grad_halo: no kernel for {i1p.device}")
    d = i0p.shape[0] - 2
    if nh < 1 or i1p.shape[0] != d + 2 * (nh + 1):
        raise ValueError(f"warp_grad_halo: i1 of {i1p.shape[0]} planes for "
                         f"a slab of {d} and a halo of {nh}")
    return _launch(i1p, flp, i0p, z0, d_global, nh + 1, interp, emit_warped,
                   staged, tile_counts)


def _launch(i1, flow, i0, z0, d_global: int, ip: int, interp: str,
            emit_warped: bool, staged: bool, tile_counts):
    """Check and launch: the window form with ``ip`` 0 (i1, flow, i0 of D
    planes; z0 an int or a 0-d int32 tensor on the device), the halo form
    with ``ip`` = nh + 1 I1 pad planes (flow and i0 of D + 2)."""
    fp = 1 if ip else 0
    d, h, w = i0.shape[0] - 2 * fp, i0.shape[1], i0.shape[2]
    if not grid_fits(d, h, w, ip):
        raise ValueError(f"warp_grad: {(d, h, w)} (I1 pad {ip}) past the "
                         f"kernel's limits (3*D*H*W < 2^31 over the padded "
                         f"arrays, H <= 1048560)")
    dev = i0.device
    kernels.check_tensor("i1", i1, (d + 2 * ip, h, w), dev)
    kernels.check_tensor("flow", flow, (3, d + 2 * fp, h, w), dev)
    kernels.check_tensor("i0", i0, (d + 2 * fp, h, w), dev)
    if tile_counts is not None:
        kernels.check_tensor("tile_counts", tile_counts, (2,), dev,
                             torch.int32)
    z0_dev, z0 = kernels.origin(z0, dev)
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
                       z0_dev, z0, d_global, ip, int(cubic), int(staged),
                       None if tile_counts is None else tile_counts.data_ptr(),
                       kernels.stream_handle(dev))
    return (g, it, i1w) if emit_warped else (g, it)
