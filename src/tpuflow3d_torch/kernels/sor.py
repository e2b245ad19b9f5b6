"""K1 wrappers: red-black SOR sweeps of the rank-1 system (``csrc/sor.cu``).

Replaces ``tpuflow3d/pallas/sor.py:sor_halfsweep_pallas``. The kernels read
the compact terms (c, g, psi_s, psi_d; c and g stored in float32 or
bfloat16) and recompute the neighbour weights and the Sherman-Morrison
factors per voxel from the stored g, so the precomputed
``SolveTerms.w/sw_inv/smt`` are read only by the plain version,
``solver.sor_halfsweep``, which the wrappers run for CPU tensors (it too
remakes ``smt`` where g is stored in bfloat16; ``with_weights`` remakes
all three where compute_terms' K8 route left them out, and the weights
where its K9 route did).

- ``sor_sweeps`` returns the iterate after n full sweeps (red, then black).
  On a whole volume each sweep is one launch of the fused kernel; a slab
  that is not the whole volume (a streamed window, a Z shard) takes two
  single-colour launches per sweep, its halo planes fetched before each.
- ``sor_halfsweep`` is one colour: the single-colour kernel.

Out-of-place, as the plain version: the result is a new tensor and ``du``
is left as it was, so a caller may keep the previous iterate.
``launch_flat`` is shared with the K6 wrappers (``kernels/sor_gc.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.solver import (SolveTerms, _weight_block, parity_mask,
                                    sor_halfsweep as _plain)

RED, BLACK, RED_THEN_BLACK = 0, 1, 2


def with_weights(t: SolveTerms, alpha: float, ctx: HaloCtx) -> SolveTerms:
    """t with the weights, sw_inv and smt that the plain version reads,
    remade from (g, psi_s, psi_d) by compute_terms' arithmetic where its
    K8 route left them out (as the kernels remake them); of the general
    system (K9's route: ainv set) the weights alone, which is all the
    plain version reads beside ainv."""
    if t.w is not None:
        return t
    w, sw = _weight_block(t.psi_s, alpha, ctx)
    if t.ainv is not None:
        return t._replace(w=w)
    sw_inv = 1.0 / sw
    g = t.g.float()
    smt = t.psi_d * sw_inv / (sw + t.psi_d * (g * g).sum(0))
    return t._replace(w=w, sw_inv=sw_inv, smt=smt)


def plain_sweeps(du: torch.Tensor, t: SolveTerms, omega: float, n: int,
                 ctx: HaloCtx, alpha: float | None = None) -> torch.Tensor:
    """n x (red half-sweep, black half-sweep) of the plain version (terms
    without weights take ``alpha``)."""
    t = with_weights(t, alpha, ctx)
    parity = parity_mask(tuple(du.shape[1:]), ctx, du.device)
    for _ in range(n):
        du = _plain(du, t, omega, parity, 0, ctx)
        du = _plain(du, t, omega, parity, 1, ctx)
    return du


def grid_fits(d: int, h: int, w: int) -> bool:
    """Whether the flat sweep kernels (K1, K6) take a (D, H, W) grid: they
    index with 32 bits and put D and the blocks of 8 rows on the launch
    grid, so D at most 65535, H at most 524280, 6*D*H*W below 2^31."""
    return d <= 65535 and h <= 8 * 65535 and 6 * d * h * w < 2 ** 31


def launch_flat(name: str, entry: str, du: torch.Tensor, c: torch.Tensor,
                g, psi_s: torch.Tensor, aux_name: str, aux: torch.Tensor,
                aux_fields: int, halves: tuple, omega: float, colours: int,
                n: int, ctx: HaloCtx) -> torch.Tensor:
    """Validate once and call a flat sweep entry (``tf3d_sor_sweeps`` or
    ``tf3d_sor_gc_sweeps``) on CUDA tensors: ``colours`` RED or BLACK is one
    half-sweep (n = 1), RED_THEN_BLACK n full sweeps on a slab that is the
    whole volume. ``aux`` is psi_d (aux_fields 0: shape (D, H, W)) or ainv
    (6 fields); ``halves`` the half-alphas per axis (z, y, x). Counts the
    launches under ``name`` and returns the new iterate (``grid_fits``
    gives the grids the kernels take)."""
    _, d, h, w = du.shape
    if not grid_fits(d, h, w):
        raise ValueError(f"{name}: grid {(d, h, w)} past the kernels' limits "
                         f"(D <= 65535, H <= 524280, 6*D*H*W < 2^31)")
    dev = du.device
    vol3, vol1 = (3, d, h, w), (d, h, w)
    td = kernels.terms_dtype(c)
    kernels.check_tensor("du", du, vol3, dev)
    kernels.check_tensor("c", c, vol3, dev, td)
    if g is not None:
        kernels.check_tensor("g", g, vol3, dev, td)
    kernels.check_tensor("psi_s", psi_s, vol1, dev)
    kernels.check_tensor(aux_name, aux,
                         (aux_fields, d, h, w) if aux_fields else vol1, dev)
    planes = ()
    if not ctx.is_whole(d):
        # A window or a shard: the planes beyond its Z faces (replicas of
        # its own faces in a window) are read for the voxels of its end
        # planes that the global face masks keep.
        planes = (*ctx.z_halo_planes(du), *ctx.z_halo_planes(psi_s))
        for pname, x, shape in zip(("du_lo", "du_hi", "ps_lo", "ps_hi"),
                                   planes, ((3, 1, h, w),) * 2
                                   + ((1, h, w),) * 2):
            kernels.check_tensor(pname, x, shape, dev)
    # On a whole volume no stencil crosses the slab's Z faces: null planes.
    plane_ptrs = [x.data_ptr() for x in planes] or [None] * 4
    # A window's tensor origin is read by the kernel from device memory.
    z0_dev, z0 = kernels.origin(ctx.z0(d), dev)
    buf0 = torch.empty_like(du)
    buf1 = torch.empty_like(du) if n > 1 else None
    launched = ctypes.c_int(0)
    lib = kernels.load_library()
    hz, hy, hx = halves
    with kernels.on_device(dev):
        kernels.launch(
            name, getattr(lib, entry), du.data_ptr(), c.data_ptr(),
            None if g is None else g.data_ptr(), psi_s.data_ptr(),
            aux.data_ptr(), *plane_ptrs, buf0.data_ptr(),
            None if buf1 is None else buf1.data_ptr(), z0_dev, d, h, w, z0,
            ctx.d_global(d), hz, hy, hx, omega, 1.0 - omega, colours, n,
            int(td == torch.bfloat16), ctypes.byref(launched),
            kernels.stream_handle(dev), launched=launched)
    return buf0 if launched.value % 2 or buf1 is None else buf1


def _launch(du, t: SolveTerms, alpha: float, omega: float, colours: int,
            n: int, ctx: HaloCtx) -> torch.Tensor:
    half_alpha = float(np.float32(alpha)) * 0.5
    return launch_flat("sor_halfsweep", "tf3d_sor_sweeps", du, t.c, t.g,
                       t.psi_s, "psi_d", t.psi_d, 0, (half_alpha,) * 3, omega,
                       colours, n, ctx)


def require_cuda(name: str, du: torch.Tensor) -> None:
    if du.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {du.device}")


def sor_halfsweep(du: torch.Tensor, t: SolveTerms, alpha: float, omega: float,
                  color: int, ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """One half-sweep of ``color`` over du (3, D, H, W): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if du.device.type == "cpu":
        parity = parity_mask(tuple(du.shape[1:]), ctx, du.device)
        return _plain(du, with_weights(t, alpha, ctx), omega, parity, color,
                      ctx)
    require_cuda("sor_halfsweep", du)
    if color not in (RED, BLACK):
        raise ValueError(f"sor_halfsweep: color {color}, expected 0 or 1")
    return _launch(du, t, alpha, omega, int(color), 1, ctx)


def sor_sweeps(du: torch.Tensor, t: SolveTerms, alpha: float, omega: float,
               n: int, ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """du (3, D, H, W) after n full red-black sweeps: the CUDA kernels for a
    CUDA tensor (one fused launch per sweep; on a slab that is not the
    whole volume two single-colour launches), the plain version for a CPU
    tensor."""
    if n < 0:
        raise ValueError(f"sor_sweeps: n = {n}")
    if du.device.type == "cpu":
        return plain_sweeps(du, t, omega, n, ctx, alpha)
    require_cuda("sor_sweeps", du)
    if n == 0:
        return du
    if ctx.is_whole(du.shape[-3]):
        return _launch(du, t, alpha, omega, RED_THEN_BLACK, n, ctx)
    for _ in range(n):
        for color in (RED, BLACK):
            du = _launch(du, t, alpha, omega, color, 1, ctx)
    return du
