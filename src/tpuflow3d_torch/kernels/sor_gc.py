"""K6 wrappers: red-black SOR sweeps of the general SPD system
(``csrc/sor_gc.cu``).

Replaces ``tpuflow3d/pallas/sor_gc.py:sor_halfsweep_gc_pallas``. The kernels
read (c, ainv, psi_s; c stored in float32 or bfloat16) and recompute the
neighbour weights from psi_s with one alpha per axis (z, y, x): (alpha,
alpha, alpha) for the fine gamma > 0 sweep, alpha/h^2 per axis on a
multigrid level. The plain version, run for CPU tensors, is
``solver.sor_halfsweep`` on the same SolveTerms, which reads the
precomputed weights ``t.w`` (made with the same alphas), or remakes them
from psi_s where compute_terms' K9 route left them out
(``kernels.sor.with_weights``; that route's sweep is the fine system's,
whose three alphas are one).

- ``sor_gc_sweeps`` returns the iterate after n full sweeps: on one device
  one fused launch per sweep, or, for a grid of at most 4096 voxels (the
  coarse multigrid levels), all n sweeps in one launch of one block; on a
  slab that is not the whole volume two single-colour launches per sweep
  (never the one-block form).
- ``sor_halfsweep_gc`` is one colour.

Out-of-place, as the plain version: the result is a new tensor.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels.sor import (BLACK, RED, RED_THEN_BLACK,
                                         require_cuda, launch_flat,
                                         plain_sweeps, with_weights)
from tpuflow3d_torch.solver import SolveTerms, parity_mask, sor_halfsweep as _plain


def _launch(du, t: SolveTerms, axis_alpha: tuple, omega: float, colours: int,
            n: int, ctx: HaloCtx) -> torch.Tensor:
    if t.ainv is None:
        raise ValueError("sor_gc: the terms carry no ainv")
    # Half-alphas as the plain weights make them: float32(alpha * 0.5).
    halves = tuple(float(a) * 0.5 for a in axis_alpha)
    return launch_flat("sor_gc", "tf3d_sor_gc_sweeps", du, t.c, None, t.psi_s,
                       "ainv", t.ainv, 6, halves, omega, colours, n, ctx)


def sor_halfsweep_gc(du: torch.Tensor, t: SolveTerms, axis_alpha: tuple,
                     omega: float, color: int,
                     ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """One half-sweep of ``color`` over du (3, D, H, W) on the system (c,
    ainv, psi_s) of ``t``, with ``axis_alpha`` = (alpha_z, alpha_y,
    alpha_x): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if du.device.type == "cpu":
        parity = parity_mask(tuple(du.shape[1:]), ctx, du.device)
        t = with_weights(t, axis_alpha[0], ctx)
        return _plain(du, t, omega, parity, color, ctx)
    require_cuda("sor_halfsweep_gc", du)
    if color not in (RED, BLACK):
        raise ValueError(f"sor_halfsweep_gc: color {color}, expected 0 or 1")
    return _launch(du, t, axis_alpha, omega, int(color), 1, ctx)


def sor_gc_sweeps(du: torch.Tensor, t: SolveTerms, axis_alpha: tuple,
                  omega: float, n: int,
                  ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """du (3, D, H, W) after n full red-black sweeps on (c, ainv, psi_s):
    the CUDA kernels for a CUDA tensor (one fused launch per sweep, or one
    launch of one block for all n on a grid of at most 4096 voxels; on a
    slab that is not the whole volume two single-colour launches per
    sweep), the plain version for a CPU tensor."""
    if n < 0:
        raise ValueError(f"sor_gc_sweeps: n = {n}")
    if du.device.type == "cpu":
        return plain_sweeps(du, t, omega, n, ctx, axis_alpha[0])
    require_cuda("sor_gc_sweeps", du)
    if n == 0:
        return du
    if ctx.is_whole(du.shape[-3]):
        return _launch(du, t, axis_alpha, omega, RED_THEN_BLACK, n, ctx)
    for _ in range(n):
        for color in (RED, BLACK):
            du = _launch(du, t, axis_alpha, omega, color, 1, ctx)
    return du
