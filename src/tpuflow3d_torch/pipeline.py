"""Coarse-to-fine flow pipeline.

Port of ``tpuflow3d.pipeline``: normalize -> presmooth ->
build pyramids -> per level (coarse to fine) ``warps`` times: warp +
derivatives -> inner solve -> median -> accumulate -> clamp; upsample
between levels. PyTorch runs eagerly, so the reference's ``fori_loop``s
are Python loops. On CUDA tensors (backend "auto" or "kernels") these
run hand-written kernels:

- warp + derivatives: K2 (trilinear) or K5 (tricubic) with
  ``deriv_order=2``; order 4 warps and differentiates in plain PyTorch
  (see ``warp_iteration``);
- the SOR half-sweep: K1 (flat) or K4 (``sweep_layout="packed"``, even W);
  with gamma > 0 K6 (flat) or K7 (packed); every multigrid level K6;
- the median: K3.

``compute_flow_checkpointed`` runs the same level loop and saves the
flow at each level boundary (``checkpoint.py``), so an interrupted run
resumes where it stopped. The out-of-core mode, whose volumes stay in host
memory, is ``piecewise.compute_flow_piecewise``; the Z-sharded mode runs
``compute_flow_impl`` on each rank's slab under a sharded ``HaloCtx``
(``sharding.compute_flow_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow3d_torch import checkpoint as ckpt
from tpuflow3d_torch.backend import check_supported, use_kernels
from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.median import median3_op
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.pyramid import build_pyramid, smooth, upsample_flow
from tpuflow3d_torch.solver import parity_mask, solve_increment
from tpuflow3d_torch.utils.profiling import PhaseTimer
from tpuflow3d_torch.warp import warp_volume


def normalize_pair(i0, i1, ctx: HaloCtx):
    """Jointly rescale both volumes to [0, 1], so alpha/epsilon are
    intensity-scale invariant."""
    mn = ctx.pmin(torch.minimum(i0.min(), i1.min()))
    mx = ctx.pmax(torch.maximum(i0.max(), i1.max()))
    scale = 1.0 / (mx - mn).clamp_min(1e-12)
    return (i0 - mn) * scale, (i1 - mn) * scale


def warp_and_derivatives(i0l, i1l, flow, p: FlowParams, ctx: HaloCtx,
                         emit_warped: bool = False):
    """Warp i1 by the flow and differentiate: (g, it), and the warped
    volume as well with ``emit_warped`` (None when not asked for).

    The fused kernels K2 and K5 compute 2-point derivatives, as the TPU
    kernel they replace, so they run only for ``deriv_order == 2``. Order
    4 warps and differentiates in plain PyTorch on any device: that is the
    reference's route (it has no kernel for the 5-point stencil). Under a
    sharded context ``flow_clamp`` bounds |s_z|, which sizes the warp's Z
    halo (``sharding.prepare_params`` makes it positive)."""
    if use_kernels(p, i0l) and p.deriv_order == 2:
        from tpuflow3d_torch.kernels.warp_grad import warp_grad
        out = warp_grad(i1l, flow, i0l, ctx, interp=p.interp,
                        emit_warped=emit_warped, max_disp=p.flow_clamp)
        return out[0], out[1], (out[2] if emit_warped else None)
    i1w = warp_volume(i1l, flow, ctx, max_disp=p.flow_clamp,
                      interp=p.interp)
    g, it = derivatives(i0l, i1w, ctx, order=p.deriv_order)
    return g, it, (i1w if emit_warped else None)


def warp_iteration(i0l, i1l, flow, p: FlowParams, ctx: HaloCtx, parity,
                   slot=None):
    """ONE warp iteration: warp -> derivatives (+ gradient-constancy terms
    when gamma > 0) -> inner solve -> median -> accumulate -> clamp.
    Returns the flow; per-sweep residuals go into ``slot`` in place when
    it is given. The sweeps and the median run their kernels on CUDA
    tensors, the warp as ``warp_and_derivatives`` says."""
    gamma = p.gamma > 0.0
    g, it, i1w = warp_and_derivatives(i0l, i1l, flow, p, ctx, gamma)
    gc = (grad_constancy_terms(i0l, i1w, ctx, order=p.deriv_order, g=g)
          if gamma else None)
    du = solve_increment(g, it, flow, p, ctx, parity, slot, gc=gc)
    if p.median:
        du = median3_op(du, ctx, p)
    flow = flow + du
    if p.flow_clamp > 0.0:
        flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return flow


def solve_level(i0l, i1l, flow, p: FlowParams, ctx: HaloCtx,
                residuals_level=None):
    """All warp iterations at one pyramid level; residuals go into
    ``residuals_level`` (warps, inner*sweeps) in place when it is given."""
    parity = parity_mask(tuple(i0l.shape), ctx, i0l.device)
    for wi in range(p.warps):
        slot = None if residuals_level is None else residuals_level[wi]
        flow = warp_iteration(i0l, i1l, flow, p, ctx, parity, slot)
    return flow


def prepare_pyramids(i0, i1, p: FlowParams, ctx: HaloCtx):
    """Normalize + presmooth + build both pyramids (fine -> coarse)."""
    dtype = getattr(torch, p.dtype)
    i0 = i0.to(dtype)
    i1 = i1.to(dtype)
    if p.normalize:
        i0, i1 = normalize_pair(i0, i1, ctx)
    if p.presmooth_sigma > 0.0:
        i0 = smooth(i0, p.presmooth_sigma, ctx)
        i1 = smooth(i1, p.presmooth_sigma, ctx)

    gshape = (ctx.d_global(i0.shape[-3]), i0.shape[-2], i0.shape[-1])
    shapes = p.level_shapes(gshape)
    if shapes[0] != gshape:
        raise ValueError(f"level shapes start at {shapes[0]}, volume is "
                         f"{gshape}: pad Z to z_multiple first")
    pyr0 = build_pyramid(i0, shapes, p, ctx)
    pyr1 = build_pyramid(i1, shapes, p, ctx)
    return pyr0, pyr1, shapes


def compute_flow_impl(i0, i1, p: FlowParams, ctx: HaloCtx,
                      diagnostics: bool = False,
                      checkpoint_dir: str | None = None, timer=None):
    """Coarse-to-fine solve of (D, H, W) volumes whose Z is already a
    multiple of ``z_multiple``. ``checkpoint_dir``: re-enter the level
    loop at a checkpoint of this pyramid found there, and save the flow at
    every level boundary (under a sharded ``ctx`` each rank reads and
    writes its own slab, ``checkpoint.resume_state``). ``timer``: an
    optional ``PhaseTimer``, given the pyramid build and each level (each
    phase ends in a device synchronize)."""
    phase = PhaseTimer.maybe(timer)
    with phase("pyramids", sync=True):
        pyr0, pyr1, shapes = prepare_pyramids(i0, i1, p, ctx)
    dtype = getattr(torch, p.dtype)

    n_levels = len(shapes)
    track = diagnostics and p.track_residuals
    residuals = (torch.zeros((n_levels, p.warps,
                              p.inner_iterations * p.sweeps),
                             dtype=dtype, device=i0.device)
                 if track else None)

    start = n_levels - 1
    flow = torch.zeros((3, *pyr0[-1].shape), dtype=dtype, device=i0.device)
    state = (None if checkpoint_dir is None
             else ckpt.resume_state(checkpoint_dir, shapes, ctx, i0.device))
    if state is not None:
        flow = torch.as_tensor(state[0], dtype=dtype, device=i0.device)
        start = state[1]
    for li in range(start, -1, -1):
        with phase(f"level{li} {shapes[li]}", sync=True):
            flow = solve_level(pyr0[li], pyr1[li], flow, p, ctx,
                               residuals[li] if track else None)
            if li > 0:
                flow = upsample_flow(flow, shapes[li - 1], ctx)
                if p.flow_clamp > 0.0:
                    flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
        if checkpoint_dir is not None and li > 0:
            # The saved state is "ready to solve level li-1".
            with phase(f"checkpoint L{li - 1}"):
                d_local = flow.shape[-3]
                ckpt.save_level_checkpoint(
                    checkpoint_dir, flow, li - 1, p, z0=ctx.z0(d_local),
                    d_global=ctx.d_global(d_local), group=ctx.group)

    if diagnostics:
        return flow, ({"residuals": residuals} if track else {})
    return flow


def place_volumes(i0, i1, device=None):
    """The pair as tensors on the device the run takes: numpy input on
    ``device``, the GPU (``"cuda"``) unless the caller names another, and
    where there is no GPU that raises instead of running on the CPU (pass
    ``device="cpu"`` for that); tensor input on its own device
    (``device``, if given, must be the same). Checks that both are 3D and
    of one shape."""
    if isinstance(i0, torch.Tensor) and isinstance(i1, torch.Tensor):
        if i0.device != i1.device:
            raise ValueError(f"volumes on {i0.device} and {i1.device}")
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != i0.device.type or want.index
                                 not in (None, i0.device.index)):
            raise ValueError(f"device={device} but the volumes are on "
                             f"{i0.device}")
    elif isinstance(i0, np.ndarray) and isinstance(i1, np.ndarray):
        device = default_device(device)
        i0 = torch.as_tensor(i0, device=device)
        i1 = torch.as_tensor(i1, device=device)
    else:
        raise TypeError("i0 and i1 must both be numpy arrays or both "
                        "tensors")
    if i0.shape != i1.shape or i0.ndim != 3:
        raise ValueError(f"expected two equal-shape 3D volumes, got "
                         f"{tuple(i0.shape)} vs {tuple(i1.shape)}")
    return i0, i1


def default_device(device=None) -> torch.device:
    """``device``, or the GPU when it is None; raises where there is no GPU
    rather than run on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "numpy volumes run on the GPU by default, and "
                "torch.cuda.is_available() is false; pass device=\"cpu\" "
                "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _pad_z(i0, i1, zm: int):
    """Edge-replicate Z up to a multiple of ``zm``."""
    d = i0.shape[-3]
    d_pad = zm * ((d + zm - 1) // zm)
    if d_pad != d:
        i0 = torch.cat([i0, i0[-1:].expand(d_pad - d, -1, -1)], dim=0)
        i1 = torch.cat([i1, i1[-1:].expand(d_pad - d, -1, -1)], dim=0)
    return i0, i1


def compute_flow(i0, i1, params: FlowParams = FlowParams(), device=None,
                 diagnostics: bool = False):
    """Compute dense 3D optical flow s with I1(x + s(x)) ~= I0(x).

    i0, i1: (D, H, W) volumes, numpy arrays or tensors (any float/int
    dtype). Numpy input is placed on ``device``: the GPU (``"cuda"``)
    unless the caller names another, and where there is no GPU that
    raises instead of running on the CPU (pass ``device="cpu"`` for that).
    Tensor input runs on its own device (``device``, if given, must be
    the same). Returns a (3, D, H, W) tensor on that device (displacements
    along z, y, x in voxels), plus a diagnostics dict when requested
    (per-sweep residual curves if params.track_residuals).
    """
    i0, i1 = place_volumes(i0, i1, device)
    check_supported(params, i0)
    d = i0.shape[-3]
    i0, i1 = _pad_z(i0, i1, params.z_multiple)
    out = compute_flow_impl(i0, i1, params, HaloCtx(), diagnostics)
    if diagnostics:
        return out[0][:, :d], out[1]
    return out[:, :d]


def compute_flow_checkpointed(i0, i1, params: FlowParams = FlowParams(),
                              checkpoint_dir: str | None = None,
                              timer=None, device=None):
    """``compute_flow`` with per-level checkpoint and resume: the
    accumulated flow, the only live state, is saved at every pyramid-level
    boundary into ``checkpoint_dir``, and a run that finds a checkpoint of
    its pyramid there re-enters the level loop at the saved level (one of
    another pyramid is ignored). Without ``checkpoint_dir`` it saves
    nothing. ``timer``: an optional ``utils.profiling.PhaseTimer``, given
    the pyramid build and each level. Device placement as in
    ``compute_flow``; returns the (3, D, H, W) flow tensor."""
    i0, i1 = place_volumes(i0, i1, device)
    check_supported(params, i0)
    d = i0.shape[-3]
    i0, i1 = _pad_z(i0, i1, params.z_multiple)
    return compute_flow_impl(i0, i1, params, HaloCtx(),
                             checkpoint_dir=checkpoint_dir,
                             timer=timer)[:, :d]
