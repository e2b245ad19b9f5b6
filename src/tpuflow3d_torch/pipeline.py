"""Coarse-to-fine flow pipeline.

Port of ``tpuflow3d.pipeline``: normalize -> presmooth ->
build pyramids -> per level (coarse to fine) ``warps`` times: warp +
derivatives -> inner solve -> median -> accumulate -> clamp; upsample
between levels. The reference's ``fori_loop``s are Python loops.

The level loop (``drive``) is written once, as segments:

- ``prep``: normalise, presmooth, both pyramids;
- per level, one warp iteration (``warp_iteration``), run ``warps`` times;
- per level, the flow upsampled to the next level and clamped.

With ``residual_tol`` > 0 the early stop reads the mean update on the host
after each sweep (V-cycle), so a warp iteration splits at each read:

- ``pre``: warp, derivatives, gradient-constancy terms, the first
  nonlinearity update (``solver.inner_system``: ``compute_terms``, and
  ``build_mg_levels`` for multigrid or the packing for the packed layout);
- ``terms``: the nonlinearity update of inner iterations k >= 1;
- ``body``: one sweep (V-cycle) and its mean update (``solver.relax_step``),
  run up to ``sweeps`` (``mg_cycles``) times, the stop test read after
  each;
- ``post``: median, accumulate, clamp (``accumulate``).

``drive`` runs them through a runner of ``graphs.py``: replayed from
CUDA graphs by ``compute_flow`` and ``compute_flow_checkpointed`` on a
CUDA device, as the reference compiles its solve once; called directly
elsewhere, and by ``compute_flow_impl`` under any ``HaloCtx`` (each
Z-sharded rank's slab, ``sharding.py``; the witness a graphed solve is
held to). On CUDA tensors (backend "auto" or "kernels") they run
hand-written kernels:

- warp + derivatives: K2 (trilinear) or K5 (tricubic) with
  ``deriv_order=2``; order 4 warps and differentiates in plain PyTorch
  (see ``warp_iteration``);
- the SOR half-sweep: K1 (flat) or K4 (``sweep_layout="packed"``, even W);
  with gamma > 0 K6 (flat) or K7 (packed); every multigrid level K6;
- the multigrid V-cycle's grid transfers on a whole volume: K10 (the
  residual and its restriction) and K11 (the prolongation and the
  correction);
- the median: K3.

``compute_flow_checkpointed`` saves the flow at each level boundary
(``checkpoint.py``), so an interrupted run resumes where it stopped. The
out-of-core mode, whose volumes stay in host memory, is
``piecewise.compute_flow_piecewise``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuflow3d_torch import checkpoint as ckpt
from tpuflow3d_torch import graphs
from tpuflow3d_torch.backend import check_supported, use_kernels
from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.median import median3_op
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.pyramid import build_pyramid, smooth, upsample_flow
from tpuflow3d_torch.solver import (inner_steps, inner_system, iterate_du,
                                    parity_mask, relax_step, solve_increment)
from tpuflow3d_torch.utils import profiling
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
    g, it, i1w = warp_and_derivatives(i0l, i1l, flow, p, ctx, p.gamma > 0.0)
    gc = gc_terms(i0l, i1w, g, p, ctx)
    du = solve_increment(g, it, flow, p, ctx, parity, slot, gc=gc)
    return accumulate(flow, du, p, ctx)


def gc_terms(i0l, i1w, g, p: FlowParams, ctx: HaloCtx):
    """The gradient-constancy terms of the warp with gamma > 0, else
    None. Traced as ``tf3d.gc.derivs``, its voxels counted in
    ``gc.derivs_voxels``."""
    if p.gamma > 0.0:
        with profiling.span("tf3d.gc.derivs"):
            profiling.count("gc.derivs_voxels", i0l.numel())
            return grad_constancy_terms(i0l, i1w, ctx, order=p.deriv_order,
                                        g=g)
    return None


def accumulate(flow, du, p: FlowParams, ctx: HaloCtx):
    """The end of a warp iteration: the increment's median, added to the
    flow, clamped."""
    if p.median:
        du = median3_op(du, ctx, p)
    flow = flow + du
    if p.flow_clamp > 0.0:
        flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
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


# ---- the level loop's segments: functions of tensors, each returning a
# tuple (what a runner of ``graphs.py`` replays or calls) ----

def _prep(i0, i1, p: FlowParams, ctx: HaloCtx):
    pyr0, pyr1, _ = prepare_pyramids(i0, i1, p, ctx)
    return pyr0, pyr1


def _warp(i0l, i1l, flow, slot, p: FlowParams, ctx: HaloCtx):
    parity = parity_mask(tuple(i0l.shape), ctx, i0l.device)
    return (warp_iteration(i0l, i1l, flow, p, ctx, parity, slot),)


def _upsample(flow, shape, p: FlowParams, ctx: HaloCtx):
    flow = upsample_flow(flow, shape, ctx)
    if p.flow_clamp > 0.0:
        flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return (flow,)


def _pre(i0l, i1l, flow, p: FlowParams, ctx: HaloCtx):
    g, it, i1w = warp_and_derivatives(i0l, i1l, flow, p, ctx, p.gamma > 0.0)
    gc = gc_terms(i0l, i1w, g, p, ctx)
    parity = parity_mask(tuple(i0l.shape), ctx, i0l.device)
    step, state = inner_system(g, it, flow, torch.zeros_like(flow), p, ctx,
                               parity, gc)
    return g, it, gc, step, state


def _terms(g, it, flow, state, gc, p: FlowParams, ctx: HaloCtx):
    parity = parity_mask(tuple(it.shape), ctx, it.device)
    return inner_system(g, it, flow, iterate_du(state, ctx), p, ctx, parity,
                        gc)


def _body(state, step, p: FlowParams, ctx: HaloCtx):
    return relax_step(step, state, p, ctx)


def _post(state, flow, p: FlowParams, ctx: HaloCtx):
    return (accumulate(flow, iterate_du(state, ctx), p, ctx),)


# The whole-volume warp segment, which the loop reads from ``graphs``.
graphs._warp = functools.partial(_warp, ctx=HaloCtx())


# ---- the level loop ----

def drive(run, i0, i1, p: FlowParams, ctx: HaloCtx, track: bool = False,
          checkpoint_dir: str | None = None, timer=None):
    """The coarse-to-fine solve of (D, H, W) volumes (this rank's slab
    under a sharded ``ctx``) whose global Z is a multiple of
    ``z_multiple``. ``run(key, fn, args, carry)`` runs segment ``fn`` on
    ``args`` and returns its results (a graph's copied into the tensors
    ``carry`` gives, made by ``run.zeros``): the loop goes on with them.
    Returns (the finest level's flow, the (levels, warps, inner*sweeps)
    residual curves with ``track``, else None).

    ``checkpoint_dir``: re-enter the loop at a checkpoint of this pyramid
    found there, and save the flow at every level boundary (under a
    sharded ``ctx`` each rank reads and writes its own slab,
    ``checkpoint.resume_state``). ``timer``: an optional ``PhaseTimer``,
    given the pyramid build and each level (each phase ends in a device
    synchronize). Both act between segments, never inside one."""
    phase = PhaseTimer.maybe(timer)
    shapes = p.level_shapes((ctx.d_global(i0.shape[-3]), *i0.shape[-2:]))
    dtype, dev = getattr(torch, p.dtype), i0.device
    with phase("pyramids", sync=True):
        pyr0, pyr1 = run(("prep",), functools.partial(_prep, p=p, ctx=ctx),
                         (i0, i1))
    n_levels = len(shapes)
    residuals = (torch.zeros((n_levels, p.warps,
                              p.inner_iterations * p.sweeps),
                             dtype=dtype, device=dev) if track else None)
    flows = [run.zeros(("flow", li), (3, *pyr.shape), dtype, dev)
             for li, pyr in enumerate(pyr0)]
    start = n_levels - 1
    state = (None if checkpoint_dir is None
             else ckpt.resume_state(checkpoint_dir, shapes, ctx, dev))
    if state is not None:
        start = state[1]
        flows[start].copy_(torch.as_tensor(state[0], dtype=dtype,
                                           device=dev))
    else:
        flows[start].zero_()
    # Each level's tensor leaves the list as the level starts.
    flow = flows[start]
    del flows[start:]
    for li in range(start, -1, -1):
        with phase(f"level{li} {shapes[li]}", sync=True):
            flow = _solve_level(run, pyr0[li], pyr1[li], flow, li, p, ctx,
                                residuals)
            if li > 0:
                flow, = run(("up", li), functools.partial(
                    _upsample, shape=shapes[li - 1], p=p, ctx=ctx),
                    (flow,), carry=(flows.pop(),))
        if checkpoint_dir is not None and li > 0:
            # The saved state is "ready to solve level li-1".
            with phase(f"checkpoint L{li - 1}"):
                d_local = flow.shape[-3]
                ckpt.save_level_checkpoint(
                    checkpoint_dir, flow, li - 1, p, z0=ctx.z0(d_local),
                    d_global=ctx.d_global(d_local), group=ctx.group)
    return flow, residuals


def _solve_level(run, i0l, i1l, flow, li: int, p: FlowParams, ctx: HaloCtx,
                 residuals):
    """The warp iterations of one level on its flow: one segment each, or,
    with the early stop, pre / (terms, body...) / post. Returns the
    flow."""
    if p.residual_tol <= 0.0:
        slot = (None if residuals is None else
                run.zeros(("slot", li), residuals.shape[-1:],
                          residuals.dtype, residuals.device))
        warp = (functools.partial(graphs._warp, p=p)
                if ctx.is_whole(i0l.shape[-3])
                else functools.partial(_warp, p=p, ctx=ctx))
        for wi in range(p.warps):
            flow, = run(("warp", li), warp, (i0l, i1l, flow, slot),
                        carry=(flow,))
            if slot is not None:
                residuals[li, wi].copy_(slot)
        return flow
    pre, terms, body, post = (functools.partial(f, p=p, ctx=ctx)
                              for f in (_pre, _terms, _body, _post))
    for wi in range(p.warps):
        g, it, gc, step, state = run(("pre", li), pre, (i0l, i1l, flow))
        for k in range(p.inner_iterations):
            if k:
                step, state = run(("terms", li), terms,
                                  (g, it, flow, state, gc),
                                  carry=(step, state))
            # The sweeps (V-cycles) and the host read of each stop test.
            with profiling.span("tf3d.early_stop"):
                for s in range(inner_steps(p)):
                    state, r, more = run(("body", li), body, (state, step),
                                         carry=(state, None, None))
                    if residuals is not None:
                        residuals[li, wi, k * p.sweeps + s] = r
                    if not bool(more):
                        break
        flow, = run(("post", li), post, (state, flow), carry=(flow,))
        # The warp's system dies here, before the next warp builds its own.
        del g, it, gc, step, state
    return flow


def compute_flow_impl(i0, i1, p: FlowParams, ctx: HaloCtx,
                      diagnostics: bool = False,
                      checkpoint_dir: str | None = None, timer=None):
    """Coarse-to-fine solve of (D, H, W) volumes whose Z is already a
    multiple of ``z_multiple``: ``drive`` with the segments called
    directly (``graphs.Direct``) under ``ctx``, on any device.
    ``checkpoint_dir`` and ``timer`` as in ``drive``. Returns the flow,
    and with ``diagnostics`` a dict holding the residual curves when
    ``p.track_residuals``."""
    track = diagnostics and p.track_residuals
    flow, residuals = drive(graphs.Direct(), i0, i1, p, ctx, track,
                            checkpoint_dir, timer)
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


def _in_core(i0, i1, params: FlowParams, device, track: bool, **loop):
    """``compute_flow``'s and ``compute_flow_checkpointed``'s solve: the
    pair placed and checked, Z edge-padded to ``z_multiple``, ``drive``
    (one device, ``loop`` its checkpoint and timer) through the runner of
    its device (``graphs.solve``), the flow cropped back. Returns (flow,
    residuals)."""
    i0, i1 = place_volumes(i0, i1, device)
    check_supported(params, i0)
    d = i0.shape[-3]
    i0, i1 = _pad_z(i0, i1, params.z_multiple)
    flow, residuals = graphs.solve(
        functools.partial(drive, ctx=HaloCtx(), **loop), i0, i1, params,
        track)
    return flow[:, :d], residuals


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

    On a CUDA device the solve replays CUDA graphs (``graphs.py``): the
    first call for a (params, shape, device) captures them, later calls
    replay them, and ``graphs.clear()`` releases them and their memory.
    """
    track = diagnostics and params.track_residuals
    flow, residuals = _in_core(i0, i1, params, device, track)
    if diagnostics:
        return flow, ({} if residuals is None else {"residuals": residuals})
    return flow


def compute_flow_checkpointed(i0, i1, params: FlowParams = FlowParams(),
                              checkpoint_dir: str | None = None,
                              timer=None, device=None):
    """``compute_flow`` with per-level checkpoint and resume: the
    accumulated flow, the only live state, is saved at every pyramid-level
    boundary into ``checkpoint_dir``, and a run that finds a checkpoint of
    its pyramid there re-enters the level loop at the saved level (one of
    another pyramid is ignored). Without ``checkpoint_dir`` it saves
    nothing. ``timer``: an optional ``utils.profiling.PhaseTimer``, given
    the pyramid build and each level. Device placement and the CUDA
    graphs as in ``compute_flow`` (the checkpoints are saved and the phases
    timed between replays); returns the (3, D, H, W) flow tensor."""
    return _in_core(i0, i1, params, device, False,
                    checkpoint_dir=checkpoint_dir, timer=timer)[0]
