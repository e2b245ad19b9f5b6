"""Out-of-core streamed execution: the "piecewise" mode.

Port of ``tpuflow3d.piecewise``. When a volume pair does not fit in device
memory, or passes the kernels' 32-bit index limits, the volumes and every
whole-volume intermediate stay in host RAM (numpy) and each phase streams
Z-chunks with margin planes through the device: 1 plane for stencils and
the median, 2 for the sweep constants, ``stream_margin`` (the warp's
ceil(clamp)+1, one more for tricubic, plus the derivative radius) for the
warp, the kernel radius for smoothing.

Numerics: the phases call the in-core ops under a window ``HaloCtx``
(``grid.HaloCtx(window_z0=..., window_d_global=...)``), which answers
clamping, red-black parity and the Neumann face masks in global
coordinates. Slab margins are padded by replication and cropped, so only
real data lands in the host arrays. On CUDA slabs the phases launch the
kernels: K2/K5 in window form, K1/K6 one colour per launch with replicate
halo planes, K3 on the clamped gather; on CPU slabs their plain versions.

Gauss-Seidel order: a red half-sweep reads only black voxels and vice
versa, so a half-sweep streamed as its own in-place pass over the host du
keeps the in-core update order. The trapezoid (``_stream_sor_trapezoid``)
visits each chunk once per inner iteration and advances all 2S half-sweeps
on the device with a wavefront: after launch k the half-sweep-j frontier
stands at F_j(k) = clamp(k*chunk + 2S - j, 0, D), every launch advances
each frontier by ``chunk`` planes, and the host du carries a graded band
of 2S planes at the frontier. This is exact: a plane's state j and state
j+1 differ only in the colour that half-sweep j+1 updates, which no read
of half-sweep j+1 touches.

Fully fused streaming (the default for inner_iterations == 1): with one
nonlinear iteration the sweep constants are a pure function of the slab
inputs (the increment entering them is zero), so one launch per chunk does
warp + derivatives + terms + all 2S half-sweeps + median + accumulate +
clamp, streaming in (i0, i1, flow) and out the new flow; the only state
across launches is the trapezoid's du frontier band, which stays on the
device (``_ph_fused_warp_iter``'s carry). No g/it/terms/du host arrays.

Host staging: a slab is gathered into page-locked memory and copied to the
device without blocking, on the current stream; results come back the same
way into page-locked memory and are written into the host arrays after an
event. Where a phase's outputs do not alias its inputs (``pipeline=True``)
chunk k's results are drained after chunk k+1 is enqueued, so the host
prepares the next slab while the device computes; an in-place phase (the
SOR du) stays synchronous, since chunk k+1's margin must see chunk k's
writes.

Scale note: this is the one-device overflow path; a Z-sharded mesh
(ROADMAP queue 1, item 10) keeps everything resident instead.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from tpuflow3d_torch import checkpoint as ckpt
from tpuflow3d_torch.backend import check_supported, use_kernels
from tpuflow3d_torch.derivatives import grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.median import median3_op
from tpuflow3d_torch.mgsolver import (_vcycle, assemble_fine_system,
                                      build_coarse_chain, data_block_d6,
                                      fine_residual, mg_shapes)
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.pipeline import default_device, warp_and_derivatives
from tpuflow3d_torch.pyramid import (gaussian_kernel1d, resize_axis_local,
                                     resize_z_window, smooth)
from tpuflow3d_torch.solver import (compute_terms, jacobi_sweep, parity_mask,
                                    sor_halfsweep, sweep_terms)
from tpuflow3d_torch.utils.profiling import PhaseTimer

DEFAULT_FLOW_CLAMP = 4.0


class _Stager:
    """Moves host slabs to the run's device and results back. For a CUDA
    device through page-locked buffers, without blocking, on the current
    stream (the caching host allocator keeps a buffer until the copies
    that use it are done). Host copies go through torch, whose CPU copy
    runs on several threads."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def put(self, x: np.ndarray, lo: int, size: int) -> torch.Tensor:
        """The slab [lo, lo+size) of host array x along axis -3, planes
        outside the volume replicating its faces, on the device."""
        d = x.shape[-3]
        src = torch.from_numpy(x)
        buf = torch.empty((*x.shape[:-3], size, *x.shape[-2:]),
                          dtype=src.dtype, pin_memory=self.cuda)
        n_lo = min(max(-lo, 0), size)                  # planes below 0
        n_hi = min(max(lo + size - d, 0), size - n_lo)  # planes from d on
        mid = size - n_lo - n_hi
        if mid:
            buf.narrow(-3, n_lo, mid).copy_(src.narrow(-3, lo + n_lo, mid))
        if n_lo:
            buf.narrow(-3, 0, n_lo).copy_(
                src.narrow(-3, 0, 1).expand_as(buf.narrow(-3, 0, n_lo)))
        if n_hi:
            top = buf.narrow(-3, size - n_hi, n_hi)
            top.copy_(src.narrow(-3, d - 1, 1).expand_as(top))
        return buf.to(self.device, non_blocking=True) if self.cuda else buf

    def get(self, t: torch.Tensor):
        """Start t's copy to the host; ``wait`` or ``store`` finish it."""
        if not self.cuda:
            return t, None
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    @staticmethod
    def wait(handle) -> torch.Tensor:
        buf, done = handle
        if done is not None:
            done.synchronize()
        return buf

    def store(self, out: np.ndarray, handle) -> None:
        """Write a result into a host array (a view of one)."""
        torch.from_numpy(out).copy_(self.wait(handle))


def _wctx(z0: int, dg: int) -> HaloCtx:
    return HaloCtx(window_z0=z0, window_d_global=dg)


def _clamp_global_z(x: torch.Tensor, z0: int, dg: int) -> torch.Tensor:
    """Remap slab planes outside the global [0, dg) to their clamped
    in-range twins. Slab margins hold replicas of the RAW inputs; a
    stencil of a stencil (the gradient-constancy second derivatives) needs
    the replicas of the DERIVED field at the global faces to match the
    in-core ``zpad``: first derivatives of a replicated plane are ~0, not
    a copy of the face derivative."""
    size = x.shape[-3]
    zg = z0 + torch.arange(size, device=x.device)
    return x.index_select(-3, zg.clamp(0, dg - 1) - z0)


def _halfsweep_fn(du: torch.Tensor, p: FlowParams, ctx: HaloCtx,
                  omega: float):
    """fn(du, t, color): one half-sweep on the slab, the kernel (K6 when t
    carries ainv, else K1; one colour, replicate halo planes) for CUDA
    tensors, the plain half-sweep otherwise."""
    if use_kernels(p, du):
        from tpuflow3d_torch.kernels.sor import sor_halfsweep as k1
        from tpuflow3d_torch.kernels.sor_gc import sor_halfsweep_gc as k6
        al3 = (p.alpha,) * 3
        return lambda x, t, color: (
            k6(x, t, al3, omega, color, ctx) if t.ainv is not None
            else k1(x, t, p.alpha, omega, color, ctx))
    parity = parity_mask(tuple(du.shape[1:]), ctx, du.device)
    return lambda x, t, color: sor_halfsweep(x, t, omega, parity, color, ctx)


def _trapezoid_sweeps(dus, t, z0: int, kbase: int, dg: int, p: FlowParams,
                      sweeps: int, chunk: int, omega: float | None = None):
    """All 2*sweeps half-sweeps of one chunk visit, wavefront-masked.

    Half-sweep j (1-based, colour (j-1)&1) updates global planes
    [F_j(k-1), F_j(k)) with F_j(k) = clamp(kbase + 2*sweeps - j, 0, dg),
    kbase = k*chunk; everything else on the slab passes through.
    ``omega`` overrides p.omega (the multigrid smoother's p.mg_omega)."""
    ctx = _wctx(z0, dg)
    half = _halfsweep_fn(dus, p, ctx, p.omega if omega is None else omega)
    size = dus.shape[-3]
    zg = z0 + torch.arange(size, device=dus.device)
    s2 = 2 * sweeps
    for j in range(1, s2 + 1):
        hi = min(max(kbase + s2 - j, 0), dg)
        # lo = F_j(k-1). Launch 0 has no predecessor: its frontier is 0,
        # not the virtual -chunk + 2S - j (> 0 when 2S > chunk + j, which
        # would skip half-sweep j on planes [0, lo) for good).
        lo = min(max(kbase - chunk + s2 - j, 0), dg) if kbase > 0 else 0
        m = ((zg >= lo) & (zg < hi)).reshape(1, size, 1, 1)
        dus = torch.where(m, half(dus, t, (j - 1) & 1), dus)
    return dus


# ---- slab phases (fn(*slabs, z0, ...) -> slab outputs) ----

def _ph_warp_deriv(i0s, i1s, fls, z0: int, dg: int, p: FlowParams):
    g, it, _ = warp_and_derivatives(i0s, i1s, fls, p, _wctx(z0, dg))
    return g, it


def _ph_terms(gs, its, fls, dus, z0: int, dg: int, p: FlowParams):
    """The rank-1 sweep constants the kernels read: (c, psi_s, psi_d); c
    goes to the host as float32 (holding bfloat16 values when the terms
    are stored so)."""
    t = compute_terms(gs, its, fls, dus, p, _wctx(z0, dg))
    return t.c.float(), t.psi_s, t.psi_d


def _ph_terms_gc(i0s, i1s, fls, dus, z0: int, dg: int, p: FlowParams,
                 mg: bool = False):
    """Sweep constants of the gradient-constancy mode (p.gamma > 0),
    recomputed on the device from the raw slab inputs: warp + derivatives
    + second-derivative terms + compute_terms in one phase, so nothing but
    (i0, i1, flow, du) streams in. Returns (c, psi_s, ainv), or with ``mg``
    the multigrid constituents (c, psi_s, d6)."""
    ctx = _wctx(z0, dg)
    g, it, i1w = warp_and_derivatives(i0s, i1s, fls, p, ctx, True)
    gc = grad_constancy_terms(i0s, i1w, ctx, order=p.deriv_order,
                              g=_clamp_global_z(g, z0, dg))
    t = compute_terms(g, it, fls, dus, p, ctx, gc=gc)
    return t.c.float(), t.psi_s, (t.d6 if mg else t.ainv)


def _slab_terms(tslabs, p: FlowParams, ctx: HaloCtx):
    """SolveTerms of a slab from the streamed constants: (c, g, psi_s,
    psi_d) of the rank-1 system or (c, psi_s, ainv) of the general one."""
    if len(tslabs) == 4:
        c, g, pss, psd = tslabs
        return sweep_terms(c, g, pss, psd, p, ctx)
    c, pss, ainv = tslabs
    return sweep_terms(c, None, pss, ainv, p, ctx)


def _ph_halfsweep(dus, *rest, dg: int, p: FlowParams, color: int):
    *tslabs, z0 = rest
    ctx = _wctx(z0, dg)
    return _halfsweep_fn(dus, p, ctx, p.omega)(
        dus, _slab_terms(tslabs, p, ctx), color)


def _ph_jacobi(dus, *rest, dg: int, p: FlowParams):
    *tslabs, z0 = rest
    ctx = _wctx(z0, dg)
    return jacobi_sweep(dus, _slab_terms(tslabs, p, ctx), p.jacobi_omega(),
                        ctx)


def _ph_sor_trapezoid(dus, *rest, dg: int, p: FlowParams, sweeps: int,
                      chunk: int):
    *tslabs, z0, kbase = rest
    t = _slab_terms(tslabs, p, _wctx(z0, dg))
    return _trapezoid_sweeps(dus, t, z0, kbase, dg, p, sweeps, chunk)


# ---- streamed multigrid: the fine level's smooths run as trapezoid passes
# and its residual, restriction and prolongation as streamed phases; the
# coarse hierarchy (<= 1/8 of the fine voxels) is built and V-cycled on the
# device. Host arrays per inner iteration: c (3), psi_s (1), d6 (6); the
# weights and the inverse are rebuilt per slab visit
# (mgsolver.assemble_fine_system).

def _ph_terms_mg(gs, its, fls, dus, z0: int, dg: int, p: FlowParams):
    """Fine multigrid constituents (c, psi_s, d6) from the streamed g/it
    (gamma = 0)."""
    t = compute_terms(gs, its, fls, dus, p, _wctx(z0, dg))
    return t.c.float(), t.psi_s, data_block_d6(t)


def _ph_mg_trapezoid(dus, cs, pss, d6s, z0: int, kbase: int, dg: int,
                     p: FlowParams, sweeps: int, chunk: int):
    """Multigrid smoother chunk visit: (w, ainv) rebuilt from the streamed
    (psi_s, d6) on the slab, then the wavefront half-sweeps at mg_omega.
    The replicated psi_s of a slab margin reaches only the outermost slab
    plane's weights, which no update window includes."""
    t, _ = assemble_fine_system(cs, pss, d6s, p, _wctx(z0, dg))
    return _trapezoid_sweeps(dus, t, z0, kbase, dg, p, sweeps, chunk,
                             omega=p.mg_omega)


def _ph_mg_residual(dus, cs, pss, d6s, z0: int, dg: int, p: FlowParams):
    return fine_residual(dus, cs, pss, d6s, p, _wctx(z0, dg))


def _ph_coarse_vcycle(rc, psi_c, d6_c, shapes, gshape: tuple,
                      p: FlowParams):
    """The device-resident part of one streamed V-cycle: the coarse chain
    built from the restricted (psi_c, d6_c) (already at shapes[0]) and the
    in-core V-cycle below the fine level. The chain is rebuilt per call
    (mg_cycles is small and the coarse work is <= 1/7 of a fine sweep)."""
    ctx = HaloCtx()
    levels = build_coarse_chain(psi_c, d6_c, list(shapes), gshape, p, ctx,
                                inputs_at_first=True)
    return _vcycle(torch.zeros_like(rc), rc, levels, 0, p, ctx)


def _stream_mg_solve(du, c, psi_s, d6, p: FlowParams, chunk: int,
                     st: _Stager) -> np.ndarray:
    """p.mg_cycles streamed V-cycles on the frozen fine system (c = rhs),
    stopped early on the host's mean |du - du_prev| when residual_tol >
    0: the cycle of mgsolver.mg_solve, fine pre-smooth -> streamed
    residual -> streamed restriction -> coarse V-cycle on the device ->
    streamed prolongation + add -> fine post-smooth. A one-entry ladder
    (a tiny pyramid level) does pre + coarse sweeps, as the in-core
    coarsest level."""
    d, h, w = psi_s.shape
    gshape = (d, h, w)
    shapes = mg_shapes(gshape, 1)
    tarr = [c, psi_s, d6]

    def smooth_n(du, n):
        if n <= 0:
            return du
        ph = partial(_ph_mg_trapezoid, dg=d, p=p, sweeps=n, chunk=chunk)
        return _stream_sor_trapezoid(du, tarr, ph, p, chunk, st, sweeps=n)

    if len(shapes) > 1:
        # The coarse system, restricted once per frozen system.
        psi_c, d6_c = (torch.as_tensor(
            _stream_resample(x, shapes[1], 0.0, chunk, st), device=st.device)
            for x in (psi_s, d6))
        coarse = tuple(tuple(s) for s in shapes[1:])

    for _ in range(p.mg_cycles):
        # The early stop compares with the iterate before the cycle, as
        # mg_solve does: one host copy of du, only when residual_tol > 0.
        du_prev = du.copy() if p.residual_tol > 0.0 else None
        if len(shapes) == 1:
            du = smooth_n(du, p.mg_pre)
            du = smooth_n(du, p.mg_coarse_sweeps)
        else:
            du = smooth_n(du, p.mg_pre)
            r = np.empty_like(du)
            _stream(partial(_ph_mg_residual, dg=d, p=p), [du, *tarr], 1,
                    chunk, [r], st, pipeline=True)
            rc = torch.as_tensor(_stream_resample(r, shapes[1], 0.0, chunk,
                                                  st), device=st.device)
            del r
            ec = _ph_coarse_vcycle(rc, psi_c, d6_c, coarse, gshape, p)
            du += _stream_resample(ec.cpu().numpy(), gshape, 0.0, chunk, st)
            du = smooth_n(du, p.mg_post)
        if du_prev is not None:
            if float(np.mean(np.abs(du - du_prev))) < p.residual_tol:
                break
    return du


def _ph_fused_warp_iter(i0s, i1s, fls, carry, z0: int, kbase: int, dg: int,
                        p: FlowParams, sweeps: int, chunk: int):
    """A whole warp iteration for one chunk visit: warp + derivatives +
    terms + all 2*sweeps half-sweeps + median + accumulate + clamp.
    Requires inner_iterations == 1 (the increment entering compute_terms
    is zero, so the terms are a pure function of the slab inputs).

    ``carry`` holds du planes [kbase - 2, kbase + 2S) from the previous
    launch: the 2S graded planes and 2 final ones, so that the trailing
    median can read final du at kbase-2 and kbase-1; the rest of the slab
    starts at zero. After this launch du is final below kbase, so the
    median + accumulate cover planes [kbase - chunk - 1, kbase - 1)
    (extended to dg once kbase >= dg), which the host writes.

    Slab: [kbase - chunk - mw, kbase + 2S + mw), mw = stream_margin(p).
    Returns (the new flow slab, the next carry: du[kbase + chunk - 2,
    kbase + chunk + 2S), at slab index chunk + mw - 2)."""
    ctx = _wctx(z0, dg)
    gamma = p.gamma > 0.0
    g, it, i1w = warp_and_derivatives(i0s, i1s, fls, p, ctx, gamma)
    gc = (grad_constancy_terms(i0s, i1w, ctx, order=p.deriv_order,
                               g=_clamp_global_z(g, z0, dg))
          if gamma else None)
    du = torch.zeros_like(fls)
    t = compute_terms(g, it, fls, du, p, ctx, gc=gc)
    s2 = 2 * sweeps
    size = fls.shape[-3]
    mw = (size - chunk - s2) // 2
    du[:, mw - 2:mw + s2] = carry
    du = _trapezoid_sweeps(du, t, z0, kbase, dg, p, sweeps, chunk)
    new_carry = du[:, chunk + mw - 2:chunk + mw + s2].contiguous()
    if p.median:
        # The in-core median replicates the global faces; slab planes
        # outside [0, dg) hold zeros, so gather each plane's clamped
        # global twin first. The slab-edge replicas lie outside the host
        # write window.
        du = median3_op(_clamp_global_z(du, z0, dg).contiguous(), HaloCtx(),
                        p)
    fl_new = fls + du
    if p.flow_clamp > 0:
        fl_new = fl_new.clamp(-p.flow_clamp, p.flow_clamp)
    return fl_new, new_carry


def _ph_median(dus, z0: int, p: FlowParams):
    return median3_op(dus, HaloCtx(), p)


def _ph_smooth(xs, z0: int, sigma: float):
    return smooth(xs, sigma, HaloCtx())


def _ph_resample(xs, z0_out: int, z0_in: int, sigma: float, out_len: int,
                 scale: float, in_global: int, out_hw: tuple[int, int]):
    if sigma > 0.0:
        xs = smooth(xs, sigma, HaloCtx())
    ys = resize_z_window(xs, out_len, z0_out, z0_in, 0, scale, in_global)
    ys = resize_axis_local(ys, out_hw[0], axis=-2)
    return resize_axis_local(ys, out_hw[1], axis=-1)


# ---- streaming loops ----

def _stream_sor_trapezoid(du, terms, phase, p: FlowParams, chunk: int,
                          st: _Stager, sweeps: int | None = None
                          ) -> np.ndarray:
    """One chunk pass advancing all 2*sweeps half-sweeps (sweeps defaults
    to p.sweeps; the multigrid smoother passes mg_pre/mg_post). ``terms``:
    host arrays streamed beside du; ``phase``: a trapezoid slab phase
    (``_ph_sor_trapezoid`` / ``_ph_mg_trapezoid``, partially applied).
    Mutates and returns the host du; exactly 2*sweeps streamed
    half-sweeps."""
    d = du.shape[-3]
    s2 = 2 * (p.sweeps if sweeps is None else sweeps)
    size = chunk + s2 + 2
    n_launch = -(-d // chunk) + 1  # +1 drains the graded frontier band
    for k in range(n_launch):
        lo = (k - 1) * chunk - 1
        slabs = [st.put(x, lo, size) for x in (du, *terms)]
        res = phase(*slabs, lo, k * chunk)
        w0 = max((k - 1) * chunk, 0)       # F_2S(k-1)
        w1 = min(k * chunk + s2, d)        # >= F_1(k)
        if w1 > w0:
            st.store(du[:, w0:w1], st.get(res[:, w0 - lo:w1 - lo]))
    return du


def _stream_fused_warp_iteration(i0l, i1l, flow, p: FlowParams, chunk: int,
                                 mw: int, st: _Stager) -> np.ndarray:
    """One whole warp iteration as a single streamed pass (see
    ``_ph_fused_warp_iter``): reads (i0, i1, flow) slabs, writes the new
    flow into a separate array, so launch k's copy back is drained after
    launch k+1 is enqueued."""
    d, h, w = i0l.shape
    s2 = 2 * p.sweeps
    size = chunk + s2 + 2 * mw
    out = np.empty_like(flow)
    carry = torch.zeros((3, s2 + 2, h, w), dtype=torch.float32,
                        device=st.device)
    n_launch = -(-d // chunk) + 1  # +1 drains the graded frontier band
    pending = None  # (copy handle, write window w0:w1)

    def drain(pd):
        if pd is not None:
            handle, pw0, pw1 = pd
            st.store(out[:, pw0:pw1], handle)

    for k in range(n_launch):
        kbase = k * chunk
        lo = kbase - chunk - mw
        slabs = [st.put(x, lo, size) for x in (i0l, i1l, flow)]
        fl_new, carry = _ph_fused_warp_iter(*slabs, carry, lo, kbase, d, p,
                                            p.sweeps, chunk)
        if p.median:
            w0 = max(kbase - chunk - 1, 0)
            w1 = d if kbase >= d else kbase - 1
        else:
            w0 = max(kbase - chunk, 0)
            w1 = min(kbase, d)
        drain(pending)
        pending = ((st.get(fl_new[:, w0 - lo:w1 - lo]), w0, w1)
                   if w1 > w0 else None)
    drain(pending)
    return out


def _stream(fn, inputs: list[np.ndarray], margin: int, chunk: int,
            outs: list[np.ndarray], st: _Stager, pipeline: bool = False):
    """Apply a slab phase over Z-chunks. fn(*slabs, z0) -> slab outputs of
    the same Z extent; their interiors are written into ``outs`` (which
    may alias an input for the in-place half-sweeps).

    pipeline=True drains chunk k's results after chunk k+1 is enqueued.
    Only legal when no output aliases an input: an in-place phase must see
    chunk k's written planes when it gathers chunk k+1's margin, so it
    keeps the synchronous order."""
    if pipeline and any(o is x for o in outs for x in inputs):
        raise ValueError("pipeline=True requires outputs disjoint from "
                         "inputs")
    d = inputs[0].shape[-3]
    size = chunk + 2 * margin
    pending = None  # (copy handles, z0, z1)

    def drain(pd):
        if pd is not None:
            handles, z0, z1 = pd
            for o, hd in zip(outs, handles):
                st.store(o[..., z0:z1, :, :], hd)

    for z0 in range(0, d, chunk):
        z1 = min(z0 + chunk, d)
        slabs = [st.put(x, z0 - margin, size) for x in inputs]
        res = fn(*slabs, z0 - margin)
        if not isinstance(res, tuple):
            res = (res,)
        handles = [st.get(r.narrow(-3, margin, z1 - z0)) for r in res]
        if pipeline:
            drain(pending)
            pending = (handles, z0, z1)
        else:
            drain((handles, z0, z1))
    drain(pending)
    return outs


def _stream_resample(x: np.ndarray, out_shape, sigma: float, chunk: int,
                     st: _Stager, ratios=None) -> np.ndarray:
    """Streamed smooth + trilinear resample (pyramid downsample, flow
    upsample). x: (..., Din, H, W) on the host; out_shape the global
    (Dout, Hout, Wout); ratios: per-component scale for flow upsampling."""
    din = x.shape[-3]
    dout, hout, wout = out_shape
    scale = din / dout
    r = 0 if sigma <= 0 else (len(gaussian_kernel1d(sigma)) - 1) // 2
    win = int(math.ceil(chunk * scale)) + 2 * r + 4
    out = np.empty((*x.shape[:-3], dout, hout, wout), np.float32)
    pending = None  # (copy handle, o0, o1); x is never written

    def drain(pd):
        if pd is not None:
            handle, o0, o1 = pd
            st.store(out[..., o0:o1, :, :], handle)

    for o0 in range(0, dout, chunk):
        o1 = min(o0 + chunk, dout)
        a = int(math.floor((o0 + 0.5) * scale - 0.5)) - 1 - r
        ys = _ph_resample(st.put(x, a, win), o0, a, sigma, chunk, scale, din,
                          (hout, wout))
        drain(pending)
        pending = (st.get(ys[..., :o1 - o0, :, :]), o0, o1)
    drain(pending)
    if ratios is not None:
        for c, rt in enumerate(ratios):
            out[c] *= np.float32(rt)
    return out


def _ph_fit(i0s, i1s, fls, z0: int, dg: int, p: FlowParams):
    _, _, i1w = warp_and_derivatives(i0s, i1s, fls, p, _wctx(z0, dg), True)
    return (i1w - i0s).abs()


def registration_fit_streamed(i0, i1, flow, p: FlowParams, chunk_z: int,
                              device=None):
    """|warp(i1, flow) - i0| statistics (mean residual, max residual, mean
    unwarped |i1 - i0|) by streaming Z-chunks, so the device never holds a
    whole volume. Device placement as in ``compute_flow_piecewise``."""
    st = _Stager(default_device(device))
    if p.flow_clamp <= 0:
        p = p.replace(flow_clamp=DEFAULT_FLOW_CLAMP)
    i0 = np.asarray(i0, np.float32)
    i1 = np.asarray(i1, np.float32)
    flow = np.asarray(flow, np.float32)
    d = i0.shape[-3]
    mw = stream_margin(p)
    size = chunk_z + 2 * mw
    tot = mx = before = 0.0
    for z0 in range(0, d, chunk_z):
        z1 = min(z0 + chunk_z, d)
        lo = z0 - mw
        slabs = [st.put(x, lo, size) for x in (i0, i1, flow)]
        r = st.wait(st.get(_ph_fit(*slabs, lo, d, p)[mw:mw + z1 - z0]))
        r = r.numpy()
        tot += float(r.sum(dtype=np.float64))
        mx = max(mx, float(r.max()))
        before += float(np.abs(i1[z0:z1] - i0[z0:z1]).sum(dtype=np.float64))
    n = float(i0.size)
    return tot / n, mx, before / n


def stream_margin(p: FlowParams) -> int:
    """Z margin planes a streamed solve chunk carries: the warp's (one more
    tap for tricubic) plus the derivative stencil's radius (1 for 2-point,
    2 for 5-point; doubled under gradient constancy, whose terms are second
    derivatives of the warped volume). Requires a positive flow_clamp
    (``compute_flow_piecewise`` puts in DEFAULT_FLOW_CLAMP)."""
    r_terms = (p.deriv_order // 2) * (2 if p.gamma > 0.0 else 1)
    return (int(math.ceil(p.flow_clamp)) + 1
            + (1 if p.interp == "tricubic" else 0) + r_terms)


def _solve_level_streamed(i0l, i1l, flow, p: FlowParams, chunk: int,
                          st: _Stager, temporal_block: bool = True,
                          fuse: bool = True):
    d, h, w = i0l.shape
    mw = stream_margin(p)
    if (fuse and temporal_block and p.solver == "sor"
            and p.inner_iterations == 1):
        # One nonlinear iteration: the whole warp iteration is one
        # streamed pass, the du frontier band carried on the device.
        for _ in range(p.warps):
            flow = _stream_fused_warp_iteration(i0l, i1l, flow, p, chunk, mw,
                                                st)
        return flow
    gamma = p.gamma > 0.0
    mg = p.solver == "multigrid"
    vol3, vol1 = (3, d, h, w), (d, h, w)
    for _ in range(p.warps):
        if not gamma:
            g = np.empty(vol3, np.float32)
            it = np.empty(vol1, np.float32)
            _stream(partial(_ph_warp_deriv, dg=d, p=p), [i0l, i1l, flow],
                    mw, chunk, [g, it], st, pipeline=True)
        du = np.zeros(vol3, np.float32)
        for _k in range(p.inner_iterations):
            c = np.empty(vol3, np.float32)
            pss = np.empty(vol1, np.float32)
            if mg:
                # Streamed multigrid: the constituents (c, psi_s, d6),
                # then V-cycles with streamed fine smooths and the coarse
                # chain on the device.
                d6 = np.empty((6, d, h, w), np.float32)
                if gamma:
                    _stream(partial(_ph_terms_gc, dg=d, p=p, mg=True),
                            [i0l, i1l, flow, du], mw, chunk, [c, pss, d6],
                            st, pipeline=True)
                else:
                    _stream(partial(_ph_terms_mg, dg=d, p=p),
                            [g, it, flow, du], 2, chunk, [c, pss, d6], st,
                            pipeline=True)
                du = _stream_mg_solve(du, c, pss, d6, p, chunk, st)
                continue
            if gamma:
                # Warp, derivatives and the second-derivative terms are
                # recomputed in the terms phase from the raw inputs (no
                # g/it/gc host arrays); the sweeps read (c, psi_s, ainv).
                ainv = np.empty((6, d, h, w), np.float32)
                _stream(partial(_ph_terms_gc, dg=d, p=p),
                        [i0l, i1l, flow, du], mw, chunk, [c, pss, ainv], st,
                        pipeline=True)
                tarr = [c, pss, ainv]
            else:
                psd = np.empty(vol1, np.float32)
                # Margin 2, not 1: the weight at plane z reads psi_s at
                # z+-1, which reads flow and du at z+-2.
                _stream(partial(_ph_terms, dg=d, p=p), [g, it, flow, du],
                        2, chunk, [c, pss, psd], st, pipeline=True)
                tarr = [c, g, pss, psd]
            if p.solver == "sor" and temporal_block:
                ph = partial(_ph_sor_trapezoid, dg=d, p=p, sweeps=p.sweeps,
                             chunk=chunk)
                du = _stream_sor_trapezoid(du, tarr, ph, p, chunk, st)
            elif p.solver == "sor":
                for _s in range(p.sweeps):
                    # One in-place pass per colour: red reads only black
                    # and vice versa, so chunk-sequential in-place updates
                    # keep the in-core order.
                    for color in (0, 1):
                        _stream(partial(_ph_halfsweep, dg=d, p=p,
                                        color=color),
                                [du, *tarr], 1, chunk, [du], st)
            else:
                for _s in range(p.sweeps):
                    du_new = np.empty_like(du)
                    _stream(partial(_ph_jacobi, dg=d, p=p), [du, *tarr], 1,
                            chunk, [du_new], st, pipeline=True)
                    du = du_new
        if p.median:
            du_m = np.empty_like(du)
            _stream(partial(_ph_median, p=p), [du], 1, chunk, [du_m], st,
                    pipeline=True)
            du = du_m
        flow = flow + du
        if p.flow_clamp > 0:
            np.clip(flow, -p.flow_clamp, p.flow_clamp, out=flow)
    return flow


def compute_flow_piecewise(i0, i1, params: FlowParams = FlowParams(),
                           chunk_z: int = 32,
                           checkpoint_dir: str | None = None,
                           temporal_block: bool = True, fuse: bool = True,
                           timer=None, device=None) -> np.ndarray:
    """Dense 3D optical flow for volumes past the device's memory or the
    kernels' index limits.

    i0, i1: (D, H, W) host arrays (numpy, or CPU tensors; any dtype). All
    whole-volume state stays in host RAM; the device sees only slabs of
    chunk_z planes plus margins, except under solver="multigrid", whose
    coarse hierarchy (<= 1/8 of the fine voxels) lives on the device. The
    slabs go to ``device``: the GPU unless the caller names another, and
    where there is no GPU that raises (pass ``device="cpu"`` to run the
    plain versions on the CPU). A non-positive flow_clamp becomes
    DEFAULT_FLOW_CLAMP (the margins need a bound). ``checkpoint_dir``:
    save the flow at every level boundary and resume from a checkpoint of
    this pyramid found there (``checkpoint.py``). ``temporal_block``:
    sweep with the trapezoid wavefront (else one streamed pass per
    half-sweep); ``fuse``: one streamed pass per warp iteration when
    inner_iterations == 1 under SOR. ``timer``: an optional
    ``utils.profiling.PhaseTimer`` (presmooth, pyramid, per-level solve
    and upsample). Returns the (3, D, H, W) float32 flow as a numpy
    array."""
    st = _Stager(default_device(device))
    check_supported(params, torch.empty(0, device=st.device))
    phase = PhaseTimer.maybe(timer)

    p = params
    if p.flow_clamp <= 0:
        p = p.replace(flow_clamp=DEFAULT_FLOW_CLAMP)
    i0, i1 = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                         np.float32) for x in (i0, i1))
    if i0.shape != i1.shape or i0.ndim != 3:
        raise ValueError(f"expected two equal-shape 3D volumes, got "
                         f"{i0.shape} vs {i1.shape}")
    d_orig = i0.shape[0]
    zm = p.z_multiple
    d_pad = zm * ((d_orig + zm - 1) // zm)
    if d_pad != d_orig:
        i0 = np.concatenate([i0, np.repeat(i0[-1:], d_pad - d_orig, 0)], 0)
        i1 = np.concatenate([i1, np.repeat(i1[-1:], d_pad - d_orig, 0)], 0)

    if p.normalize:
        mn = np.float32(min(i0.min(), i1.min()))
        mx = np.float32(max(i0.max(), i1.max()))
        scale = np.float32(1.0) / max(mx - mn, np.float32(1e-12))
        i0 = (i0 - mn) * scale
        i1 = (i1 - mn) * scale

    if p.presmooth_sigma > 0:
        with phase("presmooth"):
            r = (len(gaussian_kernel1d(p.presmooth_sigma)) - 1) // 2
            sm = partial(_ph_smooth, sigma=p.presmooth_sigma)
            i0s = np.empty_like(i0)
            i1s = np.empty_like(i1)
            _stream(sm, [i0], r, chunk_z, [i0s], st, pipeline=True)
            _stream(sm, [i1], r, chunk_z, [i1s], st, pipeline=True)
            i0, i1 = i0s, i1s

    shapes = p.level_shapes(i0.shape)
    pyr0, pyr1 = [i0], [i1]
    with phase("pyramid"):
        for shp in shapes[1:]:
            pyr0.append(_stream_resample(pyr0[-1], shp, p.aa_sigma(),
                                         chunk_z, st))
            pyr1.append(_stream_resample(pyr1[-1], shp, p.aa_sigma(),
                                         chunk_z, st))

    start = len(shapes) - 1
    flow = np.zeros((3, *shapes[-1]), np.float32)
    state = (None if checkpoint_dir is None
             else ckpt.resume_state(checkpoint_dir, shapes))
    if state is not None:
        flow, start = state

    for li in range(start, -1, -1):
        with phase(f"level{li}_solve"):
            flow = _solve_level_streamed(pyr0[li], pyr1[li], flow, p,
                                         chunk_z, st,
                                         temporal_block=temporal_block,
                                         fuse=fuse)
        if li > 0:
            with phase(f"level{li}_upsample"):
                in_shape = flow.shape[1:]
                ratios = [shapes[li - 1][a] / in_shape[a]
                          for a in range(3)]
                flow = _stream_resample(flow, shapes[li - 1], 0.0, chunk_z,
                                        st, ratios=ratios)
                np.clip(flow, -p.flow_clamp, p.flow_clamp, out=flow)
            if checkpoint_dir is not None:
                ckpt.save_level_checkpoint(checkpoint_dir, flow, li - 1, p)
    return flow[:, :d_orig]
