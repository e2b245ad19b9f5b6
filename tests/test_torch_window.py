"""The port's window context (a streamed slab of a larger volume: global
z0, possibly negative, and the volume's depth) against the JAX package's
``HaloCtx(window_z0=..., window_d_global=...)``, op by op: the warp
(trilinear and tricubic) and the plain route of K2/K5
(``kernels.warp_grad.warp_grad`` on CPU tensors), the parity, face masks
and solver terms, the single-colour SOR half-sweep (the plain K1 and K6),
the windowed Z resize of the streamed pyramid, and the streamed multigrid's
``assemble_fine_system`` / ``fine_residual``; each at a z0 below the
volume, at 0 with the slab shorter than the volume, and inside.

Tolerances, measured on the CPU: the warps, K2/K5's plain route, parity,
masks and the windowed resize bitwise (measured 0); compute_terms' c and
weights atol 1e-6, rtol 1e-6 (measured 2.0e-7 of their scale: XLA sums in
its own order); the half-sweeps and the residual at the port's SOR
tolerance against the reference, atol 5e-5, rtol 1e-5 (measured 0); the
fine system's inverse within 3e-6 of its scale, as
tests/test_torch_gamma.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import derivatives as rder
from tpuflow3d import mgsolver as rmg
from tpuflow3d import pyramid as rpyr
from tpuflow3d import solver as rsol
from tpuflow3d import warp as rwarp
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d_torch import mgsolver as pmg
from tpuflow3d_torch import pyramid as ppyr
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch import warp as pwarp
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels.warp_grad import warp_grad
from tpuflow3d_torch.params import from_reference

torch.set_num_threads(2)

DG = 20                 # the volume's depth
SLAB = (11, 9, 10)      # the slab's shape
# (z0, label): margins below the volume, the volume's first planes, inside,
# and hanging over the top.
WINDOWS = [(-4, "below"), (0, "first"), (5, "inside"), (13, "above")]
ATOL = 0.0
TERMS_TOL = dict(atol=1e-6, rtol=1e-6)
# The half-sweeps: the port's SOR tolerance against the reference
# (tests/test_torch_sor.py), as XLA rounds the point solve in its own order.
SOR_TOL = dict(atol=5e-5, rtol=1e-5)


def _ctxs(z0):
    return (HaloCtx(window_z0=z0, window_d_global=DG),
            RefCtx(window_z0=jnp.int32(z0), window_d_global=DG))


def _inputs(seed, max_disp=2.5):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=SLAB).astype(np.float32)
    vol2 = rng.normal(size=SLAB).astype(np.float32)
    flow = rng.uniform(-max_disp, max_disp, (3, *SLAB)).astype(np.float32)
    return vol, vol2, flow


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def test_window_context():
    ctx = HaloCtx(window_z0=-3, window_d_global=DG)
    assert ctx.is_window and not HaloCtx().is_window
    assert ctx.z0(7) == -3 and ctx.d_global(7) == DG
    assert not ctx.is_whole(7) and HaloCtx().is_whole(7)
    assert not HaloCtx(window_z0=0, window_d_global=8).is_whole(7)
    assert HaloCtx(window_z0=0, window_d_global=7).is_whole(7)
    assert ctx.has_z_neighbors is False
    np.testing.assert_array_equal(ctx.z_global(4).reshape(-1).numpy(),
                                  [-3, -2, -1, 0])
    lo, hi = ctx.z_halo_planes(torch.arange(12.0).reshape(3, 2, 2))
    assert torch.equal(lo, torch.arange(4.0).reshape(1, 2, 2))
    assert torch.equal(hi, torch.arange(8.0, 12.0).reshape(1, 2, 2))


@pytest.mark.parametrize("z0,_", WINDOWS)
def test_parity_and_face_masks(z0, _):
    ctx, rctx = _ctxs(z0)
    np.testing.assert_array_equal(
        psol.parity_mask(SLAB, ctx).numpy(),
        np.asarray(rsol.parity_mask(SLAB, rctx)))
    for got, want in zip(psol._face_masks(SLAB, ctx, torch.float32),
                         rsol._face_masks(SLAB, rctx, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interp", ["trilinear", "tricubic"])
@pytest.mark.parametrize("z0,_", WINDOWS)
def test_warp_volume(z0, _, interp):
    ctx, rctx = _ctxs(z0)
    vol, _, flow = _inputs(1)
    got = pwarp.warp_volume(torch.from_numpy(vol), torch.from_numpy(flow),
                            ctx, interp=interp)
    want = rwarp.warp_volume(jnp.asarray(vol), jnp.asarray(flow), rctx,
                             max_disp=2.5, interp=interp)
    _close(got, want)


def test_window_of_the_whole_volume_is_the_one_device_warp():
    """z0 = 0 and the volume's depth: the double clip is the single one."""
    vol, _, flow = _inputs(2, max_disp=8.0)
    d = SLAB[0]
    for interp in ("trilinear", "tricubic"):
        a = pwarp.warp_volume(torch.from_numpy(vol), torch.from_numpy(flow),
                              HaloCtx(window_z0=0, window_d_global=d),
                              interp=interp)
        b = pwarp.warp_volume(torch.from_numpy(vol), torch.from_numpy(flow),
                              interp=interp)
        assert torch.equal(a, b)


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("interp", ["trilinear", "tricubic"])
@pytest.mark.parametrize("z0,_", WINDOWS)
def test_warp_grad_plain_route(z0, _, interp, emit):
    """K2/K5's wrapper on CPU tensors (its plain version) under a window
    context, against the JAX warp + derivatives under the same window."""
    ctx, rctx = _ctxs(z0)
    i0, i1, flow = _inputs(3)
    got = warp_grad(torch.from_numpy(i1), torch.from_numpy(flow),
                    torch.from_numpy(i0), ctx, interp=interp,
                    emit_warped=emit)
    i1w = rwarp.warp_volume(jnp.asarray(i1), jnp.asarray(flow), rctx,
                            max_disp=2.5, interp=interp)
    g, it = rder.derivatives(jnp.asarray(i0), i1w, rctx)
    want = (g, it, i1w) if emit else (g, it)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


def _terms(z0, gamma):
    """The port's and the reference's compute_terms on one window slab, and
    the reference's terms as a port SolveTerms."""
    ctx, rctx = _ctxs(z0)
    i0, i1, flow = _inputs(4, max_disp=1.0)
    rng = np.random.default_rng(5)
    du = (rng.normal(size=(3, *SLAB)) * 0.05).astype(np.float32)
    rp = RefParams(alpha=0.05, gamma=gamma)
    p = from_reference(rp)
    g, it = rder.derivatives(jnp.asarray(i0), jnp.asarray(i1), rctx)
    rgc = pgc = None
    if gamma > 0:
        rgc = rder.grad_constancy_terms(jnp.asarray(i0), jnp.asarray(i1),
                                        rctx, g=g)
        pgc = tuple(_t(a) for a in rgc)
    rt = rsol.compute_terms(g, it, jnp.asarray(flow), jnp.asarray(du), rp,
                            rctx, gc=rgc)
    pt = psol.compute_terms(_t(g), _t(it), _t(flow), _t(du), p, ctx, gc=pgc)
    from_ref = psol.SolveTerms(**{
        f: (None if getattr(rt, f) is None else
            tuple(map(_t, rt.w)) if f == "w" else _t(getattr(rt, f)))
        for f in psol.SolveTerms._fields})
    return ctx, rctx, p, rp, _t(du), pt, rt, from_ref


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("gamma", [0.0, 1.5])
@pytest.mark.parametrize("z0,_", WINDOWS)
def test_terms_and_halfsweep(z0, _, gamma):
    """compute_terms under the window against the reference's, and one
    half-sweep of each colour (the plain K1, or K6 with gamma) on the
    reference's terms (the general system's inverse amplifies last-bit
    differences of its data block: tests/test_torch_gamma.py)."""
    ctx, rctx, p, rp, du, pt, rt, ft = _terms(z0, gamma)
    _close(pt.c, rt.c, **TERMS_TOL)
    for a, b in zip(pt.w, rt.w):
        _close(a, b, **TERMS_TOL)
    parity = psol.parity_mask(SLAB, ctx)
    rparity = rsol.parity_mask(SLAB, rctx)
    for color in (0, 1):
        got = psol.sor_halfsweep(du, ft, 1.9, parity, color, ctx)
        want = rsol.sor_halfsweep(jnp.asarray(du.numpy()), rt, 1.9, rparity,
                                  color, rctx)
        _close(got, want, **SOR_TOL)


@pytest.mark.parametrize("gamma", [0.0, 1.5])
@pytest.mark.parametrize("z0,_", WINDOWS)
def test_sweep_terms_rebuild_compute_terms(z0, _, gamma):
    """The streamed sweeps rebuild w, sw_inv and smt from (c, g, psi_s,
    psi_d) or (c, psi_s, ainv): bitwise compute_terms' own."""
    ctx, _, p, _, _, pt, _, _ = _terms(z0, gamma)
    if gamma > 0:
        st = psol.sweep_terms(pt.c, None, pt.psi_s, pt.ainv, p, ctx)
        assert st.ainv is pt.ainv and st.g is None
    else:
        st = psol.sweep_terms(pt.c, pt.g, pt.psi_s, pt.psi_d, p, ctx)
        assert torch.equal(st.sw_inv, pt.sw_inv)
        assert torch.equal(st.smt, pt.smt)
    assert all(torch.equal(a, b) for a, b in zip(st.w, pt.w))


@pytest.mark.parametrize("z0_out,z0_in,scale,in_global",
                         [(0, -2, 2.0, 24), (3, 4, 2.0, 24),
                          (5, 7, 1.6, 19), (9, 15, 2.0, 24)])
def test_resize_z_window(z0_out, z0_in, scale, in_global):
    rng = np.random.default_rng(6)
    xp = rng.normal(size=(3, 12, 5, 6)).astype(np.float32)
    got = ppyr.resize_z_window(torch.from_numpy(xp), 4, z0_out, z0_in, 1,
                               scale, in_global)
    want = rpyr.resize_z_window(jnp.asarray(xp), 4, jnp.int32(z0_out),
                                jnp.int32(z0_in), 1, scale, in_global)
    _close(got, want, atol=0.0)


@pytest.mark.parametrize("z0,_", WINDOWS)
def test_assemble_fine_system_and_residual(z0, _):
    """The streamed multigrid's fine system and residual from the
    reference's constituents (c, psi_s, d6): weights and sw at the terms'
    tolerance; ainv within 3e-6 of its scale, as tests/test_torch_gamma.py
    holds the inverse of one (d6, sw); the residual atol 5e-5, rtol 1e-5."""
    ctx, rctx, p, rp, du, _, rt, ft = _terms(z0, 1.5)
    rd6 = rmg.data_block_d6(rt)
    t, sw = pmg.assemble_fine_system(ft.c, ft.psi_s, _t(rd6), p, ctx)
    rtt, rsw = rmg.assemble_fine_system(rt.c, rt.psi_s, rd6, rp, rctx)
    _close(sw, rsw, **TERMS_TOL)
    ra = np.asarray(rtt.ainv)
    _close(t.ainv, ra, atol=3e-6 * np.abs(ra).max(), rtol=3e-6)
    for a, b in zip(t.w, rtt.w):
        _close(a, b, **TERMS_TOL)
    got = pmg.fine_residual(du, ft.c, ft.psi_s, _t(rd6), p, ctx)
    want = rmg.fine_residual(jnp.asarray(du.numpy()), rt.c, rt.psi_s, rd6,
                             rsw, rp, rctx)
    _close(got, want, **SOR_TOL)
