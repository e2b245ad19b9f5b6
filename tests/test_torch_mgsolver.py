"""The port's multigrid solver (mgsolver.py) against the JAX package's:
mg_shapes on isotropic, anisotropic and Z-rounded grids; every MGLevel
field of build_mg_levels at 24^3, with the rank-1 data block and with the
gradient-constancy one; mg_residual on every level; mg_solve with fixed
cycles, with the residual_tol early stop, and with residual tracking.

Both packages get the same frozen system: the JAX package's SolveTerms,
carried across as tensors, so each test holds the multigrid code alone
(test_torch_gamma.py and test_torch_sor.py hold compute_terms).

Tolerances, measured on the CPU: the level fields and the residual atol
1e-6 of each field's scale (measured bitwise equal: the same operations in
the same order), mg_solve atol 2e-5, rtol 1e-4 (measured 3.1e-6: the
V-cycle's resizes and sums round apart over three cycles) and the tracked
cycle norms rtol 2e-5 (measured 2.9e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import derivatives as rder
from tpuflow3d import mgsolver as rmg
from tpuflow3d import solver as rsol
from tpuflow3d import warp as rwarp
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d_torch import mgsolver as pmg
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.params import from_reference

torch.set_num_threads(2)

ALPHA = 0.05
P = RefParams(alpha=ALPHA, solver="multigrid", mg_cycles=3)
SOLVE_TOL = dict(atol=2e-5, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _system(shape=(24, 24, 24), seed=0, gamma=0.0):
    """The reference's frozen system (and a random start du), and the same
    terms as the port's SolveTerms."""
    rng = np.random.default_rng(seed)
    i0 = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1 = jax.jit(rwarp.warp_volume)(i0, jnp.asarray(-shift))
    g, it = rder.derivatives(i0, i1)
    gc = rder.grad_constancy_terms(i0, i1, g=g) if gamma > 0 else None
    flow = jnp.asarray((rng.normal(size=(3, *shape)) * 0.1)
                       .astype(np.float32))
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    p = P.replace(gamma=gamma)
    rt = rsol.compute_terms(g, it, flow, jnp.asarray(du), p, gc=gc)
    f = {k: None if v is None else _t(v) for k, v in rt._asdict().items()}
    pt = psol.SolveTerms(**{**f, "w": tuple(f["w"])})
    return p, du, rt, pt


def _close(got, want, scale_tol=1e-6, msg=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want,
                               atol=scale_tol * max(np.abs(want).max(), 1.0),
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("z_multiple", [1, 8])
@pytest.mark.parametrize("shape", [(256, 256, 256), (24, 24, 24),
                                   (32, 16, 16), (30, 17, 9), (64, 12, 40),
                                   (8, 8, 8), (7, 64, 64), (40, 96, 5)])
def test_mg_shapes_match_reference(shape, z_multiple):
    assert pmg.mg_shapes(shape, z_multiple) == rmg.mg_shapes(shape,
                                                             z_multiple)


@pytest.mark.parametrize("gamma", [0.0, 1.0])
def test_build_mg_levels_match_reference(gamma):
    p, _, rt, pt = _system(gamma=gamma)
    want = rmg.build_mg_levels(rt, p, RefCtx())
    got = pmg.build_mg_levels(pt, from_reference(p), HaloCtx())
    assert len(got) == len(want) == 3
    for i, (a, b) in enumerate(zip(got, want)):
        msg = f"level {i}"
        assert a.shape_global == b.shape_global, msg
        assert a.axis_alpha == pytest.approx(b.axis_alpha, rel=1e-12), msg
        assert torch.equal(a.parity, _t(b.parity).to(a.parity.dtype)), msg
        for name in ("d6", "sw", "psi_s"):
            _close(getattr(a, name), getattr(b, name), msg=f"{msg} {name}")
        _close(torch.stack(a.terms.w), b.terms.w, msg=f"{msg} w")
        _close(a.terms.ainv, b.terms.ainv, msg=f"{msg} ainv")
        assert a.terms.psi_s is a.psi_s


def test_mg_residual_matches_reference():
    p, du, rt, pt = _system(gamma=1.0)
    want = rmg.build_mg_levels(rt, p, RefCtx())
    got = pmg.build_mg_levels(pt, from_reference(p), HaloCtx())
    rng = np.random.default_rng(3)
    for a, b in zip(got, want):
        shp = (3, *a.shape_global)
        x = (rng.normal(size=shp) * 0.05).astype(np.float32)
        rhs = rng.normal(size=shp).astype(np.float32)
        r_want = rmg.mg_residual(jnp.asarray(x), b, jnp.asarray(rhs),
                                 RefCtx())
        r_got = pmg.mg_residual(torch.from_numpy(x), a,
                                torch.from_numpy(rhs), HaloCtx())
        _close(r_got, r_want)


def _solve_both(p, du, rt, pt, n_slot=None, offset=0):
    rslot = jnp.zeros(n_slot, jnp.float32) if n_slot else None
    r_du, r_res = rmg.mg_solve(jnp.asarray(du), rt, p, RefCtx(),
                               residuals_slot=rslot, slot_offset=offset)
    pslot = torch.zeros(n_slot) if n_slot else None
    p_du = pmg.mg_solve(torch.from_numpy(du), pt, from_reference(p),
                        HaloCtx(), residuals_slot=pslot, slot_offset=offset)
    np.testing.assert_allclose(p_du.numpy(), np.asarray(r_du), **SOLVE_TOL)
    return (np.asarray(r_res) if n_slot else None,
            pslot.numpy() if n_slot else None)


@pytest.mark.parametrize("gamma", [0.0, 1.0])
def test_mg_solve_fixed_cycles_and_tracking(gamma):
    p, du, rt, pt = _system(gamma=gamma)
    r_res, p_res = _solve_both(p, du, rt, pt, n_slot=8, offset=2)
    assert (p_res[2:5] > 0).all() and (p_res[:2] == 0).all()
    assert (p_res[5:] == 0).all()
    np.testing.assert_allclose(p_res, r_res, rtol=2e-5, atol=0)


def test_mg_solve_early_stop():
    """A residual_tol between the first and second cycles' update norms
    stops both solvers after two cycles."""
    p, du, rt, pt = _system()
    r_res, _ = _solve_both(p, du, rt, pt, n_slot=3)
    assert r_res[1] < r_res[0]
    tol = float(np.sqrt(r_res[0] * r_res[1]))
    stop = p.replace(residual_tol=tol)
    r_res, p_res = _solve_both(stop, du, rt, pt, n_slot=3)
    assert (p_res[:2] > 0).all() and p_res[2] == 0 and r_res[2] == 0
    np.testing.assert_allclose(p_res, r_res, rtol=2e-5, atol=0)


def test_mg_solve_reduces_the_residual():
    """Three V-cycles take the defect of the linear system well below the
    start's."""
    p, du, _, pt = _system()
    levels = pmg.build_mg_levels(pt, from_reference(p), HaloCtx())
    ctx = HaloCtx()
    du0 = torch.from_numpy(du)
    du3 = pmg.mg_solve(du0, pt, from_reference(p), ctx)
    r0 = pmg.mg_residual(du0, levels[0], pt.c, ctx).abs().mean()
    r3 = pmg.mg_residual(du3, levels[0], pt.c, ctx).abs().mean()
    assert float(r3) < 0.1 * float(r0)
