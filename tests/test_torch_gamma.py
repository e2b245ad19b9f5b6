"""The port's gradient-constancy pieces (gamma > 0) against the JAX package:
grad_constancy_terms, compute_terms with ``gc`` (every SolveTerms field,
the symmetric inverse ``ainv`` and the data block ``d6`` included), and the
general-SPD half-sweep, which is the plain version of kernel K6: through
solver.sor_halfsweep and through the K6 wrapper, which runs it for CPU
tensors, against the JAX XLA half-sweep and its Pallas kernel in
interpret mode.

Tolerances, measured on the CPU: grad_constancy_terms atol 1e-6 (measured
0: the same stencils); the compute_terms fields atol 1e-6, rtol 4e-6
(measured up to 7.5e-7 relative, d6); ainv from the same (d6, sw) 3e-6 of
its scale (measured 7.0e-7). The port's own ainv departs further (up to
4.5e-4 relative): the data block reaches ~1e4 against sw ~1, so the
adjugate amplifies last-bit differences of d6, and the sweeps are held to
the reference on the reference's terms, at atol 5e-5, rtol 1e-5 as K1 and
the JAX package's own Pallas-against-XLA test of this kernel (measured 0
against the XLA sweep). ainv A = I holds to 4e-3 (measured 9.0e-4, the same
conditioning)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import derivatives as rder
from tpuflow3d import solver as rsol
from tpuflow3d import warp as rwarp
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.pallas.sor_gc import sor_halfsweep_gc_pallas
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d_torch import derivatives as pder
from tpuflow3d_torch import kernels
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels.sor_gc import sor_halfsweep_gc
from tpuflow3d_torch.params import FlowParams

torch.set_num_threads(2)

ALPHA, GAMMA = 0.05, 1.5
SHAPES = [(12, 10, 14), (8, 16, 16), (7, 9, 11)]
SWEEP_TOL = dict(atol=5e-5, rtol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    i0 = rng.normal(size=shape).astype(np.float32)
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1w = np.array(jax.jit(rwarp.warp_volume)(jnp.asarray(i0),
                                              jnp.asarray(-shift)))
    flow = (rng.normal(size=(3, *shape)) * 0.1).astype(np.float32)
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    return i0, i1w, flow, du


def _terms(shape, seed=0, gamma=GAMMA):
    """The same inputs through both packages' derivatives,
    grad_constancy_terms and compute_terms."""
    i0, i1w, flow, du = _pair(shape, seed)
    g, it = rder.derivatives(jnp.asarray(i0), jnp.asarray(i1w))
    gc = rder.grad_constancy_terms(jnp.asarray(i0), jnp.asarray(i1w), g=g)
    rt = rsol.compute_terms(g, it, jnp.asarray(flow), jnp.asarray(du),
                            RefParams(alpha=ALPHA, gamma=gamma), gc=gc)
    ti0, ti1w = torch.from_numpy(i0), torch.from_numpy(i1w)
    pg, pit = pder.derivatives(ti0, ti1w)
    pgc = pder.grad_constancy_terms(ti0, ti1w, g=pg)
    pt = psol.compute_terms(pg, pit, torch.from_numpy(flow),
                            torch.from_numpy(du),
                            FlowParams(alpha=ALPHA, gamma=gamma), gc=pgc)
    return du, rt, pt


def _as_port(rt):
    """The reference's terms as the port's SolveTerms (the weights as a
    tuple of six volumes)."""
    f = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in rt._asdict().items()}
    return psol.SolveTerms(**{**f, "w": tuple(f["w"])})


@pytest.mark.parametrize("reuse_g", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_constancy_terms_match_reference(shape, reuse_g):
    i0, i1w, _, _ = _pair(shape)
    g = rder.derivatives(jnp.asarray(i0), jnp.asarray(i1w))[0]
    want = rder.grad_constancy_terms(jnp.asarray(i0), jnp.asarray(i1w),
                                     g=g if reuse_g else None)
    pg = torch.from_numpy(np.array(g))
    got = pder.grad_constancy_terms(torch.from_numpy(i0),
                                    torch.from_numpy(i1w),
                                    g=pg if reuse_g else None)
    assert got[0].shape == (3, 3, *shape) and got[1].shape == (3, *shape)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=0)


def test_grad_constancy_order4_raises():
    """Order 4 is served (the 5-point stencil, held to the reference in
    tests/test_torch_ops.py): it no longer raises and differs from order
    2; an order that is neither 2 nor 4 raises."""
    i0, i1w, _, _ = _pair((8, 9, 10))
    ti0, ti1w = torch.from_numpy(i0), torch.from_numpy(i1w)
    g4, it4 = pder.grad_constancy_terms(ti0, ti1w, order=4)
    g2, _ = pder.grad_constancy_terms(ti0, ti1w, order=2)
    assert g4.shape == g2.shape == (3, 3, 8, 9, 10)
    assert bool(torch.isfinite(g4).all()) and not torch.equal(g4, g2)
    want = rder.grad_constancy_terms(jnp.asarray(i0), jnp.asarray(i1w),
                                     order=4)
    np.testing.assert_allclose(_np(g4), _np(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(it4), _np(want[1]), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="deriv_order"):
        pder.grad_constancy_terms(ti0, ti1w, order=3)


@pytest.mark.parametrize("shape", SHAPES)
def test_compute_terms_with_gc_match_reference(shape):
    _, rt, pt = _terms(shape)
    assert pt.ainv.shape == pt.d6.shape == (6, *shape)
    for name in ("c", "g", "sw_inv", "smt", "psi_s", "psi_d", "d6"):
        np.testing.assert_allclose(_np(getattr(pt, name)),
                                   _np(getattr(rt, name)), atol=1e-6,
                                   rtol=4e-6, err_msg=name)
    np.testing.assert_allclose(np.stack([_np(w) for w in pt.w]),
                               _np(rt.w), atol=1e-6, rtol=0)
    # The adjugate inverse of the stiff data block amplifies the last-bit
    # differences of d6, so ainv is compared on the reference's own d6 and
    # sw.
    sw = torch.from_numpy(1.0 / _np(rt.sw_inv))
    d6 = torch.from_numpy(np.array(rt.d6))
    ainv = psol._sym3_inverse(d6[0] + sw, d6[1], d6[2], d6[3] + sw, d6[4],
                              d6[5] + sw)
    ra = _np(rt.ainv)
    np.testing.assert_allclose(ainv.numpy(), ra,
                               atol=3e-6 * np.abs(ra).max(), rtol=3e-6)


def test_ainv_is_the_inverse():
    """ainv times A = sw*I + d6 is the identity, per voxel."""
    _, _, t = _terms((6, 8, 8))
    sw = 1.0 / t.sw_inv
    d = t.d6
    a = torch.stack([torch.stack([d[0] + sw, d[1], d[2]]),
                     torch.stack([d[1], d[3] + sw, d[4]]),
                     torch.stack([d[2], d[4], d[5] + sw])])
    i = t.ainv
    ai = torch.stack([torch.stack([i[0], i[1], i[2]]),
                      torch.stack([i[1], i[3], i[4]]),
                      torch.stack([i[2], i[4], i[5]])])
    prod = torch.einsum("ij...,jk...->ik...", ai.double(), a.double())
    eye = torch.eye(3, dtype=torch.float64).reshape(3, 3, 1, 1, 1)
    torch.testing.assert_close(prod, eye.expand_as(prod), atol=4e-3,
                               rtol=0)


def test_gamma_and_gc_go_together():
    shape = (4, 5, 6)
    z = torch.zeros(shape)
    g = torch.zeros((3, *shape))
    gc = (torch.zeros((3, 3, *shape)), torch.zeros((3, *shape)))
    with pytest.raises(ValueError, match="gamma"):
        psol.compute_terms(g, z, g, g, FlowParams(gamma=1.0))
    with pytest.raises(ValueError, match="gamma"):
        psol.compute_terms(g, z, g, g, FlowParams(), gc=gc)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_ainv_halfsweep_matches_reference(shape, color):
    """solver.sor_halfsweep on terms with ainv (K6's plain version) and the
    K6 wrapper on CPU tensors, against the JAX XLA half-sweep and its
    Pallas kernel in interpret mode."""
    omega = 1.7
    du, rt, pt = _terms(shape)
    rctx = RefCtx()
    ref = rsol.sor_halfsweep(jnp.asarray(du), rt, omega,
                             rsol.parity_mask(shape, rctx), color, rctx)
    lo, hi = rctx.z_halo_planes(jnp.asarray(du))
    plo, phi = rctx.z_halo_planes(rt.psi_s)
    pallas = sor_halfsweep_gc_pallas(jnp.asarray(du), rt.c, rt.ainv,
                                     rt.psi_s, lo, hi, plo, phi, 0, ALPHA,
                                     omega, color, shape[0], interpret=True)
    pt = _as_port(rt)
    tdu = torch.from_numpy(du)
    plain = psol.sor_halfsweep(tdu, pt, omega,
                               psol.parity_mask(shape, HaloCtx()), color)
    before = dict(kernels.LAUNCHES)
    wrapped = sor_halfsweep_gc(tdu, pt, (ALPHA,) * 3, omega, color)
    assert kernels.LAUNCHES == before  # CPU: plain version, no launch
    assert torch.equal(wrapped, plain)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **SWEEP_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas),
                               **SWEEP_TOL)
    other = (psol.parity_mask(shape, HaloCtx()) != color)[None].expand_as(
        tdu)
    assert torch.equal(plain[other], tdu[other])


def test_gc_sweep_sequence_matches_reference():
    shape = (10, 12, 8)
    omega = 1.9
    du, rt, _ = _terms(shape, seed=1)
    pt = _as_port(rt)
    rpar = rsol.parity_mask(shape, RefCtx())
    ref, got = jnp.asarray(du), torch.from_numpy(du)
    for _ in range(4):
        for color in (0, 1):
            ref = rsol.sor_halfsweep(ref, rt, omega, rpar, color)
            got = sor_halfsweep_gc(got, pt, (ALPHA,) * 3, omega, color)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SWEEP_TOL)
