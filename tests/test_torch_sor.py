"""The port's SOR half-sweep (the plain version of kernel K1, and the K1
wrapper, which runs it for CPU tensors) against the JAX package's
solver.sor_halfsweep and its Pallas kernel in interpret mode.

Tolerance atol 5e-5, rtol 1e-5: the Pallas kernel sums the six neighbour
terms in another order than the XLA path (tests/test_pallas_sor.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import derivatives as rder
from tpuflow3d import solver as rsol
from tpuflow3d import warp as rwarp
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.pallas.sor import sor_halfsweep_pallas
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d_torch import kernels
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
from tpuflow3d_torch.params import FlowParams

torch.set_num_threads(2)

ALPHA = 0.05
TOL = dict(atol=5e-5, rtol=1e-5)


def _terms(shape, seed=0):
    """The same inputs through both packages' compute_terms."""
    rng = np.random.default_rng(seed)
    i0 = rng.normal(size=shape).astype(np.float32)
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1 = jax.jit(rwarp.warp_volume)(jnp.asarray(i0), jnp.asarray(-shift))
    g, it = jax.jit(rder.derivatives)(jnp.asarray(i0), i1)
    flow = (rng.normal(size=(3, *shape)) * 0.1).astype(np.float32)
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    rt = jax.jit(rsol.compute_terms, static_argnums=4)(
        g, it, jnp.asarray(flow), jnp.asarray(du), RefParams(alpha=ALPHA))
    pt = psol.compute_terms(torch.from_numpy(np.array(g)),
                            torch.from_numpy(np.array(it)),
                            torch.from_numpy(flow), torch.from_numpy(du),
                            FlowParams(alpha=ALPHA))
    return du, rt, pt


def _pallas_half(du, t, omega, color):
    ctx = RefCtx()
    lo, hi = ctx.z_halo_planes(du)
    plo, phi = ctx.z_halo_planes(t.psi_s)
    d = du.shape[1]
    return sor_halfsweep_pallas(du, t.c, t.g, t.psi_s, t.psi_d, lo, hi,
                                plo, phi, ctx.z0(d), ALPHA, omega, color,
                                ctx.d_global(d), interpret=True)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", [(12, 10, 14), (7, 9, 11), (13, 10, 12)])
def test_halfsweep_matches_reference(shape, color):
    du, rt, pt = _terms(shape)
    omega = 1.7
    parity = psol.parity_mask(shape, HaloCtx())
    got = psol.sor_halfsweep(torch.from_numpy(du), pt, omega, parity, color)
    xla = jax.jit(rsol.sor_halfsweep, static_argnums=(2, 4))(
        jnp.asarray(du), rt, omega, rsol.parity_mask(shape, RefCtx()), color)
    pallas = _pallas_half(jnp.asarray(du), rt, omega, color)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # The K1 wrapper runs the plain version for a CPU tensor, launching
    # nothing.
    before = dict(kernels.LAUNCHES)
    wrapped = k_sor(torch.from_numpy(du), pt, ALPHA, omega, color)
    assert torch.equal(wrapped, got)
    assert kernels.LAUNCHES == before


def test_sweep_sequence_matches_reference():
    """Five red+black sweeps, plain port vs the Pallas kernel."""
    shape = (10, 12, 8)
    du, rt, pt = _terms(shape, seed=3)
    omega = 1.9
    parity = psol.parity_mask(shape, HaloCtx())
    got, ref = torch.from_numpy(du), jnp.asarray(du)
    for _ in range(5):
        for color in (0, 1):
            got = psol.sor_halfsweep(got, pt, omega, parity, color)
            ref = _pallas_half(ref, rt, omega, color)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_jacobi_sweep_matches_reference():
    shape = (7, 9, 11)
    du, rt, pt = _terms(shape, seed=4)
    got = psol.jacobi_sweep(torch.from_numpy(du), pt, 1.0)
    ref = jax.jit(rsol.jacobi_sweep, static_argnums=2)(jnp.asarray(du), rt,
                                                      1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
