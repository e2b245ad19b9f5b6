"""The port's sweep wrappers (``sor_sweeps`` of K1, ``sor_gc_sweeps`` of
K6), which on CPU tensors run the plain version, n x (red half-sweep, black
half-sweep), against the same sequence of the JAX
package's solver.sor_halfsweep on numpy-seeded inputs; and the routing of
solve_increment and the multigrid smoother through them.

Tolerance atol 5e-5, rtol 1e-5 against the JAX package, as the half-sweep
tests (tests/test_torch_sor.py, tests/test_torch_gamma.py); bitwise against
n x two plain half-sweeps of the port."""

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
from tpuflow3d_torch import kernels
from tpuflow3d_torch import mgsolver as pmg
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import sor as k1
from tpuflow3d_torch.kernels import sor_gc as k6
from tpuflow3d_torch.params import FlowParams

torch.set_num_threads(2)

ALPHA, GAMMA = 0.05, 1.5
TOL = dict(atol=5e-5, rtol=1e-5)
# Even and odd H and W, W % 4 != 0, one plane, and a 32^3.
SHAPES = [(12, 10, 16), (7, 9, 11), (1, 6, 10), (32, 32, 32)]


def _ref_terms(shape, gamma, terms_dtype="float32", seed=0):
    """The JAX package's terms on seeded inputs, and the increment."""
    rng = np.random.default_rng(seed)
    i0 = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1w = jax.jit(rwarp.warp_volume)(i0, jnp.asarray(-shift))
    g, it = rder.derivatives(i0, i1w)
    gc = (rder.grad_constancy_terms(i0, i1w, g=g) if gamma > 0 else None)
    flow = (rng.normal(size=(3, *shape)) * 0.1).astype(np.float32)
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    rt = rsol.compute_terms(
        g, it, jnp.asarray(flow), jnp.asarray(du),
        RefParams(alpha=ALPHA, gamma=gamma, terms_dtype=terms_dtype), gc=gc)
    return du, rt


def _t(x):
    """A JAX array as a torch tensor, bfloat16 kept."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(x))


def _as_port(rt):
    """The reference's terms as the port's SolveTerms."""
    f = {k: None if v is None else (tuple(_t(w) for w in v) if k == "w"
                                    else _t(v))
         for k, v in rt._asdict().items()}
    return psol.SolveTerms(**f)


def _ref_sweeps(du, rt, omega, n):
    shape = du.shape[1:]
    par = rsol.parity_mask(shape, RefCtx())
    ref = jnp.asarray(du)
    for _ in range(n):
        for color in (0, 1):
            ref = rsol.sor_halfsweep(ref, rt, omega, par, color)
    return np.asarray(ref)


def _plain_sweeps(du, pt, omega, n):
    par = psol.parity_mask(tuple(du.shape[1:]), HaloCtx())
    out = du
    for _ in range(n):
        for color in (0, 1):
            out = psol.sor_halfsweep(out, pt, omega, par, color)
    return out


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sor_sweeps_match_reference(shape, terms_dtype, n):
    """K1 form: sor_sweeps on CPU tensors against n x (red, black) of the
    JAX package, and bitwise against the port's plain half-sweeps. With
    bfloat16 terms the reference's XLA sweep keeps the unrounded g's smt
    while the port solves with the stored g (as the reference's Pallas
    kernels), so only the float32 terms are held to the reference."""
    du, rt = _ref_terms(shape, 0.0, terms_dtype)
    pt = _as_port(rt)
    assert pt.c.dtype == getattr(torch, terms_dtype)
    tdu = torch.from_numpy(du)
    before = dict(kernels.LAUNCHES)
    got = k1.sor_sweeps(tdu, pt, ALPHA, 1.7, n)
    assert kernels.LAUNCHES == before  # CPU: plain version, no launch
    assert torch.equal(got, _plain_sweeps(tdu, pt, 1.7, n))
    assert torch.equal(tdu, torch.from_numpy(du))  # out-of-place
    if terms_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _ref_sweeps(du, rt, 1.7, n),
                                   **TOL)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sor_gc_sweeps_match_reference(shape, terms_dtype, n):
    """K6 form (terms with ainv)."""
    du, rt = _ref_terms(shape, GAMMA, terms_dtype)
    pt = _as_port(rt)
    assert pt.ainv is not None and pt.c.dtype == getattr(torch, terms_dtype)
    tdu = torch.from_numpy(du)
    before = dict(kernels.LAUNCHES)
    got = k6.sor_gc_sweeps(tdu, pt, (ALPHA,) * 3, 1.7, n)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, _plain_sweeps(tdu, pt, 1.7, n))
    np.testing.assert_allclose(got.numpy(), _ref_sweeps(du, rt, 1.7, n),
                               **TOL)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_sor_gc_sweeps_anisotropic_match_reference(shape, n):
    """An anisotropic multigrid level: the weights rebuilt with per-axis
    1/h^2 scales in both packages, the wrapper given the matching
    ``axis_alpha``."""
    scale = (1.0, 0.25, 0.0625)
    du, rt = _ref_terms(shape, GAMMA, seed=2)
    rw, _ = rmg._weights(rt.psi_s, scale, ALPHA, RefCtx())
    rt = rt._replace(w=jnp.stack(list(rw)))
    pt = _as_port(rt)
    pw, _ = pmg._weights(pt.psi_s, scale, ALPHA, HaloCtx())
    for a, b in zip(pw, pt.w):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)
    tdu = torch.from_numpy(du)
    got = k6.sor_gc_sweeps(tdu, pt, tuple(ALPHA * s for s in scale), 1.3, n)
    assert torch.equal(got, _plain_sweeps(tdu, pt, 1.3, n))
    np.testing.assert_allclose(got.numpy(), _ref_sweeps(du, rt, 1.3, n),
                               **TOL)


def test_zero_sweeps_and_bad_counts():
    du, rt = _ref_terms((4, 5, 6), GAMMA)
    pt = _as_port(rt)
    tdu = torch.from_numpy(du)
    assert torch.equal(k1.sor_sweeps(tdu, pt, ALPHA, 1.7, 0), tdu)
    assert torch.equal(k6.sor_gc_sweeps(tdu, pt, (ALPHA,) * 3, 1.7, 0), tdu)
    with pytest.raises(ValueError, match="n = -1"):
        k1.sor_sweeps(tdu, pt, ALPHA, 1.7, -1)
    with pytest.raises(ValueError, match="n = -1"):
        k6.sor_gc_sweeps(tdu, pt, (ALPHA,) * 3, 1.7, -1)


def test_one_device_ctx_has_no_z_neighbors():
    """The wrappers ask this before they fetch halo planes: on one device
    the slab is the whole volume."""
    ctx = HaloCtx()
    assert ctx.has_z_neighbors is False
    assert ctx.z0(7) == 0 and ctx.d_global(7) == 7 and ctx.n_shards == 1


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(du, t, *args):
        calls.append(args[-2])  # n
        return real(du, t, *args)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("gamma", [0.0, 1.0], ids=["k1", "k6"])
def test_solve_increment_routes_through_sweep_wrappers(monkeypatch, gamma):
    """With the kernel route chosen, solve_increment hands an inner
    iteration's sweeps to the wrapper in one call; with the residual track
    (or the early stop) it asks for one sweep at a time. Both give the
    plain route's bits (on CPU tensors the wrappers run the plain version).
    """
    from tpuflow3d_torch import derivatives as pder
    shape = (8, 10, 12)
    rng = np.random.default_rng(5)
    i0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    i1 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g, it = pder.derivatives(i0, i1)
    gc = pder.grad_constancy_terms(i0, i1, g=g) if gamma > 0 else None
    flow = torch.zeros((3, *shape))
    p = FlowParams(alpha=ALPHA, gamma=gamma, inner_iterations=2, sweeps=4)
    ctx = HaloCtx()
    parity = psol.parity_mask(shape, ctx)
    want = psol.solve_increment(g, it, flow, p, ctx, parity, gc=gc)
    slot_want = torch.zeros(8)
    psol.solve_increment(g, it, flow, p, ctx, parity, slot_want, gc=gc)

    monkeypatch.setattr(psol, "use_kernels", lambda p, x: True)
    module, name = (k6, "sor_gc_sweeps") if gamma > 0 else (k1, "sor_sweeps")
    calls = _count_calls(monkeypatch, module, name)
    got = psol.solve_increment(g, it, flow, p, ctx, parity, gc=gc)
    assert calls == [4, 4]
    assert torch.equal(got, want)
    del calls[:]
    slot = torch.zeros(8)
    got = psol.solve_increment(g, it, flow, p, ctx, parity, slot, gc=gc)
    assert calls == [1] * 8
    assert torch.equal(got, want) and torch.equal(slot, slot_want)
    del calls[:]
    stop = psol.solve_increment(g, it, flow, p.replace(residual_tol=1e9),
                                ctx, parity, gc=gc)
    assert calls == [1, 1]  # stops after the first sweep of each iteration
    monkeypatch.setattr(psol, "use_kernels", lambda p, x: False)
    assert torch.equal(stop, psol.solve_increment(
        g, it, flow, p.replace(residual_tol=1e9), ctx, parity, gc=gc))


def test_multigrid_smoother_routes_through_sor_gc_sweeps(monkeypatch):
    """With the kernel route chosen every _smooth call is one
    sor_gc_sweeps call of its n sweeps, and mg_solve keeps its bits."""
    shape = (16, 12, 20)
    du, rt = _ref_terms(shape, 0.0, seed=7)
    pt = _as_port(rt)
    p = FlowParams(alpha=ALPHA, solver="multigrid", mg_cycles=2)
    tdu = torch.from_numpy(du)
    want = pmg.mg_solve(tdu, pt, p, HaloCtx())
    monkeypatch.setattr(pmg, "use_kernels", lambda p, x: True)
    calls = _count_calls(monkeypatch, k6, "sor_gc_sweeps")
    got = pmg.mg_solve(tdu, pt, p, HaloCtx())
    assert torch.equal(got, want)
    n_levels = len(pmg.mg_shapes(shape, 1))
    per_cycle = ([p.mg_pre, p.mg_post] * (n_levels - 1)
                 + [p.mg_pre, p.mg_coarse_sweeps])
    assert sorted(calls) == sorted(per_cycle * p.mg_cycles)
