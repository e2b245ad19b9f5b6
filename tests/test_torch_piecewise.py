"""The port's out-of-core mode, ``piecewise.compute_flow_piecewise`` on the
CPU (plain versions), against the JAX package's ``compute_flow_piecewise``
(XLA on the CPU) on the same inputs, on the cases of
tests/test_piecewise.py: chunks of 1, 4, 8 and 64 planes, a Z of 22 planes
in chunks of 8, Jacobi with the median off, order-4 stencils, gamma > 0
(the fused pass and the per-phase route), multigrid (one warp, and two
levels with the early stop), tricubic, the fused pass against per
half-sweep streaming, and ``temporal_block=False``.

Tolerance atol 5e-6: about twice the largest difference measured over
these cases (2.2e-6, multigrid; every other case under 9e-7), tighter than
the 2e-5 the port's in-core flow keeps to the reference.

Then the port streamed against the port in-core at the JAX tests' own
gates (atol 1e-6 for the single-sweep, order-4 and tricubic cases; the
nonlinear cases to flow-level agreement), the fused pass and the trapezoid
against per-half-sweep streaming, the fused pass's gap from the phased
one against the JAX package's own gap (with a planted carry fault for
scale), the streamed multigrid solve against
``mg_solve`` on a frozen system, and the device rules: no GPU, no run
unless ``device="cpu"``."""

import functools

import numpy as np
import pytest
import torch

from tpuflow3d import FlowParams as RP
from tpuflow3d import synthetic as rsyn
from tpuflow3d.piecewise import compute_flow_piecewise as ref_piecewise
from tpuflow3d_torch import FlowParams, compute_flow
from tpuflow3d_torch import piecewise as pw
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.piecewise import compute_flow_piecewise

torch.set_num_threads(2)

TOL = dict(atol=5e-6, rtol=0.0)
S = (24, 16, 16)
_STRICT = dict(levels=1, warps=1, inner_iterations=1, sweeps=1, median=False,
               presmooth_sigma=0.0, normalize=False, alpha=0.05,
               flow_clamp=4.0, backend="xla")

# name -> (shape, translation, seed, reference params, piecewise keywords)
CASES = {
    "strict_chunk4": (S, (0.8, -0.5, 0.6), 0, RP(**_STRICT),
                      dict(chunk_z=4)),
    "strict_chunk8": (S, (0.8, -0.5, 0.6), 0, RP(**_STRICT),
                      dict(chunk_z=8)),
    "strict_chunk64": (S, (0.8, -0.5, 0.6), 0, RP(**_STRICT),
                       dict(chunk_z=64)),
    "full_chunk8": (S, (0.8, -0.5, 0.6), 0,
                    RP(levels=2, warps=2, inner_iterations=2, sweeps=8,
                       alpha=0.05, flow_clamp=4.0, backend="xla"),
                    dict(chunk_z=8)),
    "nondivisible_z": ((22, 16, 16), (0.8, -0.5, 0.6), 5,
                       RP(levels=2, warps=1, inner_iterations=1, sweeps=5,
                          alpha=0.05, flow_clamp=4.0, backend="xla"),
                       dict(chunk_z=8)),
    "jacobi_median_off": ((16, 16, 16), (0.8, -0.5, 0.6), 3,
                          RP(levels=1, warps=1, inner_iterations=1,
                             sweeps=10, solver="jacobi", median=False,
                             alpha=0.05, flow_clamp=4.0, backend="xla"),
                          dict(chunk_z=4)),
    "deriv_order4": (S, (0.6, 0.0, 0.4), 12,
                     RP(**{**_STRICT, "flow_clamp": 2.0, "deriv_order": 4}),
                     dict(chunk_z=4)),
    "gamma_fused": (S, (0.8, -0.5, 0.6), 0,
                    RP(levels=2, warps=2, inner_iterations=1, sweeps=4,
                       alpha=0.05, gamma=1.5, flow_clamp=2.0, backend="xla"),
                    dict(chunk_z=4)),
    "gamma_phases": (S, (0.8, -0.5, 0.6), 0,
                     RP(levels=1, warps=1, inner_iterations=2, sweeps=5,
                        median=False, presmooth_sigma=0.0, normalize=False,
                        alpha=0.05, gamma=1.0, flow_clamp=4.0,
                        backend="xla"),
                     dict(chunk_z=4)),
    "multigrid": (S, (0.8, -0.5, 0.6), 0,
                  RP(**{**_STRICT, "sweeps": 4, "solver": "multigrid",
                        "mg_cycles": 2}),
                  dict(chunk_z=8)),
    "multigrid_early_stop": (S, (0.8, -0.5, 0.6), 0,
                             RP(levels=2, warps=2, inner_iterations=2,
                                sweeps=8, solver="multigrid", mg_cycles=2,
                                residual_tol=1e-4, alpha=0.05,
                                flow_clamp=2.0, backend="xla"),
                             dict(chunk_z=8)),
    "tricubic": ((20, 14, 14), (0.5, 0.2, -0.4), 23,
                 RP(levels=1, warps=2, inner_iterations=1, sweeps=4,
                    interp="tricubic", flow_clamp=1.5, backend="xla"),
                 dict(chunk_z=5)),
    "fused_chunk1": ((10, 12, 12), (0.3, -0.2, 0.5), 17,
                     RP(levels=1, warps=1, inner_iterations=1, sweeps=3,
                        flow_clamp=1.5, backend="xla"),
                     dict(chunk_z=1)),
    "fused_chunk64": ((10, 12, 12), (0.3, -0.2, 0.5), 17,
                      RP(levels=1, warps=1, inner_iterations=1, sweeps=3,
                         flow_clamp=1.5, backend="xla"),
                      dict(chunk_z=64)),
    "per_halfsweep": ((22, 16, 16), (0.4, -0.3, 0.8), 11,
                      RP(levels=2, warps=2, inner_iterations=1, sweeps=3,
                         flow_clamp=2.0, backend="xla"),
                      dict(chunk_z=4, temporal_block=False, fuse=False)),
    "trapezoid": ((22, 16, 16), (0.0, 0.5, 1.0), 7,
                  RP(levels=2, warps=2, inner_iterations=2, sweeps=3,
                     flow_clamp=2.0, backend="xla"),
                  dict(chunk_z=4)),
    "no_temporal_block": ((22, 16, 16), (0.0, 0.5, 1.0), 7,
                          RP(levels=2, warps=2, inner_iterations=2, sweeps=3,
                             flow_clamp=2.0, backend="xla"),
                          dict(chunk_z=4, temporal_block=False)),
}


def _pair(shape, shift, seed):
    return syn.make_pair(shape, syn.translation(shift), seed=seed)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's streamed flow of a case, computed once per module
    (each slab shape compiles its own jit)."""
    shape, shift, seed, rp, kw = CASES[name]
    i0, i1, _ = rsyn.make_pair(shape, rsyn.translation(shift), seed=seed)
    return ref_piecewise(i0, i1, rp, **kw)


def _port(name, **over):
    shape, shift, seed, rp, kw = CASES[name]
    i0, i1, _ = _pair(shape, shift, seed)
    return compute_flow_piecewise(i0, i1, from_reference(rp).replace(**over),
                                  device="cpu", **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_piecewise(name):
    got = _port(name)
    want = _reference(name)
    assert got.shape == want.shape == (3, *CASES[name][0])
    np.testing.assert_allclose(got, want, **TOL)


# ---- the port streamed against the port in-core (tests/test_piecewise.py's
# gates) ----

def _params(name, **over):
    return from_reference(CASES[name][3]).replace(**over)


def _incore(name, **over):
    shape, shift, seed, _, _ = CASES[name]
    i0, i1, _ = _pair(shape, shift, seed)
    return compute_flow(i0, i1, _params(name, **over), device="cpu").numpy()


@pytest.mark.parametrize("name", ["strict_chunk4", "strict_chunk8",
                                  "strict_chunk64", "deriv_order4",
                                  "gamma_phases"])
def test_single_sweep_matches_incore_strictly(name):
    """One sweep (or gamma's per-phase route with its own sweep count):
    chunked streaming reproduces the in-core update to float noise."""
    np.testing.assert_allclose(_port(name), _incore(name), atol=1e-6)


def test_linear_convergence_matches_incore():
    got = _port("strict_chunk4", sweeps=64)
    np.testing.assert_allclose(got, _incore("strict_chunk4", sweeps=64),
                               atol=1e-4)


@pytest.mark.parametrize("name", ["full_chunk8", "nondivisible_z"])
def test_nonlinear_matches_incore(name):
    """The Charbonnier re-weighting amplifies last-bit differences (the
    slab-local warp coordinates round apart from the global ones), so the
    gate is flow-level agreement and equal accuracy."""
    shape, shift, seed, _, _ = CASES[name]
    got, ref = _port(name), _incore(name)
    d = np.abs(got - ref)
    assert d.max() < 5e-2 and d.mean() < 1e-2, (d.max(), d.mean())
    true = syn.make_pair(shape, syn.translation(shift), seed=seed)[2]
    mask = syn.interior_mask(shape, 3)
    assert abs(syn.epe(got, true, mask) - syn.epe(ref, true, mask)) < 0.02


def test_jacobi_and_tricubic_match_incore():
    np.testing.assert_allclose(_port("jacobi_median_off"),
                               _incore("jacobi_median_off"), atol=2e-5,
                               rtol=1e-4)
    over = dict(levels=2, warps=1, z_multiple=1)
    np.testing.assert_allclose(_port("tricubic", **over),
                               _incore("tricubic", **over), atol=1e-6)


def test_multigrid_and_gamma_match_incore():
    np.testing.assert_allclose(_port("multigrid"), _incore("multigrid"),
                               atol=1e-5)
    over = dict(levels=1, warps=1, presmooth_sigma=0.0, normalize=False)
    np.testing.assert_allclose(_port("gamma_fused", **over),
                               _incore("gamma_fused", **over), atol=1e-5)


@pytest.mark.parametrize("shape,chunk,sweeps,median,gamma",
                         [((22, 16, 16), 4, 3, True, 0.0),
                          ((16, 12, 12), 8, 6, True, 0.0),
                          ((9, 10, 10), 3, 2, False, 0.0),
                          ((22, 16, 16), 4, 4, True, 1.5)])
def test_fused_matches_per_halfsweep(shape, chunk, sweeps, median, gamma):
    """The fused pass (one launch per chunk, the du frontier band carried
    on the device) against per-half-sweep streaming, 2*sweeps > chunk and
    partial chunks included."""
    i0, i1, _ = _pair(shape, (0.4, -0.3, 0.8), 11)
    p = FlowParams(levels=2, warps=2, inner_iterations=1, sweeps=sweeps,
                   median=median, flow_clamp=2.0, gamma=gamma)
    a = compute_flow_piecewise(i0, i1, p, chunk_z=chunk, device="cpu")
    b = compute_flow_piecewise(i0, i1, p, chunk_z=chunk, device="cpu",
                               temporal_block=False, fuse=False)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def fused_gaps(size: int, chunk: int = 16) -> dict:
    """max |fused - phased| of each package's compute_flow_piecewise on one
    blob translation of size^3 (seed 0, shift (1.5, -1, 0.75); 3 levels,
    3 warps, one inner iteration, 20 sweeps, flow clamp 4) on the CPU, and
    of the port's fused pass with a fault planted in it: its du carry band
    read one plane off. The two passes place their slabs at different
    origins, and the slab-local warp coordinate z + s_z rounds with the
    origin, so the clean gap grows with the volume in both packages. At
    larger sizes this gives the series in PERF.md."""
    i0, i1, _ = _pair((size,) * 3, (1.5, -1.0, 0.75), 0)
    rp = RP(levels=3, warps=3, inner_iterations=1, sweeps=20, flow_clamp=4.0,
            backend="xla")
    p = from_reference(rp)
    fused = compute_flow_piecewise(i0, i1, p, chunk_z=chunk, device="cpu")
    phased = compute_flow_piecewise(i0, i1, p, chunk_z=chunk, device="cpu",
                                    fuse=False)
    real = pw._ph_fused_warp_iter

    def shifted(i0s, i1s, fls, carry, *rest, **kw):
        return real(i0s, i1s, fls, torch.cat([carry[:, 1:], carry[:, -1:]],
                                             1), *rest, **kw)

    pw._ph_fused_warp_iter = shifted
    try:
        planted = compute_flow_piecewise(i0, i1, p, chunk_z=chunk,
                                         device="cpu")
    finally:
        pw._ph_fused_warp_iter = real
    ref = [ref_piecewise(i0, i1, rp, chunk_z=chunk, fuse=f)
           for f in (True, False)]
    gap = lambda a, b: float(np.abs(a - b).max())
    return {"port": gap(fused, phased), "jax": gap(*ref),
            "planted": gap(planted, phased)}


def test_fused_gap_is_the_references():
    """At 32^3 the two passes differ by more than tests/test_piecewise.py's
    1e-6 in both packages (port 2.5e-6, JAX 1.7e-6): the port's gap stays
    within 3x the JAX package's own, and a planted carry fault shows 1e4x
    above it."""
    gaps = fused_gaps(32)
    assert gaps["port"] <= 3.0 * gaps["jax"], gaps
    assert gaps["planted"] > 1e4 * gaps["port"], gaps


@pytest.mark.parametrize("gamma", [0.0, 1.0])
def test_trapezoid_exactly_per_halfsweep(gamma):
    """The wavefront is exactly the per-half-sweep streaming order."""
    i0, i1, _ = _pair((22, 16, 16), (0.0, 0.5, 1.0), 7)
    p = FlowParams(levels=2, warps=2, inner_iterations=2, sweeps=3,
                   flow_clamp=2.0, gamma=gamma)
    a = compute_flow_piecewise(i0, i1, p, chunk_z=4, device="cpu")
    b = compute_flow_piecewise(i0, i1, p, chunk_z=4, device="cpu",
                               temporal_block=False)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [8, 16])
def test_streamed_multigrid_solve_matches_mg_solve(chunk):
    """On a frozen linear system the streamed V-cycle (trapezoid smooths,
    streamed residual and resampling, the coarse chain on the device)
    reproduces mg_solve, also with the early stop."""
    from tpuflow3d_torch.derivatives import derivatives
    from tpuflow3d_torch.mgsolver import data_block_d6, mg_solve
    from tpuflow3d_torch.solver import compute_terms
    from tpuflow3d_torch.warp import warp_volume

    shape = (32, 24, 24)
    rng = np.random.default_rng(0)
    i0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    shift = torch.zeros((3, *shape))
    shift[2] = 0.7
    g, it = derivatives(i0, warp_volume(i0, -shift))
    for kw in (dict(), dict(mg_cycles=6, residual_tol=1e-4, sweeps=8)):
        p = FlowParams(solver="multigrid", mg_cycles=2, mg_pre=2, mg_post=2,
                       alpha=0.05).replace(**kw)
        zero = torch.zeros((3, *shape))
        t = compute_terms(g, it, zero, zero, p)
        want = mg_solve(zero, t, p)
        got = pw._stream_mg_solve(
            np.zeros((3, *shape), np.float32), t.c.numpy(),
            t.psi_s.numpy(), data_block_d6(t).numpy(), p, chunk,
            pw._Stager(torch.device("cpu")))
        np.testing.assert_allclose(got, want.numpy(), atol=2e-6)


def test_registration_fit_streamed():
    """|warp(i1, flow) - i0| statistics streamed against in-core."""
    from tpuflow3d_torch.warp import warp_volume

    rng = np.random.default_rng(3)
    i0 = rng.normal(size=(14, 12, 16)).astype(np.float32)
    i1 = rng.normal(size=(14, 12, 16)).astype(np.float32)
    flow = rng.uniform(-1.5, 1.5, size=(3, 14, 12, 16)).astype(np.float32)
    mean_r, max_r, before = pw.registration_fit_streamed(
        i0, i1, flow, FlowParams(flow_clamp=2.0), chunk_z=5, device="cpu")
    r = np.abs(warp_volume(torch.from_numpy(i1), torch.from_numpy(flow))
               .numpy() - i0)
    assert abs(mean_r - r.mean()) < 1e-6
    assert abs(max_r - r.max()) < 1e-6 * max(1.0, r.max())
    assert abs(before - np.abs(i1 - i0).mean()) < 1e-6


def test_stager_replicates_the_faces():
    st = pw._Stager(torch.device("cpu"))
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 1, 3)
    for lo, size in ((-3, 4), (-2, 9), (1, 3), (3, 5), (6, 2), (-4, 2)):
        idx = np.clip(np.arange(lo, lo + size), 0, 4)
        np.testing.assert_array_equal(st.put(x, lo, size).numpy(),
                                      x[:, idx])


def test_device_rules():
    i0, i1, _ = _pair((8, 8, 8), (0.5, 0.0, 0.0), 1)
    p = FlowParams(levels=1, warps=1, inner_iterations=1, sweeps=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            compute_flow_piecewise(i0, i1, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_flow_piecewise(i0, i1, p.replace(backend="kernels"),
                               device="cpu")
    out = compute_flow_piecewise(torch.from_numpy(i0), torch.from_numpy(i1),
                                 p, chunk_z=3, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == (3, 8, 8, 8)
