"""The port's compute_flow (plain versions, on the CPU) against
tpuflow3d.compute_flow on the cases of tests/test_pipeline.py, scaled to
32^3 with two pyramid levels: translation, rotation, sinusoid on Fourier
texture, median off with clamp 3, non-divisible Z, and Jacobi; the
``accurate`` preset (multigrid, tricubic, early stop, clamp 2) with 2
levels and 3 warps, with and without gradient constancy; gradient
constancy on SOR; tricubic on SOR; plus the residual_tol early stop and
track_residuals, on SOR and on multigrid. Both packages must also meet the
same EPE thresholds.

The colour-packed SOR path runs against the reference's packed Pallas
kernels in interpret mode (``backend="pallas"``): plain, with the early
stop, with gamma 1 and on a volume of odd W (which sweeps flat in both
packages); the port's packed flow is also held bitwise to its flat flow.
bfloat16 term storage runs on SOR (against the Pallas route, which like the
port solves with the stored g) and as ``accurate-bf16``; order-4 stencils
run on SOR.

Flow tolerance atol 5e-5, rtol 1e-4: about four times the largest
difference measured over these cases (1.3e-5, sinusoid; 1.1e-5,
``accurate`` with gamma; the others stay under 5e-6), and tighter than the
JAX package's own sharded-vs-unsharded gate (2e-4, 1e-3). The packed,
``accurate-bf16`` and order-4 cases hold the same tolerance.

bfloat16 terms on SOR get atol 2e-3 with a mean |difference| under 5e-5:
measured 7.6e-4 at the worst voxel (197 of 98 304 past the tolerance
above) and 8.3e-6 in the mean. Rounding c to 8 bits turns a last-bit
difference of the float32 c into a 0.4% step wherever the value sits on a
rounding boundary, and the sweeps carry that on. The reference's own
routes spread as far on this input: its packed and flat Pallas runs differ
by 5.9e-4 (131 voxels past the tolerance above), its Pallas and XLA runs
by 6.9e-4. The EPE is unmoved (0.013672 against 0.013674).

The port's plain rank-1 sweep solves with the stored g, as its kernels and
the reference's Pallas kernels do; the reference's XLA sweep takes ``smt``
from the unrounded g. ``backend="plain"`` against that XLA route, bfloat16
terms on SOR: 7.2e-4 at the worst voxel, 9.7e-6 in the mean (296 voxels
past the float32 tolerance), EPE 0.013672 against 0.013675. With the XLA
sweep's own ``smt`` in the port the same comparison gives 4.6e-4 and 8.6e-6
(109 voxels): the gap is the amplification above, not the choice of g, and
the reference's flat Pallas run is as far from its XLA run (7.3e-4)."""

import numpy as np
import pytest
import torch

from tpuflow3d import FlowParams as RefParams
from tpuflow3d import compute_flow as ref_compute_flow
from tpuflow3d import synthetic as syn
from tpuflow3d.params import PRESETS as REF_PRESETS
from tpuflow3d_torch import compute_flow
from tpuflow3d_torch.params import from_reference

torch.set_num_threads(2)

TOL = dict(atol=5e-5, rtol=1e-4)
P32 = RefParams(levels=2, scale_factor=0.5, warps=3, inner_iterations=3,
                sweeps=20, alpha=0.05)
S = (32, 32, 32)
ACC32 = REF_PRESETS["accurate"].replace(levels=2, warps=3)

# name -> (shape, flow_fn, params, texture, EPE threshold)
CASES = {
    "translation": (S, syn.translation((1.5, -1.0, 0.75)), P32, "blobs",
                    0.05),
    "rotation": (S, syn.rotation(center=(16, 16, 16), axis="z",
                                 degrees=2.0), P32, "blobs", 0.15),
    # The reference case's field (48-voxel wavelength) on a 32^3 volume.
    "sinusoid": (S, syn.sinusoid(S, amplitude=1.0, periods=32 / 48),
                 P32.replace(alpha=0.02), "fourier", 0.2),
    "median_off_clamp": (S, syn.translation((1.0, 0.5, -0.5)),
                         P32.replace(median=False, flow_clamp=3.0), "blobs",
                         0.1),
    "nondivisible_z": ((30, 32, 32), syn.translation((1.0, 0.0, 0.0)),
                       P32.replace(z_multiple=8), "blobs", 0.1),
    "jacobi": (S, syn.translation((0.8, -0.6, 0.4)),
               P32.replace(solver="jacobi", sweeps=120), "blobs", 0.2),
    "accurate": (S, syn.translation((1.5, -1.0, 0.75)), ACC32, "blobs",
                 0.05),
    "accurate_gamma": (S, syn.translation((1.5, -1.0, 0.75)),
                       ACC32.replace(gamma=1.0), "blobs", 0.05),
    "gamma": (S, syn.translation((1.5, -1.0, 0.75)), P32.replace(gamma=1.0),
              "blobs", 0.05),
    "tricubic_clamp": (S, syn.translation((1.5, -1.0, 0.75)),
                       P32.replace(interp="tricubic", flow_clamp=2.0),
                       "blobs", 0.05),
}


def _both(i0, i1, rp, diagnostics=False):
    ref = ref_compute_flow(i0, i1, rp, diagnostics=diagnostics)
    got = compute_flow(i0, i1, from_reference(rp), device="cpu",
                       diagnostics=diagnostics)
    return ref, got


@pytest.mark.parametrize("name", list(CASES))
def test_compute_flow_matches_reference(name):
    shape, fn, rp, texture, limit = CASES[name]
    i0, i1, true = syn.make_pair(shape, fn, seed=0, texture=texture)
    ref, got = _both(i0, i1, rp)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == (3, *shape)
    np.testing.assert_allclose(got, ref, **TOL)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(shape, 4)
    e_ref, e_got = syn.epe(ref, true, mask), syn.epe(got, true, mask)
    assert e_ref < limit and e_got < limit, (e_ref, e_got)
    if rp.flow_clamp > 0.0:
        assert np.abs(got).max() <= rp.flow_clamp + 1e-5


def test_residual_tol_and_tracked_residuals_match_reference():
    _check_tracked_residuals(P32)


def test_multigrid_tracked_residuals_match_reference():
    """Per-cycle update norms, in the first mg_cycles slots of each inner
    iteration's sweeps-wide stretch."""
    _check_tracked_residuals(P32.replace(solver="multigrid"))


def _check_tracked_residuals(rp):
    i0, i1, _ = syn.make_pair(S, syn.translation((1.0, 0.0, -0.5)), seed=0)
    (ref, rdiag), (got, pdiag) = _both(
        i0, i1, rp.replace(residual_tol=1e-4, track_residuals=True),
        diagnostics=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    rres, pres = np.asarray(rdiag["residuals"]), pdiag["residuals"].numpy()
    assert pres.shape == rres.shape == (2, P32.warps,
                                        P32.inner_iterations * P32.sweeps)
    # The early stop leaves the same sweeps unrun (zero) in both.
    np.testing.assert_array_equal(pres > 0, rres > 0)
    assert (pres == 0).any()
    np.testing.assert_allclose(pres, rres, atol=1e-6, rtol=1e-3)


# The packed SOR path: name -> (shape, params of the reference's Pallas
# route, packed by its default).
PALLAS32 = P32.replace(backend="pallas")
PACKED_CASES = {
    "packed": (S, PALLAS32),
    "packed_residual_tol": (S, PALLAS32.replace(residual_tol=1e-4)),
    "packed_gamma": (S, PALLAS32.replace(gamma=1.0)),
    # W = 29 halves to 15: both levels are odd and sweep flat.
    "odd_w_sweeps_flat": ((32, 32, 29), PALLAS32),
    "packed_bf16": (S, PALLAS32.replace(terms_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", list(PACKED_CASES))
def test_packed_compute_flow_matches_reference(name, monkeypatch):
    """compute_flow through the packed branch (the plain versions of K4 and
    K7 on the CPU) against the reference's packed Pallas run in interpret
    mode; and the port's packed flow against its flat flow, bitwise."""
    from tpuflow3d_torch import solver as psol
    shape, rp = PACKED_CASES[name]
    assert rp.sweep_layout == "packed"
    i0, i1, true = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)),
                                 seed=0)
    ref = np.asarray(ref_compute_flow(i0, i1, rp))
    calls = []
    sweeper = psol._packed_sweeper
    monkeypatch.setattr(psol, "_packed_sweeper",
                        lambda *a: calls.append(1) or sweeper(*a))
    pp = from_reference(rp).replace(backend="auto")
    got = compute_flow(i0, i1, pp, device="cpu")
    # Every inner iteration packs at even W; none does at odd W.
    n_inner = 2 * rp.warps * rp.inner_iterations
    assert len(calls) == (0 if shape[-1] % 2 else n_inner)
    if rp.terms_dtype == "bfloat16":
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=1e-4)
        assert np.abs(got.numpy() - ref).mean() < 5e-5
    else:
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(shape, 4)
    assert syn.epe(got.numpy(), true, mask) < 0.05
    flat = compute_flow(i0, i1, pp.replace(sweep_layout="flat"),
                        device="cpu")
    assert len(calls) == (0 if shape[-1] % 2 else n_inner)
    assert torch.equal(got, flat)
    # backend="plain" ignores the layout: flat, plain sweeps.
    plain = compute_flow(i0, i1, pp.replace(backend="plain"), device="cpu")
    assert torch.equal(plain, flat)


def test_plain_bf16_sor_against_reference_xla_route():
    """backend="plain" with bfloat16 terms on SOR (plain flat sweeps that
    solve with the stored g) against the reference's XLA route (smt of the
    unrounded g): the measured gap the module docstring states."""
    rp = P32.replace(terms_dtype="bfloat16", backend="xla")
    i0, i1, true = syn.make_pair(S, syn.translation((1.5, -1.0, 0.75)),
                                 seed=0)
    ref = np.asarray(ref_compute_flow(i0, i1, rp))
    got = compute_flow(i0, i1, from_reference(rp).replace(backend="plain"),
                       device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-4)
    assert np.abs(got - ref).mean() < 5e-5
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(S, 4)
    assert abs(syn.epe(got, true, mask) - syn.epe(ref, true, mask)) < 1e-4


def test_accurate_bf16_matches_reference():
    """The reference's ``accurate-bf16`` preset (multigrid on bfloat16 c
    and g, tricubic, early stop) with 2 levels and 3 warps."""
    rp = REF_PRESETS["accurate-bf16"].replace(levels=2, warps=3)
    assert rp.terms_dtype == "bfloat16"
    i0, i1, true = syn.make_pair(S, syn.translation((1.5, -1.0, 0.75)),
                                 seed=0)
    ref, got = _both(i0, i1, rp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(S, 4)
    assert syn.epe(got.numpy(), true, mask) < 0.05


@pytest.mark.parametrize("gamma", [0.0, 1.0])
def test_deriv_order4_matches_reference(gamma):
    """The 5-point stencils end to end on SOR, with and without gradient
    constancy (whose terms then use them too)."""
    rp = P32.replace(deriv_order=4, gamma=gamma)
    i0, i1, true = syn.make_pair(S, syn.translation((1.5, -1.0, 0.75)),
                                 seed=0)
    ref, got = _both(i0, i1, rp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(S, 4)
    assert syn.epe(got.numpy(), true, mask) < 0.05
