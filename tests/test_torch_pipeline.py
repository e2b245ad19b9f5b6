"""The port's compute_flow (plain versions, on the CPU) against
tpuflow3d.compute_flow on the cases of tests/test_pipeline.py, scaled to
32^3 with two pyramid levels: translation, rotation, sinusoid on Fourier
texture, median off with clamp 3, non-divisible Z, and Jacobi; the
``accurate`` preset (multigrid, tricubic, early stop, clamp 2) with 2
levels and 3 warps, with and without gradient constancy; gradient
constancy on SOR; tricubic on SOR; plus the residual_tol early stop and
track_residuals, on SOR and on multigrid. Both packages must also meet the
same EPE thresholds.

Flow tolerance atol 5e-5, rtol 1e-4: about four times the largest
difference measured over these cases (1.3e-5, sinusoid; 1.1e-5,
``accurate`` with gamma; the others stay under 5e-6), and tighter than the
JAX package's own sharded-vs-unsharded gate (2e-4, 1e-3)."""

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
