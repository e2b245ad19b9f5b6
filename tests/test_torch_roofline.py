"""The port's roofline (``tpuflow3d_torch.utils.roofline``) against the JAX
package's (``tpuflow3d.utils.roofline``), on the CPU, and its byte model
against what the kernels' wrappers move.

Equal where the arithmetic is the reference's: the sweep equivalents of a
run, the expected fraction at a given bandwidth and rate, the packed byte
model (K4 36 B, bfloat16 terms 30) and the end-to-end bound of the packed
layout. Where the port's kernels differ, its own numbers: the flat model
is one fused red+black launch (56 B a sweep against the reference's 112),
the warp's operations do not grow with the clamp (no select window). The
byte model is held to the tensors: at 32^3 the bytes of the arguments each
wrapper hands its kernel and of the outputs, over the voxels, are the
model's, for every kernel form that ``chip_smoke.py`` bounds.
"""

import math

import numpy as np
import pytest
import torch

from tpuflow3d.params import PRESETS as REF_PRESETS
from tpuflow3d.utils import roofline as ref
from tpuflow3d_torch import PRESETS, FlowParams
from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import median3 as k3
from tpuflow3d_torch.kernels import sor as k1
from tpuflow3d_torch.kernels import sor_gc as k6
from tpuflow3d_torch.kernels import sor_gc_packed as k7
from tpuflow3d_torch.kernels import sor_packed as k4
from tpuflow3d_torch.kernels import warp_grad as k25
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.solver import compute_terms
from tpuflow3d_torch.utils import roofline
from tpuflow3d_torch.warp import warp_volume

torch.set_num_threads(2)

SHAPES = [(64, 64, 64), (100, 120, 90), (512, 512, 512)]
SPEC = (3.35e12, 67e12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("preset", sorted(REF_PRESETS))
def test_sweep_equivalents_are_the_references(preset, shape):
    rp, pp = REF_PRESETS[preset], PRESETS[preset]
    want = ref.pipeline_sweep_equivalents(rp.level_shapes(shape), rp)
    assert roofline.pipeline_sweep_equivalents(pp.level_shapes(shape),
                                               pp) == want


@pytest.mark.parametrize("bw, rate", [SPEC, (819e9, ref.VPU_FLOPS_F32),
                                      (2.0e12, 51e12)])
def test_expected_hw_fraction_is_the_references(bw, rate):
    for b in (8.0, 24.0, 36.0, 56.0, 112.0):
        for f in (0.0, 10.0, 43.0, 265.0, 3000.0, 1e5):
            assert roofline.expected_hw_fraction(
                b, f, bw=bw, flops_rate=rate) == ref.expected_hw_fraction(
                b, f, bw=bw, vpu=rate), (b, f)


@pytest.mark.parametrize("terms_bytes, want", [(4, 36.0), (2, 30.0)])
def test_packed_byte_model_is_the_references(terms_bytes, want):
    m = roofline.SweepByteModel(packed=True, terms_bytes=terms_bytes)
    r = ref.SweepByteModel(packed=True, terms_bytes=terms_bytes)
    assert m.per_half_sweep == r.per_half_sweep == want
    assert m.per_sweep == r.per_sweep == 2 * want


def test_flat_byte_model_departs_from_the_references():
    """The documented departure: the reference's flat Pallas kernel reads
    everything on each colour (56 B a half-sweep, 112 a sweep); the port's
    fused launch reads it once a sweep (56 B), and one colour alone needs
    42."""
    m, r = roofline.SweepByteModel(packed=False), ref.SweepByteModel(
        packed=False)
    assert (r.per_half_sweep, r.per_sweep) == (56, 112)
    assert (m.per_half_sweep, m.per_sweep) == (42, 56)
    assert m.per_sweep == r.per_sweep / 2
    gc = roofline.SweepByteModel(packed=False, gc=True)
    assert (gc.per_half_sweep, gc.per_sweep) == (46, 64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("preset", [k for k, p in sorted(REF_PRESETS.items())
                                    if p.solver == "sor"])
def test_packed_end_to_end_roofline_is_the_references(preset, shape):
    rp = REF_PRESETS[preset]
    pp = from_reference(rp)
    assert rp.sweep_layout == pp.sweep_layout == "packed"
    shapes = pp.level_shapes(shape)
    assert roofline.end_to_end_roofline(shapes, pp, bw=SPEC[0]) == \
        ref.end_to_end_roofline(rp.level_shapes(shape), rp, bw=SPEC[0])


def test_end_to_end_roofline_follows_the_kernel():
    """The byte model of the kernel the params run: the fused flat sweep
    (56 B), bfloat16 terms (44), gamma > 0 (K6 64, K7 2 x 40); the
    ladder256 prediction of PERF.md (205.7 fine sweeps, 57.7 ms at the data
    sheet's rate); no bound for multigrid or Jacobi."""
    p = PRESETS["ladder256"]
    shapes = p.level_shapes((256,) * 3)
    eq = roofline.pipeline_sweep_equivalents(shapes, p)
    assert math.isclose(eq, 1.1428 * 180, rel_tol=1e-4)
    for changes, per_sweep in (({}, 56), ({"terms_dtype": "bfloat16"}, 44),
                               ({"gamma": 1.0}, 64),
                               ({"sweep_layout": "packed"}, 72),
                               ({"sweep_layout": "packed", "gamma": 1.0}, 80)):
        q = p.replace(**changes)
        assert roofline.sweep_byte_model(q).per_sweep == per_sweep
        assert roofline.end_to_end_roofline(shapes, q, bw=SPEC[0]) == \
            SPEC[0] / per_sweep / eq
    seconds = 256 ** 3 / roofline.end_to_end_roofline(shapes, p, bw=SPEC[0])
    assert math.isclose(seconds, 0.0577, rel_tol=1e-3)
    for q in (PRESETS["accurate"], p.replace(solver="jacobi")):
        with pytest.raises(ValueError, match=q.solver):
            roofline.end_to_end_roofline(shapes, q, bw=SPEC[0])


@pytest.mark.parametrize("interp, want", [("trilinear", 40.0),
                                          ("tricubic", 265.0)])
def test_warp_flops_do_not_grow_with_the_clamp(interp, want):
    got = {roofline.warp_flops_per_voxel(c, interp)
           for c in (0.0, 0.5, 1.0, 2.0, 4.0, 7.5)}
    assert got == {want}
    # The reference's select window grows as (2 ceil(clamp) + k)^3.
    assert ref.warp_flops_per_voxel(4.0, interp) > \
        ref.warp_flops_per_voxel(1.0, interp)


def test_unknown_card_raises_naming_it(monkeypatch):
    with pytest.raises(KeyError, match="NVIDIA A100-SXM4-80GB"):
        roofline.card_rates("NVIDIA A100-SXM4-80GB")
    assert roofline.card_rates("NVIDIA H100 80GB HBM3") == SPEC
    assert roofline.device_hbm_bw("cpu") == roofline.HBM_BW["cpu"]
    # No device named and no GPU: raise, never fall back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (roofline.device_hbm_bw, roofline.peak_rates,
               roofline.measure_hbm_bw, roofline.minmax_rate):
        with pytest.raises(RuntimeError, match="is_available"):
            fn()


def test_measure_hbm_bw_on_the_cpu_is_positive_and_cached():
    nbytes = 1 << 20
    bw = roofline.measure_hbm_bw(nbytes=nbytes, device="cpu")
    assert math.isfinite(bw) and bw > 0
    probe = roofline.probe_timing_model(nbytes, "cpu")
    assert probe is roofline.probe_timing_model(nbytes, torch.device("cpu"))
    assert probe.bytes_per_s == bw and probe.device == "cpu"
    assert probe.t16_ms > 0 and probe.copy_bytes_per_s > 0
    assert roofline.measure_hbm_bw(nbytes=nbytes, device="cpu") == bw


def test_check_probe_rejects_a_probe_that_did_not_time_the_work():
    good = roofline.Probe(3.0e12, 16.0, 0.7, 11.2, 2.9e12, 1 << 30,
                          "NVIDIA H100 80GB HBM3")
    assert roofline.check_probe(good) is None
    assert "t16/t1" in roofline.check_probe(good._replace(ratio=1.1))
    assert "data sheet" in roofline.check_probe(
        good._replace(bytes_per_s=4.0e12))


def test_minmax_probe_plain_is_the_network():
    """The plain probe's values: each thread's 16 values sorted by the
    network (a permutation of them), summed in order."""
    out = roofline.minmax_probe(torch.empty(2 * 256), iters=9)
    v = (np.arange(256)[:, None] * 16 + np.arange(16)).astype(np.float32) \
        * np.float32(1e-3)
    s = np.zeros(256, np.float32)
    for k in range(16):
        s = s + np.sort(v, axis=1)[:, k]
    np.testing.assert_array_equal(out.numpy(), np.tile(s, 2))
    assert roofline.minmax_rate("cpu") > 0


# --- the byte model against the tensors the wrappers move ---------------

N = 32


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i0 = f32(rng.normal(size=(N,) * 3))
    shift = torch.zeros((3, N, N, N))
    shift[2] = 0.7
    i1 = warp_volume(i0, -shift)
    flow = f32(rng.normal(size=(3, N, N, N)) * 0.1)
    du = f32(rng.normal(size=(3, N, N, N)) * 0.05)
    g, it = derivatives(i0, i1)
    gc = grad_constancy_terms(i0, i1, g=g)
    return i0, i1, flow, du, g, it, gc


def _terms(fields, terms_dtype, gamma):
    i0, i1, flow, du, g, it, gc = fields
    p = FlowParams(alpha=0.05, gamma=gamma, terms_dtype=terms_dtype)
    return du, p, compute_terms(g, it, flow, du, p, HaloCtx(),
                                gc=gc if gamma else None)


@pytest.mark.parametrize("gamma", [0.0, 1.0], ids=["K1", "K6"])
@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
def test_flat_model_is_the_wrappers_bytes(fields, terms_dtype, gamma):
    du, p, t = _terms(fields, terms_dtype, gamma)
    # What launch_flat hands the kernel besides du and psi_s.
    if gamma:
        out = k6.sor_gc_sweeps(du, t, (p.alpha,) * 3, p.omega, 1)
        per_colour = (t.c, t.ainv)
    else:
        out = k1.sor_sweeps(du, t, p.alpha, p.omega, 1)
        per_colour = (t.c, t.g, t.psi_d)
    m = roofline.SweepByteModel(packed=False,
                                terms_bytes=t.c.element_size(),
                                gc=bool(gamma))
    vox = N ** 3
    assert _nbytes(du, t.psi_s, *per_colour, out) / vox == m.per_sweep
    # One colour: du, the result and psi_s whole, the rest for the colour.
    assert (_nbytes(du, out, t.psi_s) + _nbytes(*per_colour) / 2) / vox \
        == m.per_half_sweep
    # A slab's single-colour launch also reads du's and psi_s's halo planes.
    ctx = HaloCtx()
    assert _nbytes(*ctx.z_halo_planes(du), *ctx.z_halo_planes(t.psi_s)) \
        / vox == m.halo_plane_bytes(N)


@pytest.mark.parametrize("gamma", [0.0, 1.0], ids=["K4", "K7"])
@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
def test_packed_model_is_the_wrappers_bytes(fields, terms_dtype, gamma):
    du, p, t = _terms(fields, terms_dtype, gamma)
    ctx, color = HaloCtx(), 0
    pk = lambda a, c: k4.pack_color(a, c, 0)
    duo, pso = pk(du, 1 - color), pk(t.psi_s, 1 - color)
    mid, tail = ((t.c, t.ainv), ()) if gamma else ((t.c, t.g), (t.psi_d,))
    head = (pk(du, color), duo, *(pk(a, color) for a in mid),
            pk(t.psi_s, color), pso, *(pk(a, color) for a in tail))
    planes = (*ctx.z_halo_planes(duo), *ctx.z_halo_planes(pso))
    scalars = (0, p.alpha, p.omega, color, N)
    fn = k7.sor_halfsweep_gc_packed if gamma else k4.sor_halfsweep_packed
    m = roofline.SweepByteModel(packed=True, terms_bytes=t.c.element_size(),
                                gc=bool(gamma))
    vox = N ** 3
    for args, want in (((*head, *(None,) * 4, *scalars), m.per_half_sweep),
                       ((*head, *planes, *scalars),
                        m.per_half_sweep + m.halo_plane_bytes(N))):
        out = fn(*args)
        assert _nbytes(*args, out) / vox == want


@pytest.mark.parametrize("emit", [False, True], ids=["", "i1w"])
@pytest.mark.parametrize("interp", ["trilinear", "tricubic"],
                         ids=["K2", "K5"])
def test_warp_model_is_the_wrappers_bytes(fields, interp, emit):
    i0, i1, flow = fields[:3]
    out = k25.warp_grad(i1, flow, i0, HaloCtx(), interp=interp,
                        emit_warped=emit)
    assert len(out) == (3 if emit else 2)
    assert _nbytes(i1, flow, i0, *out) / N ** 3 == \
        roofline.WARP_BYTES_PER_VOXEL[emit]


def test_median_model_is_the_wrappers_bytes(fields):
    x = fields[3]
    assert _nbytes(x, k3.median3(x)) / N ** 3 == \
        roofline.MEDIAN3_BYTES_PER_VOXEL
