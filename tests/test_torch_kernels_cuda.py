"""The CUDA kernels (K1 SOR sweeps, single-colour and fused red+black,
K2/K5 fused trilinear/tricubic warp + derivatives, K3 median, K6
general-SPD SOR sweeps with the one-block form of the small multigrid
levels, K4 and K7 the colour-packed half-sweeps, the bfloat16-terms
instantiations of the four sweep kernels, K8 the rank-1 nonlinearity
update and K9 that of the general system) against their plain PyTorch
versions, on the card, and
compute_flow through the kernels against plain on the ladder, ``accurate``,
gamma, packed, bfloat16 and order-4 paths. The streamed mode's window forms:
K2/K5 and single-colour K1/K6 on window slabs (z0 below, at and inside the
volume) bitwise against their plain window versions, K2/K5 on a window that
is the whole volume bitwise the one-device launch, K4/K7 with null halo
planes bitwise the call with copied ones, and compute_flow_piecewise
through the kernels bitwise its plain run. The probes of utils/roofline.py
(csrc/probe.cu): the copy bitwise its source, the min/max loop bitwise its
plain network, and the bandwidth probe's own checks on this card.

Marked ``cuda``: every test skips when torch.cuda.is_available() is false.
The machine with the card has no JAX, and tests/conftest.py imports it,
so run these there without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tpuflow3d_torch import PRESETS, FlowParams, compute_flow, kernels
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels.median3 import median3 as k_median3
from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor, sor_sweeps
from tpuflow3d_torch.kernels.sor_gc import (sor_gc_sweeps,
                                            sor_halfsweep_gc as k_sor_gc)
from tpuflow3d_torch.kernels import sor_gc_packed as k7
from tpuflow3d_torch.kernels import sor_packed as k4
from tpuflow3d_torch.kernels.warp_grad import warp_grad as k_warp_grad
from tpuflow3d_torch.median import median3
from tpuflow3d_torch.mgsolver import _weights, build_mg_levels
from tpuflow3d_torch.solver import compute_terms, parity_mask, sor_halfsweep
from tpuflow3d_torch.utils import roofline
from tpuflow3d_torch.warp import warp_volume
from torch_inputs import make_flow, median_input

pytestmark = pytest.mark.cuda

ALPHA, OMEGA = 0.05, 1.9
SHAPES = [(12, 10, 14), (7, 9, 11), (13, 64, 64), (16, 33, 70)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _terms(shape, dev, seed=0, gamma=0.0, terms_dtype="float32",
           ctx=HaloCtx()):
    rng = np.random.default_rng(seed)
    i0 = _t(rng.normal(size=shape), dev)
    shift = torch.zeros((3, *shape), device=dev)
    shift[2] = 0.7
    i1 = warp_volume(i0, -shift)
    g, it = derivatives(i0, i1, ctx)
    gc = grad_constancy_terms(i0, i1, ctx, g=g) if gamma > 0 else None
    flow = _t(rng.normal(size=(3, *shape)) * 0.1, dev)
    du = _t(rng.normal(size=(3, *shape)) * 0.05, dev)
    # The plain terms: the plain sweeps these tests compare with read the
    # weights, which K8's route leaves out.
    return du, compute_terms(g, it, flow, du,
                             FlowParams(alpha=ALPHA, gamma=gamma,
                                        terms_dtype=terms_dtype,
                                        backend="plain"), ctx, gc=gc)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_sor_halfsweep_matches_plain(dev, shape, color):
    du, t = _terms(shape, dev)
    parity = parity_mask(shape, HaloCtx(), dev)
    ref = sor_halfsweep(du, t, OMEGA, parity, color)
    got = k_sor(du, t, ALPHA, OMEGA, color)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


def test_sor_sweep_sequence_matches_plain(dev):
    shape = (12, 10, 14)
    du, t = _terms(shape, dev, seed=1)
    parity = parity_mask(shape, HaloCtx(), dev)
    ref = got = du
    for _ in range(5):
        for color in (0, 1):
            ref = sor_halfsweep(ref, t, OMEGA, parity, color)
            got = k_sor(got, t, ALPHA, OMEGA, color)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_sor_gc_halfsweep_matches_plain(dev, shape, color):
    du, t = _terms(shape, dev, gamma=1.5)
    parity = parity_mask(shape, HaloCtx(), dev)
    ref = sor_halfsweep(du, t, OMEGA, parity, color)
    got = k_sor_gc(du, t, (ALPHA,) * 3, OMEGA, color)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


def test_sor_gc_every_multigrid_level_matches_plain(dev):
    """K6 with each level's per-axis alphas (anisotropic: 16 x 33 x 70
    halves to odd, unequal dims) against the plain sweep on that level's
    weights."""
    du, t = _terms((16, 33, 70), dev)
    p = FlowParams(alpha=ALPHA, solver="multigrid")
    rng = np.random.default_rng(4)
    levels = build_mg_levels(t, p, HaloCtx())
    assert len({lvl.axis_alpha for lvl in levels}) > 1
    for lvl in levels:
        shp = (3, *lvl.shape_global)
        x = _t(rng.normal(size=shp) * 0.05, dev)
        lt = lvl.terms._replace(c=_t(rng.normal(size=shp), dev))
        for color in (0, 1):
            ref = sor_halfsweep(x, lt, 1.3, lvl.parity, color)
            got = k_sor_gc(x, lt, lvl.axis_alpha, 1.3, color)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("gamma", [0.0, 1.5], ids=["k1", "k6"])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_flat_sweeps_bf16_terms_match_plain(dev, shape, color, gamma):
    """The bfloat16 instantiations of K1 (c, g) and K6 (c) against the
    plain sweep on the same bfloat16 terms."""
    du, t = _terms(shape, dev, gamma=gamma, terms_dtype="bfloat16")
    assert t.c.dtype == t.g.dtype == torch.bfloat16
    parity = parity_mask(shape, HaloCtx(), dev)
    ref = sor_halfsweep(du, t, OMEGA, parity, color)
    got = (k_sor_gc(du, t, (ALPHA,) * 3, OMEGA, color) if gamma > 0.0
           else k_sor(du, t, ALPHA, OMEGA, color))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


# The fused and single-colour sweeps: SHAPES plus one plane (D = 1), an odd
# cube, W % 4 == 0 past one tile in y and x, and W % 4 != 0 past one tile.
SWEEP_SHAPES = SHAPES + [(1, 6, 10), (5, 5, 5), (3, 20, 136), (40, 18, 66)]


def _plain_sweeps(du, t, omega, n):
    parity = parity_mask(tuple(du.shape[1:]), HaloCtx(), du.device)
    for _ in range(n):
        for color in (0, 1):
            du = sor_halfsweep(du, t, omega, parity, color)
    return du


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.0, 1.5], ids=["k1", "k6"])
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_fused_and_single_colour_sweeps_bitwise(dev, shape, gamma,
                                                terms_dtype):
    """K1 and K6, float32 and bfloat16 terms: each colour alone, one fused
    sweep and three fused sweeps, bitwise equal to the plain half-sweeps
    (K6 runs the sweeps of a grid of at most 4096 voxels in one launch of
    one block)."""
    du, t = _terms(shape, dev, gamma=gamma, terms_dtype=terms_dtype)
    kept = du.clone()
    if gamma > 0.0:
        half = lambda x, c: k_sor_gc(x, t, (ALPHA,) * 3, OMEGA, c)
        sweeps = lambda x, n: sor_gc_sweeps(x, t, (ALPHA,) * 3, OMEGA, n)
        name = "sor_gc"
    else:
        half = lambda x, c: k_sor(x, t, ALPHA, OMEGA, c)
        sweeps = lambda x, n: sor_sweeps(x, t, ALPHA, OMEGA, n)
        name = "sor_halfsweep"
    parity = parity_mask(shape, HaloCtx(), dev)
    kernels.reset_launches()
    for color in (0, 1):
        assert torch.equal(half(du, color),
                           sor_halfsweep(du, t, OMEGA, parity, color))
    assert torch.equal(sweeps(du, 1), _plain_sweeps(du, t, OMEGA, 1))
    assert torch.equal(sweeps(du, 3), _plain_sweeps(du, t, OMEGA, 3))
    torch.cuda.synchronize()
    assert torch.equal(du, kept)  # out-of-place
    one_block = gamma > 0.0 and shape[0] * shape[1] * shape[2] <= 4096
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {
        name: 4 if one_block else 6}


def test_sweep_wrappers_fetch_no_halo_planes_on_one_device(dev, monkeypatch):
    du, t = _terms((6, 8, 8), dev, gamma=1.5)
    calls = []
    monkeypatch.setattr(HaloCtx, "z_halo_planes",
                        lambda self, x: calls.append(1))
    sor_sweeps(du, t, ALPHA, OMEGA, 2)
    k_sor(du, t, ALPHA, OMEGA, 1)
    sor_gc_sweeps(du, t, (ALPHA,) * 3, OMEGA, 2)
    k_sor_gc(du, t, (ALPHA,) * 3, OMEGA, 0)
    torch.cuda.synchronize()
    assert calls == []


def _slab_ctx(z_lo, dg, full_du, full_ps, calls):
    """A context for the slab that starts at global plane z_lo of a volume
    of dg planes: it has Z neighbours, and its halo planes are the
    neighbouring planes of the full arrays (edge replicas at the ends)."""
    class Slab(HaloCtx):
        has_z_neighbors = True

        def z0(self, d_local):
            return z_lo

        def d_global(self, d_local):
            return dg

        def z_halo_planes(self, x):
            calls.append(1)
            full = full_du if x.dim() == 4 else full_ps
            zl, zh = max(z_lo - 1, 0), min(z_lo + x.shape[-3], dg - 1)
            return (full.narrow(-3, zl, 1).contiguous(),
                    full.narrow(-3, zh, 1).contiguous())
    return Slab()


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.0, 1.5], ids=["k1", "k6"])
@pytest.mark.parametrize("shape", [(12, 10, 14), (7, 9, 12), (16, 33, 72)])
def test_single_colour_sweeps_on_slabs_with_halo_planes(dev, shape, gamma,
                                                        terms_dtype):
    """A slab with Z neighbours (z0 != 0, real halo planes, global depth)
    takes the single-colour kernel with planes: each colour against the
    slab of the plain half-sweep of the whole volume; sor_sweeps then makes
    two launches per sweep and fetches the planes before each."""
    du, t = _terms(shape, dev, gamma=gamma, terms_dtype=terms_dtype)
    d = shape[0]
    parity = parity_mask(shape, HaloCtx(), dev)
    cut = lambda a, lo, hi: (None if a is None
                             else a[..., lo:hi, :, :].contiguous())
    for lo, hi in ((1, d - 1), (0, d // 2), (d // 2, d), (d // 2, d // 2 + 1)):
        calls = []
        ctx = _slab_ctx(lo, d, du, t.psi_s, calls)
        ts = t._replace(c=cut(t.c, lo, hi), g=cut(t.g, lo, hi),
                        psi_s=cut(t.psi_s, lo, hi),
                        psi_d=cut(t.psi_d, lo, hi),
                        ainv=cut(t.ainv, lo, hi), w=None)
        for color in (0, 1):
            ref = sor_halfsweep(du, t, OMEGA, parity, color)
            got = (k_sor_gc(cut(du, lo, hi), ts, (ALPHA,) * 3, OMEGA, color,
                            ctx) if gamma > 0.0 else
                   k_sor(cut(du, lo, hi), ts, ALPHA, OMEGA, color, ctx))
            assert torch.equal(got, cut(ref, lo, hi)), (lo, hi, color)
        assert len(calls) == 4
    # The whole volume under a context that claims neighbours: the planes
    # are edge replicas that the face tests skip, so the bits are the
    # fused sweep's.
    calls = []
    ctx = _slab_ctx(0, d, du, t.psi_s, calls)
    kernels.reset_launches()
    got = (sor_gc_sweeps(du, t, (ALPHA,) * 3, OMEGA, 2, ctx) if gamma > 0.0
           else sor_sweeps(du, t, ALPHA, OMEGA, 2, ctx))
    assert torch.equal(got, _plain_sweeps(du, t, OMEGA, 2))
    assert sum(kernels.LAUNCHES.values()) == 4 and len(calls) == 8


def test_sor_gc_every_multigrid_level_of_64_cubed_bitwise(dev):
    """Every level shape of a 64^3 multigrid solve (64, 32, 16, 8, 4 cubed):
    n sweeps through sor_gc_sweeps (one fused launch per sweep; one launch
    of one block for a level of at most 4096 voxels), bitwise equal to the
    plain half-sweeps."""
    du, t = _terms((64, 64, 64), dev)
    p = FlowParams(alpha=ALPHA, solver="multigrid")
    rng = np.random.default_rng(6)
    levels = build_mg_levels(t, p, HaloCtx())
    assert [lvl.shape_global[0] for lvl in levels] == [64, 32, 16, 8, 4]
    for lvl in levels:
        shp = (3, *lvl.shape_global)
        x = _t(rng.normal(size=shp) * 0.05, dev)
        lt = lvl.terms._replace(c=_t(rng.normal(size=shp), dev))
        for n in (2, 16):
            ref = _plain_sweeps(x, lt, 1.3, n)
            kernels.reset_launches()
            assert torch.equal(sor_gc_sweeps(x, lt, lvl.axis_alpha, 1.3, n),
                               ref)
            small = lvl.shape_global[0] ** 3 <= 4096
            assert kernels.LAUNCHES["sor_gc"] == (1 if small else n)


@pytest.mark.parametrize("shape", [(4, 5, 7), (16, 16, 16), (3, 33, 40),
                                   (17, 16, 16)])
def test_sor_gc_sweeps_one_block_anisotropic_bitwise(dev, shape):
    """The one-block form up to its 4096-voxel limit (and the fused form one
    plane past it), with anisotropic alphas and bfloat16 right-hand side."""
    du, t = _terms(shape, dev, gamma=1.5, terms_dtype="bfloat16")
    alphas = (ALPHA, ALPHA * 0.25, ALPHA * 0.0625)
    lvl_w = _weights(t.psi_s, (1.0, 0.25, 0.0625), ALPHA, HaloCtx())[0]
    tt = t._replace(w=lvl_w)
    kernels.reset_launches()
    got = sor_gc_sweeps(du, tt, alphas, 1.3, 5)
    n_vox = shape[0] * shape[1] * shape[2]
    assert kernels.LAUNCHES["sor_gc"] == (1 if n_vox <= 4096 else 5)
    assert torch.equal(got, _plain_sweeps(du, tt, 1.3, 5))


# Packed shapes: even W, with odd D and H, a one-element row (W = 2) and
# sizes that end inside a thread block.
PACKED_SHAPES = [(12, 10, 14), (7, 9, 12), (13, 64, 64), (16, 33, 70),
                 (5, 3, 2)]


def _packed_args(du, t, color, lo_z, hi_z, gamma):
    """Arguments of a packed half-sweep of ``color`` on the slab
    [lo_z, hi_z) of the volume: the slab's packed arrays with the slab's
    z0, and the other colour's halo planes taken from the neighbouring
    planes of the full packed arrays (edge replicas at the volume's ends,
    as HaloCtx.z_halo_planes gives them)."""
    d = du.shape[1]
    full = lambda a, c: k4.pack_color(a, c, 0)
    slab = lambda a, c: k4.pack_color(a[..., lo_z:hi_z, :, :].contiguous(),
                                      c, lo_z)
    other = 1 - color
    duo, pso = full(du, other), full(t.psi_s, other)
    zl, zh = max(lo_z - 1, 0), min(hi_z, d - 1)
    halos = (duo[:, zl:zl + 1].contiguous(), duo[:, zh:zh + 1].contiguous(),
             pso[zl:zl + 1].contiguous(), pso[zh:zh + 1].contiguous())
    mid = ((slab(t.c, color), slab(t.ainv, color)) if gamma > 0.0
           else (slab(t.c, color), slab(t.g, color)))
    tail = () if gamma > 0.0 else (slab(t.psi_d, color),)
    return (slab(du, color), slab(du, other), *mid, slab(t.psi_s, color),
            slab(t.psi_s, other), *tail, *halos, lo_z, ALPHA, OMEGA, color, d)


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.0, 1.5], ids=["k4", "k7"])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_halfsweep_matches_plain(dev, shape, color, gamma,
                                        terms_dtype):
    """K4 and K7, float32 and bfloat16 terms, on the whole volume and on
    an inner slab (z0 != 0, real halo planes, global depth): against
    their plain packed versions, and the whole-volume result against the
    flat plain sweep."""
    du, t = _terms(shape, dev, gamma=gamma, terms_dtype=terms_dtype)
    kern, plain = ((k7.sor_halfsweep_gc_packed,
                    k7.sor_halfsweep_gc_packed_plain) if gamma > 0.0 else
                   (k4.sor_halfsweep_packed, k4.sor_halfsweep_packed_plain))
    d = shape[0]
    kernels.reset_launches()
    for lo_z, hi_z in ((0, d), (1, d - 1), (d // 2, d // 2 + 1)):
        args = _packed_args(du, t, color, lo_z, hi_z, gamma)
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (3, hi_z - lo_z, shape[1],
                                          shape[2] // 2)
        torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)
        if (lo_z, hi_z) == (0, d):
            parity = parity_mask(shape, HaloCtx(), dev)
            flat = sor_halfsweep(du, t, OMEGA, parity, color)
            torch.testing.assert_close(got, k4.pack_color(flat, color, 0),
                                       atol=5e-5, rtol=1e-5)
    name = "sor_gc_packed" if gamma > 0.0 else "sor_packed"
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {name: 3}


def test_packed_kernels_reject_bad_inputs(dev):
    du, t = _terms((6, 8, 8), dev)
    args = list(_packed_args(du, t, 0, 0, 6, 0.0))
    with pytest.raises(TypeError, match="float32 or"):
        k4.sor_halfsweep_packed(*args[:2], args[2].half(), *args[3:])
    with pytest.raises(TypeError, match="bfloat16"):  # g must match c
        k4.sor_halfsweep_packed(*args[:2], args[2].bfloat16(), *args[3:])
    with pytest.raises(ValueError, match="shape"):
        k4.sor_halfsweep_packed(args[0], args[1][:, :5].contiguous(),
                                *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        k4.sor_halfsweep_packed(args[0], du[..., ::2], *args[2:])


# Warp shapes: SHAPES (ragged against the 16 x 32 column tile) and two past
# one 32-plane chunk in z.
WARP_SHAPES = SHAPES + [(40, 18, 66), (70, 20, 33)]


def _check_warp(dev, shape, flow_kind, interp, emit_warped, seed):
    """The kernel against plain (atol 1e-5) and bitwise against the same
    inputs on the device-memory branch; which slabs took which branch."""
    rng = np.random.default_rng(seed)
    i0 = _t(rng.normal(size=shape), dev)
    i1 = _t(rng.normal(size=shape), dev)
    flow = _t(make_flow(flow_kind, shape, rng), dev)
    i1w = warp_volume(i1, flow, interp=interp)
    ref = (*derivatives(i0, i1w), i1w)
    tiles, tiles_dev = (torch.zeros(2, dtype=torch.int32, device=dev)
                        for _ in range(2))
    kernels.reset_launches()
    got = k_warp_grad(i1, flow, i0, interp=interp, emit_warped=emit_warped,
                      tile_counts=tiles)
    dev_only = k_warp_grad(i1, flow, i0, interp=interp,
                           emit_warped=emit_warped, staged=False,
                           tile_counts=tiles_dev)
    torch.cuda.synchronize()
    name = "warp_grad_tricubic" if interp == "tricubic" else "warp_grad"
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {name: 2}
    assert len(got) == len(dev_only) == (3 if emit_warped else 2)
    for a, b, c in zip(got, ref, dev_only):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        assert torch.equal(a, c)
    staged, gathered = tiles.tolist()
    assert staged + gathered > 0 and tiles_dev.tolist() == [0, staged + gathered]
    if interp == "trilinear":  # no box: every slab gathers from memory
        assert staged == 0
    elif flow_kind == "smooth2":  # every box of a flow within +-1.9 fits
        assert gathered == 0
    elif flow_kind == "outlier" and np.prod(shape) > 8448:
        # A volume larger than the box budget: the outlier's slabs gather
        # from device memory, the others from their boxes.
        assert staged > 0 and gathered > 0
    return staged, gathered


@pytest.mark.parametrize("emit_warped", [False, True])
@pytest.mark.parametrize("max_disp", [2.0, 6.0, "smooth2", "outlier"])
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_grad_tricubic_matches_plain(dev, shape, max_disp, emit_warped):
    _check_warp(dev, shape, max_disp, "tricubic", emit_warped, seed=5)


@pytest.mark.parametrize("emit_warped", [False, True])
@pytest.mark.parametrize("max_disp", [2.0, 6.0, "smooth2", "outlier"])
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_grad_matches_plain(dev, shape, max_disp, emit_warped):
    _check_warp(dev, shape, max_disp, "trilinear", emit_warped, seed=2)


def test_warp_grad_tricubic_reaches_both_branches_on_rough_flows(dev):
    """Random +-6 displacements on a volume past one chunk: some slabs'
    boxes fit and some do not."""
    staged, gathered = _check_warp(dev, (40, 40, 70), 6.0, "tricubic",
                                   False, seed=7)
    assert staged > 0 and gathered > 0


# Median shapes: W in {1, 2, 3, 5}, H = 1, D = 1, ragged against the 16 x 32
# column tile, and past one 32-plane chunk.
MEDIAN_SHAPES = SHAPES + [(5, 7, 1), (4, 6, 2), (3, 5, 3), (6, 4, 5),
                          (9, 1, 12), (1, 10, 13), (1, 1, 1), (40, 18, 66),
                          (70, 20, 33)]


@pytest.mark.parametrize("kind", ["normal", "ties", "const", "zeros"])
@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
def test_median3_bitwise(dev, shape, kind):
    x = _t(median_input(kind, shape, np.random.default_rng(3)), dev)
    kernels.reset_launches()
    assert torch.equal(k_median3(x), median3(x))
    assert kernels.LAUNCHES["median3"] == 1


@pytest.mark.parametrize("shape", [(12, 10, 14), (40, 18, 66)])
def test_median3_on_slabs_with_halo_planes(dev, shape):
    """A slab with Z neighbours takes its halo planes (the neighbouring
    planes of the whole field): each slab is the slab of the whole field's
    median, and the planes are fetched once a call."""
    x = _t(np.random.default_rng(4).normal(size=(3, *shape)), dev)
    ref = median3(x)
    d = shape[0]
    for lo, hi in ((1, d - 1), (0, d // 2), (d // 2, d), (d // 2, d // 2 + 1)):
        calls = []
        ctx = _slab_ctx(lo, d, x, None, calls)
        got = k_median3(x[:, lo:hi].contiguous(), ctx)
        assert torch.equal(got, ref[:, lo:hi]), (lo, hi)
        assert len(calls) == 1


def test_median3_fetches_no_halo_planes_on_one_device(dev, monkeypatch):
    x = _t(np.random.default_rng(5).normal(size=(3, 6, 8, 8)), dev)
    calls = []
    monkeypatch.setattr(HaloCtx, "z_halo_planes",
                        lambda self, x: calls.append(1))
    k_median3(x)
    torch.cuda.synchronize()
    assert calls == []


def test_kernels_reject_bad_inputs(dev):
    du, t = _terms((6, 8, 8), dev)
    with pytest.raises(TypeError, match="float32"):
        k_median3(du.double())
    with pytest.raises(ValueError, match="contiguous"):
        k_warp_grad(du[0].transpose(1, 2), du, du[1])
    with pytest.raises(ValueError, match="on "):
        k_warp_grad(du[0], du, du[1].cpu())
    # The sweep wrappers: K1 (no ainv needed) and K6.
    al3 = (ALPHA,) * 3
    for call in (lambda x, tt: sor_sweeps(x, tt, ALPHA, OMEGA, 2),
                 lambda x, tt: k_sor(x, tt, ALPHA, OMEGA, 0)):
        with pytest.raises(TypeError, match="float32 or"):
            call(du, t._replace(c=t.c.half()))
        with pytest.raises(TypeError, match="bfloat16"):  # g must match c
            call(du, t._replace(c=t.c.bfloat16()))
        with pytest.raises(ValueError, match="shape"):
            call(du, t._replace(psi_d=t.psi_d[:5].contiguous()))
        with pytest.raises(ValueError, match="contiguous"):
            call(du.transpose(2, 3), t)
        with pytest.raises(ValueError, match="on "):
            call(du, t._replace(psi_s=t.psi_s.cpu()))
    with pytest.raises(ValueError, match="no ainv"):
        sor_gc_sweeps(du, t, al3, OMEGA, 1)
    with pytest.raises(ValueError, match="color 2"):
        k_sor(du, t, ALPHA, OMEGA, 2)
    _, tg = _terms((6, 8, 8), dev, gamma=1.5)
    for call in (lambda x, tt: sor_gc_sweeps(x, tt, al3, OMEGA, 2),
                 lambda x, tt: k_sor_gc(x, tt, al3, OMEGA, 1)):
        with pytest.raises(ValueError, match="shape"):
            call(du, tg._replace(ainv=tg.ainv[:5].contiguous()))
        with pytest.raises(TypeError, match="float32"):
            call(du.double(), tg)
    with pytest.raises(ValueError, match="n = -1"):
        sor_gc_sweeps(du, tg, al3, OMEGA, -1)
    # A grid past the kernels' limits (D on the launch grid).
    tall = torch.zeros((3, 65536, 1, 2), device=dev)
    with pytest.raises(ValueError, match="past the kernels' limits"):
        sor_sweeps(tall, t, ALPHA, OMEGA, 1)
    with pytest.raises(ValueError, match="color 3"):
        k_sor_gc(du, tg, al3, OMEGA, 3)


TERMS_SHAPES = [(1, 1, 1), (2, 3, 5), (17, 9, 33), (5, 37, 70),
                (40, 19, 33), (64, 64, 64)]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("penalizer", ["charbonnier", "quadratic"])
@pytest.mark.parametrize("du_zero", [True, False])
@pytest.mark.parametrize("shape", TERMS_SHAPES)
def test_terms_kernel_is_bitwise_its_plain_version(dev, shape, du_zero,
                                                   penalizer):
    from tpuflow3d_torch.kernels.terms import terms_rank1
    from tpuflow3d_torch.solver import rank1_terms
    rng = np.random.default_rng(sum(shape))
    g = _t(rng.normal(size=(3, *shape)) * 0.1, dev)
    it = _t(rng.normal(size=shape) * 0.05, dev)
    flow = _t(rng.normal(size=(3, *shape)) * 0.5, dev)
    du = (torch.zeros_like(flow) if du_zero
          else _t(rng.normal(size=(3, *shape)) * 0.05, dev))
    p = FlowParams(alpha=ALPHA, penalizer_data=penalizer,
                   penalizer_smooth=penalizer)
    kernels.reset_launches()
    got = terms_rank1(g, it, flow, du, p)
    ref = rank1_terms(g, it, flow, du, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["terms"] == 1
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


def test_terms_kernel_refuses_what_it_does_not_take(dev):
    from tpuflow3d_torch.kernels.terms import terms_rank1
    shape = (6, 8, 8)
    g = torch.zeros((3, *shape), device=dev)
    it = torch.zeros(shape, device=dev)
    p = FlowParams()
    with pytest.raises(ValueError, match="whole volume"):
        terms_rank1(g, it, g, g, p, HaloCtx(window_z0=0, window_d_global=6))
    with pytest.raises(ValueError, match="not contiguous"):
        terms_rank1(g.transpose(2, 3), it, g, g, p)
    with pytest.raises(TypeError, match="float32"):
        terms_rank1(g.double(), it, g, g, p)


def test_compute_terms_takes_the_kernel_on_a_whole_volume(dev):
    """On the card compute_terms makes (c, psi_s, psi_d) with K8 on a whole
    volume (no weights kept), bitwise the plain route's, and stays plain
    under a window."""
    g, it = (_t(np.random.default_rng(2).normal(size=s), dev)
             for s in ((3, 9, 20, 24), (9, 20, 24)))
    flow, du = g * 3.0, g * 0.25
    p = FlowParams(alpha=ALPHA)
    kernels.reset_launches()
    t = compute_terms(g, it, flow, du, p)
    ref = compute_terms(g, it, flow, du, p.replace(backend="plain"))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["terms"] == 1
    assert t.w is None and t.sw_inv is None and t.smt is None
    assert ref.w is not None
    for f in ("c", "g", "psi_s", "psi_d"):
        assert torch.equal(_bits(getattr(t, f)), _bits(getattr(ref, f)))
    window = compute_terms(g, it, flow, du, p,
                           HaloCtx(window_z0=0, window_d_global=9))
    assert window.w is not None and kernels.LAUNCHES["terms"] == 1


def _gc_fields(shape, dev, seed, du_zero=False):
    """Random inputs of K9: g, it, flow, du, gc_g, gc_it."""
    rng = np.random.default_rng(seed)
    g = _t(rng.normal(size=(3, *shape)) * 0.1, dev)
    it = _t(rng.normal(size=shape) * 0.05, dev)
    flow = _t(rng.normal(size=(3, *shape)) * 0.5, dev)
    du = (torch.zeros_like(flow) if du_zero
          else _t(rng.normal(size=(3, *shape)) * 0.05, dev))
    gc_g = _t(rng.normal(size=(3, 3, *shape)) * 0.1, dev)
    gc_it = _t(rng.normal(size=(3, *shape)) * 0.05, dev)
    return g, it, flow, du, gc_g, gc_it


# K9's shapes: K8's but the volume of one voxel. There ATen's sum over the
# three components of a (3, 1, 1, 1) tensor adds (x0 + x2) + x1, and on any
# larger volume (x0 + x1) + x2 (200 random draws each on the H100), the
# order the kernel repeats; the plain version's ainv then differs in its
# last bit.
TERMS_GC_SHAPES = [s for s in TERMS_SHAPES if s != (1, 1, 1)]


@pytest.mark.parametrize("penalizer", ["charbonnier", "quadratic"])
@pytest.mark.parametrize("du_zero", [True, False])
@pytest.mark.parametrize("shape", TERMS_GC_SHAPES)
def test_terms_gc_kernel_is_bitwise_its_plain_version(dev, shape, du_zero,
                                                      penalizer):
    from tpuflow3d_torch.kernels.terms import terms_general
    from tpuflow3d_torch.solver import general_terms
    fields = _gc_fields(shape, dev, sum(shape), du_zero)
    p = FlowParams(alpha=ALPHA, gamma=1.5, penalizer_data=penalizer,
                   penalizer_smooth=penalizer, penalizer_grad=penalizer)
    kernels.reset_launches()
    got = terms_general(*fields, p)
    ref = general_terms(*fields, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["terms_gc"] == 1
    assert kernels.LAUNCHES["terms"] == 0
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


def test_terms_gc_kernel_refuses_what_it_does_not_take(dev):
    from tpuflow3d_torch.kernels.terms import terms_general
    g, it, flow, du, gc_g, gc_it = _gc_fields((6, 8, 8), dev, 0)
    p = FlowParams(gamma=1.0)
    with pytest.raises(ValueError, match="whole volume"):
        terms_general(g, it, flow, du, gc_g, gc_it, p,
                      HaloCtx(window_z0=0, window_d_global=6))
    with pytest.raises(ValueError, match="gc_g: shape"):
        terms_general(g, it, flow, du, gc_g[0], gc_it, p)
    with pytest.raises(TypeError, match="float32"):
        terms_general(g, it, flow, du, gc_g.double(), gc_it, p)


def test_compute_terms_takes_the_gc_kernel_on_a_whole_volume(dev):
    """With gamma > 0 and SOR compute_terms makes (c, psi_s, ainv) with
    K9 on a whole volume (no weights, psi_d or d6 kept), bitwise the plain
    route's; multigrid and a window stay plain."""
    g, it, flow, du, gc_g, gc_it = _gc_fields((9, 20, 24), dev, 2)
    p = FlowParams(alpha=ALPHA, gamma=1.0)
    kernels.reset_launches()
    t = compute_terms(g, it, flow, du, p, gc=(gc_g, gc_it))
    ref = compute_terms(g, it, flow, du, p.replace(backend="plain"),
                        gc=(gc_g, gc_it))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["terms_gc"] == 1
    assert t.w is None and t.psi_d is None and t.d6 is None
    for f in ("c", "g", "psi_s", "ainv"):
        assert torch.equal(_bits(getattr(t, f)), _bits(getattr(ref, f)))
    for q, ctx in ((p.replace(solver="multigrid"), HaloCtx()),
                   (p, HaloCtx(window_z0=0, window_d_global=9))):
        plain = compute_terms(g, it, flow, du, q, ctx, gc=(gc_g, gc_it))
        assert plain.w is not None and plain.d6 is not None
    assert kernels.LAUNCHES["terms_gc"] == 1


# name -> (params at 32^3, the kernels its path must launch); every other
# counter must stay at 0.
PATHS = {
    "ladder": (FlowParams(levels=2, warps=3, inner_iterations=3, sweeps=20),
               {"sor_halfsweep", "warp_grad", "median3", "terms"}),
    "accurate": (PRESETS["accurate"].replace(levels=2, warps=3),
                 {"warp_grad_tricubic", "sor_gc", "median3", "terms",
                  "mg_restrict", "mg_prolong"}),
    "accurate_gamma": (PRESETS["accurate"].replace(levels=2, warps=3,
                                                   gamma=1.0),
                       {"warp_grad_tricubic", "sor_gc", "median3",
                        "mg_restrict", "mg_prolong"}),
    "gamma": (FlowParams(levels=2, warps=3, inner_iterations=3, sweeps=20,
                         gamma=1.0),
              {"warp_grad", "sor_gc", "median3", "terms_gc"}),
    "packed": (FlowParams(levels=2, warps=3, inner_iterations=3, sweeps=20,
                          sweep_layout="packed"),
               {"sor_packed", "warp_grad", "median3", "terms"}),
    "packed_early_stop": (FlowParams(levels=2, warps=3, inner_iterations=3,
                                     sweeps=20, sweep_layout="packed",
                                     residual_tol=1e-4),
                          {"sor_packed", "warp_grad", "median3", "terms"}),
    "packed_gamma_bf16": (FlowParams(levels=2, warps=3, inner_iterations=3,
                                     sweeps=20, sweep_layout="packed",
                                     gamma=1.0, terms_dtype="bfloat16"),
                          {"sor_gc_packed", "warp_grad", "median3",
                           "terms_gc"}),
    "ladder_bf16": (FlowParams(levels=2, warps=3, inner_iterations=3,
                               sweeps=20, terms_dtype="bfloat16"),
                    {"sor_halfsweep", "warp_grad", "median3", "terms"}),
    "accurate_bf16": (PRESETS["accurate-bf16"].replace(levels=2, warps=3),
                      {"warp_grad_tricubic", "sor_gc", "median3", "terms",
                       "mg_restrict", "mg_prolong"}),
    # Order 4 warps and differentiates in plain PyTorch (the fused kernels
    # compute 2-point derivatives); the sweeps and the median run kernels.
    "order4": (FlowParams(levels=2, warps=3, inner_iterations=3, sweeps=20,
                          deriv_order=4),
               {"sor_halfsweep", "median3", "terms"}),
}


@pytest.mark.parametrize("name", list(PATHS))
def test_compute_flow_kernels_match_plain_and_launch(dev, name):
    p, launched = PATHS[name]
    shape = (32, 32, 32)
    i0, i1, true = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)))
    kernels.reset_launches()
    got = compute_flow(i0, i1, p, device=dev)
    assert {k for k, n in kernels.LAUNCHES.items() if n > 0} == launched, \
        kernels.LAUNCHES
    ref = compute_flow(i0, i1, p.replace(backend="plain"), device=dev)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-3)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(shape, 4)
    assert syn.epe(got.cpu().numpy(), true, mask) < 0.05


def test_packed_odd_width_sweeps_flat(dev):
    """A volume of odd W (29 halves to 15) sweeps flat (K1) under
    sweep_layout="packed", as in the reference; numpy input with no device
    runs on the card."""
    shape = (32, 32, 29)
    i0, i1, _ = syn.make_pair(shape, syn.translation((1.0, -0.5, 0.5)))
    p = FlowParams(levels=2, warps=2, inner_iterations=2, sweeps=10,
                   sweep_layout="packed")
    kernels.reset_launches()
    got = compute_flow(i0, i1, p)
    assert got.device.type == "cuda"
    # levels x warps x inner iterations x sweeps, one fused launch each
    assert kernels.LAUNCHES["sor_halfsweep"] == 2 * 2 * 2 * 10
    assert kernels.LAUNCHES["sor_packed"] == 0
    assert torch.equal(got, compute_flow(i0, i1,
                                         p.replace(sweep_layout="flat")))


# ---- the window forms (the streamed out-of-core mode) ----

WINDOW_DG = 24                                  # the volume's depth
WINDOWS = [(-5, 14), (0, 14), (6, 14), (13, 14)]  # (z0, slab planes)


def _window_ctx(z0):
    return HaloCtx(window_z0=z0, window_d_global=WINDOW_DG)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("interp", ["trilinear", "tricubic"])
@pytest.mark.parametrize("z0,planes", WINDOWS)
def test_warp_grad_window_bitwise(dev, z0, planes, interp, emit, staged):
    """K2/K5 in window form (z clipped to the volume in the slab's frame,
    then to the slab) against the plain window warp + derivatives."""
    rng = np.random.default_rng(8)
    shape = (planes, 18, 40)
    i0, i1 = (_t(rng.normal(size=shape), dev) for _ in range(2))
    flow = _t(rng.uniform(-3.0, 3.0, (3, *shape)), dev)
    ctx = _window_ctx(z0)
    kernels.reset_launches()
    got = k_warp_grad(i1, flow, i0, ctx, interp=interp, emit_warped=emit,
                      staged=staged)
    i1w = warp_volume(i1, flow, ctx, interp=interp)
    ref = (*derivatives(i0, i1w, ctx), i1w)
    assert len(got) == (3 if emit else 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    name = "warp_grad_tricubic" if interp == "tricubic" else "warp_grad"
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {name: 1}


@pytest.mark.parametrize("interp", ["trilinear", "tricubic"])
def test_warp_grad_window_of_the_whole_volume_is_the_one_device_launch(
        dev, interp):
    rng = np.random.default_rng(9)
    shape = (20, 17, 35)
    i0, i1 = (_t(rng.normal(size=shape), dev) for _ in range(2))
    flow = _t(rng.uniform(-6.0, 6.0, (3, *shape)), dev)
    whole = HaloCtx(window_z0=0, window_d_global=shape[0])
    a = k_warp_grad(i1, flow, i0, whole, interp=interp, emit_warped=True)
    b = k_warp_grad(i1, flow, i0, interp=interp, emit_warped=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.0, 1.5], ids=["k1", "k6"])
@pytest.mark.parametrize("z0,planes", WINDOWS)
def test_single_colour_sweeps_on_windows(dev, z0, planes, gamma,
                                         terms_dtype):
    """K1 and K6 on a window slab: one colour per launch with replicate
    halo planes, bitwise the plain half-sweep under the window context;
    sor_sweeps then takes two launches per sweep, never the fused or the
    one-block form."""
    ctx = _window_ctx(z0)
    du, t = _terms((planes, 12, 16), dev, gamma=gamma,
                   terms_dtype=terms_dtype, ctx=ctx)
    parity = parity_mask(tuple(du.shape[1:]), ctx, dev)
    half = ((lambda x, c: k_sor_gc(x, t, (ALPHA,) * 3, OMEGA, c, ctx))
            if gamma > 0.0 else
            (lambda x, c: k_sor(x, t, ALPHA, OMEGA, c, ctx)))
    for color in (0, 1):
        assert torch.equal(half(du, color),
                           sor_halfsweep(du, t, OMEGA, parity, color, ctx))
    kernels.reset_launches()
    got = (sor_gc_sweeps(du, t, (ALPHA,) * 3, OMEGA, 2, ctx) if gamma > 0.0
           else sor_sweeps(du, t, ALPHA, OMEGA, 2, ctx))
    ref = du
    for _ in range(2):
        for color in (0, 1):
            ref = sor_halfsweep(ref, t, OMEGA, parity, color, ctx)
    assert torch.equal(got, ref)
    name = "sor_gc" if gamma > 0.0 else "sor_halfsweep"
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {name: 4}


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.0, 1.5], ids=["k4", "k7"])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_null_planes_bitwise(dev, shape, gamma, terms_dtype):
    """K4 and K7 with null halo planes (what a whole volume passes: the
    kernel replicates its own faces) against the call with copied planes,
    and the sweeper of solve_increment copies none on a whole volume."""
    du, t = _terms(shape, dev, gamma=gamma, terms_dtype=terms_dtype)
    kern = k7.sor_halfsweep_gc_packed if gamma > 0.0 else \
        k4.sor_halfsweep_packed
    for color in (0, 1):
        args = _packed_args(du, t, color, 0, shape[0], gamma)
        nulls = args[:-9] + (None,) * 4 + args[-5:]
        assert torch.equal(kern(*nulls), kern(*args))
    with pytest.raises(ValueError, match="all be None"):
        kern(*(args[:-9] + (None, *args[-8:])))


def test_packed_sweeper_copies_no_planes_on_one_device(dev, monkeypatch):
    from tpuflow3d_torch.solver import _packed_sweeper
    du, t = _terms((6, 8, 8), dev)
    calls = []
    monkeypatch.setattr(HaloCtx, "z_halo_planes",
                        lambda self, x: calls.append(1))
    state, one_sweep = _packed_sweeper(
        du, t, FlowParams(alpha=ALPHA, sweep_layout="packed"), HaloCtx())
    one_sweep(state)
    torch.cuda.synchronize()
    assert calls == []


# name -> (params, chunk, shape, kernels the streamed path launches)
_LADDER = dict(levels=2, warps=3, inner_iterations=3, sweeps=20,
               flow_clamp=3.0)
STREAM_PATHS = {
    "ladder": (FlowParams(**_LADDER), 8, (32, 32, 32),
               {"sor_halfsweep", "warp_grad", "median3"}),
    "fused": (FlowParams(**{**_LADDER, "inner_iterations": 1, "warps": 5}), 8,
              (32, 32, 32), {"sor_halfsweep", "warp_grad", "median3"}),
    "gamma_fused": (FlowParams(**{**_LADDER, "inner_iterations": 1,
                                  "gamma": 1.0}), 8, (30, 32, 32),
                    {"sor_gc", "warp_grad", "median3"}),
    "accurate": (PRESETS["accurate"].replace(levels=2, warps=3), 8,
                 (32, 32, 32), {"warp_grad_tricubic", "sor_gc", "median3",
                                "mg_restrict", "mg_prolong"}),
}


@pytest.mark.parametrize("name", list(STREAM_PATHS))
def test_piecewise_kernels_match_plain_and_launch(dev, name):
    """compute_flow_piecewise through the kernels against its plain run on
    the card: bitwise, exactly the path's kernels launched, and the EPE
    within the JAX package's streamed-vs-in-core gate (0.02) of the
    in-core flow's."""
    from tpuflow3d_torch.piecewise import compute_flow_piecewise
    p, chunk, shape, launched = STREAM_PATHS[name]
    i0, i1, true = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)))
    kernels.reset_launches()
    got = compute_flow_piecewise(i0, i1, p, chunk_z=chunk)
    assert {k for k, n in kernels.LAUNCHES.items() if n > 0} == launched, \
        kernels.LAUNCHES
    ref = compute_flow_piecewise(i0, i1, p.replace(backend="plain"),
                                 chunk_z=chunk, device=dev)
    np.testing.assert_array_equal(got, ref)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(shape, 4)
    incore = compute_flow(i0, i1, p, device=dev).cpu().numpy()
    assert abs(syn.epe(got, true, mask) - syn.epe(incore, true, mask)) < 0.02


# ---- the halo form (a Z shard: ranks sharing the card through gloo) ----

@pytest.fixture(scope="module")
def shard_pool():
    """Three ranks on cuda:0 (the middle one has two interior faces)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    import torch_ranks
    pool = torch_ranks.RankPool(3, device="cuda:0", threads=2)
    yield pool
    pool.close()


@pytest.mark.parametrize("depth", [36, 6], ids=["slabs", "thin_slabs"])
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("max_disp", [4.0, 6.0])
@pytest.mark.parametrize("interp", ["trilinear", "tricubic"])
def test_warp_grad_halo_form_bitwise(shard_pool, depth, emit, max_disp,
                                     interp):
    """K2/K5 in halo form on each of three Z shards (global faces on the
    outer ones, neighbours on both faces of the middle one; slabs of 2
    planes take their halos through the all-gather) against the plain
    sharded warp + derivatives, bitwise, at flows within +-max_disp."""
    import torch_ranks
    rng = np.random.default_rng(int(max_disp) * 10 + depth)
    shape = (depth, 18, 40)
    i0, i1 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    flow = rng.uniform(-max_disp, max_disp, (3, *shape)).astype(np.float32)
    name = "warp_grad_tricubic" if interp == "tricubic" else "warp_grad"
    for rank, (same, err, launches) in enumerate(shard_pool.run(
            torch_ranks.warp_halo_case, i0, i1, flow, max_disp, interp,
            emit)):
        assert same, (rank, err)
        assert launches == {name: 1}


@pytest.mark.parametrize("numel", [4, 1000, (1 << 20) + 12])
def test_copy_probe_is_its_source(dev, numel):
    """The copy kernel, several passes, on sizes that end inside a grid
    stride and inside an unrolled step."""
    src = torch.randn(numel, device=dev)
    dst = torch.zeros_like(src)
    roofline.copy_probe(dst, src, reps=3)
    torch.cuda.synchronize()
    assert torch.equal(dst, src)


@pytest.mark.parametrize("iters", [0, 1, 7])
def test_minmax_probe_matches_its_plain_network(dev, iters):
    out = torch.empty(3 * 256, device=dev)
    roofline.minmax_probe(out, iters)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), roofline.minmax_probe_plain(3, iters))


def test_bandwidth_probe_passes_its_checks(dev):
    """At the default footprint (1 GiB a side) the probe's 16 copies take
    12-20x one copy's time and its rate stays under the data sheet's."""
    bw = roofline.measure_hbm_bw(device=dev)
    assert 0 < bw <= roofline.device_hbm_bw(dev)
    assert roofline.minmax_rate(dev) > 0


@pytest.mark.parametrize("name", ["ladder256", "accurate"])
def test_graphed_flow_is_the_eager_flow(dev, name):
    """compute_flow on the card replays CUDA graphs (graphs.py): at 64^3 its
    flow is bitwise the eager compute_flow_impl's, with the same launches
    of each kernel; a second call captures nothing new; a new shape drops
    the old entry, and graphs.clear() drops them all."""
    from tpuflow3d_torch import graphs, pipeline
    p = PRESETS[name]
    shape = (64, 64, 64)
    i0, i1, _ = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)))
    graphs.clear()
    kernels.reset_launches()
    got = compute_flow(i0, i1, p, device=dev)
    graphed = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    want = pipeline.compute_flow_impl(torch.as_tensor(i0, device=dev),
                                      torch.as_tensor(i1, device=dev), p,
                                      HaloCtx())
    assert graphed == kernels.LAUNCHES
    assert torch.equal(got, want)
    (info,) = graphs.entries().values()
    assert info["captures"] == info["graphs"] > 0
    again = compute_flow(i0, i1, p, device=dev)
    assert torch.equal(again, got)
    (info2,) = graphs.entries().values()
    assert info2["captures"] == info["captures"]
    assert info2["replays"] == 2 * info["replays"]
    compute_flow(i0[:, :, :32], i1[:, :, :32], p, device=dev)
    (key,) = graphs.entries()
    assert key[1] == (64, 64, 32)
    graphs.clear()
    assert graphs.entries() == {}


def test_replays_by_key_counts_the_benchmarks_v_cycles(dev):
    """The entry's own ``replays_by_key`` holds what the benchmark counts
    by wrapping ``graphs._Held._replay`` (``flowbench.system.
    replay_counts``): one ``("body", level)`` replay a V-cycle the early
    stop let run, for a 64^3 ``accurate`` call."""
    from flowbench.system import replay_counts
    from tpuflow3d_torch import graphs
    p = PRESETS["accurate"]
    i0, i1, _ = syn.make_pair((64, 64, 64), syn.translation((1.5, -1.0, 0.75)))
    graphs.clear()
    compute_flow(i0, i1, p, device=dev)
    (info,) = graphs.entries().values()
    first = info["replays_by_key"]
    counted = {}
    with replay_counts(counted):
        compute_flow(i0, i1, p, device=dev)
    (info,) = graphs.entries().values()
    second = {k: v - first.get(k, 0) for k, v in info["replays_by_key"].items()}
    bodies = {k: v for k, v in counted.items() if k[0] == "body"}
    assert bodies and all(second[k] == v for k, v in bodies.items())
    assert second == counted
    assert sum(info["replays_by_key"].values()) == info["replays"]
    graphs.clear()


def test_a_capture_that_fails_raises(dev, monkeypatch):
    """An operation a CUDA graph cannot capture (a host read), planted in a
    segment, raises: nothing runs eagerly in its place, the entry is
    dropped, and the next call captures and runs."""
    from tpuflow3d_torch import graphs, pipeline
    real = pipeline._upsample

    def planted(flow, shape, p, ctx):
        flow.sum().item()
        return real(flow, shape, p, ctx)

    p = FlowParams(levels=2, warps=1, inner_iterations=1, sweeps=2)
    i0, i1, _ = syn.make_pair((32, 32, 32), syn.translation((1.0, 0.5, 0.0)))
    graphs.clear()
    monkeypatch.setattr(pipeline, "_upsample", planted)
    with pytest.raises(RuntimeError):
        compute_flow(i0, i1, p, device=dev)
    assert graphs.entries() == {}
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    monkeypatch.setattr(pipeline, "_upsample", real)
    flow = compute_flow(i0, i1, p, device=dev)
    assert bool(torch.isfinite(flow).all())
    graphs.clear()
