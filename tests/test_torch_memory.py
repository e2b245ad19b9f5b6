"""The port's device-memory model (``tpuflow3d_torch.utils.memory``): its
monotonicity, the index limits it takes from the kernel wrappers, the
chunk choice (which raises where the JAX package's floors), the streamed
multigrid reserve as a sum over the port's own coarse chain, the device
budget, and the streamed level plan the model reads against the passes
``compute_flow_piecewise`` makes. The bytes per voxel themselves are measured on the card
(``tools/torch_memory_peaks.py``, ``chip_smoke.py``); here is their
arithmetic."""

import numpy as np
import pytest
import torch

from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d.utils import memory as ref_mem
from tpuflow3d_torch import PRESETS, FlowParams
from tpuflow3d_torch import piecewise as pw
from tpuflow3d_torch.kernels import median3, sor, warp_grad
from tpuflow3d_torch.mgsolver import mg_shapes
from tpuflow3d_torch.utils import memory as mem

torch.set_num_threads(2)

SETTINGS = {
    "default": FlowParams(),
    "ladder512": PRESETS["ladder512"],
    "accurate": PRESETS["accurate"],
    "accurate-bf16": PRESETS["accurate-bf16"],
    "gamma": FlowParams(gamma=1.0),
    "packed": FlowParams(sweep_layout="packed"),
    "packed_gamma": FlowParams(sweep_layout="packed", gamma=1.0),
    "jacobi": FlowParams(solver="jacobi"),
    "order4": FlowParams(deriv_order=4, flow_clamp=2.0),
    "fused": FlowParams(inner_iterations=1),
    "fused_gamma_order4": FlowParams(inner_iterations=1, gamma=1.0,
                                     deriv_order=4),
    "bf16": FlowParams(terms_dtype="bfloat16"),
    "mg_gamma": PRESETS["accurate"].replace(gamma=1.0),
}
G = 1 << 30


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_model_grows_with_each_axis(name):
    """Every model grows with D, H and W; the streamed one with the chunk,
    and the chunk with the budget."""
    p = SETTINGS[name]
    base = (96, 80, 64)
    for axis in range(3):
        bigger = list(base)
        bigger[axis] += 16
        assert mem.incore_peak_bytes(bigger, p) > mem.incore_peak_bytes(
            base, p)
        assert mem.streamed_peak_bytes(bigger, p, 16) >= \
            mem.streamed_peak_bytes(base, p, 16)
    shape = (512, 256, 256)
    peaks = [mem.streamed_peak_bytes(shape, p, c) for c in (8, 16, 64, 256)]
    assert peaks == sorted(peaks) and peaks[0] < peaks[-1]
    budgets = (4 * G, 8 * G, 16 * G)
    chunks = [mem.pick_chunk_z(shape, p, b) for b in (*budgets, 1 << 50)]
    assert chunks == sorted(chunks) and chunks[-1] == 512
    for b, c in zip(budgets, chunks):
        # the chosen chunk fits and one more plane would not (or it is D)
        assert mem.streamed_peak_bytes(shape, p, c) <= b
        assert c == 512 or mem.streamed_peak_bytes(shape, p, c + 1) > b


def test_model_orders_the_settings():
    """Gradient constancy needs more than multigrid, which needs more than
    the flat SOR; the packed layout more than flat; the multigrid reserve
    only with multigrid."""
    shape = (256, 256, 256)
    need = {k: mem.incore_peak_bytes(shape, p) for k, p in SETTINGS.items()}
    assert need["gamma"] > need["accurate"] > need["default"]
    assert need["packed"] > need["default"]
    assert need["packed_gamma"] > need["gamma"]
    assert need["jacobi"] == need["default"] == need["order4"]
    assert mem.mg_coarse_resident_bytes(shape, SETTINGS["default"]) == 0
    assert mem.mg_coarse_resident_bytes(shape, SETTINGS["accurate"]) > 0


def test_incore_model_above_the_references():
    """The JAX package's model was fitted to its TPU; the port's in-core
    peak per voxel is larger (256^3 ladder: 253 B measured on the card
    against the reference's 85 x 1.15 plus pyramids)."""
    shape = (512, 512, 512)
    for name, p in (("ladder512", PRESETS["ladder512"]),
                    ("accurate", PRESETS["accurate"])):
        ref_p = RefParams(**{k: v for k, v in vars(p).items()
                             if k != "backend"})
        assert mem.incore_peak_bytes(shape, p) > 2 * ref_mem.incore_peak_bytes(
            shape, ref_p) or name == "accurate"
        assert mem.incore_peak_bytes(shape, p) > ref_mem.incore_peak_bytes(
            shape, ref_p)


# The graphed in-core gamma solve on the card (NVIDIA H100 80GB HBM3,
# 700 W): reserved peaks of its first call, which captures the graphs, in
# bytes, and the budget of an idle card (``device_budget_bytes``).
GAMMA_RESERVED = {("ladder512", 512): 67974987776,
                  ("ladder256", 256): 8128561152,
                  ("accurate", 256): 9785311232}
IDLE_CARD_BUDGET = 84465090560


@pytest.mark.parametrize("preset, n", sorted(GAMMA_RESERVED))
def test_gamma_row_covers_the_reserved_peaks(preset, n):
    """The ``gamma`` row, flat (K6) or multigrid, covers each reserved peak
    by at least 5%; at 512^3 flat it stays under an idle card's budget, so
    the command line's auto mode keeps the pair in core."""
    p = PRESETS[preset].replace(gamma=1.0)
    need = mem.incore_peak_bytes((n,) * 3, p)
    assert need >= 1.05 * GAMMA_RESERVED[preset, n]
    if n == 512:
        assert need < IDLE_CARD_BUDGET
        assert mem.incore_fits_index_limits((n,) * 3, p)


@pytest.mark.parametrize("preset", ["ladder512", "ladder1024"])
def test_index_limits_at_709_against_710(preset):
    """z_multiple 8 pads 709 and 710 to 712 planes: 6*712*709^2 < 2^31 <=
    6*712*710^2, K1's limit, which its wrapper's grid_fits gives."""
    p = PRESETS[preset]
    assert mem.incore_fits_index_limits((709,) * 3, p)
    assert not mem.incore_fits_index_limits((710,) * 3, p)
    assert sor.grid_fits(712, 709, 709) and not sor.grid_fits(712, 710, 710)


@pytest.mark.parametrize("kind", ["sor", "warp_grad", "median3", "plain",
                                  "packed", "jacobi_order4_nomedian"])
def test_index_limits_follow_the_kernels_launched(kind):
    """Each limit applies where its kernel runs: K1 at 6*DHW (711^3 past it
    without z padding), K2/K5 and K3 at 3*DHW (1024 x 1024 x 700 past
    them); the packed sweeps, Jacobi and order 4 launch none of them; the
    plain backend launches nothing."""
    p = FlowParams()
    k1 = (711, 711, 711)
    k2 = (700, 1024, 1024)
    if kind == "sor":
        assert not mem.incore_fits_index_limits(k1, p)
        assert mem.incore_fits_index_limits((710,) * 3, p)
    elif kind == "warp_grad":
        q = p.replace(sweep_layout="packed", median=False)
        assert not warp_grad.grid_fits(*k2)
        assert not mem.incore_fits_index_limits(k2, q)
    elif kind == "median3":
        q = p.replace(sweep_layout="packed", deriv_order=4)
        assert not median3.grid_fits(3, *k2)
        assert not mem.incore_fits_index_limits(k2, q)
    elif kind == "plain":
        assert mem.incore_fits_index_limits(k2, p.replace(backend="plain"))
    elif kind == "packed":
        assert mem.incore_fits_index_limits(
            (711, 711, 712), p.replace(sweep_layout="packed"))
        # an odd width sweeps flat
        assert not mem.incore_fits_index_limits(
            k1, p.replace(sweep_layout="packed"))
    else:
        q = p.replace(solver="jacobi", deriv_order=4, median=False)
        assert mem.incore_fits_index_limits(k2, q)


def test_pick_chunk_z_raises_where_the_reference_floors():
    """A budget too small for an 8-plane chunk: the JAX package returns 8
    anyway (a run that would stream for hours, then run out of memory);
    the port raises with the numbers."""
    p = FlowParams(levels=2, flow_clamp=2.0)
    shape = (512, 256, 256)
    ref_p = RefParams(levels=2, flow_clamp=2.0)
    assert ref_mem.pick_chunk_z(shape, ref_p, 1000) == 8
    with pytest.raises(ValueError, match=r"no Z-chunk of 8 or more planes "
                                         r"fits.*GiB.*budget"):
        mem.pick_chunk_z(shape, p, 1000)
    need8 = mem.streamed_peak_bytes(shape, p, 8)
    assert mem.pick_chunk_z(shape, p, need8) == 8
    with pytest.raises(ValueError):
        mem.pick_chunk_z(shape, p, need8 - 1)
    # a volume shallower than lo takes its depth
    assert mem.pick_chunk_z((6, 64, 64), p, 1 << 40) == 6


def test_pick_chunk_z_raises_for_the_multigrid_reserve():
    p = PRESETS["accurate"]
    shape = (512, 512, 512)
    reserve = mem.mg_coarse_resident_bytes(shape, p)
    with pytest.raises(ValueError, match="coarse hierarchy"):
        mem.pick_chunk_z(shape, p, int(reserve))
    # above the reserve and an 8-plane slab, a chunk is found
    assert mem.pick_chunk_z(shape, p, mem.streamed_peak_bytes(shape, p,
                                                              8)) >= 8


def test_pick_chunk_z_keeps_slabs_under_the_index_limits():
    """With memory to spare, the chunk stops where the largest slab (chunk
    + 2*sweeps + 2 planes for the trapezoid) would pass K1's limit."""
    p = FlowParams(flow_clamp=4.0)
    shape = (4096, 1024, 1024)
    c = mem.pick_chunk_z(shape, p, 1 << 50)
    assert sor.grid_fits(c + 42, 1024, 1024)
    assert not sor.grid_fits(c + 43, 1024, 1024)


@pytest.mark.parametrize("shape", [(256, 256, 256), (96, 80, 64),
                                   (6, 64, 64), (512, 512, 512)])
def test_mg_reserve_is_the_sum_over_the_coarse_chain(shape):
    """The reserve is MG_CHANNELS float32 fields over mgsolver.mg_shapes
    below the finest level, not the JAX package's fixed multiple of the
    volume: a volume too shallow to coarsen has none."""
    p = PRESETS["accurate"]
    chain = mg_shapes(tuple(p.level_shapes(shape)[0]), 1)[1:]
    want = 4 * mem.MG_CHANNELS * sum(int(np.prod(s)) for s in chain)
    assert mem.mg_coarse_resident_bytes(shape, p) == want
    if shape == (6, 64, 64):
        assert want == 0
    if shape == (256, 256, 256):
        # 128^3 down to 4^3: 2 396 736 coarse voxels
        assert want == 4 * mem.MG_CHANNELS * 2396736


def test_device_budget(monkeypatch):
    monkeypatch.setenv("TPUFLOW_DEVICE_BYTES", "123456")
    assert mem.device_budget_bytes() == 123456
    assert mem.device_budget_bytes("cpu") == 123456
    monkeypatch.delenv("TPUFLOW_DEVICE_BYTES")
    assert mem.device_budget_bytes("cpu") is None
    if not torch.cuda.is_available():
        assert mem.device_budget_bytes() is None


# piecewise slab phase -> its name in level_plan
PLAN_PHASES = {"_ph_warp_deriv": "warp", "_ph_terms": "terms",
               "_ph_terms_mg": "terms_mg", "_ph_terms_gc": "terms_gc",
               "_ph_sor_trapezoid": "sor", "_ph_halfsweep": "halfsweep",
               "_ph_jacobi": "jacobi", "_ph_mg_trapezoid": "mg_smooth",
               "_ph_mg_residual": "mg_residual",
               "_ph_fused_warp_iter": "fused", "_ph_median": "median"}


@pytest.mark.parametrize("name,temporal_block", [
    *((n, True) for n in sorted(SETTINGS)), ("default", False)])
def test_level_plan_is_what_the_mode_runs(monkeypatch, name,
                                          temporal_block):
    """Every slab phase compute_flow_piecewise calls, on every level, with
    its slab's planes and z0 (chunks of 7 on a depth of 18: the last
    chunk ragged), is a pass of ``piecewise.level_plan``, and every pass
    of the plan runs: the model and chip_smoke.py's window forms read
    the plan, so a change to the loops fails here."""
    p = SETTINGS[name].replace(levels=2, warps=1, sweeps=3, mg_cycles=1)
    chunk, seen, level = 7, set(), []
    real_level = pw._solve_level_streamed

    def solve_level(i0l, *a, **kw):
        level[:] = [tuple(i0l.shape)]
        return real_level(i0l, *a, **kw)

    def record(fn, phase):
        def wrapped(*args, **kw):
            # The slab's origin: an int, or a 0-d tensor (on the CPU the
            # phases take their origins as the card's graphs do).
            z0 = next(int(a) for a in args if isinstance(a, int) or (
                isinstance(a, torch.Tensor) and a.ndim == 0))
            seen.add((level[0], phase, args[0].shape[-3], z0))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(pw, "_solve_level_streamed", solve_level)
    for attr, phase in PLAN_PHASES.items():
        monkeypatch.setattr(pw, attr, record(getattr(pw, attr), phase))
    rng = np.random.default_rng(3)
    i0 = rng.random((18, 12, 10), dtype=np.float32)
    i1 = np.roll(i0, 1, axis=2)
    pw.compute_flow_piecewise(i0, i1, p, chunk_z=chunk, device="cpu",
                              temporal_block=temporal_block)
    want = {(tuple(shape), ps.name, ps.planes, z0)
            for shape in p.level_shapes(i0.shape)
            for ps in pw.level_plan(p, shape, chunk, temporal_block)
            for z0 in ps.z0s}
    assert seen == want


def test_sharded_peak_is_the_incore_model_at_the_padded_slab():
    """A rank's model: the in-core model at d/n planes of the finest level
    plus the warp's I1 halo a side (6 planes at ``ladder256``'s clamp 4
    from prepare_params, 5 for ``accurate``'s tricubic at its clamp 2),
    below the whole volume's and falling with the rank count."""
    from tpuflow3d_torch.sharding import prepare_params
    shape = (256, 256, 256)
    for name, halo in (("ladder256", 6), ("accurate", 5)):
        p = PRESETS[name]
        pp = prepare_params(p, 2).replace(z_multiple=1)
        assert mem.sharded_peak_bytes(shape, p, 2) == mem.incore_peak_bytes(
            (128 + 2 * halo, 256, 256), pp)
        assert (mem.sharded_peak_bytes(shape, p, 4)
                < mem.sharded_peak_bytes(shape, p, 2)
                < mem.incore_peak_bytes(shape, p))


def test_sharded_index_limits():
    """1024^3 passes K1's 32-bit limit whole and on two ranks, not on
    four; the halo form's padded arrays count for K2/K5."""
    p = PRESETS["ladder1024"]
    shape = (1024, 1024, 1024)
    assert not mem.incore_fits_index_limits(shape, p)
    assert not mem.sharded_fits_index_limits(shape, p, 2)
    assert mem.sharded_fits_index_limits(shape, p, 4)
    assert warp_grad.grid_fits(100, 1000, 1000) and not warp_grad.grid_fits(
        100, 1000, 1000, halo=1100)
