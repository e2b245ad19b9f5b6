"""The compiled dispatch (``tpuflow3d_torch.graphs``) on the CPU.

The level loop (``pipeline.drive``) runs the solve in segments through a
runner: on a CUDA device ``compute_flow`` and ``compute_flow_checkpointed``
replay them from CUDA graphs, on the CPU the same segment functions run
one after another (``graphs.Direct``). The witness is the unsplit solve,
written out in this file (``_reference``: per level ``warps`` times
``pipeline.warp_iteration``, whose early stop is ``solver.relax_steps``,
then the upsampling and the clamp). These tests hold, at 16^3-32^3:

(a) no segment of the six paths (``ladder256``, gamma, ``packed``,
    ``packed_gamma``, ``accurate``, ``accurate-bf16``, at two levels and
    two warps) reads a tensor on the host or builds one from host data,
    which a capture cannot hold; a planted ``bool(tensor)`` or
    ``torch.tensor`` in a segment fails the check;
(b) the segmented loop gives the unsplit solve's flow bitwise, on the
    six cases of tests/test_pipeline.py;
(c) it is as close to ``tpuflow3d.compute_flow`` and to
    ``tpuflow3d.pipeline.compute_flow_checkpointed`` as the eager port
    (tests/test_torch_pipeline.py's tolerance: atol 5e-5, rtol 1e-4);
(d) the early stop stops at the same sweep (V-cycle) as the unsplit
    solve: with ``track_residuals`` the curves are bitwise its ones;
(e) a cache entry's bookkeeping, with the CUDA calls replaced so that a
    "capture" runs its work once with every static tensor restored after
    it and a "replay" runs it again (a graph's semantics on CPU tensors):
    bitwise the unsplit flow, a second call captures nothing, a new shape
    drops the old entry, launches count replays only, and a graph called
    on other tensors than it was captured with raises.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpuflow3d import compute_flow as ref_compute_flow
from tpuflow3d import synthetic as rsyn
from tpuflow3d.params import PRESETS as REF_PRESETS
from tpuflow3d.pipeline import \
    compute_flow_checkpointed as ref_compute_flow_checkpointed
from tpuflow3d_torch import PRESETS, FlowParams, graphs, kernels, pipeline
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.pyramid import upsample_flow
from tpuflow3d_torch.solver import parity_mask

torch.set_num_threads(2)

TOL = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(levels=2, warps=2)
PATHS = {
    "ladder256": PRESETS["ladder256"].replace(**SMALL),
    "gamma": PRESETS["ladder256"].replace(gamma=1.0, **SMALL),
    "packed": PRESETS["ladder256"].replace(sweep_layout="packed", **SMALL),
    "packed_gamma": PRESETS["ladder256"].replace(sweep_layout="packed",
                                                 gamma=1.0, **SMALL),
    "accurate": PRESETS["accurate"].replace(**SMALL),
    "accurate-bf16": PRESETS["accurate-bf16"].replace(**SMALL),
}
SHIFT = (1.5, -1.0, 0.75)


def _pair(shape, seed=0):
    i0, i1, _ = syn.make_pair(shape, syn.translation(SHIFT), seed=seed)
    return torch.from_numpy(i0), torch.from_numpy(i1)


def _reference(i0, i1, p, diagnostics=False):
    """The unsplit solve on the padded pair, cropped as compute_flow crops:
    per level, coarse to fine, ``warps`` times ``pipeline.warp_iteration``
    (its early stop ``solver.relax_steps``), then the flow upsampled to
    the next level and clamped."""
    d, ctx = i0.shape[0], HaloCtx()
    i0p, i1p = pipeline._pad_z(i0.float(), i1.float(), p.z_multiple)
    pyr0, pyr1, shapes = pipeline.prepare_pyramids(i0p, i1p, p, ctx)
    track = diagnostics and p.track_residuals
    residuals = (torch.zeros((len(shapes), p.warps,
                              p.inner_iterations * p.sweeps))
                 if track else None)
    flow = torch.zeros((3, *shapes[-1]))
    for li in range(len(shapes) - 1, -1, -1):
        parity = parity_mask(shapes[li], ctx, flow.device)
        for wi in range(p.warps):
            flow = pipeline.warp_iteration(
                pyr0[li], pyr1[li], flow, p, ctx, parity,
                residuals[li, wi] if track else None)
        if li > 0:
            flow = upsample_flow(flow, shapes[li - 1], ctx)
            if p.flow_clamp > 0.0:
                flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    if diagnostics:
        return flow[:, :d], ({"residuals": residuals} if track else {})
    return flow[:, :d]


# ---- (a) no host reads and no host data inside a segment ----

class _NoHost(TorchDispatchMode):
    """Raises on what a CUDA graph cannot capture: a tensor read on the host
    (``.item()``, ``bool()``, ``float()``) and a tensor built from host data
    (``torch.tensor``, ``torch.as_tensor`` of an array)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.lift_fresh.default):
            raise AssertionError(f"host read or host data in a segment: "
                                 f"{func}")
        return func(*args, **(kwargs or {}))


class _Checked(graphs.Direct):
    """The direct runner with every segment under ``_NoHost``."""

    def __init__(self):
        self.segments = set()

    def __call__(self, key, fn, args, carry=None):
        self.segments.add(key[0])
        with _NoHost():
            outs = fn(*args)
        return graphs._carried(outs, carry)


def _checked_run(p, shape=(16, 16, 16)):
    i0, i1 = _pair(shape)
    run = _Checked()
    flow, _ = pipeline.drive(run, i0, i1, p, HaloCtx())
    return run.segments, flow, i0, i1


@pytest.mark.parametrize("name", list(PATHS))
def test_segments_make_no_host_reads(name):
    p = PATHS[name]
    segments, flow, i0, i1 = _checked_run(p)
    split = p.residual_tol > 0.0
    assert segments == ({"prep", "pre", "terms", "body", "post", "up"}
                        if split else {"prep", "warp", "up"})
    assert torch.equal(flow, _reference(i0, i1, p))


@pytest.mark.parametrize("plant", ["bool", "tensor"])
@pytest.mark.parametrize("name", ["ladder256", "accurate"])
def test_a_planted_host_read_fails_the_check(monkeypatch, name, plant):
    real = pipeline._upsample

    def planted(flow, shape, p, ctx):
        if plant == "bool":
            bool(flow.abs().max() > 0)
        else:
            torch.tensor([1.0, 2.0])
        return real(flow, shape, p, ctx)

    monkeypatch.setattr(pipeline, "_upsample", planted)
    with pytest.raises(AssertionError, match="host read or host data"):
        _checked_run(PATHS[name])


# ---- (b) the segmented loop is the unsplit solve, bitwise ----

P24 = FlowParams(levels=2, scale_factor=0.5, warps=2, inner_iterations=3,
                 sweeps=20, alpha=0.05)
S24 = (24, 24, 24)
# tests/test_pipeline.py's cases at 24^3: name -> (shape, flow, params,
# texture)
CASES = {
    "translation": (S24, syn.translation((1.5, -1.0, 0.75)), P24, "blobs"),
    "rotation": (S24, syn.rotation(center=(12, 12, 12), axis="z",
                                   degrees=2.0), P24, "blobs"),
    "sinusoid": (S24, syn.sinusoid(S24, amplitude=1.0, periods=24 / 48),
                 P24.replace(alpha=0.02), "fourier"),
    "median_off_clamp": (S24, syn.translation((1.0, 0.5, -0.5)),
                         P24.replace(median=False, flow_clamp=3.0),
                         "blobs"),
    "nondivisible_z": ((22, 24, 24), syn.translation((1.0, 0.0, 0.0)),
                       P24.replace(z_multiple=8), "blobs"),
    "jacobi": (S24, syn.translation((0.8, -0.6, 0.4)),
               P24.replace(solver="jacobi", sweeps=60), "blobs"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_segmented_flow_is_the_eager_flow(name):
    shape, fn, p, texture = CASES[name]
    i0, i1, _ = syn.make_pair(shape, fn, seed=0, texture=texture)
    i0, i1 = torch.from_numpy(i0), torch.from_numpy(i1)
    got = pipeline.compute_flow(i0, i1, p, device="cpu")
    assert got.shape == (3, *shape)
    assert torch.equal(got, _reference(i0, i1, p))


# ---- (c) the JAX package's flow, as close as the eager port ----

# (The segmented compute_flow on every case of tests/test_torch_pipeline.py,
# accurate included, is held there.)
REF = {"ladder": REF_PRESETS["ladder256"].replace(**SMALL),
       "accurate": REF_PRESETS["accurate"].replace(**SMALL)}


@pytest.mark.parametrize("name, checkpointed",
                         [("ladder", False), ("ladder", True),
                          ("accurate", True)])
def test_segmented_flow_matches_the_reference(name, checkpointed, tmp_path):
    rp = REF[name]
    i0, i1, _ = rsyn.make_pair(S24, rsyn.translation(SHIFT), seed=0)
    p = from_reference(rp)
    if checkpointed:
        ref = ref_compute_flow_checkpointed(
            i0, i1, rp, checkpoint_dir=str(tmp_path / "ref"))
        got = pipeline.compute_flow_checkpointed(
            i0, i1, p, checkpoint_dir=str(tmp_path / "port"), device="cpu")
        assert sorted(x.name for x in (tmp_path / "port").iterdir())
    else:
        ref = ref_compute_flow(i0, i1, rp)
        got = pipeline.compute_flow(i0, i1, p, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    unsplit = _reference(torch.from_numpy(i0), torch.from_numpy(i1), p)
    assert torch.equal(got, unsplit)


# ---- (d) the early stop stops where the unsplit solve stops ----

EARLY = {
    "sor": P24.replace(residual_tol=2e-3),
    "packed": P24.replace(residual_tol=2e-3, sweep_layout="packed"),
    "multigrid": PRESETS["accurate"].replace(levels=2, warps=3,
                                             residual_tol=1e-4),
}


@pytest.mark.parametrize("name", list(EARLY))
def test_early_stop_residual_curves_are_the_eager_ones(name):
    p = EARLY[name].replace(track_residuals=True)
    i0, i1 = _pair(S24)
    got, gdiag = pipeline.compute_flow(i0, i1, p, device="cpu",
                                       diagnostics=True)
    want, wdiag = _reference(i0, i1, p, diagnostics=True)
    assert torch.equal(got, want)
    res = gdiag["residuals"]
    assert torch.equal(res, wdiag["residuals"])
    assert (res == 0).any() and (res > 0).any()  # some sweeps stopped early


# ---- (e) the cache entry, its graphs replaced by recorded work ----

class _Recorded:
    """A captured segment's replay on CPU tensors: the segment runs again
    and its results are copied into the captured ones (the graph's fixed
    addresses); the launches its host code counts at the capture are the
    replay's."""

    def __init__(self, fn, args, carry, outs):
        self.fn, self.args, self.carry, self.outs = fn, args, carry, outs

    def replay(self):
        with kernels.counted_apart():
            graphs._copy_tree(self.outs, graphs._carried(
                self.fn(*self.args), self.carry))


@pytest.fixture
def recorded(monkeypatch):
    """graphs' CUDA calls replaced so that an entry works on CPU tensors:
    a capture runs the segment once (its host code, and the launches it
    counts) and leaves every tensor of the entry as it was; each replay
    runs it again. Yields the list of captured segments."""
    captured = []

    def capture(fn, args, carry, pool, stream):
        (entry,) = graphs._ENTRIES.values()
        held = list(entry.outside.values()) + [
            t for g in entry.graphs.values()
            for t in graphs._tensors(g.outs)]
        saved = [t.clone() for t in held]
        outs = graphs._carried(fn(*args), carry)
        for t, s in zip(held, saved):
            t.copy_(s)
        captured.append(fn)
        return _Recorded(fn, args, carry, outs), outs

    class _Stream:
        def __init__(self, *args):
            pass

        def wait_stream(self, other):
            pass

    class _Pool:
        id = (0, 1)

    monkeypatch.setattr(graphs, "_capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "MemPool", _Pool)
    monkeypatch.setattr(torch.cuda, "use_mem_pool",
                        lambda pool, device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    yield captured
    graphs._ENTRIES.clear()


def _entry_solve(p, i0, i1, track=False):
    entry = graphs._entry(p, tuple(i0.shape), torch.device("cpu"), track)
    return pipeline.drive(entry, *entry.inputs(i0, i1), p, HaloCtx(),
                          track)


@pytest.mark.parametrize("name", ["ladder256", "packed", "accurate"])
def test_entry_replays_the_eager_flow(recorded, name):
    p = PATHS[name]
    i0, i1 = _pair((16, 16, 16))
    want = _reference(i0, i1, p)
    first, _ = _entry_solve(p, i0, i1)
    n = len(recorded)
    assert n == (10 if p.residual_tol > 0.0 else 4)
    assert torch.equal(first, want)
    first = first.clone()
    # Another pair through the same entry: nothing captured anew.
    j0, j1 = _pair((16, 16, 16), seed=1)
    other, _ = _entry_solve(p, j0, j1)
    assert len(recorded) == n
    assert torch.equal(other, _reference(j0, j1, p))
    again, _ = _entry_solve(p, i0, i1)
    assert torch.equal(again, first)
    (info,) = graphs._ENTRIES.values()
    assert len(info.graphs) == n and info.stats["captures"] == n


def test_entry_residuals_and_a_new_shape(recorded):
    p = EARLY["multigrid"].replace(track_residuals=True)
    i0, i1 = _pair((16, 16, 16))
    flow, res = _entry_solve(p, i0, i1, track=True)
    want, diag = _reference(i0, i1, p, diagnostics=True)
    assert torch.equal(flow, want) and torch.equal(res, diag["residuals"])
    key = next(iter(graphs._ENTRIES))
    k0, k1 = _pair((16, 16, 24))
    _entry_solve(p, k0, k1, track=True)
    assert list(graphs._ENTRIES) != [key] and len(graphs._ENTRIES) == 1


def test_entry_counts_replayed_launches_only(recorded, monkeypatch):
    """A segment's launches count once per replay: not at the warm-up, not
    at the capture."""
    real = pipeline._upsample

    def launching(flow, shape, p, ctx):
        kernels.LAUNCHES["median3"] += 1  # what a wrapper does per launch
        return real(flow, shape, p, ctx)

    monkeypatch.setattr(pipeline, "_upsample", launching)
    p = PATHS["ladder256"].replace(levels=3)
    i0, i1 = _pair((32, 32, 32))
    assert len(p.level_shapes((32, 32, 32))) == 3
    kernels.reset_launches()
    _entry_solve(p, i0, i1)
    assert kernels.LAUNCHES["median3"] == 2  # two upsamples, one each
    entry = next(iter(graphs._ENTRIES.values()))
    assert entry.stats["warmup_launches"] == 2
    _entry_solve(p, i0, i1)
    assert kernels.LAUNCHES["median3"] == 4
    kernels.reset_launches()


@pytest.mark.parametrize("name", ["ladder256", "accurate"])
def test_entry_counts_replays_by_key(recorded, monkeypatch, name):
    """``replays_by_key`` (reported by ``entries()``) splits ``replays`` by
    segment and level: one ``("body", level)`` replay a sweep (V-cycle)
    the early stop let run, one ``("warp", level)`` a warp iteration."""
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    p = PATHS[name]
    i0, i1 = _pair((16, 16, 16))
    _entry_solve(p, i0, i1)
    (info,) = graphs.entries().values()
    by_key = info["replays_by_key"]
    assert sum(by_key.values()) == info["replays"]
    levels = range(len(p.level_shapes((16, 16, 16))))
    if p.residual_tol > 0.0:
        for li in levels:
            assert by_key[("pre", li)] == by_key[("post", li)] == p.warps
            assert p.warps <= by_key[("body", li)] <= (
                p.warps * p.inner_iterations * p.mg_cycles)
    else:
        assert {k: v for k, v in by_key.items() if k[0] == "warp"} == {
            ("warp", li): p.warps for li in levels}
    assert by_key[("prep",)] == 1


def test_entry_refuses_other_tensors(recorded):
    p = PATHS["ladder256"]
    i0, i1 = _pair((16, 16, 16))
    entry = graphs._entry(p, (16, 16, 16), torch.device("cpu"), False)
    pipeline.drive(entry, *entry.inputs(i0, i1), p, HaloCtx())
    with pytest.raises(RuntimeError, match="other tensors"):
        pipeline.drive(entry, i0.float(), i1.float(), p, HaloCtx())


def test_entry_refuses_results_of_another_level(recorded):
    """A segment may read results of the pyramids' segment or of its own
    level's segments only (a result may sit in blocks that segments
    captured before it use inside their replays)."""
    p = PATHS["accurate"]
    i0, i1 = _pair((16, 16, 16))
    entry = graphs._entry(p, (16, 16, 16), torch.device("cpu"), False)
    pipeline.drive(entry, *entry.inputs(i0, i1), p, HaloCtx())
    g1 = entry.graphs[("pre", 1)].outs[0]
    pyramid = entry.graphs[("prep",)].outs[0][0]
    same = entry(("x", 1), lambda g, v: (g * 2.0, v + 1.0), (g1, pyramid))
    assert torch.equal(same[0], g1 * 2.0)
    with pytest.raises(RuntimeError, match="reads a result of"):
        entry(("x", 0), lambda g: (g * 2.0,), (g1,))
    assert graphs._ENTRIES == {}
