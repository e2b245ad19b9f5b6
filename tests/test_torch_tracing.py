"""The tracer of ``tpuflow3d_torch.utils.profiling`` (``span``, ``count``,
``enable``, ``snapshot``, ``reset``) and its sites in the port, on the
CPU at 16^3-32^3:

(a) off (the default) a site returns the shared null context and the
    table stays empty over whole in-core and streamed solves;
(b) on, the flows are bitwise those with it off (``ladder256`` and
    ``accurate`` in core at 32^3, the streamed ladder);
(c) on, ``tf3d.replay.<segment>`` counts every segment ``pipeline.drive``
    runs, ``tf3d.early_stop`` opens once per inner iteration, and self
    seconds never exceed seconds;
(d) streamed, ``tf3d.stream.host_arrays`` opens in
    ``piecewise._solve_level_streamed`` as often as the level loop makes
    its host arrays, and ``stage.h2d_bytes`` over one pair is
    ``piecewise.stream_h2d_bytes`` (``level_plan``'s passes) exactly;
(e) ``device_trace`` (the command line's ``--profile-dir``) turns the
    tracer on for its block, and its Chrome trace holds the spans;
(f) the points the benchmark (``flowbench/system.py``) wraps stay where it
    finds them;
(g) gradient constancy: ``tf3d.gc.derivs`` opens once a warp and
    ``tf3d.gc.terms`` once a nonlinearity update, their voxel counters
    weigh each by its level's voxels, nothing of either at gamma 0, the
    counts of a graph's capture are added at each replay
    (``counted_apart``, ``add_counts``), and, on the card (``cuda``), a
    replayed pair counts what the eager solve counts.
"""

import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow3d_torch import PRESETS, compute_flow, graphs, pipeline
from tpuflow3d_torch import piecewise as pw
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.utils import profiling

torch.set_num_threads(2)

SHIFT = (1.5, -1.0, 0.75)
S32 = (32, 32, 32)
INCORE = {
    "ladder256": PRESETS["ladder256"].replace(levels=2, warps=2),
    "accurate": PRESETS["accurate"].replace(levels=2, warps=2),
}
STREAMED = PRESETS["ladder256"].replace(levels=2, warps=2, flow_clamp=4.0)
CHUNK = 8


@pytest.fixture(autouse=True)
def tracer():
    """Every test starts with the tracer off and its table empty, and
    leaves it so."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _pair(shape=S32, seed=0):
    i0, i1, _ = syn.make_pair(shape, syn.translation(SHIFT), seed=seed)
    return i0, i1


def _traced(fn, *args, **kwargs):
    profiling.enable(True)
    try:
        return fn(*args, **kwargs)
    finally:
        profiling.enable(False)


def _incore(i0, i1, p):
    return compute_flow(i0, i1, p, device="cpu")


def _streamed(i0, i1, p=STREAMED, **kw):
    return pw.compute_flow_piecewise(i0, i1, p, chunk_z=CHUNK, device="cpu",
                                     **kw)


# ---- (a) off ----

def test_off_a_site_is_the_shared_null_context():
    assert profiling.span("tf3d.anything") is profiling._NULL
    profiling.count("stage.h2d_bytes", 10)
    with profiling.span("tf3d.anything"):
        pass
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_off_the_table_stays_empty_over_solves():
    i0, i1 = _pair((16, 16, 16))
    _incore(i0, i1, INCORE["accurate"])
    _streamed(i0, i1)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


# ---- (b) the flows do not move ----

@pytest.mark.parametrize("name", list(INCORE))
def test_incore_flow_is_bitwise_with_tracing_on(name):
    i0, i1 = _pair()
    want = _incore(i0, i1, INCORE[name])
    got = _traced(_incore, i0, i1, INCORE[name])
    assert torch.equal(got, want)
    assert profiling.snapshot()["spans"]


def test_streamed_flow_is_bitwise_with_tracing_on():
    i0, i1 = _pair()
    want = _streamed(i0, i1)
    got = _traced(_streamed, i0, i1)
    assert np.array_equal(got, want)
    assert profiling.snapshot()["counters"]["stage.h2d_bytes"] > 0


# ---- (c) the in-core spans ----

class _Counting(graphs.Direct):
    """The direct runner, counting the segments it runs by name."""

    def __init__(self):
        self.runs = {}

    def __call__(self, key, fn, args, carry=None):
        self.runs[key[0]] = self.runs.get(key[0], 0) + 1
        return super().__call__(key, fn, args, carry)


@pytest.mark.parametrize("name", list(INCORE))
def test_replay_spans_count_the_segments_drive_runs(name):
    p = INCORE[name]
    i0, i1 = (torch.from_numpy(x) for x in _pair((16, 16, 16)))
    run = _Counting()
    _traced(pipeline.drive, run, i0, i1, p, HaloCtx())
    spans = profiling.snapshot()["spans"]
    replays = {k.rsplit(".", 1)[1]: v["calls"] for k, v in spans.items()
               if k.startswith("tf3d.replay.")}
    assert replays == run.runs
    levels = len(p.level_shapes((16, 16, 16)))
    if p.residual_tol > 0.0:
        assert spans["tf3d.early_stop"]["calls"] == (
            levels * p.warps * p.inner_iterations)
        # The early stop's span holds the sweeps' replays and their reads.
        assert (spans["tf3d.early_stop"]["seconds"]
                >= spans["tf3d.replay.body"]["seconds"])
    else:
        assert "tf3d.early_stop" not in spans
        assert run.runs["warp"] == levels * p.warps


def test_self_seconds_never_exceed_seconds():
    _traced(_incore, *_pair((16, 16, 16)), INCORE["accurate"])
    _traced(_streamed, *_pair((16, 16, 16)))
    spans = profiling.snapshot()["spans"]
    assert {"tf3d.early_stop", "tf3d.stage.store", "tf3d.stage.wait"} <= \
        set(spans)
    for row in spans.values():
        assert 0.0 <= row["self_seconds"] <= row["seconds"]
    # store waits for its copy inside it: its own seconds leave that out.
    st = spans["tf3d.stage.store"]
    assert st["self_seconds"] <= st["seconds"] - spans["tf3d.stage.wait"][
        "seconds"] + 1e-9


def test_nested_spans_split_their_seconds():
    profiling.enable(True)
    with profiling.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with profiling.span("inner"):
                time.sleep(0.01)
    spans = profiling.snapshot()["spans"]
    outer, inner = spans["outer"], spans["inner"]
    assert inner["calls"] == 2 and inner["self_seconds"] == inner["seconds"]
    assert outer["seconds"] >= 0.04
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - inner["seconds"])
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


# ---- (d) the streamed spans and counters ----

@pytest.mark.parametrize("inner", [1, 3])
def test_host_arrays_span_opens_in_the_streamed_level_loop(monkeypatch,
                                                           inner):
    p = STREAMED.replace(inner_iterations=inner)
    levels = []
    real = pw._solve_level_streamed

    def level(*a, **k):
        before = profiling.snapshot()["spans"].get(
            "tf3d.stream.host_arrays", {"calls": 0})["calls"]
        out = real(*a, **k)
        levels.append(profiling.snapshot()["spans"].get(
            "tf3d.stream.host_arrays", {"calls": 0})["calls"] - before)
        return out

    monkeypatch.setattr(pw, "_solve_level_streamed", level)
    _traced(_streamed, *_pair((16, 16, 16)), p)
    # Phased (inner > 1 or fuse off): g, it, du, (c, psi_s, psi_d) per
    # inner iteration, the median's du, flow + du and the clip per warp.
    # The fused pass (inner 1) makes no host arrays.
    per_warp = 0 if inner == 1 else 6 + 3 * inner
    assert levels == [p.warps * per_warp] * len(p.level_shapes((16,) * 3))


@pytest.mark.parametrize("kw", [
    {}, {"inner_iterations": 1}, {"gamma": 1.0}, {"solver": "jacobi"},
    {"temporal_block": False}])
def test_h2d_counter_is_the_level_plans_bytes(kw):
    kw = dict(kw)
    temporal_block = kw.pop("temporal_block", True)
    p = STREAMED.replace(**kw)
    _traced(_streamed, *_pair(), p, temporal_block=temporal_block)
    counters = profiling.snapshot()["counters"]
    assert counters["stage.h2d_bytes"] == pw.stream_h2d_bytes(
        p, S32, CHUNK, temporal_block)
    assert 0 < counters["stage.d2h_bytes"] < counters["stage.h2d_bytes"]


def test_h2d_bytes_refuses_the_streamed_multigrid():
    with pytest.raises(ValueError, match="early stop"):
        pw.stream_h2d_bytes(PRESETS["accurate"], S32, CHUNK)


# ---- (e) the command line's trace ----

def test_device_trace_turns_the_tracer_on_for_its_block(tmp_path):
    i0, i1 = _pair((16, 16, 16))
    with profiling.device_trace(str(tmp_path)):
        assert profiling._ON
        _incore(i0, i1, INCORE["ladder256"])
    assert not profiling._ON
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"tf3d.replay.prep", "tf3d.replay.warp", "tf3d.replay.up"} <= names
    assert profiling.snapshot()["spans"]["tf3d.replay.prep"]["calls"] == 1


# ---- (f) the benchmark's wrap points ----

def test_the_benchmarks_wrap_points_stay():
    """flowbench/system.py wraps these by name (host_split, host_labels,
    replay_counts): moving one moves what the benchmark reads."""
    for m in ("put", "get", "store"):
        assert inspect.isfunction(pw._Stager.__dict__[m])
    assert isinstance(pw._Stager.__dict__["wait"], staticmethod)
    assert list(inspect.signature(graphs._Held._replay).parameters) == [
        "self", "key", "g", "args"]
    for name in ("_solve_level_streamed", "_stream_sor_trapezoid",
                 "_stream_resample", "_stream",
                 "_stream_fused_warp_iteration", "_stream_mg_solve"):
        assert inspect.isfunction(pw.__dict__[name])


# ---- (g) gradient constancy ----

GAMMA = {"ladder256": INCORE["ladder256"].replace(gamma=1.0),
         "accurate": INCORE["accurate"].replace(gamma=1.0)}
GC = ("tf3d.gc.derivs", "tf3d.gc.terms")


def _gc_expected(p, shape):
    """(derivs spans, terms spans, derivs voxels, terms voxels) of one
    pair: one terms build a warp, one system a nonlinearity update."""
    per_level = [int(np.prod(s)) for s in p.level_shapes(shape)]
    n = len(per_level)
    inner = p.inner_iterations
    return (p.warps * n, p.warps * inner * n, p.warps * sum(per_level),
            p.warps * inner * sum(per_level))


@pytest.mark.parametrize("name", list(GAMMA))
def test_gc_spans_and_counters_over_one_pair(name):
    p = GAMMA[name]
    i0, i1 = _pair((16, 16, 16))
    want = _incore(i0, i1, p)
    got = _traced(_incore, i0, i1, p)
    assert torch.equal(got, want)
    snap = profiling.snapshot()
    derivs, terms, dvox, tvox = _gc_expected(p, (16, 16, 16))
    assert snap["spans"]["tf3d.gc.derivs"]["calls"] == derivs
    assert snap["spans"]["tf3d.gc.terms"]["calls"] == terms
    assert snap["counters"]["gc.derivs_voxels"] == dvox
    assert snap["counters"]["gc.terms_voxels"] == tvox
    # 16^3 in two levels: 4096 + 512 voxels.
    assert len(p.level_shapes((16, 16, 16))) == 2
    for k in GC:
        row = snap["spans"][k]
        assert 0.0 <= row["self_seconds"] <= row["seconds"]


@pytest.mark.parametrize("name", list(INCORE))
def test_gamma_0_counts_nothing_of_gc(name):
    _traced(_incore, *_pair((16, 16, 16)), INCORE[name])
    snap = profiling.snapshot()
    assert snap["spans"] and not set(GC) & set(snap["spans"])
    assert not {"gc.derivs_voxels", "gc.terms_voxels"} & set(
        snap["counters"])


def test_counts_apart_are_added_at_each_replay():
    """A capture's counts go apart, whether the tracer is on or off, and
    each replay adds them while it is on."""
    with profiling.counted_apart() as made:
        profiling.count("gc.terms_voxels", 5)
        with profiling.counted_apart() as inner:
            profiling.count("gc.terms_voxels", 2)
        profiling.count("gc.derivs_voxels", 1)
    assert made == {"gc.terms_voxels": 5, "gc.derivs_voxels": 1}
    assert inner == {"gc.terms_voxels": 2}
    profiling.add_counts(made)
    assert profiling.snapshot()["counters"] == {}
    profiling.enable(True)
    with profiling.counted_apart():
        profiling.count("gc.terms_voxels", 100)
    profiling.add_counts(made)
    profiling.add_counts(made)
    assert profiling.snapshot()["counters"] == {"gc.terms_voxels": 10,
                                                "gc.derivs_voxels": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GAMMA))
def test_a_replayed_pair_counts_what_the_eager_one_counts(name):
    """On the card the spans inside a replay do not open; the counters of
    a replayed pair (the graphs captured by a first call) equal those of
    the eager solve ``compute_flow_impl``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from tpuflow3d_torch.pipeline import compute_flow_impl
    p = GAMMA[name]
    dev = torch.device("cuda", 0)
    i0, i1 = (torch.from_numpy(x).to(dev) for x in _pair())
    try:
        compute_flow(i0, i1, p)              # captures the graphs
        replayed = _traced(compute_flow, i0, i1, p)
        torch.cuda.synchronize(dev)
        snap = profiling.snapshot()
        assert "tf3d.replay.warp" in snap["spans"] or \
            "tf3d.replay.pre" in snap["spans"]
        assert not set(GC) & set(snap["spans"])
        counted = snap["counters"]
        profiling.reset()
        eager = _traced(compute_flow_impl, i0, i1, p, HaloCtx())
        torch.cuda.synchronize(dev)
        snap = profiling.snapshot()
        assert counted == snap["counters"]
        _, _, dvox, tvox = _gc_expected(p, S32)
        assert counted == {"gc.derivs_voxels": dvox,
                           "gc.terms_voxels": tvox}
        assert {k: snap["spans"][k]["calls"] for k in GC} == dict(
            zip(GC, _gc_expected(p, S32)[:2]))
        assert torch.equal(replayed, eager)
    finally:
        graphs.clear()


def test_trace_split_reports_no_gc_share_on_the_cpu(tmp_path):
    """``tools/torch_trace_split.py`` runs the gamma cell at 16^3 on the
    CPU: the eager pair's spans and counters are there, and the shares of
    device time are None (no device activity)."""
    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "split.json"
    subprocess.run(
        [sys.executable, str(root / "tools" / "torch_trace_split.py"),
         "--device", "cpu", "--edge", "16", "--rounds", "1",
         "--cells", "gamma-512-incore", "--out", str(out)],
        check=True, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    (cell,) = json.loads(out.read_text())["cells"]
    gc = cell["gc"]
    assert gc["gc_plain_share"] is None and gc["device_s"] == 0.0
    # 16^3 with coarsest_planes 16: one level, 3 warps x 3 inner.
    assert gc["spans"]["tf3d.gc.derivs"]["calls"] == 3
    assert gc["spans"]["tf3d.gc.terms"]["calls"] == 9
    assert gc["counters"] == gc["replayed_counters"] == {
        "gc.derivs_voxels": 3 * 4096, "gc.terms_voxels": 9 * 4096}
