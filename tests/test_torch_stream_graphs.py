"""The streamed mode's compiled slab phases (``piecewise.py`` through
``graphs.stream_runner``).

On a CUDA device every slab phase of ``compute_flow_piecewise``,
``registration_fit_streamed`` and the streamed consistency check is
captured once per (phase, static arguments, slab shapes) into a CUDA graph
and replayed for every slab, its origins (z0, kbase, the resample's output
and input origins) in 0-d int32 tensors on the device. On the CPU the same
phases run directly with the origins in 0-d tensors. These tests hold, on
the CPU at 16^3-32^3:

(a) every slab phase with tensor origins bitwise the same phase with
    Python ints, on slabs below plane 0, inside the volume and past its
    depth, the trapezoid at kbase 0 and past it; ``resize_z_window`` with
    tensor origins;
(b) ``HaloCtx`` with a tensor origin: ``is_whole``, ``==`` and ``hash``
    read no device value, and no phase of a streamed run reads a tensor on
    the host or builds one from host data (what a capture cannot hold);
(c) a streamed entry's bookkeeping, with the CUDA calls replaced so that a
    "capture" runs its phase once with the entry's tensors restored after
    it and a "replay" runs it again: bitwise the direct run, one graph per
    distinct phase key and no more, a second call captures nothing,
    launches count replays only, the arena holds every phase, and a phase
    that reads a tensor that is not the entry's raises.

Marked ``cuda`` (skipped here; on the card, ``PYTHONPATH=src python -m
pytest --noconftest -m cuda tests/test_torch_stream_graphs.py``): graphed
against eager streamed flows, bitwise with equal launches, at 64^3, a
second call capturing nothing, and K1, K2, K5 and K6 in window form with a
device origin bitwise their plain versions.
"""

import contextlib
import weakref
from functools import partial

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpuflow3d_torch import PRESETS, graphs, kernels
from tpuflow3d_torch import piecewise as pw
from tpuflow3d_torch import postproc
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.pyramid import resize_z_window

torch.set_num_threads(2)

SHIFT = (1.5, -1.0, 0.75)
SMALL = dict(levels=2, warps=1)
LADDER = PRESETS["ladder256"].replace(flow_clamp=4.0, **SMALL)
PARAMS = {
    "ladder": LADDER,
    "gamma": LADDER.replace(gamma=1.0),
    "accurate": PRESETS["accurate"].replace(flow_clamp=4.0, **SMALL),
}
D, HW = 32, (12, 16)
CHUNK = 8


def _rand(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * np.float32(scale)


def _slab(x, lo, size):
    """The stager's slab of x at lo (faces replicated), as a tensor."""
    st = pw._Stager(torch.device("cpu"), None)
    return st.put(np.ascontiguousarray(x), lo, size)


def _o(v):
    return torch.tensor(v, dtype=torch.int32)


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- (a) tensor origins give the bits of int origins ----

# Slab origins: the first (below plane 0), an interior one, the last (past
# the depth), for slabs of CHUNK + 2 * margin planes.
def _origins(margin):
    return (-margin, 2 * CHUNK - margin, D - CHUNK - margin + 3)


def _volumes(seed=0):
    i0 = _rand(seed, D, *HW)
    i1 = np.roll(i0, 1, axis=0) + 0.1 * _rand(seed + 1, D, *HW)
    flow = _rand(seed + 2, 3, D, *HW, scale=1.5)
    du = _rand(seed + 3, 3, D, *HW, scale=0.05)
    return i0, i1, np.clip(flow, -4.0, 4.0), du


@pytest.mark.parametrize("name", list(PARAMS))
def test_warp_terms_and_fit_phases_take_tensor_origins(name):
    p = PARAMS[name]
    i0, i1, flow, du = _volumes()
    mw = pw.stream_margin(p)
    size = CHUNK + 2 * mw
    for lo in _origins(mw):
        s0, s1, sf, sd = (_slab(x, lo, size) for x in (i0, i1, flow, du))
        phases = [partial(pw._ph_fit, dg=D, p=p)]
        if p.gamma > 0.0:
            phases += [partial(pw._ph_terms_gc, dg=D, p=p, mg=m)
                       for m in (False, True)]
            args = (s0, s1, sf, sd)
        else:
            phases.append(partial(pw._ph_warp_deriv, dg=D, p=p))
            args = (s0, s1, sf)
        for ph in phases:
            a = args if ph.func is not pw._ph_fit else (s0, s1, sf)
            _same(ph(*a, _o(lo)), ph(*a, lo))
        if p.gamma > 0.0:
            continue
        g, it = pw._ph_warp_deriv(s0, s1, sf, lo, D, p)
        term = pw._ph_terms_mg if p.solver == "multigrid" else pw._ph_terms
        _same(term(g, it, sf, sd, _o(lo), D, p), term(g, it, sf, sd, lo, D, p))


def _terms_slabs(p, lo, size, seed=0):
    """Sweep constants of a slab as the phases make them (rank-1: c, g,
    psi_s, psi_d; gamma: c, psi_s, ainv; multigrid: c, psi_s, d6)."""
    i0, i1, flow, du = _volumes(seed)
    s0, s1, sf, sd = (_slab(x, lo, size) for x in (i0, i1, flow, du))
    if p.gamma > 0.0:
        return sd, pw._ph_terms_gc(s0, s1, sf, sd, lo, D, p)
    g, it = pw._ph_warp_deriv(s0, s1, sf, lo, D, p)
    if p.solver == "multigrid":
        return sd, pw._ph_terms_mg(g, it, sf, sd, lo, D, p)
    c, pss, psd = pw._ph_terms(g, it, sf, sd, lo, D, p)
    return sd, (c, g, pss, psd)


@pytest.mark.parametrize("name", list(PARAMS))
def test_sweep_phases_take_tensor_origins(name):
    p = PARAMS[name]
    sweeps = 3
    size = CHUNK + 2 * sweeps + 2
    for k, lo in enumerate((-CHUNK - 1, CHUNK - 1, D - 1)):
        kbase = k * CHUNK if lo < D - 1 else D
        du, terms = _terms_slabs(p, lo, size)
        if p.solver == "multigrid":
            ph = partial(pw._ph_mg_trapezoid, dg=D, p=p, sweeps=sweeps,
                         chunk=CHUNK)
            _same(ph(du, *terms, _o(lo), _o(kbase)),
                  ph(du, *terms, lo, kbase))
            res = partial(pw._ph_mg_residual, dg=D, p=p)
            _same(res(du, *terms, _o(lo)), res(du, *terms, lo))
            continue
        ph = partial(pw._ph_sor_trapezoid, dg=D, p=p, sweeps=sweeps,
                     chunk=CHUNK)
        _same(ph(du, *terms, _o(lo), _o(kbase)), ph(du, *terms, lo, kbase))
        for color in (0, 1):
            half = partial(pw._ph_halfsweep, dg=D, p=p, color=color)
            _same(half(du, *terms, _o(lo)), half(du, *terms, lo))
        jac = partial(pw._ph_jacobi, dg=D, p=p.replace(solver="jacobi"))
        _same(jac(du, *terms, _o(lo)), jac(du, *terms, lo))


def test_trapezoid_launch_zero_rule_with_tensor_kbase():
    """Launch 0's frontier starts at plane 0 even where 2S > chunk + j (the
    virtual predecessor frontier would be past it), for a device kbase."""
    p = LADDER
    sweeps = 6   # 2S = 12 > CHUNK + 1
    size = CHUNK + 2 * sweeps + 2
    lo = -CHUNK - 1
    du, terms = _terms_slabs(p, lo, size, seed=4)
    ph = partial(pw._ph_sor_trapezoid, dg=D, p=p, sweeps=sweeps, chunk=CHUNK)
    for kbase in (0, CHUNK):
        _same(ph(du, *terms, _o(lo), _o(kbase)), ph(du, *terms, lo, kbase))
    assert not torch.equal(ph(du, *terms, lo, 0), ph(du, *terms, lo, CHUNK))


@pytest.mark.parametrize("gamma", [0.0, 1.0])
def test_fused_phase_takes_tensor_origins(gamma):
    p = LADDER.replace(inner_iterations=1, gamma=gamma)
    i0, i1, flow, _ = _volumes(seed=5)
    mw = pw.stream_margin(p)
    size, los = pw._wave_slabs(D, CHUNK, 2 * p.sweeps, mw)
    carry = torch.from_numpy(_rand(6, 3, 2 * p.sweeps + 2, *HW, scale=0.05))
    ph = partial(pw._ph_fused_warp_iter, dg=D, p=p, sweeps=p.sweeps,
                 chunk=CHUNK)
    for k in (0, 2, len(los) - 1):
        lo = los[k]
        s = [_slab(x, lo, size) for x in (i0, i1, flow)]
        _same(ph(*s, carry, _o(lo), _o(k * CHUNK)),
              ph(*s, carry, lo, k * CHUNK))


def test_median_smooth_resample_and_consistency_take_tensor_origins():
    i0, _, flow, du = _volumes(seed=7)
    for lo in _origins(1):
        s = _slab(du, lo, CHUNK + 2)
        _same(pw._ph_median(s, _o(lo), LADDER), pw._ph_median(s, lo, LADDER))
        _same(pw._ph_smooth(s, _o(lo), 1.0), pw._ph_smooth(s, lo, 1.0))
    # The pyramid's downsample (smoothed) and the flow's upsample.
    for x, out, sigma in ((i0, (16, 6, 8), 1.0), (flow[:, :16, :6, :8],
                                                  (D, *HW), 0.0)):
        din, dout = x.shape[-3], out[0]
        scale = din / dout
        r = 0 if sigma <= 0 else (len(pw.gaussian_kernel1d(sigma)) - 1) // 2
        win = int(np.ceil(CHUNK * scale)) + 2 * r + 4
        ph = partial(pw._ph_resample, sigma=sigma, out_len=CHUNK,
                     scale=scale, in_global=din, out_hw=out[1:])
        for o0 in range(0, dout, CHUNK):
            a = int(np.floor((o0 + 0.5) * scale - 0.5)) - 1 - r
            s = _slab(x, a, win)
            _same(ph(s, _o(o0), _o(a)), ph(s, o0, a))
    bwd = -flow
    for lo in _origins(6):
        f, b = _slab(flow, lo, CHUNK + 12), _slab(bwd, lo, CHUNK + 12)
        for interp in ("trilinear", "tricubic"):
            ph = partial(postproc._consistency_slab, dg=D, interp=interp)
            _same(ph(f, b, _o(lo)), ph(f, b, lo))


def test_resize_z_window_takes_tensor_origins():
    x = torch.from_numpy(_rand(8, 3, 21, 5, 6))
    for out_len, z0_out, z0_in, scale, in_global in (
            (8, 0, -5, 2.0, 40), (8, 8, 10, 2.0, 40), (8, 16, 27, 2.0, 40),
            (8, 24, 5, 0.5, 16), (6, 35, 13, 0.4, 20)):
        _same(resize_z_window(x, out_len, _o(z0_out), _o(z0_in), 0, scale,
                              in_global),
              resize_z_window(x, out_len, z0_out, z0_in, 0, scale,
                              in_global))


# ---- (b) no host reads ----

class _NoHost(TorchDispatchMode):
    """Raises on what a CUDA graph cannot capture: a tensor read on the host
    (``.item()``, ``bool()``, ``int()``) and a tensor built from host data
    (``torch.tensor``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.lift_fresh.default):
            raise AssertionError(f"host read or host data: {func}")
        return func(*args, **(kwargs or {}))


def test_a_window_with_a_tensor_origin_reads_no_device_value():
    z0, other = _o(-3), _o(-3)
    ctx = HaloCtx(window_z0=z0, window_d_global=D)
    with _NoHost():
        assert not ctx.is_whole(D)
        assert ctx == HaloCtx(window_z0=z0, window_d_global=D)
        assert ctx != HaloCtx(window_z0=other, window_d_global=D)
        assert ctx != HaloCtx(window_z0=-3, window_d_global=D)
        hash(ctx)
        ctx.z_global(4)
    with pytest.raises(AssertionError, match="host read"), _NoHost():
        bool(z0 == 0)
    # An int window is whole only where it is the volume.
    assert HaloCtx(window_z0=0, window_d_global=D).is_whole(D)
    assert not HaloCtx(window_z0=-1, window_d_global=D).is_whole(D)


class _Checked(graphs._StreamDirect):
    """The CPU's direct runner with every phase call under ``_NoHost``
    (the origins made outside it, as the card fills them outside its
    graphs); records each phase's key."""

    def __init__(self):
        super().__init__(torch.device("cpu"), tensors=True)
        self.keys = set()

    def phase(self, fn, shapes):
        inner = super().phase(fn, shapes)
        self.keys.add(graphs._phase_key(fn, tuple(map(tuple, shapes))))
        run_fn = inner.fn

        def checked(*a):
            with _NoHost():
                return run_fn(*a)
        inner.fn = checked
        return inner


@pytest.mark.parametrize("name, fuse", [("ladder", True), ("ladder", False),
                                        ("gamma", False), ("accurate", True)])
def test_streamed_phases_make_no_host_reads(monkeypatch, name, fuse):
    p = PARAMS[name].replace(inner_iterations=1) if fuse else PARAMS[name]
    run = _Checked()
    monkeypatch.setattr(graphs, "stream_runner", lambda *a, **k: run)
    i0, i1, _ = syn.make_pair((16, 12, 12), syn.translation(SHIFT), seed=0)
    pw.compute_flow_piecewise(i0, i1, p, chunk_z=CHUNK, device="cpu",
                              fuse=fuse)
    assert run.keys


# ---- (c) a streamed entry's bookkeeping on CPU tensors ----

class _Recorded:
    def __init__(self, fn, args, carry, outs):
        self.fn, self.args, self.carry, self.outs = fn, args, carry, outs

    def replay(self):
        with kernels.counted_apart():
            graphs._copy_tree(self.outs, graphs._carried(
                self.fn(*self.args), self.carry))


@pytest.fixture
def recorded(monkeypatch):
    """graphs' CUDA calls replaced so that a streamed entry works on CPU
    tensors: a capture runs the phase once (its host code, its launches)
    and leaves every tensor of the entry as it was; each replay runs it
    again. ``graphs.stream_runner`` makes such an entry for the CPU."""
    captured = []

    def capture(fn, args, carry, pool, stream):
        (entry,) = graphs._ENTRIES.values()
        held = list(entry.outside.values())
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

    def runner(key, device, eager=False, arena=0):
        if eager:
            return graphs._StreamDirect(torch.device("cpu"), True)
        k = ("stream", key, torch.device("cpu"))
        if k not in graphs._ENTRIES:
            graphs._ENTRIES.clear()
            graphs._ENTRIES[k] = graphs._StreamEntry(k, torch.device("cpu"),
                                                     arena)
        return graphs._ENTRIES[k]

    monkeypatch.setattr(graphs, "_capture_graph", capture)
    monkeypatch.setattr(graphs, "stream_runner", runner)
    monkeypatch.setattr(torch.cuda, "MemPool", _Pool)
    monkeypatch.setattr(torch.cuda, "use_mem_pool",
                        lambda pool, device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "on_device",
                        lambda d: contextlib.nullcontext())
    yield captured
    graphs._ENTRIES.clear()


def _direct(p, i0, i1, **kw):
    return pw.compute_flow_piecewise(i0, i1, p, chunk_z=CHUNK, device="cpu",
                                     **kw)


@pytest.mark.parametrize("name, kw", [("ladder", {}),
                                      ("ladder", {"fuse": False}),
                                      ("accurate", {})])
def test_entry_replays_the_direct_flow(monkeypatch, recorded, name, kw):
    p = PARAMS[name].replace(inner_iterations=1, warps=2)
    i0, i1, _ = syn.make_pair((16, 16, 16), syn.translation(SHIFT), seed=0)
    keys = _Checked()
    with monkeypatch.context() as m:
        m.setattr(graphs, "stream_runner", lambda *a, **k: keys)
        want = _direct(p, i0, i1, **kw)
    first = _direct(p, i0, i1, **kw)
    assert np.array_equal(first, want)
    (entry,) = graphs._ENTRIES.values()
    # One graph per distinct phase key (the JAX package's compile count):
    # every warp iteration and slab replays the graphs of its level.
    n = len(recorded)
    assert n == len(entry.graphs) == len(keys.keys) == entry.stats["captures"]
    assert entry.stats["replays"] > n
    # The same key again: nothing captured anew, the same bits; the fit
    # of the flow joins the entry of a solve of the default passes with
    # one graph.
    j0, j1, _ = syn.make_pair((16, 16, 16), syn.translation(SHIFT), seed=1)
    other = _direct(p, j0, j1, **kw)
    assert len(recorded) == n
    assert np.array_equal(other, _direct(p, j0, j1, eager=True, **kw))
    if kw:
        return
    fit = pw.registration_fit_streamed(i0, i1, first, p, CHUNK, device="cpu")
    assert len(recorded) == n + 1 and list(graphs._ENTRIES) == [entry.key]
    with monkeypatch.context() as m:
        m.setattr(graphs, "stream_runner", lambda *a, **k: keys)
        assert fit == pw.registration_fit_streamed(i0, i1, first, p, CHUNK,
                                                   device="cpu")


def test_entry_counts_replays_by_phase(monkeypatch, recorded):
    """A streamed entry's ``replays_by_key`` names each graph by its
    phase and slab shapes, and sums to ``replays``."""
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    p = PARAMS["ladder"].replace(inner_iterations=2)
    i0, i1, _ = syn.make_pair((16, 16, 16), syn.translation(SHIFT), seed=0)
    _direct(p, i0, i1)
    (info,) = graphs.entries().values()
    by_key = info["replays_by_key"]
    assert sum(by_key.values()) == info["replays"]
    assert len(by_key) == info["graphs"]
    names = {name for name, _ in by_key}
    assert names == {"smooth", "resample", "warp_deriv", "terms",
                     "sor_trapezoid", "median"}
    # Two levels of 16 and 8 planes, chunks of 8: the median runs 2 + 1
    # slabs a warp.
    assert sum(v for (name, _), v in by_key.items()
               if name == "median") == 3 * p.warps


def test_entry_counts_replayed_launches_only(monkeypatch, recorded):
    real = pw._ph_median

    def launching(dus, z0, p):
        kernels.LAUNCHES["median3"] += 1   # what a wrapper does per launch
        return real(dus, z0, p)

    monkeypatch.setattr(pw, "_ph_median", launching)
    p = PARAMS["ladder"]
    i0, i1, _ = syn.make_pair((16, 16, 16), syn.translation(SHIFT), seed=0)
    kernels.reset_launches()
    _direct(p, i0, i1)
    # Two levels of 16 and 8 planes, chunks of 8: 2 + 1 median slabs.
    assert kernels.LAUNCHES["median3"] == 3
    (entry,) = graphs._ENTRIES.values()
    assert entry.stats["warmup_launches"] == 2   # one per level's graph
    _direct(p, i0, i1)
    assert kernels.LAUNCHES["median3"] == 6
    kernels.reset_launches()


def test_entry_arena_and_foreign_tensors(recorded):
    p = PARAMS["gamma"]
    i0, i1, _ = syn.make_pair((16, 16, 16), syn.translation(SHIFT), seed=0)
    _direct(p, i0, i1)
    (entry,) = graphs._ENTRIES.values()
    assert entry.arena.numel() == pw.stream_arena(p, i0.shape, CHUNK)
    # A phase whose slabs pass the arena raises.
    with pytest.raises(RuntimeError, match="arena"):
        entry.phase(partial(pw._ph_median, p=p),
                    [(3, entry.arena.numel(), 1, 1)])
    # A phase that reads a tensor of its own, not the entry's, raises and
    # drops the entry.
    ph = entry.phase(partial(pw._ph_median, p=p), [(3, 4, 4, 4)])
    with pytest.raises(RuntimeError, match="entry's tensors"):
        ph([torch.zeros(3, 4, 4, 4)], (0,))
    assert graphs._ENTRIES == {}
    # Nothing but the cache holds an entry (no reference cycle leaves its
    # graphs to the garbage collector, which may run inside a capture).
    dropped = weakref.ref(entry)
    del entry, ph
    assert dropped() is None


def test_consistency_error_through_an_entry(monkeypatch, recorded):
    fwd = np.clip(_rand(9, 3, 20, 8, 8), -2, 2)
    bwd = -fwd + 0.05 * _rand(10, 3, 20, 8, 8)
    with monkeypatch.context() as m:
        m.setattr(graphs, "stream_runner", lambda *a, **k: _Checked())
        want = postproc.consistency_error(fwd, bwd, chunk_z=8, device="cpu")
    got = postproc.consistency_error(fwd, bwd, chunk_z=8, device="cpu")
    assert np.array_equal(got, want) and len(recorded) == 1


# A plane of 20 x 21 floats is no multiple of the arena's alignment, and a
# depth of 20 pads to 24 under a z_multiple of 8 (the ladder512 presets').
ODD = (20, 20, 21)


@pytest.mark.parametrize("name, kw", [("ladder", {}),
                                      ("ladder", {"fuse": False}),
                                      ("gamma", {}), ("accurate", {})])
def test_entry_arena_holds_unaligned_slabs(recorded, name, kw):
    p = PARAMS[name].replace(z_multiple=8)
    i0, i1, _ = syn.make_pair(ODD, syn.translation(SHIFT), seed=0)
    got = _direct(p, i0, i1, **kw)
    assert got.shape == (3, *ODD) and np.isfinite(got).all()
    (entry,) = graphs._ENTRIES.values()
    assert entry.arena.numel() == pw.stream_arena(p, (24, 20, 21), CHUNK,
                                                  **kw)
    if kw:
        return
    # The fit of the flow, on the unpadded volume, joins the solve's entry.
    n = len(recorded)
    pw.registration_fit_streamed(i0, i1, got, p, CHUNK, device="cpu")
    assert len(recorded) == n + 1 and list(graphs._ENTRIES) == [entry.key]


def test_consistency_error_on_unaligned_planes(monkeypatch, recorded):
    fwd = np.clip(_rand(11, 3, *ODD), -2, 2)
    bwd = -fwd + 0.05 * _rand(12, 3, *ODD)
    with monkeypatch.context() as m:
        m.setattr(graphs, "stream_runner", lambda *a, **k: _Checked())
        want = postproc.consistency_error(fwd, bwd, chunk_z=8, device="cpu")
    got = postproc.consistency_error(fwd, bwd, chunk_z=8, device="cpu")
    assert np.array_equal(got, want) and len(recorded) == 1


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


CARD_PATHS = {
    "ladder256": PRESETS["ladder256"].replace(flow_clamp=4.0),
    "fused": PRESETS["ladder256"].replace(flow_clamp=4.0, inner_iterations=1),
    "gamma": PRESETS["ladder256"].replace(flow_clamp=4.0, gamma=1.0),
    "accurate": PRESETS["accurate"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_PATHS))
def test_graphed_streamed_flow_is_the_eager_flow(dev, name):
    p = CARD_PATHS[name]
    i0, i1, _ = syn.make_pair((64, 64, 64), syn.translation(SHIFT), seed=0)
    graphs.clear()
    kernels.reset_launches()
    eager = pw.compute_flow_piecewise(i0, i1, p, chunk_z=16, device=dev,
                                      eager=True)
    n_eager = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    graphed = pw.compute_flow_piecewise(i0, i1, p, chunk_z=16, device=dev)
    assert dict(kernels.LAUNCHES) == n_eager
    assert np.array_equal(graphed, eager)
    (info,) = graphs.entries().values()
    assert info["kind"] == "stream" and info["captures"] == info["graphs"]
    again = pw.compute_flow_piecewise(i0, i1, p, chunk_z=16, device=dev)
    (info2,) = graphs.entries().values()
    assert info2["captures"] == info["captures"]
    assert np.array_equal(again, graphed)
    graphs.clear()
    assert graphs.entries() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ladder256", "accurate"])
def test_graphed_streamed_flow_on_unaligned_planes(dev, name):
    """A 20 x 21 plane (no multiple of the arena's alignment) and a depth
    that pads: graphed bitwise eager, the fit joining the solve's entry,
    the consistency check graphed."""
    p = CARD_PATHS[name].replace(z_multiple=8)
    shape = (36, *ODD[1:])
    i0, i1, _ = syn.make_pair(shape, syn.translation(SHIFT), seed=0)
    graphs.clear()
    eager = pw.compute_flow_piecewise(i0, i1, p, chunk_z=16, device=dev,
                                      eager=True)
    graphed = pw.compute_flow_piecewise(i0, i1, p, chunk_z=16, device=dev)
    assert np.array_equal(graphed, eager)
    (key,) = graphs.entries()
    pw.registration_fit_streamed(i0, i1, graphed, p, 16, device=dev)
    assert list(graphs.entries()) == [key]
    err = postproc.consistency_error(graphed, -graphed, chunk_z=16,
                                     device=dev)
    assert err.shape == shape and np.isfinite(err).all()
    graphs.clear()


@pytest.mark.cuda
def test_window_forms_with_a_device_origin_are_bitwise_plain(dev):
    from tpuflow3d_torch.derivatives import derivatives
    from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
    from tpuflow3d_torch.kernels.sor_gc import sor_halfsweep_gc as k_sor_gc
    from tpuflow3d_torch.kernels.warp_grad import warp_grad as k_warp_grad
    from tpuflow3d_torch.solver import parity_mask, sor_halfsweep
    from tpuflow3d_torch.warp import warp_volume

    planes, h, w = 20, 33, 40
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    for lo in (-6, 11, 40):
        z0 = torch.tensor(lo, dtype=torch.int32, device=dev)
        ctx_t = HaloCtx(window_z0=z0, window_d_global=48)
        ctx_i = HaloCtx(window_z0=lo, window_d_global=48)
        i0s, i1s = rnd(planes, h, w), rnd(planes, h, w)
        fls = rnd(3, planes, h, w, scale=3.0)
        for interp in ("trilinear", "tricubic"):
            got = k_warp_grad(i1s, fls, i0s, ctx_t, interp=interp,
                              emit_warped=True)
            i1w = warp_volume(i1s, fls, ctx_t, interp=interp)
            _same(got, (*derivatives(i0s, i1w, ctx_t), i1w))
            _same(got, k_warp_grad(i1s, fls, i0s, ctx_i, interp=interp,
                                   emit_warped=True))
        for p in (LADDER, LADDER.replace(gamma=1.0)):
            du, sl = _terms_slabs_dev(p, lo, planes, h, w, dev)
            t = pw._slab_terms(sl, p, ctx_t)
            parity = parity_mask((planes, h, w), ctx_t, dev)
            for color in (0, 1):
                if p.gamma > 0.0:
                    got = k_sor_gc(du, t, (p.alpha,) * 3, p.omega, color,
                                   ctx_t)
                else:
                    got = k_sor(du, t, p.alpha, p.omega, color, ctx_t)
                _same(got, sor_halfsweep(du, t, p.omega, parity, color,
                                         ctx_t))


def _terms_slabs_dev(p, lo, planes, h, w, dev):
    gen = np.random.default_rng(lo + 100)
    i0 = torch.from_numpy(gen.standard_normal((planes, h, w)).astype(
        np.float32)).to(dev)
    i1 = torch.roll(i0, 1, 0)
    fl = torch.from_numpy(np.clip(gen.standard_normal((3, planes, h, w)),
                                  -2, 2).astype(np.float32)).to(dev)
    du = torch.from_numpy(0.05 * gen.standard_normal((3, planes, h, w)).astype(
        np.float32)).to(dev)
    if p.gamma > 0.0:
        return du, pw._ph_terms_gc(i0, i1, fl, du, lo, 48, p)
    g, it = pw._ph_warp_deriv(i0, i1, fl, lo, 48, p)
    c, pss, psd = pw._ph_terms(g, it, fl, du, lo, 48, p)
    return du, (c, g, pss, psd)
