"""Compiled dispatch: the runners that run a segment of the solve, replayed
from the CUDA graph it was captured into once, or called directly.

Counterpart of the compiled programs of ``tpuflow3d.pipeline``
(``_compute_flow_jit``, ``_prep_fn_cached``, ``_warp_fn_cached``,
``_upsample_fn_cached``, ``_level_fn_cached``). There the whole
coarse-to-fine solve is one program; PyTorch launches each operation from
the host, so the in-core level loop (``pipeline.drive``, which owns the
segments and their order) runs each segment through a runner:
``run(key, fn, args, carry)`` runs ``fn`` on ``args`` and returns its
results, a graph's with each that ``carry`` gives a tensor for copied into
that tensor, and ``run.zeros(key, ...)`` gives a tensor a graph keeps
between calls. This module knows nothing of what a segment computes
(but for ``_warp``, below). ``solve`` picks the runner of the volumes'
device: on a CUDA device the in-core entry of the call's key, which
captures each segment at its first call and replays it after; elsewhere
``Direct``, which calls the segments one after another
(``pipeline.compute_flow_impl`` takes ``Direct`` on any device: the
Z-sharded ranks, and the witness a graphed solve is held to).

A cache entry is keyed by (params, the padded global shape, the device,
whether residuals are tracked) and holds the captured graphs, the static
inputs and each level's flow (allocated outside the graphs), and the
graphs' results. The graphs share one memory pool, a
``torch.cuda.MemPool`` (not a bare graph pool handle: the warm-ups below
allocate from it too). A result made inside a capture stays where the
capture put it, held by the entry, and a segment whose result
feeds the next warp iteration or level copies it into that tensor (the
flow, the iterate, the frozen system of the next inner iteration). A
result may sit in blocks that a segment captured before it uses inside its
replays; it is safe because a segment reads results of the pyramids'
segment (captured first) or of its own level's segments only, and no
segment of another level replays while a level is solved (the entry
checks the first rule at each capture). Before a segment is first captured
it runs once eagerly on a side stream (the warm-up: the first launch of a
kernel may load its module, which a capture cannot), its memory from the
graphs' pool, and its results are thrown away. Allocated elsewhere, a
warm-up of the finest level would need its working set beside the pool's
free blocks (gradient constancy at 512^3 ran out of the card's 80 GB so).
A capture that fails raises: nothing runs eagerly in place of a graph.

Launch counts (``kernels.LAUNCHES``): a graph records the launches its
capture made, each replay adds them, and neither the warm-up nor the
capture counts, so a graphed solve counts what the eager one does. The
tracer's counters (``utils.profiling.count``) are kept so as well
(``profiling.counted_apart``, ``add_counts``).

The streamed mode (``piecewise.py``, and the streamed consistency check of
``postproc.py``) is the counterpart of the JAX package's jitted slab
phases (static slab shapes, z0 traced). The copies between host and device
stay outside the graphs; the compute between them, one slab phase, is
captured once per (phase, its static arguments, the slab shapes) into a
graph of a streamed entry (``stream_runner``) and replayed for every slab
of every pass. The slab's origin (z0, the wavefront's kbase, the
resample's output and input origins) lives in 0-d int32 tensors on the
device that the host fills (``Tensor.fill_``) before each replay, the
counterpart of ``jnp.int32(lo)``; the host copies each slab from its
page-locked staging buffer straight into the graph's static inputs and
copies the results back from its outputs. Every tensor a streamed phase
reads or leaves is the entry's, outside the pool: the static inputs and
results (views of one arena that all phases share, so the streaming loops
start a result's copy to the host before the next replay), the origins
and the buffers that outlive a replay (the fused pass's carried band, the
streamed multigrid's coarse inputs, residual and correction). On the
CPU (and, with ``eager``, on a CUDA device as the witness a graphed run is
held to) the phases are called directly: with the origins in 0-d tensors
on the CPU, as the card's graphs read them, with Python ints eagerly on
the card.

Capturing an entry (of either kind) with a new key drops every other entry
on that device first; ``clear`` drops them on request.
"""

from __future__ import annotations

import functools
import gc
import math
import time
import weakref
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from tpuflow3d_torch import kernels
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.utils import profiling

# The warp segment on the whole volume, ``(i0l, i1l, flow, slot, p) ->
# (flow,)``: ``pipeline`` sets it and its loop calls it from here, the
# point where the benchmark's fault controls plant a warp that changes
# nothing. Nothing in this module calls it.
_warp = None


def solve(loop, i0, i1, p: FlowParams, track: bool):
    """``loop(run, i0, i1, p, track=track)`` (``pipeline.drive`` with its
    other arguments bound) through the runner of the volumes' device: on a
    CUDA device the entry of (p, shape, device, track), the volumes copied
    into its static inputs and the flow cloned out of it; elsewhere
    ``Direct``. Returns the loop's (flow, residuals). The benchmark's
    fault controls wrap this function."""
    if i0.device.type != "cuda":
        return loop(Direct(), i0, i1, p, track=track)
    with torch.cuda.device(i0.device):
        run = _entry(p, tuple(i0.shape), i0.device, track)
        flow, residuals = loop(run, *run.inputs(i0, i1), p, track=track)
        return flow.clone(), residuals


def _copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at its place in
    ``dst`` (two trees of one structure)."""
    for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(s)


def _carried(outs, carry):
    """``outs`` with each output that ``carry`` gives a destination for
    copied into it and replaced by it."""
    if carry is None:
        return outs
    outs = list(outs)
    for i, dst in enumerate(carry):
        if dst is not None:
            _copy_tree(dst, outs[i])
            outs[i] = dst
    return tuple(outs)


def _span_name(segment: str) -> str:
    """The tracer's span of a segment's replays (or direct calls)."""
    return f"tf3d.replay.{segment}"


class Direct:
    """The segments called one after another: a device without graphs, the
    Z-sharded ranks, the eager witness. A result is returned as the
    segment made it (``carry`` names tensors only a graph keeps), so what
    the loop no longer holds is freed at once."""

    def __call__(self, key, fn, args, carry=None):
        with profiling.span(_span_name(key[0])):
            return fn(*args)

    def zeros(self, key, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


# ---- the graphs ----

class _Graph(NamedTuple):
    graph: object      # a torch.cuda.CUDAGraph
    args: list         # the tensors it reads, as captured
    outs: tuple        # its results, the carried ones in their destinations
    launches: dict     # the kernel launches of one replay
    counts: dict       # the tracer's counts of one replay
    label: tuple       # its key in ``replays_by_key``
    span: str          # the tracer's span around its replays


def _level(key) -> int | None:
    """The pyramid level a segment works on (None: the pyramids)."""
    return key[1] if len(key) > 1 else None


class _Held:
    """What an entry of either kind holds: its graphs, their memory pool,
    the side stream they are captured on, the tensors allocated outside the
    pool (``outside``) and the counts ``info`` reports."""

    kind = ""

    def __init__(self, key, device):
        self.key, self.device = key, device
        # The graphs' memory pool, which the warm-ups allocate from too:
        # they reuse its free blocks instead of holding their own beside it.
        self.pool = torch.cuda.MemPool()
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict = {}
        self.outside: dict = {}
        self.stats = {"captures": 0, "capture_seconds": 0.0, "replays": 0,
                      "replays_by_key": {}, "warmup_launches": 0}

    def label(self, key) -> tuple:
        """How ``replays_by_key`` names the graph of ``key``: the segment
        and its level (in core), the phase and its slab shapes
        (streamed)."""
        return key

    def _record(self, key, fn, args, carry) -> _Graph:
        """Warm ``fn`` up on ``args`` on the side stream (its memory from
        the pool, its results thrown away), then capture it: its graph.
        ``carry`` may be a function of the warm-up's results that gives
        it. A failure drops the entry, so nothing half-captured stays
        behind, and raises."""
        def tupled(*a):
            return _outputs(fn(*a))

        try:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream), \
                    torch.cuda.use_mem_pool(self.pool, self.device):
                with kernels.counted_apart() as warm_launches, \
                        profiling.counted_apart():
                    outs = tupled(*args)
            if callable(carry):
                carry = carry(outs)
            del outs
            self.stats["warmup_launches"] += sum(warm_launches.values())
            t0 = time.perf_counter()
            with kernels.counted_apart() as launches, \
                    profiling.counted_apart() as counts:
                graph, outs = _capture_graph(tupled, args, carry,
                                             self.pool.id, self.stream)
        except BaseException:
            _ENTRIES.pop(self.key, None)
            raise
        self.stats["captures"] += 1
        self.stats["capture_seconds"] += time.perf_counter() - t0
        label = self.label(key)
        g = self.graphs[key] = _Graph(graph, _tensors(args), outs, launches,
                                      counts, label, _span_name(label[0]))
        return g

    def _replay(self, key, g: _Graph, args) -> tuple:
        leaves = _tensors(args)
        if len(leaves) != len(g.args) or any(
                a is not b for a, b in zip(leaves, g.args)):
            raise RuntimeError(f"graph {key}: called on other tensors than "
                               f"it was captured with")
        with profiling.span(g.span):
            g.graph.replay()
        kernels.add_launches(g.launches)
        profiling.add_counts(g.counts)
        self.stats["replays"] += 1
        by_key = self.stats["replays_by_key"]
        by_key[g.label] = by_key.get(g.label, 0) + 1
        return g.outs

    def static_bytes(self) -> int:
        """Bytes of the tensors the entry holds outside the graphs' pool."""
        return sum(t.numel() * t.element_size()
                   for t in self.outside.values())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' pool holds (the allocator's segments of
        that pool): the graphs' results and what lives inside a replay."""
        pool = tuple(self.pool.id)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool
                   and s["device"] == self.device.index)

    def info(self) -> dict:
        return {"kind": self.kind, "graphs": len(self.graphs), **self.stats,
                "replays_by_key": dict(self.stats["replays_by_key"]),
                "static_bytes": self.static_bytes(),
                "pool_bytes": self.pool_bytes()}


class _Entry(_Held):
    """The captured segments of one (params, shape, device, track) key, and
    the tensors they read and write: the static inputs and the tensors of
    ``zeros``, allocated outside the graphs, and the graphs' results, in
    their pool."""

    kind = "incore"

    def __init__(self, key, p: FlowParams, shape, device):
        super().__init__(key, device)
        dtype = getattr(torch, p.dtype)
        self.i0 = torch.empty(shape, dtype=dtype, device=device)
        self.i1 = torch.empty(shape, dtype=dtype, device=device)
        self.outside.update(i0=self.i0, i1=self.i1)
        # id of every tensor a segment may read -> the segment that makes
        # it (None: made outside the graphs)
        self.maker: dict = {id(self.i0): None, id(self.i1): None}

    def inputs(self, i0, i1):
        """The call's volumes copied into the static inputs."""
        self.i0.copy_(i0)
        self.i1.copy_(i1)
        return self.i0, self.i1

    def zeros(self, key, shape, dtype, device):
        """A static tensor of zeros made at the first call for ``key``."""
        t = self.outside.get(key)
        if t is None:
            t = self.outside[key] = torch.zeros(shape, dtype=dtype,
                                                device=device)
            self.maker[id(t)] = None
        return t

    def __call__(self, key, fn, args, carry=None):
        g = self.graphs.get(key)
        if g is None:
            self._check(key, args, carry)
            g = self._record(key, fn, args, carry)
            for t in _tensors(g.outs):
                self.maker.setdefault(id(t), key)
        return self._replay(key, g, args)

    def _check(self, key, args, carry) -> None:
        # A result stays in the pool, whose blocks the graphs captured
        # before may use inside their replays: so a segment reads results
        # of the pyramids' segment (captured first) or of its own level's
        # segments only, which are captured before it and none of which
        # replays while another level is solved.
        for t in _tensors(args) + _tensors(carry):
            if id(t) not in self.maker:
                _ENTRIES.pop(self.key, None)
                raise RuntimeError(f"graph {key}: its inputs must be the "
                                   f"entry's tensors")
            maker = self.maker[id(t)]
            if maker is not None and maker != ("prep",) and \
                    _level(maker) != _level(key):
                _ENTRIES.pop(self.key, None)
                raise RuntimeError(f"graph {key} reads a result of {maker}")


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _capture_graph(fn, args, carry, pool, stream):
    """Segment ``fn`` on ``args``, its carried results copied into their
    destinations, captured into a CUDA graph on ``stream`` with its memory
    from ``pool``: (the graph, the results)."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(stream.device)
    # No garbage collection inside the capture: freeing an object that
    # holds CUDA resources (an event, a page-locked buffer, another graph)
    # there would invalidate it.
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            outs = _carried(fn(*args), carry)
    except BaseException:
        # A capture that fails at its end leaves the capture stream current.
        torch.cuda.set_stream(current)
        raise
    finally:
        if collecting:
            gc.enable()
    return graph, outs


_ENTRIES: dict = {}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _entry(p: FlowParams, shape, device, track: bool) -> _Entry:
    device = _device(device)
    key = (p, shape, device, track)
    e = _ENTRIES.get(key)
    if e is None:
        clear(device)
        e = _ENTRIES[key] = _Entry(key, p, shape, device)
    return e


# ---- the streamed mode's slab phases ----

def _outputs(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


def _phase_key(fn, shapes) -> tuple:
    """What a slab phase is compiled for in the JAX package: the function,
    its static arguments (a ``functools.partial``'s keywords) and the slab
    shapes."""
    if isinstance(fn, functools.partial):
        return (fn.func, tuple(sorted(fn.keywords.items())), fn.args, shapes)
    return (fn, (), (), shapes)


def _phase_name(fn) -> str:
    """A slab phase's function's name without its ``_ph_`` (``_``)
    prefix: ``sor_trapezoid``."""
    name = getattr(fn, "func", fn).__name__
    return name[4:] if name.startswith("_ph_") else name.lstrip("_")


class _DirectPhase:
    """A slab phase called directly (``_StreamDirect``)."""

    def __init__(self, run, fn, n_inputs: int):
        self.run, self.fn = run, fn
        self.span = _span_name(_phase_name(fn))
        # Nothing to stage into: the stager makes each slab's tensors.
        self.inputs = [None] * n_inputs

    def __call__(self, args, origins=(), carry=None):
        """fn(*args, *origins), the results that ``carry`` gives a tensor
        for copied into it (as a graph does)."""
        if self.run.tensors:
            origins = [torch.tensor(v, dtype=torch.int32,
                                    device=self.run.device) for v in origins]
        with profiling.span(self.span):
            outs = _outputs(self.fn(*args, *origins))
        return _carried(outs, carry)


class _StreamDirect:
    """The streamed mode's runner where nothing is captured: the CPU, whose
    phases take their slab origins as 0-d int32 tensors (the arithmetic
    the card's graphs replay), or a CUDA device called eagerly with Python
    ints (the witness a graphed run is held to)."""

    def __init__(self, device: torch.device, tensors: bool):
        self.device, self.tensors = device, tensors

    def phase(self, fn, shapes) -> _DirectPhase:
        return _DirectPhase(self, fn, len(shapes))

    def buffer(self, name, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)


class _StreamPhase:
    """A slab phase of a streamed entry: its static inputs (``inputs``, the
    tensors the stager copies each slab into: views of the entry's arena
    from its start, ``end`` the arena offset after them) and, once
    called, its graph, which leaves each result in the arena after the
    inputs or in the tensor the caller carries it into."""

    def __init__(self, entry, key, fn, inputs: list, end: int):
        # A weak reference: the entry holds its phases, and a cycle would
        # leave a dropped entry's graphs to the garbage collector, which
        # may run during another capture (where destroying a graph fails).
        self._entry = weakref.ref(entry)
        self.key, self.fn, self.inputs, self.end = key, fn, inputs, end

    @property
    def entry(self):
        return self._entry()

    def _results(self, outs, carry) -> tuple:
        carry = tuple(carry or ()) + (None,) * (len(outs) - len(carry or ()))
        free = [o for o, c in zip(outs, carry) if c is None]
        views = iter(self.entry.views(free, self.end)[0])
        return tuple(next(views) if c is None else c for c in carry)

    def __call__(self, args, origins=(), carry=None):
        """Fill the origins into the entry's device scalars, then replay the
        graph of fn(*args, *origins) (captured at the first call), the
        results that ``carry`` gives a tensor for copied into it; returns
        the graph's results."""
        e = self.entry
        scalars = e.scalars(len(origins))
        with kernels.on_device(e.device):
            for t, v in zip(scalars, origins):
                t.fill_(v)
            args = [*args, *scalars]
            g = e.graphs.get(self.key)
            if g is None:
                e.check(self.key, args, carry)
                g = e._record(self.key, self.fn, args,
                              lambda outs: self._results(outs, carry))
            return e._replay(self.key, g, args)


# Arena offsets are multiples of 64 floats (256 bytes): the kernels' 16-byte
# loads need aligned rows.
_ALIGN = 64


def aligned(n: int) -> int:
    """The arena floats that a view of ``n`` floats takes: n rounded up to
    the views' alignment. An arena sized in fields of ``aligned(floats)``
    each holds every view of those fields, however they are grouped."""
    return -(-n // _ALIGN) * _ALIGN


class _StreamEntry(_Held):
    """The graphs of one streamed call's key, one per slab phase, and what
    they read and write outside the pool: the arena, which holds every
    phase's static inputs and results (each phase's from the arena's start:
    the stager copies a phase's slabs in right before its replay and its
    results out right after it, so the phases may share the memory; its
    size, in floats, is the most any phase of the call stages in and out),
    the device scalars of the slab origins (shared alike: each replay is
    preceded by its own fills) and the buffers that outlive a replay. The
    pool then holds what lives inside the replays, which the graphs share
    as well."""

    kind = "stream"

    def __init__(self, key, device, arena: int):
        super().__init__(key, device)
        self.phases: dict = {}
        self.arena = self.outside["arena"] = torch.empty(
            arena, dtype=torch.float32, device=device)
        self.owned = {id(self.arena)}   # ids of the tensors a phase may read

    def label(self, key) -> tuple:
        return (_phase_name(key[0]), key[-1])

    def views(self, likes, start: int) -> tuple:
        """Float32 tensors of the shapes of ``likes`` (shapes or tensors)
        laid out in the arena from ``start``, and the offset after them;
        raises where the arena is too small."""
        views, off = [], start
        for like in likes:
            shape = tuple(like.shape if isinstance(like, torch.Tensor)
                          else like)
            if isinstance(like, torch.Tensor) and like.dtype != torch.float32:
                raise TypeError(f"a streamed phase's result of {like.dtype}")
            n = math.prod(shape)
            if off + n > self.arena.numel():
                raise RuntimeError(f"the streamed entry's arena of "
                                   f"{self.arena.numel()} floats holds no "
                                   f"{shape} at {off}")
            views.append(self.arena[off:off + n].view(shape))
            self.owned.add(id(views[-1]))
            off += aligned(n)
        return views, off

    def phase(self, fn, shapes) -> _StreamPhase:
        key = _phase_key(fn, tuple(tuple(s) for s in shapes))
        ph = self.phases.get(key)
        if ph is None:
            ph = self.phases[key] = _StreamPhase(self, key, fn,
                                                 *self.views(key[-1], 0))
        return ph

    def buffer(self, name, shape) -> torch.Tensor:
        """The entry's tensor of ``name`` and ``shape`` (zeros when made),
        outside the pool and the arena: what outlives a replay."""
        key = ("buffer", name, tuple(shape))
        if key not in self.outside:
            t = self.outside[key] = torch.zeros(shape, dtype=torch.float32,
                                                device=self.device)
            self.owned.add(id(t))
        return self.outside[key]

    def scalars(self, n: int) -> list:
        for i in range(n):
            if ("origin", i) not in self.outside:
                t = self.outside["origin", i] = torch.zeros(
                    (), dtype=torch.int32, device=self.device)
                self.owned.add(id(t))
        return [self.outside["origin", i] for i in range(n)]

    def check(self, key, args, carry) -> None:
        """A phase reads and writes only the entry's tensors outside the
        pool: a result in the pool may sit in blocks another phase's
        replay uses."""
        if any(id(t) not in self.owned
               for t in _tensors(args) + _tensors(carry)):
            _ENTRIES.pop(self.key, None)
            raise RuntimeError(f"streamed graph {key[0].__name__}: its "
                               f"inputs must be the entry's tensors")


def stream_runner(key, device, eager: bool = False, arena: int = 0):
    """The runner of a streamed call (``piecewise.py``, ``postproc.py``) of
    ``key`` (what the call is: its kind, params, volume shape and chunk)
    on ``device``: on a CUDA device the entry of (key, device), made, after
    dropping every other entry on the device, at the first call, with an
    arena of ``arena`` floats (the most any phase of the call stages in
    and out); with ``eager``, or on another device, the phases called
    directly. Both answer ``phase(fn, slab shapes)`` (a handle whose
    ``inputs`` are the tensors to stage each slab into, or None, and whose
    call runs the phase on (args, origins, carry)) and ``buffer(name,
    shape)``."""
    device = _device(device)
    if device.type != "cuda" or eager:
        return _StreamDirect(device, tensors=device.type != "cuda")
    k = ("stream", key, device)
    e = _ENTRIES.get(k)
    if e is None:
        clear(device)
        e = _ENTRIES[k] = _StreamEntry(k, device, arena)
    return e


def entries() -> dict:
    """The live entries of both kinds: key -> their ``info()`` (kind,
    graphs, captures, capture seconds, replays, warm-up launches, static
    and pool bytes)."""
    return {key: e.info() for key, e in _ENTRIES.items()}


def clear(device=None) -> None:
    """Drop the entries of both kinds on ``device`` (every device when
    None): their graphs, their pools and their static tensors, and hand
    the freed memory back to the device."""
    device = None if device is None else _device(device)
    doomed = [k for k, e in _ENTRIES.items()
              if device is None or e.device == device]
    for k in doomed:
        torch.cuda.synchronize(_ENTRIES[k].device)
        del _ENTRIES[k]
    if doomed:
        torch.cuda.empty_cache()
