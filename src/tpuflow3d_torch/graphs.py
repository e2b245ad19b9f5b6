"""Compiled dispatch: the one-device in-core solve captured into CUDA graphs
and replayed.

Counterpart of the compiled programs of ``tpuflow3d.pipeline``
(``_compute_flow_jit``, ``_prep_fn_cached``, ``_warp_fn_cached``,
``_upsample_fn_cached``, ``_level_fn_cached``). There the whole
coarse-to-fine solve is one program; PyTorch launches each operation from
the host, so ``compute_flow`` and ``compute_flow_checkpointed`` on a CUDA
device capture the solve once, in segments, into CUDA graphs and then
replay them. The segments:

- ``prep``: normalise, presmooth, both pyramids;
- per level, one warp iteration (``pipeline.warp_iteration``), replayed
  ``warps`` times;
- per level, the flow upsampled to the next level and clamped.

With ``residual_tol`` > 0 the early stop reads the mean update on the host
after each sweep (V-cycle), as the eager solve does, so the solve stops at
the same sweep; a warp iteration then splits at each read:

- ``pre``: warp, derivatives, gradient-constancy terms, the first
  nonlinearity update (``solver.inner_system``: ``compute_terms``, and
  ``build_mg_levels`` for multigrid or the packing for the packed layout);
- ``terms``: the nonlinearity update of inner iterations k >= 1;
- ``body``: one sweep (V-cycle) and its mean update (``solver.relax_step``),
  replayed up to ``sweeps`` (``mg_cycles``) times, the stop test read after
  each replay;
- ``post``: median, accumulate, clamp (``pipeline.accumulate``).

On the CPU (any device but CUDA) the same segment functions run directly,
one after another, and give the eager ``pipeline.compute_flow_impl``'s
bits, which the tests hold.

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
capture counts, so a graphed solve counts what the eager one does.

Capturing an entry with a new key drops every other entry on that device
first; ``clear`` drops them on request. Only the one-device in-core solve
is graphed: the Z-sharded ranks stage their exchanges through host memory
and the streamed mode moves slabs between host and device, and neither can
be captured.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from tpuflow3d_torch import checkpoint as ckpt
from tpuflow3d_torch import kernels
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.pipeline import (accumulate, gc_terms, prepare_pyramids,
                                     warp_and_derivatives, warp_iteration)
from tpuflow3d_torch.pyramid import upsample_flow
from tpuflow3d_torch.solver import (inner_steps, inner_system, iterate_du,
                                    parity_mask, relax_step)
from tpuflow3d_torch.utils.profiling import PhaseTimer

_CTX = HaloCtx()


# ---- the segments: functions of tensors, each returning a tuple ----

def _prep(i0, i1, p: FlowParams):
    pyr0, pyr1, _ = prepare_pyramids(i0, i1, p, _CTX)
    return pyr0, pyr1


def _warp(i0l, i1l, flow, slot, p: FlowParams):
    parity = parity_mask(tuple(i0l.shape), _CTX, i0l.device)
    return (warp_iteration(i0l, i1l, flow, p, _CTX, parity, slot),)


def _upsample(flow, shape, p: FlowParams):
    flow = upsample_flow(flow, shape, _CTX)
    if p.flow_clamp > 0.0:
        flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return (flow,)


def _pre(i0l, i1l, flow, p: FlowParams):
    g, it, i1w = warp_and_derivatives(i0l, i1l, flow, p, _CTX,
                                      p.gamma > 0.0)
    gc = gc_terms(i0l, i1w, g, p, _CTX)
    parity = parity_mask(tuple(i0l.shape), _CTX, i0l.device)
    step, state = inner_system(g, it, flow, torch.zeros_like(flow), p, _CTX,
                               parity, gc)
    return g, it, gc, step, state


def _terms(g, it, flow, state, gc, p: FlowParams):
    parity = parity_mask(tuple(it.shape), _CTX, it.device)
    return inner_system(g, it, flow, iterate_du(state, _CTX), p, _CTX,
                        parity, gc)


def _body(state, step, p: FlowParams):
    return relax_step(step, state, p, _CTX)


def _post(state, flow, p: FlowParams):
    return (accumulate(flow, iterate_du(state, _CTX), p, _CTX),)


# ---- the driver: the same on every device ----

def solve(i0, i1, p: FlowParams, diagnostics: bool = False,
          checkpoint_dir: str | None = None, timer=None):
    """Coarse-to-fine solve of one-device volumes whose Z is already a
    multiple of ``z_multiple``, by segments: replayed from CUDA graphs on a
    CUDA device, called directly elsewhere. Returns (flow, residuals): the
    flow a tensor of the caller's own (a clone on CUDA), residuals the
    (levels, warps, inner*sweeps) curves when ``diagnostics`` and
    ``p.track_residuals``, else None. ``checkpoint_dir`` and ``timer`` as in
    ``pipeline.compute_flow_impl``: checkpoints are saved and the phases
    timed between replays, never inside a capture."""
    track = diagnostics and p.track_residuals
    if i0.device.type != "cuda":
        return drive(_Direct(), i0, i1, p, track, checkpoint_dir, timer)
    with torch.cuda.device(i0.device):
        run = _entry(p, tuple(i0.shape), i0.device, track)
        flow, residuals = drive(run, *run.inputs(i0, i1), p, track,
                                checkpoint_dir, timer)
        return flow.clone(), residuals


def drive(run, i0, i1, p: FlowParams, track: bool = False,
          checkpoint_dir: str | None = None, timer=None):
    """``solve``'s level loop through ``run(key, fn, args, carry)``, which
    runs segment ``fn`` on ``args`` (replaying the graph of ``key``, or
    calling ``fn``) and copies each result that ``carry`` gives a tensor
    for into that tensor; ``run.zeros`` gives the static tensors the loop
    keeps between calls. Returns (the finest level's flow, residuals)."""
    phase = PhaseTimer.maybe(timer)
    shapes = p.level_shapes(tuple(i0.shape))
    dtype, dev = getattr(torch, p.dtype), i0.device
    with phase("pyramids", sync=True):
        pyr0, pyr1 = run(("prep",), functools.partial(_prep, p=p), (i0, i1))
    n_levels = len(shapes)
    residuals = (torch.zeros((n_levels, p.warps,
                              p.inner_iterations * p.sweeps),
                             dtype=dtype, device=dev) if track else None)
    flows = [run.zeros(("flow", li), (3, *shapes[li]), dtype, dev)
             for li in range(n_levels)]
    start = n_levels - 1
    state = (None if checkpoint_dir is None
             else ckpt.resume_state(checkpoint_dir, shapes, _CTX, dev))
    if state is not None:
        start = state[1]
        flows[start].copy_(torch.as_tensor(state[0], dtype=dtype,
                                           device=dev))
    else:
        flows[start].zero_()
    for li in range(start, -1, -1):
        with phase(f"level{li} {shapes[li]}", sync=True):
            _solve_level(run, pyr0[li], pyr1[li], flows[li], li, p,
                         residuals)
            if li > 0:
                run(("up", li), functools.partial(
                    _upsample, shape=shapes[li - 1], p=p), (flows[li],),
                    carry=(flows[li - 1],))
        if checkpoint_dir is not None and li > 0:
            with phase(f"checkpoint L{li - 1}"):
                ckpt.save_level_checkpoint(checkpoint_dir, flows[li - 1],
                                           li - 1, p, z0=0,
                                           d_global=shapes[li - 1][0])
    return flows[0], residuals


def _solve_level(run, i0l, i1l, flow, li: int, p: FlowParams, residuals):
    """The warp iterations of one level on its static flow: one segment
    each, or, with the early stop, pre / (terms, body...) / post."""
    if p.residual_tol <= 0.0:
        slot = (None if residuals is None else
                run.zeros(("slot", li), residuals.shape[-1:],
                          residuals.dtype, residuals.device))
        warp = functools.partial(_warp, p=p)
        for wi in range(p.warps):
            run(("warp", li), warp, (i0l, i1l, flow, slot), carry=(flow,))
            if slot is not None:
                residuals[li, wi].copy_(slot)
        return
    pre, terms, body, post = (functools.partial(f, p=p)
                              for f in (_pre, _terms, _body, _post))
    for wi in range(p.warps):
        g, it, gc, step, state = run(("pre", li), pre, (i0l, i1l, flow))
        for k in range(p.inner_iterations):
            if k:
                run(("terms", li), terms, (g, it, flow, state, gc),
                    carry=(step, state))
            for s in range(inner_steps(p)):
                _, r, more = run(("body", li), body, (state, step),
                                 carry=(state, None, None))
                if residuals is not None:
                    residuals[li, wi, k * p.sweeps + s] = r
                if not bool(more):
                    break
        run(("post", li), post, (state, flow), carry=(flow,))


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


class _Direct:
    """The segments called one after another (a device without graphs)."""

    def __call__(self, key, fn, args, carry=None):
        return _carried(fn(*args), carry)

    def zeros(self, key, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


# ---- the graphs ----

class _Graph(NamedTuple):
    graph: object      # a torch.cuda.CUDAGraph
    args: list         # the tensors it reads, as captured
    outs: tuple        # its results, the carried ones in their destinations
    launches: dict     # the kernel launches of one replay


def _level(key) -> int | None:
    """The pyramid level a segment works on (None: the pyramids)."""
    return key[1] if len(key) > 1 else None


class _Entry:
    """The captured segments of one (params, shape, device, track) key, and
    the tensors they read and write: the static inputs and the tensors of
    ``zeros``, allocated outside the graphs, and the graphs' results, in
    their pool."""

    def __init__(self, key, p: FlowParams, shape, device):
        self.key, self.device = key, device
        dtype = getattr(torch, p.dtype)
        self.i0 = torch.empty(shape, dtype=dtype, device=device)
        self.i1 = torch.empty(shape, dtype=dtype, device=device)
        # The graphs' memory pool, which the warm-ups allocate from too:
        # they reuse its free blocks instead of holding their own beside it.
        self.pool = torch.cuda.MemPool()
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict = {}
        self.outside: dict = {"i0": self.i0, "i1": self.i1}
        # id of every tensor a segment may read -> the segment that makes
        # it (None: made outside the graphs)
        self.maker: dict = {id(self.i0): None, id(self.i1): None}
        self.stats = {"captures": 0, "capture_seconds": 0.0, "replays": 0,
                      "warmup_launches": 0}

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
        leaves = _tensors(args)
        if g is None:
            try:
                g = self.graphs[key] = self._capture(key, fn, args, leaves,
                                                     carry)
            except BaseException:
                # Nothing half-captured stays behind.
                _ENTRIES.pop(self.key, None)
                raise
        elif len(leaves) != len(g.args) or any(
                a is not b for a, b in zip(leaves, g.args)):
            raise RuntimeError(f"graph {key}: called on other tensors than "
                               f"it was captured with")
        g.graph.replay()
        kernels.add_launches(g.launches)
        self.stats["replays"] += 1
        return g.outs

    def _capture(self, key, fn, args, leaves, carry) -> _Graph:
        # A result stays in the pool, whose blocks the graphs captured
        # before may use inside their replays: so a segment reads results
        # of the pyramids' segment (captured first) or of its own level's
        # segments only, which are captured before it and none of which
        # replays while another level is solved.
        for t in leaves + _tensors(carry):
            if id(t) not in self.maker:
                raise RuntimeError(f"graph {key}: its inputs must be the "
                                   f"entry's tensors")
            maker = self.maker[id(t)]
            if maker is not None and maker != ("prep",) and \
                    _level(maker) != _level(key):
                raise RuntimeError(f"graph {key} reads a result of {maker}")
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), \
                torch.cuda.use_mem_pool(self.pool, self.device):
            with kernels.counted_apart() as warm_launches:
                fn(*args)
        self.stats["warmup_launches"] += sum(warm_launches.values())
        t0 = time.perf_counter()
        with kernels.counted_apart() as launches:
            graph, outs = _capture_graph(fn, args, carry, self.pool.id,
                                         self.stream)
        self.stats["captures"] += 1
        self.stats["capture_seconds"] += time.perf_counter() - t0
        for t in _tensors(outs):
            self.maker.setdefault(id(t), key)
        return _Graph(graph, leaves, outs, launches)

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
        return {"graphs": len(self.graphs), **self.stats,
                "static_bytes": self.static_bytes(),
                "pool_bytes": self.pool_bytes()}


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _capture_graph(fn, args, carry, pool, stream):
    """Segment ``fn`` on ``args``, its carried results copied into their
    destinations, captured into a CUDA graph on ``stream`` with its memory
    from ``pool``: (the graph, the results)."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(stream.device)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            outs = _carried(fn(*args), carry)
    except BaseException:
        # A capture that fails at its end leaves the capture stream current.
        torch.cuda.set_stream(current)
        raise
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


def entries() -> dict:
    """The live entries: key -> their ``info()`` (graphs, captures,
    capture seconds, replays, warm-up launches, static and pool bytes)."""
    return {key: e.info() for key, e in _ENTRIES.items()}


def clear(device=None) -> None:
    """Drop the entries on ``device`` (every device when None): their
    graphs, their pools and their static tensors, and hand the freed memory
    back to the device."""
    device = None if device is None else _device(device)
    doomed = [k for k, e in _ENTRIES.items()
              if device is None or e.device == device]
    for k in doomed:
        torch.cuda.synchronize(_ENTRIES[k].device)
        del _ENTRIES[k]
    if doomed:
        torch.cuda.empty_cache()
