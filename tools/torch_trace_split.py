#!/usr/bin/env python3
"""What the port's own spans and counters (the tracer of
``tpuflow3d_torch.utils.profiling``) read in the benchmark's cells on one
NVIDIA GPU, and what the tracer costs when it is on.

    python3 tools/torch_trace_split.py [--cells a,b,c] [--seed N]
        [--rounds 3] [--out chiprun_out/trace_split.json]

Each cell of ``BENCHMARK.json`` is set up as ``flowbench`` sets it up (its
configuration, its traffic's pairs made from the seed, one capturing call),
then:

- cost: unprofiled rounds of the distinct pairs with the tracer off and on
  in turns (off, on, on, off, ...), the voxels/s of each;
- in core: a profiled round with the tracer off, then one with it on. In
  the second, every device activity is linked to the ``tf3d.replay.*``
  span whose replay launched it, by two links: (a) the activity's linked
  correlation id names a host event, inside a span; (b) its correlation id
  is the runtime launch's (``cudaGraphLaunch``), and the launch lies inside
  a span by host time. From the link that holds: the device seconds by
  segment, ``pyramid_share`` (prep, up), ``terms_plain_share`` (the plain
  kernels of warp, pre, terms, post), ``vcycle_plain_share`` (of body)
  beside ``plain_ops_share``, and ``early_stop_idle_share`` (the device's
  idle time inside ``tf3d.early_stop`` spans, less the gaps under the
  profiler's own buffer work) beside ``device_idle_share``;
- in core with gamma > 0: the graphs dropped, one pair of the eager
  solve (``pipeline.compute_flow_impl``, the volumes already on the
  device) profiled with the tracer on, whose spans open where a replay's
  do not: ``gc_plain_share``, the device seconds of the plain kernels
  launched inside ``tf3d.gc.*`` spans (``gc_terms``' derivatives, and
  ``compute_terms``' gradient-constancy branch where it runs plain; K9,
  which makes the system there on a whole volume, is left out) over
  the pair's device seconds, each kernel placed by the host event its
  link (a) names (link (b), its runtime launch, where that covers more),
  and the pair's counters (``gc.derivs_voxels``, ``gc.terms_voxels``)
  beside those of a replayed pair;
- streamed: an unprofiled round with the tracer on (its table over the
  round's wall: ``tf3d.stream.host_arrays``, the staging spans, and
  ``stage.h2d_bytes`` per pair against ``piecewise.stream_h2d_bytes``),
  then a profiled round with it on: the device's idle time by the
  innermost program span over it, and the longest gaps.

Writes JSON to ``--out`` and prints a summary. ``--device cpu --edge 16``
runs the same code at 16^3 on the CPU (no device activity: the shares are
None there). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from flowbench import devtrace, spec  # noqa: E402
from flowbench.harness import Bench, _profiler, card_info  # noqa: E402
from tpuflow3d_torch import piecewise as pw  # noqa: E402
from tpuflow3d_torch.params import FlowParams  # noqa: E402
from tpuflow3d_torch.utils import profiling  # noqa: E402

# plain_ops_share's pattern of the program's own kernels.
CSRC = re.compile(r"tf3d_sweep::|warp_grad_kernel<|median3_kernel\(|"
                  r"sor_halfsweep_packed_kernel|sor_halfsweep_gc_packed_kernel")
# The nonlinearity-update kernels (K8, K9), which plain_ops_share's
# pattern lacks: K9 runs inside ``tf3d.gc.terms``.
TERMS_KERNELS = re.compile(r"tf3d_terms::")
# Host events of the profiler's own work, not the program's.
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")
PYRAMID = ("prep", "up")
TERMS = ("warp", "pre", "terms", "post")
REPLAY = "tf3d.replay."
GC = "tf3d.gc."


def events(prof):
    """(host, device) events of a finished profiler: host as (name, start,
    end, corr), device as (name, start, end, kind, corr, linked)."""
    cuda = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() != cuda:
            host.append((name, s, t, e.correlation_id()))
        elif not (e.is_user_annotation() or name.startswith(("flowbench.",
                                                             "tf3d."))):
            dev.append((name, s, t, devtrace._kind(name), e.correlation_id(),
                        e.linked_correlation_id()))
    return host, dev


class Spans:
    """Non-overlapping host spans (the replays) found by time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda h: h[1])
        self.starts = [h[1] for h in self.spans]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i]
        return None


def split(host, dev, span):
    """The profiled round's device time by replay segment, both links'
    coverage, and the shares."""
    s0, s1 = span
    dev = [d for d in dev if d[2] > s0 and d[1] < s1]
    replays = Spans([h for h in host if h[0].startswith(REPLAY)])
    by_corr = {h[3]: h for h in host}
    runtime = {h[3]: h for h in host if h[0].startswith("cuda")}

    def seg_a(d):
        h = by_corr.get(d[5])
        if h is None:
            return None
        sp = h if h[0].startswith(REPLAY) else replays.at(h[1])
        return sp and sp[0][len(REPLAY):]

    def seg_b(d):
        h = runtime.get(d[4])
        sp = h and replays.at(h[1])
        return sp and sp[0][len(REPLAY):]

    kernel_s = sum(d[2] - d[1] for d in dev if d[3] == "kernel") * 1e-9
    all_s = sum(d[2] - d[1] for d in dev) * 1e-9
    out = {"kernel_s": kernel_s, "device_s": all_s, "links": {}}
    segs = {}
    for link, fn in (("linked_correlation_id", seg_a),
                     ("correlation_id", seg_b)):
        got = [fn(d) for d in dev]
        linked = sum(d[2] - d[1] for d, g in zip(dev, got)
                     if g and d[3] == "kernel") * 1e-9
        out["links"][link] = (100.0 * linked / kernel_s if kernel_s > 0
                              else None)
        segs[link] = got
    link = max(out["links"], key=lambda k: out["links"][k] or -1.0)
    out["link"] = link
    by_seg = {}
    for d, g in zip(dev, segs[link]):
        plain = d[3] == "kernel" and not CSRC.search(d[0])
        row = by_seg.setdefault(g or "unlinked", [0.0, 0.0])
        row[0] += (d[2] - d[1]) * 1e-9
        row[1] += (d[2] - d[1]) * 1e-9 if plain else 0.0
    out["by_segment"] = {k: {"device_s": v[0], "plain_kernel_s": v[1]}
                         for k, v in sorted(by_seg.items())}
    plain_all = sum(d[2] - d[1] for d in dev if d[3] == "kernel"
                    and not CSRC.search(d[0])) * 1e-9
    if all_s > 0:
        out["plain_ops_share"] = 100.0 * plain_all / all_s
        out["pyramid_share"] = 100.0 * sum(
            by_seg.get(k, [0.0])[0] for k in PYRAMID) / all_s
        out["terms_plain_share"] = 100.0 * sum(
            by_seg.get(k, [0.0, 0.0])[1] for k in TERMS) / all_s
        if "body" in by_seg:
            out["vcycle_plain_share"] = 100.0 * by_seg["body"][1] / all_s
    # A sample of each link, for the record.
    out["sample"] = [
        {"device": d[0][:60], "corr": d[4], "linked": d[5],
         "linked_host": (by_corr[d[5]][0] if d[5] in by_corr else None),
         "runtime": (runtime[d[4]][0] if d[4] in runtime else None)}
        for d in dev if d[3] == "kernel"][:4]
    return out


def innermost(evs, points):
    """The name of the shortest event of ``evs`` (name, start, end, ...)
    holding each of the sorted ``points`` (None where none does): a sweep
    that keeps the open events in a heap by duration."""
    evs = sorted(evs, key=lambda h: h[1])
    heap, out, i = [], [], 0
    for t in points:
        while i < len(evs) and evs[i][1] <= t:
            h = evs[i]
            heapq.heappush(heap, (h[2] - h[1], h[2], i, h[0]))
            i += 1
        # An event ended by t leaves when it comes to the top; one below
        # the top that has ended is longer than the top, which holds t.
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][3] if heap else None)
    return out


def idle(host, dev, span, top=10):
    """The device's idle time in the profiled span: in all, inside
    ``tf3d.early_stop`` spans less the gaps whose innermost host event is
    the profiler's own, by the innermost program span, and the longest
    gaps by the innermost host event."""
    s0, s1 = span
    busy = devtrace.merged((max(d[1], s0), min(d[2], s1)) for d in dev
                           if d[2] > s0 and d[1] < s1)
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = [(s + e) // 2 for s, e in gaps]
    inner = [h for h in host if h[2] > s0 and h[1] < s1
             and not h[0].startswith("flowbench.")]
    names = innermost(inner, mids)
    progs = innermost([h for h in inner if h[0].startswith("tf3d.")], mids)
    stops = Spans([h for h in host if h[0] == "tf3d.early_stop"])
    span_s = (s1 - s0) * 1e-9
    total = sum(e - s for s, e in gaps) * 1e-9
    stop_idle = own = 0.0
    by_span = {}
    for (s, e), mid, name, prog in zip(gaps, mids, names, progs):
        key = prog or "outside the program's spans"
        by_span[key] = by_span.get(key, 0.0) + (e - s) * 1e-9
        sp = stops.at(mid)
        if sp is not None:
            piece = (min(e, sp[2]) - max(s, sp[1])) * 1e-9
            if name in PROFILER_OWN:
                own += piece
            else:
                stop_idle += piece
    longest = sorted(zip(gaps, names), key=lambda g: g[0][0] - g[0][1])
    out = {"span_s": span_s, "idle_s": total,
           "device_idle_share": 100.0 * total / span_s if span_s else None,
           "idle_by_program_span": dict(sorted(by_span.items(),
                                               key=lambda kv: -kv[1])),
           "gaps": [[n or "no host event", (e - s) * 1e-9]
                    for (s, e), n in longest[:top]]}
    if stops.spans:
        out["early_stop_idle_share"] = 100.0 * stop_idle / span_s
        out["early_stop_profiler_gaps_s"] = own
    return out


def rounds(bench, pairs, n, voxels):
    """Voxels/s of unprofiled rounds, tracer off and on in turns."""
    order = (["off", "on", "on", "off"] * n)[:2 * n]
    got = {"off": [], "on": []}
    for kind in order:
        profiling.enable(kind == "on")
        t = time.perf_counter()
        for i0, i1 in pairs:
            bench.system.solve(i0, i1)
        got[kind].append(len(pairs) * voxels / (time.perf_counter() - t))
        profiling.enable(False)
    profiling.reset()
    return {**got, "on_over_off": statistics.median(got["on"])
            / statistics.median(got["off"])}


def profiled(solve, pairs, on: bool):
    """``solve`` on each pair under the profiler, the tracer on or off:
    (host events, device events, the pairs' span)."""
    prof = _profiler()
    profiling.enable(on)
    prof.start()
    for i0, i1 in pairs:
        with torch.profiler.record_function(devtrace.PAIR):
            solve(i0, i1)
    prof.stop()
    profiling.enable(False)
    host, dev = events(prof)
    marks = [h for h in host if h[0] == devtrace.PAIR]
    return host, dev, (min(h[1] for h in marks), max(h[2] for h in marks))


def gc_split(host, dev, span) -> dict:
    """The eager pair's device time of the plain kernels inside the
    ``tf3d.gc.*`` spans."""
    s0, s1 = span
    dev = [d for d in dev if d[2] > s0 and d[1] < s1]
    spans = Spans([h for h in host if h[0].startswith(GC)])
    by_corr = {h[3]: h for h in host if h[3]}
    runtime = {h[3]: h for h in host if h[3] and h[0].startswith("cuda")}
    kernels = [d for d in dev if d[3] == "kernel"]
    kernel_s = sum(d[2] - d[1] for d in kernels) * 1e-9
    all_s = sum(d[2] - d[1] for d in dev) * 1e-9
    links = {"linked_correlation_id": [by_corr.get(d[5]) for d in kernels],
             "correlation_id": [runtime.get(d[4]) for d in kernels]}
    cover = {k: (100.0 * sum(d[2] - d[1] for d, h in zip(kernels, hs)
                             if h is not None) * 1e-9 / kernel_s
                 if kernel_s > 0 else None) for k, hs in links.items()}
    link = max(cover, key=lambda k: cover[k] or -1.0)
    inside = {}
    for d, h in zip(kernels, links[link]):
        sp = h and spans.at(h[1])
        if sp and not TERMS_KERNELS.search(d[0]):
            inside[sp[0]] = inside.get(sp[0], 0.0) + (d[2] - d[1]) * 1e-9
    return {"device_s": all_s, "kernel_s": kernel_s, "links": cover,
            "link": link, "gc_device_s": inside,
            "gc_plain_share": (100.0 * sum(inside.values()) / all_s
                               if all_s > 0 else None)}


def eager_gc(bench, pairs) -> dict:
    """One eager pair profiled with the tracer on (the graphs dropped
    first), its gradient-constancy split and counters, and a replayed
    pair's counters."""
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.pipeline import _pad_z, compute_flow_impl
    p = bench.system.p
    profiling.reset()
    profiling.enable(True)
    bench.system.solve(*pairs[0])
    profiling.enable(False)
    replayed = profiling.snapshot()["counters"]
    profiling.reset()
    bench.system.release()

    def eager(i0, i1):
        compute_flow_impl(i0, i1, p, HaloCtx())
        if bench.device.type == "cuda":
            torch.cuda.synchronize(bench.device)

    pair = _pad_z(*(torch.as_tensor(x, device=bench.device)
                    for x in pairs[0]), p.z_multiple)
    host, dev, span = profiled(eager, [pair], True)
    del pair
    snap = profiling.snapshot()
    profiling.reset()
    out = gc_split(host, dev, span)
    out.update(counters=snap["counters"], replayed_counters=replayed,
               spans={k: v for k, v in snap["spans"].items()
                      if k.startswith(GC)})
    return out


def cell_run(name: str, args, device) -> dict:
    cell = spec.Cell(name)
    if args.edge:
        cell.shape = (args.edge,) * 3
        cell.params = spec.solver_params(cell.config, cell.traffic,
                                         cell.shape)
    bench = Bench(cell, device)
    bench.system.build()
    pairs = bench.make_pairs(args.seed)
    bench.system.solve(*pairs[0])
    out = {"cell": name, "shape": cell.shape, "mode": cell.mode,
           "cost": rounds(bench, pairs, args.rounds, cell.voxels)}
    if cell.mode == "incore":
        host, dev, span = profiled(bench.system.solve, pairs, False)
        off_span = (span[1] - span[0]) * 1e-9
        del host, dev
        host, dev, span = profiled(bench.system.solve, pairs, True)
        out["profiled_span_s"] = {"off": off_span,
                                  "on": (span[1] - span[0]) * 1e-9}
        out["split"] = split(host, dev, span)
        out["idle"] = idle(host, dev, span)
        del host, dev
        if cell.params.get("gamma", 0.0) > 0.0:
            out["gc"] = eager_gc(bench, pairs)
    else:
        profiling.reset()
        profiling.enable(True)
        t = time.perf_counter()
        for i0, i1 in pairs:
            bench.system.solve(i0, i1)
        wall = time.perf_counter() - t
        profiling.enable(False)
        snap = profiling.snapshot()
        profiling.reset()
        p = FlowParams(**cell.params)
        h2d = snap["counters"].get("stage.h2d_bytes", 0)
        out["unprofiled"] = {
            "wall_s": wall, "pairs": len(pairs),
            "host_share": {k: 100.0 * v["self_seconds"] / wall
                           for k, v in sorted(snap["spans"].items())
                           if not k.startswith(REPLAY)},
            "stream_host_arrays_share": 100.0 * snap["spans"].get(
                "tf3d.stream.host_arrays", {}).get("seconds", 0.0) / wall,
            "staging_share": 100.0 * sum(
                snap["spans"].get(f"tf3d.stage.{k}", {}).get(
                    "self_seconds", 0.0) for k in ("put", "store")) / wall,
            "stream_h2d_bytes_per_voxel": h2d / len(pairs) / cell.voxels,
            "predicted_h2d_bytes_per_voxel": pw.stream_h2d_bytes(
                p, cell.shape, cell.traffic["chunk_z"]) / cell.voxels,
            "d2h_bytes_per_voxel": snap["counters"].get(
                "stage.d2h_bytes", 0) / len(pairs) / cell.voxels,
            "spans": snap["spans"]}
        host, dev, span = profiled(bench.system.solve, pairs, True)
        out["idle"] = idle(host, dev, span)
    bench.system.release()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="ladder-512-incore,"
                    "accurate-256-incore,ladder-256-stream")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--edge", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "trace_split.json"))
    args = ap.parse_args()
    device = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info(device)
    print(f"[trace_split] {card[0]} {card[1]} torch {torch.__version__}",
          flush=True)
    results = {"card": card, "torch": torch.__version__, "cells": []}
    for name in args.cells.split(","):
        t = time.perf_counter()
        r = cell_run(name, args, device)
        r["seconds"] = time.perf_counter() - t
        results["cells"].append(r)
        brief = {k: v for k, v in r.items() if k not in ("split", "idle",
                                                          "unprofiled", "gc")}
        print(f"[trace_split] {json.dumps(brief)}", flush=True)
        for part in ("split", "idle", "unprofiled", "gc"):
            if part in r:
                shown = {k: v for k, v in r[part].items() if k != "spans"}
                print(f"[trace_split] {name} {part}: {json.dumps(shown)}",
                      flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
