"""The traced run's device trace: ``torch.profiler`` over a bounded number
of pairs, reduced to what the per-layer readers take (``Observed``) and to
the result's ``breakdown``.

Device activities are kernels, memory copies and memsets; the profiled
span runs from the start of the first profiled pair to the end of the last
(the benchmark's own ``flowbench.pair`` annotations). Only times are kept;
no trace file is written.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

PAIR = "flowbench.pair"


class Event(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns
    kind: str    # "kernel", "memcpy", "memset", or "host"


def _kind(name: str) -> str:
    # "memcpy128" and the like: the CUDA driver's own copy kernels.
    if name.startswith("Memcpy") or re.match(r"memcpy\d*$", name):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def events(prof) -> list[Event]:
    """Every activity of a finished ``torch.profiler.profile``: device
    activities by kind, host ones as ``"host"`` (the pair annotations
    included; their device mirrors left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() != cuda:
            out.append(Event(name, start, end, "host"))
        elif not (e.is_user_annotation() or name.startswith("flowbench.")):
            out.append(Event(name, start, end, _kind(name)))
    return out


def merged(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Observed:
    """What a traced run saw, handed to every per-layer reader.

    ``device``: device activities inside the profiled span; ``host``: host
    events there; ``span``: (start, end) ns; ``pairs``: pairs profiled;
    ``params``: the solver settings; ``shapes``: the pyramid's level shapes
    (finest first); ``mode``; ``card``: the device's name; ``replays``:
    graph replays by key over the profiled pairs; ``staging``: host seconds
    of the streamed staging (``system.host_split``) over ``staging_wall``
    seconds of unprofiled pairs."""

    def __init__(self, evs: list[Event], pairs: int, params: dict,
                 shapes: list, mode: str, card: str, replays: dict,
                 staging: dict, staging_wall: float):
        marks = [e for e in evs if e.kind == "host" and e.name == PAIR]
        self.span = ((min(e.start for e in marks), max(e.end for e in marks))
                     if marks else (0, 0))
        s0, s1 = self.span
        self.device = [Event(e.name, max(e.start, s0), min(e.end, s1), e.kind)
                       for e in evs if e.kind != "host"
                       and e.end > s0 and e.start < s1]
        self.host = [e for e in evs if e.kind == "host" and e.name != PAIR
                     and e.end > s0 and e.start < s1]
        self.pairs, self.params, self.shapes = pairs, params, shapes
        self.mode, self.card, self.replays = mode, card, replays
        self.staging, self.staging_wall = staging, staging_wall
        self.busy = merged((e.start, e.end) for e in self.device)

    @property
    def span_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def seconds(self, pattern: str | None = None, kinds=("kernel",)) -> float:
        """Device seconds of the activities of ``kinds`` whose names match
        ``pattern`` (all of them where it is None)."""
        rx = None if pattern is None else re.compile(pattern)
        return sum(e.end - e.start for e in self.device
                   if e.kind in kinds and (rx is None or rx.search(e.name))
                   ) * 1e-9

    def by_name(self) -> list:
        """(name, device seconds, count) of every device activity name,
        the longest first."""
        acc = {}
        for e in self.device:
            t, n = acc.get(e.name, (0, 0))
            acc[e.name] = (t + e.end - e.start, n + 1)
        return sorted(((k, t * 1e-9, n) for k, (t, n) in acc.items()),
                      key=lambda r: -r[1])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event under each."""
        ops = [[n, t] for n, t, _ in self.by_name()[:top]]
        edges = [self.span[0]] + [x for iv in self.busy for x in iv] \
            + [self.span[1]]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            under = [h for h in self.host if h.start <= mid < h.end]
            name = (min(under, key=lambda h: h.end - h.start).name
                    if under else "no host event")
            named.append([f"host: {name}", (e - s) * 1e-9])
        return {"device_ops": ops,
                "idle_gaps": named}
