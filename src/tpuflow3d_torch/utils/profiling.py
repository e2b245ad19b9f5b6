"""Wall time per named phase, the program's own spans and counters, and a
profiler trace.

Port of ``tpuflow3d.utils.profiling``: a phase ends after a
``torch.cuda.synchronize()`` where the reference blocks on its arrays, and
the trace is ``torch.profiler``'s (a Chrome trace, which Perfetto and
chrome://tracing read) where the reference writes a ``jax.profiler``
trace.

The tracer (``span``, ``count``) marks the program's layer boundaries: the
graph replays of each segment, the early stop's host reads, the streamed
mode's host arrays and staging, the gradient-constancy terms. It is off by
default, and then a site costs one test of a module-level boolean. Turned
on (``enable``, or ``device_trace`` for its block) a span adds its calls,
host seconds and self seconds (less the spans opened inside it) to a
table, and, while a ``torch.profiler`` runs, is a ``record_function``
range too: a host event in the same trace as the device activities, so
that the kernels a replay launches and the device's idle gaps can be put
down to it. Spans never synchronise the device and are opened from the
calling thread only.

A CUDA graph runs the host code of its segment once, at its capture, and
none of it at a replay: the counts made inside a capture are kept apart
(``counted_apart``, which records them whether the tracer is on or not)
and each replay adds them (``add_counts``), as ``kernels.LAUNCHES`` counts
a graph's launches. The spans inside a replayed segment do not open; its
work lies under the replay's own span.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    """Accumulates wall time per named phase; everything host-visible."""
    times: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with ``sync`` (a tensor, or anything true) the
        phase waits for the CUDA device before it ends."""
        t0 = time.perf_counter()
        yield
        if sync is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, dict]:
        return {k: {"seconds": v, "calls": self.counts[k]}
                for k, v in self.times.items()}

    @staticmethod
    def maybe(timer: "PhaseTimer | None"):
        """``phase(name)`` context factory that is a no-op when ``timer``
        is None."""
        if timer is None:
            return lambda name, sync=None: contextlib.nullcontext()
        return timer.phase


# ---- the tracer ----

_ON = False
_NULL = contextlib.nullcontext()
_SPANS: dict[str, list] = {}    # name -> [calls, seconds, self seconds]
_COUNTERS: dict[str, int] = {}
_OPEN: list[float] = []         # seconds of the child spans of each open span
_APART: list[dict] = []         # the counts of each open ``counted_apart``


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _OPEN.append(0.0)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        inner = _OPEN.pop()
        if _OPEN:
            _OPEN[-1] += dt
        row = _SPANS.get(self.name)
        if row is None:
            row = _SPANS[self.name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += dt
        row[2] += dt - inner
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager over one piece of the program's work named
    ``name``: the shared null context while tracing is off."""
    if not _ON:
        return _NULL
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on (inside a
    ``counted_apart`` block, to that block's counts instead)."""
    if _ON or _APART:
        into = _APART[-1] if _APART else _COUNTERS
        into[name] = into.get(name, 0) + n


@contextlib.contextmanager
def counted_apart():
    """Counts made inside go to the dict it yields (name -> total), with
    the tracer on or off, and not to the counters: a CUDA graph's capture,
    whose counts each replay adds (``add_counts``)."""
    made: dict = {}
    _APART.append(made)
    try:
        yield made
    finally:
        _APART.pop()


def add_counts(made: dict) -> None:
    """Add counts made elsewhere (a CUDA graph's capture, at each of its
    replays) to the counters while tracing is on."""
    if _ON:
        for name, n in made.items():
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def enable(on: bool = True) -> bool:
    """Turn tracing on or off; returns whether it was on."""
    global _ON
    was, _ON = _ON, bool(on)
    return was


def snapshot() -> dict:
    """A copy of the table: ``{"spans": {name: {"calls", "seconds",
    "self_seconds"}}, "counters": {name: total}}``."""
    return {"spans": {k: {"calls": c, "seconds": t, "self_seconds": own}
                      for k, (c, t, own) in _SPANS.items()},
            "counters": dict(_COUNTERS)}


def reset() -> None:
    """Empty the table and the counters."""
    _SPANS.clear()
    _COUNTERS.clear()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """``torch.profiler`` over the block (host and, where there is a GPU,
    device activity), with the tracer on, so that the program's spans
    (``tf3d.*``) are in the trace; its Chrome trace written to
    ``<logdir>/trace.json`` (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = enable(True)
    try:
        with profile(activities=acts) as prof:
            yield
            _sync()
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
