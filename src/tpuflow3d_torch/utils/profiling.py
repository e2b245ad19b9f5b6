"""Wall time per named phase, steady-state call timing and a profiler
trace.

Port of ``tpuflow3d.utils.profiling``: the phase and the timed calls end
after a ``torch.cuda.synchronize()`` where the reference blocks on its
arrays, and the trace is ``torch.profiler``'s (a Chrome trace, which
Perfetto and chrome://tracing read) where the reference writes a
``jax.profiler`` trace."""

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


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Steady-state seconds per call of ``fn(*args)`` (host clock, the
    device synchronized; the first ``warmup`` calls, which build the
    kernels, are not timed)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """``torch.profiler`` over the block (host and, where there is a GPU,
    device activity), its Chrome trace written to
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
    with profile(activities=acts) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
