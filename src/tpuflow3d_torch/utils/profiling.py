"""Wall time per named phase.

Port of ``tpuflow3d.utils.profiling.PhaseTimer``: the phase ends after a
``torch.cuda.synchronize()`` when ``sync`` is given, where the reference
blocks on its arrays."""

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
