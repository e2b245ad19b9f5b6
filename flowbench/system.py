"""The system under test: ``tpuflow3d_torch``, called as its command line
calls it for one pair (``cli._solve_pair``), and the spans and counters the
benchmark puts around calls into it.

In-core: ``compute_flow`` on numpy volumes, the flow copied back to a numpy
array. Streamed: ``piecewise.compute_flow_piecewise`` with the traffic's
chunk. Each call ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class System:
    def __init__(self, params: dict, traffic: dict, device: torch.device):
        from tpuflow3d_torch.params import FlowParams
        self.p = FlowParams(**params)
        self.mode = traffic["mode"]
        self.chunk = traffic.get("chunk_z")
        self.device = device
        self.cuda = device.type == "cuda"

    def build(self) -> None:
        """Build (first run in a checkout) or load the CUDA kernels."""
        if self.cuda:
            from tpuflow3d_torch import kernels
            kernels.load_library()

    def solve(self, i0: np.ndarray, i1: np.ndarray) -> np.ndarray:
        if self.mode == "incore":
            from tpuflow3d_torch import compute_flow
            flow = compute_flow(i0, i1, self.p, device=self.device)
            out = flow.cpu().numpy()
        elif self.mode == "stream":
            from tpuflow3d_torch.piecewise import compute_flow_piecewise
            out = compute_flow_piecewise(i0, i1, self.p, chunk_z=self.chunk,
                                         device=self.device)
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return out

    def release(self) -> None:
        """Drop the program's graphs and their memory."""
        if self.cuda:
            from tpuflow3d_torch import graphs
            graphs.clear()
            torch.cuda.empty_cache()


@contextlib.contextmanager
def patched(targets, wrap):
    """Replace each (class, attribute, label) of ``targets`` by
    ``wrap(original, label)`` for the length of the block."""
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in targets]
    for (cls, attr, label), (_, _, raw) in zip(targets, saved):
        if isinstance(raw, staticmethod):
            setattr(cls, attr, staticmethod(wrap(raw.__func__, label)))
        else:
            setattr(cls, attr, wrap(raw, label))
    try:
        yield
    finally:
        for cls, attr, raw in saved:
            setattr(cls, attr, raw)


@contextlib.contextmanager
def host_split(into: dict):
    """Host seconds of the streamed mode's staging, each without the calls
    inside it, added into ``into``: ``put`` (a slab gathered into
    page-locked memory and its copy enqueued), ``get`` (a result's copy
    back enqueued), ``wait`` (for a copy back), ``store`` (a result written
    into its host array)."""
    from tpuflow3d_torch import piecewise as pw
    stack = []

    def wrap(fn, name):
        def timed(*a, **k):
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                into[name] = into.get(name, 0.0) + dt - inner
                if stack:
                    stack[-1] += dt
        return timed

    targets = [(pw._Stager, "put", "put"), (pw._Stager, "get", "get"),
               (pw._Stager, "wait", "wait"), (pw._Stager, "store", "store")]
    with patched(targets, wrap):
        yield into


# The streamed mode's host phases, named in a traced run's trace so that an
# idle gap of the device shows what the host was doing.
_STREAM_PHASES = ("_solve_level_streamed", "_stream_sor_trapezoid",
                  "_stream_resample", "_stream",
                  "_stream_fused_warp_iteration", "_stream_mg_solve")


@contextlib.contextmanager
def host_labels():
    """Label the streamed mode's host phases and staging calls in the
    profiler's trace (``flowbench.host.<name>``) for the length of the
    block."""
    from tpuflow3d_torch import piecewise as pw

    def wrap(fn, name):
        def labelled(*a, **k):
            with torch.profiler.record_function(f"flowbench.host.{name}"):
                return fn(*a, **k)
        return labelled

    names = [n for n in _STREAM_PHASES if n in pw.__dict__]
    saved = {n: pw.__dict__[n] for n in names}
    for n in names:
        setattr(pw, n, wrap(saved[n], n))
    try:
        with patched([(pw._Stager, m, m) for m in
                      ("put", "get", "wait", "store")], wrap):
            yield
    finally:
        for n, fn in saved.items():
            setattr(pw, n, fn)


@contextlib.contextmanager
def replay_counts(into: dict):
    """Count the replays of each of the program's CUDA graphs by its key
    (``("body", level)`` is one V-cycle of that pyramid level under the
    early stop)."""
    from tpuflow3d_torch import graphs

    def wrap(fn, _):
        def counted(self, key, *a, **k):
            into[key] = into.get(key, 0) + 1
            return fn(self, key, *a, **k)
        return counted

    with patched([(graphs._Held, "_replay", "replay")], wrap):
        yield into
