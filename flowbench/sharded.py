"""One run of a sharded cell: the program's Z-sharded solve over the cell's
``chips`` cards, one persistent rank a card, as a deployment solves a
series (the command line's ``--distributed``).

- Set-up (``setup_s``, from the start of ``run.py``'s process to the start
  of the window): the kernels built (nvcc alone: this process touches no
  card until every rank has exited); one rank process a card started once
  (spawn, a free port on localhost). Each rank joins the program's group
  (``distributed.initialize``, rank r on card r: NCCL where every rank has
  a card of its own, gloo on the CPU), loads the kernels, makes its Z
  planes of every pair on its card (the traffic's pairs in the seed's
  order, as ``Bench.make_pairs`` makes them) into host memory that every
  rank maps (``HostMemory``: each pair held once), and makes one call.
- The window: every rank solves the same pairs in the same order
  (``System.solve``: ``sharding.compute_flow_sharded`` on the host pair,
  its flow slab back to host numpy). Each pair ends in an all-reduce of
  every rank, so a pair takes the slowest rank's time; on the last pair of
  a round it carries rank 0's word that its clock has passed the window's
  seconds. Every rank keeps its slab of the same flows, drawn from the
  seed. A traced run profiles the same first pairs on every rank; the
  per-layer readers read rank 1's trace (an interior rank with two
  neighbours where there are three ranks or more).
- After the window each rank reads its peak, writes its kept slabs into
  the shared memory, drops the program's graphs, leaves the group and
  exits. Then, on the cards the ranks have freed: the EPE over the whole
  volume (``slabwise.epe``) and the check against the configuration's
  reference (given the cell's cards where it takes ``devices``), compared
  slab by slab (``slabwise.compare``).

A rank that raises, or dies without reporting, ends the run with no result
and a non-zero exit: the other ranks are stopped ``_GRACE_S`` seconds
later at the most. A run killed from outside takes its ranks with it.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import mmap
import os
import queue as queue_mod
import signal
import sys
import time
import traceback
from dataclasses import dataclass
from multiprocessing import process as mp_process
from multiprocessing import reduction
from pathlib import Path

import numpy as np
import torch

from flowbench import devtrace, gen, slabwise, spec

# Seconds the ranks may take to report once one has failed, died or
# finished, before the rest are stopped (the program's own
# ``sharding._GRACE_S``).
_GRACE_S = 60.0
# Seconds a rank may take to exit once it has reported.
_EXIT_S = 30.0
# prctl's option for the signal a process gets when its parent dies.
_PR_SET_PDEATHSIG = 1


@dataclass(frozen=True)
class Job:
    """What every rank of a run is given: the cell by name (and the root of
    its ``BENCHMARK.json``), the run's seed, seconds and trace, the pairs'
    field seeds in the seed's order, the control's sweep-constant dtype
    (None: the configuration's), and the devices in rank order."""
    workload: str
    root: str
    seed: int
    seconds: float
    trace: bool
    fields: tuple
    terms_dtype: str | None
    devices: tuple


class HostMemory:
    """Host memory that every rank of a run maps (an anonymous ``memfd``,
    passed to the spawned ranks as a file descriptor): each pair's i0 and
    i1, then each pair's kept flow, float32. Pages are taken as they are
    first written."""

    def __init__(self, shape, pairs: int, fd: int | None = None):
        self.shape, self.pairs = tuple(shape), pairs
        self.voxels = math.prod(self.shape)
        nbytes = 5 * pairs * self.voxels * 4
        if fd is None:
            fd = os.memfd_create("flowbench", os.MFD_CLOEXEC)
            os.ftruncate(fd, nbytes)
        self.fd = fd
        self._map = mmap.mmap(fd, nbytes)

    def __reduce__(self):
        # Valid while a rank is being spawned: the descriptor goes with it.
        return _attach, (self.shape, self.pairs, reduction.DupFd(self.fd))

    def _array(self, index: int, lead: int) -> np.ndarray:
        return np.ndarray((lead, *self.shape), np.float32, self._map,
                          index * self.voxels * 4)

    def pair(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        pair = self._array(2 * k, 2)
        return pair[0], pair[1]

    def flow(self, k: int) -> np.ndarray:
        """Pair ``k``'s kept flow, (3, D, H, W)."""
        return self._array(2 * self.pairs + 3 * k, 3)

    def close(self) -> None:
        """Close the descriptor (the mapping lives on while it is used)."""
        os.close(self.fd)


def _attach(shape, pairs, dup) -> HostMemory:
    return HostMemory(shape, pairs, dup.detach())


@dataclass
class Outcome:
    """A sharded run's readings: pairs solved and the window's seconds on
    rank 0's clock (from ``window_start``), the check's gaps and failed
    pairs, the EPE, whether every pair's flow was kept, and each rank's
    report (``reports``: peak, backend, card, bring-up stamps, busy and
    span seconds of a traced run, forbidden modules) with the traced
    rank's ``Observed``."""
    done: int
    window_s: float
    window_start: float
    epe: float
    gaps: dict
    failed: int
    kept: bool
    reports: list
    obs: object


def main(args, cell: spec.Cell, t_proc: float) -> int:
    """``harness.main`` for a sharded cell (``t_proc``: the process's start
    on ``time.perf_counter``'s clock)."""
    from flowbench import harness
    n = cell.chips
    devices = _devices(args.device, n)
    if devices is None:
        return 2
    harness.log(f"[flowbench] {cell.name}: {n} ranks on {', '.join(devices)}"
                f", {cell.shape}, sharded, seed {args.seed}, "
                f"{args.seconds} s, trace {args.trace}")
    if args.device == "cuda":
        harness.log("[flowbench] power limits: " + ", ".join(
            harness.power_limit().splitlines()))
        from tpuflow3d_torch import kernels
        kernels.build()
    harness.log(f"[flowbench] kernels built at "
                f"{time.perf_counter() - t_proc:.3f} s")
    try:
        o = run(cell, devices, args.seed, args.seconds, bool(args.trace))
    except RankFailure as e:
        harness.log(f"[flowbench] {e}")
        return 1
    for r, rep in enumerate(o.reports):
        stamps = ", ".join(f"{k} {v - t_proc:.3f}"
                           for k, v in rep["stamps"].items())
        harness.log(f"[flowbench] rank {r} on {rep['device']}, backend "
                    f"{rep['backend']}: {stamps} s; peak {rep['peak']} B")
    setup_s = o.window_start - t_proc
    harness.log(f"[flowbench] window: {o.done} pairs in {o.window_s:.3f} s "
                f"(set-up {setup_s:.3f} s)")
    peaks = [rep["peak"] for rep in o.reports]
    checks = {k: {"value": o.gaps[k], "limit": cell.limits[k]}
              for k in ("flow_max_gap", "flow_mean_gap")}
    values = {"voxels_per_s": o.done * cell.voxels / o.window_s,
              "peak_bytes_per_voxel": max(peaks) / (cell.voxels / n),
              "epe": o.epe, "setup_s": setup_s}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": o.reports[0]["card"], "count": n,
              "memory_peak_bytes": max(peaks),
              "memory_peak_bytes_by_rank": peaks}
    if o.obs is not None:
        busy = [rep["busy_s"] for rep in o.reports]
        spans = [rep["span_s"] for rep in o.reports]
        device.update(busy_s=sum(busy) / n, window_s=sum(spans) / n,
                      busy_s_by_rank=busy, window_s_by_rank=spans)
    loaded = sorted({m for rep in o.reports for m in rep["loaded"]})
    return harness.emit(cell, bool(args.trace), o.failed == 0 and o.kept,
                        o.done, o.failed, values, device, o.obs, checks,
                        loaded)


def _devices(arg: str, n: int) -> list[str] | None:
    """The ranks' devices: card r for rank r, or n CPU ranks; None (and a
    line on standard error) where the cards are not there. Asks CUDA
    for the count only: no card is touched here."""
    if arg == "cpu":
        return ["cpu"] * n
    from flowbench import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device: torch.cuda.is_available() is false")
        return None
    if torch.cuda.device_count() < n:
        harness.log(f"the cell asks for {n} cards, "
                    f"{torch.cuda.device_count()} present")
        return None
    return [f"cuda:{r}" for r in range(n)]


class RankFailure(RuntimeError):
    """A rank raised, died, or did not report in time."""


def run(cell: spec.Cell, devices: list[str], seed: int, seconds: float,
        trace: bool, fields=None, terms_dtype: str | None = None) -> Outcome:
    """Set up the ranks, run the window, let the ranks exit, then read the
    EPE and the check. ``fields``: the pairs' field seeds (default the
    traffic's); ``terms_dtype``: the control's precision."""
    tr = cell.traffic
    fields = tr["field_seeds"] if fields is None else fields
    order = np.random.default_rng([seed, 0]).permutation(len(fields))
    job = Job(cell.name, str(cell.root), seed, seconds, trace,
              tuple(fields[j] for j in order.tolist()), terms_dtype,
              tuple(devices))
    memory = HostMemory(cell.shape, len(fields))
    try:
        reports = _ranks(job, memory)
    finally:
        memory.close()
    rank0 = reports[0]
    pairs = [memory.pair(k) for k in range(len(fields))]
    kept = [memory.flow(k) for k in range(len(fields))]
    dev = torch.device(devices[0])
    m = tr["epe_mask"]
    epe = float(np.mean([
        slabwise.epe(flow, i0, tr["deformation"], m["quantile"],
                     m["border"], dev)
        for (i0, _), flow in zip(pairs, kept)]))
    gaps, failed = check(cell, pairs, kept, seed, devices)
    obs = next((rep.pop("obs") for rep in reports
                if rep.get("obs") is not None), None)
    return Outcome(rank0["done"], rank0["window_s"], rank0["window_start"],
                   epe, gaps, failed, all(all(rep["kept"]) for rep in reports),
                   reports, obs)


def check(cell: spec.Cell, pairs, kept, seed: int, devices) -> tuple:
    """``Bench.check`` for a sharded cell: the pairs drawn from the seed
    solved again by the cell's reference (given the cell's cards where it
    takes ``devices``, else in core on the first card), each kept flow
    compared with its flow slab by slab. Returns (the largest gaps over
    the pairs, with the pairs drawn; how many pairs broke a limit)."""
    rng = np.random.default_rng([seed, 2])
    drawn = sorted(rng.choice(len(pairs), cell.traffic["check_pairs"],
                              replace=False).tolist())
    reference = cell.reference
    p = reference.Params.from_dict(cell.params)
    dev = torch.device(devices[0])
    limits = cell.limits
    worst, means, failed = 0.0, [], 0
    for j in drawn:
        i0, i1 = pairs[j]
        with torch.no_grad():
            if spec.takes_devices(reference):
                ref = reference.solve(
                    torch.from_numpy(i0), torch.from_numpy(i1), p, None,
                    devices=[torch.device(d) for d in devices])
            else:
                ref = reference.solve(torch.as_tensor(i0, device=dev),
                                      torch.as_tensor(i1, device=dev), p,
                                      None)
        gap, mean = slabwise.compare(kept[j], ref, dev)
        del ref
        worst = max(worst, gap)
        means.append(mean)
        failed += (gap > limits["flow_max_gap"]
                   or mean > limits["flow_mean_gap"])
    return ({"flow_max_gap": worst, "flow_mean_gap": max(means),
             "pairs_checked": drawn}, failed)


def _ranks(job: Job, memory: HostMemory) -> list[dict]:
    """Start one rank a device, gather each one's report, and wait until
    every rank has exited. Raises ``RankFailure`` where a rank raised, died
    without reporting, or had not reported ``_GRACE_S`` seconds after
    another had failed or finished; the rest are then stopped."""
    import torch.multiprocessing as mp

    from tpuflow3d_torch.sharding import free_port
    ctx = mp.get_context("spawn")
    n = len(job.devices)
    port = free_port()
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, job, port, memory, out),
                         daemon=True) for r in range(n)]
    for proc in procs:
        proc.start()
    got, error, failed_at, first_done, quiet = {}, None, None, None, 0
    try:
        while len(got) < n:
            now = time.monotonic()
            if error is not None and now - failed_at > _GRACE_S:
                break
            if error is None and first_done is not None and \
                    now - first_done > _GRACE_S:
                error = (f"ranks {sorted(set(range(n)) - set(got))} gave "
                         f"no result {_GRACE_S:.0f} s after rank "
                         f"{min(got)} had")
                break
            try:
                r, kind, payload = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, proc in enumerate(procs)
                        if proc.exitcode not in (None, 0) and r not in got]
                if dead and error is None:
                    error = (f"rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode} without a result")
                    failed_at = time.monotonic()
                # Every rank gone: what they sent has arrived by the next
                # empty wait.
                if all(proc.exitcode is not None for proc in procs):
                    quiet += 1
                    if quiet > 1:
                        error = error or "a rank exited without a result"
                        break
                continue
            if kind == "error":
                if error is None:
                    error = f"rank {r} failed:\n{payload}"
                    failed_at = time.monotonic()
            else:
                got[r] = payload
                first_done = first_done or time.monotonic()
    finally:
        if error is not None or len(got) < n:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
        for proc in procs:
            proc.join(timeout=_EXIT_S)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=_EXIT_S)
    if error is not None or len(got) < n:
        raise RankFailure(f"sharded run over {n} ranks failed: "
                          f"{error or 'ranks stopped without a result'}")
    return [got[r] for r in range(n)]


def rank_main(rank: int, job: Job, port: int, memory: HostMemory,
              out) -> None:
    """A rank: its report, or its traceback, on ``out``. It dies with the
    run's process, so that a run ended from outside leaves no rank."""
    _die_with_parent()
    try:
        report = _rank(rank, job, port, memory)
    except BaseException:
        # The traceback reaches the parent before this rank leaves without
        # waiting for its peers.
        out.put((rank, "error", traceback.format_exc()))
        out.close()
        out.join_thread()
        sys.stderr.flush()
        os._exit(1)
    out.put((rank, "done", report))


def _die_with_parent() -> None:
    """Ask Linux to kill this process when its parent dies
    (``PR_SET_PDEATHSIG``; where the kernel refuses, say so and go on), and
    leave at once where it already has."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL) != 0:
        print(f"[flowbench] prctl(PR_SET_PDEATHSIG) failed: "
              f"{os.strerror(ctypes.get_errno())}", file=sys.stderr,
              flush=True)
    parent = mp_process.parent_process()
    if parent is not None and os.getppid() != parent.pid:
        os._exit(1)


def _rank(rank: int, job: Job, port: int, memory: HostMemory) -> dict:
    import torch.distributed as dist

    from flowbench import harness
    from flowbench.system import System
    from tpuflow3d_torch import distributed as tdist
    from tpuflow3d_torch.sharding import process_z_range
    stamps = {"start": time.perf_counter()}
    n = len(job.devices)
    if job.devices[rank] == "cpu":
        torch.set_num_threads(1)
    z = tdist.initialize(f"localhost:{port}", n, rank,
                         device=job.devices[rank])
    dev = z.device
    stamps["group"] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(job.workload, Path(job.root))
    params = dict(cell.params)
    if job.terms_dtype is not None:   # the control: the program in bf16
        params["terms_dtype"] = job.terms_dtype
    system = System(params, cell.traffic, dev)
    system.build()
    stamps["kernels"] = time.perf_counter()

    tr = cell.traffic
    lo, hi = process_z_range(cell.shape[0], n, rank)
    pairs = [memory.pair(k) for k in range(memory.pairs)]
    for (i0, i1), field in zip(pairs, job.fields):
        gen.fill_planes(i0, i1, field, tr["texture"], tr["deformation"],
                        lo, hi, dev)
    dist.barrier()
    if rank == 0:
        for _, i1 in pairs:
            gen.add_intensity(i1, tr.get("intensity"))
    dist.barrier()
    stamps["pairs"] = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system.solve(*pairs[0])
    stamps["first_call"] = time.perf_counter()

    profiled = tr["profile_pairs"] if job.trace else 0
    done, t0, window_s, kept, prof, comm = _window(system, pairs, job,
                                                   rank, profiled)
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    for k, flow in enumerate(kept):
        if flow is not None:
            memory.flow(k)[:, lo:hi] = flow
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    obs = None
    if prof is not None:
        shapes = [(d // n, h, w) for d, h, w in cell.reference.Params
                  .from_dict(cell.params).level_shapes(cell.shape)]
        obs = devtrace.Observed(devtrace.events(prof), min(done, profiled),
                                cell.params, shapes, "sharded", card, {}, {},
                                0.0, rank, n, *comm)
    flags = [flow is not None for flow in kept]
    del kept, pairs
    system.release()
    tdist.shutdown()
    return {"done": done, "window_start": t0, "window_s": window_s,
            "kept": flags, "peak": peak, "card": card, "device": str(dev),
            "backend": z.backend, "stamps": stamps,
            "busy_s": obs.busy_s if obs else None,
            "span_s": obs.span_s if obs else None,
            "obs": obs if rank == traced_rank(n) else None,
            "loaded": harness.forbidden_modules()}


def traced_rank(n: int) -> int:
    """The rank whose trace the per-layer readers read: rank 1, an
    interior rank where there are three or more."""
    return min(1, n - 1)


def _window(system, pairs, job: Job, rank: int, profiled: int):
    """``Bench.window`` on a rank: the pairs solved in turn in whole
    rounds until rank 0's clock has passed ``job.seconds`` at the end of a
    round, the first ``profiled`` under the profiler; each pair ends in an
    all-reduce of every rank. Returns (pairs solved, the window's start and
    seconds, the kept flow slabs, the profiler or None, and the program's
    count of this rank's collectives over the unprofiled pairs of a traced
    run with their seconds)."""
    import torch.distributed as dist

    from flowbench import harness
    from tpuflow3d_torch.grid import COMM
    rng = np.random.default_rng([job.seed, 1])
    n = len(pairs)
    kept, seen = [None] * n, [0] * n
    # As in one process: a traced run profiles its first pairs and then
    # runs at least one round unprofiled.
    least = max(profiled + (n if job.trace else 0), 1)
    word = torch.zeros(1, dtype=torch.int32)
    prof = None
    done, comm_wall = 0, 0.0
    dist.barrier()
    t0 = time.perf_counter()
    while not word[0]:
        for j, (i0, i1) in enumerate(pairs):
            traced = done < profiled
            if traced and prof is None:
                prof = harness._profiler()
                prof.start()
            if done == profiled:
                COMM.reset()
            ts = time.perf_counter()
            with (torch.profiler.record_function(devtrace.PAIR) if traced
                  else contextlib.nullcontext()):
                flow = system.solve(i0, i1)
                word[0] = int(rank == 0 and j == n - 1 and done + 1 >= least
                              and time.perf_counter() - t0 >= job.seconds)
                dist.all_reduce(word, op=dist.ReduceOp.MAX)
            if done + 1 == profiled:
                prof.stop()
            elif not traced:
                comm_wall += time.perf_counter() - ts
            done += 1
            seen[j] += 1
            if rng.random() * seen[j] < 1.0:
                kept[j] = flow
            del flow
    window_s = time.perf_counter() - t0
    return done, t0, window_s, kept, prof, (COMM.as_dict(), comm_wall)
