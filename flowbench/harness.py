"""One run of a cell: set-up, the measured window, the check, the metrics.

``run.py`` parses the command line and calls ``main``; ``readings.py`` uses
the same pieces to read the compared numbers over many seeds in one
process. What follows is a cell in one process on one card (the traffic's
``mode`` ``incore`` or ``stream``); a ``sharded`` cell runs one rank
process a card (``sharded.py``) and prints its result through ``emit``.

- Set-up (``setup_s``, from the start of the process): torch and the
  program imported, the kernels built or loaded, the traffic's distinct
  pairs made on the device (the same for every seed; the seed orders them;
  with the traffic's ``intensity`` change on the moving volume) and copied
  to host numpy, and one call that captures the program's graphs.
- The window: the distinct pairs solved in turn, one after another, in
  whole rounds, until ``--seconds`` have passed at the end of a round.
  Each call takes numpy volumes and returns the flow as a numpy array.
  One returned flow of each distinct pair is kept, drawn from the seed.
- After the window: the device's peak read, the program's graphs and
  memory dropped, then the EPE of the kept flows and the check: the plain
  reference that the cell's configuration names (``spec.Cell.reference``,
  ``reference/<name>.py``) solves the pairs drawn for it again from the
  same volumes, and the kept flow is compared with its flow.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from flowbench import devtrace, gen, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuflow3d")


def process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_info(device: torch.device) -> tuple[str, str]:
    """(name, power limit) of the card; ("cpu", "") on the CPU."""
    if device.type != "cuda":
        return "cpu", ""
    return torch.cuda.get_device_name(device), power_limit(device.index or 0)


def power_limit(index: int | None = None) -> str:
    """The power limit ``nvidia-smi`` reads for card ``index``, or for
    every card, one line each (no CUDA call)."""
    which = [] if index is None else [f"--id={index}"]
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", *which],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Bench:
    """A cell set up on a device: its spec, the program, the pairs."""

    def __init__(self, cell: spec.Cell, device: torch.device,
                 terms_dtype: str | None = None):
        from flowbench.system import System
        self.cell, self.device = cell, device
        params = dict(cell.params)
        if terms_dtype is not None:   # the control: the program in bf16
            params["terms_dtype"] = terms_dtype
        self.system = System(params, cell.traffic, device)
        self.tr = cell.traffic
        self.shapes = cell.reference.Params.from_dict(
            cell.params).level_shapes(cell.shape)

    def make_pairs(self, seed: int, fields=None) -> list:
        """The traffic's distinct pairs, made from its ``field_seeds`` (or
        from ``fields``), in the order the run's seed draws: every seed
        does the same work, in another order."""
        fields = self.tr["field_seeds"] if fields is None else fields
        order = np.random.default_rng([seed, 0]).permutation(len(fields))
        return [gen.make_pair(self.cell.shape, fields[j], self.tr["texture"],
                              self.tr["deformation"], self.device,
                              self.tr.get("intensity"))
                for j in order.tolist()]

    def window(self, pairs, seconds: float, seed: int, trace: bool = False):
        """Solve the pairs in turn for ``seconds``, in whole rounds. Returns
        (pairs solved, window seconds, the kept flow of each pair, the
        ``Observed`` of a traced run or None)."""
        from flowbench.system import host_labels, host_split, replay_counts
        rng = np.random.default_rng([seed, 1])
        n = len(pairs)
        kept, seen = [None] * n, [0] * n
        profiled = self.tr["profile_pairs"] if trace else 0
        staging, staging_wall, replays = {}, 0.0, {}
        prof = None
        done = 0
        t0 = time.perf_counter()
        # A traced run profiles its first ``profiled`` pairs and then runs
        # at least one round unprofiled (the staging's host seconds are
        # read there).
        least = profiled + (n if trace else 0)
        while done < max(least, 1) or time.perf_counter() - t0 < seconds:
            for j, (i0, i1) in enumerate(pairs):
                if done < profiled:
                    if prof is None:
                        prof = _profiler()
                        prof.start()
                    with torch.profiler.record_function(devtrace.PAIR), \
                            replay_counts(replays), host_labels():
                        flow = self.system.solve(i0, i1)
                    if done + 1 == profiled:
                        prof.stop()
                elif trace and self.system.mode == "stream":
                    split = {}
                    ts = time.perf_counter()
                    with host_split(split):
                        flow = self.system.solve(i0, i1)
                    staging_wall += time.perf_counter() - ts
                    for k, v in split.items():
                        staging[k] = staging.get(k, 0.0) + v
                else:
                    flow = self.system.solve(i0, i1)
                done += 1
                seen[j] += 1
                if rng.random() * seen[j] < 1.0:
                    kept[j] = flow
                del flow
        window_s = time.perf_counter() - t0
        if prof is not None and done < profiled:
            prof.stop()
        obs = None
        if prof is not None:
            name = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu")
            obs = devtrace.Observed(
                devtrace.events(prof), min(done, profiled), self.cell.params,
                self.shapes, self.system.mode, name, replays, staging,
                staging_wall)
        return done, window_s, kept, obs

    def epe(self, pairs, kept) -> float:
        m = self.tr["epe_mask"]
        return float(np.mean([
            gen.epe(flow, i0, self.tr["deformation"], m["quantile"],
                    m["border"], self.device)
            for (i0, _), flow in zip(pairs, kept)]))

    def check(self, pairs, kept, seed: int, limits: dict) -> tuple:
        """Solve the pairs drawn from the seed with the cell's reference and
        compare each kept flow with its flow: the widest and the mean
        |difference| over every voxel and component (float64). Returns
        (the largest of each over the pairs, with the pairs drawn; how many
        pairs broke a limit)."""
        rng = np.random.default_rng([seed, 2])
        drawn = sorted(rng.choice(len(pairs), self.tr["check_pairs"],
                                  replace=False).tolist())
        reference = self.cell.reference
        p = reference.Params.from_dict(self.cell.params)
        chunk = (self.tr["chunk_z"] if self.system.mode == "stream"
                 else None)
        worst, means, failed = 0.0, [], 0
        for j in drawn:
            i0, i1 = (torch.as_tensor(x, device=self.device)
                      for x in pairs[j])
            with torch.no_grad():
                ref = reference.solve(i0, i1, p, chunk)
            del i0, i1
            got = torch.as_tensor(kept[j], device=self.device)
            diff = (got.double() - ref.double()).abs()
            del got, ref
            finite = bool(torch.isfinite(diff).all())
            gap = float(diff.max()) if finite else float("inf")
            mean = float(diff.mean()) if finite else float("inf")
            del diff
            worst = max(worst, gap)
            means.append(mean)
            failed += (gap > limits["flow_max_gap"]
                       or mean > limits["flow_mean_gap"])
        return ({"flow_max_gap": worst, "flow_mean_gap": max(means),
                 "pairs_checked": drawn}, failed)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _device(arg: str, chips: int) -> torch.device | None:
    if arg == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return None
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
            f"present")
        return None
    return torch.device("cuda", 0)


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(args) -> int:
    age0 = process_age()
    t_proc = time.perf_counter() - age0
    cell = spec.Cell(args.workload)
    if cell.mode == "sharded":
        from flowbench import sharded
        return sharded.main(args, cell, t_proc)
    dev = _device(args.device, cell.chips)
    if dev is None:
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, power = card_info(dev)
    log(f"[flowbench] {cell.name}: {card} {power}, {cell.shape}, "
        f"{cell.mode}, seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}")

    bench = Bench(cell, dev)
    bench.system.build()
    t = time.perf_counter()
    pairs = bench.make_pairs(args.seed)
    log(f"[flowbench] {len(pairs)} pairs made in "
        f"{time.perf_counter() - t:.3f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    bench.system.solve(*pairs[0])
    log(f"[flowbench] first call {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_proc

    done, window_s, kept, obs = bench.window(pairs, args.seconds, args.seed,
                                             bool(args.trace))
    log(f"[flowbench] window: {done} pairs in {window_s:.3f} s")
    peak = (torch.cuda.max_memory_reserved(dev) if dev.type == "cuda"
            else 0)
    bench.system.release()

    t = time.perf_counter()
    epe = bench.epe(pairs, kept)
    gaps, failed = bench.check(pairs, kept, args.seed, cell.limits)
    log(f"[flowbench] epe and check {time.perf_counter() - t:.3f} s, pairs "
        f"{gaps['pairs_checked']} checked")
    checks = {k: {"value": gaps[k], "limit": cell.limits[k]}
              for k in ("flow_max_gap", "flow_mean_gap")}
    correct = failed == 0 and all(f is not None for f in kept)
    values = {"voxels_per_s": done * cell.voxels / window_s,
              "peak_bytes_per_voxel": peak / cell.voxels,
              "epe": epe, "setup_s": setup_s}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": card, "count": cell.chips, "memory_peak_bytes": peak}
    if obs is not None:
        device["busy_s"] = obs.busy_s
        device["window_s"] = obs.span_s
    return emit(cell, bool(args.trace), correct, done, failed, values,
                device, obs, checks)


def emit(cell: spec.Cell, trace: bool, correct: bool, attempted: int,
         failed: int, values: dict, device: dict, obs, checks: dict,
         loaded: tuple = ()) -> int:
    """Print a run's result as its last line of standard output: the
    end-to-end ``values`` by quantity, or with ``trace`` the per-layer
    metrics read from ``obs`` and its ``breakdown``; then each compared
    number beside its limit as the last lines of standard error. Returns
    non-zero, printing no result, where this process or another of the run
    (``loaded``: the forbidden modules the run's other processes found)
    loaded a forbidden module."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[spec.base(m["name"])],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": attempted,
              "failed": int(failed), "metrics": metrics, "device": device}
    if obs is not None:
        result["breakdown"] = obs.breakdown()
        log(f"[flowbench] traced {obs.pairs} pairs: busy {obs.busy_s:.4f} "
            f"of {obs.span_s:.4f} s, {len(obs.device)} device activities")
        for name, sec, n in obs.by_name()[:30]:
            log(f"[flowbench]   {sec:10.6f} s {n:8d}x  {name[:160]}")
    result["checks"] = checks

    bad = sorted(set(forbidden_modules()) | set(loaded))
    if bad:
        log(f"[flowbench] forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
