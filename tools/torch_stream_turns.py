#!/usr/bin/env python3
"""Warm graphed streamed calls against eager ones, in turns, on one NVIDIA
GPU, each with its wall and host split.

    python3 tools/torch_stream_turns.py [--path stream:ladder512]
        [--size 512] [--turns eager,graphed,graphed,eager]
        [--out build/stream_turns.json]

The path's parameters, the chunk (``STREAM_CHUNK``), the blob pair (made
on the card) and the host split (``host_split``: put, phase, get, wait,
store, and the rest as ``other``) are ``chip_smoke.py``'s. A first graphed
call (no graphs held before it) captures the entry; then the calls of
``--turns`` run, each flow bitwise the first with the same launches, and
no graph captured after the first call. Prints the card's name and power
limit, a line per call and the medians of each kind; writes them as JSON
to ``--out``. Exits 1 where a flow, the launches or the captures differ.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("wall", "put", "phase", "get", "wait", "store", "other")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="stream:ladder512")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--turns", default="eager,graphed,graphed,eager")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "stream_turns.json"))
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_stream_turns.py: no CUDA device")
    import chip_smoke as smoke
    from tpuflow3d_torch import PRESETS, graphs, kernels
    from tpuflow3d_torch import synthetic as syn
    from tpuflow3d_torch.piecewise import compute_flow_piecewise

    dev = torch.device("cuda", 0)
    card = smoke.gpu_name_and_power_limit()
    print(card, flush=True)
    kernels.load_library()
    preset, changes, _, _ = smoke.STREAM_PATHS[args.path]
    pp = PRESETS[preset].replace(**changes)
    shape = (args.size,) * 3
    t0 = time.perf_counter()
    pair = smoke.blob_pair_on_device(torch, syn, shape, smoke.SHIFT, 0, dev)
    print(f"{shape} blob pair made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(kind):
        split = {}
        kernels.reset_launches()
        with smoke.host_split(split):
            t0 = time.perf_counter()
            f = compute_flow_piecewise(*pair, pp, chunk_z=smoke.STREAM_CHUNK,
                                       device=dev, eager=kind == "eager")
            torch.cuda.synchronize(dev)
            split["wall"] = time.perf_counter() - t0
        split["other"] = split["wall"] - sum(v for k, v in split.items()
                                             if k != "wall")
        print(f"{args.path} {kind}: " + ", ".join(
            f"{k} {split.get(k, 0.0):.3f}" for k in KEYS) + " s", flush=True)
        return f, split, dict(kernels.LAUNCHES)

    graphs.clear()
    f0, first, n0 = run("graphed")
    (cold,) = graphs.entries().values()
    runs = {"graphed": [], "eager": []}
    bad = []
    for kind in args.turns.split(","):
        f, split, n = run(kind)
        if not np.array_equal(f, f0) or n != n0:
            bad.append(f"a {kind} call's flow or launches ({n}) differ from "
                       f"the first graphed call's ({n0})")
        runs[kind].append(split)
    info = next(iter(graphs.entries().values()), cold)
    if info["captures"] != cold["captures"]:
        bad.append(f"{info['captures'] - cold['captures']} graphs captured "
                   f"after the first call")
    med = {kind: {k: statistics.median(s.get(k, 0.0) for s in ss)
                  for k in KEYS} for kind, ss in runs.items() if ss}
    for kind, m in med.items():
        print(f"{args.path} {kind} median of {len(runs[kind])}: " + ", ".join(
            f"{k} {m[k]:.3f}" for k in KEYS) + " s", flush=True)
    out = {"card": card, "path": args.path, "shape": shape,
           "chunk": smoke.STREAM_CHUNK, "launches": n0, "first_call": first,
           "captures": cold["captures"], "capture_s": cold["capture_seconds"],
           "static_bytes": info["static_bytes"],
           "pool_bytes": info["pool_bytes"], "runs": runs, "median": med,
           "faults": bad}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    graphs.clear()
    for b in bad:
        print(f"torch_stream_turns.py: {args.path}: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
