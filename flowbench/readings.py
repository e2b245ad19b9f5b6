"""The readings the check's limits are set from, in one process.

    python3 flowbench/readings.py --workload <cell> --seeds 11,12,13 [--control]

For each seed, as a run makes them but with volumes of the seed's own
(the textures drawn from it): the cell's pairs, one capturing
call, a short window of the timed path (one round: each distinct pair
solved once), the program's graphs dropped, and the check against the
plain reference its configuration names (``spec.Cell.reference``).
Prints one JSON line per seed with the compared numbers. A sharded cell
starts its ranks anew for each seed (``sharded.run``). With
``--control`` the program runs with its sweep constants stored in bfloat16
(``terms_dtype``), the nearest precision below the configuration's
float32: a limit must fail it. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    from flowbench import harness, spec
    cell = spec.Cell(args.workload)
    if cell.mode == "sharded":
        return _sharded(cell, args)
    dev = harness._device(args.device, cell.chips)
    if dev is None:
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, power = harness.card_info(dev)
    bench = harness.Bench(cell, dev,
                          "bfloat16" if args.control else None)
    bench.system.build()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        # Volumes of the seed's own, not the traffic's fixed pair: the
        # limits are read over as many textures as seeds.
        n = len(cell.traffic["field_seeds"])
        pairs = bench.make_pairs(seed, [[seed, j] for j in range(n)])
        bench.system.solve(*pairs[0])
        done, window_s, kept, _ = bench.window(pairs, 0.0, seed)
        bench.system.release()
        epe = bench.epe(pairs, kept)
        gaps, failed = bench.check(pairs, kept, seed, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": args.control, "card": card,
                          "power_limit": power, "pairs": done,
                          "window_s": window_s, "epe": epe, **gaps,
                          "failed": failed,
                          "seconds": time.perf_counter() - t}), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


def _sharded(cell, args) -> int:
    """The readings of a sharded cell: for each seed a run of its own (the
    ranks started, the seed's pairs made, one round solved, the ranks
    gone), then the EPE and the check, as ``sharded.run`` makes them."""
    from flowbench import harness, sharded
    devices = sharded._devices(args.device, cell.chips)
    if devices is None:
        return 2
    if args.device == "cuda":
        from tpuflow3d_torch import kernels
        kernels.build()
    power = ", ".join(harness.power_limit().splitlines()) \
        if args.device == "cuda" else ""
    loaded = set()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        n = len(cell.traffic["field_seeds"])
        o = sharded.run(cell, devices, seed, 0.0, False,
                        [[seed, j] for j in range(n)],
                        "bfloat16" if args.control else None)
        loaded.update(m for rep in o.reports for m in rep["loaded"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": args.control,
                          "card": o.reports[0]["card"], "power_limit": power,
                          "ranks": len(devices), "pairs": o.done,
                          "window_s": o.window_s, "epe": o.epe, **o.gaps,
                          "failed": o.failed,
                          "seconds": time.perf_counter() - t}), flush=True)
    bad = sorted(loaded | set(harness.forbidden_modules()))
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
