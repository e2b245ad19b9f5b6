"""The readings the check's limits are set from, in one process.

    python3 flowbench/readings.py --workload <cell> --seeds 11,12,13 [--control]

For each seed, as a run makes them but with volumes of the seed's own
(the textures drawn from it): the cell's pairs, one capturing
call, a short window of the timed path (one round: each distinct pair
solved once), the program's graphs dropped, and the check against the
plain reference. Prints one JSON line per seed with the compared numbers. With
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
    args = ap.parse_args(argv)
    import torch
    from flowbench import harness, spec
    cell = spec.Cell(args.workload)
    dev = harness._device("cuda", cell.chips)
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


if __name__ == "__main__":
    sys.exit(main())
