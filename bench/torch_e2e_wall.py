#!/usr/bin/env python3
"""Wall time of tpuflow3d_torch.compute_flow at 256^3 on one NVIDIA GPU, for
the package of a given checkout, so that two checkouts can be timed in turns
one after the other on one card:

    for r in build/parent . . build/parent; do
        python3 bench/torch_e2e_wall.py --root $r
    done

Each run is one compute_flow call from numpy volumes to a synchronized
device on the host clock (the copy to the card included), through the
kernels (backend "auto"), on the blob translation (1.5, -1, 0.75), seed 0,
that chip_smoke.py uses, made in each process with the --root package's
synthetic module. The first run of each path warms up and is printed apart.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

PATHS = {"ladder256": ("ladder256", {}), "gamma": ("ladder256", {"gamma": 1.0}),
         "accurate": ("accurate", {}),
         "packed": ("ladder256", {"sweep_layout": "packed"})}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="root of the checkout")
    ap.add_argument("--paths", default="ladder256,gamma,accurate")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    from tpuflow3d_torch import PRESETS, compute_flow, kernels, synthetic as syn

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    i0, i1, _ = syn.make_pair((256,) * 3, syn.translation((1.5, -1.0, 0.75)),
                              seed=0)
    kernels.load_library()
    dev = torch.device("cuda", 0)
    for name in args.paths.split(","):
        preset, changes = PATHS[name]
        p = PRESETS[preset].replace(**changes)
        times = []
        for _ in range(args.runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute_flow(i0, i1, p, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rest = times[1:]
        print(f"{card}; root {args.root}; {name}: first {times[0]:.4f} s; "
              f"then median {statistics.median(rest):.4f} s (min "
              f"{min(rest):.4f}, max {max(rest):.4f}, {len(rest)} runs)",
              flush=True)


if __name__ == "__main__":
    main()
