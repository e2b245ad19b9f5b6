"""The benchmark of tpuflow3d_torch: one run of one cell.

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number beside its limit,
also the last lines of standard error). Exits non-zero, printing no
result, where there is no CUDA device or fewer than the cell asks for, or
where JAX or the JAX package was loaded. ``--device cpu`` is for the
benchmark's own tests only: it runs a cell on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root (for ``flowbench``) and its program; never the
# script's own directory, whose module names could shadow others.
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from flowbench import harness
    sys.exit(harness.main(parse()))
