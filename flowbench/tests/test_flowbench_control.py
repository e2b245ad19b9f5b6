"""The control: the program with its sweep constants stored in bfloat16
(``terms_dtype``), the nearest precision below the configurations'
float32, must break a limit of each cell; the program as configured must
not.

Each cell's own configuration, traffic and limits, at 32^3 on the CPU
(streamed in chunks of 12 planes, so the slabs' seams are crossed); on
the card, at the cells' sizes, ``readings.py --control`` takes the same
readings (PERF.md lists them).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from flowbench import harness, spec  # noqa: E402

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _readings(name: str, control: bool) -> tuple[dict, int]:
    cell = spec.Cell(name)
    cell.shape = (32, 32, 32)
    if cell.mode == "stream":
        cell.traffic = dict(cell.traffic, chunk_z=12)
    cell.params = spec.solver_params(cell.config, cell.traffic, cell.shape)
    bench = harness.Bench(cell, torch.device("cpu"),
                          "bfloat16" if control else None)
    pairs = bench.make_pairs(2**31 + 99)
    _, _, kept, _ = bench.window(pairs, 0.0, 2**31 + 99)
    return bench.check(pairs, kept, 2**31 + 99, cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_program_within_and_control_past_the_limits(name):
    gaps, failed = _readings(name, control=False)
    assert failed == 0, gaps
    gaps, failed = _readings(name, control=True)
    assert failed >= 1, gaps
