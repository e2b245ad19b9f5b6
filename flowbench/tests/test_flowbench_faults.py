"""A run with its timed path broken underneath must come out not correct.

The harness is driven as ``run.py`` drives it (``--device cpu``, the tiny
cell of ``test_flowbench_harness``, in core and streamed), with one fault
planted in the program: every warp iteration (streamed: every level's
solve) returning the flow it was given; half of the volume left unsolved;
one voxel's answer altered where the solve produces it. One chip
exchanges nothing, so there is no exchange to leave out.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from test_flowbench_harness import REPO, _copy

DRIVER = r'''
import sys
root, src, fault = sys.argv[1:4]
sys.path[:0] = [root, src]
from tpuflow3d_torch import graphs, piecewise

solve, streamed = graphs.solve, piecewise.compute_flow_piecewise


def broken(flow):
    d, h, w = flow.shape[-3:]
    if fault == "half":
        flow[:, d // 2:] = 0
    elif fault == "altered":
        flow[0, d // 2, h // 2, w // 2] += 1.0
    return flow


if fault == "unchanged":
    graphs._warp = lambda i0l, i1l, flow, slot, p: (flow.clone(),)
    piecewise._solve_level_streamed = lambda i0l, i1l, flow, *a, **k: flow
else:
    graphs.solve = lambda *a, **k: (broken(solve(*a, **k)[0]), None)
    piecewise.compute_flow_piecewise = lambda *a, **k: broken(
        streamed(*a, **k))

from flowbench import harness, run
sys.exit(harness.main(run.parse(sys.argv[4:])))
'''


@pytest.mark.parametrize("traffic", ["incore", "stream-c64"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(tmp_path, traffic, fault):
    root = _copy(tmp_path, traffic)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", DRIVER, str(root), str(REPO / "src"), fault,
         "--workload", "tiny-cell", "--seed", "123456789012",
         "--seconds", "0.2", "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is False, last["checks"]
    assert last["failed"] >= 1
