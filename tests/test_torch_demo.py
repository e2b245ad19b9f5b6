"""examples/demo_synthetic_torch.py, the port's demo, against the JAX
package's: run as a process on the CPU at 24^3 (in-core, streamed, and
Z-sharded on two gloo ranks), it prints the same registration report, and
the mean EPE it reports is the JAX package's on the same pair and
parameters (within 1e-4 and the report's four decimals: the pipelines
agree to ~1e-5, tests/test_torch_pipeline.py)."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow3d import FlowParams, compute_flow
from tpuflow3d import synthetic as ref_syn
from tpuflow3d.piecewise import compute_flow_piecewise

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "examples" / "demo_synthetic_torch.py"
SIZE = 24


def _reference_epe(mode: str) -> float:
    """What examples/demo_synthetic.py computes, through the JAX package
    (a sharded flow is the one-device flow's bits in the port)."""
    shape = (SIZE,) * 3
    fn = ref_syn.sinusoid(shape, amplitude=1.2)
    i0, i1, true = ref_syn.make_pair(shape, fn, texture="fourier")
    p = FlowParams(levels=3, alpha=0.02, warps=3, inner_iterations=3,
                   sweeps=20)
    if mode == "--piecewise":
        flow = compute_flow_piecewise(i0, i1, p, chunk_z=16)
    else:
        flow = np.asarray(compute_flow(i0, i1, p))
    return ref_syn.epe(flow, true, ref_syn.interior_mask(shape, 4))


@pytest.mark.parametrize("mode", ["", "--piecewise", "--sharded"])
def test_demo_reports_the_references_epe(mode, tmp_path):
    env = {**os.environ, "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    res = subprocess.run(
        [sys.executable, str(DEMO), "--size", str(SIZE), "--platform", "cpu",
         *([mode] if mode else [])],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == (f"synthesizing {(SIZE,) * 3} pair (sinusoidal "
                        "deformation, dense texture)...")
    m = re.fullmatch(r"solved in [\d.]+s  ->  mean EPE ([\d.]+) voxels "
                     r"\(mean \|s\| = ([\d.]+)\)", lines[1])
    assert m, lines[1]
    m_out = re.fullmatch(r"flow components written to (.+)"
                         r"\{u,v,w,magnitude\}\.raw", lines[2])
    assert m_out, lines[2]
    for c in "uvw":
        assert os.path.getsize(f"{m_out.group(1)}{c}.raw") == 4 * SIZE ** 3
    assert abs(float(m.group(1)) - _reference_epe(mode)) <= 1e-4 + 5e-5


def test_demo_without_a_gpu_exits_2(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("demo_synthetic_torch",
                                                  DEMO)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert demo.main(["--size", "8"]) == 2
    assert "--platform cpu" in capsys.readouterr().err
