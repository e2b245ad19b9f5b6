"""The frozen plain reference against the port's plain solve, and what
the benchmark imports.

At 32^3 on the CPU ``reference.solve`` gave the flow of
``tpuflow3d_torch.compute_flow(..., device="cpu")`` with ``backend="plain"``
bit for bit (max |difference| 0.0) for both configurations, and with
``stream_chunk`` that of ``piecewise.compute_flow_piecewise`` (chunks of 8,
12 and 64 planes), so the tolerance is 0: the reference is a copy of the
same arithmetic, operation for operation.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from flowbench import gen, spec  # noqa: E402
from flowbench.reference import solve as reference  # noqa: E402

SHAPE = (32, 32, 32)


@pytest.mark.parametrize("config", ["ladder", "accurate"])
def test_reference_is_the_plain_solve(config):
    from tpuflow3d_torch import FlowParams, compute_flow
    cfg = json.loads((REPO / "flowbench" / "configs"
                      / f"{config}.json").read_text())
    tr = json.loads((REPO / "flowbench" / "traffic" / "incore.json")
                    .read_text())
    params = spec.solver_params(dict(cfg, coarsest_planes=16), tr, SHAPE)
    i0, i1 = gen.make_pair(SHAPE, [11, 0], tr["texture"], tr["deformation"],
                           "cpu")
    want = compute_flow(i0, i1, FlowParams(**dict(params, backend="plain")),
                        device="cpu").numpy()
    got = reference.solve(torch.as_tensor(i0), torch.as_tensor(i1),
                          reference.Params.from_dict(params)).numpy()
    assert np.abs(got - want).max() == 0.0


@pytest.mark.parametrize("chunk", [12, 64])
def test_streamed_reference_is_the_streamed_solve(chunk):
    from tpuflow3d_torch import FlowParams
    from tpuflow3d_torch.piecewise import compute_flow_piecewise
    cfg = json.loads((REPO / "flowbench" / "configs" / "ladder.json")
                     .read_text())
    tr = json.loads((REPO / "flowbench" / "traffic" / "stream-c64.json")
                    .read_text())
    params = spec.solver_params(dict(cfg, coarsest_planes=16), tr, SHAPE)
    i0, i1 = gen.make_pair(SHAPE, [12, 1], tr["texture"], tr["deformation"],
                           "cpu")
    want = compute_flow_piecewise(i0, i1, FlowParams(**params),
                                  chunk_z=chunk, device="cpu")
    p = reference.Params.from_dict(params)
    got = reference.solve(torch.as_tensor(i0), torch.as_tensor(i1), p,
                          chunk).numpy()
    assert np.abs(got - want).max() == 0.0
    # In core the two part at the faces and the slabs' seams.
    incore = reference.solve(torch.as_tensor(i0), torch.as_tensor(i1),
                             p).numpy()
    assert np.abs(incore - want).max() > 1e-3


def test_reference_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError):
        reference.Params.from_dict({"gamma": 1.0})
    with pytest.raises(ValueError):
        reference.Params.from_dict({"terms_dtype": "bfloat16"})


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, env=env, check=True, cwd=REPO)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_run_py_runs_imports_jax():
    """Everything run.py imports (the harness, the program's entries, the
    reference, every metric reader), compared by whole top-level name:
    tpuflow3d_torch is the program and allowed, tpuflow3d is not."""
    tops = _loaded(
        "import runpy, glob\n"
        "import flowbench.run, flowbench.harness, flowbench.system\n"
        "import flowbench.devtrace, flowbench.gen, flowbench.spec\n"
        "import flowbench.reference.solve, flowbench.readings\n"
        "import tpuflow3d_torch, tpuflow3d_torch.piecewise\n"
        "import tpuflow3d_torch.graphs, tpuflow3d_torch.kernels\n"
        "from flowbench import spec\n"
        "for f in glob.glob('flowbench/metrics/*.py'):\n"
        "    runpy.run_path(f)\n")
    assert "tpuflow3d_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpuflow3d", "bench"}


def test_reference_imports_nothing_of_the_program():
    tops = _loaded("import flowbench.reference.solve")
    assert not tops & {"jax", "jaxlib", "flax", "tpuflow3d",
                       "tpuflow3d_torch"}
