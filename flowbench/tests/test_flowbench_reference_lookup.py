"""A configuration's own reference, found by name, decides ``correct``; a
traffic's brightness change; the gradient-constancy reference.

- A temporary copy of ``flowbench/`` (``test_flowbench_harness._copy``)
  gets a reference module as a new file and its configuration names it
  (``"reference"``): ``run.py --device cpu`` checks the cell against that
  module. One that returns ``solve.solve``'s flow plus 1 reads
  ``flow_max_gap`` 1 and ``correct`` false; the configuration without the
  key reads gap 0 and ``correct`` true; a name with no file exits non-zero
  with no result and names the file.
- ``gen.make_pair``'s ``intensity``: without it the pair is as before;
  ``offset`` adds exactly float32(k * std(i1)) to i1 and leaves i0.
- ``reference/gradient.py`` against the port's plain solve with gamma 1
  (``compute_flow(..., backend="plain")``) on the CPU at 32^3 under that
  offset: SOR with the trilinear warp (``ladder``) and multigrid with the
  tricubic one (``accurate``). Measured max |difference| 0.0 in both, with
  slabs of 2 planes (the seams crossed) and of the whole volume, so the
  tolerance is 0. At gamma 0 it is ``solve.solve`` bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_flowbench_harness import REPO, _copy, run_cell

sys.path[:0] = [str(REPO), str(REPO / "src")]

from flowbench import gen, spec  # noqa: E402
from flowbench.reference import gradient, solve  # noqa: E402

torch.set_num_threads(2)

SHAPE = (32, 32, 32)
OFFSET = {"kind": "offset", "std_fraction": 0.25}
PLUS_ONE = '''
from flowbench.reference.solve import Params, solve as _solve


def solve(i0, i1, p, stream_chunk=None):
    return _solve(i0, i1, p, stream_chunk) + 1.0
'''


def _checkout(tmp_path, reference: str | None):
    """The harness tests' checkout, its tiny configuration naming
    ``reference`` (none where None), and the module ``plus_one`` added."""
    root = _copy(tmp_path, "incore")
    fb = root / "flowbench"
    (fb / "reference" / "plus_one.py").write_text(PLUS_ONE)
    path = fb / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    if reference is not None:
        cfg["reference"] = reference
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("reference, correct, gap", [
    (None, True, 0.0), ("solve", True, 0.0), ("plus_one", False, 1.0)])
def test_the_named_reference_decides(tmp_path, reference, correct, gap):
    rc, out, err = run_cell(_checkout(tmp_path, reference))
    assert rc == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert last["correct"] is correct, last["checks"]
    assert last["checks"]["flow_max_gap"]["value"] == pytest.approx(
        gap, abs=1e-6)
    assert (last["failed"] >= 1) is (not correct)


def test_a_missing_reference_names_its_file(tmp_path):
    rc, out, err = run_cell(_checkout(tmp_path, "no_such_reference"))
    assert rc != 0
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "reference/no_such_reference.py" in err


def test_a_reference_name_is_a_name():
    with pytest.raises(ValueError):
        spec.reference("../configs/ladder")


def test_cells_without_the_key_take_solve():
    held = 0
    for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]:
        cfg = json.loads((REPO / "flowbench" / "configs"
                          / f"{w['config']}.json").read_text())
        if "reference" not in cfg:
            assert spec.Cell(w["name"]).reference.__file__ == solve.__file__
            held += 1
    assert held >= 1
    # The gradient-constancy cell names its own.
    assert spec.Cell("gamma-512-incore").reference.__file__ == \
        gradient.__file__


@pytest.mark.parametrize("seed", [[3, 0], [2**31 + 5, 1]])
def test_intensity_offset(seed):
    tex = {"kind": "fourier", "modes": 64, "kmin": 0.2, "kmax": 0.7}
    deform = {"kind": "sinusoid", "amplitude": 1.5, "periods": 1.0}
    a0, a1 = gen.make_pair(SHAPE, seed, tex, deform, "cpu")
    b0, b1 = gen.make_pair(SHAPE, seed, tex, deform, "cpu", None)
    assert a0.tobytes() == b0.tobytes() and a1.tobytes() == b1.tobytes()
    c0, c1 = gen.make_pair(SHAPE, seed, tex, deform, "cpu", OFFSET)
    assert c0.tobytes() == a0.tobytes()
    shift = np.float32(0.25 * np.std(a1.astype(np.float64)))
    assert shift > 0.05
    assert c1.dtype == np.float32
    assert c1.tobytes() == (a1 + shift).tobytes()
    with pytest.raises(ValueError):
        gen.make_pair(SHAPE, seed, tex, deform, "cpu",
                      {"kind": "gain", "std_fraction": 0.25})


def _case(config: str):
    cfg = json.loads((REPO / "flowbench" / "configs"
                      / f"{config}.json").read_text())
    tr = json.loads((REPO / "flowbench" / "traffic" / "incore.json")
                    .read_text())
    params = spec.solver_params(dict(cfg, coarsest_planes=16), tr, SHAPE)
    i0, i1 = gen.make_pair(SHAPE, [13, 0], tr["texture"], tr["deformation"],
                           "cpu", OFFSET)
    return params, torch.as_tensor(i0), torch.as_tensor(i1)


@pytest.mark.parametrize("slab_planes", [2, None])
@pytest.mark.parametrize("config", ["ladder", "accurate"])
def test_gradient_reference_is_the_plain_gamma_solve(monkeypatch, config,
                                                     slab_planes):
    from tpuflow3d_torch import FlowParams, compute_flow
    params, i0, i1 = _case(config)
    params = dict(params, gamma=1.0)
    want = compute_flow(i0, i1, FlowParams(**dict(params, backend="plain")),
                        device="cpu").numpy()
    if slab_planes is not None:
        monkeypatch.setattr(solve, "_SLAB_VOXELS",
                            slab_planes * SHAPE[1] * SHAPE[2])
    got = gradient.solve(i0, i1, gradient.Params.from_dict(params)).numpy()
    assert np.abs(got - want).max() == 0.0
    # The term is in play: the flow is not gamma 0's.
    flat = solve.solve(i0, i1, solve.Params.from_dict(
        dict(params, gamma=0.0))).numpy()
    assert np.abs(got - flat).max() > 0.1


@pytest.mark.parametrize("config", ["ladder", "accurate"])
def test_gradient_reference_at_gamma_0_is_solve(config):
    params, i0, i1 = _case(config)
    got = gradient.solve(i0, i1, gradient.Params.from_dict(params))
    want = solve.solve(i0, i1, solve.Params.from_dict(params))
    assert torch.equal(got, want)


def test_gradient_reference_refuses_what_it_does_not_compute():
    p = gradient.Params.from_dict({"gamma": 2.0, "penalizer_grad":
                                   "quadratic", "eps_grad": 0.01})
    assert (p.gamma, p.penalizer_grad, p.eps_grad) == (2.0, "quadratic",
                                                      0.01)
    for bad in ({"gamma": -1.0}, {"gamma": 1.0, "deriv_order": 4},
                {"gamma": 1.0, "terms_dtype": "bfloat16"},
                {"gamma": 1.0, "solver": "jacobi"}):
        with pytest.raises(ValueError):
            gradient.Params.from_dict(bad)
    i0 = torch.zeros((16, 16, 16))
    with pytest.raises(ValueError):
        gradient.solve(i0, i0, p, 8)


def test_gradient_reference_imports_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, json\n"
         "import flowbench.reference.gradient\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, env=env, check=True, cwd=REPO)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "tpuflow3d",
                       "tpuflow3d_torch"}
