"""The benchmark's gradient-constancy cell ``gamma-512-incore`` on the CPU:

- ``spec.Cell`` loads it: ``ladder``'s parameters with gamma 1, the
  ``gradient`` reference, the moving volume offset by 0.25 std, 6 levels
  at 512^3;
- the port's normal path (``compute_flow`` with the configuration's own
  parameters, backend ``auto``) agrees with ``reference/gradient.py`` on an
  offset pair of ``gen.make_pair`` at 32^3: on the CPU ``auto`` runs the
  plain versions, whose operations the reference repeats one for one
  (bitwise at 512^3 on the card too), so the tolerance is 0; and the
  gradient-constancy term is in play (the flow is not gamma 0's);
- ``flowbench/metrics/gc_sor_roofline_share.py`` on synthetic traces: a
  known K6 time gives a known share; there is none at gamma 0, under
  multigrid, or without K6 time.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from flowbench import gen, spec, yardstick  # noqa: E402
from flowbench.devtrace import PAIR, Event, Observed  # noqa: E402
from flowbench.reference import gradient, solve  # noqa: E402

torch.set_num_threads(2)

CELL = "gamma-512-incore"
CARD = "NVIDIA H100 80GB HBM3"
K6_NAME = "void tf3d_sweep::fused_kernel<float, true, true>"
SHAPE = (32, 32, 32)


def _json(*parts):
    return json.loads(REPO.joinpath("flowbench", *parts).read_text())


def test_the_cell_loads():
    cell = spec.Cell(CELL)
    ladder = _json("configs", "ladder.json")["params"]
    gc = {"gamma": 1.0, "penalizer_grad": "charbonnier", "eps_grad": 0.001}
    assert cell.config["params"] == {**ladder, **gc}
    assert cell.params == {**ladder, **gc, "levels": 6}
    assert cell.reference is spec.reference("gradient")
    assert cell.reference.__file__ == gradient.__file__
    assert cell.traffic["intensity"] == {"kind": "offset",
                                         "std_fraction": 0.25}
    incore = _json("traffic", "incore.json")
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("intensity", "why")} == {
        k: v for k, v in incore.items() if k != "why"}
    assert cell.shape == (512, 512, 512) and cell.chips == 1
    assert cell.mode == "incore"
    shapes = cell.reference.Params.from_dict(cell.params).level_shapes(
        cell.shape)
    assert len(shapes) == 6 and shapes[-1] == (16, 16, 16)
    assert set(cell.limits) == {"flow_max_gap", "flow_mean_gap"}
    layer = {m["name"] for m in cell.per_layer}
    assert "gc_sor_roofline_share" in layer
    assert not {"sor_roofline_share", "terms_roofline_share"} & layer


def test_the_normal_path_agrees_with_the_gradient_reference():
    from tpuflow3d_torch import FlowParams, compute_flow
    cell = spec.Cell(CELL)
    params = spec.solver_params(cell.config, cell.traffic, SHAPE)
    assert params["levels"] == 2 and params["backend"] == "auto"
    tr = cell.traffic
    i0, i1 = gen.make_pair(SHAPE, [2**31 + 7, 0], tr["texture"],
                           tr["deformation"], "cpu", tr["intensity"])
    i0, i1 = torch.as_tensor(i0), torch.as_tensor(i1)
    got = compute_flow(i0.numpy(), i1.numpy(), FlowParams(**params),
                       device="cpu").numpy()
    ref = gradient.solve(i0, i1, gradient.Params.from_dict(params)).numpy()
    assert np.abs(got - ref).max() == 0.0
    flat = solve.solve(i0, i1, solve.Params.from_dict(
        dict(params, gamma=0.0))).numpy()
    assert np.abs(got - flat).max() > 0.1


def _observed(k6_s: float, pairs: int = 2, **params):
    cell = spec.Cell(CELL)
    shapes = cell.reference.Params.from_dict(cell.params).level_shapes(
        cell.shape)
    ns = 10 ** 9
    evs = [Event(PAIR, 0, 5 * ns, "host"), Event(PAIR, 5 * ns, 10 * ns,
                                                  "host"),
           Event("void tf3d_sweep::fused_kernel<float, false, true>", ns,
                 2 * ns, "kernel"),
           Event("Memcpy DtoH (Device -> Pageable)", 3 * ns, 4 * ns,
                 "memcpy")]
    if k6_s > 0:
        evs.append(Event(K6_NAME, 6 * ns, 6 * ns + int(k6_s * ns),
                         "kernel"))
    p = {**cell.params, **params}
    return Observed(evs, pairs, p, shapes, cell.mode, CARD, {}, {},
                    0.0), shapes


def _read():
    return spec.Cell(CELL).reader("gc_sor_roofline_share")


def test_share_from_known_seconds():
    obs, shapes = _observed(2.0)
    p = obs.params
    nbytes = (2 * p["warps"] * p["inner_iterations"] * p["sweeps"] * 64
              * sum(d * h * w for d, h, w in shapes))
    assert yardstick.SWEEP_BYTES["general"] == 64
    want = 100.0 * nbytes / yardstick.HBM_BW[CARD] / 2.0
    assert _read()(obs) == pytest.approx(want, rel=1e-12)
    # 3 x 3 x 20 sweeps on 6 levels (512^3 to 16^3): 1.767 TB a pair.
    assert 180 * 64 * sum(d * h * w for d, h, w in shapes) == 1767065518080


@pytest.mark.parametrize("params", [{"gamma": 0.0},
                                    {"solver": "multigrid"},
                                    {"solver": "jacobi"}])
def test_no_share_where_k6_is_not_the_gamma_sweep(params):
    obs, _ = _observed(2.0, **params)
    assert _read()(obs) is None


def test_no_share_without_kernel_time():
    obs, _ = _observed(0.0)
    assert _read()(obs) is None
    assert _read()(None) is None
    obs, _ = _observed(2.0)
    obs.card = "an unlisted card"
    assert _read()(obs) is None
