"""flowbench/metrics/gc_terms_roofline_share.py on synthetic traces: the
share of K9's roofline from known kernel seconds in ``gamma-512-incore``;
no share at gamma 0, in the streamed mode, under multigrid or Jacobi, or
where K9 left no kernel time (a program without it: K8's kernel does not
count); and ``BENCHMARK.json`` lists the metric with its one cell."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from flowbench import spec, yardstick  # noqa: E402
from flowbench.devtrace import PAIR, Event, Observed  # noqa: E402

CELL = "gamma-512-incore"
METRIC = "gc_terms_roofline_share"
read = spec.Cell(CELL).reader(METRIC)
K9_NAME = ("void tf3d_terms::gc_kernel(tf3d_terms::Args, tf3d_terms::GcArgs, "
           "int)")
K8_NAME = "void tf3d_terms::rank1_kernel(tf3d_terms::Args, int)"
CARD = "NVIDIA H100 80GB HBM3"


def _observed(cell: str, k9_s: float, pairs: int = 2, kernel=K9_NAME,
              **params):
    c = spec.Cell(cell)
    shapes = c.reference.Params.from_dict(c.params).level_shapes(c.shape)
    p = {**c.params, **params}
    ns = 10 ** 9
    evs = [Event(PAIR, 0, 5 * ns, "host"), Event(PAIR, 5 * ns, 10 * ns,
                                                  "host"),
           Event("void tf3d_sweep::fused_kernel<float, true, true>", ns,
                 2 * ns, "kernel"),
           Event("Memcpy DtoH (Device -> Pageable)", 3 * ns, 4 * ns,
                 "memcpy")]
    if k9_s > 0:
        evs.append(Event(kernel, 6 * ns, 6 * ns + int(k9_s * ns), "kernel"))
    return Observed(evs, pairs, p, shapes, c.mode, CARD, {}, {}, 0.0), shapes


def test_share_from_known_seconds():
    obs, shapes = _observed(CELL, 0.25)
    p = obs.params
    nbytes = (2 * p["warps"] * p["inner_iterations"] * 128
              * sum(d * h * w for d, h, w in shapes))
    want = 100.0 * nbytes / yardstick.HBM_BW[CARD] / 0.25
    assert read(obs) == pytest.approx(want, rel=1e-12)
    # 54 calls a pair over 6 levels at 512^3.
    assert len(shapes) == 6 and p["warps"] * p["inner_iterations"] == 9


@pytest.mark.parametrize("cell, params", [
    (CELL, {"gamma": 0.0}),
    (CELL, {"solver": "multigrid"}),
    (CELL, {"solver": "jacobi"}),
    ("ladder-512-incore", {}),
    ("ladder-256-stream", {"gamma": 1.0}),
])
def test_no_share_where_k9_does_not_run(cell, params):
    obs, _ = _observed(cell, 0.25, **params)
    assert read(obs) is None


def test_no_share_without_kernel_time():
    obs, _ = _observed(CELL, 0.0)
    assert read(obs) is None
    assert read(None) is None
    k8_only, _ = _observed(CELL, 0.25, kernel=K8_NAME)
    assert read(k8_only) is None
    unknown, _ = _observed(CELL, 0.25)
    unknown.card = "an unlisted card"
    assert read(unknown) is None


def test_the_benchmark_lists_it_in_its_cell():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry, = (m for m in bench["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "voxels_per_s"
    assert entry["layer"] == "the system's terms (solver.compute_terms)"
    assert [m["name"] for m in spec.Cell(CELL).per_layer].count(METRIC) == 1
    assert METRIC not in [m["name"]
                          for m in spec.Cell("ladder-512-incore").per_layer]
