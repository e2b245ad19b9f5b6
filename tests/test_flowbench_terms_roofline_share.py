"""flowbench/metrics/terms_roofline_share.py on synthetic traces: the share
of K8's roofline from known kernel seconds in the benchmark's in-core
cells, and no share where K8 does not run (the streamed mode, gamma > 0,
Jacobi) or left no kernel time (a program without it)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from flowbench import spec, yardstick  # noqa: E402
from flowbench.devtrace import PAIR, Event, Observed  # noqa: E402
from flowbench.reference import solve as reference  # noqa: E402

read = spec.Cell("ladder-512-incore").reader("terms_roofline_share")
K8_NAME = "void tf3d_terms::rank1_kernel(tf3d_terms::Args, int)"
CARD = "NVIDIA H100 80GB HBM3"


def _observed(cell: str, k8_s: float, pairs: int = 2, **params):
    c = spec.Cell(cell)
    shapes = reference.Params.from_dict(c.params).level_shapes(c.shape)
    p = {**c.params, **params}
    ns = 10 ** 9
    evs = [Event(PAIR, 0, 5 * ns, "host"), Event(PAIR, 5 * ns, 10 * ns,
                                                  "host"),
           Event("void tf3d_sweep::fused_kernel<float, false, true>", ns,
                 2 * ns, "kernel"),
           Event("Memcpy DtoH (Device -> Pageable)", 3 * ns, 4 * ns,
                 "memcpy")]
    if k8_s > 0:
        evs.append(Event(K8_NAME, 6 * ns, 6 * ns + int(k8_s * ns), "kernel"))
    return Observed(evs, pairs, p, shapes, c.mode, CARD, {}, {}, 0.0), shapes


@pytest.mark.parametrize("cell", ["ladder-512-incore",
                                  "accurate-256-incore"])
def test_share_from_known_seconds(cell):
    obs, shapes = _observed(cell, 0.25)
    p = obs.params
    nbytes = (2 * p["warps"] * p["inner_iterations"] * 60
              * sum(d * h * w for d, h, w in shapes))
    want = 100.0 * nbytes / yardstick.HBM_BW[CARD] / 0.25
    assert read(obs) == pytest.approx(want, rel=1e-12)
    # ladder512 at 512^3: 54 calls a pair over 6 levels.
    if cell == "ladder-512-incore":
        assert len(shapes) == 6 and p["warps"] * p["inner_iterations"] == 9


@pytest.mark.parametrize("cell, params", [
    ("ladder-256-stream", {}),
    ("ladder-512-incore", {"gamma": 1.0}),
    ("ladder-512-incore", {"solver": "jacobi"}),
])
def test_no_share_where_k8_does_not_run(cell, params):
    obs, _ = _observed(cell, 0.25, **params)
    assert read(obs) is None


def test_no_share_without_kernel_time():
    obs, _ = _observed("ladder-512-incore", 0.0)
    assert read(obs) is None
    assert read(None) is None
    unknown, _ = _observed("accurate-256-incore", 0.25)
    unknown.card = "an unlisted card"
    assert read(unknown) is None
