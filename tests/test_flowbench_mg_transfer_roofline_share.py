"""flowbench/metrics/mg_transfer_roofline_share.py on synthetic traces: the
share of K10's and K11's roofline from known kernel seconds and known
V-cycles (``("body", level)`` replays) in the multigrid cell, and no share
outside multigrid, without ``tf3d_mg::`` time (a program without the
kernels) or without a V-cycle."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from flowbench import spec, yardstick  # noqa: E402
from flowbench.devtrace import PAIR, Event, Observed  # noqa: E402
from flowbench.reference import solve as reference  # noqa: E402

read = spec.Cell("accurate-256-incore").reader("mg_transfer_roofline_share")
K10 = "void tf3d_mg::restrict_kernel<float>(tf3d_mg::RArgs<float>)"
K11 = "void tf3d_mg::prolong_kernel(tf3d_mg::PArgs)"
K6 = "void tf3d_sweep::fused_kernel<float, true, true>(tf3d_sweep::Args)"
CARD = "NVIDIA H100 80GB HBM3"


def _observed(cell: str, k10_s: float, k11_s: float, replays: dict,
              **params):
    c = spec.Cell(cell)
    shapes = c.reference.Params.from_dict(c.params).level_shapes(c.shape)
    p = {**c.params, **params}
    ns = 10 ** 9
    evs = [Event(PAIR, 0, 5 * ns, "host"), Event(PAIR, 5 * ns, 10 * ns,
                                                  "host"),
           Event(K6, ns, 2 * ns, "kernel"),
           Event("Memcpy DtoH (Device -> Pageable)", 3 * ns, 4 * ns,
                 "memcpy")]
    if k10_s > 0:
        evs.append(Event(K10, 6 * ns, 6 * ns + int(k10_s * ns), "kernel"))
    if k11_s > 0:
        evs.append(Event(K11, 8 * ns, 8 * ns + int(k11_s * ns), "kernel"))
    return Observed(evs, 2, p, shapes, c.mode, CARD, replays, {}, 0.0), shapes


# Two V-cycles on the finest level, five on level 3, and graphs that are
# not V-cycles (they move no grid transfer).
REPLAYS = {("body", 0): 2, ("body", 3): 5, ("pre", 0): 16, ("prep",): 2,
           ("terms", 3): 32}


def _bytes(shape) -> int:
    grids = reference.mg_shapes(shape)
    return sum(76 * yardstick.voxels(f) + 24 * yardstick.voxels(c)
               for f, c in zip(grids, grids[1:]))


def test_share_from_known_seconds_and_v_cycles():
    obs, shapes = _observed("accurate-256-incore", 0.002, 0.001, REPLAYS)
    assert shapes[0] == (256, 256, 256)
    nbytes = 2 * _bytes(shapes[0]) + 5 * _bytes(shapes[3])
    want = 100.0 * nbytes / yardstick.HBM_BW[CARD] / 0.003
    assert read(obs) == pytest.approx(want, rel=1e-12)
    # The finest level's hierarchy: 7 grids, 6 transfers each way; at
    # 256^3 one V-cycle moves 76 B a voxel of every grid but the
    # coarsest and 24 B a voxel of every grid but the finest.
    grids = reference.mg_shapes(shapes[0])
    assert len(grids) == 7 and grids[1] == (128, 128, 128)
    assert _bytes(shapes[0]) == 76 * sum(d ** 3 for d in
                                         (256, 128, 64, 32, 16, 8)) \
        + 24 * sum(d ** 3 for d in (128, 64, 32, 16, 8, 4))


def test_no_share_without_kernel_time_or_v_cycles():
    assert read(None) is None
    none, _ = _observed("accurate-256-incore", 0.0, 0.0, REPLAYS)
    assert read(none) is None
    no_cycles, _ = _observed("accurate-256-incore", 0.002, 0.001,
                             {("prep",): 2, ("warp", 0): 6})
    assert read(no_cycles) is None
    unknown, _ = _observed("accurate-256-incore", 0.002, 0.001, REPLAYS)
    unknown.card = "an unlisted card"
    assert read(unknown) is None


@pytest.mark.parametrize("cell", ["ladder-512-incore", "gamma-512-incore",
                                  "ladder-256-stream"])
def test_no_share_outside_multigrid(cell):
    obs, _ = _observed(cell, 0.002, 0.001, REPLAYS)
    assert obs.params["solver"] != "multigrid"
    assert read(obs) is None


def test_the_kernels_are_not_the_smoothers():
    """K10 and K11 count toward neither K6's share nor each other's
    smoother bytes: mg_smoother_roofline_share reads the same trace with
    K6's second alone."""
    import re
    from flowbench.metrics import mg_smoother_roofline_share as smoother
    assert not re.search(smoother.K6, K10) and not re.search(smoother.K6,
                                                             K11)
    obs, _ = _observed("accurate-256-incore", 0.002, 0.001, REPLAYS)
    assert obs.seconds(smoother.K6) == pytest.approx(1.0)
