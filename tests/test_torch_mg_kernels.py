"""K10 and K11, the multigrid V-cycle's grid transfers
(``csrc/mg_transfer.cu``), against their plain versions on the card:

(a) K10 (the residual restricted to the next grid) and K11 (the coarse
    correction prolonged and added) bitwise ``restrict_residual_plain``
    and ``prolong_add_plain`` on every pair of grids of the 256^3
    hierarchy, of each pyramid level of ragged volumes with z_multiple 1
    and 8, with rhs in float32 and in bfloat16, the rank-1 data block and
    the general one of gamma > 0; K11 in place bitwise out of place;
(b) a whole ``accurate`` pair at 64^3, graphed, bitwise the same pair with
    the transfers on their plain route, with the same V-cycles (``body``
    replays), and the two launch counters above 0 on the kernel route only;
(c) the kernels refuse what they do not take.

Marked ``cuda``: every test skips when torch.cuda.is_available() is false.
Run them on the card without the conftest (it imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_mg_kernels.py
"""

import pytest
import torch

from tpuflow3d_torch import PRESETS, FlowParams, compute_flow, kernels
from tpuflow3d_torch import mgsolver
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import mg_transfer
from tpuflow3d_torch.solver import SolveTerms

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _hierarchy(shape, dev, seed: int, general: bool):
    """The multigrid levels of a random system on a (D, H, W) grid: the
    rank-1 data block from (g, psi_d), or a general one (gamma > 0)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    psi_s = 0.2 + rnd(*shape).abs()
    g = rnd(3, *shape, scale=0.3)
    psi_d = 0.5 + rnd(*shape).abs()
    d6 = None
    if general:
        h = rnd(3, 3, *shape, scale=0.2)
        d6 = torch.stack([psi_d * g[i] * g[j] + (h[:, i] * h[:, j]).sum(0)
                          for i, j in ((0, 0), (0, 1), (0, 2), (1, 1),
                                       (1, 2), (2, 2))])
    t = SolveTerms(c=rnd(3, *shape), g=g, w=None, sw_inv=None, smt=None,
                   psi_s=psi_s, psi_d=psi_d, d6=d6)
    p = FlowParams(solver="multigrid", alpha=0.05)
    levels = mgsolver.build_mg_levels(t, p, HaloCtx())
    return levels, gen


def _check_transfers(levels, gen, dev, rhs_dtype):
    for li, lvl in enumerate(levels[:-1]):
        shape, coarse = lvl.shape_global, levels[li + 1].shape_global
        du = torch.randn((3, *shape), generator=gen, device=dev) * 0.1
        rhs = torch.randn((3, *shape), generator=gen, device=dev)
        if li == 0:
            rhs = rhs.to(rhs_dtype)
        got = mg_transfer.restrict_residual(du, lvl, rhs, coarse)
        want = mgsolver.restrict_residual_plain(du, lvl, rhs, coarse)
        assert torch.equal(_bits(got), _bits(want)), (
            f"K10 {shape} -> {coarse}: {int((_bits(got) != _bits(want)).sum())}"
            f" values differ, max |diff| {float((got - want).abs().max())}")
        ec = torch.randn((3, *coarse), generator=gen, device=dev) * 0.1
        want = mgsolver.prolong_add_plain(du, ec, shape)
        got = mg_transfer.prolong_add(du, ec, lvl)
        assert torch.equal(_bits(got), _bits(want)), (
            f"K11 {coarse} -> {shape}: {int((_bits(got) != _bits(want)).sum())}"
            f" values differ")
        mine = du.clone()
        assert mg_transfer.prolong_add(mine, ec, lvl, in_place=True) is mine
        assert torch.equal(_bits(mine), _bits(want))
    torch.cuda.synchronize()


@pytest.mark.parametrize("general", [False, True], ids=["rank1", "general"])
@pytest.mark.parametrize("rhs_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_transfers_bitwise_on_the_256_cubed_hierarchy(dev, rhs_dtype,
                                                      general):
    levels, gen = _hierarchy((256, 256, 256), dev, 1, general)
    assert [lvl.shape_global[0] for lvl in levels] == [256, 128, 64, 32, 16,
                                                        8, 4]
    before = dict(kernels.LAUNCHES)
    _check_transfers(levels, gen, dev, rhs_dtype)
    n = len(levels) - 1
    assert kernels.LAUNCHES["mg_restrict"] - before["mg_restrict"] == n
    assert kernels.LAUNCHES["mg_prolong"] - before["mg_prolong"] == 2 * n


@pytest.mark.parametrize("general", [False, True], ids=["rank1", "general"])
@pytest.mark.parametrize("rhs_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("z_multiple", [1, 8])
@pytest.mark.parametrize("shape", [(40, 37, 29), (9, 70, 12), (33, 8, 130)])
def test_transfers_bitwise_on_ragged_grids(dev, shape, z_multiple, rhs_dtype,
                                           general):
    """Every pyramid level of a ragged volume (Z padded to z_multiple, as
    compute_flow pads it), and each level's whole hierarchy: ratios that
    are not 2:1."""
    p = FlowParams(z_multiple=z_multiple, levels=3)
    seen = set()
    for k, lshape in enumerate(p.level_shapes(shape)):
        levels, gen = _hierarchy(lshape, dev, k, general)
        seen |= {(a.shape_global, b.shape_global)
                 for a, b in zip(levels, levels[1:])}
        _check_transfers(levels, gen, dev, rhs_dtype)
    ratios = {f[a] / c[a] for f, c in seen for a in range(3)}
    assert seen and (shape != (40, 37, 29) or any(r != 2.0 for r in ratios))


def test_accurate_pair_graphed_is_the_plain_route(dev, monkeypatch):
    """A 64^3 ``accurate`` pair through the graphs: bitwise the same pair
    with the transfers on their plain route, with as many V-cycles, and
    K10 and K11 launched only on the kernel route."""
    from tpuflow3d_torch import graphs
    p = PRESETS["accurate"]
    i0, i1, _ = syn.make_pair((64, 64, 64),
                              syn.translation((1.5, -1.0, 0.75)))

    def run():
        graphs.clear()
        kernels.reset_launches()
        flow = compute_flow(i0, i1, p, device=dev)
        (info,) = graphs.entries().values()
        graphs.clear()
        return flow, dict(kernels.LAUNCHES), info["replays_by_key"]

    got, launched, replays = run()
    assert launched["mg_restrict"] > 0 and launched["mg_prolong"] > 0
    assert launched["mg_prolong"] == launched["mg_restrict"]
    monkeypatch.setattr(mgsolver, "transfers_on_kernel",
                        lambda p, x, ctx: False)
    want, plain_launched, plain_replays = run()
    assert plain_launched["mg_restrict"] == plain_launched["mg_prolong"] == 0
    assert torch.equal(_bits(got), _bits(want))
    bodies = {k: n for k, n in replays.items() if k[0] == "body"}
    assert bodies and bodies == {k: n for k, n in plain_replays.items()
                                 if k[0] == "body"}
    assert {k: n for k, n in launched.items()
            if k not in ("mg_restrict", "mg_prolong")} == \
        {k: n for k, n in plain_launched.items()
         if k not in ("mg_restrict", "mg_prolong")}


def test_transfer_kernels_refuse_what_they_do_not_take(dev):
    levels, gen = _hierarchy((16, 12, 10), dev, 3, False)
    lvl, coarse = levels[0], levels[1].shape_global
    du = torch.zeros((3, 16, 12, 10), device=dev)
    rhs = torch.zeros_like(du)
    with pytest.raises(ValueError, match="no lerp tables"):
        mg_transfer.restrict_residual(du, lvl._replace(down=None), rhs,
                                      coarse)
    with pytest.raises(ValueError, match="ratios of at most 2"):
        mg_transfer.restrict_residual(du, lvl, rhs, (8, 5, 5))
    with pytest.raises(TypeError):
        mg_transfer.restrict_residual(du, lvl, rhs.double(), coarse)
    ec = torch.zeros((3, *coarse), device=dev)
    with pytest.raises(ValueError, match="not contiguous"):
        mg_transfer.prolong_add(du.transpose(2, 3).contiguous().transpose(
            2, 3), ec, lvl)
    with pytest.raises(ValueError, match="keeps its length"):
        mg_transfer.restrict_residual(du, lvl, rhs, (16, *coarse[1:]))
    with pytest.raises(ValueError, match="table 0"):
        mg_transfer.prolong_add(du, ec, lvl._replace(
            up=(lvl.up[1],) + lvl.up[1:]))
