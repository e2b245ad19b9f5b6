"""K10 and K11, the multigrid V-cycle's grid transfers
(``csrc/mg_transfer.cu``), on the CPU: the route ``mgsolver._vcycle``
takes, the lerp tables the kernels read, and the solve with the route
forced.

On a CUDA tensor of a whole volume, ``_vcycle`` restricts the residual in
one launch of K10 and prolongs and adds the correction in one of K11
(``kernels/mg_transfer.py``), reading the tables its levels hold. Here the
route is forced by patching ``use_kernels`` in ``mgsolver``; the wrappers
then run their plain versions, ``restrict_residual_plain`` and
``prolong_add_plain``, for the CPU tensors in the launch's place. These
tests hold:

(a) the route rule: a whole volume takes it; windows (whatever their
    origin), Z shards and CPU tensors (``use_kernels`` as it is) do not,
    and their levels hold no tables;
(b) the tables are ``pyramid.resize_axis_local``'s coordinates and
    weights, and resize bitwise as it does, on every transfer of the 256^3
    hierarchy and of each pyramid level of a ragged volume with z_multiple
    1 and 8;
(c) the in-core and the streamed ``accurate`` solves keep their bits with
    the route forced, every V-cycle restricting and prolonging once a
    grid, and K11 writes in place only where the V-cycle owns du.

The kernels against their plain versions run on the card:
tests/test_torch_mg_kernels.py and chip_smoke.py's ``[mg]``.
"""

import numpy as np
import pytest
import torch

from tpuflow3d_torch import PRESETS, FlowParams, mgsolver, pipeline, pyramid
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import mg_transfer
from tpuflow3d_torch.solver import SolveTerms

torch.set_num_threads(2)

D = 16
SHAPE = (D, 12, 10)


def _terms(shape, seed=0):
    rng = np.random.default_rng(seed)

    def t(*s, scale=1.0):
        return torch.from_numpy(np.asarray(rng.normal(size=s) * scale,
                                           np.float32))
    return SolveTerms(c=t(3, *shape), g=t(3, *shape, scale=0.3), w=None,
                      sw_inv=None, smt=None, psi_s=0.2 + t(*shape).abs(),
                      psi_d=0.5 + t(*shape).abs())


@pytest.fixture
def forced(monkeypatch):
    """The route forced; the wrappers' calls recorded as (name, du's
    shape, in_place)."""
    calls = []
    monkeypatch.setattr(mgsolver, "use_kernels", lambda p, x: True)
    for name in ("restrict_residual", "prolong_add"):
        real = getattr(mg_transfer, name)

        def recorded(du, *args, real=real, name=name, **kwargs):
            calls.append((name, tuple(du.shape[1:]),
                          kwargs.get("in_place", False)))
            return real(du, *args, **kwargs)
        monkeypatch.setattr(mg_transfer, name, recorded)
    return calls


CONTEXTS = {
    "whole": (HaloCtx(), True),
    "window_at_0": (HaloCtx(window_z0=0, window_d_global=D), False),
    "window_inside": (HaloCtx(window_z0=4, window_d_global=3 * D), False),
    "window_tensor_origin": (HaloCtx(window_z0=torch.tensor(0, dtype=torch.int32),
                                     window_d_global=D), False),
    "shard": (HaloCtx(n_shards=2, rank=0), False),
}


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_route_rule(forced, name):
    ctx, takes = CONTEXTS[name]
    p = FlowParams(solver="multigrid")
    x = torch.zeros((3, *SHAPE))
    assert mgsolver.transfers_on_kernel(p, x, ctx) is takes


def test_cpu_tensors_take_the_plain_route():
    p = FlowParams(solver="multigrid")
    assert not mgsolver.transfers_on_kernel(p, torch.zeros((3, *SHAPE)),
                                            HaloCtx())
    levels = mgsolver.build_mg_levels(_terms(SHAPE), p, HaloCtx())
    assert len(levels) > 1
    assert all(lvl.down is None and lvl.up is None for lvl in levels)


def test_levels_hold_the_tables_on_the_route(forced):
    p = FlowParams(solver="multigrid")
    levels = mgsolver.build_mg_levels(_terms(SHAPE), p, HaloCtx())
    shapes = tuple(lvl.shape_global for lvl in levels)
    assert shapes == tuple(mgsolver.mg_shapes(SHAPE, 1))
    tables = mgsolver.transfer_tables(shapes, torch.device("cpu"))
    for lvl, (down, up) in zip(levels, tables):
        assert lvl.down is down and lvl.up is up
    assert levels[-1].down is None and levels[-1].up is None
    # Made once per hierarchy: a second build reads the same tensors.
    again = mgsolver.build_mg_levels(_terms(SHAPE, 1), p, HaloCtx())
    assert all(a.down is b.down for a, b in zip(levels, again))


def _pairs(shape, z_multiple):
    """The (in, out) lengths of every transfer of every pyramid level's
    hierarchy, both ways."""
    p = FlowParams(z_multiple=z_multiple, levels=4)
    out = set()
    for lshape in p.level_shapes(shape):
        grids = mgsolver.mg_shapes(lshape, 1)
        for fine, coarse in zip(grids, grids[1:]):
            out |= {(f, c) for f, c in zip(fine, coarse)}
            out |= {(c, f) for f, c in zip(fine, coarse)}
    return out


@pytest.mark.parametrize("shape, z_multiple", [
    ((256, 256, 256), 1), ((40, 37, 29), 1), ((40, 37, 29), 8),
    ((9, 70, 12), 8)])
def test_tables_are_the_plain_resize(shape, z_multiple):
    pairs = _pairs(shape, z_multiple)
    if shape == (40, 37, 29):
        assert any(a != 2 * b and b != 2 * a for a, b in pairs)
    rng = np.random.default_rng(3)
    for n_in, n_out in sorted(pairs):
        t = mgsolver.lerp_table(n_in, n_out, "cpu")
        assert t.dtype == torch.int32 and t.shape == (3, n_out)
        i0, i1, f = pyramid.lerp_coords(n_in, n_out)
        assert torch.equal(t[0].long(), i0) and torch.equal(t[1].long(), i1)
        assert torch.equal(t[2].view(torch.float32), f)
        x = torch.from_numpy(rng.normal(size=(2, n_in)).astype(np.float32))
        f = t[2].view(torch.float32)
        got = x[:, t[0].long()] * (1.0 - f) + x[:, t[1].long()] * f
        want = pyramid.resize_axis_local(x, n_out, -1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ((down, up),) = mgsolver.transfer_tables(((16, 12, 10), (8, 6, 5)),
                                             torch.device("cpu"))
    assert [t.shape for t in down] == [(3, 8), (3, 6), (3, 5)]
    assert [t.shape for t in up] == [(3, 16), (3, 12), (3, 10)]


def _pair(shape, seed=2):
    i0, i1, _ = syn.make_pair(shape, syn.translation((1.0, -0.5, 0.25)),
                              seed=seed)
    return torch.as_tensor(i0), torch.as_tensor(i1)


def test_solve_keeps_its_bits_with_the_route_forced(forced):
    p = PRESETS["accurate"].replace(levels=2, warps=2)
    i0, i1 = _pair((24, 24, 24))
    got = pipeline.compute_flow_impl(i0, i1, p, HaloCtx())
    calls = list(forced)
    forced.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mgsolver, "use_kernels", lambda p, x: False)
        want = pipeline.compute_flow_impl(i0, i1, p, HaloCtx())
    assert not forced
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    restricts = [c for c in calls if c[0] == "restrict_residual"]
    prolongs = [c for c in calls if c[0] == "prolong_add"]
    assert restricts and len(restricts) == len(prolongs)
    # mg_pre > 0: every K11 writes into the pre-smoother's result.
    assert p.mg_pre > 0 and all(c[2] for c in prolongs)


def test_prolongation_in_place_only_where_the_cycle_owns_du(forced):
    """Without pre-sweeps the finest grid's du is the caller's iterate,
    which the early stop compares with: K11 writes a new tensor there, in
    place on the coarser grids (each cycle's own zeros)."""
    p = PRESETS["accurate"].replace(levels=1, warps=1, mg_pre=0)
    i0, i1 = _pair((16, 16, 16))
    pipeline.compute_flow_impl(i0, i1, p, HaloCtx())
    prolongs = [c for c in forced if c[0] == "prolong_add"]
    assert prolongs
    for _, shape, in_place in prolongs:
        assert in_place == (shape != (16, 16, 16))


def test_streamed_coarse_cycles_keep_their_bits_with_the_route_forced(
        forced):
    """The streamed multigrid's coarse V-cycle runs ``_vcycle`` on whole
    coarse volumes (the route), its fine residual on windows stays plain
    (``piecewise._ph_mg_residual``, never the wrappers)."""
    from tpuflow3d_torch.piecewise import compute_flow_piecewise
    p = PRESETS["accurate"].replace(levels=1, warps=1)
    i0, i1 = _pair((16, 16, 16))
    got = compute_flow_piecewise(i0.numpy(), i1.numpy(), p, chunk_z=8,
                                 device="cpu")
    assert forced and all(shape != (16, 16, 16) for _, shape, _ in forced)
    forced.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mgsolver, "use_kernels", lambda p, x: False)
        want = compute_flow_piecewise(i0.numpy(), i1.numpy(), p, chunk_z=8,
                                      device="cpu")
    assert not forced
    np.testing.assert_array_equal(got, want)
