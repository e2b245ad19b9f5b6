"""The port's Z-sharded path, ``sharding.compute_flow_sharded`` run SPMD in
a pool of four gloo ranks on the CPU (plain versions), against the JAX
package's ``compute_flow_sharded`` on the conftest's virtual CPU devices
with the same shard count (tests/torch_shard_cases.py: the tolerance and
why), on the cases of tests/test_sharding.py: translation 64x32x32 at
n=4, the early stop, eta = 0.7, tricubic, clamp 6. The rotation,
sinusoid, clamp 6 tricubic and multi-voxel cases are in
test_torch_sharding_fields.py, ``accurate``, gamma 1 and packed at 32^3
on two ranks in test_torch_sharding_presets.py (split so that each file
stays short under xdist). The halo helpers (``zpad``, its all-gather
branch, ``z_halo_planes``) are held bitwise to JAX's under ``shard_map``,
the reductions to one value on every rank. One pool serves the module
(~3 s to spawn), and the JAX runs are cached per process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
import torch_shard_cases as cases
from tpuflow3d.grid import HaloCtx as RHaloCtx
from tpuflow3d.sharding import make_z_mesh
from tpuflow3d_torch import PRESETS, compute_flow
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.sharding import prepare_params

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs >=4 virtual devices")


@pytest.fixture(scope="module")
def pool():
    p = torch_ranks.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("name", ["translation_64", "early_stop", "eta_0_7",
                                  "tricubic", "clamp6"])
def test_sharded_matches_jax(pool, name):
    cases.check(pool, name)


def test_residuals_are_replicated(pool):
    """The early stop's residual curve is the same on every rank (one
    reduction, every rank the same bits), and the one-device curve to its
    sums' rounding (a sum of two halves against one sum)."""
    i0, i1, _, rp, n, _ = cases.case("early_stop")
    p = from_reference(rp).replace(track_residuals=True)
    outs = pool.run(torch_ranks.sharded_flow, i0, i1, p, ranks=n,
                    diagnostics=True)
    curves = [d["residuals"] for _, d in outs]
    for c in curves[1:]:
        np.testing.assert_array_equal(c, curves[0])
    _, one = compute_flow(i0, i1, prepare_params(p, n), device="cpu",
                          diagnostics=True)
    np.testing.assert_allclose(curves[0], one["residuals"].numpy(),
                               atol=1e-6, rtol=1e-3)


def _ref_zpad(x, n, nh):
    mesh = make_z_mesh(n)
    spec = P(*([None] * (x.ndim - 3)), "z", None, None)
    out = jax.jit(jax.shard_map(
        lambda a: RHaloCtx(axis_name="z", n_shards=n).zpad(a, nh),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))(
        jnp.asarray(x))
    return np.split(np.asarray(out), n, axis=-3)


@pytest.mark.parametrize("shape,nh", [((16, 4, 4), 2), ((3, 16, 4, 4), 1),
                                      ((4, 4, 4), 3), ((3, 8, 4, 4), 5)],
                         ids=["exchange", "flow_exchange", "all_gather",
                              "flow_all_gather"])
def test_zpad_bitwise_jax(pool, shape, nh):
    """Neighbour planes on interior faces, replicas on global ones; a slab
    thinner than the halo (1 and 2 planes here) through the all-gather."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = pool.run(torch_ranks.zpad_slabs, x, nh)
    for g, r in zip(got, _ref_zpad(x, 4, nh)):
        np.testing.assert_array_equal(g, r)


def test_z_halo_planes_bitwise_jax(pool):
    x = np.random.default_rng(1).normal(size=(3, 16, 5, 6)).astype(
        np.float32)
    n = 4
    mesh = make_z_mesh(n)
    spec = P(None, "z", None, None)
    lo, hi = jax.jit(jax.shard_map(
        lambda a: RHaloCtx(axis_name="z", n_shards=n).z_halo_planes(a),
        mesh=mesh, in_specs=spec, out_specs=(spec, spec),
        check_vma=False))(jnp.asarray(x))
    want = zip(np.split(np.asarray(lo), n, axis=1),
               np.split(np.asarray(hi), n, axis=1))
    for (glo, ghi), (wlo, whi) in zip(pool.run(torch_ranks.halo_planes, x),
                                      want):
        np.testing.assert_array_equal(glo, wlo)
        np.testing.assert_array_equal(ghi, whi)


@pytest.mark.parametrize("ranks", [2, 4])
def test_reductions_same_on_every_rank(pool, ranks):
    values = [0.1, 1e-8, -3.25, 7.0][:ranks]
    got = pool.run(torch_ranks.reductions, values, ranks=ranks)
    assert all(g == got[0] for g in got)
    s = np.float32(0.0)
    for v in values:
        s = np.float32(s + np.float32(v))
    assert got[0] == (float(s), float(np.float32(min(values))),
                      float(np.float32(max(values))))


def test_prepare_params():
    p = PRESETS["ladder256"]
    q = prepare_params(p, 3)
    assert q.z_multiple % 3 == 0 and q.z_multiple % p.z_multiple == 0
    assert q.flow_clamp == (p.flow_clamp if p.flow_clamp > 0 else 4.0)
    from tpuflow3d.params import PRESETS as RPRESETS
    from tpuflow3d.sharding import prepare_params as ref_prepare
    rq = ref_prepare(RPRESETS["ladder256"], 3)
    assert (q.z_multiple, q.flow_clamp) == (rq.z_multiple, rq.flow_clamp)
