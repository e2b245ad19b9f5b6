"""The port's Z-sharded path on the JAX sharded tests' fields that vary
across the shard faces (tests/test_sharding.py): rotation, the sinusoid
(n=4 here: the pool has four ranks; the JAX test takes 8), clamp 6 with
the tricubic warp's wider halo, and the multi-voxel shift with its EPE
bound; each against the JAX package's ``compute_flow_sharded`` at the same
shard count and bitwise against the port's one-device flow
(tests/torch_shard_cases.py). One pool of four gloo ranks serves the
module."""

import jax
import pytest
import torch

import torch_ranks
import torch_shard_cases as cases
from tpuflow3d import synthetic as rsyn

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs >=4 virtual devices")


@pytest.fixture(scope="module")
def pool():
    p = torch_ranks.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("name", ["rotation", "sinusoid", "clamp6_tricubic"])
def test_sharded_matches_jax(pool, name):
    cases.check(pool, name)


def test_multivoxel_shift_recovered(pool):
    """The multi-voxel case against JAX, and the JAX test's accuracy
    bound on it."""
    got = cases.check(pool, "multivoxel")
    i0, _, true, _, _, _ = cases.case("multivoxel")
    assert rsyn.epe(got, true, rsyn.interior_mask(i0.shape, 5)) < 0.15
