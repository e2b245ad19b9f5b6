"""The port's Z-sharded path on two gloo ranks at 32^3 with the systems the
JAX sharded tests leave out: ``accurate`` (multigrid, tricubic, the
early stop; cut to two levels and three warps as
tests/test_torch_pipeline.py cuts it), gradient constancy (gamma 1) and
the packed layout; each against the JAX package's
``compute_flow_sharded`` on two virtual devices and bitwise against the
port's one-device flow (tests/torch_shard_cases.py). One pool of two
ranks serves the module."""

import jax
import pytest
import torch

import torch_ranks
import torch_shard_cases as cases

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs >=2 virtual devices")


@pytest.fixture(scope="module")
def pool():
    p = torch_ranks.RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("name", ["accurate_32", "gamma_32", "packed_32"])
def test_sharded_matches_jax(pool, name):
    cases.check(pool, name)
