"""The port's 27-point median (the plain version of kernel K3, and the K3
wrapper, which runs it for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its XLA median. Bitwise: the median is an
exact order statistic (bitwise up to the sign of a zero, which neither
side fixes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.median import median3 as ref_median3
from tpuflow3d.pallas.median3 import median3_pallas
from tpuflow3d_torch import kernels
from tpuflow3d_torch.kernels.median3 import median3 as k_median3
from tpuflow3d_torch.median import median3
from torch_inputs import median_input

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["normal", "ties", "const", "zeros"])
@pytest.mark.parametrize("shape", [(8, 16, 16), (6, 24, 10), (5, 7, 9)])
def test_median_bitwise(shape, kind):
    x = median_input(kind, shape, np.random.default_rng(0))
    got = median3(torch.from_numpy(x)).numpy()
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(got, np.asarray(ref_median3(xj)))
    np.testing.assert_array_equal(
        got, np.asarray(median3_pallas(RefCtx().zpad(xj, 1), interpret=True)))
    before = dict(kernels.LAUNCHES)
    np.testing.assert_array_equal(k_median3(torch.from_numpy(x)).numpy(), got)
    assert kernels.LAUNCHES == before


def test_impulse_rejected():
    x = torch.ones((1, 6, 8, 8))
    x[0, 3, 4, 4] = 100.0
    assert torch.equal(median3(x), torch.ones_like(x))
