"""The port's fused warp + derivatives (the K2 wrapper, which runs its plain
version warp_volume + derivatives for CPU tensors) against the JAX
package's Pallas kernel in interpret mode (|flow| <= 2, the kernel's
clamp) and against its XLA warp + derivatives (|flow| up to 6; the smooth
+-2 and outlier flows of tests/torch_inputs.py).

Tolerance atol 1e-5, rtol 1e-5 (tests/test_pallas_warp.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d.derivatives import derivatives as ref_derivatives
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.pallas.warp_grad import warp_grad_pallas
from tpuflow3d.warp import warp_volume as ref_warp_volume
from tpuflow3d_torch import kernels
from tpuflow3d_torch.kernels.warp_grad import warp_grad
from torch_inputs import make_flow

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(shape, max_disp, seed=0):
    rng = np.random.default_rng(seed)
    i0 = rng.normal(size=shape).astype(np.float32)
    i1 = rng.normal(size=shape).astype(np.float32)
    flow = make_flow(max_disp, shape, rng)
    before = dict(kernels.LAUNCHES)
    g, it = warp_grad(torch.from_numpy(i1), torch.from_numpy(flow),
                      torch.from_numpy(i0))
    assert kernels.LAUNCHES == before  # CPU: plain version, no launch
    return (jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(flow)), (g, it)


def _check(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("shape", [(8, 16, 16), (6, 24, 10), (7, 9, 11)])
def test_matches_pallas_kernel(shape):
    (i0, i1, flow), got = _case(shape, 2.0)
    want = warp_grad_pallas(i1, flow, i0, RefCtx(), max_disp=2.0,
                            interpret=True)
    _check(got, want)


@pytest.mark.parametrize("max_disp", [1.0, 6.0, "smooth2", "outlier"])
@pytest.mark.parametrize("shape", [(7, 9, 11), (12, 10, 14)])
def test_matches_xla_warp_and_derivatives(shape, max_disp):
    (i0, i1, flow), got = _case(shape, max_disp, seed=1)
    want = ref_derivatives(i0, ref_warp_volume(i1, flow))
    _check(got, want)


def test_integer_shift_reproduces_volume():
    shape = (8, 8, 8)
    rng = np.random.default_rng(3)
    i1 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    flow = torch.zeros((3, *shape))
    flow[2] = 2.0
    _, it = warp_grad(i1, flow, torch.zeros(shape))
    torch.testing.assert_close(it[:, :, :6], i1[:, :, 2:], atol=1e-6, rtol=0)
