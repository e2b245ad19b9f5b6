"""The CUDA kernels (K1 SOR half-sweep, K2 fused warp + derivatives, K3
median) against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips when torch.cuda.is_available() is false.
The machine with the card has no JAX, and tests/conftest.py imports it,
so run these there without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tpuflow3d_torch import FlowParams, compute_flow, kernels
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.derivatives import derivatives
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels.median3 import median3 as k_median3
from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
from tpuflow3d_torch.kernels.warp_grad import warp_grad as k_warp_grad
from tpuflow3d_torch.median import median3
from tpuflow3d_torch.solver import compute_terms, parity_mask, sor_halfsweep
from tpuflow3d_torch.warp import warp_volume

pytestmark = pytest.mark.cuda

ALPHA, OMEGA = 0.05, 1.9
SHAPES = [(12, 10, 14), (7, 9, 11), (13, 64, 64), (16, 33, 70)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _terms(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    i0 = _t(rng.normal(size=shape), dev)
    shift = torch.zeros((3, *shape), device=dev)
    shift[2] = 0.7
    i1 = warp_volume(i0, -shift)
    g, it = derivatives(i0, i1)
    flow = _t(rng.normal(size=(3, *shape)) * 0.1, dev)
    du = _t(rng.normal(size=(3, *shape)) * 0.05, dev)
    return du, compute_terms(g, it, flow, du, FlowParams(alpha=ALPHA))


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_sor_halfsweep_matches_plain(dev, shape, color):
    du, t = _terms(shape, dev)
    parity = parity_mask(shape, HaloCtx(), dev)
    ref = sor_halfsweep(du, t, OMEGA, parity, color)
    got = k_sor(du, t, ALPHA, OMEGA, color)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


def test_sor_sweep_sequence_matches_plain(dev):
    shape = (12, 10, 14)
    du, t = _terms(shape, dev, seed=1)
    parity = parity_mask(shape, HaloCtx(), dev)
    ref = got = du
    for _ in range(5):
        for color in (0, 1):
            ref = sor_halfsweep(ref, t, OMEGA, parity, color)
            got = k_sor(got, t, ALPHA, OMEGA, color)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("max_disp", [2.0, 6.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_warp_grad_matches_plain(dev, shape, max_disp):
    rng = np.random.default_rng(2)
    i0 = _t(rng.normal(size=shape), dev)
    i1 = _t(rng.normal(size=shape), dev)
    flow = _t(rng.uniform(-max_disp, max_disp, (3, *shape)), dev)
    g_ref, it_ref = derivatives(i0, warp_volume(i1, flow))
    g, it = k_warp_grad(i1, flow, i0)
    torch.cuda.synchronize()
    torch.testing.assert_close(g, g_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(it, it_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_median3_bitwise(dev, shape, quantize):
    x = np.random.default_rng(3).normal(size=(3, *shape))
    if quantize:  # many ties
        x = np.round(x * 2.0) / 2.0
    x = _t(x, dev)
    assert torch.equal(k_median3(x), median3(x))


def test_kernels_reject_bad_inputs(dev):
    du, t = _terms((6, 8, 8), dev)
    with pytest.raises(TypeError, match="float32"):
        k_median3(du.double())
    with pytest.raises(ValueError, match="contiguous"):
        k_warp_grad(du[0].transpose(1, 2), du, du[1])
    with pytest.raises(ValueError, match="on "):
        k_warp_grad(du[0], du, du[1].cpu())


def test_compute_flow_kernels_match_plain_and_launch(dev):
    shape = (32, 32, 32)
    i0, i1, true = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)))
    p = FlowParams(levels=2, warps=3, inner_iterations=3, sweeps=20)
    kernels.reset_launches()
    got = compute_flow(i0, i1, p, device=dev)
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    ref = compute_flow(i0, i1, p.replace(backend="plain"), device=dev)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-3)
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(shape, 4)
    assert syn.epe(got.cpu().numpy(), true, mask) < 0.05
