"""The port's tricubic warp (the plain version of kernel K5) against the
JAX package: ``_cubic_weights``, ``warp_volume(interp="tricubic")`` with
coordinates clamped at every face, and the K5 wrapper (which runs
warp_volume + derivatives for CPU tensors, with and without the warped
volume) against the JAX Pallas kernel in interpret mode (|flow| <= 2, its
clamp) and its XLA warp + derivatives (|flow| up to 6, and the smooth +-2
and outlier flows of tests/torch_inputs.py).

Tolerance atol 1e-5, rtol 1e-5, as K2 and tests/test_pallas_warp.py
(measured on the CPU: the weights, the warp and the fused outputs against
XLA bitwise equal, against the Pallas kernel, which sums its taps in
another order, up to 1.2e-6); the weights atol 1e-7 (measured 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import warp as rwarp
from tpuflow3d.derivatives import derivatives as ref_derivatives
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.pallas.warp_grad import warp_grad_pallas
from tpuflow3d_torch import kernels
from tpuflow3d_torch import warp as pwarp
from tpuflow3d_torch.kernels.warp_grad import warp_grad
from torch_inputs import make_flow

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(8, 16, 16), (6, 24, 10), (7, 9, 11)]


def _case(shape, max_disp, seed=0):
    rng = np.random.default_rng(seed)
    i0 = rng.normal(size=shape).astype(np.float32)
    i1 = rng.normal(size=shape).astype(np.float32)
    return i0, i1, make_flow(max_disp, shape, rng)


def test_cubic_weights_match_reference():
    f = np.linspace(0.0, 1.0, 257, endpoint=False, dtype=np.float32)
    want = rwarp._cubic_weights(jnp.asarray(f))
    got = pwarp._cubic_weights(torch.from_numpy(f))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=0)
    # Interpolating: the weights sum to one, and sample the tap at f = 0.
    np.testing.assert_allclose(sum(got).numpy(), 1.0, atol=1e-6)
    np.testing.assert_array_equal([w[0].item() for w in got], [0, 1, 0, 0])


@pytest.mark.parametrize("max_disp", [0.5, 2.0, 6.0, "smooth2", "outlier"])
@pytest.mark.parametrize("shape", SHAPES)
def test_warp_volume_matches_reference(shape, max_disp):
    """|flow| up to 6 on dims of 6 to 24 pushes coordinates past every
    face: the clip and each tap's clamp are exercised."""
    _, i1, flow = _case(shape, max_disp)
    want = rwarp.warp_volume(jnp.asarray(i1), jnp.asarray(flow),
                             interp="tricubic")
    got = pwarp.warp_volume(torch.from_numpy(i1), torch.from_numpy(flow),
                            interp="tricubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_integer_shift_is_exact():
    """Catmull-Rom interpolates: an integer shift moves the voxels, with
    the edge replicated."""
    shape = (6, 8, 10)
    vol = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    flow = np.zeros((3, *shape), np.float32)
    flow[2] = 2.0
    got = pwarp.warp_volume(torch.from_numpy(vol), torch.from_numpy(flow),
                            interp="tricubic").numpy()
    want = vol[..., np.minimum(np.arange(shape[2]) + 2, shape[2] - 1)]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_unknown_interp_raises():
    x = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="interp"):
        pwarp.warp_volume(x, torch.zeros((3, 4, 4, 4)), interp="cubic")
    with pytest.raises(ValueError, match="interp"):
        warp_grad(x, torch.zeros((3, 4, 4, 4)), x, interp="cubic")


def _wrapped(i0, i1, flow, emit_warped):
    before = dict(kernels.LAUNCHES)
    out = warp_grad(torch.from_numpy(i1), torch.from_numpy(flow),
                    torch.from_numpy(i0), interp="tricubic",
                    emit_warped=emit_warped)
    assert kernels.LAUNCHES == before  # CPU: plain version, no launch
    assert len(out) == (3 if emit_warped else 2)
    return out


@pytest.mark.parametrize("emit_warped", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_pallas_kernel(shape, emit_warped):
    i0, i1, flow = _case(shape, 2.0)
    got = _wrapped(i0, i1, flow, emit_warped)
    want = warp_grad_pallas(jnp.asarray(i1), jnp.asarray(flow),
                            jnp.asarray(i0), RefCtx(), max_disp=2.0,
                            interp="tricubic", emit_warped=emit_warped,
                            interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_xla_beyond_the_clamp(shape):
    _check_fused_against_xla(*_case(shape, 6.0, seed=1))


@pytest.mark.parametrize("flow", ["smooth2", "outlier"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_xla_on_smooth_and_outlier_flows(shape, flow):
    _check_fused_against_xla(*_case(shape, flow, seed=2))


def _check_fused_against_xla(i0, i1, flow):
    got = _wrapped(i0, i1, flow, True)
    i1w = rwarp.warp_volume(jnp.asarray(i1), jnp.asarray(flow),
                            interp="tricubic")
    want = (*ref_derivatives(jnp.asarray(i0), i1w), i1w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
