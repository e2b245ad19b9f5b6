"""The port's plain ops against the JAX package on the same inputs:
smoothing, resampling, pyramids, flow upsampling, warping, derivatives
(orders 2 and 4, the gradient-constancy terms of order 4 included) and the
solver terms (stored in float32 and in bfloat16), on odd shapes and with
flows up to 6 voxels.

Tolerance atol 1e-5 (the JAX suite's own op tolerance between its Pallas
and XLA twins, VALIDATION.md "Consistency gates"); rtol 1e-5 only where
the values are large (the solver weights reach ~1e3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import derivatives as rder
from tpuflow3d import pyramid as rpyr
from tpuflow3d import solver as rsol
from tpuflow3d import warp as rwarp
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d_torch import derivatives as pder
from tpuflow3d_torch import pyramid as ppyr
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch import warp as pwarp
from tpuflow3d_torch.params import FlowParams

torch.set_num_threads(2)

SHAPES = [(7, 9, 11), (12, 10, 14)]


def _jit(fn, *static):
    """The reference function under one jit (op-by-op dispatch would
    compile every primitive for every shape)."""
    return jax.jit(fn, static_argnums=static)


def _close(got, want, atol=1e-5, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _inputs(shape, seed=0, max_disp=6.0):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=shape).astype(np.float32)
    vol2 = rng.normal(size=shape).astype(np.float32)
    flow = rng.uniform(-max_disp, max_disp, (3, *shape)).astype(np.float32)
    return vol, vol2, flow


def _check_smooth(shape):
    vol, _, _ = _inputs(shape)
    for sigma in (0.8, 1.039):
        _close(ppyr.smooth(torch.from_numpy(vol), sigma),
               _jit(rpyr.smooth, 1)(jnp.asarray(vol), sigma))


def _check_resize3(shape):
    vol, _, flow = _inputs(shape)
    for out in [(4, 5, 6), (15, 7, 20), shape]:
        for x in (vol, flow):
            _close(ppyr.resize3(torch.from_numpy(x), out),
                   _jit(rpyr.resize3, 1)(jnp.asarray(x), out))


def _check_build_pyramid(shape):
    vol, _, _ = _inputs(shape)
    for p in (FlowParams(levels=3, min_dim=2), FlowParams(levels=4, min_dim=3,
                                                          scale_factor=0.7)):
        rp = RefParams(levels=p.levels, min_dim=p.min_dim,
                       scale_factor=p.scale_factor)
        shapes = p.level_shapes(shape)
        assert shapes == rp.level_shapes(shape) and len(shapes) > 1
        got = ppyr.build_pyramid(torch.from_numpy(vol), shapes, p)
        want = _jit(rpyr.build_pyramid, 1, 2)(jnp.asarray(vol),
                                              tuple(shapes), rp)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)


def _check_upsample_flow(shape):
    _, _, flow = _inputs(shape)
    coarse = tuple((s + 1) // 2 for s in shape)
    small = _jit(rpyr.resize3, 1)(jnp.asarray(flow), coarse)
    _close(ppyr.upsample_flow(torch.from_numpy(np.array(small)), shape),
           _jit(rpyr.upsample_flow, 1)(small, shape))


def _check_warp_volume(shape):
    vol, _, flow = _inputs(shape)
    _close(pwarp.warp_volume(torch.from_numpy(vol), torch.from_numpy(flow)),
           _jit(rwarp.warp_volume)(jnp.asarray(vol), jnp.asarray(flow)))


def _check_derivatives(shape):
    vol, vol2, _ = _inputs(shape)
    g, it = pder.derivatives(torch.from_numpy(vol), torch.from_numpy(vol2))
    rg, rit = _jit(rder.derivatives)(jnp.asarray(vol), jnp.asarray(vol2))
    _close(g, rg)
    _close(it, rit)


def _check_central_diff4(shape):
    vol, _, flow = _inputs(shape)
    for x in (vol, flow):
        for axis in (-3, -2, -1):
            _close(pder.central_diff4(torch.from_numpy(x), axis),
                   _jit(rder.central_diff4, 1)(jnp.asarray(x), axis))


def _check_derivatives_order4(shape):
    vol, vol2, _ = _inputs(shape)
    g, it = pder.derivatives(torch.from_numpy(vol), torch.from_numpy(vol2),
                             order=4)
    rg, rit = _jit(lambda a, b: rder.derivatives(a, b, order=4))(
        jnp.asarray(vol), jnp.asarray(vol2))
    _close(g, rg)
    _close(it, rit)


def _check_grad_constancy_order4(shape):
    vol, vol2, _ = _inputs(shape)
    for reuse in (False, True):
        rg = rder.derivatives(jnp.asarray(vol), jnp.asarray(vol2),
                              order=4)[0] if reuse else None
        want = rder.grad_constancy_terms(jnp.asarray(vol), jnp.asarray(vol2),
                                         order=4, g=rg)
        got = pder.grad_constancy_terms(
            torch.from_numpy(vol), torch.from_numpy(vol2), order=4,
            g=None if rg is None else torch.from_numpy(np.array(rg)))
        for a, b in zip(got, want):
            _close(a, b)


def _check_compute_terms_bf16(shape):
    """terms_dtype="bfloat16": c and g are stored in bfloat16, rounded to
    nearest even as the reference's astype, and are bitwise the
    reference's. (g is an input. The float32 c of the two packages differs
    in the last bit on half the voxels, the float32 test above; a flip in
    bfloat16 needs a value within that bit of a rounding boundary, about
    2^-15 a voxel, and none of these shapes has one.) Everything else stays
    float32 and is the reference's, smt of the unrounded g included."""
    want, got = _terms_pair(shape, "bfloat16")

    def widen(x):
        return np.asarray(x.astype(jnp.float32))
    for name in ("c", "g"):
        assert getattr(got, name).dtype == torch.bfloat16
        assert getattr(want, name).dtype == jnp.bfloat16
        np.testing.assert_array_equal(getattr(got, name).float().numpy(),
                                      widen(getattr(want, name)))
    for name in ("sw_inv", "smt", "psi_s", "psi_d"):
        assert getattr(got, name).dtype == torch.float32
        _close(getattr(got, name), getattr(want, name), rtol=1e-5)


def _terms_pair(shape, terms_dtype):
    """(reference terms, port terms) of the same inputs."""
    vol, _, flow = _inputs(shape, max_disp=1.0)
    rng = np.random.default_rng(1)
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    flow = flow * 0.1
    rp = RefParams(alpha=0.05, terms_dtype=terms_dtype)
    pp = FlowParams(alpha=0.05, terms_dtype=terms_dtype)
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1 = _jit(rwarp.warp_volume)(jnp.asarray(vol), jnp.asarray(-shift))
    rg, rit = _jit(rder.derivatives)(jnp.asarray(vol), i1)
    want = _jit(rsol.compute_terms, 4)(rg, rit, jnp.asarray(flow),
                                       jnp.asarray(du), rp)
    got = psol.compute_terms(torch.from_numpy(np.array(rg)),
                             torch.from_numpy(np.array(rit)),
                             torch.from_numpy(flow), torch.from_numpy(du), pp)
    return want, got


def _check_compute_terms(shape):
    vol, _, flow = _inputs(shape, max_disp=1.0)
    rng = np.random.default_rng(1)
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    flow = flow * 0.1
    rp, pp = RefParams(alpha=0.05), FlowParams(alpha=0.05)
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1 = _jit(rwarp.warp_volume)(jnp.asarray(vol), jnp.asarray(-shift))
    rg, rit = _jit(rder.derivatives)(jnp.asarray(vol), i1)
    want = _jit(rsol.compute_terms, 4)(rg, rit, jnp.asarray(flow),
                                       jnp.asarray(du), rp)
    got = psol.compute_terms(torch.from_numpy(np.array(rg)),
                             torch.from_numpy(np.array(rit)),
                             torch.from_numpy(flow), torch.from_numpy(du), pp)
    for name in ("c", "g", "sw_inv", "smt", "psi_s", "psi_d"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-5)
    _close(torch.stack(got.w), want.w, rtol=1e-5)


CHECKS = {"smooth": _check_smooth, "resize3": _check_resize3,
          "build_pyramid": _check_build_pyramid,
          "upsample_flow": _check_upsample_flow,
          "warp_volume": _check_warp_volume,
          "derivatives": _check_derivatives,
          "compute_terms": _check_compute_terms,
          "central_diff4": _check_central_diff4,
          "derivatives_order4": _check_derivatives_order4,
          "grad_constancy_order4": _check_grad_constancy_order4,
          "compute_terms_bf16": _check_compute_terms_bf16}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", sorted(CHECKS))
def test_op_matches_reference(op, shape):
    CHECKS[op](shape)
