"""The device generator against the port's numpy generator at 32^3.

``gen.make_pair`` evaluates ``synthetic.make_pair(shape, sinusoid(shape,
1.5, 1), seed, texture="fourier")`` in torch, in float64, slab by slab.
On the CPU the volumes, the true flow, the mask and the EPE came out equal
to the numpy copy's (max |difference| 0.0 for seeds 3 and 2**31 + 5); the
tolerance of 1e-6 on the float32 volumes leaves room for another libm's
cosine, whose float64 rounding moves a float32 result by one unit at most.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from flowbench import gen  # noqa: E402
from tpuflow3d_torch import synthetic as syn  # noqa: E402

SHAPE = (32, 32, 32)
TEXTURE = {"kind": "fourier", "modes": 64, "kmin": 0.2, "kmax": 0.7}
DEFORMATION = {"kind": "sinusoid", "amplitude": 1.5, "periods": 1.0}
ATOL = 1e-6


@pytest.mark.parametrize("seed", [[3, 0], [3, 1], [2**31 + 5, 0]])
def test_pair_matches_the_numpy_generator(seed):
    a0, a1 = gen.make_pair(SHAPE, seed, TEXTURE, DEFORMATION, "cpu")
    b0, b1, true = syn.make_pair(SHAPE, syn.sinusoid(SHAPE, 1.5, 1.0),
                                 seed=seed, texture="fourier")
    assert a0.dtype == a1.dtype == np.float32
    np.testing.assert_allclose(a0, b0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(a1, b1, rtol=0, atol=ATOL)
    flow = gen.true_flow_slab(SHAPE, DEFORMATION, 0, SHAPE[0], "cpu")
    np.testing.assert_allclose(flow.numpy(), true, rtol=0, atol=ATOL)


def test_mask_and_epe_match_the_numpy_metrics():
    i0, _, true = syn.make_pair(SHAPE, syn.sinusoid(SHAPE, 1.5, 1.0),
                                seed=[9, 0], texture="fourier")
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(SHAPE, 4)
    got = (gen.gradient_mask(torch.as_tensor(i0), 0.75)
           & gen.interior_mask(SHAPE, 4, "cpu")).numpy()
    assert (got == mask).all()
    noisy = true + np.random.default_rng(0).normal(
        size=true.shape).astype(np.float32) * 0.05
    assert gen.epe(noisy, i0, DEFORMATION, 0.75, 4, "cpu") == pytest.approx(
        syn.epe(noisy, true, mask), rel=1e-12)


def test_slabs_cover_the_volume_once():
    gen_slabs = gen._slabs((40, 1024, 1024))
    assert gen_slabs[0][0] == 0 and gen_slabs[-1][1] == 40
    assert all(a[1] == b[0] for a, b in zip(gen_slabs, gen_slabs[1:]))
