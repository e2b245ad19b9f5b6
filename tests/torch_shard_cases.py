"""The flow cases of the port's sharded tests (tests/test_torch_sharding*.py)
and their JAX references: each case is a pair, the reference's params and
a shard count; ``case`` runs the JAX package's ``compute_flow_sharded`` on
the conftest's virtual CPU devices once per process, and ``check`` holds
the port's SPMD run in a ``torch_ranks`` pool to it (atol 3e-5, rtol 0:
twice the largest difference measured over these cases, 1.5e-5, the
multi-voxel case; the others 7.9e-6 or less; tighter than the
reference's own sharded-vs-unsharded gate, 2e-4 and rtol 1e-3) and to
the port's one-device flow with the same ``prepare_params``, bitwise: its
sharded warp samples at global coordinates (``warp.warp_volume``), where
the reference's rounds in the slab's frame.

Imported by the test processes only: the ranks import ``torch_ranks``.
"""

import functools

import numpy as np

import torch_ranks
from tpuflow3d import FlowParams as RP
from tpuflow3d import synthetic as rsyn
from tpuflow3d.sharding import compute_flow_sharded as ref_sharded
from tpuflow3d.sharding import make_z_mesh
from tpuflow3d_torch import compute_flow
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.sharding import prepare_params

TOL = dict(atol=3e-5, rtol=0.0)


def _translation(shape, shift, seed, texture="blobs"):
    return rsyn.make_pair(shape, rsyn.translation(shift), seed=seed,
                          texture=texture)


# name -> (pair maker, reference params, shard count)
CASES = {
    "translation_64": (lambda: _translation((64, 32, 32), (1.0, -0.5, 0.75),
                                            2),
                       RP(levels=3, warps=2, inner_iterations=2, sweeps=10,
                          alpha=0.1), 4),
    "early_stop": (lambda: _translation((32, 16, 16), (0.5, 0.0, 0.5), 4),
                   RP(levels=2, warps=2, inner_iterations=2, sweeps=10,
                      alpha=0.05, residual_tol=1e-5), 4),
    "eta_0_7": (lambda: _translation((48, 16, 16), (0.8, 0.0, 0.6), 6),
                RP(levels=3, scale_factor=0.7, warps=1, inner_iterations=1,
                   sweeps=5, alpha=0.05), 4),
    "rotation": (lambda: rsyn.make_pair(
        (64, 48, 48), rsyn.rotation((32, 24, 24), axis="y", degrees=3.0),
        texture="fourier", seed=12),
        RP(levels=3, warps=2, inner_iterations=2, sweeps=8, alpha=0.05), 4),
    "sinusoid": (lambda: rsyn.make_pair(
        (80, 48, 48), rsyn.sinusoid((80, 48, 48), amplitude=1.2),
        texture="fourier", seed=13),
        RP(levels=4, warps=1, inner_iterations=2, sweeps=6, alpha=0.05), 4),
    "tricubic": (lambda: _translation((48, 16, 16), (0.8, 0.0, 0.6), 22),
                 RP(levels=2, warps=2, inner_iterations=1, sweeps=6,
                    alpha=0.05, interp="tricubic"), 4),
    "clamp6": (lambda: _translation((64, 24, 24), (4.0, -2.0, 1.5), 11),
               RP(levels=3, warps=3, inner_iterations=2, sweeps=10,
                  alpha=0.05, flow_clamp=6.0), 4),
    "clamp6_tricubic": (lambda: _translation((64, 24, 24), (4.0, -2.0, 1.5),
                                             11),
                        RP(levels=3, warps=3, inner_iterations=2, sweeps=10,
                           alpha=0.05, flow_clamp=6.0, interp="tricubic"), 4),
    "multivoxel": (lambda: _translation((64, 32, 32), (3.0, -2.5, 2.0), 12),
                   RP(levels=3, warps=4, inner_iterations=2, sweeps=20,
                      alpha=0.05, flow_clamp=6.0), 4),
    "accurate_32": (lambda: _translation((32, 32, 32), (0.8, -0.5, 0.6), 3),
                    "accurate", 2),
    "gamma_32": (lambda: _translation((32, 32, 32), (0.8, -0.5, 0.6), 3),
                 RP(levels=2, warps=2, inner_iterations=2, sweeps=8,
                    alpha=0.05, gamma=1.0), 2),
    "packed_32": (lambda: _translation((32, 32, 32), (0.8, -0.5, 0.6), 3),
                  RP(levels=2, warps=2, inner_iterations=2, sweeps=8,
                     alpha=0.05, sweep_layout="packed"), 2),
}


def _ref_params(rp):
    if isinstance(rp, str):
        from tpuflow3d.params import PRESETS as RPRESETS
        # As tests/test_torch_pipeline.py cuts it for 32^3.
        return RPRESETS[rp].replace(levels=2, warps=3)
    return rp


@functools.lru_cache(maxsize=None)
def case(name):
    make, rp, n = CASES[name]
    i0, i1, true = make()
    rp = _ref_params(rp)
    ref = np.asarray(ref_sharded(i0, i1, rp, mesh=make_z_mesh(n)))
    return i0, i1, true, rp, n, ref


def check(pool, name):
    """The port's sharded flow of case ``name`` against the JAX package's
    and, bitwise, against its own one-device flow."""
    i0, i1, true, rp, n, ref = case(name)
    p = from_reference(rp)
    got = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1, p,
                                      ranks=n))
    assert got.shape == ref.shape == (3, *i0.shape)
    np.testing.assert_allclose(got, ref, **TOL)
    one = compute_flow(i0, i1, prepare_params(p, n), device="cpu").numpy()
    np.testing.assert_array_equal(got, one)
    return got
