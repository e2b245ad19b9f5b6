"""The port's colour-packed layout and packed half-sweeps (the plain
versions of kernels K4 and K7, and their wrappers, which run them for CPU
tensors) against the JAX package: pack_color / unpack_colors bitwise, the
half-sweeps against the packed Pallas kernels in interpret mode and against
the port's own flat plain sweep.

Tolerance against the Pallas kernels atol 5e-5, rtol 1e-5, as
tests/test_torch_sor.py states it and for the same reason (XLA on the CPU
contracts and orders the six neighbour terms in its own way). Against the
port's flat plain sweep the packed plain sweep is held bitwise: it does the
same operations in the same order on a permutation of the same values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow3d import derivatives as rder
from tpuflow3d import solver as rsol
from tpuflow3d import warp as rwarp
from tpuflow3d.grid import HaloCtx as RefCtx
from tpuflow3d.pallas import sor_gc_packed as ref_gc_packed
from tpuflow3d.pallas import sor_packed as ref_packed
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d_torch import derivatives as pder
from tpuflow3d_torch import kernels
from tpuflow3d_torch import solver as psol
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import sor_gc_packed as k7
from tpuflow3d_torch.kernels import sor_packed as k4
from tpuflow3d_torch.params import FlowParams

torch.set_num_threads(2)

ALPHA, GAMMA = 0.05, 1.5
TOL = dict(atol=5e-5, rtol=1e-5)
SHAPES = [(12, 10, 14), (8, 16, 16), (7, 9, 12)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _as_port(rt):
    """The reference's terms as the port's SolveTerms (the weights as a
    tuple of six volumes; bfloat16 arrays widened, which is exact, and
    stored in bfloat16 again)."""
    def conv(v):
        if v is None:
            return None
        if v.dtype == jnp.bfloat16:
            return _t(v.astype(jnp.float32)).to(torch.bfloat16)
        return _t(v)
    f = {k: conv(v) for k, v in rt._asdict().items()}
    return psol.SolveTerms(**{**f, "w": tuple(f["w"])})


def _terms(shape, gamma, seed=0, terms_dtype="float32"):
    """The same inputs through both packages' compute_terms. With
    gamma > 0 (the general SPD system, ainv set) the port's sweeps are held
    to the reference on the reference's terms: the adjugate inverse
    amplifies last-bit differences of the data block (up to 4.5e-4
    relative, tests/test_torch_gamma.py), which is compute_terms' matter and
    not the sweep's."""
    rng = np.random.default_rng(seed)
    i0 = rng.normal(size=shape).astype(np.float32)
    shift = np.zeros((3, *shape), np.float32)
    shift[2] = 0.7
    i1 = jax.jit(rwarp.warp_volume)(jnp.asarray(i0), jnp.asarray(-shift))
    g, it = jax.jit(rder.derivatives)(jnp.asarray(i0), i1)
    gc = pgc = None
    if gamma > 0.0:
        gc = rder.grad_constancy_terms(jnp.asarray(i0), i1, g=g)
        pgc = pder.grad_constancy_terms(_t(i0), _t(i1), g=_t(g))
    flow = (rng.normal(size=(3, *shape)) * 0.1).astype(np.float32)
    du = (rng.normal(size=(3, *shape)) * 0.05).astype(np.float32)
    rt = rsol.compute_terms(
        g, it, jnp.asarray(flow), jnp.asarray(du),
        RefParams(alpha=ALPHA, gamma=gamma, terms_dtype=terms_dtype), gc=gc)
    pt = psol.compute_terms(
        _t(g), _t(it), _t(flow), _t(du),
        FlowParams(alpha=ALPHA, gamma=gamma, terms_dtype=terms_dtype),
        gc=pgc)
    if gamma > 0.0:
        pt = _as_port(rt)
    return du, rt, pt


def _packed_half(mod, ctx, du, t, omega, color, z0=0, dg=None, fn=None,
                 **kw):
    """One packed half-sweep of ``color`` on the full ``du`` through the
    package ``mod`` comes from (the reference's modules or the port's),
    unpacked again: pack, fetch the other colour's halos, sweep, unpack."""
    packed = ref_packed if mod in (ref_packed, ref_gc_packed) else k4
    pk = lambda a, c: packed.pack_color(a, c, z0)
    d = du.shape[1]
    dua, duo = pk(du, color), pk(du, 1 - color)
    pso = pk(t.psi_s, 1 - color)
    lo, hi = ctx.z_halo_planes(duo)
    plo, phi = ctx.z_halo_planes(pso)
    if t.ainv is not None:
        fn = fn or mod.sor_halfsweep_gc_packed
        mid = (pk(t.c, color), pk(t.ainv, color), pk(t.psi_s, color), pso)
    else:
        fn = fn or mod.sor_halfsweep_packed
        mid = (pk(t.c, color), pk(t.g, color), pk(t.psi_s, color), pso,
               pk(t.psi_d, color))
    out = fn(dua, duo, *mid, lo, hi, plo, phi, z0, ALPHA, omega, color,
             d if dg is None else dg, **kw)
    pair = (out, duo) if color == 0 else (duo, out)
    return packed.unpack_colors(*pair, z0)


def _ref_half(du, rt, omega, color):
    mod = ref_gc_packed if rt.ainv is not None else ref_packed
    return _packed_half(mod, RefCtx(), du, rt, omega, color, interpret=True)


def _port_half(du, pt, omega, color):
    mod = k7 if pt.ainv is not None else k4
    return _packed_half(mod, HaloCtx(), du, pt, omega, color)


@pytest.mark.parametrize("z0", [0, 3])
@pytest.mark.parametrize("shape", [(6, 8, 10), (3, 6, 8, 10), (5, 7, 12),
                                   (6, 5, 7, 4)])
def test_pack_unpack_bitwise(shape, z0):
    """Round trip, and equality with the reference's functions, at z0 = 0
    and an odd z0 (global, not slab-local, parity)."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    packs = [k4.pack_color(_t(x), c, z0) for c in (0, 1)]
    for c in (0, 1):
        ref = ref_packed.pack_color(jnp.asarray(x), c, z0)
        assert packs[c].shape == (*shape[:-1], shape[-1] // 2)
        assert packs[c].is_contiguous()
        np.testing.assert_array_equal(packs[c].numpy(), np.asarray(ref))
    back = k4.unpack_colors(*packs, z0)
    np.testing.assert_array_equal(back.numpy(), x)
    ref_back = ref_packed.unpack_colors(*(jnp.asarray(p.numpy())
                                          for p in packs), z0)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))


def test_pack_follows_global_parity_and_keeps_dtype():
    """Packing a slab with its z0 equals slicing the packed volume; each
    packed element is the voxel of its colour at x = 2i + off; bfloat16
    stays bfloat16; odd W raises."""
    x = _t(np.random.default_rng(1).normal(size=(8, 6, 10))
           .astype(np.float32))
    full = k4.pack_color(x, 0, 0)
    assert torch.equal(full[3:6], k4.pack_color(x[3:6], 0, 3))
    parity = psol.parity_mask((8, 6, 10), HaloCtx())
    for c in (0, 1):
        assert torch.equal(k4.pack_color(x, c, 0).flatten(),
                           x[parity == c])
    assert k4.pack_color(x.to(torch.bfloat16), 1, 0).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="odd"):
        k4.pack_color(x[..., :9], 0, 0)


@pytest.mark.parametrize("gamma", [0.0, GAMMA], ids=["k4", "k7"])
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_halfsweep_matches_reference(shape, color, gamma):
    """Plain K4 (gamma 0) and K7 against the packed Pallas kernel in
    interpret mode, and bitwise against the port's flat plain sweep; the
    wrapper runs the plain version for a CPU tensor and launches nothing."""
    du, rt, pt = _terms(shape, gamma)
    omega = 1.7
    before = dict(kernels.LAUNCHES)
    got = _port_half(_t(du), pt, omega, color)
    assert kernels.LAUNCHES == before
    ref = _ref_half(jnp.asarray(du), rt, omega, color)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    parity = psol.parity_mask(shape, HaloCtx())
    flat = psol.sor_halfsweep(_t(du), pt, omega, parity, color)
    assert torch.equal(got, flat)
    plain = (k7.sor_halfsweep_gc_packed_plain if gamma > 0.0
             else k4.sor_halfsweep_packed_plain)
    assert torch.equal(
        _packed_half(None, HaloCtx(), _t(du), pt, omega, color, fn=plain),
        got)


@pytest.mark.parametrize("gamma", [0.0, GAMMA], ids=["k4", "k7"])
@pytest.mark.parametrize("color", [0, 1])
def test_packed_halfsweep_on_a_slab(color, gamma):
    """A slab of the volume with its z0, the global depth and its
    neighbours' halo planes gives the slab of the full half-sweep, bitwise:
    the row offset and the faces follow the global z."""
    shape, lo_z, hi_z = (9, 8, 10), 3, 7
    du, _, pt = _terms(shape, gamma, seed=2)
    full = _port_half(_t(du), pt, 1.8, color)
    pk = lambda a, c: k4.pack_color(a[..., lo_z:hi_z, :, :], c, lo_z)
    pk_full = lambda a, c: k4.pack_color(a, c, 0)
    du_t = _t(du)
    duo_full, pso_full = pk_full(du_t, 1 - color), pk_full(pt.psi_s,
                                                           1 - color)
    halos = (duo_full[:, lo_z - 1:lo_z], duo_full[:, hi_z:hi_z + 1],
             pso_full[lo_z - 1:lo_z], pso_full[hi_z:hi_z + 1])
    if gamma > 0.0:
        out = k7.sor_halfsweep_gc_packed(
            pk(du_t, color), pk(du_t, 1 - color), pk(pt.c, color),
            pk(pt.ainv, color), pk(pt.psi_s, color), pk(pt.psi_s, 1 - color),
            *halos, lo_z, ALPHA, 1.8, color, shape[0])
    else:
        out = k4.sor_halfsweep_packed(
            pk(du_t, color), pk(du_t, 1 - color), pk(pt.c, color),
            pk(pt.g, color), pk(pt.psi_s, color), pk(pt.psi_s, 1 - color),
            pk(pt.psi_d, color), *halos, lo_z, ALPHA, 1.8, color, shape[0])
    assert torch.equal(out, pk_full(full, color)[:, lo_z:hi_z])


@pytest.mark.parametrize("gamma", [0.0, GAMMA], ids=["k4", "k7"])
def test_packed_sweep_sequence_matches_reference(gamma):
    """Five red+black sweeps: plain port packed against the packed Pallas
    kernel, and bitwise against the port's flat plain sweeps."""
    shape = (10, 12, 8)
    du, rt, pt = _terms(shape, gamma, seed=3)
    omega = 1.9
    parity = psol.parity_mask(shape, HaloCtx())
    got = flat = _t(du)
    ref = jnp.asarray(du)
    for _ in range(5):
        for color in (0, 1):
            got = _port_half(got, pt, omega, color)
            flat = psol.sor_halfsweep(flat, pt, omega, parity, color)
            ref = _ref_half(ref, rt, omega, color)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(got, flat)


@pytest.mark.parametrize("gamma", [0.0, GAMMA], ids=["k4", "k7"])
@pytest.mark.parametrize("color", [0, 1])
def test_packed_halfsweep_bf16_terms(color, gamma):
    """bfloat16 c (and g): the stored arrays are bitwise the reference's,
    the packed plain sweep widens them and stays bitwise the port's flat
    plain sweep, and within the sweep tolerance of the Pallas kernel on the
    reference's bfloat16 terms."""
    shape = (8, 16, 16)
    du, rt, pt = _terms(shape, gamma, terms_dtype="bfloat16")
    for name in ("c", "g"):
        a, b = getattr(pt, name), getattr(rt, name)
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
    got = _port_half(_t(du), pt, 1.7, color)
    assert got.dtype == torch.float32
    parity = psol.parity_mask(shape, HaloCtx())
    assert torch.equal(got, psol.sor_halfsweep(_t(du), pt, 1.7, parity,
                                               color))
    ref = _ref_half(jnp.asarray(du), rt, 1.7, color)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
