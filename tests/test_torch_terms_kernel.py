"""K8 and K9, the nonlinearity update (``csrc/terms.cu``), on the CPU: the
route ``solver.compute_terms`` takes, the plain versions, and the solve
with the route forced.

On a CUDA tensor of a whole volume, ``compute_terms`` makes the system in
one launch (``kernels/terms.py``): with gamma = 0 and SOR or multigrid K8
makes (c, psi_s, psi_d) and leaves the weights, sw_inv and smt out; with
gamma > 0 and SOR, K9 makes (c, psi_s, ainv) and leaves psi_d and d6 out
as well. Here the route is forced by patching ``use_kernels`` in the
solver; the wrappers then run the plain versions, ``solver.rank1_terms``
and ``solver.general_terms``, for the CPU tensors in the launch's place.
These tests hold, at 32^3 or smaller:

(a) the route rule: a whole volume with sor (flat or packed) or multigrid
    takes it, and with gamma > 0 with sor (flat, packed or bfloat16
    terms); windows (whatever their origin), Z shards, multigrid with
    gamma > 0, Jacobi and CPU tensors (``use_kernels`` as it is) do not;
(b) rank1_terms' (c, psi_s, psi_d) are bitwise compute_terms' at 1^3,
    2x3x5, 17x9x33 and 32^3, du zero and not; general_terms' (c, psi_s,
    ainv) likewise, with either penalizer of the gradient term and c
    stored in float32 or bfloat16;
(c) w, sw_inv and smt (with gamma > 0 psi_d and d6 too) are None on the
    route only, and the plain versions of K1, K6 and K7 remake what they
    read bitwise (``kernels.sor.with_weights``);
(d) the segmented CPU solve (``graphs.py``'s segments called directly) of
    ladder256, accurate and ladder256 with gamma 1 (flat and packed) at
    32^3 keeps its bits with the route forced, one update per level, warp
    and inner iteration;
(e) the byte models (``utils.roofline.TERMS_BYTES_PER_VOXEL``,
    ``TERMS_GC_BYTES_PER_VOXEL``) are the bytes the wrappers read and
    write.

The kernels against their plain versions run on the card:
tests/test_torch_kernels_cuda.py and chip_smoke.py's ``[terms]`` and
``[terms_gc]``.
"""

import numpy as np
import pytest
import torch

from tpuflow3d_torch import PRESETS, FlowParams, kernels, pipeline, solver
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import sor as ksor
from tpuflow3d_torch.kernels import sor_gc as ksor_gc
from tpuflow3d_torch.kernels import terms as kterms
from tpuflow3d_torch.ops import registry
from tpuflow3d_torch.utils import roofline

torch.set_num_threads(2)

SHAPES = [(1, 1, 1), (2, 3, 5), (17, 9, 33), (32, 32, 32)]


def _inputs(shape, seed=0, du_zero=False):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    i0, i1 = t(rng.normal(size=shape)), t(rng.normal(size=shape))
    g, it = derivatives(i0, i1, HaloCtx())
    flow = t(rng.normal(size=(3, *shape)) * 0.5)
    du = (torch.zeros_like(flow) if du_zero
          else t(rng.normal(size=(3, *shape)) * 0.05))
    return g, it, flow, du, i0, i1


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def force_route(monkeypatch, wrapper: str) -> list:
    """The kernel route for CPU tensors: ``use_kernels`` says yes in the
    solver (the sweeps' wrappers then run their plain versions); the calls
    of ``kernels.terms``' ``wrapper`` are recorded in the list returned."""
    calls = []
    monkeypatch.setattr(solver, "use_kernels", lambda p, x: True)
    real = getattr(kterms, wrapper)

    def recorded(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(kterms, wrapper, recorded)
    return calls


@pytest.fixture
def forced(monkeypatch):
    """The route forced; K8's calls recorded."""
    return force_route(monkeypatch, "terms_rank1")


@pytest.fixture
def forced_gc(monkeypatch):
    """The route forced; K9's calls recorded."""
    return force_route(monkeypatch, "terms_general")


D = 8
SHAPE = (D, 6, 10)
# name -> (params, context, whether compute_terms takes K8, or K9 with
# gamma > 0)
ROUTES = {
    "whole_sor": (FlowParams(), HaloCtx(), True),
    "whole_sor_packed": (FlowParams(sweep_layout="packed"), HaloCtx(), True),
    "whole_sor_bf16": (FlowParams(terms_dtype="bfloat16"), HaloCtx(), True),
    "whole_multigrid": (FlowParams(solver="multigrid"), HaloCtx(), True),
    "jacobi": (FlowParams(solver="jacobi"), HaloCtx(), False),
    "gamma": (FlowParams(gamma=1.0), HaloCtx(), True),
    "gamma_packed": (FlowParams(gamma=1.0, sweep_layout="packed"), HaloCtx(),
                     True),
    "gamma_bf16": (FlowParams(gamma=1.0, terms_dtype="bfloat16"), HaloCtx(),
                   True),
    "multigrid_gamma": (FlowParams(solver="multigrid", gamma=1.0),
                        HaloCtx(), False),
    "jacobi_gamma": (FlowParams(solver="jacobi", gamma=1.0), HaloCtx(),
                     False),
    "window_gamma": (FlowParams(gamma=1.0),
                     HaloCtx(window_z0=0, window_d_global=D), False),
    # A window at plane 0 as deep as its volume is whole by is_whole, and
    # still a window: the streamed mode stays plain.
    "window_whole": (FlowParams(), HaloCtx(window_z0=0, window_d_global=D),
                     False),
    "window_inner": (FlowParams(), HaloCtx(window_z0=4,
                                           window_d_global=3 * D), False),
    "window_tensor": (FlowParams(), HaloCtx(
        window_z0=torch.tensor(0, dtype=torch.int32), window_d_global=D),
                      False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_rule(forced, forced_gc, name):
    p, ctx, route = ROUTES[name]
    g, it, flow, du, i0, i1 = _inputs(SHAPE)
    gc = grad_constancy_terms(i0, i1, ctx, g=g) if p.gamma > 0 else None
    assert solver.terms_on_kernel(g, p, ctx, gc) is route
    t = solver.compute_terms(g, it, flow, du, p, ctx, gc=gc)
    calls, other = (forced_gc, forced) if gc is not None else (forced,
                                                               forced_gc)
    assert len(calls) == int(route) and not other
    # (c) the weights, sw_inv and smt (with gamma > 0 psi_d and d6, which
    # the general system's sweeps do not read) are left out on the route
    # only.
    left_out = (t.w, t.sw_inv, t.smt) + ((t.psi_d, t.d6) if gc is not None
                                         else ())
    for field in left_out:
        assert (field is None) is route
    ref = solver.compute_terms(g, it, flow, du, p.replace(backend="plain"),
                               ctx, gc=gc)
    for field in ("c", "g", "psi_s",
                  "ainv" if gc is not None else "psi_d"):
        got, want = getattr(t, field), getattr(ref, field)
        assert _bitwise(got.float(), want.float()), field


def test_route_rule_shards(forced):
    """A Z shard has neighbours, so it never takes the route (decided
    without touching the group)."""
    g, _, _, _, _, _ = _inputs(SHAPE)
    assert not solver.terms_on_kernel(g, FlowParams(), HaloCtx(n_shards=2,
                                                               rank=1))
    assert not solver.terms_on_kernel(g, FlowParams(), HaloCtx(n_shards=4))


def test_route_rule_shards_gamma(forced):
    """Nor with gradient constancy."""
    g, _, _, _, i0, i1 = _inputs(SHAPE)
    gc = grad_constancy_terms(i0, i1, g=g)
    p = FlowParams(gamma=1.0)
    assert not solver.terms_on_kernel(g, p, HaloCtx(n_shards=2, rank=1), gc)
    assert not solver.terms_on_kernel(g, p, HaloCtx(n_shards=4), gc)


def test_cpu_tensors_stay_plain():
    g, it, flow, du, _, _ = _inputs(SHAPE)
    assert not solver.terms_on_kernel(g, FlowParams(), HaloCtx())
    t = solver.compute_terms(g, it, flow, du, FlowParams())
    assert t.w is not None and t.sw_inv is not None and t.smt is not None
    before = dict(kernels.LAUNCHES)
    c, psi_s, psi_d = kterms.terms_rank1(g, it, flow, du, FlowParams())
    assert kernels.LAUNCHES == before  # CPU: the plain version, no launch
    assert _bitwise(c, t.c) and _bitwise(psi_s, t.psi_s)


@pytest.mark.parametrize("du_zero", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_is_compute_terms(shape, du_zero):
    g, it, flow, du, _, _ = _inputs(shape, seed=sum(shape), du_zero=du_zero)
    p = FlowParams()
    t = solver.compute_terms(g, it, flow, du, p)
    got = solver.rank1_terms(g, it, flow, du, p)
    for a, b in zip(got, (t.c, t.psi_s, t.psi_d)):
        assert _bitwise(a, b)
    quad = p.replace(penalizer_data="quadratic", penalizer_smooth="quadratic")
    tq = solver.compute_terms(g, it, flow, du, quad)
    for a, b in zip(solver.rank1_terms(g, it, flow, du, quad),
                    (tq.c, tq.psi_s, tq.psi_d)):
        assert _bitwise(a, b)


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
def test_plain_sweep_remakes_the_weights(terms_dtype):
    """K1's plain version on the route's compact terms: the weights and
    sw_inv bitwise compute_terms' (smt too where g is stored in float32),
    and each half-sweep bitwise the one on the full terms."""
    g, it, flow, du, _, _ = _inputs((9, 12, 14), seed=3)
    p = FlowParams(terms_dtype=terms_dtype)
    t = solver.compute_terms(g, it, flow, du, p)
    compact = t._replace(w=None, sw_inv=None, smt=None)
    full = ksor.with_weights(compact, p.alpha, HaloCtx())
    for a, b in zip(full.w, t.w):
        assert _bitwise(a, b)
    assert _bitwise(full.sw_inv, t.sw_inv)
    if terms_dtype == "float32":
        assert _bitwise(full.smt, t.smt)
    for color in (0, 1):
        assert _bitwise(ksor.sor_halfsweep(du, compact, p.alpha, p.omega,
                                           color),
                        ksor.sor_halfsweep(du, t, p.alpha, p.omega, color))
    assert _bitwise(ksor.sor_sweeps(du, compact, p.alpha, p.omega, 2),
                    ksor.sor_sweeps(du, t, p.alpha, p.omega, 2))


@pytest.mark.parametrize("name", ["ladder256", "accurate"])
def test_segmented_solve_keeps_its_bits_on_the_route(forced, monkeypatch,
                                                     name):
    p = PRESETS[name]
    shape = (32, 32, 32)
    i0, i1, _ = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)),
                              seed=0)
    i0, i1 = torch.from_numpy(i0), torch.from_numpy(i1)
    got = pipeline.compute_flow(i0, i1, p, device="cpu")
    levels = len(p.level_shapes(shape))
    assert len(forced) == levels * p.warps * p.inner_iterations
    monkeypatch.undo()
    want = pipeline.compute_flow(i0, i1, p, device="cpu")
    assert _bitwise(got, want)


def test_byte_model_is_the_wrappers_bytes():
    g, it, flow, du, _, _ = _inputs((32, 32, 32))
    outs = kterms.terms_rank1(g, it, flow, du, FlowParams())
    nbytes = sum(x.numel() * x.element_size()
                 for x in (g, it, flow, du, *outs))
    assert nbytes == roofline.TERMS_BYTES_PER_VOXEL * it.numel()
    assert roofline.OPS["terms"][1] == "fp32"


# K9: the general system of gamma > 0.

def _gc_inputs(shape, seed=0, du_zero=False):
    g, it, flow, du, i0, i1 = _inputs(shape, seed, du_zero)
    gc_g, gc_it = grad_constancy_terms(i0, i1, g=g)
    return g, it, flow, du, gc_g, gc_it


def test_cpu_tensors_stay_plain_gamma():
    g, it, flow, du, gc_g, gc_it = _gc_inputs(SHAPE)
    p = FlowParams(gamma=1.0)
    assert not solver.terms_on_kernel(g, p, HaloCtx(), (gc_g, gc_it))
    t = solver.compute_terms(g, it, flow, du, p, gc=(gc_g, gc_it))
    assert t.w is not None and t.psi_d is not None and t.d6 is not None
    before = dict(kernels.LAUNCHES)
    c, psi_s, ainv = kterms.terms_general(g, it, flow, du, gc_g, gc_it, p)
    assert kernels.LAUNCHES == before  # CPU: the plain version, no launch
    assert _bitwise(c, t.c) and _bitwise(psi_s, t.psi_s)
    assert _bitwise(ainv, t.ainv)


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("penalizer", ["charbonnier", "quadratic"])
@pytest.mark.parametrize("du_zero", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_general_plain_version_is_compute_terms(shape, du_zero, penalizer,
                                                terms_dtype):
    g, it, flow, du, gc_g, gc_it = _gc_inputs(shape, seed=sum(shape),
                                              du_zero=du_zero)
    p = FlowParams(gamma=1.5, penalizer_grad=penalizer,
                   terms_dtype=terms_dtype)
    t = solver.compute_terms(g, it, flow, du, p, gc=(gc_g, gc_it))
    c, psi_s, ainv = solver.general_terms(g, it, flow, du, gc_g, gc_it, p)
    # compute_terms stores c as p.terms_dtype after the kernel as after
    # the plain arithmetic.
    assert _bitwise(c.to(t.c.dtype).float(), t.c.float())
    assert _bitwise(psi_s, t.psi_s) and _bitwise(ainv, t.ainv)


def _compact(t):
    """The general system as K9's route leaves it."""
    return t._replace(w=None, sw_inv=None, smt=None, psi_d=None, d6=None)


@pytest.mark.parametrize("terms_dtype", ["float32", "bfloat16"])
def test_general_plain_sweeps_remake_the_weights(terms_dtype):
    """K6's plain version on the route's compact terms: the weights
    bitwise compute_terms', each half-sweep and two fused sweeps bitwise
    those on the full terms; K7's plain version (which makes its weights
    from psi_s anyway) likewise."""
    g, it, flow, du, gc_g, gc_it = _gc_inputs((9, 12, 14), seed=3)
    p = FlowParams(gamma=1.0, terms_dtype=terms_dtype)
    t = solver.compute_terms(g, it, flow, du, p, gc=(gc_g, gc_it))
    compact = _compact(t)
    full = ksor.with_weights(compact, p.alpha, HaloCtx())
    assert full.sw_inv is None and full.smt is None
    for a, b in zip(full.w, t.w):
        assert _bitwise(a, b)
    alphas = (p.alpha,) * 3
    for color in (0, 1):
        assert _bitwise(
            ksor_gc.sor_halfsweep_gc(du, compact, alphas, p.omega, color),
            ksor_gc.sor_halfsweep_gc(du, t, alphas, p.omega, color))
    assert _bitwise(ksor_gc.sor_gc_sweeps(du, compact, alphas, p.omega, 2),
                    ksor_gc.sor_gc_sweeps(du, t, alphas, p.omega, 2))
    packed = p.replace(sweep_layout="packed")
    got, step = solver._packed_sweeper(du, compact, packed, HaloCtx())
    want, ref_step = solver._packed_sweeper(du, t, packed, HaloCtx())
    for a, b in zip(step(step(got)), ref_step(ref_step(want))):
        assert _bitwise(a, b)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_gamma_segmented_solve_keeps_its_bits_on_the_route(forced_gc,
                                                           monkeypatch,
                                                           layout):
    p = PRESETS["ladder256"].replace(gamma=1.0, sweep_layout=layout)
    shape = (32, 32, 32)
    i0, i1, _ = syn.make_pair(shape, syn.translation((1.5, -1.0, 0.75)),
                              seed=0)
    i0, i1 = torch.from_numpy(i0), torch.from_numpy(i1 * 1.1 + 0.05)
    got = pipeline.compute_flow(i0, i1, p, device="cpu")
    levels = len(p.level_shapes(shape))
    assert len(forced_gc) == levels * p.warps * p.inner_iterations
    monkeypatch.undo()
    want = pipeline.compute_flow(i0, i1, p, device="cpu")
    assert _bitwise(got, want)


def test_general_byte_model_is_the_wrappers_bytes():
    g, it, flow, du, gc_g, gc_it = _gc_inputs((32, 32, 32))
    outs = kterms.terms_general(g, it, flow, du, gc_g, gc_it,
                                FlowParams(gamma=1.0))
    nbytes = sum(x.numel() * x.element_size()
                 for x in (g, it, flow, du, gc_g, gc_it, *outs))
    assert nbytes == roofline.TERMS_GC_BYTES_PER_VOXEL * it.numel() == \
        128 * it.numel()
    assert roofline.OPS["terms_gc"][1] == "fp32"
    solve = registry.get_op("solve")
    assert solve.byte_variants["nonlinearity update, general (K9)"] == 128
