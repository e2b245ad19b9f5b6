"""K8, the rank-1 nonlinearity update (``csrc/terms.cu``), on the CPU: the
route ``solver.compute_terms`` takes, its plain version, and the solve with
the route forced.

On a CUDA tensor of a whole volume with gamma = 0 and SOR or multigrid,
``compute_terms`` makes (c, psi_s, psi_d) with K8 (``kernels/terms.py``)
and leaves the weights, sw_inv and smt out. Here the route is forced by
patching ``use_kernels`` in the solver; the wrapper then runs the plain
version, ``solver.rank1_terms``, for the CPU tensors in the launch's place.
These tests hold, at 32^3 or smaller:

(a) the route rule: a whole volume with sor (flat or packed) or multigrid
    takes it; windows (whatever their origin), Z shards, gamma > 0, Jacobi
    and CPU tensors (``use_kernels`` as it is) do not;
(b) rank1_terms' (c, psi_s, psi_d) are bitwise compute_terms' at 1^3,
    2x3x5, 17x9x33 and 32^3, du zero and not;
(c) w, sw_inv and smt are None on the route only, and K1's plain version
    remakes them bitwise (``kernels.sor.with_weights``);
(d) the segmented CPU solve (``graphs.py``'s segments called directly) of
    ladder256 and accurate at 32^3 keeps its bits with the route forced,
    one update per level, warp and inner iteration;
(e) the byte model (``utils.roofline.TERMS_BYTES_PER_VOXEL``) is the bytes
    the wrapper reads and writes.

The kernel against its plain version runs on the card:
tests/test_torch_kernels_cuda.py and chip_smoke.py's ``[terms]``.
"""

import numpy as np
import pytest
import torch

from tpuflow3d_torch import PRESETS, FlowParams, kernels, pipeline, solver
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
from tpuflow3d_torch.grid import HaloCtx
from tpuflow3d_torch.kernels import sor as ksor
from tpuflow3d_torch.kernels import terms as kterms
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


@pytest.fixture
def forced(monkeypatch):
    """The kernel route for CPU tensors: ``use_kernels`` says yes in the
    solver (the sweeps' wrappers then run their plain versions); the
    wrapper's calls are recorded."""
    calls = []
    monkeypatch.setattr(solver, "use_kernels", lambda p, x: True)
    real = kterms.terms_rank1

    def recorded(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(kterms, "terms_rank1", recorded)
    return calls


D = 8
SHAPE = (D, 6, 10)
# name -> (params, context, whether compute_terms takes K8)
ROUTES = {
    "whole_sor": (FlowParams(), HaloCtx(), True),
    "whole_sor_packed": (FlowParams(sweep_layout="packed"), HaloCtx(), True),
    "whole_sor_bf16": (FlowParams(terms_dtype="bfloat16"), HaloCtx(), True),
    "whole_multigrid": (FlowParams(solver="multigrid"), HaloCtx(), True),
    "jacobi": (FlowParams(solver="jacobi"), HaloCtx(), False),
    "gamma": (FlowParams(gamma=1.0), HaloCtx(), False),
    "multigrid_gamma": (FlowParams(solver="multigrid", gamma=1.0),
                        HaloCtx(), False),
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
def test_route_rule(forced, name):
    p, ctx, route = ROUTES[name]
    g, it, flow, du, i0, i1 = _inputs(SHAPE)
    gc = grad_constancy_terms(i0, i1, ctx, g=g) if p.gamma > 0 else None
    assert solver.terms_on_kernel(g, p, ctx, gc) is route
    t = solver.compute_terms(g, it, flow, du, p, ctx, gc=gc)
    assert len(forced) == int(route)
    # (c) the weights, sw_inv and smt are left out on the route only.
    for field in (t.w, t.sw_inv, t.smt):
        assert (field is None) is route
    ref = solver.compute_terms(g, it, flow, du, p.replace(backend="plain"),
                               ctx, gc=gc)
    for field in ("c", "g", "psi_s", "psi_d"):
        got, want = getattr(t, field), getattr(ref, field)
        assert _bitwise(got.float(), want.float()), field


def test_route_rule_shards(forced):
    """A Z shard has neighbours, so it never takes the route (decided
    without touching the group)."""
    g, _, _, _, _, _ = _inputs(SHAPE)
    assert not solver.terms_on_kernel(g, FlowParams(), HaloCtx(n_shards=2,
                                                               rank=1))
    assert not solver.terms_on_kernel(g, FlowParams(), HaloCtx(n_shards=4))


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
