"""Device-memory model of the port's runs, and the device's budget.

The command line chooses in-core (``pipeline.compute_flow``) or the
out-of-core mode (``piecewise.compute_flow_piecewise``) and the latter's
Z-chunk from this module (``cli._auto_mode``), as the reference's
``main()`` picks entire-data or piecewise by free GPU memory. The numbers
are the port's, measured on the card (NVIDIA H100 80GB HBM3, 700 W) with
``torch.cuda.max_memory_allocated`` (``tools/torch_memory_peaks.py``,
``chip_smoke.py``); none is carried over from the JAX package, whose model
under-predicts the port's in-core peak (0.37x at 512^3 for ``ladder512``).

- In-core, the peak is set by the finest pyramid level: the allocated
  bytes per finest voxel of each kind of system (rank-1 SOR or Jacobi,
  gradient constancy, multigrid) and sweep layout, from the second warp
  on (the first warp holds one flow field less). Interpolation, stencil
  order, early stop and the median move it by less than 0.1%. On the GPU
  ``compute_flow`` replays CUDA graphs (``graphs.py``): its first call,
  which captures them, sets the peak, and the entry then holds the graphs'
  pool (the results and the largest segment's working set) and the static
  tensors until ``graphs.clear()``; the model covers both the first call's
  allocated peak and what the entry holds.
- Streamed, the peak is the largest phase: fields per slab plane times
  the slab's planes (the chunk plus that phase's margins), and for
  multigrid the device-resident coarse chain of the V-cycle. On the GPU
  the phases replay CUDA graphs (``graphs.stream_runner``) whose entry
  holds, until ``graphs.clear()``, an arena of the most that one phase
  stages in and out (``piecewise.stream_arena``) and the graphs' pool,
  where the replays' working sets live: the model is the arena plus
  ``_STREAM_POOL`` times the largest phase (measured on the pool's
  reserved bytes: the pool keeps what every level's graphs need).
- Both are multiplied by ``ALLOCATOR_HEADROOM``: the caching allocator's
  reserve over its allocated bytes reached 1.30x in-core (the reserved
  peak is what has to fit); a streamed run's cached blocks are all freed
  and retried before the allocator gives up.

``incore_fits_index_limits`` asks the kernel wrappers' own ``grid_fits``
whether the finest level passes a kernel's 32-bit index limits (which
raise in-core); the streamed slabs stay under them.

- Z-sharded, a rank's peak is the in-core model at its slab, d/n planes
  plus the warp's I1 halo on each side (``sharded_peak_bytes``), which
  the command line's auto choice reads; ``chip_smoke.py`` holds it to the
  peak each rank measures (two ranks sharing the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpuflow3d_torch.mgsolver import mg_shapes

ALLOCATOR_HEADROOM = 1.3

# In-core: allocated bytes per voxel of the finest level, float32 volumes,
# the pyramid at scale_factor 0.5 included (256^3 and 512^3 agree to
# 0.1%; the bfloat16-terms forms of the flat and packed layouts need up to
# 4 B more than float32, and these cover both).
_INCORE_BYTES = {
    "flat": 258,            # SOR (K1) or Jacobi, flat layout
    "packed": 298,          # SOR in the packed layout (K4)
    # Gradient constancy, flat (K6) or multigrid, graphed: allocated 415 B
    # a voxel flat at 256^3 and 512^3 (reserved 485 and 506: 67.97e9 B at
    # 512^3), multigrid 487 at 256^3 (reserved 571-583). 470 x
    # ALLOCATOR_HEADROOM covers each reserved peak by 5.6% or more and, at
    # 512^3 flat (82.09e9 B), stays under an idle card's budget (84.47e9 B;
    # NVIDIA H100 80GB HBM3, 700 W).
    "gamma": 470,
    "packed_gamma": 526,    # gradient constancy, packed (K7)
    # Multigrid without gradient constancy (K6): 331 eager; graphed the
    # frozen system of every level stays in the pool and the pool's
    # reserved bytes reach 1.23x the allocated peak, 390 B a voxel at
    # 512^3 (``accurate``: 68.15e9 reserved, 65.45e9 held).
    "multigrid": 395,
}
# Below ~64^3 the allocator's 2 MiB blocks and the CUDA workspaces dominate.
_FIXED_BYTES = 64 << 20

# Streamed passes (``piecewise.level_plan``'s names): float32 fields per
# slab plane, the slab's inputs and the results of the chunk before
# (drained one chunk late) included, at the finest level (the peaks inside
# each pass's call, ``tools/torch_memory_peaks.py --phases``, rounded up).
_STREAM_FIELDS = {
    "warp": 14,            # K2/K5 warp + derivatives
    "warp_plain": 46,      # deriv_order 4: the plain warp and stencils
    "terms": 48,           # rank-1 sweep constants
    "terms_mg": 52,        # multigrid constituents (c, psi_s, d6)
    "terms_gc": 98,        # gradient constancy: warp + gc terms
    "sor": 32,             # the trapezoid sweeps
    "sor_bf16": 35,
    "jacobi": 41,          # one Jacobi sweep
    "fused": 49,           # one whole warp iteration
    "fused_gc": 92,
    "mg_smooth": 49,       # multigrid trapezoid smooth
    "mg_residual": 45,
    "mg_restrict": 42,     # the fine residual restricted (chunk + 2 planes)
    "median": 10,
    "upsample": 21,        # the flow brought up to the level (chunk + 2)
}
# Float32 fields per coarse voxel live in the streamed V-cycle (the coarse
# chain's weights, inverse, data block, smoothness weight, parity, the
# restricted inputs and the cycle's increments, residuals and right-hand
# sides), measured over the chain below a 256^3 level: 47.7.
MG_CHANNELS = 48
# Fields of the first coarse level that stay on the device through the fine
# phases: the restricted psi_s and d6, the restricted residual and the
# coarse correction (10-13 measured).
_MG_INPUT_CHANNELS = 13
# The streamed graphs' pool (its reserved segments) against the largest
# phase's working set or the multigrid's coarse chain: the pool keeps the
# replays' working sets of every level, which the graphs share only where
# the allocator's blocks fit. Measured over tools/torch_memory_peaks.py's
# 26 streamed runs, reserved bytes included (NVIDIA H100 80GB HBM3, 700 W):
# up to 1.85 for multigrid without gradient constancy (passes of one size,
# and the coarse chain beside them), 1.70 with 5-point stencils (the plain
# warp), 1.32 for the others; the smoke's full pyramids 0.33-1.63 (held).
_STREAM_POOL = {"multigrid": 1.9, "order4": 1.75, "other": 1.5}


def _finest(shape, p) -> tuple[int, int, int]:
    return tuple(p.level_shapes(tuple(shape))[0])


def _packed(p, w: int) -> bool:
    return p.solver == "sor" and p.sweep_layout == "packed" and w % 2 == 0


def incore_peak_bytes(shape, p) -> int:
    """Device bytes an in-core run (``compute_flow``, the kernels on the
    GPU) of a (D, H, W) volume with FlowParams ``p`` needs: the allocated
    peak modelled per finest voxel, a pyramid finer than scale 0.5 added,
    times ``ALLOCATOR_HEADROOM``."""
    shapes = p.level_shapes(tuple(shape))
    finest = int(np.prod(shapes[0]))
    coarse = sum(int(np.prod(s)) for s in shapes[1:])
    w = shapes[0][2]
    if p.gamma > 0.0:
        kind = "packed_gamma" if _packed(p, w) else "gamma"
    elif p.solver == "multigrid":
        kind = "multigrid"
    else:
        kind = "packed" if _packed(p, w) else "flat"
    # Two pyramids of float32; scale 0.5 (coarse <= finest / 7) is in the
    # per-voxel numbers.
    pyramid = 8 * max(0.0, coarse - finest / 7)
    allocated = _INCORE_BYTES[kind] * finest + pyramid + _FIXED_BYTES
    return int(ALLOCATOR_HEADROOM * allocated)


def incore_fits_index_limits(shape, p) -> bool:
    """Whether the kernels an in-core run launches take its finest level
    (each wrapper's own ``grid_fits``: K1/K6 need 6*D*H*W < 2^31, above
    ~709^3; K2/K5 and K3 3*D*H*W < 2^31). The packed sweeps (K4/K7) index
    with 64 bits; the plain backend launches nothing."""
    if p.backend == "plain":
        return True
    from tpuflow3d_torch.kernels import median3, sor, warp_grad

    d, h, w = _finest(shape, p)
    fits = True
    if p.deriv_order == 2:
        fits &= warp_grad.grid_fits(d, h, w)
    if p.median:
        fits &= median3.grid_fits(3, d, h, w)
    if p.solver == "multigrid" or (p.solver == "sor" and not _packed(p, w)):
        fits &= sor.grid_fits(d, h, w)
    return fits


def _shard_slab(shape, p, n: int) -> tuple[tuple[int, int, int], int]:
    """(a rank's finest slab padded by its warp's I1 halo, that halo): the
    finest level of the run ``sharding.prepare_params`` makes for n ranks,
    d/n planes, plus ceil(clamp) + 2 planes a side (+ 3 tricubic), what the
    fused warp (K2/K5 in halo form) holds of I1."""
    from tpuflow3d_torch.sharding import prepare_params
    from tpuflow3d_torch.warp import warp_halo
    p = prepare_params(p, n)
    d, h, w = _finest(shape, p)
    halo = warp_halo(p.flow_clamp, p.interp) + 1
    return (d // n + 2 * halo, h, w), halo


def sharded_peak_bytes(shape, p, n: int) -> int:
    """Device bytes a rank of a Z-sharded in-core run over n ranks
    (``sharding.compute_flow_sharded``, the kernels on the GPU) needs: the
    in-core model (per finest voxel, the coarser levels, the allocator
    headroom) at its slab of d/n planes plus the warp's I1 halo on both
    sides (``_shard_slab``). The exchanged planes are staged in host
    memory under gloo and not counted."""
    slab, _ = _shard_slab(shape, p, n)
    from tpuflow3d_torch.sharding import prepare_params
    pp = prepare_params(p, n).replace(z_multiple=1)
    return incore_peak_bytes(slab, pp)


def sharded_fits_index_limits(shape, p, n: int) -> bool:
    """Whether a rank's arrays pass the kernels' 32-bit index limits (the
    halo form's padded arrays for K2/K5)."""
    if p.backend == "plain":
        return True
    from tpuflow3d_torch.kernels import median3, sor, warp_grad
    (dp, h, w), halo = _shard_slab(shape, p, n)
    d = dp - 2 * halo
    fits = median3.grid_fits(3, d, h, w) if p.median else True
    if p.deriv_order == 2:
        fits &= warp_grad.grid_fits(d, h, w, halo)
    if p.solver == "multigrid" or (p.solver == "sor" and not _packed(p, w)):
        fits &= sor.grid_fits(d, h, w)
    return fits


def _stream_slabs(shape, p, chunk: int) -> list[tuple[int, int]]:
    """(float32 fields per slab plane, slab planes) of each pass of a
    streamed level of ``shape`` with Z-chunks of ``chunk`` (the finest
    level's; coarser levels have smaller planes and the same slabs):
    ``piecewise.level_plan``'s passes, with the flow upsampling and, for
    multigrid, the restriction beside them."""
    from tpuflow3d_torch.piecewise import level_plan

    f = _STREAM_FIELDS
    variant = {"fused": "fused_gc" if p.gamma > 0.0 else "fused",
               "warp": "warp_plain" if p.deriv_order == 4 else "warp",
               "sor": "sor_bf16" if p.terms_dtype == "bfloat16" else "sor"}
    slabs = [(f["upsample"], chunk + 2)]
    for ps in level_plan(p, shape, chunk):
        slabs.append((f[variant.get(ps.name, ps.name)], ps.planes))
        if ps.name == "mg_residual":
            slabs.append((f["mg_restrict"], chunk + 2))
    return slabs


def mg_coarse_resident_bytes(shape, p) -> int:
    """Allocated bytes of the streamed V-cycle's device-resident coarse
    chain (``piecewise._stream_mg_solve``): ``MG_CHANNELS`` float32 fields
    per voxel summed over ``mgsolver.mg_shapes`` of the finest level below
    the level itself. 0 unless p.solver == "multigrid"."""
    if p.solver != "multigrid":
        return 0
    shapes = mg_shapes(_finest(shape, p), 1)[1:]
    return 4 * MG_CHANNELS * sum(int(np.prod(s)) for s in shapes)


def streamed_peak_bytes(shape, p, chunk: int) -> int:
    """Device bytes a streamed run (``compute_flow_piecewise``, the kernels
    on the GPU, replayed from its graphs) of a (D, H, W) volume with
    Z-chunks of ``chunk`` planes needs, and its graphs hold after it: its
    largest phase (slab planes times fields per plane, the multigrid's
    restricted inputs beside the slab) or the multigrid V-cycle's coarse
    chain, times ``_STREAM_POOL`` (the graphs' pool, reserved bytes: no
    ``ALLOCATOR_HEADROOM`` on top), plus the arena of the phases' static
    inputs and results."""
    from tpuflow3d_torch.piecewise import stream_arena

    arena = 4 * stream_arena(p, shape, chunk)
    shape = _finest(shape, p)
    _, h, w = shape
    plane = 4 * h * w
    slab = max(fields * planes
               for fields, planes in _stream_slabs(shape, p, chunk)) * plane
    reserve = mg_coarse_resident_bytes(shape, p)
    if reserve:
        coarse = mg_shapes(shape, 1)[1]
        slab += 4 * _MG_INPUT_CHANNELS * int(np.prod(coarse))
    kind = ("multigrid" if p.solver == "multigrid" and p.gamma <= 0.0 else
            "order4" if p.deriv_order == 4 else "other")
    return int(_STREAM_POOL[kind] * max(slab, reserve) + arena
               + _FIXED_BYTES)


def _slabs_fit_index_limits(shape, p, chunk: int) -> bool:
    """Whether every slab of a streamed run passes the kernels' 32-bit
    index limits (checked at the largest slab for each kernel)."""
    from tpuflow3d_torch.kernels import median3, sor, warp_grad

    _, h, w = shape
    planes = max(n for _, n in _stream_slabs(shape, p, chunk))
    return (sor.grid_fits(planes, h, w) and warp_grad.grid_fits(planes, h, w)
            and median3.grid_fits(3, planes, h, w))


def pick_chunk_z(shape, p, budget: int, lo: int = 8) -> int:
    """The largest Z-chunk (at most the volume's depth) whose streamed run
    fits in ``budget`` device bytes and whose slabs pass the kernels' index
    limits. Raises ValueError, with the numbers, when no chunk of ``lo``
    planes or more fits (or the depth, on a shallower volume): a run that
    could not fit would stream for hours before running out of memory."""
    shape = _finest(shape, p)
    d, h, w = shape
    reserve = mg_coarse_resident_bytes(shape, p)
    if reserve and int(ALLOCATOR_HEADROOM * (reserve + _FIXED_BYTES)) > budget:
        raise ValueError(
            f"streamed multigrid at {shape} keeps a coarse hierarchy of "
            f"~{reserve / 2**30:.2f} GiB on the device (x{ALLOCATOR_HEADROOM}"
            f" allocator headroom) against a budget of "
            f"{budget / 2**30:.2f} GiB: it cannot run piecewise on this "
            "device; use solver='sor' (fully streamed) at this size")

    def fits(c: int) -> bool:
        return (streamed_peak_bytes(shape, p, c) <= budget
                and _slabs_fit_index_limits(shape, p, c))

    # Both tests only fail more often as the chunk grows: bisect.
    good, bad = 0, d + 1
    while bad - good > 1:
        mid = (good + bad) // 2
        good, bad = (mid, bad) if fits(mid) else (good, mid)
    chunk = good
    need = min(lo, d)
    if chunk < need:
        raise ValueError(
            f"no Z-chunk of {need} or more planes fits: a {need}-plane "
            f"chunk of {shape} needs "
            f"{streamed_peak_bytes(shape, p, need) / 2**30:.2f} GiB of "
            f"device memory against a budget of {budget / 2**30:.2f} GiB"
            + ("" if _slabs_fit_index_limits(shape, p, need) else
               " and its slabs pass the kernels' 32-bit index limits"))
    return int(chunk)


def device_budget_bytes(device=None):
    """Device bytes a run can use, or None on the CPU (in-core is host
    memory there, the memory the out-of-core mode streams from). The
    environment variable ``TPUFLOW_DEVICE_BYTES`` overrides it on any
    device (the reference's own test hook). On a CUDA device (the current
    one by default): the free bytes ``torch.cuda.mem_get_info`` reports,
    plus what PyTorch's caching allocator holds without a live tensor in
    it (``memory_reserved - memory_allocated``), which the run reuses;
    tensors alive in this process are not counted."""
    env = os.environ.get("TPUFLOW_DEVICE_BYTES")
    if env:
        return int(env)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free + cached)
