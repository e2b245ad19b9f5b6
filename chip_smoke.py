#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpuflow3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Requires a CUDA device; prints the card's name and power limit and the
   torch and CUDA versions.
2. Builds the CUDA kernels from src/tpuflow3d_torch/csrc with nvcc (one
   nvcc per source, started together). Then ``[roofline]``: the card's
   own rates beside its data sheet's (``tpuflow3d_torch.utils.roofline``,
   the one source of every rate, byte and operation count below): the
   copy kernel of ``csrc/probe.cu`` at 1 GiB and at 64 MiB a side, each
   with t16/t1 (16 copies against one) and ``Tensor.copy_``'s rate, the
   1 GiB rate checked (t16/t1 in [12, 20], at most the data sheet's) and
   taken as the probed bandwidth; and the fminf/fmaxf rate of its min/max
   loop.
3. Holds each kernel against its plain PyTorch version on the card at the
   finest-level shapes of the 256^3 runs, and times both: K1 SOR sweeps
   (each colour alone, the fused red+black sweep against two plain
   half-sweeps, three fused sweeps against six); K2 fused trilinear warp +
   derivatives at flows +-6, with and without the warped volume, and on a
   smooth flow within +-2 and that flow with one voxel displaced by +40;
   K5 fused tricubic warp + derivatives at flows +-2 and +-6, with and
   without the warped volume, and on the smooth and the outlier flows (for
   each warp case, how many slabs gathered from a staged box and how many
   from device memory); K3 3x3x3 median (no halo planes on one device),
   beside the floor of its own selection network at the probed min/max
   rate; K6 general-SPD
   SOR sweeps (the same forms) on gradient-constancy terms, with (alpha,
   alpha, alpha) and with an anisotropic multigrid triple, and its
   one-block form on a 16^3 system; K4 and K7, the colour-packed
   forms of K1 and K6, at (3, 256, 256, 128), with copied halo planes and
   with null ones (bitwise the same); and the bfloat16-terms
   instantiations of K1, K4, K6 and K7 on the same terms stored in
   bfloat16. Beside each time stands the kernel's bound: the least time
   the card could take, the larger of its bytes (inputs read once, outputs
   written once) over the data sheet's memory rate and the operations the
   function needs over the card's float32 rate (``bound_ms``), and the
   same at the probed bandwidth (``bound_probed_ms``; a ``[roofline]``
   line names a kernel that moves its bytes faster than the probed copy).
   For a flat single-colour launch also the bytes
   a half-sweep needs (the inactive colour's c, g or ainv and psi_d left
   out). The fused sweep and two single-colour launches are timed in turns.
   Also times pack_color and unpack_colors, the overhead of the packed layout
   per inner iteration.
   ``[terms]``: K8, the rank-1 nonlinearity update, bitwise against
   ``solver.rank1_terms`` (du zero and random) on every level shape of
   ``ladder512`` at 512^3 and of ``accurate`` at 256^3 and on shapes
   smaller than its 32 x 16 tile and 32-plane chunk, each timed beside
   its bound (60 B/voxel) and the plain version; then a ``ladder512``
   pair at 512^3 in core must launch it exactly 54 times (6 levels x 3
   warps x 3 inner iterations), its warm wall printed. ``[terms_gc]``:
   K9, the same of the general system (gamma > 0), bitwise against
   ``solver.general_terms`` on every level shape of ``ladder512`` with
   gamma 1 at 512^3 and on the small shapes, timed beside its bound (128
   B/voxel), and 54 launches in such a pair at 512^3. ``[mg]``: K10 and
   K11, the multigrid V-cycle's grid transfers, bitwise
   ``mgsolver.restrict_residual_plain`` and ``prolong_add_plain`` on every
   grid of a 256^3 hierarchy (rank-1 and general data blocks, rhs in
   float32 and bfloat16), each timed beside its bound (52 B a fine and 12 a
   coarse voxel; 24 and 12) and the plain version; then a 128^3
   ``accurate`` pair bitwise the pair with the transfers on their plain
   route, with as many V-cycles, its launches and warm walls printed.
4. Drives ``tpuflow3d_torch.compute_flow`` with ``PRESETS["ladder256"]`` on
   a 256^3 blob translation, once through the kernels (backend "auto") and
   once plain, each replayed from the CUDA graphs of ``graphs.py`` (the
   first call of each captures them, with no graphs held before it); beside
   the kernel run the eager driver ``pipeline.compute_flow_impl`` on the
   same inputs, whose flow must be bitwise the graphed one, with the same
   launches of every kernel; checks that the path's kernels (K1, K2, K3)
   and no other were launched (K1 exactly 900 times: one fused launch per
   sweep), that the two flows agree, and the EPE of each; its voxels/s
   (256^3 over a warm graphed call's wall time) and their share of
   ``end_to_end_roofline`` at the data sheet's and at the probed rate
   (``[roofline]``; phases 5-9 likewise, where multigrid has none the line
   says so, and phase 10 for its medians); then the torch.profiler split
   of a warm graphed kernel run: device busy and idle, the device
   activities and the device time by kernel.
5. The same for ``PRESETS["accurate"]`` (multigrid, tricubic, early stop;
   K5, K6 and K3) on the same pair, with EPE < 1e-3 on both runs, and the
   profiler split.
6. The same for ``PRESETS["ladder256"]`` with gamma = 1 (gradient
   constancy on SOR: K2 emitting the warped volume, K9 45 times, K6 729
   times (one launch per sweep, one per inner iteration on the 16^3
   level), K3).
7. The same for ``PRESETS["ladder256"]`` with ``sweep_layout="packed"``
   (the reference's default layout: K4 in place of K1, 1800 launches).
8. The same with gamma = 1 as well (K7 in place of K6, 1800 launches; K9
   45).
9. The same for ``PRESETS["accurate-bf16"]`` (``accurate`` with c and g
   stored in bfloat16: K5, the bfloat16 K6, K3), EPE < 1e-3 on both runs.
10. Times the flat and the packed layout end to end in turns (flat, packed,
   packed, flat; three turns; each a warm graphed call after a first call
   that captured), with and without gamma, and prints the median of each.
11-14. The out-of-core mode, ``piecewise.compute_flow_piecewise`` with
   64-plane chunks, its slab phases replayed from CUDA graphs
   (``graphs.stream_runner``; each run's first call, no graphs held before
   it, captures them). Before each path runs, ``[window:<path>]`` holds the
   kernels in the forms that path gives them, on every level of its own
   pyramid: K2/K5 on its warp slab, K1/K6 one colour on its trapezoid or
   fused slab (its omega, its system: the terms made by its own phases), K3
   on its median slab (the fused pass's clamped-global gather), each at its
   first, an interior and its last z0, K2/K5 and K1/K6 with the origin an
   int and in device memory (the graphed form), bitwise against the plain
   version, and timed beside the bound on the finest level; the run then
   records every form it launches and fails if one was not held so.
   ``ladder256`` (flow clamp 4) through the kernels against plain (exactly
   K1, K2, K3; K1 5040 times), with the profiler split, then with a
   checkpoint directory and resumed from it (``[stream:ladder256]``); one
   inner iteration, the fused pass against the phases, their gap at 64^3,
   128^3 and 256^3, and a fault planted in the fused pass that the gate
   must reject (``[stream:fused]``); ``ladder512`` at 512^3, the full
   width, the pair made on the card, against in-core, with the phase times,
   both device peaks and the host's memory (``[stream:ladder512]``, graphed
   only); ``accurate`` at 256^3 against in-core (``[stream:accurate]``).
   ``ladder256`` and the fused pass are each held bitwise to the eager
   streamed run (``eager=True``: the phases called directly, the origins
   Python ints), with equal launches; ``accurate`` in phase 18. The
   streamed-vs-in-core gate is the JAX package's (max |diff| < 5e-2, mean
   < 1e-2, |dEPE| < 0.02).
15. The command line, ``tpuflow3d_torch.cli``, at 256^3 (``[15:cli]``):
   frames i0, i1, i0 written as uint16 raws with sidecars (the native IO
   library required); the series with tracking, derived fields, VTK,
   statistics, fit and timings in this process (exactly K1 1800, K2 30,
   K3 30; pair 0 bitwise ``compute_flow`` on the widened frames; EPE; the
   tracks back at their seeds; the VTK flow equal to the raws); the pair
   through ``python -m tpuflow3d_torch.cli`` as a process (bitwise pair
   0); auto mode under a 1 GiB budget (``TPUFLOW_DEVICE_BYTES``, and the
   caching allocator capped at it) for ``ladder256`` and ``accurate``:
   first the window forms of ``pick_chunk_z``'s chunk (the streamed
   graphs' arena counted; the last chunk ragged) bitwise against plain,
   then the run, piecewise and graphed with that chunk, every form it
   launched held so, the device peak and reserved bytes within the
   budget, the streamed-vs-in-core gate; ``--apply-flow`` bitwise
   ``warp_volume`` and no kernel launched; ``--check-consistency``
   (exactly K1 1800, K2 30, K3 30).
16. The Z-sharded paths (``[16:shard]``): two ranks spawned on cuda:0,
   joined through gloo by ``distributed.initialize`` (the halos pass
   through host memory), run ``ladder256``, ``accurate``, gamma 1,
   ``packed`` and ``packed_gamma`` with ``sharding.prepare_params(., 2)``
   (flow clamp 4 where the preset has none). Before each path every rank
   holds each kernel form the path launches, on its slab of every level
   of its sharded pyramid, bitwise against the plain version under the
   same context: K2/K5 in halo form (on the finest level timed: the
   kernel alone while the other rank waits, the wrapper with its
   exchanges and the plain version with both ranks running), K1 or K6 one
   colour, K6 on every multigrid level, K4 or K7, K3, each with its
   neighbour's planes; then it runs ``compute_flow_sharded`` (SPMD) with
   every launched form recorded, failing on one not held, and reports its
   launches (exactly 1800 K1, K6, K4 or K7 on the SOR paths), wall time,
   device peak beside ``memory.sharded_peak_bytes`` and the halo
   exchanges' count, bytes and seconds. The gathered flow must be within
   the JAX package's sharded gate (atol 2e-4, rtol 1e-3) of the one-device
   flow of the same params, and within the EPE limits.
   ``compute_flow_sharded`` called from this process (spawning the ranks
   itself) must give the SPMD flow's bits. Then two ``python -m
   tpuflow3d_torch.cli --distributed`` processes on the card (float32
   raws, host-local slab IO, ``ladder256``): bitwise the sharded flow; the
   same with a checkpoint directory and rank 1 killed at the first level
   checkpoint: the survivor must exit non-zero within 120 s, and a
   relaunch resumes to the same bits.

17. The compiled dispatch (``[17:graphs]``), for ``ladder256`` and
   ``accurate`` at 256^3: the first graphed call's wall and capture
   seconds; warm graphed calls against eager ``compute_flow_impl`` calls in
   turns (graphed, eager, eager, graphed); the busy share and the
   device activities of one graphed and one eager call under the profiler;
   the entry's static and pool bytes; ``graphs.clear()`` must bring the
   allocated bytes back within 64 MiB of their level before the first call.

18. The streamed mode's graphs (``[18:stream-graphs]``), for
   ``stream:ladder256`` and ``stream:fused`` at 256^3: the first graphed
   call (captures at most one graph per (pass, level): ``graph_bound``),
   then warm graphed calls against eager ones in turns, medians of 3, every
   flow bitwise the first with equal launches, none captured anew;
   ``stream:accurate`` phase 14's graphed call (its host split taken there)
   and one eager (its witness). Each call's wall and its host split:
   seconds in ``_Stager.put`` (gather and enqueue), the phase calls
   (replays, or the eager launches), ``get``, ``wait`` and ``store`` (timed
   by wrapping them here), the entry's captures, replays, static and pool
   bytes.

Every in-core run through the kernels (phases 4-10, 12-15; graphed, its
first call, which captures, and in phases 4-9 the eager witness too)
prints its device peak (``torch.cuda.max_memory_allocated`` beyond what
was allocated before it) beside ``utils.memory.incore_peak_bytes``, and
every streamed run its peak and what its graphs hold beside
``utils.memory.streamed_peak_bytes`` for its chunk (``[mem]``); each fails
if the model is below the peak or the graphs' bytes.

Every failure raises, so the exit code is non-zero. The last two lines are
a JSON summary of the kernels (K2 and K5 in halo form as entries of their
own, with their launches on the sharded paths) and {"ok": true,
"device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPE = (256, 256, 256)
SHIFT = (1.5, -1.0, 0.75)
FLOW_ATOL, FLOW_RTOL = 2e-4, 1e-3
TOLS = {"sor_halfsweep": (0.0, 0.0), "warp_grad": (1e-5, 1e-5),
        "median3": (0.0, 0.0), "warp_grad_tricubic": (1e-5, 1e-5),
        "sor_gc": (0.0, 0.0), "sor_packed": (5e-5, 1e-5),
        "sor_gc_packed": (5e-5, 1e-5), "terms": (0.0, 0.0),
        "terms_gc": (0.0, 0.0), "mg_restrict": (0.0, 0.0),
        "mg_prolong": (0.0, 0.0)}
# kernel -> (the source that holds its device code, the TPU kernel it
# replaces, the C entry's source where another file holds the body).
SOURCES = {
    "sor_halfsweep": ("src/tpuflow3d_torch/csrc/sor_sweep.cuh",
                      "src/tpuflow3d/pallas/sor.py:200",
                      "src/tpuflow3d_torch/csrc/sor.cu"),
    "warp_grad": ("src/tpuflow3d_torch/csrc/warp_grad.cu",
                  "src/tpuflow3d/pallas/warp_grad.py:292"),
    "median3": ("src/tpuflow3d_torch/csrc/median3.cu",
                "src/tpuflow3d/pallas/median3.py:133"),
    "warp_grad_tricubic": ("src/tpuflow3d_torch/csrc/warp_grad.cu",
                           "src/tpuflow3d/pallas/warp_grad.py:292"),
    "sor_gc": ("src/tpuflow3d_torch/csrc/sor_sweep.cuh",
               "src/tpuflow3d/pallas/sor_gc.py:95",
               "src/tpuflow3d_torch/csrc/sor_gc.cu"),
    "sor_packed": ("src/tpuflow3d_torch/csrc/sor_packed.cu",
                   "src/tpuflow3d/pallas/sor_packed.py:164"),
    "sor_gc_packed": ("src/tpuflow3d_torch/csrc/sor_gc_packed.cu",
                      "src/tpuflow3d/pallas/sor_gc_packed.py:102"),
    "terms": ("src/tpuflow3d_torch/csrc/terms.cu",
              "src/tpuflow3d/solver.py:compute_terms (XLA, no Pallas kernel)"),
    "terms_gc": ("src/tpuflow3d_torch/csrc/terms.cu",
                 "src/tpuflow3d/solver.py:compute_terms (XLA, no Pallas "
                 "kernel)"),
    "mg_restrict": ("src/tpuflow3d_torch/csrc/mg_transfer.cu",
                    "src/tpuflow3d/mgsolver.py:_vcycle's mg_residual and "
                    "resize3 (XLA, no Pallas kernel)"),
    "mg_prolong": ("src/tpuflow3d_torch/csrc/mg_transfer.cu",
                   "src/tpuflow3d/mgsolver.py:_vcycle's resize3 and add "
                   "(XLA, no Pallas kernel)"),
}
# kernel -> a pattern that its device functions' names match in a profiler
# trace. K1 and K6 share the templates of csrc/sor_sweep.cuh (colour_kernel,
# fused_kernel, resident_kernel<terms type, general system, ...>): the second
# template argument tells them apart.
KERNEL_SYMBOLS = {
    "sor_halfsweep": r"tf3d_sweep::\w+_kernel<[\w ]+, *(false|\(bool\)0)",
    "warp_grad": r"::warp_grad_kernel<(false|\(bool\)0)>",
    "median3": r"::median3_kernel\(",
    "warp_grad_tricubic": r"::warp_grad_kernel<(true|\(bool\)1)>",
    "sor_gc": r"tf3d_sweep::\w+_kernel<[\w ]+, *(true|\(bool\)1)",
    "sor_packed": r"::sor_halfsweep_packed_kernel<",
    "sor_gc_packed": r"::sor_halfsweep_gc_packed_kernel<",
    "terms": r"tf3d_terms::rank1_kernel",
    "terms_gc": r"tf3d_terms::gc_kernel",
    "mg_restrict": r"tf3d_mg::restrict_kernel<",
    "mg_prolong": r"tf3d_mg::prolong_kernel"}
# path -> (preset, changes, the kernels it must launch, EPE limit). A kernel
# maps to the launch count the path must show exactly, or to None for any
# count above 0; 900 is 5 levels (all of even W) x 3 warps x 3 inner
# iterations x 20 sweeps, one fused red+black launch each, and 1800 the same
# x 2 colours. K6 runs the 20 sweeps of an inner iteration on the coarsest
# level (16^3 = 4096 voxels) in one launch of one block: 4 x 180 + 9 = 729.
# K8 makes each nonlinearity update of the rank-1 system on a whole volume:
# levels x warps x inner iterations, 45 for ladder256 and 120 for accurate;
# K9 each of the general system with gamma > 0 and SOR: 45. Multigrid
# restricts (K10) and prolongs (K11) once a grid of each V-cycle the early
# stop lets run, on a whole volume.
# The JAX package's TPU records:
# ladder256 0.0179 on its bench input; accurate 3.4e-4 and its accuracy
# gate 1e-3.
PATHS = {
    "ladder256": ("ladder256", {},
                  {"sor_halfsweep": 900, "warp_grad": None, "median3": None,
                   "terms": 45}, 0.03),
    "accurate": ("accurate", {},
                 {"warp_grad_tricubic": None, "sor_gc": None,
                  "median3": None, "terms": 120, "mg_restrict": None,
                  "mg_prolong": None}, 1e-3),
    "gamma": ("ladder256", {"gamma": 1.0},
              {"warp_grad": None, "sor_gc": 729, "median3": None,
               "terms_gc": 45}, 0.03),
    "packed": ("ladder256", {"sweep_layout": "packed"},
               {"sor_packed": 1800, "warp_grad": None, "median3": None,
                "terms": 45}, 0.03),
    "packed_gamma": ("ladder256", {"sweep_layout": "packed", "gamma": 1.0},
                     {"sor_gc_packed": 1800, "warp_grad": None,
                      "median3": None, "terms_gc": 45}, 0.03),
    "accurate-bf16": ("accurate-bf16", {},
                      {"warp_grad_tricubic": None, "sor_gc": None,
                       "median3": None, "terms": 120, "mg_restrict": None,
                       "mg_prolong": None}, 1e-3),
}
# Turns of (flat, packed, packed, flat) in the end-to-end layout comparison.
LAYOUT_TURNS = 3
# The streamed (out-of-core) paths, phases 11-14: compute_flow_piecewise with
# Z-chunks of STREAM_CHUNK planes. path -> (preset, changes, the kernels it
# must launch, EPE limit; the fused path is held to the in-core EPE
# instead), as PATHS. With 64-plane chunks a level of depth D
# takes ceil(D/64) + 1 trapezoid launches of 2 x 20 single-colour K1
# half-sweeps per inner iteration: 256^3 levels 5+3+2+2+2 = 14 launches,
# x 40 x 3 warps x 3 inner iterations = 5040 K1 (fused, one inner
# iteration: 14 x 40 x 3 = 1680); 512^3 9+5+3+2+2+2 = 23: 8280.
STREAM_CHUNK = 64
STREAM_PATHS = {
    "stream:ladder256": ("ladder256", {"flow_clamp": 4.0},
                         {"sor_halfsweep": 5040, "warp_grad": None,
                          "median3": None}, 0.03),
    "stream:fused": ("ladder256", {"flow_clamp": 4.0, "inner_iterations": 1},
                     {"sor_halfsweep": 1680, "warp_grad": None,
                      "median3": None}, None),
    "stream:ladder512": ("ladder512", {"flow_clamp": 4.0},
                         {"sor_halfsweep": 8280, "warp_grad": None,
                          "median3": None}, 0.03),
    "stream:accurate": ("accurate", {},
                        {"warp_grad_tricubic": None, "sor_gc": None,
                         "median3": None, "mg_restrict": None,
                         "mg_prolong": None}, 1e-3),
}
# The JAX package's streamed-vs-in-core gate (tests/test_piecewise.py:61-64):
# max |diff| and mean |diff| of the flows, |difference of the EPEs|.
STREAM_GATE = (5e-2, 1e-2, 0.02)
# The fused pass against the phases, rtol 0 as the JAX package's gate
# (tests/test_piecewise.py:140). Its atol of 1e-6 holds only at that test's
# sizes: a slab-local warp coordinate z + s_z rounds with the slab's origin,
# which the two passes place apart, and the gap grows with the volume in
# both packages (on the CPU, tests/test_torch_piecewise.py's fused_gaps:
# 2.5e-6 in the port and 1.7e-6 in the JAX package at 32^3). The limit sits
# at about twice the 256^3 reading on the card (8.9e-6); a fault in the
# fused pass (its carry band read one plane off) moves the flow by ~0.6,
# which phase 12 plants and requires the gate to reject.
FUSED_ATOL = 2e-5


START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def elapsed() -> str:
    return f"(at {time.perf_counter() - START:.0f} s)"


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per run on
    the current device."""
    from tpuflow3d_torch.utils.roofline import median_ms
    return median_ms(fn, torch.cuda.current_device(), reps, warmup)


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors among the arguments (None and scalars skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


# What the [roofline] phase measured on this card: "rates", the rates
# utils/roofline.OPS are held to (the min/max rate probed), "sheet_bw", the
# data sheet's memory rate, and "probed_bw", the copy kernel's sustained
# bytes/s. Empty in the ranks of phase 16, which bound only the warps, at
# the data sheet's rates.
ROOFLINE: dict = {}


def roofline_phase(torch, dev, card: str, summary: dict) -> None:
    """[roofline]: the card's own rates beside its data sheet's
    (utils/roofline.py): the copy kernel at the default footprint and at
    64 MiB a side (the L2 is 50 MB), with t16/t1 and Tensor.copy_'s rate,
    and the fminf/fmaxf rate K3's comparisons are held to. Raises where
    the default footprint's probe fails ``check_probe``."""
    from tpuflow3d_torch.utils import roofline
    rates = roofline.peak_rates(dev)
    sheet = roofline.device_hbm_bw(dev)
    log(f"[roofline] {card}: data sheet {sheet:.4g} B/s, float32 "
        f"{rates['fp32']:.4g} FLOP/s")
    probes = {}
    for nbytes in (roofline.PROBE_BYTES, 64 << 20):
        pr = roofline.probe_timing_model(nbytes, dev)
        fault = roofline.check_probe(pr)
        log(f"[roofline] copy kernel, {nbytes >> 20} MiB a side: "
            f"{pr.bytes_per_s:.6g} B/s ({100 * pr.bytes_per_s / sheet:.1f}% "
            f"of the data sheet), t16/t1 {pr.ratio:.3f} (one copy "
            f"{pr.t1_ms:.4f} ms, 16 {pr.t16_ms:.4f} ms); Tensor.copy_ "
            f"{pr.copy_bytes_per_s:.6g} B/s; "
            + (f"not a bandwidth: {fault}" if fault else "checks pass"))
        probes[nbytes] = {**pr._asdict(), "fault": fault}
    probed = roofline.measure_hbm_bw(roofline.PROBE_BYTES, dev)
    mm = roofline.minmax_rate(dev)
    log(f"[roofline] fminf/fmaxf: {mm / 1e12:.2f} T/s on this card (one "
        f"per lane and clock would be {rates['minmax'] / 1e12:.2f})")
    rates["minmax"] = mm
    ROOFLINE.update(rates=rates, sheet_bw=sheet, probed_bw=probed)
    summary["roofline"] = {"card": card, "sheet_bytes_per_s": sheet,
                           "probed_bytes_per_s": probed, "rates": rates,
                           "probes_by_bytes": probes, "end_to_end": {}}


def e2e_share(label: str, p, seconds: float, summary: dict) -> None:
    """[roofline] line of an in-core one-device run at SHAPE: its voxels/s
    and their share of utils/roofline.end_to_end_roofline at the data
    sheet's and at the probed rate (or why the run has no such bound)."""
    from tpuflow3d_torch.utils import roofline
    shapes = p.level_shapes(SHAPE)
    vps = SHAPE[0] * SHAPE[1] * SHAPE[2] / seconds
    try:
        sheet = roofline.end_to_end_roofline(shapes, p,
                                             bw=ROOFLINE["sheet_bw"])
        probed = roofline.end_to_end_roofline(shapes, p,
                                              bw=ROOFLINE["probed_bw"])
    except ValueError as e:
        log(f"[roofline] {label}: no end-to-end line ({e})")
        return
    log(f"[roofline] {label}: {vps:.6g} voxels/s in {seconds:.4f} s; "
        f"end-to-end roofline {sheet:.6g} voxels/s at the data sheet's rate "
        f"({100 * vps / sheet:.2f}%), {probed:.6g} at the probed rate "
        f"({100 * vps / probed:.2f}%), "
        f"{roofline.sweep_byte_model(p).per_sweep:g} B a sweep")
    summary["roofline"]["end_to_end"][label] = {
        "seconds": seconds, "voxels_per_s": vps, "roofline_sheet": sheet,
        "roofline_probed": probed, "share_sheet": vps / sheet,
        "share_probed": vps / probed}


def compare(torch, name, got, ref) -> float:
    """Max |got - ref| over the tensors of a result; raise past the kernel's
    tolerance (|d| <= atol + rtol*|ref|; K3 must be bitwise equal)."""
    atol, rtol = TOLS[name]
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} outputs, expected "
                             f"{len(ref)}")
    worst = 0.0
    for a, b in zip(got, ref):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}")
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        bad = int((diff > atol + rtol * b.abs()).sum())
        if bad or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {bad} elements past atol {atol} "
                                 f"rtol {rtol} (max |diff| {worst:.3e}), or "
                                 f"non-finite output")
    return worst


def profile_split(torch, run) -> dict:
    """Run ``run`` once under torch.profiler (device activity only) and
    print the device's busy and idle share of the span, the device time
    of the kernels that took the most, and that of each ported kernel;
    return the wall, busy and span times and the count of activities."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    log(f"[profile] {wall:.3f} s wall under the profiler; device busy "
        f"{busy / 1e3:.1f} ms of a {span / 1e3:.1f} ms span: "
        f"{100 * busy / span:.1f}% busy, {100 - 100 * busy / span:.1f}% "
        f"idle; {len(spans)} device activities")
    by_name = {}
    for s, e, name in ((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA):
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e - s, n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {t / 1e3:9.2f} ms {100 * t / busy:5.1f}% "
            f"{n:7d}x  {name[:110]}")
    for kernel, symbol in KERNEL_SYMBOLS.items():
        hits = [v for name, v in by_name.items() if re.search(symbol, name)]
        t, n = sum(v[0] for v in hits), sum(v[1] for v in hits)
        log(f"[profile]   {kernel}: {t / 1e3:.2f} ms, {100 * t / busy:.1f}% "
            f"of busy, {n} launches")
    # Copies on the device (memcpy, and PyTorch's copy kernels, which
    # contiguous() and the halo-plane fetches launch).
    hits = [v for name, v in by_name.items() if re.search(r"(?i)copy", name)]
    log(f"[profile]   copies: {sum(v[1] for v in hits)} device activities, "
        f"{sum(v[0] for v in hits) / 1e3:.2f} ms")
    return {"wall_s": wall, "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "busy_share": busy / span, "activities": len(spans)}


# Phase 17: the graphed compute_flow of these paths against the eager
# compute_flow_impl, in turns of (graphed, eager, eager, graphed).
GRAPH_PATHS = ("ladder256", "accurate")
GRAPH_TURNS = 1
# What graphs.clear() may leave allocated beyond the level before the call.
GRAPH_CLEAR_SLACK = 64 << 20


def graphs_phase(torch, i0, i1, summary) -> None:
    """Phase 17 (``[17:graphs]``): for each of GRAPH_PATHS at 256^3 the
    first graphed call's wall and capture seconds, warm graphed calls
    against eager ones in turns (host clock to a synchronized device, numpy
    volumes in), the busy share and device activities of one graphed and
    one eager call under the profiler, the entry's static and pool bytes,
    and the allocated bytes after ``graphs.clear()`` beside those before
    the first call (raises past GRAPH_CLEAR_SLACK)."""
    from tpuflow3d_torch import PRESETS, compute_flow, graphs
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.pipeline import compute_flow_impl

    dev = torch.device("cuda", 0)
    res = summary["graphs"] = {"card": gpu_name_and_power_limit()}
    for path in GRAPH_PATHS:
        preset, changes, _, _ = PATHS[path]
        pp = PRESETS[preset].replace(**changes)

        def graphed():
            compute_flow(i0, i1, pp, device=dev)
            torch.cuda.synchronize(dev)

        def eager():
            compute_flow_impl(torch.as_tensor(i0, device=dev),
                              torch.as_tensor(i1, device=dev), pp, HaloCtx())
            torch.cuda.synchronize(dev)

        graphs.clear()
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        graphed()
        first = time.perf_counter() - t0
        (cold,) = graphs.entries().values()
        times = {"graphed": [], "eager": []}
        for _ in range(GRAPH_TURNS):
            for key, fn in (("graphed", graphed), ("eager", eager),
                            ("eager", eager), ("graphed", graphed)):
                t0 = time.perf_counter()
                fn()
                times[key].append(time.perf_counter() - t0)
        prof = {"graphed": profile_split(torch, graphed),
                "eager": profile_split(torch, eager)}
        (info,) = graphs.entries().values()
        graphs.clear()
        left = torch.cuda.memory_allocated(dev) - before
        row = res[path] = {
            "first_call_s": first, "capture_s": cold["capture_seconds"],
            "graphs": cold["graphs"], "captures": info["captures"],
            "replays": info["replays"],
            "warmup_launches": cold["warmup_launches"],
            "static_bytes": info["static_bytes"],
            "pool_bytes": info["pool_bytes"], "walls_s": times,
            "graphed_median_s": statistics.median(times["graphed"]),
            "eager_median_s": statistics.median(times["eager"]),
            "profile": prof, "allocated_after_clear_bytes": left}
        log(f"[17:graphs] {elapsed()} {path}: first call {first:.3f} s "
            f"({row['graphs']} graphs, captured in {row['capture_s']:.3f} "
            f"s); warm graphed median {row['graphed_median_s']:.4f} s "
            f"({', '.join(f'{t:.4f}' for t in times['graphed'])}), eager "
            f"median {row['eager_median_s']:.4f} s ("
            f"{', '.join(f'{t:.4f}' for t in times['eager'])}), in turns; "
            f"busy {100 * prof['graphed']['busy_share']:.1f}% graphed over "
            f"{prof['graphed']['activities']} device activities, "
            f"{100 * prof['eager']['busy_share']:.1f}% eager over "
            f"{prof['eager']['activities']}; static tensors "
            f"{row['static_bytes'] / 2 ** 30:.3f} GiB, pool "
            f"{row['pool_bytes'] / 2 ** 30:.3f} GiB; after graphs.clear() "
            f"{left / 2 ** 20:.1f} MiB above the level before the call")
        if left > GRAPH_CLEAR_SLACK:
            raise AssertionError(f"{path}: graphs.clear() left {left} bytes "
                                 f"allocated beyond the level before the "
                                 f"call")


# Phase 18: the streamed mode graphed against eager. These paths in turns of
# (graphed, eager, eager, graphed, graphed, eager) after a first graphed
# call; stream:accurate (~50-60 s a call) phase 14's graphed call and one
# eager.
STREAM_GRAPH_PATHS = ("stream:ladder256", "stream:fused")
STREAM_GRAPH_TURNS = ("graphed", "eager", "eager", "graphed", "graphed",
                      "eager")


@contextlib.contextmanager
def host_split(into: dict):
    """For the length of the block, the host seconds of a streamed run's
    staging and phase calls, each without the calls inside it, added into
    ``into``: ``put`` (the slab gathered into page-locked memory and its
    copy enqueued), ``phase`` (the origins filled and the graph replayed,
    or the phase's launches; its first call's warm-up and capture too),
    ``get`` (a result's copy back enqueued), ``wait`` (for a copy back)
    and ``store`` (the result written into the host array)."""
    from tpuflow3d_torch import graphs
    from tpuflow3d_torch import piecewise as pw

    targets = [(pw._Stager, "put", "put"), (pw._Stager, "get", "get"),
               (pw._Stager, "wait", "wait"), (pw._Stager, "store", "store"),
               (graphs._StreamPhase, "__call__", "phase"),
               (graphs._DirectPhase, "__call__", "phase")]
    stack = []

    def wrap(fn, name):
        def timed(*a, **k):
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                into[name] = into.get(name, 0.0) + dt - inner
                if stack:
                    stack[-1] += dt
        return timed

    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in targets]
    for (cls, attr, name), (_, _, raw) in zip(targets, saved):
        if isinstance(raw, staticmethod):
            setattr(cls, attr, staticmethod(wrap(raw.__func__, name)))
        else:
            setattr(cls, attr, wrap(raw, name))
    try:
        yield into
    finally:
        for cls, attr, raw in saved:
            setattr(cls, attr, raw)


def graph_bound(p, shape, chunk: int) -> int:
    """The streamed passes of one ``compute_flow_piecewise`` call, each
    (pass, level) once: every pass of ``level_plan`` on every level, the
    presmoothing, the pyramid's downsampling and the flow's upsampling
    between levels and, on a multigrid level, the restriction of psi_s,
    d6 and the residual, the prolongation and the coarse V-cycle. A
    streamed entry captures at most that many graphs (the JAX package's
    compile count)."""
    from tpuflow3d_torch.mgsolver import mg_shapes
    from tpuflow3d_torch.piecewise import DEFAULT_FLOW_CLAMP, level_plan
    if p.flow_clamp <= 0:
        p = p.replace(flow_clamp=DEFAULT_FLOW_CLAMP)
    shapes = p.level_shapes(tuple(shape))
    n = (1 if p.presmooth_sigma > 0 else 0) + 2 * (len(shapes) - 1)
    for shp in shapes:
        n += len(level_plan(p, shp, chunk))
        if p.solver == "multigrid" and len(mg_shapes(tuple(shp), 1)) > 1:
            n += 5
    return n


def stream_graphs_phase(torch, i0, i1, summary) -> None:
    """Phase 18 (``[18:stream-graphs]``): for STREAM_GRAPH_PATHS and
    stream:accurate at 256^3, chunks of STREAM_CHUNK: the first graphed
    call (no graphs held before it) with its capture seconds, captures
    (at most ``graph_bound``), replays, static and pool bytes; then warm
    graphed calls against eager ones in turns (STREAM_GRAPH_TURNS), every
    flow bitwise the first with the same launches, no graph captured
    anew; each call's wall on the host clock to a synchronized device and
    its host split (``host_split``), the medians printed. stream:accurate
    (~50-60 s a call) takes phase 14's run (``summary["stream_first"]``)
    as its first graphed call, and runs one eager call, its witness."""
    from tpuflow3d_torch import PRESETS, graphs, kernels
    from tpuflow3d_torch.piecewise import compute_flow_piecewise

    dev = torch.device("cuda", 0)
    tag = "[18:stream-graphs]"
    res = summary["stream_graphs"] = {"card": gpu_name_and_power_limit()}

    def run(pp, eager):
        split = {}
        kernels.reset_launches()
        with host_split(split):
            t0 = time.perf_counter()
            f = compute_flow_piecewise(i0, i1, pp, chunk_z=STREAM_CHUNK,
                                       device=dev, eager=eager)
            torch.cuda.synchronize(dev)
            split["wall"] = time.perf_counter() - t0
        split["other"] = split["wall"] - sum(v for k, v in split.items()
                                             if k != "wall")
        return f, split, dict(kernels.LAUNCHES)

    def fmt(split):
        return ", ".join(f"{k} {split.get(k, 0.0):.3f}" for k in (
            "wall", "put", "phase", "get", "wait", "store", "other"))

    earlier = summary.pop("stream_first")
    for path in (*STREAM_GRAPH_PATHS, "stream:accurate"):
        preset, changes, _, _ = STREAM_PATHS[path]
        pp = PRESETS[preset].replace(**changes)
        if path in STREAM_GRAPH_PATHS:
            graphs.clear()
            f0, first, n0 = run(pp, False)
            (cold,) = graphs.entries().values()
            turns, runs = STREAM_GRAPH_TURNS, {"graphed": [], "eager": []}
        else:
            f0, first, n0, cold = (earlier[path][k] for k in (
                "flow", "split", "launches", "entry"))
            first["other"] = first["wall"] - sum(
                v for k, v in first.items() if k != "wall")
            turns, runs = ("eager",), {"graphed": [first], "eager": []}
        bound = graph_bound(pp, i0.shape, STREAM_CHUNK)
        if not cold["captures"] == cold["graphs"] <= bound:
            raise AssertionError(f"{tag} {path}: {cold['captures']} captures "
                                 f"of {cold['graphs']} graphs, at most "
                                 f"{bound} (pass, level) pairs")
        for kind in turns:
            f, split, n = run(pp, kind == "eager")
            if not np.array_equal(f, f0) or n != n0:
                raise AssertionError(f"{tag} {path}: a {kind} call's flow or "
                                     f"launches ({n}) differ from the first "
                                     f"graphed one's ({n0})")
            runs[kind].append(split)
        # (stream:accurate's entry went with the phases after phase 14.)
        info = next(iter(graphs.entries().values()), cold)
        if info["captures"] != cold["captures"]:
            raise AssertionError(f"{tag} {path}: warm calls captured "
                                 f"{info['captures'] - cold['captures']} "
                                 f"graphs")
        med = {kind: {k: statistics.median(s.get(k, 0.0) for s in ss)
                      for k in ss[0]} for kind, ss in runs.items()}
        res[path] = {
            "launches": n0, "first_call": first,
            "capture_s": cold["capture_seconds"],
            "graphs": cold["graphs"], "captures": info["captures"],
            "bound": bound, "replays": info["replays"],
            "warmup_launches": cold["warmup_launches"],
            "static_bytes": info["static_bytes"],
            "pool_bytes": info["pool_bytes"], "runs": runs,
            "median": med}
        log(f"{tag} {elapsed()} {path}: launches {n0}, equal in every "
            f"call, every flow bitwise the first; first graphed call "
            f"{fmt(first)} s "
            f"({cold['captures']} captures of at most {bound} (pass, level) "
            f"pairs, captured in {cold['capture_seconds']:.3f} s); static "
            f"{info['static_bytes'] / 2 ** 30:.3f} GiB, pool "
            f"{info['pool_bytes'] / 2 ** 30:.3f} GiB; {info['replays']} "
            f"replays in all, none captured after the first call")
        for kind in ("graphed", "eager"):
            log(f"{tag} {path}: {kind} (median of {len(runs[kind])}: "
                f"{', '.join(f'{s['wall']:.3f}' for s in runs[kind])} s) "
                f"{fmt(med[kind])} s")
        graphs.clear()
        torch.cuda.empty_cache()


# [terms]: the shapes K8 is held at beside the level shapes of ladder512 at
# 512^3 and accurate at 256^3: a voxel, depths below the 32-plane chunk,
# heights and widths below and across the 16 x 32 tile, odd sizes.
TERMS_SHAPES = [(1, 1, 1), (2, 3, 5), (17, 9, 33), (5, 37, 70),
                (40, 19, 33), (32, 32, 32)]


def bits(torch, x):
    """x's float32 bit patterns (torch.equal takes -0 for +0)."""
    return x.contiguous().view(torch.int32)


def hold_terms_kernel(torch, dev, summary, tag: str, name: str, shapes,
                      make, kern, plain, outputs, bytes_per_voxel) -> None:
    """A nonlinearity-update kernel (``name``: "terms" K8, "terms_gc" K9)
    bitwise against its plain version at each of ``shapes`` (inputs
    ``make(shape, du_zero)``, du zero and random), each shape timed
    (CUDA-event medians of 10) beside its bound; the 256^3 numbers go into
    ``summary[name]``."""
    from tpuflow3d_torch import kernels
    from tpuflow3d_torch.utils import roofline
    rates, sheet_bw, probed_bw = (ROOFLINE[k] for k in ("rates", "sheet_bw",
                                                        "probed_bw"))
    entry = summary.setdefault(name, {"max_abs_err": 0.0})
    by_shape = entry.setdefault("by_shape", {})
    for shape in shapes:
        n_vox = shape[0] * shape[1] * shape[2]
        for du_zero in (True, False):
            args = make(shape, du_zero)
            before = kernels.LAUNCHES[name]
            got, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            if kernels.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{name} {shape}: "
                                     f"{kernels.LAUNCHES[name] - before}"
                                     f" launches, expected 1")
            for out, a, b in zip(outputs, got, ref):
                if not torch.equal(bits(torch, a), bits(torch, b)):
                    bad = int((bits(torch, a) != bits(torch, b)).sum())
                    raise AssertionError(
                        f"{name} {shape}: {out} differs from the plain "
                        f"version in {bad} values (max |diff| "
                        f"{float((a - b).abs().max()):.3e})")
            del got, ref
        nbytes = bytes_per_voxel * n_vox
        ms = cuda_ms(torch, lambda: kern(*args))
        plain_ms = cuda_ms(torch, lambda: plain(*args))
        b = roofline.bound(name, nbytes, n_vox, bw=sheet_bw, rates=rates)
        b_probed = roofline.bound(name, nbytes, n_vox, bw=probed_bw,
                                  rates=rates)["bound_ms"]
        log(f"[{tag}] {shape}: bitwise the plain version (du zero and "
            f"random); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({bytes_per_voxel} B/voxel: "
            f"{100 * b['bound_ms'] / ms:.1f}% of it); at the probed rate "
            f"{b_probed:.4f} ms")
        by_shape["x".join(map(str, shape))] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_probed_ms": b_probed}
        if shape == SHAPE:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b["bound_ms"]),
                             ("bound_by", b["bound_by"]),
                             ("bound_bytes_ms", b["bound_bytes_ms"]),
                             ("bound_operations_ms",
                              b["bound_operations_ms"]),
                             ("bound_probed_ms", b_probed),
                             ("probed_bytes_per_s", probed_bw)):
                entry[key] = val
        del args
    torch.cuda.empty_cache()


def count_pair_launches(torch, dev, summary, tag: str, name: str, p,
                        gen) -> None:
    """A pair of ``p`` at 512^3 in core must launch ``name`` once per
    nonlinearity update: levels x warps x inner iterations (54 at 512^3);
    the warm graphed call's wall is printed."""
    from tpuflow3d_torch import compute_flow, graphs, kernels
    shape = (512, 512, 512)
    base = torch.nn.functional.interpolate(
        torch.randn((1, 1, 64, 64, 64), generator=gen, device=dev),
        size=shape, mode="trilinear", align_corners=False)[0, 0]
    i0, i1 = base, torch.roll(base, shifts=1, dims=2)
    del base
    kernels.reset_launches()
    graphs.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    compute_flow(i0, i1, p, device=dev)
    n = kernels.LAUNCHES[name]
    expected = p.warps * p.inner_iterations * len(p.level_shapes(shape))
    t0 = time.perf_counter()
    compute_flow(i0, i1, p, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    log(f"[{tag}] a pair at 512^3 in core: {n} {name} launches (expected "
        f"{expected}), warm graphed call {wall:.3f} s "
        f"({shape[0] ** 3 / wall:.6g} voxels/s), "
        f"{torch.cuda.max_memory_reserved(dev) / 2 ** 30:.2f} GiB reserved "
        f"at the most")
    if n != expected:
        raise AssertionError(f"{tag}: {n} {name} launches, expected "
                             f"{expected}")
    summary[name]["launches_512"] = n
    summary[name]["pair_512_warm_s"] = wall
    del i0, i1
    graphs.clear()
    torch.cuda.empty_cache()


def terms_phase(torch, dev, summary) -> None:
    """[terms]: K8 bitwise against its plain version at every shape of
    TERMS_SHAPES and the two presets' levels, each timed (CUDA-event
    medians of 10) beside its bound; then its launches in a ladder512 pair
    at 512^3."""
    from tpuflow3d_torch import PRESETS
    from tpuflow3d_torch.kernels.terms import terms_rank1
    from tpuflow3d_torch.solver import rank1_terms
    from tpuflow3d_torch.utils import roofline
    p = PRESETS["ladder512"]
    shapes = list(dict.fromkeys(
        TERMS_SHAPES + p.level_shapes((512,) * 3)
        + PRESETS["accurate"].level_shapes(SHAPE)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def make(shape, du_zero):
        flow = rnd((3, *shape), 0.5)
        return (rnd((3, *shape), 0.1), rnd(shape, 0.05), flow,
                torch.zeros_like(flow) if du_zero else rnd((3, *shape), 0.05))

    hold_terms_kernel(torch, dev, summary, "terms", "terms", shapes, make,
                      lambda *a: terms_rank1(*a, p),
                      lambda *a: rank1_terms(*a, p), ("c", "psi_s", "psi_d"),
                      roofline.TERMS_BYTES_PER_VOXEL)
    count_pair_launches(torch, dev, summary, "terms", "terms", p, gen)


def terms_gc_phase(torch, dev, summary) -> None:
    """[terms_gc]: K9 bitwise against its plain version at every shape of
    TERMS_SHAPES and of the gamma configuration's levels at 512^3, each
    timed (CUDA-event medians of 10) beside its bound; then its launches in
    a gamma pair at 512^3."""
    from tpuflow3d_torch import PRESETS
    from tpuflow3d_torch.kernels.terms import terms_general
    from tpuflow3d_torch.solver import general_terms
    from tpuflow3d_torch.utils import roofline
    p = PRESETS["ladder512"].replace(gamma=1.0)
    # Not the volume of one voxel: there ATen's sum over three components
    # adds (x0 + x2) + x1, on any larger volume (x0 + x1) + x2, the
    # kernel's order.
    shapes = list(dict.fromkeys(
        [s for s in TERMS_SHAPES if s != (1, 1, 1)]
        + p.level_shapes((512,) * 3)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def make(shape, du_zero):
        flow = rnd((3, *shape), 0.5)
        return (rnd((3, *shape), 0.1), rnd(shape, 0.05), flow,
                torch.zeros_like(flow) if du_zero else rnd((3, *shape), 0.05),
                rnd((3, 3, *shape), 0.1), rnd((3, *shape), 0.05))

    hold_terms_kernel(torch, dev, summary, "terms_gc", "terms_gc", shapes,
                      make, lambda *a: terms_general(*a, p),
                      lambda *a: general_terms(*a, p), ("c", "psi_s", "ainv"),
                      roofline.TERMS_GC_BYTES_PER_VOXEL)
    count_pair_launches(torch, dev, summary, "terms_gc", "terms_gc", p, gen)


def mg_phase(torch, dev, summary) -> None:
    """[mg]: K10 and K11 bitwise their plain versions on every grid of the
    multigrid hierarchy of a 256^3 volume (rank-1 and general data blocks,
    rhs in float32 and bfloat16 on the finest grid), each timed
    (CUDA-event medians of 10) beside its bound and the plain version;
    then a 128^3 ``accurate`` pair, graphed, bitwise the pair with the
    transfers on their plain route, with as many V-cycles, and its
    launches."""
    from tpuflow3d_torch import PRESETS, compute_flow, graphs, kernels
    from tpuflow3d_torch import mgsolver, synthetic as syn
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.kernels import mg_transfer
    from tpuflow3d_torch.params import FlowParams
    from tpuflow3d_torch.solver import SolveTerms
    from tpuflow3d_torch.utils import roofline
    rates, sheet_bw, probed_bw = (ROOFLINE[k] for k in ("rates", "sheet_bw",
                                                        "probed_bw"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    def hierarchy(general):
        psi_d = 0.5 + rnd(*SHAPE).abs()
        g = rnd(3, *SHAPE, scale=0.3)
        d6 = None
        if general:
            h = rnd(3, 3, *SHAPE, scale=0.2)
            d6 = torch.stack([psi_d * g[i] * g[j] + (h[:, i] * h[:, j]).sum(0)
                              for i, j in ((0, 0), (0, 1), (0, 2), (1, 1),
                                           (1, 2), (2, 2))])
        t = SolveTerms(c=None, g=g, w=None, sw_inv=None, smt=None,
                       psi_s=0.2 + rnd(*SHAPE).abs(), psi_d=psi_d, d6=d6)
        return mgsolver.build_mg_levels(
            t, FlowParams(solver="multigrid", alpha=0.05), HaloCtx())

    def held(name, got, want, label):
        if not torch.equal(bits(torch, got), bits(torch, want)):
            bad = int((bits(torch, got) != bits(torch, want)).sum())
            raise AssertionError(f"{name} {label}: {bad} values differ from "
                                 f"the plain version (max |diff| "
                                 f"{float((got - want).abs().max()):.3e})")

    for name in ("mg_restrict", "mg_prolong"):
        summary[name] = {"max_abs_err": 0.0, "by_grid": {}}
    for general in (False, True):
        levels = hierarchy(general)
        for li, lvl in enumerate(levels[:-1]):
            fine, coarse = lvl.shape_global, levels[li + 1].shape_global
            label = f"{fine} -> {coarse}"
            du = rnd(3, *fine, scale=0.1)
            ec = rnd(3, *coarse, scale=0.1)
            rhss = [rnd(3, *fine)]
            if li == 0:
                rhss.append(rnd(3, *fine).to(torch.bfloat16))
            for rhs in rhss:
                held("mg_restrict",
                     mg_transfer.restrict_residual(du, lvl, rhs, coarse),
                     mgsolver.restrict_residual_plain(du, lvl, rhs, coarse),
                     f"{label} rhs {rhs.dtype}")
            want = mgsolver.prolong_add_plain(du, ec, fine)
            held("mg_prolong", mg_transfer.prolong_add(du, ec, lvl), want,
                 label)
            mine = du.clone()
            held("mg_prolong", mg_transfer.prolong_add(mine, ec, lvl,
                                                       in_place=True),
                 want, f"{label} in place")
            if general:
                continue
            rhs = rhss[0]
            for name, kern, plain in (
                    ("mg_restrict",
                     lambda: mg_transfer.restrict_residual(du, lvl, rhs,
                                                           coarse),
                     lambda: mgsolver.restrict_residual_plain(du, lvl, rhs,
                                                              coarse)),
                    ("mg_prolong",
                     lambda: mg_transfer.prolong_add(mine, ec, lvl,
                                                     in_place=True),
                     lambda: mgsolver.prolong_add_plain(du, ec, fine))):
                n_vox = fine[0] * fine[1] * fine[2]
                nbytes = roofline.mg_transfer_bytes(name, fine, coarse)
                ms = cuda_ms(torch, kern)
                plain_ms = cuda_ms(torch, plain)
                b = roofline.bound(name, nbytes, n_vox, bw=sheet_bw,
                                   rates=rates)
                b_probed = roofline.bound(name, nbytes, n_vox, bw=probed_bw,
                                          rates=rates)["bound_ms"]
                log(f"[mg] {name} {label}: bitwise the plain version; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
                    f"({100 * b['bound_ms'] / ms:.1f}% of it); at the probed "
                    f"rate {b_probed:.4f} ms")
                entry = summary[name]
                entry["by_grid"]["x".join(map(str, fine))] = {
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b["bound_ms"], "bound_probed_ms": b_probed}
                if fine == SHAPE:
                    entry.update(ms=ms, plain_ms=plain_ms,
                                 bound_ms=b["bound_ms"],
                                 bound_by=b["bound_by"],
                                 bound_bytes_ms=b["bound_bytes_ms"],
                                 bound_operations_ms=b[
                                     "bound_operations_ms"],
                                 bound_probed_ms=b_probed,
                                 probed_bytes_per_s=probed_bw)
            del du, ec, rhss, mine, want
        del levels
    torch.cuda.empty_cache()

    # A 128^3 accurate pair: the kernel route against the plain one.
    p = PRESETS["accurate"]
    i0, i1, _ = syn.make_pair((128,) * 3, syn.translation(SHIFT), seed=3)

    def pair():
        graphs.clear()
        kernels.reset_launches()
        compute_flow(i0, i1, p, device=dev)
        t0 = time.perf_counter()
        flow = compute_flow(i0, i1, p, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        (info,) = graphs.entries().values()
        graphs.clear()
        bodies = {k: n for k, n in info["replays_by_key"].items()
                  if k[0] == "body"}
        return flow, dict(kernels.LAUNCHES), bodies, wall

    got, launched, bodies, wall = pair()
    route = mgsolver.transfers_on_kernel
    mgsolver.transfers_on_kernel = lambda p, x, ctx: False
    try:
        want, plain_launched, plain_bodies, plain_wall = pair()
    finally:
        mgsolver.transfers_on_kernel = route
    held("the accurate pair", got, want, "at 128^3")
    if bodies != plain_bodies:
        raise AssertionError(f"[mg] V-cycles {bodies} on the kernel route, "
                             f"{plain_bodies} on the plain one")
    if not (launched["mg_restrict"] > 0 and plain_launched["mg_restrict"]
            == plain_launched["mg_prolong"] == 0):
        raise AssertionError(f"[mg] launches {launched}, plain route "
                             f"{plain_launched}")
    log(f"[mg] a 128^3 accurate pair (two calls: the second warm): bitwise "
        f"the plain route's flow, {sum(bodies.values())} V-cycles on both; "
        f"K10 {launched['mg_restrict']}, K11 {launched['mg_prolong']} "
        f"launches; warm call {wall:.3f} s, plain route {plain_wall:.3f} s")
    for name in ("mg_restrict", "mg_prolong"):
        summary[name]["launches_128_pair"] = launched[name]
    summary["mg_restrict"]["pair_128_warm_s"] = wall
    summary["mg_restrict"]["pair_128_plain_route_warm_s"] = plain_wall
    del got, want
    torch.cuda.empty_cache()


def check_launches(label: str, launches: dict, expected: dict) -> None:
    """Raise unless exactly the expected kernels launched, each as often as
    given (None: any count above 0)."""
    ran = {k for k, n in launches.items() if n > 0}
    if ran != set(expected):
        raise AssertionError(f"{label} launched {sorted(ran)}, expected "
                             f"{sorted(expected)}")
    for name, count in expected.items():
        if count is not None and launches[name] != count:
            raise AssertionError(f"{label}: {launches[name]} launches of "
                                 f"{name}, expected {count}")


@contextlib.contextmanager
def recording_forms(forms: set, sharded: bool = False):
    """For the length of the block, wrap the kernel wrappers that a run
    calls so that each call adds its form to ``forms``: (kernel, slab
    shape, omega) for a flat sweep, (kernel, slab shape, emit) for a warp,
    (kernel, packed shape) for a packed half-sweep, (kernel, shape) for
    the median. The streamed mode calls K1 and K6 one colour at a time
    (``sor_halfsweep``, ``sor_halfsweep_gc``), and the key of a warp or a
    sweep ends with whether its window's origin is a device tensor (a
    graphed slab) or an int; a sharded run (``sharded``) calls them
    through ``sor_sweeps``/``sor_gc_sweeps``, and K4/K7. The wrapped
    functions count their launches as before; the callers import the
    wrappers at the call."""
    import torch

    from tpuflow3d_torch.kernels import median3 as m3, sor as k1, sor_gc as k6
    from tpuflow3d_torch.kernels import sor_gc_packed as k7, sor_packed as k4
    from tpuflow3d_torch.kernels import warp_grad as kw

    def origin(key, ctx):
        if sharded:
            return key
        return (*key, isinstance(getattr(ctx, "window_z0", None),
                                 torch.Tensor))

    def warp_key(i1, flow, i0, ctx=None, interp="trilinear",
                 emit_warped=False, **_):
        name = "warp_grad_tricubic" if interp == "tricubic" else "warp_grad"
        return origin((name, tuple(i1.shape), bool(emit_warped)), ctx)

    def sweep(name):
        def key(du, t, alpha, omega, *rest, ctx=None, **_):
            ctx = rest[1] if len(rest) > 1 else ctx
            return origin((name, tuple(du.shape), float(omega)), ctx)
        return key

    def packed(name):
        return lambda du, *_, **__: (name, tuple(du.shape))

    keys = {(kw, "warp_grad"): warp_key,
            (m3, "median3"): lambda x, *_, **__: ("median3", tuple(x.shape))}
    if sharded:
        keys.update({(k1, "sor_sweeps"): sweep("sor_halfsweep"),
                     (k6, "sor_gc_sweeps"): sweep("sor_gc"),
                     (k4, "sor_halfsweep_packed"): packed("sor_packed"),
                     (k7, "sor_halfsweep_gc_packed"): packed("sor_gc_packed")})
    else:
        keys.update({(k1, "sor_halfsweep"): sweep("sor_halfsweep"),
                     (k6, "sor_halfsweep_gc"): sweep("sor_gc")})
    saved = {}
    for (mod, attr), key in keys.items():
        fn = saved[mod, attr] = getattr(mod, attr)

        def rec(*a, fn=fn, key=key, **kw_):
            forms.add(key(*a, **kw_))
            return fn(*a, **kw_)
        setattr(mod, attr, rec)
    try:
        yield forms
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def window_forms(p, shape, chunk: int) -> list:
    """The slab forms that compute_flow_piecewise (temporal_block, fuse)
    gives the kernels on a level of global shape ``shape``, read from its
    ``piecewise.level_plan``: (kind, planes, the z0 of every launch,
    detail). kind "warp": detail = emit; "sweep": (omega, system: "rank1",
    "gc" or "mg"); "median": detail = whether the slab is the fused
    pass's clamped-global gather."""
    from tpuflow3d_torch.piecewise import level_plan
    gamma = p.gamma > 0.0
    sweep = (p.omega, "gc" if gamma else "rank1")
    forms = []
    for ps in level_plan(p, shape, chunk):
        at = (ps.planes, ps.z0s)
        if ps.name == "fused":
            forms += [("warp", *at, gamma), ("sweep", *at, sweep)]
            forms += [("median", *at, True)] if p.median else []
        elif ps.name in ("warp", "terms_gc"):
            forms.append(("warp", *at, gamma))
        elif ps.name == "sor":
            forms.append(("sweep", *at, sweep))
        elif ps.name == "mg_smooth":
            forms.append(("sweep", *at, (p.mg_omega, "mg")))
        elif ps.name == "median":
            forms.append(("median", *at, False))
    return forms


def window_phase(torch, label, p, pyr0, pyr1, summary, checked: set,
                 all_forms=False, chunk: int = STREAM_CHUNK) -> None:
    """The kernels in the forms a streamed path with Z-chunks of ``chunk``
    gives them (``window_forms``) on every level of its pyramid (device
    tensors, fine to coarse), each at its first launch's z0 (margins below
    the volume), an interior one (96 where the level has one past it) and
    its last (margins above; a ragged last chunk's slab):
    K2/K5 on the warp slab and K1/K6 on the trapezoid or fused slab, under
    the window context, K3 on the median slab with null planes (the fused
    pass's clamped-global gather). The sweep terms are made by the path's
    own phases (``_ph_terms``/``_ph_terms_gc``/``_ph_terms_mg``, then
    ``_slab_terms`` or ``assemble_fine_system``). Each must be bitwise
    equal to its plain version on the same inputs; the forms go into
    ``checked``. K2/K5 and K1/K6 run twice: with the origin an int (the
    eager launch) and in a 0-d int32 tensor on the device (a graphed slab,
    which reads it from device memory), each bitwise the plain version. On
    the finest level, at the interior z0, each is timed beside its bound
    (the device-origin launch too). ``all_forms`` adds, on the finest
    level, K5 and K2 with and without the warped volume and K6 on
    gradient-constancy terms on the same slabs."""
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.kernels.median3 import median3 as k_median3
    from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
    from tpuflow3d_torch.kernels.sor_gc import sor_halfsweep_gc as k_sor_gc
    from tpuflow3d_torch.kernels.warp_grad import warp_grad as k_warp_grad
    from tpuflow3d_torch.median import median3
    from tpuflow3d_torch.mgsolver import assemble_fine_system
    from tpuflow3d_torch.derivatives import derivatives
    from tpuflow3d_torch.pipeline import warp_and_derivatives
    from tpuflow3d_torch.piecewise import (_clamp_global_z, _ph_terms,
                                           _ph_terms_gc, _ph_terms_mg,
                                           _slab_terms)
    from tpuflow3d_torch.solver import parity_mask, sor_halfsweep
    from tpuflow3d_torch.utils import roofline
    from tpuflow3d_torch.warp import warp_volume

    gen = torch.Generator(device=pyr0[0].device).manual_seed(6)
    dev = pyr0[0].device
    n_checked = 0

    def rand(shape, scale, uniform=False):
        if uniform:
            return (torch.rand(shape, device=dev, generator=gen) * 2.0
                    - 1.0) * scale
        return torch.randn(shape, device=dev, generator=gen) * scale

    def same(what, got, ref):
        nonlocal n_checked
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if len(got) != len(ref) or not all(
                torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"[window:{label}] {what}: not bitwise "
                                 f"equal to plain")
        n_checked += 1

    def timed(name, what, kern, plain, nbytes, elements, key,
              kern_dev=None):
        """Time the kernel (and its device-origin launch ``kern_dev``,
        where the form has an origin) and the plain version."""
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        dev_ms = None if kern_dev is None else cuda_ms(torch, kern_dev)
        b, b_probed = (roofline.bound(name, nbytes, elements, bw=ROOFLINE[k],
                                      rates=ROOFLINE["rates"])
                       for k in ("sheet_bw", "probed_bw"))
        dev_txt = ("" if dev_ms is None else
                   f" ({dev_ms:.3f} ms with the origin in device memory)")
        log(f"[window:{label}] {what}: kernel {ms:.3f} ms{dev_txt}, plain "
            f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms by "
            f"{b['bound_by']} ({b_probed['bound_ms']:.3f} at the probed "
            f"rate)")
        summary[name].setdefault("window", {})[f"{label} {key}"] = {
            "ms": ms, "ms_device_origin": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"],
            "bound_probed_ms": b_probed["bound_ms"]}

    for li, (v0, v1) in enumerate(zip(pyr0, pyr1)):
        dg, h, w = v0.shape
        hw = (h, w)

        def cut(x, z0, n):
            idx = torch.arange(z0, z0 + n, device=dev).clamp(0, dg - 1)
            return x.index_select(-3, idx).contiguous()

        for kind, planes, zs, detail in window_forms(p, v0.shape, chunk):
            mid = (96 if zs[0] < 96 < zs[-1] else zs[len(zs) // 2])
            n = planes * h * w
            for z0 in dict.fromkeys((zs[0], mid, zs[-1])):
                wctx = HaloCtx(window_z0=z0, window_d_global=dg)
                # The same window with its origin in device memory.
                dctx = HaloCtx(window_z0=torch.tensor(z0, dtype=torch.int32,
                                                      device=dev),
                               window_d_global=dg)
                at = f"{planes}x{h}x{w} z0={z0}"
                time_it = li == 0 and z0 == mid
                i0s, i1s = cut(v0, z0, planes), cut(v1, z0, planes)
                if kind == "warp":
                    fls = rand((3, planes, *hw), p.flow_clamp, uniform=True)
                    forms = ([(i, e) for i in ("trilinear", "tricubic")
                              for e in (False, True)]
                             if all_forms and li == 0 else [(p.interp, detail)])
                    for interp, emit in forms:
                        name = ("warp_grad_tricubic" if interp == "tricubic"
                                else "warp_grad")

                        def kern(ctx=wctx):
                            return k_warp_grad(i1s, fls, i0s, ctx,
                                               interp=interp,
                                               emit_warped=emit)

                        def plain():
                            i1w = warp_volume(i1s, fls, wctx, interp=interp)
                            g, it = derivatives(i0s, i1w, wctx)
                            return (g, it, i1w) if emit else (g, it)

                        what = f"{name} {at}{', emit' if emit else ''}"
                        same(what, kern(), plain())
                        same(f"{what} (device origin)", kern(dctx), plain())
                        checked.update((name, (planes, h, w), emit, o)
                                       for o in (False, True))
                        if time_it:
                            timed(name, what, kern, plain,
                                  4 * n * (5 + (5 if emit else 4)), n,
                                  f"{at}{'/emit' if emit else ''}",
                                  lambda: kern(dctx))
                elif kind == "sweep":
                    omega, system = detail
                    fls = rand((3, planes, *hw), 1.0, uniform=True)
                    du = rand((3, planes, *hw), 0.05)
                    systems = ((system, "gc") if all_forms and li == 0
                               and system == "rank1" else (system,))
                    for sysname in systems:
                        if sysname == "rank1":
                            g, it, _ = warp_and_derivatives(i0s, i1s, fls, p,
                                                            wctx)
                            c, pss, psd = _ph_terms(g, it, fls, du, z0, dg, p)
                            t = _slab_terms((c, g, pss, psd), p, wctx)
                            fields = (c, g, pss, psd)
                        elif sysname == "gc":
                            pg = p if p.gamma > 0.0 else p.replace(gamma=1.0)
                            c, pss, ainv = _ph_terms_gc(i0s, i1s, fls, du,
                                                        z0, dg, pg)
                            t = _slab_terms((c, pss, ainv), pg, wctx)
                            fields = (c, pss, ainv)
                        else:
                            g, it, _ = warp_and_derivatives(i0s, i1s, fls, p,
                                                            wctx)
                            c, pss, d6 = _ph_terms_mg(g, it, fls, du, z0, dg,
                                                      p)
                            t = assemble_fine_system(c, pss, d6, p, wctx)[0]
                            fields = (c, pss, t.ainv)
                        name = ("sor_halfsweep" if sysname == "rank1"
                                else "sor_gc")
                        parity = parity_mask((planes, h, w), wctx, dev)
                        for color in (0, 1):
                            def kern(color=color, t=t, ctx=wctx):
                                if name == "sor_halfsweep":
                                    return k_sor(du, t, p.alpha, omega,
                                                 color, ctx)
                                return k_sor_gc(du, t, (p.alpha,) * 3, omega,
                                                color, ctx)

                            def plain(color=color, t=t):
                                return sor_halfsweep(du, t, omega, parity,
                                                     color, wctx)

                            what = (f"{name} ({sysname}, omega {omega}) {at} "
                                    f"colour {color}")
                            same(what, kern(), plain())
                            same(f"{what} (device origin)", kern(ctx=dctx),
                                 plain())
                            if time_it:
                                # The arguments, the output, 4 halo planes.
                                timed(name, what, kern, plain,
                                      tensor_bytes(du, *fields)
                                      + tensor_bytes(du) + 16 * h * w, n // 2,
                                      f"{at}/colour{color}",
                                      lambda k=kern: k(ctx=dctx))
                        checked.update((name, (3, planes, h, w),
                                        float(omega), o)
                                       for o in (False, True))
                        del t, fields
                else:
                    x = torch.round(rand((3, planes, *hw), 4.0)) / 80.0
                    if detail:
                        x = _clamp_global_z(x, z0, dg).contiguous()
                    what = (f"median3 {at}"
                            f"{' (clamped-global gather)' if detail else ''}")
                    ctx = HaloCtx()
                    same(what, k_median3(x, ctx), median3(x, ctx))
                    checked.add(("median3", (3, planes, h, w)))
                    if time_it:
                        timed("median3", what, lambda: k_median3(x, ctx),
                              lambda: median3(x, ctx), 2 * tensor_bytes(x),
                              3 * n, at)
    torch.cuda.empty_cache()
    log(f"[window:{label}] {n_checked} window-form cases over "
        f"{len(pyr0)} levels: each bitwise equal to its plain version")


def check_forms(label: str, forms: set, checked: set) -> None:
    """Raise if the streamed run gave a kernel a form that no window case
    held against its plain version."""
    missing = sorted(forms - checked, key=str)
    if missing:
        raise AssertionError(f"{label}: kernel forms launched but not held "
                             f"against plain: {missing}")
    log(f"[{label}] every one of the {len(forms)} kernel forms it launched "
        f"was held bitwise against plain in a window case")


def blob_pair_on_device(torch, syn, shape, shift, seed, dev):
    """synthetic.make_pair(shape, translation(shift), seed=seed) evaluated
    on the card in float64 (the same blobs; the inverse of a translation
    is exact, so i1 is the field at x - shift), returned as host float32
    arrays: numpy needs minutes for a 512^3 pair."""
    field = syn.BlobField(shape, seed=seed)
    kw = dict(dtype=torch.float64, device=dev)
    centers = torch.as_tensor(field.centers, **kw)
    sigmas = torch.as_tensor(field.sigmas, **kw)
    amps = torch.as_tensor(field.amps, **kw)
    d, h, w = shape
    yy = torch.arange(h, **kw).reshape(1, h, 1)
    xx = torch.arange(w, **kw).reshape(1, 1, w)
    out = []
    for sh in ((0.0, 0.0, 0.0), shift):
        vol = np.empty(shape, np.float32)
        for z0 in range(0, d, 32):
            zz = torch.arange(z0, min(z0 + 32, d), **kw).reshape(-1, 1, 1)
            pts = (zz - sh[0], yy - sh[1], xx - sh[2])
            acc = torch.zeros((zz.shape[0], h, w), **kw)
            for c, s, a in zip(centers, sigmas, amps):
                q = ((pts[0] - c[0]) / s[0]) ** 2
                q = q + ((pts[1] - c[1]) / s[1]) ** 2
                q = q + ((pts[2] - c[2]) / s[2]) ** 2
                acc += a * torch.exp(-0.5 * q)
            vol[z0:z0 + zz.shape[0]] = acc.float().cpu().numpy()
        out.append(vol)
    return out[0], out[1]


def device_mask(torch, i0, quantile: float, border: int, dev):
    """synthetic.gradient_mask(i0, quantile) & interior_mask(border),
    computed on the card (np.gradient's differences, np.quantile's linear
    interpolation)."""
    v = torch.as_tensor(i0, device=dev).double()
    mag = torch.sqrt(sum(gd * gd for gd in torch.gradient(v)))
    flat = mag.flatten().sort().values
    pos = quantile * (flat.numel() - 1)
    lo = int(pos)
    thr = flat[lo] + (flat[min(lo + 1, flat.numel() - 1)] - flat[lo]) * (
        pos - lo)
    mask = mag > thr
    inner = torch.zeros_like(mask)
    inner[border:-border, border:-border, border:-border] = True
    return mask & inner


def device_epe(torch, flow, shift, mask) -> float:
    """Mean endpoint error of a flow (tensor or numpy) against a
    translation, over a mask, in float64 on the mask's device."""
    f = torch.as_tensor(flow, device=mask.device).double()
    true = torch.as_tensor(shift, dtype=torch.float64,
                           device=mask.device).reshape(3, 1, 1, 1)
    err = torch.sqrt(((f - true) ** 2).sum(0))
    return float(err[mask].mean())


def device_peak(torch, dev, run, clear: bool = True):
    """Run ``run``, with no graphs captured before it unless ``clear`` is
    false (``graphs.clear``: an in-core call then captures its own);
    return (its result, the device bytes allocated at its peak beyond those
    allocated before it, those bytes)."""
    from tpuflow3d_torch import graphs
    if clear:
        graphs.clear()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = run()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base, base


def check_incore_model(label, shape, p, peak, base, summary) -> None:
    """Print an in-core run's device peak beside utils.memory's model, and
    what its graphs hold after it (``graphs.entries``: static and pool
    bytes; none after an eager run); raise if the model is below either
    (the auto choice would then send a volume in-core that runs out of
    memory)."""
    from tpuflow3d_torch import graphs
    from tpuflow3d_torch.utils import memory as mem
    model = mem.incore_peak_bytes(shape, p)
    held = sum(e["static_bytes"] + e["pool_bytes"]
               for e in graphs.entries().values())
    log(f"[mem] {label} in-core {shape}: device peak "
        f"{peak / 2 ** 30:.3f} GiB (beyond {base / 2 ** 30:.3f} GiB "
        f"allocated before), graphs hold {held / 2 ** 30:.3f} GiB, model "
        f"{model / 2 ** 30:.3f} GiB, model/peak {model / peak:.3f}")
    summary.setdefault("memory", {}).setdefault(label, []).append(
        {"shape": list(shape), "peak_bytes": peak, "graph_held_bytes": held,
         "model_bytes": model})
    if model < max(peak, held):
        raise AssertionError(f"{label}: memory.incore_peak_bytes "
                             f"{model} below the measured peak {peak} or the "
                             f"{held} bytes the graphs hold")


def log_streamed_model(label, shape, p, chunk, peak, base, summary) -> None:
    """Print a streamed run's device peak and what its graphs hold after it
    (``graphs.entries``: static and pool bytes) beside the footprint the
    model of pick_chunk_z gives for its chunk; raise if the model is below
    either (the chunk pick_chunk_z chooses would then run out of
    memory)."""
    from tpuflow3d_torch import graphs
    from tpuflow3d_torch.utils import memory as mem
    model = mem.streamed_peak_bytes(shape, p, chunk)
    held = sum(e["static_bytes"] + e["pool_bytes"]
               for e in graphs.entries().values())
    held_txt = (f"graphs hold {held / 2 ** 30:.3f} GiB" if held else
                "no graphs held")
    log(f"[mem] {label} streamed {shape}, chunks of {chunk}: device peak "
        f"{peak / 2 ** 30:.3f} GiB (beyond {base / 2 ** 30:.3f} GiB "
        f"allocated before), {held_txt}, model {model / 2 ** 30:.3f} GiB, "
        f"model/peak {model / peak:.3f}"
        + (f", model/held {model / held:.3f}" if held else ""))
    summary.setdefault("memory", {}).setdefault(label, []).append(
        {"shape": list(shape), "chunk": chunk, "peak_bytes": peak,
         "graph_held_bytes": held, "model_bytes": model})
    if model < max(peak, held):
        raise AssertionError(f"{label}: memory.streamed_peak_bytes {model} "
                             f"below the measured peak {peak} or the {held} "
                             f"bytes the graphs hold")


def stream_gate(torch, label, streamed, incore, e_s, e_c, epe_limit):
    """The JAX package's streamed-vs-in-core gate, and the EPE limit."""
    diff = (torch.as_tensor(streamed, device=incore.device) - incore).abs()
    mx, mean = float(diff.max()), float(diff.mean())
    log(f"{label} streamed vs in-core: max |diff| {mx:.3e}, mean "
        f"{mean:.3e}; EPE streamed {e_s:.6f}, in-core {e_c:.6f} (gate max "
        f"< {STREAM_GATE[0]}, mean < {STREAM_GATE[1]}, |dEPE| < "
        f"{STREAM_GATE[2]}; EPE < {epe_limit})")
    if not (mx < STREAM_GATE[0] and mean < STREAM_GATE[1]
            and abs(e_s - e_c) < STREAM_GATE[2]
            and max(e_s, e_c) < epe_limit):
        raise AssertionError(f"{label}: streamed and in-core flows fail the "
                             f"gate")
    return mx, mean


def host_memory() -> str:
    """`free -g`'s memory line and this process's peak resident size."""
    import resource
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.splitlines()
    mem = next((ln for ln in free if ln.startswith("Mem:")), "?")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return f"free -g: {' '.join(mem.split())}; peak RSS {rss:.1f} GiB"


def stream_phases(torch, i0, i1, true, mask, launches, summary) -> None:
    """Phases 11-14: compute_flow_piecewise on the card."""
    import tempfile

    from tpuflow3d_torch import PRESETS, compute_flow, graphs, kernels
    from tpuflow3d_torch import synthetic as syn
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.piecewise import compute_flow_piecewise
    from tpuflow3d_torch.pipeline import prepare_pyramids
    from tpuflow3d_torch.utils.profiling import PhaseTimer

    dev = torch.device("cuda", 0)
    checked = set()   # kernel forms held bitwise against plain
    forms = set()     # kernel forms the current path's runs launched

    def params(path, **kw):
        preset, changes, _, _ = STREAM_PATHS[path]
        return PRESETS[preset].replace(**changes, **kw)

    def windows(path, pp, pair=(i0, i1), **kw):
        """The window forms of the path's kernels, on its own pyramid."""
        pyr0, pyr1, _ = prepare_pyramids(torch.as_tensor(pair[0], device=dev),
                                         torch.as_tensor(pair[1], device=dev),
                                         pp, HaloCtx())
        window_phase(torch, path, pp, pyr0, pyr1, summary, checked, **kw)
        del pyr0, pyr1
        torch.cuda.empty_cache()
        forms.clear()

    def streamed(label, pp, pair=(i0, i1), split=None, **kw):
        """One streamed run, graphed (no graphs held before it) unless
        ``eager=True``: (flow, wall s, launches, device peak bytes); the
        kernel forms it launches go into ``forms``, its host split into
        ``split`` where one is given (``host_split``)."""
        kernels.reset_launches()
        t0 = time.perf_counter()
        with recording_forms(forms), (contextlib.nullcontext()
                                      if split is None
                                      else host_split(split)):
            f, peak, base = device_peak(
                torch, dev, lambda: compute_flow_piecewise(
                    *pair, pp, chunk_z=STREAM_CHUNK, device=dev, **kw))
        wall = time.perf_counter() - t0
        if f.shape != (3, *pair[0].shape) or not np.isfinite(f).all():
            raise AssertionError(f"{label}: flow of shape {f.shape} or "
                                 f"non-finite")
        if pp.backend != "plain" and kw.get("fuse", True):
            log_streamed_model(label + (" eager" if kw.get("eager") else ""),
                               pair[0].shape, pp, STREAM_CHUNK, peak, base,
                               summary)
        return f, wall, dict(kernels.LAUNCHES), peak

    def witness(label, f, launched, pp, pair=(i0, i1), **kw):
        """The eager streamed run on the same inputs: bitwise the graphed
        flow ``f``, with the same launches; returns its wall s."""
        f_e, t_e, n_e, _ = streamed(label, pp, pair, eager=True, **kw)
        log(f"[{label}] eager witness {t_e:.2f} s: bitwise the graphed flow "
            f"{np.array_equal(f_e, f)}, launches equal {n_e == launched}")
        if not np.array_equal(f_e, f) or n_e != launched:
            raise AssertionError(f"{label}: the graphed streamed flow is not "
                                 f"the eager one ({n_e} eager launches, "
                                 f"{launched} graphed)")
        return t_e

    def incore(pp, pair=(i0, i1), label=""):
        t0 = time.perf_counter()
        f, peak, base = device_peak(
            torch, dev, lambda: compute_flow(*pair, pp, device=dev))
        check_incore_model(label, pair[0].shape, pp, peak, base, summary)
        return f, time.perf_counter() - t0, peak

    # 11. ladder256 streamed: kernels against plain, then checkpoint and
    # resume.
    path = "stream:ladder256"
    tag = f"[{path}]"
    pp = params(path)
    windows(path, pp, all_forms=True)
    f_k, t_k, launches[path], peak_k = streamed(path, pp)
    check_launches(path, launches[path], STREAM_PATHS[path][2])
    t_e = witness(path, f_k, launches[path], pp)
    f_p, t_p, _, _ = streamed(path, pp.replace(backend="plain"))
    diff = np.abs(f_k - f_p)
    bad = int((diff > FLOW_ATOL + FLOW_RTOL * np.abs(f_p)).sum())
    e_k, e_p = (syn.epe(f, true, mask) for f in (f_k, f_p))
    log(f"{tag} {elapsed()} 256^3, chunks of {STREAM_CHUNK}: kernels "
        f"{t_k:.2f} s (device peak {peak_k / 2 ** 30:.2f} GiB), plain "
        f"{t_p:.2f} s; launches {launches[path]}; max |kernels - plain| "
        f"{float(diff.max()):.3e}, {bad} voxels past atol {FLOW_ATOL} rtol "
        f"{FLOW_RTOL}; EPE kernels {e_k:.6f}, plain {e_p:.6f} (limit "
        f"{STREAM_PATHS[path][3]})")
    if bad or max(e_k, e_p) >= STREAM_PATHS[path][3]:
        raise AssertionError(f"{path}: flows disagree or EPE past the limit")
    with tempfile.TemporaryDirectory(prefix="tf3d_ckpt.") as ck:
        f_c, t_c, _, _ = streamed(path, pp, checkpoint_dir=ck)
        saved = sorted(n for n in os.listdir(ck) if n.endswith(".raw"))
        f_r, t_r, n_r, _ = streamed(path, pp, checkpoint_dir=ck)
    d_r = float(np.abs(f_r - f_c).max())
    d_k = float(np.abs(f_c - f_k).max())
    log(f"{tag} with a checkpoint directory {t_c:.2f} s (left {saved}); "
        f"resumed from it {t_r:.2f} s ({n_r['sor_halfsweep']} K1 launches: "
        f"the finest level only); max |resumed - full| {d_r:.3e} (atol "
        f"1e-6), |checkpointed - plain run| {d_k:.3e}")
    if d_r > 1e-6 or d_k > 1e-6 or saved != [f"flow{c}_L0.raw"
                                             for c in range(3)]:
        raise AssertionError(f"{path}: resume differs from the full run")
    check_forms(path, forms, checked)
    profile_split(torch, lambda: compute_flow_piecewise(
        i0, i1, pp, chunk_z=STREAM_CHUNK, device=dev))
    summary["stream"] = {path: {"kernels_s": t_k, "eager_s": t_e,
                                "plain_s": t_p,
                                "device_peak_bytes": peak_k, "epe": e_k,
                                "max_abs_kernels_plain": float(diff.max()),
                                "resume_max_abs": d_r}}
    del f_p, f_c, f_r, diff

    # 12. One inner iteration: the fused warp iteration against the
    # trapezoid phases; their gap at 64^3, 128^3 and 256^3, and a fault
    # planted in the fused pass, which the gate must reject.
    from tpuflow3d_torch import piecewise as pw
    path = "stream:fused"
    pp = params(path)
    windows(path, pp)
    f_f, t_f, launches[path], _ = streamed(path, pp)
    check_launches(path, launches[path], STREAM_PATHS[path][2])
    t_fe = witness(path, f_f, launches[path], pp)
    f_u, t_u, n_u, _ = streamed(path, pp, fuse=False)
    check_forms(path, forms, checked)
    diff = np.abs(f_f - f_u)
    bad = int((diff > FUSED_ATOL).sum())
    by_plane = diff.max(axis=(0, 2, 3))
    seam = np.isin(np.arange(by_plane.size) % STREAM_CHUNK,
                   (0, 1, STREAM_CHUNK - 2, STREAM_CHUNK - 1))
    e_f, e_u = (syn.epe(f, true, mask) for f in (f_f, f_u))
    e_c = syn.epe(incore(pp, label=path)[0].cpu().numpy(), true, mask)
    gaps = {}
    for n in (64, 128):
        pair = syn.make_pair((n,) * 3, syn.translation(SHIFT), seed=0)[:2]
        gaps[n] = float(np.abs(streamed(path, pp, pair=pair)[0] - streamed(
            path, pp, pair=pair, fuse=False)[0]).max())
    gaps[256] = float(diff.max())
    real = pw._ph_fused_warp_iter

    def shifted(i0s, i1s, fls, carry, *rest, **kw):
        return real(i0s, i1s, fls, torch.cat([carry[:, 1:], carry[:, -1:]],
                                             1), *rest, **kw)

    pw._ph_fused_warp_iter = shifted
    try:
        planted = float(np.abs(streamed(path, pp)[0] - f_u).max())
    finally:
        pw._ph_fused_warp_iter = real
    log(f"[{path}] {elapsed()} fuse=True {t_f:.2f} s, launches "
        f"{launches[path]}; fuse=False {t_u:.2f} s, launches {n_u}; max "
        f"|fused - phases| {gaps[256]:.3e} "
        f"({float(by_plane[seam].max()):.3e} within 2 planes of a chunk "
        f"boundary, {float(by_plane[~seam].max()):.3e} "
        f"elsewhere), {bad} voxels past atol {FUSED_ATOL} rtol 0; "
        f"EPE fused {e_f:.6f}, phases {e_u:.6f}, in-core {e_c:.6f}")
    log(f"[{path}] max |fused - phases| by size: " + ", ".join(
        f"{n}^3 {g:.3e}" for n, g in sorted(gaps.items())) + "; with the "
        f"carry band read one plane off (a planted fault) "
        f"{planted:.3e} at 256^3 (the gate: atol {FUSED_ATOL})")
    if bad or max(abs(e_f - e_c), abs(e_u - e_c)) >= STREAM_GATE[2]:
        raise AssertionError(f"{path}: fused and phased flows disagree")
    if planted <= FUSED_ATOL:
        raise AssertionError(f"{path}: the gate passes a planted carry fault")
    summary["stream"][path] = {"fused_s": t_f, "fused_eager_s": t_fe,
                               "phases_s": t_u,
                               "max_abs_fused_phases_by_size": gaps,
                               "max_abs_planted_fault": planted,
                               "epe": e_f, "epe_incore": e_c}
    del f_f, f_u, f_k, diff

    # 13. ladder512 at 512^3, the full width: streamed against in-core.
    path = "stream:ladder512"
    tag = f"[{path}]"
    shape512, shift = (512, 512, 512), SHIFT
    t0 = time.perf_counter()
    pair = blob_pair_on_device(torch, syn, shape512, shift, 0, dev)
    mask512 = device_mask(torch, pair[0], 0.75, 4, dev)
    log(f"{tag} 512^3 blob pair, translation {shift}, made on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    pp = params(path)
    windows(path, pp, pair)
    timer = PhaseTimer()
    f_s, t_s, launches[path], peak_s = streamed(path, pp, pair=pair,
                                                timer=timer)
    check_launches(path, launches[path], STREAM_PATHS[path][2])
    check_forms(path, forms, checked)
    log(f"{tag} {elapsed()} streamed {t_s:.2f} s, device peak "
        f"{peak_s / 2 ** 30:.2f} GiB, launches {launches[path]}; "
        f"{host_memory()}")
    log(f"{tag} phases: " + json.dumps(timer.report()))
    f_c, t_c, peak_c = incore(pp, pair, label=path)
    log(f"{tag} in-core {t_c:.2f} s, device peak {peak_c / 2 ** 30:.2f} GiB")
    e_s, e_c = (device_epe(torch, f, shift, mask512) for f in (f_s, f_c))
    mx, mean = stream_gate(torch, tag, f_s, f_c, e_s, e_c,
                           STREAM_PATHS[path][3])
    summary["stream"][path] = {
        "streamed_s": t_s, "incore_s": t_c, "device_peak_streamed_bytes":
        peak_s, "device_peak_incore_bytes": peak_c, "max_abs": mx,
        "mean_abs": mean, "epe_streamed": e_s, "epe_incore": e_c,
        "phases": timer.report()}
    del pair, mask512, f_s, f_c
    torch.cuda.empty_cache()

    # 14. accurate streamed (streamed multigrid, K5, K6) against in-core.
    path = "stream:accurate"
    tag = f"[{path}]"
    pp = params(path)
    windows(path, pp)
    split = {}
    f_s, t_s, launches[path], peak_s = streamed(path, pp, split=split)
    check_launches(path, launches[path], STREAM_PATHS[path][2])
    check_forms(path, forms, checked)
    # Phase 18 takes this run as stream:accurate's first graphed call.
    (entry,) = graphs.entries().values()
    summary["stream_first"] = {path: {
        "flow": f_s, "split": {**split, "wall": t_s},
        "launches": dict(launches[path]), "entry": entry}}
    f_c, t_c, peak_c = incore(pp, label=path)
    e_s = syn.epe(f_s, true, mask)
    e_c = syn.epe(f_c.cpu().numpy(), true, mask)
    log(f"{tag} {elapsed()} 256^3: streamed {t_s:.2f} s (device peak "
        f"{peak_s / 2 ** 30:.2f} GiB, launches {launches[path]}), in-core "
        f"{t_c:.2f} s (device peak {peak_c / 2 ** 30:.2f} GiB)")
    mx, mean = stream_gate(torch, tag, f_s, f_c, e_s, e_c,
                           STREAM_PATHS[path][3])
    summary["stream"][path] = {
        "streamed_s": t_s, "incore_s": t_c,
        "device_peak_streamed_bytes": peak_s,
        "device_peak_incore_bytes": peak_c, "max_abs": mx,
        "mean_abs": mean, "epe_streamed": e_s, "epe_incore": e_c}
    torch.cuda.empty_cache()


# Phase 15: the command line at 256^3. The budget of the auto-mode runs
# (TPUFLOW_DEVICE_BYTES), below the in-core model of both presets and
# above the streamed multigrid's coarse chain.
CLI_BUDGET = 1 << 30
CLI_SEEDS = 300


def cli_phase(torch, i0, i1, true, mask, launches, summary) -> None:
    """Phase 15: ``python -m tpuflow3d_torch.cli`` at 256^3, in this
    process and as one, through the kernels."""
    import tempfile

    from tpuflow3d_torch import PRESETS, cli, compute_flow, kernels, vtkio
    from tpuflow3d_torch import synthetic as syn
    from tpuflow3d_torch import volume as vio
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.piecewise import DEFAULT_FLOW_CLAMP
    from tpuflow3d_torch.pipeline import prepare_pyramids
    from tpuflow3d_torch.utils import memory as mem
    from tpuflow3d_torch.utils import native
    from tpuflow3d_torch.warp import warp_volume

    dev = torch.device("cuda", 0)
    tag = "[15:cli]"
    res = summary["cli"] = {}
    torch.cuda.empty_cache()
    log(f"{tag} {torch.cuda.memory_allocated(dev)} bytes allocated on the "
        f"device before the command line runs")

    def read_flow(prefix):
        """(3, D, H, W) (z, y, x) from <prefix>{w,v,u}.raw."""
        return np.stack([vio.read_raw(f"{prefix}{c}.raw") for c in "wvu"])

    def events(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    def run_cli(label, argv):
        """cli.main in this process, its launches recorded under
        ``label``; returns (wall s, device peak, base)."""
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, peak, base = device_peak(torch, dev, lambda: cli.main(argv))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{tag} {label}: exit code {rc}")
        launches[label] = dict(kernels.LAUNCHES)
        return wall, peak, base

    with tempfile.TemporaryDirectory(prefix="tf3d_cli.") as tmp:
        # 1. The frames i0, i1, i0 as uint16 raws with sidecars; seeds.
        lo = float(min(i0.min(), i1.min()))
        scale = 65535.0 / (float(max(i0.max(), i1.max())) - lo)
        q0, q1 = (np.round((x - lo) * scale).astype(np.uint16)
                  for x in (i0, i1))
        frames = [os.path.join(tmp, f"f{t}.raw") for t in range(3)]
        for path, q in zip(frames, (q0, q1, q0)):
            vio.write_raw(path, q)
        if not native.available():
            raise AssertionError(f"{tag} the native IO library did not "
                                 f"build: {native.build_error()}")
        w0, w1 = (native.to_f32(q) for q in (q0, q1))
        rng = np.random.default_rng(0)
        # Seeds on texture (phase 4's mask: textured interior voxels), at
        # sub-voxel offsets.
        cand = np.argwhere(mask)
        seeds = (cand[rng.choice(len(cand), CLI_SEEDS, replace=False)]
                 + rng.uniform(0.0, 1.0, (CLI_SEEDS, 3)))
        seeds_csv = os.path.join(tmp, "seeds.csv")
        with open(seeds_csv, "w") as f:
            f.write("z,y,x\n" + "".join(f"{z:.3f},{y:.3f},{x:.3f}\n"
                                        for z, y, x in seeds))
        log(f"{tag} {elapsed()} three uint16 frames with sidecars, "
            f"{CLI_SEEDS} seeds; native IO {native.library_path().name}")

        # 2. The series in this process.
        out = os.path.join(tmp, "s_")
        log_json = os.path.join(tmp, "series.jsonl")
        wall, peak, base = run_cli("cli", [
            "--frames", *frames, "--preset", "ladder256", "--track",
            seeds_csv, "--derived", "divergence,curl,jacdet", "--export-vtk",
            "--stats", "--report-fit", "--timings", "--log-json", log_json,
            "--out", out])
        check_launches("cli", launches["cli"], {
            "sor_halfsweep": 1800, "warp_grad": 30, "median3": 30,
            "terms": 90})
        check_incore_model("cli", SHAPE, PRESETS["ladder256"], peak, base,
                           summary)
        ev = events(log_json)
        kinds = [e["event"] for e in ev]
        for kind in ("start", "pair_done", "tracks_written", "timings",
                     "fit", "statistics", "derived_written", "vtk_written"):
            if kind not in kinds:
                raise AssertionError(f"{tag} no {kind!r} event")
        if "auto_mode" in kinds:
            raise AssertionError(f"{tag} 256^3 ladder256 left in-core")
        pair_s = [e["seconds"] for e in ev if e["event"] == "pair_done"]
        flow0 = read_flow(f"{out}0000_")
        ref = compute_flow(w0, w1, PRESETS["ladder256"], device=dev)
        ref = ref.cpu().numpy()
        if not np.array_equal(flow0, ref):
            raise AssertionError(f"{tag} pair 0 differs from compute_flow: "
                                 f"{float(np.abs(flow0 - ref).max()):.3e}")
        epe0 = syn.epe(flow0, true, mask)
        with open(f"{out}tracks.csv") as f:
            rows = np.loadtxt(f, delimiter=",", skiprows=1)
        back = rows[rows[:, 0] == 2][:, 2:]
        drift = np.sqrt(((back - seeds) ** 2).sum(axis=1))
        vtk, _ = vtkio.read_vtk(f"{out}0000_flow.vtk")
        log(f"{tag} {elapsed()} series of 3 frames: {wall:.2f} s, pairs "
            + ", ".join(f"{t:.3f} s" for t in pair_s) + f"; launches "
            f"{launches['cli']}; pair 0 bitwise compute_flow, EPE "
            f"{epe0:.6f} (limit 0.03); tracks back at their seeds within "
            f"{float(drift.max()):.4f} voxel (mean {float(drift.mean()):.4f},"
            f" limit 0.1)")
        if epe0 >= 0.03 or drift.max() >= 0.1:
            raise AssertionError(f"{tag} EPE {epe0} or track drift "
                                 f"{drift.max()} past its limit")
        if not np.array_equal(vtk, flow0):
            raise AssertionError(f"{tag} the VTK flow is not the raw flow")
        res.update(series_s=wall, pair_s=pair_s, epe_pair0=epe0,
                   track_drift_max=float(drift.max()))

        # 3. The real entry point: the command line as a process.
        torch.cuda.empty_cache()
        out_p = os.path.join(tmp, "p_")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpuflow3d_torch.cli", "--frame0",
             frames[0], "--frame1", frames[1], "--preset", "ladder256",
             "--out", out_p], capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=tmp)
        t_proc = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{tag} python -m tpuflow3d_torch.cli: "
                                 f"exit {proc.returncode}\n{proc.stderr}")
        if not np.array_equal(read_flow(out_p), flow0):
            raise AssertionError(f"{tag} the process's flow differs from "
                                 f"the series' pair 0")
        log(f"{tag} {elapsed()} python -m tpuflow3d_torch.cli: rc 0 in "
            f"{t_proc:.2f} s (process start and kernel load included), "
            f"u/v/w bitwise the series' pair 0")
        res["process_s"] = t_proc

        # 4. Auto mode under a budget below the in-core model: the window
        # forms of the chunk pick_chunk_z gives, then the run, capped at
        # the budget, every form it launched held against plain.
        total = torch.cuda.get_device_properties(dev).total_memory
        checked, forms = set(), set()
        os.environ["TPUFLOW_DEVICE_BYTES"] = str(CLI_BUDGET)
        try:
            for preset, expected, limit in (
                    ("ladder256", {"sor_halfsweep": None, "warp_grad": None,
                                   "median3": None}, 0.03),
                    ("accurate", {"warp_grad_tricubic": None,
                                  "sor_gc": None, "median3": None,
                                  "mg_restrict": None, "mg_prolong": None},
                     1e-3)):
                p = PRESETS[preset]
                label = f"cli:auto:{preset}"
                want = mem.pick_chunk_z(SHAPE, p, CLI_BUDGET)
                # (the mode puts in its flow clamp where the preset has none)
                p_s = (p if p.flow_clamp > 0 else
                       p.replace(flow_clamp=DEFAULT_FLOW_CLAMP))
                pyr0, pyr1, _ = prepare_pyramids(
                    torch.as_tensor(w0, device=dev),
                    torch.as_tensor(w1, device=dev), p_s, HaloCtx())
                window_phase(torch, label, p_s, pyr0, pyr1, summary, checked,
                             chunk=want)
                del pyr0, pyr1
                torch.cuda.empty_cache()
                forms.clear()
                out_a = os.path.join(tmp, f"a_{preset}_")
                log_a = os.path.join(tmp, f"auto_{preset}.jsonl")
                torch.cuda.set_per_process_memory_fraction(
                    CLI_BUDGET / total, dev)
                try:
                    with recording_forms(forms):
                        wall, peak, base = run_cli(label, [
                            "--frame0", frames[0], "--frame1", frames[1],
                            "--preset", preset, "--log-json", log_a,
                            "--out", out_a])
                    reserved = torch.cuda.max_memory_reserved(dev)
                finally:
                    torch.cuda.set_per_process_memory_fraction(1.0, dev)
                check_launches(label, launches[label], expected)
                check_forms(label, forms, checked)
                ev = events(log_a)
                auto = [e for e in ev if e["event"] == "auto_mode"]
                chunk = [e for e in ev if e["event"] == "auto_chunk"]
                if not (auto and auto[0]["selected"] == "piecewise"
                        and chunk and chunk[0]["chunk_z"] == want):
                    raise AssertionError(f"{tag} {label}: events {auto} "
                                         f"{chunk}, expected piecewise and "
                                         f"chunk {want}")
                log_streamed_model(label, SHAPE, p, want, peak, base,
                                   summary)
                incore = (flow0 if preset == "ladder256" else
                          compute_flow(w0, w1, p, device=dev).cpu().numpy())
                streamed = read_flow(out_a)
                e_s, e_c = (syn.epe(f, true, mask) for f in (streamed,
                                                             incore))
                mx, mean = stream_gate(torch, f"{tag} {label}", streamed,
                                       torch.as_tensor(incore), e_s, e_c,
                                       limit)
                log(f"{tag} {elapsed()} {label}: in-core model "
                    f"{auto[0]['need_bytes'] / 2 ** 30:.2f} GiB > budget "
                    f"{CLI_BUDGET / 2 ** 30:.2f} GiB: piecewise, chunk "
                    f"{want}, {wall:.2f} s under the allocator capped at the "
                    f"budget; torch.cuda.max_memory_allocated "
                    f"{(base + peak) / 2 ** 30:.3f} GiB, "
                    f"max_memory_reserved {reserved / 2 ** 30:.3f} GiB; "
                    f"launches {launches[label]}")
                if base + peak > CLI_BUDGET or reserved > CLI_BUDGET:
                    raise AssertionError(f"{tag} {label}: device peak "
                                         f"{base + peak} (with {base} "
                                         f"allocated before) or reserved "
                                         f"{reserved} past the budget")
                res[label] = {"chunk": want, "s": wall, "peak_bytes": peak,
                              "reserved_bytes": reserved, "max_abs": mx,
                              "mean_abs": mean, "epe": e_s,
                              "epe_incore": e_c}
        finally:
            del os.environ["TPUFLOW_DEVICE_BYTES"]

        # 5. Apply pair 0's flow to frame 1.
        out_w = os.path.join(tmp, "w_")
        run_cli("cli:apply", ["--apply-flow", f"{out}0000_", "--frame1",
                              frames[1], "--out", out_w])
        check_launches("cli:apply", launches["cli:apply"], {})
        warped = vio.read_raw(f"{out_w}warped.raw")
        ref = warp_volume(torch.as_tensor(w1, device=dev),
                          torch.as_tensor(flow0, device=dev)).cpu().numpy()
        before = float(np.abs(w1 - w0).mean())
        after = float(np.abs(warped - w0).mean())
        log(f"{tag} --apply-flow: bitwise warp_volume "
            f"{np.array_equal(warped, ref)}; mean |warped - i0| {after:.3f} "
            f"against mean |i1 - i0| {before:.3f} (uint16 units)")
        if not np.array_equal(warped, ref) or after >= before:
            raise AssertionError(f"{tag} --apply-flow")

        # 6. Forward-backward consistency of the pair.
        out_c = os.path.join(tmp, "c_")
        wall, _, _ = run_cli("cli:consistency", [
            "--frame0", frames[0], "--frame1", frames[1], "--preset",
            "ladder256", "--check-consistency", "--out", out_c])
        check_launches("cli:consistency", launches["cli:consistency"], {
            "sor_halfsweep": 1800, "warp_grad": 30, "median3": 30,
            "terms": 90})
        err = vio.read_raw(f"{out_c}consistency.raw")
        med = float(np.median(err[8:-8, 8:-8, 8:-8]))
        log(f"{tag} {elapsed()} --check-consistency {wall:.2f} s: interior "
            f"median {med:.5f} voxel (limit 0.25), mean {float(err.mean()):.5f}")
        if med >= 0.25:
            raise AssertionError(f"{tag} consistency median {med}")
        res.update(consistency_median=med)
    torch.cuda.empty_cache()


# The Z-sharded paths, phase 16: two ranks sharing the card through gloo,
# each path's flow against the one-device flow of the same prepare_params.
# path -> (preset, changes, the kernels each rank must launch, EPE limit),
# as PATHS. A shard is never the whole volume, so every sweep launches one
# colour with its neighbour's planes: 5 levels x 3 warps x 3 inner
# iterations x 20 sweeps x 2 colours = 1800 K1, K6 (no one-block form), K4
# or K7 on each rank.
SHARD_RANKS = 2
SHARD_DEVICE = "cuda:0"
SHARD_PATHS = {
    "ladder256": ("ladder256", {},
                  {"sor_halfsweep": 1800, "warp_grad": None,
                   "median3": None}, 0.03),
    "accurate": ("accurate", {},
                 {"warp_grad_tricubic": None, "sor_gc": None,
                  "median3": None}, 1e-3),
    "gamma": ("ladder256", {"gamma": 1.0},
              {"warp_grad": None, "sor_gc": 1800, "median3": None}, 0.03),
    "packed": ("ladder256", {"sweep_layout": "packed"},
               {"sor_packed": 1800, "warp_grad": None, "median3": None},
               0.03),
    "packed_gamma": ("ladder256", {"sweep_layout": "packed", "gamma": 1.0},
                     {"sor_gc_packed": 1800, "warp_grad": None,
                      "median3": None}, 0.03),
}
# The JAX package's sharded-vs-unsharded gate (tests/test_sharding.py).
SHARD_GATE = (2e-4, 1e-3)
# Seconds the survivor of a killed --distributed rank may take to exit.
FAULT_BOUND_S = 120
# Rank 1 of the fault run: a thread ends the process (exit 17) the moment
# the first level checkpoint appears, mid-solve; then the command line.
DIE_AT_FIRST_CHECKPOINT = """
import os, sys, threading, time
from tpuflow3d_torch import checkpoint, cli
ck = sys.argv[sys.argv.index("--checkpoint-dir") + 1]
def watch():
    while checkpoint.peek_level_checkpoint(ck) is None:
        time.sleep(0.02)
    os._exit(17)
threading.Thread(target=watch, daemon=True).start()
sys.exit(cli.main(sys.argv[1:]))
"""


def shard_params(path):
    from tpuflow3d_torch import PRESETS
    from tpuflow3d_torch.sharding import prepare_params
    preset, changes = SHARD_PATHS[path][:2]
    return prepare_params(PRESETS[preset].replace(**changes), SHARD_RANKS)


def shard_forms(torch, label, pp, i0, i1, ctx, dev, timings: dict):
    """On this rank, before path ``label`` runs: each kernel form that the
    path launches, on its slab of every level of its sharded pyramid (made
    by ``prepare_pyramids`` under the sharded context), bitwise against
    its plain version under the same context, neighbours' planes and all:
    K2/K5 in halo form (flows uniform within +-flow_clamp), K1 or K6 one
    colour (rank-1, gradient-constancy or every multigrid level's
    system), K4 or K7 with their halo planes, K3 with its halo planes.
    Returns the forms held, as ``recording_forms(sharded=True)`` keys
    them, and the largest |kernel - plain| of the warp's halo form over
    the levels, by kernel name. With ``timings`` (rank 0's dict), the finest level's warp is timed: the
    kernel on padded inputs while the other rank waits (its own time on
    the card), and the wrapper (halo exchanges included) and the plain
    version with both ranks running; beside its bound."""
    import torch.distributed as dist

    from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
    from tpuflow3d_torch.kernels.median3 import median3 as k_median3
    from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
    from tpuflow3d_torch.kernels.sor_gc import sor_halfsweep_gc as k_sor_gc
    from tpuflow3d_torch.kernels.sor_gc_packed import (
        sor_halfsweep_gc_packed as k_sor_gc_packed,
        sor_halfsweep_gc_packed_plain)
    from tpuflow3d_torch.kernels.sor_packed import (
        pack_color, sor_halfsweep_packed as k_sor_packed,
        sor_halfsweep_packed_plain)
    from tpuflow3d_torch.kernels.warp_grad import (warp_grad as k_warp_grad,
                                                   warp_grad_halo)
    from tpuflow3d_torch.median import median3
    from tpuflow3d_torch.mgsolver import build_mg_levels
    from tpuflow3d_torch.pipeline import prepare_pyramids, warp_and_derivatives
    from tpuflow3d_torch.sharding import process_z_range
    from tpuflow3d_torch.solver import compute_terms, parity_mask, sor_halfsweep
    from tpuflow3d_torch.utils import roofline
    from tpuflow3d_torch.warp import warp_halo, warp_volume

    tag = f"[shard:{label}] rank {ctx.rank}"
    lo, hi = process_z_range(i0.shape[0], ctx.n_shards, ctx.rank)
    pyr0, pyr1, _ = prepare_pyramids(torch.as_tensor(i0[lo:hi], device=dev),
                                     torch.as_tensor(i1[lo:hi], device=dev),
                                     pp, ctx)
    gen = torch.Generator(device=dev).manual_seed(16 + ctx.rank)
    gamma = pp.gamma > 0.0
    warp_name = "warp_grad_tricubic" if pp.interp == "tricubic" else \
        "warp_grad"
    checked = set()
    n_checked = 0
    errs = {}

    def rand(shape, scale, uniform=False):
        if uniform:
            return (torch.rand(shape, device=dev, generator=gen) * 2.0
                    - 1.0) * scale
        return torch.randn(shape, device=dev, generator=gen) * scale

    def same(what, got, ref, kernel=None):
        nonlocal n_checked
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        if kernel is not None:
            errs[kernel] = max(err, errs.get(kernel, 0.0))
        if len(got) != len(ref) or not all(
                torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{tag} {what}: not bitwise equal to plain "
                                 f"(max |diff| {err:.3e})")
        n_checked += 1

    for li, (v0, v1) in enumerate(zip(pyr0, pyr1)):
        dl, h, w = v0.shape
        at = f"{dl}x{h}x{w} (level {li})"
        fl = rand((3, dl, h, w), pp.flow_clamp, uniform=True)

        def kern():
            return k_warp_grad(v1, fl, v0, ctx, interp=pp.interp,
                               emit_warped=gamma, max_disp=pp.flow_clamp)

        def plain():
            i1w = warp_volume(v1, fl, ctx, max_disp=pp.flow_clamp,
                              interp=pp.interp)
            g, it = derivatives(v0, i1w, ctx)
            return (g, it, i1w) if gamma else (g, it)

        same(f"{warp_name} halo form {at}", kern(), plain(), warp_name)
        checked.add((warp_name, (dl, h, w), gamma))
        if li == 0:
            # Every rank runs the same timed loops (the wrapper and the
            # plain version exchange planes); the kernel alone is timed
            # on rank 0 while the other rank waits.
            nh = warp_halo(pp.flow_clamp, pp.interp)
            padded = (ctx.zpad(v1, nh + 1).contiguous(),
                      ctx.zpad(fl, 1).contiguous(),
                      ctx.zpad(v0, 1).contiguous())
            bare = None
            if ctx.rank == 0:
                bare = cuda_ms(torch, lambda: warp_grad_halo(
                    *padded, ctx.z0(dl), ctx.d_global(dl), nh, pp.interp,
                    gamma))
            dist.barrier(ctx.group)
            wrapper_ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
            if timings is not None:
                n = dl * h * w
                nbytes = tensor_bytes(*padded) + (5 if gamma else 4) * 4 * n
                b = roofline.bound(warp_name, nbytes, n, device=dev)
                key = f"{warp_name}/halo{'/emit' if gamma else ''}"
                timings.setdefault(key, {
                    "ms": bare, "wrapper_ms": wrapper_ms,
                    "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"], "bytes": nbytes,
                    "elements": n, "slab": [dl, h, w],
                    "halo_planes": nh + 1, "flow_clamp": pp.flow_clamp})
                log(f"{tag} {key} {at}: kernel alone {bare:.3f} ms, wrapper "
                    f"with its exchanges {wrapper_ms:.3f} ms and plain "
                    f"{plain_ms:.3f} ms (both ranks running), bound "
                    f"{b['bound_ms']:.3f} ms by {b['bound_by']}")
            del padded

        du = rand((3, dl, h, w), 0.05)
        if pp.solver == "multigrid":
            g, it, _ = warp_and_derivatives(v0, v1, fl, pp, ctx)
            t = compute_terms(g, it, fl, du, pp, ctx)
            for mi, lvl in enumerate(build_mg_levels(t, pp, ctx)):
                shp = tuple(lvl.psi_s.shape)
                dm = rand((3, *shp), 0.05)
                tt = lvl.terms._replace(c=rand((3, *shp), 0.01))
                for color in (0, 1):
                    same(f"sor_gc multigrid level {mi} {shp} colour {color}",
                         k_sor_gc(dm, tt, lvl.axis_alpha, pp.mg_omega, color,
                                  ctx),
                         sor_halfsweep(dm, tt, pp.mg_omega, lvl.parity,
                                       color, ctx))
                checked.add(("sor_gc", (3, *shp), float(pp.mg_omega)))
        else:
            g, it, i1w = warp_and_derivatives(v0, v1, fl, pp, ctx,
                                              emit_warped=gamma)
            gc = grad_constancy_terms(v0, i1w, ctx, g=g) if gamma else None
            t = compute_terms(g, it, fl, du, pp, ctx, gc=gc)
            if pp.sweep_layout == "packed" and w % 2 == 0:
                z0, dg = ctx.z0(dl), ctx.d_global(dl)
                name = "sor_gc_packed" if gamma else "sor_packed"
                kern_p, plain_p = ((k_sor_gc_packed,
                                    sor_halfsweep_gc_packed_plain) if gamma
                                   else (k_sor_packed,
                                         sor_halfsweep_packed_plain))
                mid, tail = ((t.c, t.ainv), ()) if gamma else (
                    (t.c, t.g), (t.psi_d,))
                for color in (0, 1):
                    pk = lambda a, c: pack_color(a, c, z0)
                    duo, pso = pk(du, 1 - color), pk(t.psi_s, 1 - color)
                    args = (pk(du, color), duo,
                            *(pk(a, color) for a in mid),
                            pk(t.psi_s, color), pso,
                            *(pk(a, color) for a in tail),
                            *ctx.z_halo_planes(duo), *ctx.z_halo_planes(pso),
                            z0, pp.alpha, pp.omega, color, dg)
                    same(f"{name} {at} colour {color}", kern_p(*args),
                         plain_p(*args))
                checked.add((name, (3, dl, h, w // 2)))
            else:
                name = "sor_gc" if gamma else "sor_halfsweep"
                parity = parity_mask((dl, h, w), ctx, dev)
                for color in (0, 1):
                    got = (k_sor_gc(du, t, (pp.alpha,) * 3, pp.omega, color,
                                    ctx) if gamma else
                           k_sor(du, t, pp.alpha, pp.omega, color, ctx))
                    same(f"{name} {at} colour {color}", got,
                         sor_halfsweep(du, t, pp.omega, parity, color, ctx))
                checked.add((name, (3, dl, h, w), float(pp.omega)))
        if pp.median:
            x = torch.round(rand((3, dl, h, w), 4.0)) / 80.0
            same(f"median3 {at}", k_median3(x, ctx), median3(x, ctx))
            checked.add(("median3", (3, dl, h, w)))
        del fl, du, t
    torch.cuda.empty_cache()
    log(f"{tag} {n_checked} sharded kernel-form cases over {len(pyr0)} "
        f"levels: each bitwise equal to its plain version")
    return checked, errs


def shard_rank(rank, port, i0, i1, results) -> None:
    """One of the ranks of phase 16 (spawned; both share cuda:0 through
    gloo): for each path, hold its kernel forms (``shard_forms``), then run
    ``compute_flow_sharded`` (SPMD) with every launched form recorded, and
    report its flow slab, launch counts, wall time, device peak beside
    ``memory.sharded_peak_bytes``, and the halo exchanges' count and time
    on ``results``; a traceback in place of a report on failure."""
    import torch
    import torch.distributed as dist
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from tpuflow3d_torch import distributed as tdist, grid, kernels
        from tpuflow3d_torch.sharding import compute_flow_sharded
        from tpuflow3d_torch.utils import memory as mem
        z = tdist.initialize(f"127.0.0.1:{port}", SHARD_RANKS, rank,
                             device=SHARD_DEVICE)
        if z.backend != "gloo":
            raise AssertionError(f"two ranks on one card took {z.backend}")
        kernels.load_library()
        dev = z.device
        for path in SHARD_PATHS:
            pp = shard_params(path)
            ctx = grid.shard_ctx(z.group)
            timings = {} if rank == 0 else None
            checked, errs = shard_forms(torch, path, pp, i0, i1, ctx, dev,
                                        timings)
            forms = set()
            dist.barrier()
            kernels.reset_launches()
            grid.COMM.reset()
            with recording_forms(forms, sharded=True):
                t0 = time.perf_counter()
                flow, peak, base = device_peak(
                    torch, dev, lambda: compute_flow_sharded(
                        i0, i1, pp, devices=[SHARD_DEVICE] * SHARD_RANKS))
                wall = time.perf_counter() - t0
            missing = sorted(forms - checked, key=str)
            if missing:
                raise AssertionError(f"[shard:{path}] rank {rank}: kernel "
                                     f"forms launched but not held against "
                                     f"plain: {missing}")
            results.put((rank, path, {
                "flow": flow.cpu().numpy(), "seconds": wall,
                "launches": dict(kernels.LAUNCHES),
                "comm": grid.COMM.as_dict(), "forms": len(forms),
                "halo_max_abs_err": errs,
                "peak_bytes": peak, "base_bytes": base,
                "model_bytes": mem.sharded_peak_bytes(SHAPE, pp,
                                                      SHARD_RANKS),
                "timings": timings or {}}))
            del flow
            torch.cuda.empty_cache()
        tdist.shutdown()
    except BaseException:
        import traceback
        results.put((rank, None, traceback.format_exc()))
        results.close()
        results.join_thread()
        sys.stderr.flush()
        os._exit(1)


def shard_phase(torch, i0, i1, true, mask, launches, summary) -> None:
    """Phase 16: the Z-sharded paths, two ranks sharing the card."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    from tpuflow3d_torch import compute_flow, graphs
    from tpuflow3d_torch import synthetic as syn
    from tpuflow3d_torch.sharding import compute_flow_sharded, free_port

    dev = torch.device(SHARD_DEVICE)
    card = gpu_name_and_power_limit()
    res = summary["shard"] = {"card": card, "ranks": SHARD_RANKS,
                              "transport": "gloo through host memory",
                              "paths": {}}
    # The one-device flows with the sharded runs' params (prepare_params:
    # Z a multiple of 2, flow clamp 4 where the preset has none).
    one = {}
    for path in SHARD_PATHS:
        pp = shard_params(path)
        t0 = time.perf_counter()
        f = compute_flow(i0, i1, pp, device=dev)
        torch.cuda.synchronize(dev)
        one[path] = (f.cpu().numpy(), time.perf_counter() - t0)
        del f
    graphs.clear()
    log(f"[16:shard] {elapsed()} one-device flows of the {len(one)} paths "
        f"with prepare_params(., {SHARD_RANKS})")

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    t_spawn = time.perf_counter()
    procs = [ctx.Process(target=shard_rank, args=(r, port, i0, i1, results),
                         daemon=True) for r in range(SHARD_RANKS)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < SHARD_RANKS * len(SHARD_PATHS):
            try:
                rank, path, payload = results.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [r for r, proc in enumerate(procs)
                        if proc.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"[16:shard] rank {dead[0]} exited "
                                         f"with {procs[dead[0]].exitcode}")
                continue
            if path is None:
                raise AssertionError(f"[16:shard] rank {rank} failed:\n"
                                     f"{payload}")
            got[rank, path] = payload
            if all((r, path) in got for r in range(SHARD_RANKS)):
                shard_check(torch, path, [got[r, path]
                                          for r in range(SHARD_RANKS)],
                            one[path], true, mask, launches, res, card)
                for r in range(SHARD_RANKS):
                    got[r, path] = {"checked": True}
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
    log(f"[16:shard] {elapsed()} the two ranks ran the {len(SHARD_PATHS)} "
        f"paths in {time.perf_counter() - t_spawn:.1f} s, spawn included")

    # The entry point called from one process: it spawns the two ranks
    # itself and gathers the flow, which must be the SPMD run's bits.
    pp = shard_params("ladder256")
    t0 = time.perf_counter()
    flow = compute_flow_sharded(i0, i1, pp,
                                devices=[SHARD_DEVICE] * SHARD_RANKS)
    wall = time.perf_counter() - t0
    if not np.array_equal(flow.numpy(), res["paths"]["ladder256"].pop(
            "_flow")):
        raise AssertionError("[16:shard] compute_flow_sharded from one "
                             "process differs from the SPMD run")
    log(f"[16:shard] compute_flow_sharded(..., devices=['cuda:0', "
        f"'cuda:0']) from one process: {wall:.2f} s with its spawn, bitwise "
        f"the SPMD ladder256 flow")
    res["single_process_entry_seconds"] = wall
    for path in res["paths"]:
        res["paths"][path].pop("_flow", None)
    shard_cli(torch, i0, i1, flow.numpy(), res)


def shard_check(torch, path, reports, one_device, true, mask, launches, res,
                card) -> None:
    """Parent side of phase 16 for one path: launch counts on each rank,
    the gathered flow against the one-device flow (the JAX gate), the EPE,
    each rank's device peak beside the model, the exchanges."""
    from tpuflow3d_torch import synthetic as syn
    tag = f"[16:shard:{path}]"
    expected, epe_limit = SHARD_PATHS[path][2:]
    for r, rep in enumerate(reports):
        check_launches(f"{path} rank {r}", rep["launches"], expected)
    launches[f"shard:{path}"] = {
        k: sum(rep["launches"][k] for rep in reports)
        for k in reports[0]["launches"]}
    flow = np.concatenate([rep["flow"] for rep in reports], axis=1)
    ref, t_one = one_device
    if flow.shape != ref.shape or not np.isfinite(flow).all():
        raise AssertionError(f"{tag} flow of shape {flow.shape} or "
                             f"non-finite")
    diff = np.abs(flow - ref)
    atol, rtol = SHARD_GATE
    bad = int((diff > atol + rtol * np.abs(ref)).sum())
    e_shard = syn.epe(flow, true, mask)
    e_one = syn.epe(ref, true, mask)
    walls = [rep["seconds"] for rep in reports]
    comm = [rep["comm"] for rep in reports]
    log(f"{tag} two ranks sharing one {card}, gloo through host: wall "
        f"{max(walls):.2f} s (ranks {', '.join(f'{w:.2f}' for w in walls)}; "
        f"one device {t_one:.2f} s); launches per rank "
        f"{reports[0]['launches']}; {reports[0]['forms']} kernel forms, "
        f"every one held bitwise")
    for r, c in enumerate(comm):
        log(f"{tag} rank {r}: {c['exchanges']} halo exchanges, "
            f"{c['gathers']} all-gathers, {c['reductions']} reductions, "
            f"{c['bytes_sent'] / 2 ** 20:.1f} MiB sent, {c['seconds']:.2f} s "
            f"in them")
    log(f"{tag} max |sharded - one device| {float(diff.max()):.3e}, {bad} "
        f"voxels past atol {atol} rtol {rtol}; EPE sharded {e_shard:.6f}, "
        f"one device {e_one:.6f} (limit {epe_limit})")
    for r, rep in enumerate(reports):
        log(f"[mem] shard:{path} rank {r}: device peak "
            f"{rep['peak_bytes'] / 2 ** 30:.3f} GiB (beyond "
            f"{rep['base_bytes'] / 2 ** 30:.3f} GiB allocated before), model "
            f"{rep['model_bytes'] / 2 ** 30:.3f} GiB, model/peak "
            f"{rep['model_bytes'] / rep['peak_bytes']:.3f}")
    res["paths"][path] = {
        "max_abs_diff_vs_one_device": float(diff.max()), "epe": e_shard,
        "epe_one_device": e_one, "seconds_by_rank": walls,
        "one_device_seconds": t_one, "comm_by_rank": comm,
        "peak_bytes_by_rank": [rep["peak_bytes"] for rep in reports],
        "model_bytes": reports[0]["model_bytes"],
        "forms": reports[0]["forms"], "timings": reports[0]["timings"],
        "halo_max_abs_err": {
            k: max(rep["halo_max_abs_err"][k] for rep in reports)
            for k in reports[0]["halo_max_abs_err"]}}
    if path == "ladder256":
        res["paths"][path]["_flow"] = flow
    if bad:
        raise AssertionError(f"{tag} sharded and one-device flows disagree")
    if not max(e_shard, e_one) < epe_limit:
        raise AssertionError(f"{tag} EPE {e_shard} (one device {e_one}), "
                             f"limit {epe_limit}")
    for r, rep in enumerate(reports):
        if rep["model_bytes"] < rep["peak_bytes"]:
            raise AssertionError(f"{tag} rank {r}: memory.sharded_peak_bytes "
                                 f"{rep['model_bytes']} below the measured "
                                 f"peak {rep['peak_bytes']}")


def shard_cli(torch, i0, i1, sharded, res) -> None:
    """Phase 16's command line: two ``python -m tpuflow3d_torch.cli
    --distributed`` processes on the card (host-local slab IO) at 256^3
    with ``ladder256``, bitwise the sharded flow; then the same with a
    checkpoint directory and rank 1 killed at the first level checkpoint:
    the survivor must exit non-zero within FAULT_BOUND_S, and a relaunch
    resumes to the same bits."""
    import tempfile

    from tpuflow3d_torch import checkpoint as ckpt
    from tpuflow3d_torch import volume as vio
    from tpuflow3d_torch.sharding import free_port

    tag = "[16:shard:cli]"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out_res = res["cli"] = {}

    def launch(f0, f1, out, ck=None, die=False):
        port = free_port()
        procs = []
        for r in range(SHARD_RANKS):
            head = ([sys.executable, "-c", DIE_AT_FIRST_CHECKPOINT]
                    if die and r == 1 else
                    [sys.executable, "-m", "tpuflow3d_torch.cli"])
            argv = head + ["--distributed", "--coordinator",
                           f"127.0.0.1:{port}", "--num-processes",
                           str(SHARD_RANKS), "--process-id", str(r),
                           "--frame0", f0, "--frame1", f1, "--out", out,
                           "--preset", "ladder256"]
            if ck is not None:
                argv += ["--checkpoint-dir", ck]
            procs.append(subprocess.Popen(argv, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        return procs

    def wait(procs, timeout):
        """Exit codes and the seconds at which each process ended; kills
        what is still running at the timeout."""
        t0 = time.perf_counter()
        ended = [None] * len(procs)
        while None in ended and time.perf_counter() - t0 < timeout:
            for i, proc in enumerate(procs):
                if ended[i] is None and proc.poll() is not None:
                    ended[i] = time.perf_counter() - t0
            time.sleep(0.05)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        outs = [proc.communicate()[0] for proc in procs]
        return [proc.returncode for proc in procs], ended, outs

    def read_flow(prefix):
        meta = vio.VolumeMeta(SHAPE, "float32")
        return np.stack([vio.read_raw(f"{prefix}{c}.raw", meta)
                         for c in "wvu"])

    with tempfile.TemporaryDirectory(prefix="tf3d_dist.") as tmp:
        f0, f1 = (os.path.join(tmp, name) for name in ("a.raw", "b.raw"))
        vio.write_raw(f0, i0.astype(np.float32))
        vio.write_raw(f1, i1.astype(np.float32))

        out = os.path.join(tmp, "dist_")
        rcs, ended, outs = wait(launch(f0, f1, out), 600)
        if rcs != [0] * SHARD_RANKS:
            raise AssertionError(f"{tag} exit codes {rcs}:\n" + "\n".join(
                o[-3000:] for o in outs))
        if not np.array_equal(read_flow(out), sharded):
            raise AssertionError(f"{tag} the --distributed flow differs from "
                                 f"compute_flow_sharded's")
        log(f"{tag} {SHARD_RANKS} processes of --distributed on the card: "
            f"{max(ended):.1f} s each with its start, u/v/w bitwise the "
            f"sharded flow")
        out_res["seconds"] = max(ended)

        ck = os.path.join(tmp, "ck")
        out2 = os.path.join(tmp, "fault_")
        rcs, ended, outs = wait(launch(f0, f1, out2, ck, die=True),
                                600 + FAULT_BOUND_S)
        state = ckpt.peek_level_checkpoint(ck)
        detect = (ended[0] - ended[1]) if None not in ended else None
        log(f"{tag} rank 1 killed at the first level checkpoint "
            f"({state}): exit codes {rcs}; the survivor exited "
            f"{detect if detect is None else f'{detect:.2f}'} s after it")
        if rcs[1] != 17 or rcs[0] in (0, None) or detect is None \
                or detect > FAULT_BOUND_S or state is None:
            raise AssertionError(f"{tag} the killed rank was not detected "
                                 f"within {FAULT_BOUND_S} s:\n" + "\n".join(
                                     o[-3000:] for o in outs))
        out_res["survivor_exit_after_kill_seconds"] = detect
        out_res["checkpoint_at_kill"] = list(state[0]) + [state[1]]

        rcs, ended, outs = wait(launch(f0, f1, out2, ck), 600)
        if rcs != [0] * SHARD_RANKS:
            raise AssertionError(f"{tag} relaunch exit codes {rcs}:\n"
                                 + "\n".join(o[-3000:] for o in outs))
        if not np.array_equal(read_flow(out2), sharded):
            raise AssertionError(f"{tag} the resumed flow differs from the "
                                 f"uninterrupted one")
        log(f"{tag} relaunched: resumed from level {state[1]} in "
            f"{max(ended):.1f} s, u/v/w bitwise the uninterrupted flow")
        out_res["resume_seconds"] = max(ended)


def main() -> None:
    if not (ROOT / "src" / "tpuflow3d_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: src/tpuflow3d_torch not found next "
                         "to this script; run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpuflow3d_torch import (PRESETS, compute_flow, graphs, kernels,
                                 synthetic as syn)
    from tpuflow3d_torch.derivatives import derivatives, grad_constancy_terms
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.kernels.median3 import median3 as k_median3
    from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor, sor_sweeps
    from tpuflow3d_torch.kernels.sor_gc import (
        sor_gc_sweeps, sor_halfsweep_gc as k_sor_gc)
    from tpuflow3d_torch.kernels.sor_gc_packed import (
        sor_halfsweep_gc_packed as k_sor_gc_packed,
        sor_halfsweep_gc_packed_plain)
    from tpuflow3d_torch.kernels.sor_packed import (
        pack_color, sor_halfsweep_packed as k_sor_packed,
        sor_halfsweep_packed_plain, unpack_colors)
    from tpuflow3d_torch.kernels.warp_grad import warp_grad as k_warp_grad
    from tpuflow3d_torch.median import median3
    from tpuflow3d_torch.mgsolver import _weights
    from tpuflow3d_torch.pipeline import compute_flow_impl, prepare_pyramids
    from tpuflow3d_torch.solver import compute_terms, parity_mask, sor_halfsweep
    from tpuflow3d_torch.utils import roofline
    from tpuflow3d_torch.warp import warp_volume

    # 1. The device.
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power_limit()
    log(f"[device] {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # 2. Build.
    fresh = not kernels.library_path().exists()
    t0 = time.perf_counter()
    kernels.load_library()
    log(f"[build] {'built' if fresh else 'found'} {kernels.library_path()} "
        f"in {time.perf_counter() - t0:.2f} s")
    summary = {}

    # The card's own rates, beside its data sheet's (utils/roofline.py).
    roofline_phase(torch, dev, card, summary)
    rates, sheet_bw, probed_bw = (ROOFLINE[k] for k in ("rates", "sheet_bw",
                                                        "probed_bw"))

    # 3. Each kernel against its plain version at the finest-level shapes.
    p = PRESETS["ladder256"]
    ctx = HaloCtx()
    t0 = time.perf_counter()
    i0, i1, true = syn.make_pair(SHAPE, syn.translation(SHIFT), seed=0)
    log(f"[data] 256^3 blob pair, translation {SHIFT}: "
        f"{time.perf_counter() - t0:.1f} s")
    pyr0, pyr1, _ = prepare_pyramids(torch.as_tensor(i0, device=dev),
                                     torch.as_tensor(i1, device=dev), p, ctx)
    v0, v1 = pyr0[0], pyr1[0]
    rng = np.random.default_rng(0)

    def cuda_rand(scale, shape, kind="normal"):
        a = (rng.uniform(-scale, scale, shape) if kind == "uniform"
             else rng.normal(size=shape) * scale)
        return torch.as_tensor(a.astype(np.float32), device=dev)

    def plain_warp_grad(flow, interp, emit):
        i1w = warp_volume(v1, flow, ctx, interp=interp)
        g, it = derivatives(v0, i1w, ctx)
        return (g, it, i1w) if emit else (g, it)

    # case -> (kernel, plain, bytes, elements[, needed bytes]): kernel and
    # plain each return the tensors to compare and are timed as one call of
    # the kernel's wrapper / plain version; bytes are the inputs read once
    # plus the outputs written once, elements what OPS counts per (updated
    # voxels, voxels, output values); needed bytes, for a flat sweep, are
    # those a half-sweep cannot do without. The part of a case's name
    # before the first "/" is its kernel; "bf16" marks the bfloat16-terms
    # instantiation, "sweep" the fused red+black sweep and "sweep3" three
    # of them in one wrapper call.
    n_vox = SHAPE[0] * SHAPE[1] * SHAPE[2]

    def run_cases(cases):
        for case, (kern, plain, nbytes, elements, *needed) in cases.items():
            parts = case.split("/")
            name, suffix = parts[0], "_bf16" if "bf16" in parts else ""
            prefix = next((part + "_" for part in parts
                           if part.startswith("sweep")), "")
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = compare(torch, name, got, ref)
            del got, ref
            ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
            b = roofline.bound(name, nbytes, elements, bw=sheet_bw,
                               rates=rates)
            b_probed = roofline.bound(name, nbytes, elements, bw=probed_bw,
                                      rates=rates)["bound_ms"]
            if nbytes / (1e-3 * ms) > probed_bw:
                log(f"[roofline] {case}: {nbytes / (1e-3 * ms):.6g} B/s, "
                    f"faster than the probed copy's {probed_bw:.6g} (a "
                    f"kernel that mostly reads can be)")
            extra = {}
            if needed:
                extra["needed_bytes_ms"] = 1e3 * needed[0] / sheet_bw
                note = (f"; needed {needed[0] / n_vox:.1f} B/voxel: "
                        f"{extra['needed_bytes_ms']:.3f} ms")
            elif name == "median3":
                extra["network_operations_ms"] = (
                    1e3 * roofline.MEDIAN3_NETWORK_OPS * elements
                    / rates["minmax"])
                note = (f"; its own network's {roofline.MEDIAN3_NETWORK_OPS} "
                        f"min/max "
                        f"{extra['network_operations_ms']:.3f} ms")
            else:
                note = ""
            log(f"[kernel] {case}: max |kernel - plain| {err:.3e} (atol "
                f"{TOLS[name][0]}), kernel {ms:.3f} ms, plain {plain_ms:.3f} "
                f"ms, bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
                f"({nbytes / n_vox:.1f} B/voxel: {b['bound_bytes_ms']:.3f} "
                f"ms; operations {b['bound_operations_ms']:.3f} ms{note}); "
                f"at the probed rate {b_probed:.3f} ms")
            # One entry per kernel: the worst error, and the times and the
            # bound of its first case (of its first bfloat16 case under
            # keys ending in _bf16; of the fused sweep and of three fused
            # sweeps under keys starting with sweep_ and sweep3_).
            entry = summary.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(err, entry["max_abs_err"])
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b["bound_ms"]),
                             ("bound_by", b["bound_by"]),
                             ("bound_bytes_ms", b["bound_bytes_ms"]),
                             ("bound_operations_ms",
                              b["bound_operations_ms"]),
                             ("bound_probed_ms", b_probed),
                             ("probed_bytes_per_s", probed_bw),
                             *extra.items()):
                entry.setdefault(prefix + key + suffix, val)

    # K2 and K5: the fused warps, on uniform random flows, on a smooth flow
    # within +-2 (the displacements `accurate` warps with, flow_clamp 2) and
    # on that flow with one voxel displaced by +40 (tests/torch_inputs.py
    # makes the same fields in numpy).
    flow6 = cuda_rand(6.0, (3, *SHAPE), "uniform")
    flow2 = cuda_rand(2.0, (3, *SHAPE), "uniform")
    axes = torch.meshgrid(*(torch.arange(n, device=dev, dtype=torch.float64)
                            for n in SHAPE), indexing="ij")
    smooth = torch.stack([1.9 * torch.sin(2 * torch.pi * (
        axes[2] / 23 + axes[1] / 31 + axes[0] / 37 + k / 3))
        for k in range(3)]).float()
    outlier = smooth.clone()
    outlier[:, SHAPE[0] // 2, SHAPE[1] // 2, SHAPE[2] // 2] = 40.0
    del axes
    warp_flows = {"2": flow2, "6": flow6, "smooth2": smooth,
                  "outlier": outlier}

    def warp_bytes(emit):
        return tensor_bytes(v1, flow6, v0) + (5 if emit else 4) * 4 * n_vox

    cases = {}
    for tag in ("6", "smooth2", "outlier"):
        for emit in (False, True) if tag == "6" else (False,):
            case = "/".join(["warp_grad"] + ([tag] if tag != "6" else [])
                            + (["emit"] if emit else []))
            cases[case] = (
                lambda fl=warp_flows[tag], emit=emit: k_warp_grad(
                    v1, fl, v0, ctx, emit_warped=emit),
                lambda fl=warp_flows[tag], emit=emit: plain_warp_grad(
                    fl, "trilinear", emit),
                warp_bytes(emit), n_vox)
    for tag in ("2", "6", "smooth2", "outlier"):
        for emit in (False, True) if tag in ("2", "6") else (False,):
            cases[f"warp_grad_tricubic/{tag}{'/emit' if emit else ''}"] = (
                lambda fl=warp_flows[tag], emit=emit: k_warp_grad(
                    v1, fl, v0, ctx, interp="tricubic", emit_warped=emit),
                lambda fl=warp_flows[tag], emit=emit: plain_warp_grad(
                    fl, "tricubic", emit),
                warp_bytes(emit), n_vox)
    run_cases(cases)
    # Which branch each slab (a block's 4 sample planes) took.
    for name, interp in (("warp_grad", "trilinear"),
                         ("warp_grad_tricubic", "tricubic")):
        for tag, fl in warp_flows.items():
            tiles = torch.zeros(2, dtype=torch.int32, device=dev)
            k_warp_grad(v1, fl, v0, ctx, interp=interp, tile_counts=tiles)
            staged, gathered = tiles.tolist()
            log(f"[tiles] {name}/{tag}: {staged} slabs gathered from a "
                f"staged box, {gathered} from device memory")
            summary[name].setdefault("slabs_staged_device_by_flow", {})[
                tag] = [staged, gathered]
    del cases, flow6, flow2, smooth, outlier, warp_flows, fl

    # The sweeps: K1 and K6 flat, K4 and K7 packed, on the same terms, stored
    # in float32 and in bfloat16.
    flow = cuda_rand(0.1, (3, *SHAPE))
    du = cuda_rand(0.05, (3, *SHAPE))
    i1w = warp_volume(v1, flow, ctx)
    g, it = derivatives(v0, i1w, ctx)
    gc = grad_constancy_terms(v0, i1w, ctx, g=g)
    pg = p.replace(gamma=1.0)
    parity = parity_mask(SHAPE, ctx, dev)
    # An anisotropic multigrid level's per-axis 1/h^2 scales.
    scale = (1.0, 0.25, 0.0625)

    def flat_bytes(*fields):
        """Bytes of one flat launch (a half-sweep, or the fused sweep) as
        its arguments have them (on one device no halo planes are passed),
        and the bytes a half-sweep needs: du and the output whole, psi_s
        (the first field) whole, the other fields for the active colour
        only."""
        whole = 2 * tensor_bytes(du)
        return (whole + tensor_bytes(*fields),
                whole + tensor_bytes(fields[0])
                + tensor_bytes(*fields[1:]) // 2)

    def plain_sweeps(tt, n):
        x = du
        for _ in range(n):
            for color in (0, 1):
                x = sor_halfsweep(x, tt, p.omega, parity, color, ctx)
        return [x]

    def in_turns(label, two_launch, fused, turns=3):
        """Median times of the fused sweep and of two single-colour launches,
        in turns (two, fused, fused, two) on this card."""
        times = {"two": [], "fused": []}
        for _ in range(turns):
            for key, fn in (("two", two_launch), ("fused", fused),
                            ("fused", fused), ("two", two_launch)):
                times[key].append(cuda_ms(torch, fn, reps=5, warmup=1))
        two, one = (statistics.median(times[k]) for k in ("two", "fused"))
        log(f"[sweep] {label}: two single-colour launches {two:.3f} ms, "
            f"fused sweep {one:.3f} ms, in {turns} turns")
        return two, one

    def packed_args(t, color):
        """The arguments of a packed half-sweep of ``color`` on du and the
        terms t: K7's when t carries ainv, else K4's."""
        other = 1 - color
        pk = lambda a, c: pack_color(a, c, 0)
        duo, pso = pk(du, other), pk(t.psi_s, other)
        mid, tail = ((t.c, t.g), (t.psi_d,)) if t.ainv is None else (
            (t.c, t.ainv), ())
        return (pk(du, color), duo, *(pk(a, color) for a in mid),
                pk(t.psi_s, color), pso, *(pk(a, color) for a in tail),
                *ctx.z_halo_planes(duo), *ctx.z_halo_planes(pso), 0, p.alpha,
                p.omega, color, SHAPE[0])

    for terms_dtype in ("float32", "bfloat16"):
        tag = "" if terms_dtype == "float32" else "/bf16"
        # The plain terms: the plain sweeps compared below read the weights,
        # which K8's route leaves out.
        pt = p.replace(terms_dtype=terms_dtype, backend="plain")
        terms = compute_terms(g, it, flow, du, pt, ctx)
        gterms = compute_terms(g, it, flow, du, pt.replace(gamma=1.0), ctx,
                               gc=gc)
        cases = {}
        nbytes, needed = flat_bytes(terms.psi_s, terms.c, terms.g,
                                    terms.psi_d)
        for color in (0, 1):
            cases[f"sor_halfsweep{tag}/{color}"] = (
                lambda c=color: [k_sor(du, terms, p.alpha, p.omega, c, ctx)],
                lambda c=color: [sor_halfsweep(du, terms, p.omega, parity, c,
                                               ctx)],
                nbytes, n_vox // 2, needed)
        for n in (1, 3):
            cases[f"sor_halfsweep{tag}/sweep{'' if n == 1 else n}"] = (
                lambda n=n: [sor_sweeps(du, terms, p.alpha, p.omega, n, ctx)],
                lambda n=n: plain_sweeps(terms, n), n * nbytes, n * n_vox)
        variants = [("iso", gterms, (p.alpha,) * 3)]
        if terms_dtype == "float32":
            aterms = gterms._replace(
                w=_weights(gterms.psi_s, scale, p.alpha, ctx)[0])
            variants.append(("aniso", aterms,
                             tuple(p.alpha * s for s in scale)))
        for vtag, tt, alphas in variants:
            nbytes, needed = flat_bytes(tt.psi_s, tt.c, tt.ainv)
            for color in (0, 1):
                cases[f"sor_gc{tag}/{vtag}/{color}"] = (
                    lambda c=color, tt=tt, al=alphas: [
                        k_sor_gc(du, tt, al, p.omega, c, ctx)],
                    lambda c=color, tt=tt: [sor_halfsweep(du, tt, p.omega,
                                                          parity, c, ctx)],
                    nbytes, n_vox // 2, needed)
            for n in (1, 3):
                cases[f"sor_gc{tag}/{vtag}/sweep{'' if n == 1 else n}"] = (
                    lambda n=n, tt=tt, al=alphas: [
                        sor_gc_sweeps(du, tt, al, p.omega, n, ctx)],
                    lambda n=n, tt=tt: plain_sweeps(tt, n), n * nbytes,
                    n * n_vox)
        run_cases(cases)
        al3 = (p.alpha,) * 3
        for name, two_launch, fused in (
                ("sor_halfsweep",
                 lambda: k_sor(k_sor(du, terms, p.alpha, p.omega, 0, ctx),
                               terms, p.alpha, p.omega, 1, ctx),
                 lambda: sor_sweeps(du, terms, p.alpha, p.omega, 1, ctx)),
                ("sor_gc",
                 lambda: k_sor_gc(k_sor_gc(du, gterms, al3, p.omega, 0, ctx),
                                  gterms, al3, p.omega, 1, ctx),
                 lambda: sor_gc_sweeps(du, gterms, al3, p.omega, 1, ctx))):
            two, one = in_turns(name + tag, two_launch, fused)
            sfx = "_bf16" if tag else ""
            summary[name]["sweep_two_launch_turns_ms" + sfx] = two
            summary[name]["sweep_turns_ms" + sfx] = one
        del cases, variants
        for name, tt, kern, plain in (
                ("sor_packed", terms, k_sor_packed, sor_halfsweep_packed_plain),
                ("sor_gc_packed", gterms, k_sor_gc_packed,
                 sor_halfsweep_gc_packed_plain)):
            for color in (0, 1):
                args = packed_args(tt, color)
                run_cases({f"{name}{tag}/{color}": (
                    lambda: [kern(*args)], lambda: [plain(*args)],
                    tensor_bytes(*args) + tensor_bytes(args[0]),
                    n_vox // 2)})
                # Null halo planes, what a whole volume passes: the kernel
                # replicates its faces in place, bitwise the same.
                nulls = args[:-9] + (None,) * 4 + args[-5:]
                if not torch.equal(kern(*nulls), kern(*args)):
                    raise AssertionError(f"{name}{tag}/{color}: null halo "
                                         f"planes differ from copied ones")
                ms_null = cuda_ms(torch, lambda: kern(*nulls))
                log(f"[kernel] {name}{tag}/{color}/null_planes: bitwise "
                    f"equal to the call with copied planes; {ms_null:.3f} ms")
                summary[name].setdefault("null_planes_ms" + tag.replace(
                    "/", "_"), ms_null)
                del args, nulls
        if terms_dtype == "float32":
            # What the packed layout pays per inner iteration: packing du
            # and the sweep constants for both colours, and one unpack.
            for name, fields in (
                    ("K4", (du, terms.c, terms.g, terms.psi_s, terms.psi_d)),
                    ("K7", (du, gterms.c, gterms.ainv, gterms.psi_s))):
                ms = cuda_ms(torch, lambda: [pack_color(a, c, 0)
                                             for c in (0, 1) for a in fields])
                log(f"[layout] pack_color of {len(fields)} fields ({name}: "
                    f"{tensor_bytes(*fields) / n_vox:.0f} B/voxel), both "
                    f"colours: {ms:.3f} ms")
            pair = [pack_color(du, c, 0) for c in (0, 1)]
            ms = cuda_ms(torch, lambda: unpack_colors(*pair, 0))
            log(f"[layout] unpack_colors of du: {ms:.3f} ms")
            if not torch.equal(unpack_colors(*pair, 0), du):
                raise AssertionError("unpack_colors(pack_color(du)) != du")
            del pair, aterms
            # K6's one-block form: the 16 coarse sweeps of a smoothing call
            # on a 16^3 system in one launch, against the plain half-sweeps
            # and, for its time, against 32 single-colour launches.
            cut = lambda a: a[..., :16, :16, :16].contiguous()
            small = cut(du)
            st = gterms._replace(c=cut(gterms.c), ainv=cut(gterms.ainv),
                                 psi_s=cut(gterms.psi_s))
            st = st._replace(w=_weights(st.psi_s, (1.0,) * 3, p.alpha,
                                        ctx)[0])
            spar = parity_mask((16, 16, 16), ctx, dev)
            ref = small
            for _ in range(16):
                for color in (0, 1):
                    ref = sor_halfsweep(ref, st, p.omega, spar, color, ctx)
            kernels.reset_launches()
            got = sor_gc_sweeps(small, st, al3, p.omega, 16, ctx)
            n_one = kernels.LAUNCHES["sor_gc"]
            torch.cuda.synchronize()
            err = compare(torch, "sor_gc", [got], [ref])
            if n_one != 1:
                raise AssertionError(f"one-block form: {n_one} launches")
            t_one = cuda_ms(torch, lambda: sor_gc_sweeps(small, st, al3,
                                                         p.omega, 16, ctx))

            def colour_by_colour():
                x = small
                for _ in range(16):
                    for color in (0, 1):
                        x = k_sor_gc(x, st, al3, p.omega, color, ctx)

            t_32 = cuda_ms(torch, colour_by_colour)
            log(f"[kernel] sor_gc/one_block: 16 sweeps at 16^3, max |kernel "
                f"- plain| {err:.3e}; one launch of one block {t_one:.4f} "
                f"ms, 32 single-colour launches {t_32:.4f} ms")
            summary["sor_gc"]["max_abs_err"] = max(
                err, summary["sor_gc"]["max_abs_err"])
            summary["sor_gc"]["one_block_16_sweeps_ms"] = t_one
            summary["sor_gc"]["single_colour_32_launches_at_16_cubed_ms"] = (
                t_32)
            del small, st, ref, got, spar
        del terms, gterms, tt
        # The last cases' tensors would stay allocated through the runs
        # whose device peaks are measured below.
        cases = variants = aterms = args = nulls = pair = fields = None
        torch.cuda.empty_cache()
    del flow, du, g, it, i1w, gc, parity

    # K3: the median (no halo planes on one device), its comparisons at the
    # min/max rate [roofline] probed.
    x = cuda_rand(1.0, (3, *SHAPE))
    xq = torch.round(x * 4.0) / 4.0  # quantized: many ties
    median_bytes = 2 * tensor_bytes(x)  # x read once, out written once
    run_cases({
        "median3": (lambda: [k_median3(x, ctx)], lambda: [median3(x, ctx)],
                    median_bytes, 3 * n_vox),
        "median3/ties": (lambda: [k_median3(xq, ctx)],
                         lambda: [median3(xq, ctx)], median_bytes,
                         3 * n_vox)})
    summary["median3"]["minmax_per_s"] = rates["minmax"]
    del x, xq
    del pyr0, pyr1, v0, v1
    torch.cuda.empty_cache()

    # 3b. K8, the rank-1 nonlinearity update.
    terms_phase(torch, dev, summary)
    terms_gc_phase(torch, dev, summary)
    mg_phase(torch, dev, summary)

    # 4-9. The main paths, each through the kernels, then plain.
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(SHAPE, 4)
    launches = {}
    for phase, (path, (preset, changes, expected, epe_limit)) in enumerate(
            PATHS.items(), start=4):
        pp = PRESETS[preset].replace(**changes)
        tag = f"[{phase}:{path}]"
        # The graphed compute_flow (graphs.py): its first call captures.
        kernels.reset_launches()
        t0 = time.perf_counter()
        f_auto, peak, base = device_peak(
            torch, dev, lambda: compute_flow(i0, i1, pp, device=dev))
        t_auto = time.perf_counter() - t0
        launches[path] = dict(kernels.LAUNCHES)
        check_incore_model(path, SHAPE, pp, peak, base, summary)
        # The eager driver on the same padded inputs (Z = 256 needs no
        # padding): bitwise the graphed flow, with the same launches.
        kernels.reset_launches()
        t0 = time.perf_counter()
        f_eager, peak_e, base_e = device_peak(
            torch, dev, lambda: compute_flow_impl(
                torch.as_tensor(i0, device=dev),
                torch.as_tensor(i1, device=dev), pp, HaloCtx()), clear=False)
        t_eager = time.perf_counter() - t0
        check_incore_model(f"{path} eager", SHAPE, pp, peak_e, base_e,
                           summary)
        if dict(kernels.LAUNCHES) != launches[path]:
            raise AssertionError(f"{path}: graphed launches {launches[path]}"
                                 f", eager {dict(kernels.LAUNCHES)}")
        if not torch.equal(f_auto, f_eager):
            raise AssertionError(f"{path}: the graphed flow differs from the "
                                 f"eager one by up to "
                                 f"{float((f_auto - f_eager).abs().max())}")
        del f_eager
        t0 = time.perf_counter()
        compute_flow(i0, i1, pp, device=dev)
        torch.cuda.synchronize(dev)
        t_warm = time.perf_counter() - t0
        (info,) = graphs.entries().values()
        log(f"{tag} graphed flow bitwise the eager compute_flow_impl's, "
            f"launches equal; first call {t_auto:.3f} s ({info['captures']} "
            f"graphs captured in {info['capture_seconds']:.3f} s), warm "
            f"{t_warm:.3f} s, eager {t_eager:.3f} s; static tensors "
            f"{info['static_bytes'] / 2 ** 30:.3f} GiB, pool "
            f"{info['pool_bytes'] / 2 ** 30:.3f} GiB")
        if path in ("ladder256", "accurate", "packed"):
            profile_split(torch, lambda: compute_flow(i0, i1, pp, device=dev))
        t0 = time.perf_counter()
        f_plain, peak_p, _ = device_peak(
            torch, dev, lambda: compute_flow(
                i0, i1, pp.replace(backend="plain"), device=dev))
        t_plain = time.perf_counter() - t0
        log(f"{tag} device peak of the plain run {peak_p / 2 ** 30:.3f} GiB "
            f"(not modelled: on the GPU the command line runs the kernels)")
        log(f"{tag} 256^3: kernels {t_warm:.2f} s (warm graphs), plain "
            f"{t_plain:.2f} s (first call, captures); launches "
            f"{launches[path]}")
        e2e_share(path, pp, t_warm, summary)
        check_launches(path, launches[path], expected)
        for f in (f_auto, f_plain):
            if tuple(f.shape) != (3, *SHAPE) or not bool(
                    torch.isfinite(f).all()):
                raise AssertionError(f"flow of shape {tuple(f.shape)} or "
                                     f"non-finite")
        diff = (f_auto - f_plain).abs()
        bad = int((diff > FLOW_ATOL + FLOW_RTOL * f_plain.abs()).sum())
        log(f"{tag} max |flow(kernels) - flow(plain)| "
            f"{float(diff.max()):.3e}, {bad} voxels past atol {FLOW_ATOL} "
            f"rtol {FLOW_RTOL}")
        if bad:
            raise AssertionError(f"{path}: kernel and plain flows disagree")
        e_auto = syn.epe(f_auto.cpu().numpy(), true, mask)
        e_plain = syn.epe(f_plain.cpu().numpy(), true, mask)
        log(f"{tag} mean EPE: kernels {e_auto:.6f}, plain {e_plain:.6f} "
            f"(limit {epe_limit})")
        if not (e_auto <= e_plain + 1e-3 and max(e_auto, e_plain)
                < epe_limit):
            raise AssertionError(f"{path}: EPE {e_auto} vs plain {e_plain}, "
                                 f"limit {epe_limit}")
        del f_auto, f_plain, f, diff
        graphs.clear()

    # 10. The two sweep layouts end to end, in turns on this card: host clock
    # around compute_flow from numpy volumes to a synchronized device.
    def wall(pp, label):
        """A warm call's wall time, after a first call (whose device peak
        the model is held to) captured its graphs."""
        _, peak, base = device_peak(
            torch, dev, lambda: compute_flow(i0, i1, pp, device=dev))
        check_incore_model(label, SHAPE, pp, peak, base, summary)
        t0 = time.perf_counter()
        compute_flow(i0, i1, pp, device=dev)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    for flat, packed in (("ladder256", "packed"), ("gamma", "packed_gamma")):
        pf, pk = (PRESETS[PATHS[k][0]].replace(**PATHS[k][1])
                  for k in (flat, packed))
        times = {flat: [], packed: []}
        for _ in range(LAYOUT_TURNS):
            for key, pp in ((flat, pf), (packed, pk), (packed, pk),
                            (flat, pf)):
                times[key].append(wall(pp, key))
        log(f"[10:layouts] {elapsed()} " + "; ".join(
            f"{key} median {statistics.median(ts):.4f} s (min "
            f"{min(ts):.4f}, max {max(ts):.4f}, {len(ts)} runs)"
            for key, ts in times.items()))
        for key, pp in ((flat, pf), (packed, pk)):
            e2e_share(f"{key} median of {len(times[key])}", pp,
                      statistics.median(times[key]), summary)
        torch.cuda.empty_cache()

    log("[roofline] " + json.dumps(summary.pop("roofline")))

    # 11-14. The streamed (out-of-core) paths.
    stream_phases(torch, i0, i1, true, mask, launches, summary)
    log("[stream] " + json.dumps(summary.pop("stream")))

    # 15. The command line.
    cli_phase(torch, i0, i1, true, mask, launches, summary)
    log("[cli] " + json.dumps(summary.pop("cli")))
    log("[mem] " + json.dumps(summary.pop("memory")))

    # 16. The Z-sharded paths, two ranks sharing the card.
    shard_phase(torch, i0, i1, true, mask, launches, summary)
    shard = summary.pop("shard")
    log("[shard] " + json.dumps(shard))

    # 17. The compiled dispatch: graphed against eager.
    graphs_phase(torch, i0, i1, summary)
    log("[graphs] " + json.dumps(summary.pop("graphs")))

    # 18. The streamed mode's graphs against its eager phases.
    stream_graphs_phase(torch, i0, i1, summary)
    log("[stream-graphs] " + json.dumps(summary.pop("stream_graphs")))

    def halo_entry(name):
        """K2/K5 in halo form: its launches on the sharded paths (both
        ranks), the largest |kernel - plain| the ranks measured on those
        paths, its time (the kernel alone on the card), the plain
        version's and the bound, from the first path that timed it."""
        timed = [t for p in shard["paths"].values()
                 for key, t in p["timings"].items()
                 if key.startswith(f"{name}/halo")]
        runs = {p: n[name] for p, n in launches.items()
                if p.startswith("shard:")}
        return {"name": f"{name} (halo form)", "route": "cuda",
                "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                "launches": sum(runs.values()), "launches_by_path": runs,
                "library_ms": None,
                "max_abs_err": max(p["halo_max_abs_err"][name]
                                   for p in shard["paths"].values()
                                   if name in p["halo_max_abs_err"]),
                **{k: timed[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "wrapper_ms",
                                            "slab", "halo_planes")},
                "bound_probed_ms": roofline.bound(
                    name, timed[0]["bytes"], timed[0]["elements"],
                    bw=probed_bw, rates=rates)["bound_ms"],
                "probed_bytes_per_s": probed_bw,
                "timed": timed}

    log(card)
    warps = ("warp_grad", "warp_grad_tricubic")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         **({"entry_source": SOURCES[name][2]} if len(SOURCES[name]) > 2
            else {}),
         # K2/K5's sharded launches are their halo form's (below).
         "launches": sum(n[name] for p, n in launches.items()
                         if not (name in warps and p.startswith("shard:"))),
         "launches_by_path": {
             path: n[name] for path, n in launches.items()
             if not (name in warps and path.startswith("shard:"))},
         # No single PyTorch call computes a red-black half-sweep, the fused
         # warp + derivatives or a 27-point median.
         "library_ms": None,
         **summary[name]} for name in SOURCES]
        + [halo_entry(name) for name in warps]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
