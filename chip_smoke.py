#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpuflow3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Requires a CUDA device; prints the card's name and power limit and the
   torch and CUDA versions.
2. Builds the CUDA kernels from src/tpuflow3d_torch/csrc with nvcc (one
   nvcc per source, started together).
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
   beside the floor of its own selection network at the min/max rate a
   short probe measures on this card; K6 general-SPD
   SOR sweeps (the same forms) on gradient-constancy terms, with (alpha,
   alpha, alpha) and with an anisotropic multigrid triple, and its
   one-block form on a 16^3 system; K4 and K7, the colour-packed
   forms of K1 and K6, at (3, 256, 256, 128), with copied halo planes and
   with null ones (bitwise the same); and the bfloat16-terms
   instantiations of K1, K4, K6 and K7 on the same terms stored in
   bfloat16. Beside each time stands the kernel's bound: the least time
   the card could take, the larger of its bytes (inputs read once, outputs
   written once) over 3.35 TB/s and the operations the function needs over
   the card's float32 rate. For a flat single-colour launch also the bytes
   a half-sweep needs (the inactive colour's c, g or ainv and psi_d left
   out). The fused sweep and two single-colour launches are timed in turns.
   Also times pack_color and unpack_colors, the overhead of the packed layout
   per inner iteration.
4. Drives ``tpuflow3d_torch.compute_flow`` with ``PRESETS["ladder256"]`` on
   a 256^3 blob translation, once through the kernels (backend "auto") and
   once plain; checks that the path's kernels (K1, K2, K3) and no other
   were launched (K1 exactly 900 times: one fused launch per sweep), that
   the two flows agree, and the EPE of each; then the torch.profiler split
   of a second kernel run: device busy and idle, the device activities and
   the device time by kernel.
5. The same for ``PRESETS["accurate"]`` (multigrid, tricubic, early stop;
   K5, K6 and K3) on the same pair, with EPE < 1e-3 on both runs, and the
   profiler split.
6. The same for ``PRESETS["ladder256"]`` with gamma = 1 (gradient
   constancy on SOR: K2 emitting the warped volume, K6 729 times (one
   launch per sweep, one per inner iteration on the 16^3 level), K3).
7. The same for ``PRESETS["ladder256"]`` with ``sweep_layout="packed"``
   (the reference's default layout: K4 in place of K1, 1800 launches).
8. The same with gamma = 1 as well (K7 in place of K6, 1800 launches).
9. The same for ``PRESETS["accurate-bf16"]`` (``accurate`` with c and g
   stored in bfloat16: K5, the bfloat16 K6, K3), EPE < 1e-3 on both runs.
10. Times the flat and the packed layout end to end in turns (flat, packed,
   packed, flat; three turns), with and without gamma, and prints the
   median of each; the packed path also gets the profiler split.
11-14. The out-of-core mode, ``piecewise.compute_flow_piecewise`` with
   64-plane chunks. Before each path runs, ``[window:<path>]`` holds the
   kernels in the forms that path gives them, on every level of its own
   pyramid: K2/K5 on its warp slab, K1/K6 one colour on its trapezoid or
   fused slab (its omega, its system: the terms made by its own phases),
   K3 on its median slab (the fused pass's clamped-global gather), each at
   its first, an interior and its last z0, bitwise against the plain
   version, and timed beside the bound on the finest level; the run then
   records every form it launches and fails if one was not held so.
   ``ladder256`` (flow clamp 4) through the kernels against plain (exactly
   K1, K2, K3; K1 5040 times), with the profiler split, then with a
   checkpoint directory and resumed from it (``[stream:ladder256]``); one
   inner iteration, the fused pass against the phases, their gap at 64^3,
   128^3 and 256^3, and a fault planted in the fused pass that the gate
   must reject (``[stream:fused]``); ``ladder512`` at 512^3, the full
   width, the pair made on the card, against in-core, with the phase
   times, both device peaks and the host's memory
   (``[stream:ladder512]``); ``accurate`` at 256^3 against in-core
   (``[stream:accurate]``). The streamed-vs-in-core gate is the JAX
   package's (max |diff| < 5e-2, mean < 1e-2, |dEPE| < 0.02).
15. The command line, ``tpuflow3d_torch.cli``, at 256^3 (``[15:cli]``):
   frames i0, i1, i0 written as uint16 raws with sidecars (the native IO
   library required); the series with tracking, derived fields, VTK,
   statistics, fit and timings in this process (exactly K1 1800, K2 30,
   K3 30; pair 0 bitwise ``compute_flow`` on the widened frames; EPE; the
   tracks back at their seeds; the VTK flow equal to the raws); the pair
   through ``python -m tpuflow3d_torch.cli`` as a process (bitwise pair
   0); auto mode under a 1 GiB budget (``TPUFLOW_DEVICE_BYTES``, and the
   caching allocator capped at it) for ``ladder256`` and ``accurate``:
   first the window forms of ``pick_chunk_z``'s chunk (48 and 43, the
   last chunk ragged) bitwise against plain, then the run, piecewise with
   that chunk, every form it launched held so, the device peak within
   the budget, the streamed-vs-in-core gate; ``--apply-flow`` bitwise
   ``warp_volume`` and no kernel launched; ``--check-consistency``
   (exactly K1 1800, K2 30, K3 30).

Every in-core run through the kernels (phases 4-10, 12-15) prints its
device peak (``torch.cuda.max_memory_allocated`` beyond what was allocated
before it) beside ``utils.memory.incore_peak_bytes``, and every streamed
run its peak beside ``utils.memory.streamed_peak_bytes`` for its chunk
(``[mem]``); each fails if the model is below the peak.

Every failure raises, so the exit code is non-zero. The last two lines are
a JSON summary of the kernels and {"ok": true, "device": {...}}. Imports
nothing of JAX.
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
        "sor_gc_packed": (5e-5, 1e-5)}
# The card's peaks (NVIDIA's H100 SXM data sheet): device memory and
# float32 arithmetic outside the tensor cores.
PEAK_BYTES_PER_S, PEAK_FLOP_PER_S = 3.35e12, 67e12
# kernel -> (operations the function needs per output element, the card's
# rate for them). The sweeps per updated voxel (six neighbours at 9, or 8
# without the weight sum, plus the point solve) and the fused warps per
# voxel (coordinates, taps, stencils; one sample per voxel) are
# multiplications and additions, rated at the FMA peak, which counts two
# per instruction. The median per output value: 39 comparisons, the proven
# least that select the median of 27 values (n + min(t - 1, n - t) - 1 for
# the t-th of n; Blum, Floyd, Pratt, Rivest, Tarjan 1973), one per
# instruction, at the min/max rate the probe measures (the rate below, one
# per lane and clock, is replaced by it). Neighbouring voxels share 18 of
# their 27 values, so shared work could only lower that count: bytes bound
# the median either way.
OPS = {"sor_halfsweep": (86, PEAK_FLOP_PER_S),
       "sor_packed": (86, PEAK_FLOP_PER_S),
       "sor_gc": (72, PEAK_FLOP_PER_S),
       "sor_gc_packed": (72, PEAK_FLOP_PER_S),
       "warp_grad": (40, PEAK_FLOP_PER_S),
       "warp_grad_tricubic": (265, PEAK_FLOP_PER_S),
       "median3": (39, PEAK_FLOP_PER_S / 2)}
# What csrc/median3.cu's selection network executes per output value: min
# and max instructions of the separable network (sorted rows, merged 3x3
# blocks shared by two rows and three planes, one merge of two planes
# shared by two output planes, an 18-instruction selection), counted in the
# kernel's machine code: 336 FMNMX a loop step, which yields 4 output
# values, and a step without outputs that starts each 64-plane chunk:
# (33 * 336 - 168) / 128 = 85.3. Not part of the bound (a cheaper
# selection computes the same function); printed beside it.
MEDIAN3_NETWORK_OPS = 85.3
# A throughput probe of fminf/fmaxf: 16 values a thread, compare-exchanged
# in two alternating layers (30 min/max per iteration, 8 independent pairs
# a layer), built with the kernels' flags.
MINMAX_PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void minmax_probe(float* out, int iters) {
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = (threadIdx.x * 16 + k) * 1e-3f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; k += 2) {
      const float a = v[k], b = v[k + 1];
      v[k] = fminf(a, b);
      v[k + 1] = fmaxf(a, b);
    }
#pragma unroll
    for (int k = 1; k < 15; k += 2) {
      const float a = v[k], b = v[k + 1];
      v[k] = fminf(a, b);
      v[k + 1] = fmaxf(a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += v[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int minmax_probe_launch(float* out, int blocks, int iters,
                                   void* stream) {
  minmax_probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
MINMAX_PER_ITER = 30
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
    "sor_gc_packed": r"::sor_halfsweep_gc_packed_kernel<"}
# path -> (preset, changes, the kernels it must launch, EPE limit). A kernel
# maps to the launch count the path must show exactly, or to None for any
# count above 0; 900 is 5 levels (all of even W) x 3 warps x 3 inner
# iterations x 20 sweeps, one fused red+black launch each, and 1800 the same
# x 2 colours. K6 runs the 20 sweeps of an inner iteration on the coarsest
# level (16^3 = 4096 voxels) in one launch of one block: 4 x 180 + 9 = 729.
# The JAX package's TPU records:
# ladder256 0.0179 on its bench input; accurate 3.4e-4 and its accuracy
# gate 1e-3.
PATHS = {
    "ladder256": ("ladder256", {},
                  {"sor_halfsweep": 900, "warp_grad": None, "median3": None},
                  0.03),
    "accurate": ("accurate", {},
                 {"warp_grad_tricubic": None, "sor_gc": None,
                  "median3": None}, 1e-3),
    "gamma": ("ladder256", {"gamma": 1.0},
              {"warp_grad": None, "sor_gc": 729, "median3": None}, 0.03),
    "packed": ("ladder256", {"sweep_layout": "packed"},
               {"sor_packed": 1800, "warp_grad": None, "median3": None},
               0.03),
    "packed_gamma": ("ladder256", {"sweep_layout": "packed", "gamma": 1.0},
                     {"sor_gc_packed": 1800, "warp_grad": None,
                      "median3": None}, 0.03),
    "accurate-bf16": ("accurate-bf16", {},
                      {"warp_grad_tricubic": None, "sor_gc": None,
                       "median3": None}, 1e-3),
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
                         "median3": None}, 1e-3),
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
    """Median device time of fn() in ms, one CUDA-event pair per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors among the arguments (None and scalars skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def bound(name: str, nbytes: int, elements: int) -> dict:
    """The least time the card could take for a kernel's work: its bytes
    over the memory rate or the operations it needs over their rate,
    whichever is larger."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops, rate = OPS[name]
    by_ops = 1e3 * ops * elements / rate
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_operations_ms": by_ops,
            "bytes": nbytes}


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


def minmax_rate(torch, kernels, dev) -> float:
    """fminf/fmaxf per second on this card: the probe built with nvcc and
    the kernels' flags, 8 blocks per SM of 256 threads, timed with CUDA
    events."""
    import ctypes
    src = kernels.BUILD_DIR / "minmax_probe.cu"
    lib_path = kernels.BUILD_DIR / "libminmax_probe.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(MINMAX_PROBE_SRC)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(src)], check=True, timeout=300)
    fn = ctypes.CDLL(str(lib_path)).minmax_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    iters = 4096
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        if fn(out.data_ptr(), blocks, iters, stream) != 0:
            raise RuntimeError("minmax probe: launch failed")

    ms = cuda_ms(torch, run)
    return blocks * 256 * iters * MINMAX_PER_ITER / (ms * 1e-3)


def profile_split(torch, run) -> None:
    """Run ``run`` once under torch.profiler (device activity only) and
    print the device's busy and idle share of the span, the device time
    of the kernels that took the most, and that of each ported kernel."""
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
def recording_forms(forms: set):
    """For the length of the block, wrap the wrappers of the kernels that
    the streamed mode runs on slabs (K1 and K6 one colour, K2/K5, K3) so
    that each call adds its form to ``forms``: (kernel, slab shape, omega)
    for a sweep, (kernel, slab shape, emit) for a warp, (kernel, shape)
    for the median. The wrapped functions count their launches as
    before; the mode imports the wrappers at the call."""
    from tpuflow3d_torch.kernels import median3 as m3, sor as k1, sor_gc as k6
    from tpuflow3d_torch.kernels import warp_grad as kw

    def warp_key(i1, flow, i0, ctx=None, interp="trilinear",
                 emit_warped=False, **_):
        name = "warp_grad_tricubic" if interp == "tricubic" else "warp_grad"
        return name, tuple(i1.shape), bool(emit_warped)

    keys = {(k1, "sor_halfsweep"): lambda du, t, alpha, omega, *_, **__: (
                "sor_halfsweep", tuple(du.shape), float(omega)),
            (k6, "sor_halfsweep_gc"): lambda du, t, alpha, omega, *_, **__: (
                "sor_gc", tuple(du.shape), float(omega)),
            (kw, "warp_grad"): warp_key,
            (m3, "median3"): lambda x, *_, **__: ("median3", tuple(x.shape))}
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
    ``checked``. On the finest level, at the interior z0, each is timed
    beside its bound. ``all_forms`` adds, on the finest level, K5 and K2
    with and without the warped volume and K6 on gradient-constancy terms
    on the same slabs."""
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

    def timed(name, what, kern, plain, nbytes, elements, key):
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        b = bound(name, nbytes, elements)
        log(f"[window:{label}] {what}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms by "
            f"{b['bound_by']}")
        summary[name].setdefault("window", {})[f"{label} {key}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"]}

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

                        def kern():
                            return k_warp_grad(i1s, fls, i0s, wctx,
                                               interp=interp,
                                               emit_warped=emit)

                        def plain():
                            i1w = warp_volume(i1s, fls, wctx, interp=interp)
                            g, it = derivatives(i0s, i1w, wctx)
                            return (g, it, i1w) if emit else (g, it)

                        what = f"{name} {at}{', emit' if emit else ''}"
                        same(what, kern(), plain())
                        checked.add((name, (planes, h, w), emit))
                        if time_it:
                            timed(name, what, kern, plain,
                                  4 * n * (5 + (5 if emit else 4)), n,
                                  f"{at}{'/emit' if emit else ''}")
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
                            def kern(color=color, t=t):
                                if name == "sor_halfsweep":
                                    return k_sor(du, t, p.alpha, omega,
                                                 color, wctx)
                                return k_sor_gc(du, t, (p.alpha,) * 3, omega,
                                                color, wctx)

                            def plain(color=color, t=t):
                                return sor_halfsweep(du, t, omega, parity,
                                                     color, wctx)

                            what = (f"{name} ({sysname}, omega {omega}) {at} "
                                    f"colour {color}")
                            same(what, kern(), plain())
                            if time_it:
                                # The arguments, the output, 4 halo planes.
                                timed(name, what, kern, plain,
                                      tensor_bytes(du, *fields)
                                      + tensor_bytes(du) + 16 * h * w, n // 2,
                                      f"{at}/colour{color}")
                        checked.add((name, (3, planes, h, w), float(omega)))
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


def device_peak(torch, dev, run):
    """Run ``run``; return (its result, the device bytes allocated at its
    peak beyond those allocated before it, those bytes)."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = run()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base, base


def check_incore_model(label, shape, p, peak, base, summary) -> None:
    """Print an in-core run's device peak beside utils.memory's model; raise
    if the model is below it (the auto choice would then send a volume
    in-core that runs out of memory)."""
    from tpuflow3d_torch.utils import memory as mem
    model = mem.incore_peak_bytes(shape, p)
    log(f"[mem] {label} in-core {shape}: device peak "
        f"{peak / 2 ** 30:.3f} GiB (beyond {base / 2 ** 30:.3f} GiB "
        f"allocated before), model {model / 2 ** 30:.3f} GiB, model/peak "
        f"{model / peak:.3f}")
    summary.setdefault("memory", {}).setdefault(label, []).append(
        {"shape": list(shape), "peak_bytes": peak, "model_bytes": model})
    if model < peak:
        raise AssertionError(f"{label}: memory.incore_peak_bytes "
                             f"{model} below the measured peak {peak}")


def log_streamed_model(label, shape, p, chunk, peak, base, summary) -> None:
    """Print a streamed run's device peak beside the footprint the model of
    pick_chunk_z gives for its chunk; raise if the model is below it (the
    chunk pick_chunk_z chooses would then run out of memory)."""
    from tpuflow3d_torch.utils import memory as mem
    model = mem.streamed_peak_bytes(shape, p, chunk)
    log(f"[mem] {label} streamed {shape}, chunks of {chunk}: device peak "
        f"{peak / 2 ** 30:.3f} GiB (beyond {base / 2 ** 30:.3f} GiB "
        f"allocated before), model {model / 2 ** 30:.3f} GiB, model/peak "
        f"{model / peak:.3f}")
    summary.setdefault("memory", {}).setdefault(label, []).append(
        {"shape": list(shape), "chunk": chunk, "peak_bytes": peak,
         "model_bytes": model})
    if model < peak:
        raise AssertionError(f"{label}: memory.streamed_peak_bytes {model} "
                             f"below the measured peak {peak}")


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

    from tpuflow3d_torch import PRESETS, compute_flow, kernels
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

    def streamed(label, pp, pair=(i0, i1), **kw):
        """One streamed run: (flow, wall s, launches, device peak bytes);
        the kernel forms it launches go into ``forms``."""
        kernels.reset_launches()
        t0 = time.perf_counter()
        with recording_forms(forms):
            f, peak, base = device_peak(
                torch, dev, lambda: compute_flow_piecewise(
                    *pair, pp, chunk_z=STREAM_CHUNK, device=dev, **kw))
        wall = time.perf_counter() - t0
        if f.shape != (3, *pair[0].shape) or not np.isfinite(f).all():
            raise AssertionError(f"{label}: flow of shape {f.shape} or "
                                 f"non-finite")
        if pp.backend != "plain" and kw.get("fuse", True):
            log_streamed_model(label, pair[0].shape, pp, STREAM_CHUNK, peak,
                               base, summary)
        return f, wall, dict(kernels.LAUNCHES), peak

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
    summary["stream"] = {path: {"kernels_s": t_k, "plain_s": t_p,
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

    def shifted(i0s, i1s, fls, carry, *rest):
        return real(i0s, i1s, fls, torch.cat([carry[:, 1:], carry[:, -1:]],
                                             1), *rest)

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
    summary["stream"][path] = {"fused_s": t_f, "phases_s": t_u,
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
    f_s, t_s, launches[path], peak_s = streamed(path, pp)
    check_launches(path, launches[path], STREAM_PATHS[path][2])
    check_forms(path, forms, checked)
    f_c, t_c, peak_c = incore(pp, label=path)
    e_s = syn.epe(f_s, true, mask)
    e_c = syn.epe(f_c.cpu().numpy(), true, mask)
    log(f"{tag} {elapsed()} 256^3: streamed {t_s:.2f} s (device peak "
        f"{peak_s / 2 ** 30:.2f} GiB, launches {launches[path]}), in-core "
        f"{t_c:.2f} s (device peak {peak_c / 2 ** 30:.2f} GiB)")
    mx, mean = stream_gate(torch, tag, f_s, f_c, e_s, e_c,
                           STREAM_PATHS[path][3])
    summary["stream"][path] = {
        "streamed_s": t_s, "incore_s": t_c, "device_peak_streamed_bytes":
        peak_s, "device_peak_incore_bytes": peak_c, "max_abs": mx,
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
            "sor_halfsweep": 1800, "warp_grad": 30, "median3": 30})
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
                                  "sor_gc": None, "median3": None}, 1e-3)):
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
            "sor_halfsweep": 1800, "warp_grad": 30, "median3": 30})
        err = vio.read_raw(f"{out_c}consistency.raw")
        med = float(np.median(err[8:-8, 8:-8, 8:-8]))
        log(f"{tag} {elapsed()} --check-consistency {wall:.2f} s: interior "
            f"median {med:.5f} voxel (limit 0.25), mean {float(err.mean()):.5f}")
        if med >= 0.25:
            raise AssertionError(f"{tag} consistency median {med}")
        res.update(consistency_median=med)
    torch.cuda.empty_cache()


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

    from tpuflow3d_torch import PRESETS, compute_flow, kernels, synthetic as syn
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
    from tpuflow3d_torch.pipeline import prepare_pyramids
    from tpuflow3d_torch.solver import compute_terms, parity_mask, sor_halfsweep
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
    summary = {}

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
            b = bound(name, nbytes, elements)
            extra = {}
            if needed:
                extra["needed_bytes_ms"] = 1e3 * needed[0] / PEAK_BYTES_PER_S
                note = (f"; needed {needed[0] / n_vox:.1f} B/voxel: "
                        f"{extra['needed_bytes_ms']:.3f} ms")
            elif name == "median3":
                extra["network_operations_ms"] = (
                    1e3 * MEDIAN3_NETWORK_OPS * elements / OPS[name][1])
                note = (f"; its own network's {MEDIAN3_NETWORK_OPS} min/max "
                        f"{extra['network_operations_ms']:.3f} ms")
            else:
                note = ""
            log(f"[kernel] {case}: max |kernel - plain| {err:.3e} (atol "
                f"{TOLS[name][0]}), kernel {ms:.3f} ms, plain {plain_ms:.3f} "
                f"ms, bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
                f"({nbytes / n_vox:.1f} B/voxel: {b['bound_bytes_ms']:.3f} "
                f"ms; operations {b['bound_operations_ms']:.3f} ms{note})")
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
                              b["bound_operations_ms"]), *extra.items()):
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
        pt = p.replace(terms_dtype=terms_dtype)
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

    # K3: the median (no halo planes on one device), and the rate of the
    # min/max that its selection network is made of.
    mm_rate = minmax_rate(torch, kernels, dev)
    log(f"[probe] fminf/fmaxf: {mm_rate / 1e12:.2f} T/s on this card (the "
        f"bound's assumption: {OPS['median3'][1] / 1e12:.2f})")
    OPS["median3"] = (OPS["median3"][0], mm_rate)
    x = cuda_rand(1.0, (3, *SHAPE))
    xq = torch.round(x * 4.0) / 4.0  # quantized: many ties
    median_bytes = 2 * tensor_bytes(x)  # x read once, out written once
    run_cases({
        "median3": (lambda: [k_median3(x, ctx)], lambda: [median3(x, ctx)],
                    median_bytes, 3 * n_vox),
        "median3/ties": (lambda: [k_median3(xq, ctx)],
                         lambda: [median3(xq, ctx)], median_bytes,
                         3 * n_vox)})
    summary["median3"]["minmax_per_s"] = mm_rate
    del x, xq
    del pyr0, pyr1, v0, v1
    torch.cuda.empty_cache()

    # 4-9. The main paths, each through the kernels, then plain.
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(SHAPE, 4)
    launches = {}
    for phase, (path, (preset, changes, expected, epe_limit)) in enumerate(
            PATHS.items(), start=4):
        pp = PRESETS[preset].replace(**changes)
        kernels.reset_launches()
        t0 = time.perf_counter()
        f_auto, peak, base = device_peak(
            torch, dev, lambda: compute_flow(i0, i1, pp, device=dev))
        t_auto = time.perf_counter() - t0
        launches[path] = dict(kernels.LAUNCHES)
        check_incore_model(path, SHAPE, pp, peak, base, summary)
        t0 = time.perf_counter()
        f_plain, peak_p, _ = device_peak(
            torch, dev, lambda: compute_flow(
                i0, i1, pp.replace(backend="plain"), device=dev))
        t_plain = time.perf_counter() - t0
        tag = f"[{phase}:{path}]"
        log(f"{tag} device peak of the plain run {peak_p / 2 ** 30:.3f} GiB "
            f"(not modelled: on the GPU the command line runs the kernels)")
        log(f"{tag} 256^3: kernels {t_auto:.2f} s, plain {t_plain:.2f} s; "
            f"launches {launches[path]}")
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
        if path in ("ladder256", "accurate", "packed"):
            profile_split(torch, lambda: compute_flow(i0, i1, pp, device=dev))
        torch.cuda.empty_cache()

    # 10. The two sweep layouts end to end, in turns on this card: host clock
    # around compute_flow from numpy volumes to a synchronized device.
    def wall(pp, label):
        t0 = time.perf_counter()
        _, peak, base = device_peak(
            torch, dev, lambda: compute_flow(i0, i1, pp, device=dev))
        t = time.perf_counter() - t0
        check_incore_model(label, SHAPE, pp, peak, base, summary)
        return t

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
        torch.cuda.empty_cache()

    # 11-14. The streamed (out-of-core) paths.
    stream_phases(torch, i0, i1, true, mask, launches, summary)
    log("[stream] " + json.dumps(summary.pop("stream")))

    # 15. The command line.
    cli_phase(torch, i0, i1, true, mask, launches, summary)
    log("[cli] " + json.dumps(summary.pop("cli")))
    log("[mem] " + json.dumps(summary.pop("memory")))

    log(card)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         **({"entry_source": SOURCES[name][2]} if len(SOURCES[name]) > 2
            else {}),
         "launches": sum(n[name] for n in launches.values()),
         "launches_by_path": {path: n[name] for path, n in launches.items()},
         # No single PyTorch call computes a red-black half-sweep, the fused
         # warp + derivatives or a 27-point median.
         "library_ms": None,
         **summary[name]} for name in SOURCES]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
