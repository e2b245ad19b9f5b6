#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpuflow3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Requires a CUDA device; prints the card's name and power limit and the
   torch and CUDA versions.
2. Builds the CUDA kernels from src/tpuflow3d_torch/csrc with nvcc (one
   nvcc per source, started together).
3. Holds each kernel against its plain PyTorch version on the card at the
   finest-level shapes of the 256^3 runs, and times both: K1 SOR
   half-sweep; K2 fused trilinear warp + derivatives, with and without the
   warped volume; K3 3x3x3 median; K5 fused tricubic warp + derivatives at
   flows +-2 and +-6, with and without the warped volume; K6 general-SPD
   SOR half-sweep on gradient-constancy terms, with (alpha, alpha, alpha)
   and with an anisotropic multigrid triple.
4. Drives ``tpuflow3d_torch.compute_flow`` with ``PRESETS["ladder256"]`` on
   a 256^3 blob translation, once through the kernels (backend "auto") and
   once plain; checks that the path's kernels (K1, K2, K3) and no other
   were launched, that the two flows agree, and the EPE of each.
5. The same for ``PRESETS["accurate"]`` (multigrid, tricubic, early stop;
   K5, K6 and K3) on the same pair, with EPE < 1e-3 on both runs, and a
   torch.profiler split of a second kernel run: device busy and idle, and
   the device time by kernel.
6. The same for ``PRESETS["ladder256"]`` with gamma = 1 (gradient
   constancy on SOR: K2 emitting the warped volume, K6, K3).

Every failure raises, so the exit code is non-zero. The last two lines are
a JSON summary of the kernels and {"ok": true, "device": {...}}. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (256, 256, 256)
SHIFT = (1.5, -1.0, 0.75)
FLOW_ATOL, FLOW_RTOL = 2e-4, 1e-3
TOLS = {"sor_halfsweep": (5e-5, 1e-5), "warp_grad": (1e-5, 1e-5),
        "median3": (0.0, 0.0), "warp_grad_tricubic": (1e-5, 1e-5),
        "sor_gc": (5e-5, 1e-5)}
SOURCES = {
    "sor_halfsweep": ("src/tpuflow3d_torch/csrc/sor.cu",
                      "src/tpuflow3d/pallas/sor.py:200"),
    "warp_grad": ("src/tpuflow3d_torch/csrc/warp_grad.cu",
                  "src/tpuflow3d/pallas/warp_grad.py:292"),
    "median3": ("src/tpuflow3d_torch/csrc/median3.cu",
                "src/tpuflow3d/pallas/median3.py:133"),
    "warp_grad_tricubic": ("src/tpuflow3d_torch/csrc/warp_grad.cu",
                           "src/tpuflow3d/pallas/warp_grad.py:292"),
    "sor_gc": ("src/tpuflow3d_torch/csrc/sor_gc.cu",
               "src/tpuflow3d/pallas/sor_gc.py:95"),
}
# kernel -> a part of its device function's name in a profiler trace.
KERNEL_SYMBOLS = {"sor_halfsweep": "::sor_halfsweep_kernel(",
                  "warp_grad": "::warp_grad_kernel<false>",
                  "median3": "::median3_kernel(",
                  "warp_grad_tricubic": "::warp_grad_kernel<true>",
                  "sor_gc": "::sor_halfsweep_gc_kernel("}
# path -> (preset, changes, the kernels it must launch, EPE limit). The
# JAX package's TPU records: ladder256 0.0179 on its bench input; accurate
# 3.4e-4 and its accuracy gate 1e-3.
PATHS = {
    "ladder256": ("ladder256", {}, {"sor_halfsweep", "warp_grad", "median3"},
                  0.03),
    "accurate": ("accurate", {}, {"warp_grad_tricubic", "sor_gc", "median3"},
                 1e-3),
    "gamma": ("ladder256", {"gamma": 1.0}, {"warp_grad", "sor_gc", "median3"},
              0.03),
}


def log(*a):
    print(*a, flush=True)


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
        hits = [v for name, v in by_name.items() if symbol in name]
        t, n = sum(v[0] for v in hits), sum(v[1] for v in hits)
        log(f"[profile]   {kernel}: {t / 1e3:.2f} ms, {100 * t / busy:.1f}% "
            f"of busy, {n} launches")


def main() -> None:
    if not (ROOT / "src" / "tpuflow3d_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: src/tpuflow3d_torch not found next "
                         "to this script; run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
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
    from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
    from tpuflow3d_torch.kernels.sor_gc import sor_halfsweep_gc as k_sor_gc
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

    # name -> (kernel, plain): each returns the tensors to compare and is
    # timed as one call of the kernel's wrapper / plain version.
    results = {}
    flow6 = cuda_rand(6.0, (3, *SHAPE), "uniform")
    flow2 = cuda_rand(2.0, (3, *SHAPE), "uniform")
    results["warp_grad"] = (
        lambda: k_warp_grad(v1, flow6, v0, ctx),
        lambda: plain_warp_grad(flow6, "trilinear", False))
    results["warp_grad/emit"] = (
        lambda: k_warp_grad(v1, flow6, v0, ctx, emit_warped=True),
        lambda: plain_warp_grad(flow6, "trilinear", True))
    for tag, fl in (("2", flow2), ("6", flow6)):
        for emit in (False, True):
            results[f"warp_grad_tricubic/{tag}{'/emit' if emit else ''}"] = (
                lambda fl=fl, emit=emit: k_warp_grad(
                    v1, fl, v0, ctx, interp="tricubic", emit_warped=emit),
                lambda fl=fl, emit=emit: plain_warp_grad(fl, "tricubic",
                                                         emit))

    flow = cuda_rand(0.1, (3, *SHAPE))
    du = cuda_rand(0.05, (3, *SHAPE))
    i1w = warp_volume(v1, flow, ctx)
    g, it = derivatives(v0, i1w, ctx)
    terms = compute_terms(g, it, flow, du, p, ctx)
    parity = parity_mask(SHAPE, ctx, dev)
    for color in (0, 1):
        results[f"sor_halfsweep/{color}"] = (
            lambda c=color: [k_sor(du, terms, p.alpha, p.omega, c, ctx)],
            lambda c=color: [sor_halfsweep(du, terms, p.omega, parity, c,
                                           ctx)])

    pg = p.replace(gamma=1.0)
    gterms = compute_terms(g, it, flow, du, pg, ctx,
                           gc=grad_constancy_terms(v0, i1w, ctx, g=g))
    # An anisotropic multigrid level's per-axis 1/h^2 scales.
    scale = (1.0, 0.25, 0.0625)
    aterms = gterms._replace(w=_weights(gterms.psi_s, scale, p.alpha, ctx)[0])
    for tag, tt, alphas in (
            ("iso", gterms, (p.alpha,) * 3),
            ("aniso", aterms, tuple(p.alpha * s for s in scale))):
        for color in (0, 1):
            results[f"sor_gc/{tag}/{color}"] = (
                lambda c=color, tt=tt, al=alphas: [
                    k_sor_gc(du, tt, al, p.omega, c, ctx)],
                lambda c=color, tt=tt: [sor_halfsweep(du, tt, p.omega,
                                                      parity, c, ctx)])

    x = cuda_rand(1.0, (3, *SHAPE))
    xq = torch.round(x * 4.0) / 4.0  # quantized: many ties
    results["median3"] = (lambda: [k_median3(x, ctx)],
                          lambda: [median3(x, ctx)])
    results["median3/ties"] = (lambda: [k_median3(xq, ctx)],
                               lambda: [median3(xq, ctx)])

    summary = {}
    for case, (kern, plain) in results.items():
        name = case.split("/")[0]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = compare(torch, name, got, ref)
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        log(f"[kernel] {case}: max |kernel - plain| {err:.3e} (atol "
            f"{TOLS[name][0]}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if name in summary:  # one entry per kernel: the worst error
            err = max(err, summary[name]["max_abs_err"])
            ms, plain_ms = summary[name]["ms"], summary[name]["plain_ms"]
        summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    del (results, flow6, flow2, flow, du, g, it, i1w, terms, gterms, aterms,
         x, xq, pyr0, pyr1, v0, v1)
    torch.cuda.empty_cache()

    # 4-6. The main paths, each through the kernels, then plain.
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(SHAPE, 4)
    launches = {}
    for phase, (path, (preset, changes, expected, epe_limit)) in enumerate(
            PATHS.items(), start=4):
        pp = PRESETS[preset].replace(**changes)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_auto = compute_flow(i0, i1, pp, device=dev)
        torch.cuda.synchronize()
        t_auto = time.perf_counter() - t0
        launches[path] = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        f_plain = compute_flow(i0, i1, pp.replace(backend="plain"),
                               device=dev)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        tag = f"[{phase}:{path}]"
        log(f"{tag} 256^3: kernels {t_auto:.2f} s, plain {t_plain:.2f} s; "
            f"launches {launches[path]}")
        ran = {k for k, n in launches[path].items() if n > 0}
        if ran != expected:
            raise AssertionError(f"{path} launched {sorted(ran)}, expected "
                                 f"{sorted(expected)}")
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
        del f_auto, f_plain, diff
        if path == "accurate":
            profile_split(torch, lambda: compute_flow(i0, i1, pp, device=dev))
        torch.cuda.empty_cache()

    log(card)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(launches[path][name] for path in PATHS),
         "launches_by_path": {path: launches[path][name] for path in PATHS},
         **summary[name]} for name in SOURCES]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
