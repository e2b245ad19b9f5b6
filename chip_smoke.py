#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpuflow3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. Requires a CUDA device; prints the card's name and power limit and the
   torch and CUDA versions.
2. Builds the CUDA kernels from src/tpuflow3d_torch/csrc with nvcc.
3. Holds each kernel (K1 SOR half-sweep, K2 fused warp + derivatives, K3
   3x3x3 median) against its plain PyTorch version on the card at the
   finest-level shapes of the 256^3 ``ladder256`` run, and times both.
4. Drives the main path, ``tpuflow3d_torch.compute_flow`` with
   ``PRESETS["ladder256"]`` on a 256^3 blob translation, once through the
   kernels (backend "auto") and once plain; checks that every kernel was
   launched, that the two flows agree, and the EPE of each.

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
EPE_LIMIT = 0.03           # the JAX package measured 0.0179 here on a TPU
FLOW_ATOL, FLOW_RTOL = 2e-4, 1e-3
TOLS = {"sor_halfsweep": (5e-5, 1e-5), "warp_grad": (1e-5, 1e-5),
        "median3": (0.0, 0.0)}
SOURCES = {
    "sor_halfsweep": ("src/tpuflow3d_torch/csrc/sor.cu",
                      "src/tpuflow3d/pallas/sor.py:200"),
    "warp_grad": ("src/tpuflow3d_torch/csrc/warp_grad.cu",
                  "src/tpuflow3d/pallas/warp_grad.py:292"),
    "median3": ("src/tpuflow3d_torch/csrc/median3.cu",
                "src/tpuflow3d/pallas/median3.py:133"),
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
    from tpuflow3d_torch.derivatives import derivatives
    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.kernels.median3 import median3 as k_median3
    from tpuflow3d_torch.kernels.sor import sor_halfsweep as k_sor
    from tpuflow3d_torch.kernels.warp_grad import warp_grad as k_warp_grad
    from tpuflow3d_torch.median import median3
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

    # name -> (kernel, plain): each returns the tensors to compare and is
    # timed as one call of the kernel's wrapper / plain version.
    results = {}
    flow6 = cuda_rand(6.0, (3, *SHAPE), "uniform")
    results["warp_grad"] = (
        lambda: k_warp_grad(v1, flow6, v0, ctx),
        lambda: derivatives(v0, warp_volume(v1, flow6, ctx), ctx))

    flow = cuda_rand(0.1, (3, *SHAPE))
    du = cuda_rand(0.05, (3, *SHAPE))
    g, it = derivatives(v0, warp_volume(v1, flow, ctx), ctx)
    terms = compute_terms(g, it, flow, du, p, ctx)
    parity = parity_mask(SHAPE, ctx, dev)
    for color in (0, 1):
        results[f"sor_halfsweep/{color}"] = (
            lambda c=color: [k_sor(du, terms, p.alpha, p.omega, c, ctx)],
            lambda c=color: [sor_halfsweep(du, terms, p.omega, parity, c,
                                           ctx)])

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
    del results, flow6, flow, du, g, it, terms, x, xq, pyr0, pyr1, v0, v1
    torch.cuda.empty_cache()

    # 4. The main path: kernels, then plain.
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_auto = compute_flow(i0, i1, p, device=dev)
    torch.cuda.synchronize()
    t_auto = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    f_plain = compute_flow(i0, i1, p.replace(backend="plain"), device=dev)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    log(f"[main] ladder256 256^3: kernels {t_auto:.2f} s, plain "
        f"{t_plain:.2f} s; launches {launches}")

    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    for f in (f_auto, f_plain):
        if tuple(f.shape) != (3, *SHAPE) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"flow of shape {tuple(f.shape)} or "
                                 f"non-finite")
    diff = (f_auto - f_plain).abs()
    bad = int((diff > FLOW_ATOL + FLOW_RTOL * f_plain.abs()).sum())
    log(f"[main] max |flow(kernels) - flow(plain)| {float(diff.max()):.3e}, "
        f"{bad} voxels past atol {FLOW_ATOL} rtol {FLOW_RTOL}")
    if bad:
        raise AssertionError("kernel and plain flows disagree")
    mask = syn.gradient_mask(i0, 0.75) & syn.interior_mask(SHAPE, 4)
    e_auto = syn.epe(f_auto.cpu().numpy(), true, mask)
    e_plain = syn.epe(f_plain.cpu().numpy(), true, mask)
    log(f"[main] mean EPE: kernels {e_auto:.6f}, plain {e_plain:.6f} "
        f"(limit {EPE_LIMIT})")
    if not (e_auto <= e_plain + 1e-3 and e_auto < EPE_LIMIT):
        raise AssertionError(f"EPE {e_auto} vs plain {e_plain}, limit "
                             f"{EPE_LIMIT}")

    log(card)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **summary[name]} for name in SOURCES]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
