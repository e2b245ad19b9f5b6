#!/usr/bin/env python3
"""Device-memory peaks of the port on one NVIDIA GPU, beside the model of
``tpuflow3d_torch.utils.memory``.

    python3 tools/torch_memory_peaks.py [--out build/memory_peaks.json]

For each configuration, in-core (``compute_flow``, two warps: the peak is
reached from the second warp on; its first call on the card, which
captures the CUDA graphs of ``graphs.py``, no graphs held before it, with
the entry's static and pool bytes after it) at 256^3 and, for the
heaviest, 512^3;
then streamed (``compute_flow_piecewise``, one warp over two levels: the
peak is the finest level's; its first call on the card, which captures
the streamed graphs, with the entry's arena and pool bytes after it) at
256^3 with chunks of 32 and 128 planes:
the allocated peak (``torch.cuda.max_memory_allocated`` beyond what was
allocated before the run, the cache emptied first), the reserved peak,
and the model's bytes (``incore_peak_bytes`` / ``streamed_peak_bytes``).
Inputs are a smoothed random volume and its shift, made on the card from
a seed. One JSON line per run; exits 1 if the model is below an allocated
peak, or below what a run's graphs hold after it (static and pool
bytes). Needs a CUDA device; imports nothing of JAX.

``--phases`` measures instead what the streamed model is made of: each
phase function of ``piecewise`` (``_ph_*``) wrapped to record the
allocated peak inside its call (its slab inputs and the chunk before's
results included), the phases called eagerly, printed per finest-level
phase as float32 fields per slab plane, and the coarse V-cycle's as
float32 fields per coarse voxel of ``mgsolver.mg_shapes``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "memory_peaks.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", action="store_true",
                    help="per-phase peaks of the streamed runs instead")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_memory_peaks.py: no CUDA device")
    from tpuflow3d_torch import PRESETS, compute_flow, graphs, kernels
    from tpuflow3d_torch.piecewise import compute_flow_piecewise
    from tpuflow3d_torch.utils import memory as mem

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.load_library()

    def pair(n):
        g = torch.Generator(device=dev).manual_seed(args.seed)
        x = torch.randn((1, 1, n, n, n), generator=g, device=dev)
        x = torch.nn.functional.avg_pool3d(x, 5, 1, 2)[0, 0]
        i1 = torch.roll(x, (1, -1, 1), (0, 1, 2))
        return x.cpu().numpy(), i1.cpu().numpy()

    def peak(run):
        graphs.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        base_r = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        return (torch.cuda.max_memory_allocated(dev) - base,
                torch.cuda.max_memory_reserved(dev) - base_r,
                time.perf_counter() - t0)

    lad, acc = PRESETS["ladder256"], PRESETS["accurate"]
    bf = dict(terms_dtype="bfloat16")
    incore = {
        "ladder256": lad, "bf16": lad.replace(**bf),
        "jacobi": lad.replace(solver="jacobi"),
        "order4": lad.replace(deriv_order=4),
        "tricubic": lad.replace(interp="tricubic"),
        "packed": lad.replace(sweep_layout="packed"),
        "packed_bf16": lad.replace(sweep_layout="packed", **bf),
        "gamma": lad.replace(gamma=1.0),
        "gamma_bf16": lad.replace(gamma=1.0, **bf),
        "packed_gamma": lad.replace(sweep_layout="packed", gamma=1.0),
        "packed_gamma_bf16": lad.replace(sweep_layout="packed", gamma=1.0,
                                         **bf),
        "multigrid": lad.replace(solver="multigrid", mg_cycles=3),
        "accurate": acc, "accurate-bf16": PRESETS["accurate-bf16"],
        "mg_gamma": acc.replace(gamma=1.0),
    }
    big = {"ladder512": PRESETS["ladder512"], "accurate": acc,
           "gamma": lad.replace(gamma=1.0),
           "packed": lad.replace(sweep_layout="packed")}
    c4 = dict(flow_clamp=4.0)
    streamed = {
        "ladder256": lad.replace(**c4), "bf16": lad.replace(**c4, **bf),
        "tricubic": lad.replace(interp="tricubic", **c4),
        "order4": lad.replace(deriv_order=4, **c4),
        "jacobi": lad.replace(solver="jacobi", **c4),
        "gamma": lad.replace(gamma=1.0, **c4),
        "gamma_bf16": lad.replace(gamma=1.0, **c4, **bf),
        "fused": lad.replace(inner_iterations=1, **c4),
        "fused_gamma": lad.replace(inner_iterations=1, gamma=1.0, **c4),
        "fused_order4": lad.replace(inner_iterations=1, deriv_order=4, **c4),
        "multigrid": lad.replace(solver="multigrid", mg_cycles=3, **c4),
        "accurate": acc, "mg_gamma": acc.replace(gamma=1.0),
    }
    if args.phases:
        return phase_peaks(torch, dev, pair(256), streamed, args.out)
    rows, under = [], []

    def held(row):
        """The graphs' static and pool bytes after the run, into ``row``."""
        (entry,) = graphs.entries().values()
        row.update(graph_static_bytes=entry["static_bytes"],
                   graph_pool_bytes=entry["pool_bytes"],
                   graph_held_bytes=entry["static_bytes"]
                   + entry["pool_bytes"])
        return row

    def record(row):
        print(json.dumps(row), flush=True)
        rows.append(row)
        if row["model_bytes"] < max(row["peak_bytes"],
                                    row.get("graph_held_bytes", 0)):
            under.append(row)

    for n, configs in ((256, incore), (512, big)):
        i0, i1 = pair(n)
        for name, p in configs.items():
            p = p.replace(warps=2)
            a, r, s = peak(lambda: compute_flow(i0, i1, p, device=dev))
            record(held({"run": "incore", "config": name, "n": n,
                         "peak_bytes": a, "reserved_bytes": r, "seconds": s,
                         "model_bytes": mem.incore_peak_bytes((n,) * 3, p)}))
        del i0, i1
    i0, i1 = pair(256)
    for name, p in streamed.items():
        p = p.replace(warps=1, levels=2)
        for chunk in (32, 128):
            a, r, s = peak(lambda: compute_flow_piecewise(
                i0, i1, p, chunk_z=chunk, device=dev))
            record(held({"run": "streamed", "config": name, "n": 256,
                         "chunk": chunk, "peak_bytes": a,
                         "reserved_bytes": r, "seconds": s,
                         "model_bytes": mem.streamed_peak_bytes(
                             (256,) * 3, p, chunk)}))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": card, "rows": rows}, indent=1))
    ratios = [r["model_bytes"] / max(r["peak_bytes"], r["graph_held_bytes"])
              for r in rows]
    print(f"{card}: {len(rows)} runs, model/max(peak, held) "
          f"{min(ratios):.3f}-{max(ratios):.3f}; {len(under)} below the "
          f"peak or the graphs' bytes", flush=True)
    return 1 if under else 0


def phase_peaks(torch, dev, pair, configs, out) -> int:
    """The allocated peak inside each streamed phase (``--phases``)."""
    import numpy as np

    from tpuflow3d_torch import piecewise as pw
    from tpuflow3d_torch.mgsolver import mg_shapes

    seen = {}

    def wrap(name, fn):
        def recorded(*a, **k):
            t = next(x for x in a if isinstance(x, torch.Tensor))
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            result = fn(*a, **k)
            torch.cuda.synchronize(dev)
            key = (name, t.shape[-3], t.shape[-2] * t.shape[-1])
            seen[key] = max(seen.get(key, 0),
                            torch.cuda.max_memory_allocated(dev))
            return result
        return recorded

    for name in [n for n in dir(pw) if n.startswith("_ph_")]:
        setattr(pw, name, wrap(name, getattr(pw, name)))
    i0, i1 = pair
    coarse = sum(int(np.prod(s)) for s in mg_shapes(i0.shape, 1)[1:])
    rows = []
    for config, p in configs.items():
        for chunk in (32, 128):
            seen.clear()
            torch.cuda.empty_cache()
            pw.compute_flow_piecewise(i0, i1, p.replace(warps=1, levels=2),
                                      chunk_z=chunk, device=dev, eager=True)
            for (name, planes, plane), peak in sorted(seen.items()):
                row = {"run": "phase", "config": config, "chunk": chunk,
                       "phase": name, "slab_planes": planes,
                       "peak_bytes": peak}
                fine = i0.shape[1] * i0.shape[2]
                if name == "_ph_coarse_vcycle":
                    row["fields_per_coarse_voxel"] = peak / (4 * coarse)
                elif plane == fine:
                    row["fields_per_slab_plane"] = peak / (4 * plane
                                                           * planes)
                elif name == "_ph_resample" and 4 * plane == fine:
                    # the flow brought up to the finest level: per output
                    # plane of the chunk
                    row["fields_per_fine_output_plane"] = peak / (
                        4 * fine * chunk)
                else:
                    continue  # a coarser pyramid level
                print(json.dumps(row), flush=True)
                rows.append(row)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps({"rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
