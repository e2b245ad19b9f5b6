"""End-to-end demo of the PyTorch port: synthesize a deformed volume pair,
recover the flow, and verify registration quality (examples/
demo_synthetic.py's counterpart, through ``tpuflow3d_torch``).

    python examples/demo_synthetic_torch.py [--size 64] [--sharded]
        [--piecewise] [--platform cpu|cuda]

Runs on the GPU unless ``--platform cpu`` is given; without a GPU and
without it, exits 2. ``--sharded`` puts one rank on each GPU (on the CPU,
two gloo ranks); ``--piecewise`` streams 16-plane Z-chunks through the
device.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--piecewise", action="store_true")
    ap.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                    help="where to run (default: the GPU)")
    args = ap.parse_args(argv)

    import torch

    from tpuflow3d_torch import FlowParams, compute_flow
    from tpuflow3d_torch import synthetic as syn
    from tpuflow3d_torch import volume as vio

    if args.platform != "cpu" and not torch.cuda.is_available():
        print("demo_synthetic_torch: no GPU (torch.cuda.is_available() is "
              "false); pass --platform cpu to run on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.platform == "cpu" else "cuda")

    shape = (args.size,) * 3
    print(f"synthesizing {shape} pair (sinusoidal deformation, "
          "dense texture)...")
    fn = syn.sinusoid(shape, amplitude=1.2)
    i0, i1, true = syn.make_pair(shape, fn, texture="fourier")

    p = FlowParams(levels=3, alpha=0.02, warps=3, inner_iterations=3,
                   sweeps=20)
    t0 = time.perf_counter()
    if args.sharded:
        from tpuflow3d_torch.sharding import compute_flow_sharded
        devices = ["cpu", "cpu"] if device.type == "cpu" else None
        flow = compute_flow_sharded(i0, i1, p, devices=devices).numpy()
    elif args.piecewise:
        from tpuflow3d_torch.piecewise import compute_flow_piecewise
        flow = compute_flow_piecewise(i0, i1, p, chunk_z=16, device=device)
    else:
        flow = compute_flow(i0, i1, p, device=device).cpu().numpy()
    dt = time.perf_counter() - t0

    mask = syn.interior_mask(shape, 4)
    err = syn.epe(flow, true, mask)
    print(f"solved in {dt:.1f}s  ->  mean EPE {err:.4f} voxels "
          f"(mean |s| = {np.sqrt((true ** 2).sum(0)).mean():.2f})")

    out = os.path.join(tempfile.mkdtemp(prefix="tpuflow3d_torch_"), "flow_")
    vio.write_flow(out, flow)
    print(f"flow components written to {out}{{u,v,w,magnitude}}.raw")
    return 0


if __name__ == "__main__":
    sys.exit(main())
