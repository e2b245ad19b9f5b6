"""How far the JAX package's own Z-sharded flow lies from its one-device
flow, beside the port's: the evidence for the port's sharded warp sampling
at global coordinates where the reference clips in the slab's frame.

For each size N it makes the blob pair of ``chip_smoke.py`` (translation
(1.5, -1.0, 0.75), seed 0) at N^3 and runs the ``accurate`` preset through
``prepare_params(., 2)``:

- the JAX package's ``compute_flow`` and ``compute_flow_sharded`` on two
  virtual CPU devices;
- the port's ``compute_flow`` and ``compute_flow_sharded`` on two gloo
  ranks on the CPU;

and prints, per N, the largest |sharded - one device| of each package and
the voxels past the reference's gate (atol 2e-4, rtol 1e-3,
tests/test_sharding.py), and the largest |port - JAX| of the one-device
flows and of the sharded ones. Run from the repository's root:

    python tests/torch_reference_gap.py 64 96

(minutes on the CPU: each JAX run of ``accurate`` takes about a minute at
64^3).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = (2e-4, 1e-3)
SHIFT = (1.5, -1.0, 0.75)


def gap(a, b):
    import numpy as np
    d = np.abs(a - b)
    return float(d.max()), int((d > GATE[0] + GATE[1] * np.abs(b)).sum())


def main(sizes) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from tpuflow3d import compute_flow as ref_flow
    from tpuflow3d import synthetic as rsyn
    from tpuflow3d.params import PRESETS as RPRESETS
    from tpuflow3d.sharding import compute_flow_sharded as ref_sharded
    from tpuflow3d.sharding import make_z_mesh
    from tpuflow3d.sharding import prepare_params as ref_prepare
    from tpuflow3d_torch import PRESETS, compute_flow
    from tpuflow3d_torch.sharding import compute_flow_sharded, prepare_params

    torch.set_num_threads(4)
    for n in sizes:
        i0, i1, _ = rsyn.make_pair((n,) * 3, rsyn.translation(SHIFT), seed=0)
        rp = ref_prepare(RPRESETS["accurate"], 2)
        p = prepare_params(PRESETS["accurate"], 2)
        t0 = time.perf_counter()
        j1 = np.asarray(ref_flow(i0, i1, rp))
        j2 = np.asarray(ref_sharded(i0, i1, rp, mesh=make_z_mesh(2)))
        t1 = time.perf_counter()
        t1d = compute_flow(i0, i1, p, device="cpu").numpy()
        t2 = compute_flow_sharded(i0, i1, p, devices=["cpu", "cpu"]).numpy()
        t2s = time.perf_counter()
        jg, tg = gap(j2, j1), gap(t2, t1d)
        print(f"{n}^3 accurate, 2 shards: JAX sharded - one device max "
              f"{jg[0]:.6e}, {jg[1]} voxels past the gate; port sharded - "
              f"one device max {tg[0]:.6e}, {tg[1]} past; port - JAX one "
              f"device max {float(np.abs(t1d - j1).max()):.6e}, sharded "
              f"{float(np.abs(t2 - j2).max()):.6e} (JAX {t1 - t0:.1f} s, "
              f"port {t2s - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64, 96])
