"""K7 wrapper: red-black SOR half-sweep of the general SPD system on
colour-packed arrays (``csrc/sor_gc_packed.cu``).

Replaces ``tpuflow3d/pallas/sor_gc_packed.py:sor_halfsweep_gc_packed``. The
layout is ``kernels/sor_packed.py``'s. Per half-sweep the kernel reads the
active colour's du, c, ainv and psi_s and the other colour's du and psi_s,
and writes the active du: 40 B per voxel of the full volume against the
flat K6's 64. It is the sweep of gamma > 0 on SOR; the multigrid levels
sweep flat (K6), as in the reference.

``sor_halfsweep_gc_packed`` takes the reference function's arguments,
launches the CUDA kernel for CUDA tensors and runs
``sor_halfsweep_gc_packed_plain`` for CPU tensors. Out-of-place.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.kernels.sor_packed import (check_packed, packed_rhs,
                                                plane_ptr)


def sor_halfsweep_gc_packed_plain(du_a, du_o, c_a, ainv_a, ps_a, ps_o,
                                  duo_lo, duo_hi, pso_lo, pso_hi, z0: int,
                                  alpha: float, omega: float, color: int,
                                  dg: int) -> torch.Tensor:
    """Plain version of K7: ``solver.sor_halfsweep`` with ``ainv`` on the
    packed arrays of ``color``, every element an update."""
    b, _ = packed_rhs(du_o, c_a, ps_a, ps_o, duo_lo, duo_hi, pso_lo, pso_hi,
                      z0, alpha, color, dg)
    a = ainv_a
    star = torch.stack([
        a[0] * b[0] + a[1] * b[1] + a[2] * b[2],
        a[1] * b[0] + a[3] * b[1] + a[4] * b[2],
        a[2] * b[0] + a[4] * b[1] + a[5] * b[2],
    ])
    return (1.0 - omega) * du_a + omega * star


def sor_halfsweep_gc_packed(du_a, du_o, c_a, ainv_a, ps_a, ps_o,
                            duo_lo, duo_hi, pso_lo, pso_hi, z0: int,
                            alpha: float, omega: float, color: int,
                            dg: int) -> torch.Tensor:
    """One half-sweep updating the packed ``color`` arrays of the general
    SPD system. du_a, du_o, c_a (3, D, H, WP); ainv_a (6, D, H, WP)
    float32; ps_a, ps_o (D, H, WP); duo_lo/duo_hi (3, 1, H, WP) and
    pso_lo/pso_hi (1, H, WP) are the OTHER colour's Z halo planes, or all
    four None for replicas of the slab's own faces; z0 is the global z of
    plane 0 and dg the global Z extent. c_a may be bfloat16. Returns the
    updated active-colour array: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if du_a.device.type == "cpu":
        return sor_halfsweep_gc_packed_plain(
            du_a, du_o, c_a, ainv_a, ps_a, ps_o, duo_lo, duo_hi, pso_lo,
            pso_hi, z0, alpha, omega, color, dg)
    if du_a.device.type != "cuda":
        raise RuntimeError(f"sor_halfsweep_gc_packed: no kernel for "
                           f"{du_a.device}")
    d, h, wp = check_packed(du_a, du_o, ps_a, ps_o, duo_lo, duo_hi, pso_lo,
                            pso_hi)
    dev = du_a.device
    td = kernels.terms_dtype(c_a)
    kernels.check_tensor("c_a", c_a, (3, d, h, wp), dev, td)
    kernels.check_tensor("ainv_a", ainv_a, (6, d, h, wp), dev)
    out = torch.empty_like(du_a)
    lib = kernels.load_library()
    half_alpha = float(np.float32(alpha)) * 0.5
    with torch.cuda.device(dev):
        kernels.launch(
            "sor_gc_packed", lib.tf3d_sor_halfsweep_gc_packed,
            du_a.data_ptr(), du_o.data_ptr(), c_a.data_ptr(),
            ainv_a.data_ptr(), ps_a.data_ptr(), ps_o.data_ptr(),
            plane_ptr(duo_lo), plane_ptr(duo_hi), plane_ptr(pso_lo),
            plane_ptr(pso_hi), out.data_ptr(), d, h, wp, int(z0), int(dg),
            half_alpha, omega, 1.0 - omega, int(color),
            int(td == torch.bfloat16), kernels.stream_handle(dev))
    return out
