"""Dispatch between the hand-written CUDA kernels and their plain versions.

``backend="auto"`` launches the kernels for CUDA tensors and runs the plain
PyTorch versions for CPU tensors; ``"kernels"`` requires CUDA tensors;
``"plain"`` runs the plain versions on any device (the reference a kernel
run is compared with). There is no fallback: a kernel that fails to build
or launch raises.
"""

from __future__ import annotations

import torch

from tpuflow3d_torch.params import FlowParams


def use_kernels(p: FlowParams, x: torch.Tensor) -> bool:
    """Whether the op on ``x`` runs its CUDA kernel (True) or its plain
    version (False)."""
    if p.backend == "plain":
        return False
    if x.device.type == "cuda":
        return True
    if p.backend == "kernels":
        raise RuntimeError(f"backend='kernels' needs CUDA tensors, got a "
                           f"tensor on {x.device}")
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"backend='auto' has no kernels for {x.device}; "
                       f"pass backend='plain' to run the plain versions")


def check_supported(p: FlowParams, x: torch.Tensor) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for every
    setting this port does not serve yet (none is served by another path)."""
    missing = []
    if p.solver == "multigrid":
        missing.append("solver='multigrid' (ROADMAP queue 1, item 9)")
    if p.interp != "trilinear":
        missing.append(f"interp={p.interp!r} (ROADMAP queue 2, K5)")
    if p.gamma > 0.0:
        missing.append("gamma > 0 (ROADMAP queue 2, K6)")
    if p.deriv_order != 2:
        missing.append("deriv_order=4 (ROADMAP queue 1, item 4)")
    if p.dtype != "float32" or p.terms_dtype != "float32":
        missing.append(f"dtype={p.dtype!r}, terms_dtype={p.terms_dtype!r} "
                       f"(ROADMAP queue 1, item 5)")
    if p.sweep_layout == "packed" and use_kernels(p, x):
        missing.append("sweep_layout='packed' on CUDA (ROADMAP queue 2, K4)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
