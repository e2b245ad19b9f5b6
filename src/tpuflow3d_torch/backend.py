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


def unsupported(p: FlowParams, kernels: bool) -> list[str]:
    """The settings of ``p`` this port does not serve yet, each naming its
    ROADMAP item; ``kernels`` says whether the CUDA kernels would run."""
    missing = []
    if p.deriv_order != 2:
        missing.append("deriv_order=4 (ROADMAP queue 1, item 4)")
    if p.dtype != "float32" or p.terms_dtype != "float32":
        missing.append(f"dtype={p.dtype!r}, terms_dtype={p.terms_dtype!r} "
                       f"(ROADMAP queue 1, item 5)")
    # The reference sweeps packed only on its SOR path (the multigrid
    # smoother is always flat), so only that needs the packed kernels.
    if p.sweep_layout == "packed" and p.solver == "sor" and kernels:
        k = "K7" if p.gamma > 0.0 else "K4"
        missing.append(f"sweep_layout='packed' with solver='sor' on CUDA "
                       f"(ROADMAP queue 2, {k})")
    return missing


def check_supported(p: FlowParams, x: torch.Tensor) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for every
    setting this port does not serve yet (none is served by another path)."""
    missing = unsupported(p, use_kernels(p, x))
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
