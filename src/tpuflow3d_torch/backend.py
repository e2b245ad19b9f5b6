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


def unsupported(p: FlowParams) -> list[str]:
    """The settings of ``p`` this port does not serve, each saying why, on
    the kernel route and the plain one alike. One device serves every
    float32 solve the reference serves: both sweep layouts, float32 or
    bfloat16 term storage, stencils of order 2 and 4."""
    missing = []
    if p.dtype != "float32":
        missing.append(
            f"dtype={p.dtype!r}: float32 is the reference's only solver "
            f"dtype (it documents no other and has no test or record of "
            f"one), and every kernel computes in float32; bfloat16 is "
            f"served as storage of the sweep constants, "
            f"terms_dtype='bfloat16'")
    if p.terms_dtype not in ("float32", "bfloat16"):
        missing.append(
            f"terms_dtype={p.terms_dtype!r}: the sweep kernels read c and "
            f"g stored in float32 or bfloat16")
    return missing


def check_supported(p: FlowParams, x: torch.Tensor) -> None:
    """Raise NotImplementedError for every setting this port does not
    serve (none is served by another path), and RuntimeError where the
    backend cannot run on ``x``'s device."""
    use_kernels(p, x)
    missing = unsupported(p)
    if missing:
        raise NotImplementedError("not served: " + "; ".join(missing))
