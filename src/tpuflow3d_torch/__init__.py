"""tpuflow3d_torch - dense 3D optical flow in PyTorch, with CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``tpuflow3d`` (which stays the reference):
variational coarse-to-fine 3D optical flow with red-black SOR on the
linearized Euler-Lagrange system. One module per reference module; the
reference's Pallas TPU kernels become hand-written CUDA C++ kernels under
``csrc/``, built with nvcc at first use and bound through ctypes
(``kernels/``). Every kernel has a plain PyTorch version beside it, which
runs on CPU tensors and is what the kernel is tested against.

This package imports neither jax nor tpuflow3d.
"""

from tpuflow3d_torch.params import PRESETS, FlowParams
from tpuflow3d_torch.pipeline import compute_flow

__all__ = ["FlowParams", "PRESETS", "compute_flow"]
