"""Op registry: the catalog of the port's device ops.

Port of ``tpuflow3d.ops.registry``: one entry per device op, with the same
names, Z-halo rules and reference counterparts, so ``--list-ops`` prints
the same catalog. ``fn`` is the function the port's pipeline calls (a
kernel's wrapper where the op has a CUDA kernel: it runs the kernel on
CUDA tensors and the plain version on CPU tensors). ``bytes_per_voxel`` is
the least traffic of one call: each input read once and each output
written once, per voxel of the volume, float32 (bfloat16 where a variant
says so); the kernels' counts come from ``utils/roofline.py``, from which
``chip_smoke.py`` takes its bounds too. Compute never dispatches through
strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpuflow3d_torch import derivatives as _derivatives
from tpuflow3d_torch import pyramid as _pyramid
from tpuflow3d_torch import warp as _warp
from tpuflow3d_torch.kernels import median3 as _k_median3
from tpuflow3d_torch.kernels import sor as _k_sor
from tpuflow3d_torch.kernels import warp_grad as _k_warp_grad
from tpuflow3d_torch.utils.roofline import (MEDIAN3_BYTES_PER_VOXEL,
                                            TERMS_BYTES_PER_VOXEL,
                                            TERMS_GC_BYTES_PER_VOXEL,
                                            WARP_BYTES_PER_VOXEL,
                                            SweepByteModel)


@dataclass(frozen=True)
class OpSpec:
    """One device op: function, Z-halo need, and its bytes per voxel per
    call (inputs read once, outputs written once)."""
    name: str
    fn: Callable
    z_halo: str              # human-readable margin rule
    bytes_per_voxel: float   # the form the pipeline runs by default
    reference: str           # counterpart op in cuda-flow3d
    doc: str = ""
    # The other forms of the op, where they move other bytes.
    byte_variants: dict | None = None


OPS: dict[str, OpSpec] = {}


def _register(spec: OpSpec) -> None:
    OPS[spec.name] = spec


def get_op(name: str) -> OpSpec:
    return OPS[name]


_register(OpSpec(
    name="convolution",
    fn=_pyramid.smooth,
    z_halo="kernel radius = ceil(3*sigma)",
    bytes_per_voxel=8.0,  # read the volume, write it (plain PyTorch)
    reference="CudaOperationConvolution3D",
    doc="Separable Gaussian smoothing (presmooth + pyramid antialias)."))

_register(OpSpec(
    name="resample",
    fn=_pyramid.resize3,
    z_halo="ceil(in/out) + 1 planes",
    bytes_per_voxel=8.0,
    reference="CudaOperationResample3D",
    doc="Trilinear resample at arbitrary scale; flow upsample scales values "
        "by the per-axis dim ratio."))

_register(OpSpec(
    name="registration",
    fn=_warp.warp_volume,
    z_halo="ceil(max |flow_z|) + 1 planes (+1 for tricubic)",
    bytes_per_voxel=4 + 12 + 4,  # read I1 + 3 flow comps, write warped
    byte_variants={"trilinear": 4 + 12 + 4, "tricubic": 4 + 12 + 4},
    reference="CudaOperationRegistration",
    doc="Backward warp of the moving volume by the current flow: trilinear "
        "(reference behavior) or tricubic Catmull-Rom (params.interp). "
        "Plain PyTorch (the fused warp + derivatives below is the kernel)."))

_register(OpSpec(
    name="warp_derivatives",
    fn=_k_warp_grad.warp_grad,
    z_halo="ceil(max |flow_z|) + 1 planes (+1 tricubic)",
    bytes_per_voxel=WARP_BYTES_PER_VOXEL[False],
    reference="registration + derivative kernels (one fused pass here)",
    doc="Fused backward warp + spatiotemporal derivative stencils in one "
        "pass: K2 (trilinear), K5 (tricubic Catmull-Rom, 64 taps a "
        "sample), csrc/warp_grad.cu. With emit_warped (gamma > 0) it also "
        "writes the warped volume.",
    byte_variants={f"{interp}{', warped volume too' if emit else ''}":
                   float(WARP_BYTES_PER_VOXEL[emit])
                   for interp in ("trilinear", "tricubic")
                   for emit in (False, True)}))

_register(OpSpec(
    name="derivatives",
    fn=_derivatives.derivatives,
    z_halo="1 plane",
    bytes_per_voxel=8 + 12 + 4,  # read I0,I1w; write g(3)+It
    reference="derivative stencil kernels (part of solve pipeline)",
    doc="Spatiotemporal central-difference stencils on (I0 + warped I1)/2 "
        "(plain PyTorch; order 4 runs this route)."))

_register(OpSpec(
    name="grad_constancy",
    fn=_derivatives.grad_constancy_terms,
    z_halo="2 planes (two chained central diffs; 4 at deriv_order=4)",
    bytes_per_voxel=8 + 36 + 12,  # read I0,I1w; write gc_g(9)+gc_it(3)
    reference="none (capability extension: Brox 2004 gradient constancy; "
              "active when params.gamma > 0)",
    doc="Second-derivative linearization terms of the gradient-constancy "
        "assumption; feeds the full symmetric 3x3 point solve "
        "(solver.SolveTerms.ainv)."))


def _solve_bytes(packed: bool, terms_bytes: int = 4, gc: bool = False) -> float:
    """Bytes per voxel of one launch of a sweep kernel, from the byte
    model of utils/roofline.py: a fused red+black sweep of the flat layout;
    a half-sweep of the packed one, with the copied halo planes of a
    256-plane volume (16/256 B, as chip_smoke.py's packed cases pass
    them)."""
    m = SweepByteModel(packed=packed, terms_bytes=terms_bytes, gc=gc)
    return m.per_half_sweep + m.halo_plane_bytes(256) if packed else \
        m.per_sweep


_register(OpSpec(
    name="solve",
    fn=_k_sor.sor_halfsweep,
    z_halo="1 plane per half-sweep",
    bytes_per_voxel=_solve_bytes(packed=False),
    reference="CudaOperationSolve3D",
    doc="Red-black SOR on the coupled Euler-Lagrange system "
        "(Sherman-Morrison pointwise solve). bytes_per_voxel is one sweep "
        "of the flat layout, the port's default; the variants are the "
        "packed layout (K4, K7: per half-sweep of the packed arrays, per "
        "voxel of the volume) and the general SPD system of gamma > 0 and "
        "multigrid (K6, K7), and the nonlinearity update that precedes "
        "each inner iteration's sweeps (K8 on a whole volume with gamma = 0, "
        "K9 with gamma > 0 and SOR; their plain versions elsewhere).",
    byte_variants={
        "flat sweep (K1)": _solve_bytes(False),
        "flat sweep, bf16 terms": _solve_bytes(False, 2),
        "packed half-sweep (K4)": _solve_bytes(True),
        "packed half-sweep, bf16 terms": _solve_bytes(True, 2),
        "gc flat sweep (K6, gamma > 0, multigrid)": _solve_bytes(False,
                                                                 gc=True),
        "gc flat sweep, bf16 terms": _solve_bytes(False, 2, gc=True),
        "gc packed half-sweep (K7)": _solve_bytes(True, gc=True),
        "gc packed half-sweep, bf16 terms": _solve_bytes(True, 2, gc=True),
        "nonlinearity update, rank-1 (K8)": float(TERMS_BYTES_PER_VOXEL),
        "nonlinearity update, general (K9)":
            float(TERMS_GC_BYTES_PER_VOXEL)}))

_register(OpSpec(
    name="median",
    fn=_k_median3.median3,
    z_halo="1 plane",
    bytes_per_voxel=float(MEDIAN3_BYTES_PER_VOXEL),
    reference="CudaOperationMedian3D",
    doc="3x3x3 median filter on flow increments (K3, csrc/median3.cu)."))


def _statistics(x: torch.Tensor) -> dict:
    """Global volume statistics (min/max/mean/L2) as 0-d tensors on x's
    device (torch reductions)."""
    return {"min": torch.amin(x), "max": torch.amax(x), "mean": torch.mean(x),
            "l2": torch.sqrt(torch.sum(x * x))}


_register(OpSpec(
    name="statistics",
    fn=_statistics,
    z_halo="none",
    bytes_per_voxel=4.0,
    reference="stat/min-max helper ops (intensity normalization, "
              "diagnostics)",
    doc="Global min/max/mean/norm reductions on the device."))

_register(OpSpec(
    name="add",
    fn=lambda flow, du: flow + du,
    z_halo="none",
    bytes_per_voxel=36.0,
    reference="CudaOperationAdd3D",
    doc="Flow accumulation s += ds."))
