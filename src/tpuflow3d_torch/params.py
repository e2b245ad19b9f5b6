"""Typed, frozen flow parameters.

Port of ``tpuflow3d.params``: the same fields, checks, level shapes and
presets. Two deliberate differences:

- ``backend`` is ``"auto" | "plain" | "kernels"``: ``auto`` launches the
  CUDA kernels for CUDA tensors and runs the plain PyTorch versions for CPU
  tensors, ``kernels`` requires CUDA tensors, ``plain`` runs the plain
  versions on any device (see ``backend.py``).
- ``sweep_layout`` defaults to ``"flat"`` (the reference's default is
  ``"packed"``). Both are served: ``"packed"`` sweeps SOR through the
  colour-packed kernels K4 and K7 at even W. Which is the faster default
  on the card is an open question recorded in PERF.md.

``from_reference`` carries a ``tpuflow3d.FlowParams`` (or its
``dataclasses.asdict``) across without importing the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Literal

Penalizer = Literal["charbonnier", "quadratic"]
Solver = Literal["sor", "jacobi", "multigrid"]
Backend = Literal["auto", "plain", "kernels"]

# The reference package's backend names, mapped onto the port's.
_REFERENCE_BACKENDS = {"xla": "plain", "pallas": "kernels", "auto": "auto"}


@dataclass(frozen=True)
class FlowParams:
    """All tunables of the variational solver (field for field the
    reference's; see tpuflow3d/params.py for what each one does)."""

    # --- energy functional ---
    alpha: float = 0.05
    penalizer_data: Penalizer = "charbonnier"
    penalizer_smooth: Penalizer = "charbonnier"
    eps_data: float = 1e-3
    eps_smooth: float = 1e-3
    gamma: float = 0.0
    penalizer_grad: Penalizer = "charbonnier"
    eps_grad: float = 1e-3

    # --- coarse-to-fine pyramid ---
    levels: int = 4
    scale_factor: float = 0.5
    min_dim: int = 8
    presmooth_sigma: float = 0.8
    aa_sigma_factor: float = 0.6

    # --- iteration counts ---
    warps: int = 3
    inner_iterations: int = 3
    sweeps: int = 20
    solver: Solver = "sor"
    omega: float = 1.9
    # --- multigrid controls (solver="multigrid") ---
    mg_cycles: int = 2
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarse_sweeps: int = 16
    mg_omega: float = 1.3
    residual_tol: float = 0.0

    # --- discretization ---
    deriv_order: int = 2
    interp: str = "trilinear"

    # --- post-processing ---
    median: bool = True
    flow_clamp: float = 0.0

    # --- numerics / execution ---
    normalize: bool = True
    dtype: str = "float32"
    terms_dtype: str = "float32"
    backend: Backend = "auto"
    sweep_layout: str = "flat"
    z_multiple: int = 1
    track_residuals: bool = False

    def __post_init__(self):
        if not (0.0 < self.scale_factor <= 0.95):
            raise ValueError("scale_factor must be in (0, 0.95]")
        if not (0.0 < self.omega < 2.0):
            raise ValueError("omega must be in (0, 2)")
        if self.levels < 1:
            raise ValueError("levels must be >= 1")
        if self.alpha <= 0.0:
            raise ValueError("alpha must be > 0")
        if self.gamma < 0.0:
            raise ValueError("gamma must be >= 0")
        if self.z_multiple < 1:
            raise ValueError("z_multiple must be >= 1")
        if self.sweeps < 1 or self.warps < 1 or self.inner_iterations < 1:
            raise ValueError("iteration counts must be >= 1")
        if self.sweep_layout not in ("packed", "flat"):
            raise ValueError("sweep_layout must be 'packed' or 'flat'")
        if self.deriv_order not in (2, 4):
            raise ValueError("deriv_order must be 2 or 4")
        if self.interp not in ("trilinear", "tricubic"):
            raise ValueError("interp must be 'trilinear' or 'tricubic'")
        if self.solver not in ("sor", "jacobi", "multigrid"):
            raise ValueError("solver must be 'sor', 'jacobi' or 'multigrid'")
        if self.backend not in ("auto", "plain", "kernels"):
            raise ValueError("backend must be 'auto', 'plain' or 'kernels'")
        if self.solver == "multigrid":
            if min(self.mg_cycles, self.mg_coarse_sweeps) < 1 or \
                    min(self.mg_pre, self.mg_post) < 0:
                raise ValueError("multigrid iteration counts out of range")
            if self.mg_cycles > self.sweeps:
                raise ValueError("mg_cycles must be <= sweeps (the "
                                 "residual-slot width per inner iteration)")
            if not (0.0 < self.mg_omega < 2.0):
                raise ValueError("mg_omega must be in (0, 2)")

    # ---- derived quantities ----

    def aa_sigma(self) -> float:
        """Anti-aliasing sigma applied before each pyramid downsample."""
        eta = self.scale_factor
        return self.aa_sigma_factor * math.sqrt(max(eta ** -2 - 1.0, 0.0))

    def jacobi_omega(self) -> float:
        return min(self.omega, 1.0)

    def level_shapes(self, shape: tuple[int, int, int]) -> list[tuple[int, int, int]]:
        """Per-level (D, H, W), fine -> coarse: dims_{l+1} = ceil(dims_l *
        eta), Z rounded up to ``z_multiple``, stopping at ``min_dim``."""
        zm = self.z_multiple
        d, h, w = shape
        d = zm * ((d + zm - 1) // zm)
        shapes = [(d, h, w)]
        for _ in range(self.levels - 1):
            d2 = math.ceil(d * self.scale_factor)
            h2 = math.ceil(h * self.scale_factor)
            w2 = math.ceil(w * self.scale_factor)
            d2 = zm * ((d2 + zm - 1) // zm)
            if min(d2, h2, w2) < self.min_dim or max(d2, h2, w2) < 2:
                break
            if (d2, h2, w2) == (d, h, w):
                break
            shapes.append((d2, h2, w2))
            d, h, w = d2, h2, w2
        return shapes

    def replace(self, **kw) -> "FlowParams":
        return dataclasses.replace(self, **kw)


def from_reference(obj_or_dict) -> FlowParams:
    """Map a ``tpuflow3d.FlowParams`` (or ``dataclasses.asdict`` of one)
    onto the port's FlowParams: backend ``xla`` -> ``plain``, ``pallas`` ->
    ``kernels``, ``auto`` -> ``auto``; every other field carries over as
    it is (so a reference ``sweep_layout="packed"`` stays packed, and
    ``terms_dtype="bfloat16"`` and ``deriv_order=4`` carry over). Every
    preset of the reference maps onto a configuration this port serves."""
    if dataclasses.is_dataclass(obj_or_dict):
        fields = dataclasses.asdict(obj_or_dict)
    else:
        fields = dict(obj_or_dict)
    fields["backend"] = _REFERENCE_BACKENDS[fields.get("backend", "auto")]
    return FlowParams(**fields)


# Presets mirroring the reference's config ladder (BASELINE.json:7-11).
PRESETS: dict[str, FlowParams] = {
    "ladder64": FlowParams(levels=3, scale_factor=0.5, warps=3,
                           inner_iterations=3, sweeps=20),
    "ladder128": FlowParams(levels=4, scale_factor=0.5, warps=3,
                            inner_iterations=3, sweeps=20),
    "ladder256": FlowParams(levels=5, scale_factor=0.5, warps=3,
                            inner_iterations=3, sweeps=20),
    "ladder512": FlowParams(levels=6, scale_factor=0.5, warps=3,
                            inner_iterations=3, sweeps=20, z_multiple=8),
    "ladder1024": FlowParams(levels=7, scale_factor=0.5, warps=3,
                             inner_iterations=3, sweeps=20, z_multiple=8),
    "accurate": FlowParams(levels=5, scale_factor=0.5, warps=8,
                           inner_iterations=3, sweeps=20,
                           solver="multigrid", mg_cycles=3,
                           residual_tol=1e-6, interp="tricubic",
                           flow_clamp=2.0),
    "accurate-bf16": FlowParams(levels=5, scale_factor=0.5, warps=8,
                                inner_iterations=3, sweeps=20,
                                solver="multigrid", mg_cycles=3,
                                residual_tol=1e-6, interp="tricubic",
                                flow_clamp=2.0, terms_dtype="bfloat16"),
}
