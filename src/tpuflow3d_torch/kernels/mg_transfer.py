"""K10 and K11 wrappers: the multigrid V-cycle's grid transfers
(``csrc/mg_transfer.cu``).

The JAX package computes them in XLA; here, on a whole in-core grid, each
is one launch. K10 (``restrict_residual``): the residual of a level's
system restricted to the next coarser grid, the fine residual never
written. K11 (``prolong_add``): the coarse correction prolonged to the
level's grid and added to its iterate. Both read the lerp tables that the
level holds (``mgsolver.transfer_tables``), the plain resize's own
coordinates. The plain versions, run for CPU tensors, are
``mgsolver.restrict_residual_plain`` and ``mgsolver.prolong_add_plain``;
each kernel agrees bitwise with its own. ``mgsolver._vcycle`` decides when
to call them (``mgsolver.transfers_on_kernel``).
"""

from __future__ import annotations

import torch

from tpuflow3d_torch import kernels
from tpuflow3d_torch.mgsolver import (MGLevel, prolong_add_plain,
                                      restrict_residual_plain)


def _tables(name: str, tables, lengths, device) -> list:
    """The tables' addresses, each checked: a (3, n) int32 tensor on
    ``device`` for an axis whose length changes from ``lengths[a][0]`` to
    ``lengths[a][1]`` = n. Every axis changes its length between
    neighbouring grids of a one-device hierarchy (``mgsolver.mg_shapes``),
    where the plain resize of an axis that keeps it returns its input."""
    if tables is None or len(tables) != 3:
        raise ValueError(f"{name}: the level holds no lerp tables")
    for axis, (t, (n_in, n_out)) in enumerate(zip(tables, lengths)):
        if n_in == n_out:
            raise ValueError(f"{name}: axis {axis} keeps its length {n_in}")
        kernels.check_tensor(f"{name} table {axis}", t, (3, n_out), device,
                             torch.int32)
    return [t.data_ptr() for t in tables]


def _whole(name: str, du: torch.Tensor) -> tuple:
    if du.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {du.device}")
    if du.ndim != 4 or du.shape[0] != 3:
        raise ValueError(f"{name}: du of shape {tuple(du.shape)}, expected "
                         f"(3, D, H, W)")
    return tuple(du.shape[1:])


def restrict_residual(du: torch.Tensor, lvl: MGLevel, rhs: torch.Tensor,
                      coarse_shape) -> torch.Tensor:
    """The residual rhs + sum_q w du_q - (sw I + D) du of ``lvl``'s system
    at du (3, D, H, W), restricted to ``coarse_shape``: K10 for CUDA
    tensors of a whole grid (rhs float32 or bfloat16), the plain version
    for CPU tensors."""
    if du.device.type == "cpu":
        return restrict_residual_plain(du, lvl, rhs, coarse_shape)
    d, h, w = _whole("mg_restrict", du)
    dc, hc, wc = coarse_shape
    if 2 * hc < h or 2 * wc < w:
        raise ValueError(f"mg_restrict: {(h, w)} -> {(hc, wc)}: K10 takes "
                         f"y and x ratios of at most 2")
    dev = du.device
    kernels.check_tensor("du", du, (3, d, h, w), dev)
    kernels.check_tensor("rhs", rhs, (3, d, h, w), dev,
                         kernels.terms_dtype(rhs))
    kernels.check_tensor("psi_s", lvl.psi_s, (d, h, w), dev)
    kernels.check_tensor("d6", lvl.d6, (6, d, h, w), dev)
    tz, ty, tx = _tables("mg_restrict", lvl.down,
                         list(zip((d, h, w), coarse_shape)), dev)
    rc = du.new_empty((3, dc, hc, wc))
    # Half-alphas as the plain weights make them: float32(alpha * 0.5).
    halves = tuple(float(a) * 0.5 for a in lvl.axis_alpha)
    with kernels.on_device(dev):
        kernels.launch(
            "mg_restrict", kernels.load_library().tf3d_mg_restrict,
            du.data_ptr(), rhs.data_ptr(), lvl.psi_s.data_ptr(),
            lvl.d6.data_ptr(), rc.data_ptr(), tz, ty, tx, d, h, w, dc, hc,
            wc, *halves, int(rhs.dtype == torch.bfloat16),
            kernels.stream_handle(dev))
    return rc


def prolong_add(du: torch.Tensor, ec: torch.Tensor, lvl: MGLevel,
                in_place: bool = False) -> torch.Tensor:
    """du (3, D, H, W) plus the coarse correction ec prolonged to
    ``lvl``'s grid: K11 for CUDA tensors of a whole grid, written into du
    itself where ``in_place`` (the caller no longer reads the old du), the
    plain version for CPU tensors (a new tensor)."""
    if du.device.type == "cpu":
        return prolong_add_plain(du, ec, lvl.shape_global)
    d, h, w = _whole("mg_prolong", du)
    if ec.ndim != 4 or ec.shape[0] != 3:
        raise ValueError(f"mg_prolong: ec of shape {tuple(ec.shape)}, "
                         f"expected (3, Dc, Hc, Wc)")
    dc, hc, wc = ec.shape[1:]
    if hc > h or wc > w:
        raise ValueError(f"mg_prolong: {(hc, wc)} -> {(h, w)}: K11 takes a "
                         f"coarse grid no larger than the fine along y and x")
    dev = du.device
    kernels.check_tensor("du", du, (3, d, h, w), dev)
    kernels.check_tensor("ec", ec, (3, dc, hc, wc), dev)
    tz, ty, tx = _tables("mg_prolong", lvl.up,
                         list(zip((dc, hc, wc), (d, h, w))), dev)
    out = du if in_place else torch.empty_like(du)
    with kernels.on_device(dev):
        kernels.launch(
            "mg_prolong", kernels.load_library().tf3d_mg_prolong,
            du.data_ptr(), ec.data_ptr(), out.data_ptr(), tz, ty, tx, d, h,
            w, dc, hc, wc, kernels.stream_handle(dev))
    return out
