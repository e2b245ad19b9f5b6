"""Gaussian smoothing, trilinear resampling, and coarse-to-fine pyramids.

Port of ``tpuflow3d.pyramid``. Smoothing is a chain of shift-multiply-adds
(not ``conv3d``: cuDNN runs float32 convolutions in TF32 by default), so
the arithmetic is the reference's, term for term.

Resampling convention: half-pixel centers - output index i samples input
coordinate (i + 0.5) * (in/out) - 0.5, clipped (clamp/Neumann edges), then
linear interpolation per axis (separable => trilinear).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuflow3d_torch.grid import HaloCtx, Z_AXIS, neighbor_slices, replicate_pad
from tpuflow3d_torch.params import FlowParams


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _smooth_axis(xp: torch.Tensor, k: np.ndarray, r: int,
                 axis: int) -> torch.Tensor:
    acc = None
    for j, w in enumerate(k):
        term = float(w) * neighbor_slices(xp, r, axis, j - r)
        acc = term if acc is None else acc + term
    return acc


def smooth(x: torch.Tensor, sigma: float, ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """Separable Gaussian smoothing with Neumann (replicate) boundaries."""
    if sigma <= 0.0:
        return x
    k = gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    x = _smooth_axis(ctx.zpad(x, r), k, r, Z_AXIS)
    for axis in (-2, -1):
        x = _smooth_axis(replicate_pad(x, r, axis=axis), k, r, axis)
    return x


def _axis_coords(out_len_local: int, scale: float, z0_out: int,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Half-pixel source coordinates for a local output window: output index
    i (local) at global offset z0_out samples global input coordinate
    (i + z0_out + 0.5) * scale - 0.5, scale = in_global/out_global rounded
    to ``dtype``."""
    i = torch.arange(out_len_local, dtype=dtype, device=device)
    return (i + z0_out + 0.5) * float(np.float32(scale)) - 0.5


def resize_axis_local(x: torch.Tensor, out_len: int, axis: int) -> torch.Tensor:
    """Linear resize along one axis (half-pixel coordinates, clipped)."""
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    c = _axis_coords(out_len, in_len / out_len, 0, x.dtype, x.device)
    c = c.clamp(0.0, in_len - 1)
    fl = torch.floor(c)
    i0 = fl.long()
    i1 = (i0 + 1).clamp_max(in_len - 1)
    f = c - fl
    a = x.index_select(axis, i0)
    b = x.index_select(axis, i1)
    fshape = [1] * x.ndim
    fshape[axis] = out_len
    f = f.reshape(fshape)
    return a * (1.0 - f) + b * f


def resize_z_window(xp: torch.Tensor, out_len: int, z0_out: int, z0_in: int,
                    nh: int, scale: float, in_global: int) -> torch.Tensor:
    """Windowed Z resize: xp is an input window padded by nh planes whose
    plane 0 is global input plane (z0_in - nh); makes ``out_len`` output
    planes starting at global output plane z0_out. The streamed pyramid
    (``piecewise._stream_resample``) resizes its slabs with it, with the
    arithmetic of the in-core ``resize_axis_local`` along Z. Indices are
    clipped into the window, so an off-by-one reads an edge plane instead
    of failing silently elsewhere."""
    c = _axis_coords(out_len, scale, z0_out, xp.dtype, xp.device)
    c = c.clamp(0.0, in_global - 1)
    fl = torch.floor(c)
    i0g = fl.long()
    i1g = (i0g + 1).clamp_max(in_global - 1)
    f = c - fl
    n = xp.shape[Z_AXIS]
    a = xp.index_select(Z_AXIS, (i0g - z0_in + nh).clamp(0, n - 1))
    b = xp.index_select(Z_AXIS, (i1g - z0_in + nh).clamp(0, n - 1))
    fshape = [1] * xp.ndim
    fshape[Z_AXIS] = out_len
    f = f.reshape(fshape)
    return a * (1.0 - f) + b * f


def resize_z(x: torch.Tensor, out_len_global: int,
             ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """Linear resize along Z. On one device the Z axis is local, and the
    reference's windowed Z resize reduces to ``resize_axis_local``."""
    return resize_axis_local(x, out_len_global, Z_AXIS)


def resize3(x: torch.Tensor, out_shape_global: tuple[int, int, int],
            ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """Trilinear resize of a (..., D, H, W) array to a global (D, H, W)."""
    d, h, w = out_shape_global
    x = resize_z(x, d, ctx)
    x = resize_axis_local(x, h, axis=-2)
    x = resize_axis_local(x, w, axis=-1)
    return x


def build_pyramid(x: torch.Tensor, shapes: list[tuple[int, int, int]],
                  params: FlowParams, ctx: HaloCtx = HaloCtx()) -> list[torch.Tensor]:
    """Smooth + resample pyramid, fine -> coarse (shapes[0] == x.shape)."""
    out = [x]
    sigma = params.aa_sigma()
    for shp in shapes[1:]:
        x = smooth(x, sigma, ctx)
        x = resize3(x, shp, ctx)
        out.append(x)
    return out


def upsample_flow(flow: torch.Tensor, out_shape_global: tuple[int, int, int],
                  ctx: HaloCtx = HaloCtx()) -> torch.Tensor:
    """Upsample a (3, D, H, W) flow field to the next finer level and scale
    each component by the actual dimension ratio of its axis (not the
    nominal 1/eta, which drifts with the ceil in level_shapes)."""
    in_shape = flow.shape[-3:]
    up = resize3(flow, out_shape_global, ctx)
    ratios = torch.tensor([out_shape_global[i] / in_shape[i] for i in range(3)],
                          dtype=up.dtype, device=up.device).reshape(3, 1, 1, 1)
    return up * ratios
