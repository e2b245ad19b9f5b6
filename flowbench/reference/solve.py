"""The plain reference: the float32 coarse-to-fine solve in plain PyTorch.

A frozen copy of the arithmetic of ``tpuflow3d_torch``'s plain versions on
one device (normalise, presmooth, pyramids; per level and warp: warp +
2-point derivatives, the nonlinearity updates, red-black SOR or multigrid
V-cycles with the early stop, the 3x3x3 median, accumulate and clamp; the
upsample between levels), operation for operation, so that it rounds as
they do. It imports nothing of the program; later changes to the program
do not move it. Served: gradient constancy off (gamma 0), 2-point
derivatives, SOR or multigrid, trilinear or tricubic warping, float32
sweep constants; anything else raises.

Memory: the warp and the median run over slabs of Z planes (each output
voxel is computed from the whole input exactly as unsliced), so a 512^3
solve fits the card beside nothing else.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

Z = -3
_DIRECTIONS = ((Z, +1), (Z, -1), (-2, +1), (-2, -1), (-1, +1), (-1, -1))
_SLAB_VOXELS = 1 << 23
_MAX_MG_LEVELS = 8
_COARSEST_MIN = 8


@dataclass(frozen=True)
class Params:
    """The solver settings the reference reads (``FlowParams``' names)."""
    alpha: float = 0.05
    penalizer_data: str = "charbonnier"
    penalizer_smooth: str = "charbonnier"
    eps_data: float = 1e-3
    eps_smooth: float = 1e-3
    gamma: float = 0.0
    levels: int = 4
    scale_factor: float = 0.5
    min_dim: int = 8
    presmooth_sigma: float = 0.8
    aa_sigma_factor: float = 0.6
    warps: int = 3
    inner_iterations: int = 3
    sweeps: int = 20
    solver: str = "sor"
    omega: float = 1.9
    mg_cycles: int = 2
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarse_sweeps: int = 16
    mg_omega: float = 1.3
    residual_tol: float = 0.0
    deriv_order: int = 2
    interp: str = "trilinear"
    median: bool = True
    flow_clamp: float = 0.0
    normalize: bool = True
    z_multiple: int = 1

    # How the program executes, not what it computes: read and ignored.
    _EXECUTION = ("backend", "sweep_layout", "dtype", "terms_dtype",
                  "track_residuals", "penalizer_grad", "eps_grad")

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names - set(cls._EXECUTION)
        if unknown:
            raise ValueError(f"reference: unknown settings {sorted(unknown)}")
        p = cls(**{k: v for k, v in d.items() if k in names})
        if d.get("dtype", "float32") != "float32" or \
                d.get("terms_dtype", "float32") != "float32":
            raise ValueError("reference: float32 only")
        if p.gamma != 0.0 or p.deriv_order != 2 or \
                p.solver not in ("sor", "multigrid") or \
                p.interp not in ("trilinear", "tricubic"):
            raise ValueError("reference: gamma 0, deriv_order 2, SOR or "
                             "multigrid, trilinear or tricubic only")
        return p

    def aa_sigma(self) -> float:
        eta = self.scale_factor
        return self.aa_sigma_factor * math.sqrt(max(eta ** -2 - 1.0, 0.0))

    def level_shapes(self, shape):
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


# ---- padding and stencils ----

def replicate_pad(x, nh: int, axis: int):
    if nh == 0:
        return x
    n = x.shape[axis]
    idx = torch.arange(-nh, n + nh, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def neighbor(xp, nh: int, axis: int, delta: int):
    return xp.narrow(axis, nh + delta, xp.shape[axis] - 2 * nh)


def central_diff(x, axis: int):
    if axis in (Z, x.ndim + Z):
        axis = Z
    xp = replicate_pad(x, 1, axis)
    return 0.5 * (neighbor(xp, 1, axis, +1) - neighbor(xp, 1, axis, -1))


# ---- pyramid ----

def gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _smooth_axis(xp, k, r: int, axis: int):
    acc = None
    for j, w in enumerate(k):
        term = float(w) * neighbor(xp, r, axis, j - r)
        acc = term if acc is None else acc + term
    return acc


def smooth(x, sigma: float):
    if sigma <= 0.0:
        return x
    k = gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    for axis in (Z, -2, -1):
        x = _smooth_axis(replicate_pad(x, r, axis), k, r, axis)
    return x


def resize_axis(x, out_len: int, axis: int):
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    scale = float(np.float32(in_len / out_len))
    c = (torch.arange(out_len, dtype=x.dtype, device=x.device) + 0.5) \
        * scale - 0.5
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


def resize3(x, shape):
    d, h, w = shape
    return resize_axis(resize_axis(resize_axis(x, d, Z), h, -2), w, -1)


def upsample_flow(flow, out_shape):
    in_shape = flow.shape[-3:]
    up = resize3(flow, out_shape)
    return torch.stack([up[i] * float(np.float32(out_shape[i] / in_shape[i]))
                        for i in range(3)])


def prepare_pyramids(i0, i1, p: Params):
    i0 = i0.to(torch.float32)
    i1 = i1.to(torch.float32)
    if p.normalize:
        mn = torch.minimum(i0.min(), i1.min())
        mx = torch.maximum(i0.max(), i1.max())
        scale = 1.0 / (mx - mn).clamp_min(1e-12)
        i0, i1 = (i0 - mn) * scale, (i1 - mn) * scale
    if p.presmooth_sigma > 0.0:
        i0 = smooth(i0, p.presmooth_sigma)
        i1 = smooth(i1, p.presmooth_sigma)
    shapes = p.level_shapes(tuple(i0.shape))
    pyrs = []
    for x in (i0, i1):
        out = [x]
        for shp in shapes[1:]:
            x = resize3(smooth(x, p.aa_sigma()), shp)
            out.append(x)
        pyrs.append(out)
    return pyrs[0], pyrs[1], shapes


# ---- warp and derivatives ----

def _trilinear(vol, cz, cy, cx, origin=0):
    """Trilinear sample at (cz + origin, cy, cx), cz in the frame whose
    plane 0 is global plane ``origin`` (the fraction is cz's)."""
    d, h, w = vol.shape[-3:]
    z0, y0, x0 = torch.floor(cz), torch.floor(cy), torch.floor(cx)
    fz, fy, fx = cz - z0, cy - y0, cx - x0
    z0, y0, x0 = z0.long() + origin, y0.long(), x0.long()
    z1 = (z0 + 1).clamp_max(d - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    flat = vol.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    c00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
    c01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
    c10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
    c11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _cubic_weights(f):
    f2 = f * f
    f3 = f2 * f
    return (0.5 * (-f3 + 2.0 * f2 - f),
            0.5 * (3.0 * f3 - 5.0 * f2 + 2.0),
            0.5 * (-3.0 * f3 + 4.0 * f2 + f),
            0.5 * (f3 - f2))


def _tricubic(vol, cz, cy, cx, origin=0):
    d, h, w = vol.shape[-3:]
    z0, y0, x0 = torch.floor(cz), torch.floor(cy), torch.floor(cx)
    wz = _cubic_weights(cz - z0)
    wy = _cubic_weights(cy - y0)
    wx = _cubic_weights(cx - x0)
    z0, y0, x0 = z0.long() + origin, y0.long(), x0.long()
    flat = vol.reshape(-1)
    acc = None
    for iz in range(4):
        zrow = (z0 + (iz - 1)).clamp_(0, d - 1) * h
        pz = None
        for iy in range(4):
            row = (zrow + (y0 + (iy - 1)).clamp_(0, h - 1)) * w
            for ix in range(4):
                v = flat[row + (x0 + (ix - 1)).clamp_(0, w - 1)]
                term = wy[iy] * (wx[ix] * v)
                pz = term if pz is None else pz + term
        term = wz[iz] * pz
        acc = term if acc is None else acc + term
    return acc


def _slabs(shape):
    d, h, w = shape
    step = max(1, _SLAB_VOXELS // (h * w))
    return [(z0, min(z0 + step, d)) for z0 in range(0, d, step)]


def warp(i1, flow, interp: str):
    """I1(x + s(x)), coordinates clipped to the volume, slab by slab."""
    d, h, w = i1.shape
    gather = _tricubic if interp == "tricubic" else _trilinear
    kw = dict(dtype=flow.dtype, device=flow.device)
    yi = torch.arange(h, **kw).reshape(1, h, 1)
    xi = torch.arange(w, **kw).reshape(1, 1, w)
    out = torch.empty_like(i1)
    for z0, z1 in _slabs(i1.shape):
        zi = torch.arange(z0, z1, **kw).reshape(-1, 1, 1)
        fl = flow[:, z0:z1]
        cy = (yi + fl[1]).clamp(0.0, h - 1)
        cx = (xi + fl[2]).clamp(0.0, w - 1)
        cz = (zi + fl[0]).clamp(0.0, d - 1)
        out[z0:z1] = gather(i1, cz, cy, cx)
    return out


def warp_deriv_streamed(i0, i1, flow, interp: str, chunk: int,
                        margin: int):
    """(g, it) as the streamed mode defines them: the volume in Z-chunks
    of ``chunk`` planes, each warped in the frame of its slab, whose plane
    0 is global plane chunk_start - ``margin``: the z coordinate z + s_z is
    formed there (its rounding moves with the frame) and clipped to the
    volume. The planes beyond the chunk that the Z derivative reads are
    warped in the same frame, and beyond the volume's faces they are the
    face planes' inputs (i0, flow) warped one plane out, not copies of the
    warped face plane as in core."""
    d, h, w = i1.shape
    gather = _tricubic if interp == "tricubic" else _trilinear
    kw = dict(dtype=flow.dtype, device=flow.device)
    yi = torch.arange(h, **kw).reshape(1, h, 1)
    xi = torch.arange(w, **kw).reshape(1, 1, w)
    size = chunk + 2 * margin
    g = torch.empty((3, d, h, w), **kw)
    it = torch.empty((d, h, w), **kw)
    for c in range(0, d, chunk):
        e = min(c + chunk, d)
        o = c - margin
        planes = torch.arange(c - 1, e + 1, device=flow.device)
        src = planes.clamp(0, d - 1)
        fl = flow[:, src]
        i0p = i0[src]
        zl = (planes - o).to(flow.dtype).reshape(-1, 1, 1)
        cz = (zl + fl[0]).clamp(float(-o), float(d - 1 - o)).clamp(
            0.0, size - 1)
        cy = (yi + fl[1]).clamp(0.0, h - 1)
        cx = (xi + fl[2]).clamp(0.0, w - 1)
        i1w = gather(i1, cz, cy, cx, o)
        ibar = 0.5 * (i0p + i1w)
        g[0, c:e] = 0.5 * (ibar[2:] - ibar[:-2])
        g[1, c:e] = central_diff(ibar[1:-1], -2)
        g[2, c:e] = central_diff(ibar[1:-1], -1)
        it[c:e] = i1w[1:-1] - i0p[1:-1]
    return g, it


def derivatives(i0, i1w):
    ibar = 0.5 * (i0 + i1w)
    g = torch.stack([central_diff(ibar, a) for a in (Z, -2, -1)])
    return g, i1w - i0


# ---- the linearised system ----

class Terms(NamedTuple):
    c: torch.Tensor
    g: torch.Tensor
    w: tuple
    sw_inv: torch.Tensor
    smt: torch.Tensor
    psi_s: torch.Tensor
    psi_d: torch.Tensor
    ainv: torch.Tensor = None


def _psi(q2, penalizer: str, eps: float):
    if penalizer == "quadratic":
        return torch.ones_like(q2)
    return torch.rsqrt(q2 + eps * eps)


def parity_mask(shape, device):
    d, h, w = shape
    zg = torch.arange(d, device=device).reshape(d, 1, 1) + 0
    iy = torch.arange(h, device=device).reshape(1, h, 1)
    ix = torch.arange(w, device=device).reshape(1, 1, w)
    return (zg + iy + ix) & 1


def _face_masks(shape, dtype, device):
    d, h, w = shape
    zg = torch.arange(d, device=device).reshape(d, 1, 1) + 0
    iy = torch.arange(h, device=device).reshape(1, h, 1)
    ix = torch.arange(w, device=device).reshape(1, 1, w)
    zeros = torch.zeros((d, h, w), dtype=dtype, device=device)
    return [(zg < d - 1).to(dtype) + zeros, (zg > 0).to(dtype) + zeros,
            (iy < h - 1).to(dtype) + zeros, (iy > 0).to(dtype) + zeros,
            (ix < w - 1).to(dtype) + zeros, (ix > 0).to(dtype) + zeros]


def _nb(src, src_zp, axis: int, delta: int):
    if axis == Z:
        return neighbor(src_zp, 1, Z, delta)
    return neighbor(replicate_pad(src, 1, axis), 1, axis, delta)


def _neighbors6(x):
    xp = replicate_pad(x, 1, Z)
    out = [neighbor(xp, 1, Z, +1), neighbor(xp, 1, Z, -1)]
    for axis in (-2, -1):
        xp = replicate_pad(x, 1, axis)
        out.append(neighbor(xp, 1, axis, +1))
        out.append(neighbor(xp, 1, axis, -1))
    return out


def _weights(psi_s, axis_scale, alpha: float):
    """Directional weights z+, z-, y+, y-, x+, x- (alpha scaled per axis)
    and their sum, accumulated in that order."""
    masks = _face_masks(tuple(psi_s.shape), psi_s.dtype, psi_s.device)
    psi_zp = replicate_pad(psi_s, 1, Z)
    sw = torch.zeros_like(psi_s)
    w_dirs = []
    for i, (mask, (axis, delta)) in enumerate(zip(masks, _DIRECTIONS)):
        a_eff = alpha * axis_scale[i // 2]
        wd = a_eff * 0.5 * (psi_s + _nb(psi_s, psi_zp, axis, delta)) * mask
        sw = sw + wd
        w_dirs.append(wd)
    return tuple(w_dirs), sw


def compute_terms(g, it, flow, du, p: Params) -> Terms:
    """The nonlinearity update at the increment ``du``."""
    r = it + (g * du).sum(0)
    psi_d = _psi(r * r, p.penalizer_data, p.eps_data)
    total = flow + du
    s2 = torch.zeros(tuple(it.shape), dtype=g.dtype, device=g.device)
    for axis in (Z, -2, -1):
        dgrad = central_diff(total, axis)
        s2 = s2 + (dgrad * dgrad).sum(0)
    psi_s = _psi(s2, p.penalizer_smooth, p.eps_smooth)
    masks = _face_masks(tuple(psi_s.shape), psi_s.dtype, psi_s.device)
    half_alpha = float(np.float32(p.alpha)) * 0.5
    psi_zp = replicate_pad(psi_s, 1, Z)
    sw = torch.zeros(tuple(psi_s.shape), dtype=psi_s.dtype,
                     device=psi_s.device)
    w_dirs = []
    for mask, (axis, delta) in zip(masks, _DIRECTIONS):
        wd = half_alpha * (psi_s + _nb(psi_s, psi_zp, axis, delta)) * mask
        sw = sw + wd
        w_dirs.append(wd)
    nbu = torch.zeros_like(flow)
    flow_zp = replicate_pad(flow, 1, Z)
    for wd, (axis, delta) in zip(w_dirs, _DIRECTIONS):
        nbu = nbu + wd[None] * (_nb(flow, flow_zp, axis, delta) - flow)
    c = -(psi_d * it)[None] * g + nbu
    sw_inv = 1.0 / sw
    q = psi_d * (g * g).sum(0)
    smt = psi_d * sw_inv / (sw + q)
    return Terms(c, g, tuple(w_dirs), sw_inv, smt, psi_s, psi_d)


def _du_star(du, t: Terms):
    b = t.c
    for wd, dnb in zip(t.w, _neighbors6(du)):
        b = b + wd[None] * dnb
    if t.ainv is not None:
        a = t.ainv
        return torch.stack([a[0] * b[0] + a[1] * b[1] + a[2] * b[2],
                            a[1] * b[0] + a[3] * b[1] + a[4] * b[2],
                            a[2] * b[0] + a[4] * b[1] + a[5] * b[2]])
    gb = (t.g * b).sum(0)
    return b * t.sw_inv[None] - t.g * (gb * t.smt)[None]


def halfsweep(du, t: Terms, omega: float, parity, color: int):
    new = (1.0 - omega) * du + omega * _du_star(du, t)
    return torch.where((parity == color)[None], new, du)


def sor_sweep(du, t: Terms, omega: float, parity):
    return halfsweep(halfsweep(du, t, omega, parity, 0), t, omega, parity, 1)


# ---- multigrid ----

class MGLevel(NamedTuple):
    terms: Terms
    d6: torch.Tensor
    sw: torch.Tensor
    parity: torch.Tensor
    shape: tuple


def mg_shapes(shape):
    """The multigrid hierarchy's grids, fine -> coarse (one device)."""
    shapes = [tuple(shape)]
    while len(shapes) < _MAX_MG_LEVELS:
        d, h, w = shapes[-1]
        if min(d, h, w) < _COARSEST_MIN:
            break
        dc = max(1, d // 2)
        hc, wc = max(4, (h + 1) // 2), max(4, (w + 1) // 2)
        if (dc, hc, wc) == (d, h, w):
            break
        shapes.append((dc, hc, wc))
    return shapes


def _sym3_inverse(m00, m01, m02, m11, m12, m22):
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det_inv = 1.0 / (m00 * c00 + m01 * c01 + m02 * c02)
    return torch.stack([c00, c01, c02, c11, c12, c22]) * det_inv


def _level(w, sw, d6, shape, psi_s) -> MGLevel:
    ainv = _sym3_inverse(sw + d6[0], d6[1], d6[2],
                         sw + d6[3], d6[4], sw + d6[5])
    t = Terms(None, None, w, None, None, psi_s, None, ainv)
    return MGLevel(t, d6, sw, parity_mask(tuple(psi_s.shape), psi_s.device),
                   shape)


def mg_levels(t: Terms, p: Params) -> list:
    shape = tuple(t.psi_s.shape)
    shapes = mg_shapes(shape)
    g, pd = t.g, t.psi_d
    d6 = torch.stack([pd * g[0] * g[0], pd * g[0] * g[1], pd * g[0] * g[2],
                      pd * g[1] * g[1], pd * g[1] * g[2], pd * g[2] * g[2]])
    psi_s = t.psi_s
    w, sw = _weights(psi_s, (1.0, 1.0, 1.0), p.alpha)
    levels = [_level(w, sw, d6, shapes[0], psi_s)]
    for shp in shapes[1:]:
        d6 = resize3(d6, shp)
        psi_s = resize3(psi_s, shp)
        scale = tuple((shp[a] / shape[a]) ** 2 for a in range(3))
        w, sw = _weights(psi_s, scale, p.alpha)
        levels.append(_level(w, sw, d6, shp, psi_s))
    return levels


def _mg_smooth(du, lvl: MGLevel, rhs, p: Params, n: int):
    t = lvl.terms._replace(c=rhs)
    for _ in range(n):
        du = sor_sweep(du, t, p.mg_omega, lvl.parity)
    return du


def mg_residual(du, lvl: MGLevel, rhs):
    r = rhs
    for wd, dnb in zip(lvl.terms.w, _neighbors6(du)):
        r = r + wd[None] * dnb
    a = lvl.d6
    d_du = torch.stack([a[0] * du[0] + a[1] * du[1] + a[2] * du[2],
                        a[1] * du[0] + a[3] * du[1] + a[4] * du[2],
                        a[2] * du[0] + a[4] * du[1] + a[5] * du[2]])
    return r - (du * lvl.sw[None] + d_du)


def vcycle(du, rhs, levels, li: int, p: Params):
    lvl = levels[li]
    du = _mg_smooth(du, lvl, rhs, p, p.mg_pre)
    if li == len(levels) - 1:
        return _mg_smooth(du, lvl, rhs, p, p.mg_coarse_sweeps)
    r = mg_residual(du, lvl, rhs)
    rc = resize3(r, levels[li + 1].shape)
    ec = vcycle(torch.zeros_like(rc), rc, levels, li + 1, p)
    du = du + resize3(ec, lvl.shape)
    return _mg_smooth(du, lvl, rhs, p, p.mg_post)


# ---- the solve ----

def _relax(step, du, n: int, p: Params):
    """Up to n steps; with residual_tol > 0 stop once a step's mean
    |update| is not above it."""
    for _ in range(n):
        new = step(du)
        if p.residual_tol > 0.0:
            d, h, w = new.shape[-3:]
            r = (new - du).abs().sum() / (3.0 * d * h * w)
            du = new
            if not bool(r > p.residual_tol):
                break
        else:
            du = new
    return du


def solve_increment(g, it, flow, p: Params, parity):
    du = torch.zeros_like(flow)
    for _ in range(p.inner_iterations):
        t = compute_terms(g, it, flow, du, p)
        if p.solver == "multigrid":
            levels = mg_levels(t, p)
            du = _relax(lambda x: vcycle(x, t.c, levels, 0, p), du,
                        p.mg_cycles, p)
        else:
            du = _relax(lambda x: sor_sweep(x, t, p.omega, parity), du,
                        p.sweeps, p)
    return du


def median3(x):
    """27-point median of each component of (3, D, H, W), replicate
    edges, slab by slab."""
    d, h, w = x.shape[-3:]
    xp = replicate_pad(replicate_pad(replicate_pad(x, 1, Z), 1, -1), 1, -2)
    out = torch.empty_like(x)
    for z0, z1 in _slabs((d, h, w)):
        stack = [xp[..., 1 + dz + z0:1 + dz + z1, 1 + dy:1 + dy + h,
                    1 + dx:1 + dx + w]
                 for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1)]
        for c in range(x.shape[0]):
            out[c, z0:z1] = torch.sort(torch.stack([s[c] for s in stack]),
                                       dim=0).values[13]
    return out


def warp_iteration(i0l, i1l, flow, p: Params, parity, frame=None):
    if frame is None:
        g, it = derivatives(i0l, warp(i1l, flow, p.interp))
    else:
        g, it = warp_deriv_streamed(i0l, i1l, flow, p.interp, *frame)
    du = solve_increment(g, it, flow, p, parity)
    del g, it
    if p.median:
        du = median3(du)
    flow = flow + du
    if p.flow_clamp > 0.0:
        flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return flow


def stream_margin(p: Params) -> int:
    """The Z margin of a streamed warp slab: the warp's reach (ceil of the
    clamp, plus one tap; one more for tricubic) and the derivative's."""
    return (int(math.ceil(p.flow_clamp)) + 1
            + (1 if p.interp == "tricubic" else 0) + 1)


def solve(i0, i1, p: Params, stream_chunk: int | None = None
          ) -> torch.Tensor:
    """The (3, D, H, W) float32 flow of a (D, H, W) pair of tensors, on
    their device. ``stream_chunk``: the solve as the streamed mode defines
    it, in Z-chunks of that many planes (``warp_deriv_streamed``);
    everything else a slab computes is the in-core value."""
    if stream_chunk is not None and (p.solver != "sor"
                                     or p.inner_iterations == 1):
        raise ValueError("reference: the streamed mode is reproduced for "
                         "SOR with its phased passes (inner_iterations > 1)"
                         " only")
    frame = (None if stream_chunk is None
             else (stream_chunk, stream_margin(p)))
    d = i0.shape[0]
    zm = p.z_multiple
    d_pad = zm * ((d + zm - 1) // zm)
    if d_pad != d:
        i0 = torch.cat([i0, i0[-1:].expand(d_pad - d, -1, -1)], dim=0)
        i1 = torch.cat([i1, i1[-1:].expand(d_pad - d, -1, -1)], dim=0)
    pyr0, pyr1, shapes = prepare_pyramids(i0, i1, p)
    flow = torch.zeros((3, *shapes[-1]), dtype=torch.float32,
                       device=i0.device)
    for li in range(len(shapes) - 1, -1, -1):
        parity = parity_mask(shapes[li], i0.device)
        for _ in range(p.warps):
            flow = warp_iteration(pyr0[li], pyr1[li], flow, p, parity, frame)
        pyr0[li] = pyr1[li] = None
        if li > 0:
            flow = upsample_flow(flow, shapes[li - 1])
            if p.flow_clamp > 0.0:
                flow = flow.clamp(-p.flow_clamp, p.flow_clamp)
    return flow[:, :d]
