"""The colour-packed layout, and the K4 wrapper: red-black SOR half-sweep on
colour-packed arrays (``csrc/sor_packed.cu``).

Replaces ``tpuflow3d/pallas/sor_packed.py`` (``pack_color``,
``unpack_colors``, ``sor_halfsweep_packed``).

Layout: everything is stored checkerboard-packed along X. Voxel (z, y, x)
of colour c = (z0 + z + y + x) & 1 lives at packed index x // 2 of colour
c's (..., D, H, W/2) array; row (z, y) of that array starts at x parity
off = (z0 + z + y + c) & 1, so each packed row is dense. W must be even.
On a 6-neighbourhood every neighbour has the other colour, so a half-sweep
reads the active colour's du, c, g, psi_s, psi_d and the other colour's du
and psi_s, and writes only the active du: 36 B per voxel of the full volume
against the flat kernel's 56. Packing and unpacking are exact permutations
in plain PyTorch, once per nonlinearity update, outside the kernel (as in
the reference).

``sor_halfsweep_packed`` takes the reference function's arguments. It
launches the CUDA kernel for CUDA tensors and runs
``sor_halfsweep_packed_plain`` for CPU tensors; the plain version does the
flat plain sweep's operations (``solver.sor_halfsweep``) in the same order,
so the two are bitwise equal on the same device. Out-of-place: returns the
updated active-colour array.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow3d_torch import kernels


def _row_offset(d: int, h: int, z0: int, color: int,
                device=None) -> torch.Tensor:
    """(d, h, 1) x parity of the first element of each packed row,
    off = (z_global + y + color) & 1."""
    zg = z0 + torch.arange(d, device=device).reshape(d, 1, 1)
    yy = torch.arange(h, device=device).reshape(1, h, 1)
    return (zg + yy + color) & 1


def pack_color(x: torch.Tensor, color: int, z0: int = 0) -> torch.Tensor:
    """(..., D, H, W) -> (..., D, H, W//2): the colour's elements, each row
    dense; z0 is the global z of plane 0. Keeps the dtype."""
    d, h, w = x.shape[-3:]
    if w % 2:
        raise ValueError(f"pack_color: W = {w} is odd")
    off = _row_offset(d, h, z0, color, x.device)
    xr = x.reshape(*x.shape[:-1], w // 2, 2)
    return torch.where(off == 1, xr[..., 1], xr[..., 0])


def unpack_colors(x0: torch.Tensor, x1: torch.Tensor,
                  z0: int = 0) -> torch.Tensor:
    """Inverse of pack_color: interleave the two colour arrays back to
    (..., D, H, W)."""
    d, h, wp = x0.shape[-3:]
    sel = _row_offset(d, h, z0, 0, x0.device) == 0
    even = torch.where(sel, x0, x1)
    odd = torch.where(sel, x1, x0)
    return torch.stack([even, odd], dim=-1).reshape(*x0.shape[:-1], 2 * wp)


def _neighbors6_packed(o: torch.Tensor, lo, hi,
                       off: torch.Tensor) -> list[torch.Tensor]:
    """Values at the 6 neighbours (z+, z-, y+, y-, x+, x-) of each active
    element, read from the other colour's array ``o`` (..., D, H, WP) and
    its Z halo planes (..., 1, H, WP; None for a replica of o's own face
    plane). z and y neighbours keep the packed index; x+ is index i+1 where
    the row offset is 1, else i; x- is i-1 where it is 0, else i. Edges
    replicate (the face masks zero them)."""
    d = o.shape[-3]
    lo = o.narrow(-3, 0, 1) if lo is None else lo
    hi = o.narrow(-3, d - 1, 1) if hi is None else hi
    xl = torch.cat([o[..., 1:], o[..., -1:]], dim=-1)    # index i+1
    xr = torch.cat([o[..., :1], o[..., :-1]], dim=-1)    # index i-1
    return [
        torch.cat([o.narrow(-3, 1, d - 1), hi], dim=-3),
        torch.cat([lo, o.narrow(-3, 0, d - 1)], dim=-3),
        torch.cat([o[..., 1:, :], o[..., -1:, :]], dim=-2),
        torch.cat([o[..., :1, :], o[..., :-1, :]], dim=-2),
        torch.where(off == 1, xl, o),
        torch.where(off == 0, xr, o),
    ]


def packed_rhs(du_o, c_a, ps_a, ps_o, duo_lo, duo_hi, pso_lo, pso_hi,
               z0: int, alpha: float, color: int, dg: int):
    """(b, sw) of the active colour: b = c + sum_q w_pq du_q and
    sw = sum_q w_pq, with w_pq = alpha*(psi_s[p]+psi_s[q])/2, zero across a
    global face, summed one neighbour at a time in the order z+, z-, y+,
    y-, x+, x- (the order sets the rounding)."""
    d, h, wp = ps_a.shape
    dev, dtype = ps_a.device, ps_a.dtype
    off = _row_offset(d, h, z0, color, dev)
    zi = z0 + torch.arange(d, device=dev).reshape(d, 1, 1)
    yi = torch.arange(h, device=dev).reshape(1, h, 1)
    xa = 2 * torch.arange(wp, device=dev).reshape(1, 1, wp) + off  # true x
    masks = [zi < dg - 1, zi > 0, yi < h - 1, yi > 0, xa < 2 * wp - 1, xa > 0]
    half_alpha = float(np.float32(alpha)) * 0.5
    b = c_a.to(du_o.dtype)
    sw = torch.zeros_like(ps_a)
    for m, pnb, dnb in zip(masks,
                           _neighbors6_packed(ps_o, pso_lo, pso_hi, off),
                           _neighbors6_packed(du_o, duo_lo, duo_hi, off)):
        wd = half_alpha * (ps_a + pnb) * m.to(dtype)
        sw = sw + wd
        b = b + wd[None] * dnb
    return b, sw


def sor_halfsweep_packed_plain(du_a, du_o, c_a, g_a, ps_a, ps_o, pd_a,
                               duo_lo, duo_hi, pso_lo, pso_hi, z0: int,
                               alpha: float, omega: float, color: int,
                               dg: int) -> torch.Tensor:
    """Plain version of K4: ``solver.sor_halfsweep`` on the packed arrays
    of ``color``, every element an update."""
    b, sw = packed_rhs(du_o, c_a, ps_a, ps_o, duo_lo, duo_hi, pso_lo, pso_hi,
                       z0, alpha, color, dg)
    g = g_a.to(du_a.dtype)
    sw_inv = 1.0 / sw
    q = pd_a * (g * g).sum(0)
    smt = pd_a * sw_inv / (sw + q)
    gb = (g * b).sum(0)
    star = b * sw_inv[None] - g * (gb * smt)[None]
    return (1.0 - omega) * du_a + omega * star


def check_packed(du_a, du_o, ps_a, ps_o, duo_lo, duo_hi, pso_lo, pso_hi):
    """Raise unless the float32 arguments that K4 and K7 share have their
    packed shapes on du_a's device, and the four halo planes are all given
    or all None; returns (d, h, wp)."""
    _, d, h, wp = du_a.shape
    dev = du_a.device
    planes = (duo_lo, duo_hi, pso_lo, pso_hi)
    n_none = sum(x is None for x in planes)
    if n_none not in (0, 4):
        raise ValueError("the halo planes must all be given or all be None")
    for name, x, shape in (("du_a", du_a, (3, d, h, wp)),
                           ("du_o", du_o, (3, d, h, wp)),
                           ("ps_a", ps_a, (d, h, wp)),
                           ("ps_o", ps_o, (d, h, wp)),
                           ("duo_lo", duo_lo, (3, 1, h, wp)),
                           ("duo_hi", duo_hi, (3, 1, h, wp)),
                           ("pso_lo", pso_lo, (1, h, wp)),
                           ("pso_hi", pso_hi, (1, h, wp))):
        if x is not None:
            kernels.check_tensor(name, x, shape, dev)
    return d, h, wp


def plane_ptr(x):
    """A halo plane's device pointer, or null for None (a replica of the
    slab's own face, which the kernel reads in place)."""
    return None if x is None else x.data_ptr()


def sor_halfsweep_packed(du_a, du_o, c_a, g_a, ps_a, ps_o, pd_a,
                         duo_lo, duo_hi, pso_lo, pso_hi, z0: int,
                         alpha: float, omega: float, color: int,
                         dg: int) -> torch.Tensor:
    """One half-sweep updating the packed ``color`` arrays. du_a, du_o, c_a,
    g_a (3, D, H, WP); ps_a, ps_o, pd_a (D, H, WP); duo_lo/duo_hi (3, 1, H,
    WP) and pso_lo/pso_hi (1, H, WP) are the OTHER colour's Z halo planes
    (``HaloCtx.z_halo_planes`` of the packed arrays), or all four None for
    replicas of the slab's own faces (nothing copied; what a whole volume
    on one device passes); z0 is the global z of plane 0 and dg the global
    Z extent. c_a and g_a may be bfloat16.
    Returns the updated active-colour array: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if du_a.device.type == "cpu":
        return sor_halfsweep_packed_plain(
            du_a, du_o, c_a, g_a, ps_a, ps_o, pd_a, duo_lo, duo_hi, pso_lo,
            pso_hi, z0, alpha, omega, color, dg)
    if du_a.device.type != "cuda":
        raise RuntimeError(f"sor_halfsweep_packed: no kernel for "
                           f"{du_a.device}")
    d, h, wp = check_packed(du_a, du_o, ps_a, ps_o, duo_lo, duo_hi, pso_lo,
                            pso_hi)
    dev = du_a.device
    td = kernels.terms_dtype(c_a)
    kernels.check_tensor("c_a", c_a, (3, d, h, wp), dev, td)
    kernels.check_tensor("g_a", g_a, (3, d, h, wp), dev, td)
    kernels.check_tensor("pd_a", pd_a, (d, h, wp), dev)
    out = torch.empty_like(du_a)
    lib = kernels.load_library()
    half_alpha = float(np.float32(alpha)) * 0.5
    with torch.cuda.device(dev):
        kernels.launch(
            "sor_packed", lib.tf3d_sor_halfsweep_packed,
            du_a.data_ptr(), du_o.data_ptr(), c_a.data_ptr(), g_a.data_ptr(),
            ps_a.data_ptr(), ps_o.data_ptr(), pd_a.data_ptr(),
            plane_ptr(duo_lo), plane_ptr(duo_hi), plane_ptr(pso_lo),
            plane_ptr(pso_hi), out.data_ptr(), d, h, wp, int(z0), int(dg),
            half_alpha, omega, 1.0 - omega, int(color),
            int(td == torch.bfloat16), kernels.stream_handle(dev))
    return out
