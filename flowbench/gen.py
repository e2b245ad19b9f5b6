"""The benchmark's traffic: synthetic volume pairs made on the device.

A torch copy of the generator the port ships for its own tests
(``FourierField``, ``sinusoid``, ``invert_flow``, ``epe``,
``gradient_mask``, ``interior_mask``): a band-limited texture of random
plane waves, deformed by a smooth nonrigid sinusoid whose inverse is found
by fixed-point iteration, so the pair (I0 = f(x), I1 = f(psi(x))) has the
exact forward flow s. The mode parameters come from numpy's generator
seeded as the port's copy seeds it (64 modes: a few hundred numbers on the
host); every volume-sized array is evaluated on the device in float64, in
slabs of Z planes, and the volumes are returned as float32. A traffic may
add a brightness change to I1 (``make_pair``'s ``intensity``), worked out
on the host from the returned float32 volume. Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Voxels evaluated at once (a slab of whole planes): bounds the float64
# working set at about a dozen arrays of this many values.
_SLAB_VOXELS = 1 << 23


class Modes(NamedTuple):
    """A FourierField's plane waves: wave vectors (n, 3) in (z, y, x),
    phases (n,), amplitudes (n,)."""
    k: np.ndarray
    phase: np.ndarray
    amp: np.ndarray


def fourier_modes(seed, n_modes: int = 64, kmin: float = 0.2,
                  kmax: float = 0.7) -> Modes:
    """The modes ``FourierField(n_modes, seed, kmin, kmax)`` draws, drawn in
    the same order from the same generator."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_modes, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = rng.uniform(kmin, kmax, n_modes)
    phase = rng.uniform(0, 2 * np.pi, n_modes)
    amp = rng.uniform(0.3, 1.0, n_modes) / np.sqrt(n_modes)
    return Modes(d * k[:, None], phase, amp)


def field(modes: Modes, pts) -> torch.Tensor:
    """sum_m amp_m cos(k_m . p + phase_m) at the points ``pts`` (a tuple of
    z, y, x float64 tensors that broadcast together)."""
    out = None
    for kk, ph, a in zip(modes.k.tolist(), modes.phase.tolist(),
                         modes.amp.tolist()):
        term = a * torch.cos(kk[0] * pts[0] + kk[1] * pts[1]
                             + kk[2] * pts[2] + ph)
        out = term if out is None else out + term
    return out


def sinusoid(shape, amplitude: float = 1.5, periods: float = 1.0):
    """The smooth nonrigid displacement of ``synthetic.sinusoid``: a
    function of (z, y, x) tensors giving the (dz, dy, dx) tensors."""
    k = [2 * math.pi * periods / float(n) for n in shape]

    def fn(z, y, x):
        return (amplitude * torch.sin(k[1] * y) * torch.cos(k[2] * x),
                amplitude * torch.sin(k[2] * x) * torch.cos(k[0] * z),
                amplitude * torch.sin(k[0] * z) * torch.cos(k[1] * y))
    return fn


def invert_flow(flow_fn, pts, iters: int = 30):
    """psi with psi(y) = y - s(psi(y)), by fixed point from psi = y."""
    psi = pts
    for _ in range(iters):
        s = flow_fn(*psi)
        psi = tuple(p - q for p, q in zip(pts, s))
    return psi


def _grid(shape, z0: int, z1: int, device):
    """The voxel centres of planes [z0, z1) as broadcasting float64
    (z, y, x) tensors, each made whole (the deformation mixes axes)."""
    _, h, w = shape
    kw = dict(dtype=torch.float64, device=device)
    z = torch.arange(z0, z1, **kw).reshape(-1, 1, 1)
    y = torch.arange(h, **kw).reshape(1, h, 1)
    x = torch.arange(w, **kw).reshape(1, 1, w)
    full = (z1 - z0, h, w)
    return z.expand(full), y.expand(full), x.expand(full)


def _slabs(shape):
    d, h, w = shape
    step = max(1, _SLAB_VOXELS // (h * w))
    return [(z0, min(z0 + step, d)) for z0 in range(0, d, step)]


def make_pair(shape, seed, texture: dict, deformation: dict,
              device, intensity: dict | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """(i0, i1) as float32 host arrays: the FourierField of ``seed`` at the
    voxel centres and at the inverse-deformed ones. ``texture``: modes,
    kmin, kmax; ``deformation``: amplitude, periods; ``intensity``, a
    brightness change of the moving volume i1 (the traffic file's
    groups): None for none, or ``{"kind": "offset", "std_fraction": k}``,
    which adds k * std(i1), the additive offset of VALIDATION.md's
    gradient-constancy study. The std is i1's population std in float64
    over the whole volume, on the host, and the offset, rounded to
    float32, is added to i1 in place: the pair does not depend on the
    device. The true flow is unchanged."""
    _check_intensity(intensity)
    i0 = np.empty(shape, np.float32)
    i1 = np.empty(shape, np.float32)
    fill_planes(i0, i1, seed, texture, deformation, 0, shape[0], device)
    add_intensity(i1, intensity)
    return i0, i1


def fill_planes(i0: np.ndarray, i1: np.ndarray, seed, texture: dict,
                deformation: dict, z0: int, z1: int, device) -> None:
    """Planes [z0, z1) of ``make_pair``'s (i0, i1) before its brightness
    change, written into ``i0`` and ``i1`` (whole volumes): each voxel is
    evaluated alone, so planes filled apart (a sharded cell's ranks, each
    on its own card) make ``make_pair``'s pair bit for bit."""
    if texture.get("kind", "fourier") != "fourier" or \
            deformation.get("kind", "sinusoid") != "sinusoid":
        raise ValueError("the generator makes fourier textures under a "
                         "sinusoid deformation")
    shape = i0.shape
    modes = fourier_modes(seed, texture["modes"], texture["kmin"],
                          texture["kmax"])
    fn = sinusoid(shape, deformation["amplitude"], deformation["periods"])
    step = max(1, _SLAB_VOXELS // (shape[1] * shape[2]))
    for a in range(z0, z1, step):
        b = min(a + step, z1)
        pts = _grid(shape, a, b, device)
        i0[a:b] = field(modes, pts).float().cpu().numpy()
        i1[a:b] = field(modes, invert_flow(fn, pts)).float().cpu().numpy()


def _check_intensity(intensity: dict | None) -> None:
    if intensity is not None and intensity.get("kind") != "offset":
        raise ValueError(f"unknown intensity change {intensity!r}: the "
                         f"generator adds an offset (kind \"offset\")")


def add_intensity(i1: np.ndarray, intensity: dict | None) -> None:
    """``make_pair``'s brightness change of the whole moving volume, in
    place, once every plane is filled."""
    _check_intensity(intensity)
    if intensity is not None:
        i1 += np.float32(intensity["std_fraction"]
                         * float(np.std(i1, dtype=np.float64)))


def true_flow_slab(shape, deformation: dict, z0: int, z1: int,
                   device) -> torch.Tensor:
    """The true flow of planes [z0, z1), (3, z1 - z0, H, W) float32, as
    ``synthetic.make_pair`` returns it (float64 rounded to float32)."""
    fn = sinusoid(shape, deformation["amplitude"], deformation["periods"])
    return torch.stack(fn(*_grid(shape, z0, z1, device))).float()


def gradient_mask(i0: torch.Tensor, quantile: float) -> torch.Tensor:
    """``synthetic.gradient_mask``: |np.gradient(i0)| (float64) above its
    ``quantile`` (np.quantile's linear interpolation)."""
    v = i0.double()
    mag = torch.sqrt(sum(g * g for g in torch.gradient(v)))
    flat = mag.flatten().sort().values
    pos = quantile * (flat.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, flat.numel() - 1)
    thr = flat[lo] + (flat[hi] - flat[lo]) * (pos - lo)
    return mag > thr


def interior_mask(shape, border: int, device) -> torch.Tensor:
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[border:-border or None, border:-border or None,
      border:-border or None] = True
    return m


def epe(flow: np.ndarray, i0: np.ndarray, deformation: dict,
        quantile: float, border: int, device) -> float:
    """Mean endpoint error of a (3, D, H, W) flow against the true flow,
    over the textured interior of i0 (``gradient_mask`` at ``quantile``
    and ``interior_mask`` of ``border``), in float64 on ``device``, slab
    by slab."""
    shape = i0.shape
    mask = gradient_mask(torch.as_tensor(i0, device=device), quantile)
    mask &= interior_mask(shape, border, device)
    total, count = 0.0, 0
    for z0, z1 in _slabs(shape):
        true = true_flow_slab(shape, deformation, z0, z1, device).double()
        est = torch.as_tensor(flow[:, z0:z1], device=device).double()
        err = torch.sqrt(((est - true) ** 2).sum(0))
        m = mask[z0:z1]
        total += float(err[m].sum())
        count += int(m.sum())
    if count == 0:
        raise ValueError("epe: empty mask")
    return total / count
