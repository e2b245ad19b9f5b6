"""Synthetic volume pairs with analytic ground-truth flow, and EPE metrics.

A numpy-only copy of ``tpuflow3d.synthetic`` (make_pair and the
displacement fields and masks it is used with), so that the port can make
its inputs on a machine without JAX. Volumes are analytic sums of Gaussian
blobs (or plane waves) evaluated at real coordinates; the moving volume is
the same field at the inverse-deformed coordinates, found by fixed-point
iteration. ``tests/test_torch_package.py`` checks that the arrays are
bitwise those of the reference.
"""

from __future__ import annotations

import numpy as np

_COORD_DTYPE = np.float64  # float32 for big volumes via set_coord_dtype


def set_coord_dtype(dtype) -> None:
    """Ground-truth coordinate precision: float64 by default; float32
    makes 256^3 and larger pairs several times faster to generate, at
    ~1e-4 voxels of error in the truth. A module global, as in the
    reference: restore the default when done."""
    global _COORD_DTYPE
    _COORD_DTYPE = np.dtype(dtype)


def _coords(shape: tuple[int, int, int]) -> np.ndarray:
    """(3, D, H, W) voxel-center coordinates (z, y, x)."""
    d, h, w = shape
    z, y, x = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                          indexing="ij")
    return np.stack([z, y, x]).astype(_COORD_DTYPE)


class BlobField:
    """Analytic volume: sum of anisotropic Gaussian blobs on a DC offset."""

    def __init__(self, shape, n_blobs=40, seed=0, margin=0.15):
        rng = np.random.default_rng(seed)
        dims = np.asarray(shape, np.float64)
        lo, hi = margin * dims, (1 - margin) * dims
        self.centers = rng.uniform(lo, hi, size=(n_blobs, 3))
        self.sigmas = rng.uniform(0.02, 0.10, size=(n_blobs, 3)) * dims
        self.amps = rng.uniform(0.3, 1.0, size=n_blobs)
        self.shape = tuple(shape)

    def eval(self, coords: np.ndarray) -> np.ndarray:
        """coords: (3, ...) real-valued; returns intensity at those points.
        Evaluated in chunks to bound the working set at large volumes."""
        dt = coords.dtype
        pts = coords.reshape(3, -1)
        n = pts.shape[1]
        out = np.zeros(n, np.float32)
        chunk = 1 << 23
        centers = self.centers.astype(dt)
        sigmas = self.sigmas.astype(dt)
        for lo in range(0, n, chunk):
            seg = pts[:, lo:lo + chunk]
            acc = np.zeros(seg.shape[1], dt)
            for c, s, a in zip(centers, sigmas, self.amps):
                q = ((seg[0] - c[0]) / s[0]) ** 2
                q += ((seg[1] - c[1]) / s[1]) ** 2
                q += ((seg[2] - c[2]) / s[2]) ** 2
                acc += a * np.exp(-0.5 * q)
            out[lo:lo + chunk] = acc
        return out.reshape(coords.shape[1:])


class FourierField:
    """Analytic band-limited texture: a sum of random plane waves (dense
    gradients in every direction, so nonrigid flow is data-constrained)."""

    def __init__(self, n_modes=64, seed=0, kmin=0.2, kmax=0.7):
        rng = np.random.default_rng(seed)
        d = rng.normal(size=(n_modes, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        k = rng.uniform(kmin, kmax, n_modes)
        self.k = d * k[:, None]
        self.phase = rng.uniform(0, 2 * np.pi, n_modes)
        self.amp = rng.uniform(0.3, 1.0, n_modes) / np.sqrt(n_modes)

    def eval(self, coords: np.ndarray) -> np.ndarray:
        pts = coords.reshape(3, -1)
        out = np.zeros(pts.shape[1])
        for kk, ph, a in zip(self.k, self.phase, self.amp):
            out += a * np.cos(kk @ pts + ph)
        return out.reshape(coords.shape[1:]).astype(np.float32)


def invert_flow(flow_fn, coords: np.ndarray, iters: int = 30) -> np.ndarray:
    """Solve psi(y) = y - s(psi(y)) by fixed point, so that the pair
    (I0 = f(x), I1 = f(psi(y))) has exact forward flow s."""
    psi = coords.copy()
    for _ in range(iters):
        psi = coords - flow_fn(psi)
    return psi


def make_pair(shape, flow_fn, n_blobs=40, seed=0, texture="blobs"):
    """Build (i0, i1, true_flow) for a prescribed displacement field.

    flow_fn maps (3, ...) coordinates to (3, ...) displacements (z, y, x).
    texture: "blobs" (sparse tomography-like features) or "fourier" (dense
    band-limited texture). Returns float32 volumes of ``shape`` and the
    (3, D, H, W) true flow sampled at voxel centers.
    """
    if texture == "fourier":
        field = FourierField(seed=seed)
    else:
        field = BlobField(shape, n_blobs=n_blobs, seed=seed)
    coords = _coords(shape)
    i0 = field.eval(coords)
    psi = invert_flow(flow_fn, coords)
    i1 = field.eval(psi)
    true_flow = flow_fn(coords).astype(np.float32)
    return i0, i1, true_flow


# ---- prescribed displacement fields ----

def translation(shift):
    """Constant translation; shift = (dz, dy, dx) in voxels."""
    s = np.asarray(shift, np.float64)

    def fn(coords):
        sh = s.astype(coords.dtype).reshape(3, *([1] * (coords.ndim - 1)))
        return np.broadcast_to(sh, coords.shape)
    return fn


def rotation(center, axis="z", degrees=2.0):
    """Small rigid rotation about ``center`` (about one axis)."""
    th = np.deg2rad(degrees)
    c = np.asarray(center, np.float64)
    i, j = {"z": (1, 2), "y": (0, 2), "x": (0, 1)}[axis]

    def fn(coords):
        out = np.zeros_like(coords)
        pi = coords[i] - c[i]
        pj = coords[j] - c[j]
        out[i] = (np.cos(th) * pi - np.sin(th) * pj) - pi
        out[j] = (np.sin(th) * pi + np.cos(th) * pj) - pj
        return out
    return fn


def sinusoid(shape, amplitude=1.5, periods=1.0):
    """Smooth nonrigid sinusoidal displacement."""
    dims = np.asarray(shape, np.float64)
    k = 2 * np.pi * periods / dims

    def fn(coords):
        z, y, x = coords[0], coords[1], coords[2]
        return np.stack([
            amplitude * np.sin(k[1] * y) * np.cos(k[2] * x),
            amplitude * np.sin(k[2] * x) * np.cos(k[0] * z),
            amplitude * np.sin(k[0] * z) * np.cos(k[1] * y),
        ])
    return fn


# ---- metrics ----

def epe(flow_est, flow_true, mask=None) -> float:
    """Mean endpoint error |s_est - s_true|_2, optionally over a mask."""
    est = np.asarray(flow_est, np.float64)
    true = np.asarray(flow_true, np.float64)
    err = np.sqrt(((est - true) ** 2).sum(axis=0))
    if mask is not None:
        if not np.any(mask):
            raise ValueError("epe: empty mask")
        return float(err[mask].mean())
    return float(err.mean())


def gradient_mask(i0: np.ndarray, quantile: float = 0.5) -> np.ndarray:
    """Mask of voxels with meaningful image gradient (where flow is
    observable; elsewhere only the smoothness prior determines it)."""
    gz, gy, gx = np.gradient(np.asarray(i0, np.float64))
    mag = np.sqrt(gz ** 2 + gy ** 2 + gx ** 2)
    return mag > np.quantile(mag, quantile)


def interior_mask(shape, border=4) -> np.ndarray:
    """True away from the volume faces. border: int or per-axis (bz, by,
    bx)."""
    bz, by, bx = (border,) * 3 if np.isscalar(border) else border
    m = np.zeros(shape, bool)
    m[bz or None:-bz or None, by or None:-by or None,
      bx or None:-bx or None] = True
    return m
