"""Grid utilities: Neumann padding and the halo context.

Port of ``tpuflow3d.grid`` for one device: the whole volume, or a streamed
window of a larger one (the out-of-core mode, ``piecewise.py``). Every
stencil op goes through ``HaloCtx.zpad`` / ``HaloCtx.z_halo_planes`` for
its Z margin, as in the reference, so the Z-sharded context can later
replace this one without touching the ops.

Axis convention: volumes are (D, H, W) = (z, y, x); flow fields are
(3, D, H, W) with component c displacing along array axis c. Z is always
axis -3 so volumes and flow fields share all helpers.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

Z_AXIS = -3  # z axis for both (D,H,W) volumes and (3,D,H,W) flow fields


def replicate_pad(x: torch.Tensor, nh: int, axis: int) -> torch.Tensor:
    """Edge-replicate pad by nh on both sides of one axis (Neumann BC)."""
    if nh == 0:
        return x
    n = x.shape[axis]
    idx = torch.arange(-nh, n + nh, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def pad_yx(x: torch.Tensor, nh: int) -> torch.Tensor:
    """Edge-replicate pad the y and x axes."""
    return replicate_pad(replicate_pad(x, nh, axis=-1), nh, axis=-2)


def neighbor_slices(xp: torch.Tensor, nh: int, axis: int,
                    delta: int) -> torch.Tensor:
    """Shifted view of a padded array: value at p + delta*e_axis.

    xp must be padded by nh >= |delta| along ``axis``; returns a view of
    the unpadded length along ``axis``."""
    n = xp.shape[axis] - 2 * nh
    return xp.narrow(axis, nh + delta, n)


@dataclass(frozen=True)
class HaloCtx:
    """One-device execution context. Z margins are edge replicas and
    reductions are the identity. (The reference's Z-sharded mode is not
    ported yet.)

    By default the local volume is the global one. In window mode
    (``window_z0``/``window_d_global`` set, see ``piecewise.py``) it is a
    Z-chunk slab of a volume of ``window_d_global`` planes whose plane 0
    is global plane ``window_z0``, margins included: z0 may be negative
    (a margin hanging below the volume). Parity, face masks and warp
    clipping then answer in global coordinates; ``zpad`` and
    ``z_halo_planes`` still replicate the slab's own faces, so an op
    over-pads the slab and the streaming loop crops the planes that the
    replicas reach."""

    window_z0: int | None = None
    window_d_global: int | None = None

    @property
    def n_shards(self) -> int:
        """Number of Z shards (coarse multigrid Z dims stay multiples of
        it)."""
        return 1

    @property
    def has_z_neighbors(self) -> bool:
        """Whether the local slab has neighbouring slabs along Z whose
        planes a stencil must read (a Z-sharded slab). One device has
        none: the slab is the whole volume, or a window whose margins the
        caller crops."""
        return False

    @property
    def is_window(self) -> bool:
        return self.window_z0 is not None

    def is_whole(self, d_local: int) -> bool:
        """Whether the local slab is the whole volume (global plane 0 first,
        ``d_local`` planes in all) and has no Z neighbours. Only then may
        the sweep kernels take null halo planes and fuse red and black in
        one launch."""
        return (not self.has_z_neighbors and int(self.z0(d_local)) == 0
                and self.d_global(d_local) == d_local)

    def z0(self, d_local: int) -> int:
        """Global z index of local plane 0."""
        return 0 if self.window_z0 is None else self.window_z0

    def z_global(self, d_local: int, device=None) -> torch.Tensor:
        """Global z index of each local plane, shape (d_local, 1, 1)."""
        idx = torch.arange(d_local, device=device).reshape(d_local, 1, 1)
        return idx + self.z0(d_local)

    def d_global(self, d_local: int) -> int:
        if self.window_d_global is not None:
            return self.window_d_global
        return d_local

    def zpad(self, x: torch.Tensor, nh: int) -> torch.Tensor:
        """Pad Z by nh planes per side (edge replication)."""
        return replicate_pad(x, nh, axis=Z_AXIS)

    def z_halo_planes(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One-plane Z halos (lo, hi) as separate contiguous arrays of
        z-extent 1, the form the kernels take them in."""
        d = x.shape[Z_AXIS]
        return (x.narrow(Z_AXIS, 0, 1).contiguous(),
                x.narrow(Z_AXIS, d - 1, 1).contiguous())

    def psum(self, v):
        return v

    def pmin(self, v):
        return v

    def pmax(self, v):
        return v
