"""Grid utilities: Neumann padding, the Z-halo exchange and the halo context.

Port of ``tpuflow3d.grid``: the whole volume on one device, a streamed
window of a larger one (the out-of-core mode, ``piecewise.py``), or a Z
slab of a volume sharded over the ranks of a ``torch.distributed`` group
(``sharding.py``). Every stencil op goes through ``HaloCtx.zpad`` /
``HaloCtx.z_halo_planes`` for its Z margin and through
``psum``/``pmin``/``pmax`` for its reductions, as in the reference, so the
sharded run is the one-device code under another context.

Axis convention: volumes are (D, H, W) = (z, y, x); flow fields are
(3, D, H, W) with component c displacing along array axis c. Z is always
axis -3 so volumes and flow fields share all helpers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

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


def _edge_planes(x: torch.Tensor, nh: int, side: str) -> torch.Tensor:
    """nh copies of x's first (``"lo"``) or last (``"hi"``) Z plane."""
    d = x.shape[Z_AXIS]
    plane = 0 if side == "lo" else d - 1
    idx = torch.full((nh,), plane, dtype=torch.long, device=x.device)
    return x.index_select(Z_AXIS, idx)


@dataclass
class CommStats:
    """What the sharded contexts' collectives cost this process: halo
    exchanges (``zpad``/``z_halo_planes`` with neighbours), all-gathers
    (slabs thinner than the halo, the reductions' values), reductions,
    the bytes this rank sent, and host seconds inside these calls
    (staging copies and waits included)."""
    exchanges: int = 0
    gathers: int = 0
    reductions: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)

    def reset(self) -> None:
        self.__init__()


# Every sharded context of this process adds to it, as each kernel wrapper
# adds its launches to ``kernels.LAUNCHES``.
COMM = CommStats()


@dataclass(frozen=True)
class HaloCtx:
    """Execution context of the stencil ops: one device, a streamed
    window, or a Z shard. A context is a window or a shard, never both.

    By default the local volume is the global one: Z margins are edge
    replicas and reductions are the identity.

    In window mode (``window_z0``/``window_d_global`` set, see
    ``piecewise.py``) it is a Z-chunk slab of a volume of
    ``window_d_global`` planes whose plane 0 is global plane ``window_z0``,
    margins included: z0 may be negative (a margin hanging below the
    volume). Parity, face masks and warp clipping then answer in global
    coordinates; ``zpad`` and ``z_halo_planes`` still replicate the slab's
    own faces, so an op over-pads the slab and the streaming loop crops
    the planes that the replicas reach.

    In sharded mode (``n_shards`` > 1, made by ``shard_ctx``) the local
    volume is rank ``rank``'s slab of ``d_local`` planes of a volume of
    ``d_local * n_shards``, every rank's slab of one depth (the
    reference's ``shard_map`` over a 1-D Z mesh). ``zpad`` and
    ``z_halo_planes`` take the neighbours' planes on interior faces and
    edge replicas on the two global faces; a slab thinner than the halo
    all-gathers Z (the coarse levels). ``psum``/``pmin``/``pmax`` reduce
    over the group, and every rank gets the same bits. Every rank must
    make the same sequence of calls, as under the reference's SPMD
    program. ``staged`` (the gloo backend) sends CUDA tensors through
    host buffers, explicitly; under NCCL device tensors go as they are.
    ``COMM`` counts what the collectives cost."""

    window_z0: int | None = None
    window_d_global: int | None = None
    n_shards: int = 1
    rank: int = 0
    group: object = field(default=None, compare=False, repr=False)
    staged: bool = False

    def __post_init__(self):
        if self.n_shards > 1 and self.window_z0 is not None:
            raise ValueError("a HaloCtx is a window or a shard, not both")
        if not 0 <= self.rank < self.n_shards:
            raise ValueError(f"rank {self.rank} of {self.n_shards} shards")

    @property
    def has_z_neighbors(self) -> bool:
        """Whether the local slab has neighbouring slabs along Z whose
        planes a stencil must read (a Z-sharded slab). One device has
        none: the slab is the whole volume, or a window whose margins the
        caller crops."""
        return self.n_shards > 1

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
        if self.window_z0 is not None:
            return self.window_z0
        return self.rank * d_local

    def z_global(self, d_local: int, device=None) -> torch.Tensor:
        """Global z index of each local plane, shape (d_local, 1, 1)."""
        idx = torch.arange(d_local, device=device).reshape(d_local, 1, 1)
        return idx + self.z0(d_local)

    def d_global(self, d_local: int) -> int:
        if self.window_d_global is not None:
            return self.window_d_global
        return d_local * self.n_shards

    # ---- halo exchange / padding ----

    def zpad(self, x: torch.Tensor, nh: int) -> torch.Tensor:
        """Pad Z by nh planes per side: neighbour planes on interior faces
        of a shard, edge replication on global faces (and everywhere on one
        device or a window)."""
        if nh == 0:
            return x
        if not self.has_z_neighbors:
            return replicate_pad(x, nh, axis=Z_AXIS)
        d = x.shape[Z_AXIS]
        if d < nh:
            # A slab thinner than the halo (a coarse level): the margin
            # spans several shards. These levels are small: gather the
            # whole Z extent and cut the padded slab out of it.
            xg = replicate_pad(self._all_gather_z(x), nh, axis=Z_AXIS)
            return xg.narrow(Z_AXIS, self.z0(d), d + 2 * nh)
        lo, hi = self._neighbor_planes(x, nh)
        return torch.cat([lo, x, hi], dim=x.ndim + Z_AXIS)

    def z_halo_planes(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One-plane Z halos (lo, hi) as separate contiguous arrays of
        z-extent 1, the form the kernels take them in: the neighbours'
        planes on interior faces of a shard, replicas of the slab's own
        faces otherwise."""
        if not self.has_z_neighbors:
            d = x.shape[Z_AXIS]
            return (x.narrow(Z_AXIS, 0, 1).contiguous(),
                    x.narrow(Z_AXIS, d - 1, 1).contiguous())
        return self._neighbor_planes(x, 1)

    def _neighbor_planes(self, x: torch.Tensor, nh: int):
        """(lo, hi): the nh planes below the slab (the previous rank's top
        planes, or edge replicas on rank 0) and above it (the next rank's
        bottom planes, or edge replicas on the last rank), contiguous."""
        d = x.shape[Z_AXIS]
        first, last = self.rank == 0, self.rank == self.n_shards - 1
        sends, recvs = [], []
        if not first:
            sends.append((self.rank - 1, x.narrow(Z_AXIS, 0, nh)))
            recvs.append(self.rank - 1)
        if not last:
            sends.append((self.rank + 1, x.narrow(Z_AXIS, d - nh, nh)))
            recvs.append(self.rank + 1)
        got = dict(zip(recvs, self._exchange(sends, recvs)))
        lo = (_edge_planes(x, nh, "lo") if first else got[self.rank - 1])
        hi = (_edge_planes(x, nh, "hi") if last else got[self.rank + 1])
        return lo, hi

    # ---- transport ----

    def _global_rank(self, r: int) -> int:
        import torch.distributed as dist
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _to_host(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Staged transport: contiguous host copies of CUDA tensors
        (page-locked, copied without blocking, then one stream
        synchronize); host tensors as they are. Gloo's send of a CUDA
        tensor aborts the sending process (torch 2.11.0+cu128: writev: Bad
        address), though its all_reduce, all_gather and broadcast take
        them: every exchange is staged alike."""
        out = []
        for t in ts:
            if t.device.type == "cuda" and self.staged:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                out.append(buf.copy_(t, non_blocking=True))
            else:
                out.append(t.contiguous())
        if any(t.device.type == "cuda" for t in ts) and self.staged:
            torch.cuda.current_stream(ts[0].device).synchronize()
        return out

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for a tensor like ``like``: page-locked host
        memory under staging, else on its device."""
        if like.device.type == "cuda" and self.staged:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty_like(like, memory_format=torch.contiguous_format)

    def _back(self, t: torch.Tensor, device) -> torch.Tensor:
        return t.to(device, non_blocking=True) if t.device != device else t

    def _exchange(self, sends, recvs) -> list[torch.Tensor]:
        """Point-to-point: send each (group rank, tensor) of ``sends`` and
        receive one tensor of the same shape from each group rank of
        ``recvs`` (sends and receives pair up by neighbour), through
        ``batch_isend_irecv``."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        like = sends[0][1]
        dev = like.device
        bufs = self._to_host([t for _, t in sends])
        out = [self._buffer(like) for _ in recvs]
        ops = [dist.P2POp(dist.isend, b, self._global_rank(r), self.group)
               for (r, _), b in zip(sends, bufs)]
        ops += [dist.P2POp(dist.irecv, b, self._global_rank(r), self.group)
                for r, b in zip(recvs, out)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = [self._back(b, dev) for b in out]
        COMM.exchanges += 1
        COMM.bytes_sent += sum(b.numel() * b.element_size() for b in bufs)
        COMM.seconds += time.perf_counter() - t0
        return out

    def _all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's x (one shape on all ranks), in rank order."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        (buf,) = self._to_host([x])
        parts = [self._buffer(x) for _ in range(self.n_shards)]
        dist.all_gather(parts, buf, group=self.group)
        parts = [self._back(p, x.device) for p in parts]
        COMM.gathers += 1
        COMM.bytes_sent += buf.numel() * buf.element_size()
        COMM.seconds += time.perf_counter() - t0
        return parts

    def _all_gather_z(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._all_gather(x), dim=x.ndim + Z_AXIS)

    # ---- collectives over the Z group ----

    def _reduce(self, v, how: str):
        """All ranks' v (a tensor) reduced in rank order on each rank, so
        that every rank holds the same bits (what an early stop needs)."""
        if not self.has_z_neighbors:
            return v
        COMM.reductions += 1
        stacked = torch.stack(self._all_gather(torch.as_tensor(v)))
        if how == "sum":
            acc = stacked[0]
            for part in stacked[1:]:
                acc = acc + part
            return acc
        return stacked.amin(0) if how == "min" else stacked.amax(0)

    def psum(self, v):
        return self._reduce(v, "sum")

    def pmin(self, v):
        return self._reduce(v, "min")

    def pmax(self, v):
        return self._reduce(v, "max")


def shard_ctx(group=None) -> HaloCtx:
    """The sharded context of this process in ``group`` (the default group
    when None; ``torch.distributed`` initialised): its rank, the group's
    size, and the transport chosen from the group's backend (gloo: CUDA
    tensors through host buffers; NCCL: device tensors;
    ``distributed.initialize`` logs the choice)."""
    import torch.distributed as dist
    return HaloCtx(n_shards=dist.get_world_size(group),
                   rank=dist.get_rank(group), group=group,
                   staged=str(dist.get_backend(group)) == "gloo")
