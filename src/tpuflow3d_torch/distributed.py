"""Multi-process execution and host-local sharded IO.

Port of ``tpuflow3d.distributed``: process-group bring-up
(``torch.distributed`` where the reference starts ``jax.distributed``), the
global Z group over every process, and host-local volume IO in which each
process reads and writes only its own Z slab of the raw files, so no
process holds a global volume. The solve is ``sharding``'s, one rank per
process.

The transport follows the devices the processes took: NCCL when every
process has a GPU of its own, gloo otherwise (CPU processes, or several
processes sharing a GPU, whose halos then pass through host memory). The
choice is logged. The processes always meet in a gloo group first (it
carries the bring-up's small exchanges, among them the devices each
process took, and the checkpoint barriers); under NCCL the Z group is an
NCCL group over the same ranks.
"""

from __future__ import annotations

import socket
import sys
from dataclasses import dataclass

import numpy as np
import torch

from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.sharding import (compute_flow_slab, prepare_params,
                                      process_z_range)
from tpuflow3d_torch.grid import shard_ctx
from tpuflow3d_torch.volume import VolumeMeta, read_raw_slab, write_raw_slab


@dataclass(frozen=True)
class ZGroup:
    """The Z group of this process: ``group`` (None: the default group),
    this process's rank and the group's size, its device and the
    backend."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


_Z: list[ZGroup] = []


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: str | None = None) -> ZGroup:
    """Join the job's processes. With the three arguments omitted they come
    from the environment (``env://``: torchrun's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK); otherwise ``coordinator_address`` is
    ``host:port`` of rank 0.

    ``device``: None takes a GPU (raising where this host has none), the
    k-th of the host's processes the k-th GPU (modulo their count);
    ``"cpu"`` runs on the CPU; ``"cuda:i"`` names the GPU. ``backend``:
    None picks NCCL when every process runs on a GPU that no other process
    took, gloo otherwise (CPU processes, or processes sharing a GPU, whose
    halo exchanges then pass through host buffers); the choice goes to
    stderr."""
    import torch.distributed as dist
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        dist.init_process_group("gloo", init_method="env://")
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together, or none of them")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    rank, size = dist.get_rank(), dist.get_world_size()
    if device is None and not torch.cuda.is_available():
        dist.destroy_process_group()
        raise RuntimeError(
            "the distributed run puts each process on a GPU, and "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "on the CPU")
    host = socket.gethostname()
    hosts = [None] * size
    dist.all_gather_object(hosts, host)
    local_rank = [r for r in range(size) if hosts[r] == host].index(rank)
    gpus = torch.cuda.device_count() if device != "cpu" else 0
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % gpus)
    # The backend follows the devices the ranks took: NCCL refuses two
    # ranks on one GPU, so it needs every rank on a GPU of its own.
    devices = [None] * size
    dist.all_gather_object(devices, (host, dev.type, dev.index))
    own_gpus = (all(t == "cuda" for _, t, _ in devices)
                and len(set(devices)) == size)
    if backend is None:
        backend = "nccl" if own_gpus else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.new_group(backend="nccl") if backend == "nccl" else None
    z = ZGroup(group=group, rank=rank, size=size, device=dev,
               backend=backend)
    _Z[:] = [z]
    route = "device to device" if backend == "nccl" else "through host buffers"
    print(f"tpuflow3d_torch: process {rank} of {size} on {dev}: backend "
          f"{backend} (every process on a GPU of its own: {own_gpus}), halo "
          f"exchanges {route}", file=sys.stderr, flush=True)
    return z


def global_z_group() -> ZGroup:
    """The Z group ``initialize`` made (every process of the job, in rank
    order)."""
    if not _Z:
        raise RuntimeError("distributed.initialize has not been called")
    return _Z[0]


def shutdown() -> None:
    """Leave the job's groups (after the last collective)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _Z.clear()


def load_sharded_volume(path: str, meta: VolumeMeta, z: ZGroup | None = None,
                        dtype=np.float32) -> torch.Tensor:
    """This process's Z slab of a raw volume, read from disk alone (raw
    z-major files: one contiguous range), as a tensor on its device."""
    z = global_z_group() if z is None else z
    lo, hi = process_z_range(meta.shape[0], z.size, z.rank)
    slab = read_raw_slab(path, meta, lo, hi - lo).astype(dtype, copy=False)
    return torch.as_tensor(slab, device=z.device)


def save_sharded_flow(prefix: str, flow: torch.Tensor, d_global: int,
                      z: ZGroup | None = None) -> None:
    """Write this process's slab of the flow (3, D/n, H, W) into the
    global u/v/w raw files (u = x, v = y, w = z displacement); every
    process writes only its planes."""
    z = global_z_group() if z is None else z
    _, dl, h, w = flow.shape
    meta = VolumeMeta((d_global, h, w), "float32")
    data = flow.detach().cpu().numpy()
    lo, _ = process_z_range(d_global, z.size, z.rank)
    for c, name in ((2, "u"), (1, "v"), (0, "w")):
        write_raw_slab(f"{prefix}{name}.raw", meta, lo, data[c])


def compute_flow_distributed(frame0: str, frame1: str, meta: VolumeMeta,
                             params: FlowParams = FlowParams(),
                             z: ZGroup | None = None,
                             out_prefix: str | None = None,
                             checkpoint_dir: str | None = None,
                             timer=None) -> torch.Tensor:
    """End-to-end multi-process run: host-local slab load, the Z-sharded
    solve, and (with ``out_prefix``) host-local slab writes. Every process
    calls it; each gets its own slab of the flow (3, D/n, H, W) on its
    device. The Z extent must be divisible by the process count. With
    ``checkpoint_dir`` the flow is saved per rank at every level boundary
    and a resume reads only each process's slab."""
    z = global_z_group() if z is None else z
    if meta.shape[0] % z.size:
        raise ValueError(f"Z extent {meta.shape[0]} not divisible by "
                         f"process count {z.size}")
    params = prepare_params(params, z.size)
    i0 = load_sharded_volume(frame0, meta, z)
    i1 = load_sharded_volume(frame1, meta, z)
    ctx = shard_ctx(z.group)
    flow = compute_flow_slab(i0, i1, params, ctx,
                             checkpoint_dir=checkpoint_dir, timer=timer)
    if out_prefix is not None:
        save_sharded_flow(out_prefix, flow, meta.shape[0], z)
    return flow
