"""Z-sharded execution over ``torch.distributed``.

Port of ``tpuflow3d.sharding``. The volume is split along Z into one slab
per rank; every stencil, warp and resample op takes its margin planes from
the neighbouring ranks through the sharded ``grid.HaloCtx`` (point-to-point
halo exchanges, an all-gather where a coarse slab is thinner than the
halo), and the reductions are all-reduces. Each rank runs the level loop
of the one-device solve (``pipeline.drive``, its segments called directly
through ``pipeline.compute_flow_impl``) on its slab under that context,
as the reference runs the same function under ``shard_map``. The warp
samples at global coordinates (``warp.warp_volume``), so a sharded flow
is bitwise the one-device flow with the same ``prepare_params``.

``compute_flow_sharded`` runs two ways:

- called from one process, it spawns one rank per listed device (a free
  port on localhost; the backend as ``distributed.initialize`` picks it,
  and one thread per CPU rank), scatters the slabs, and gathers
  the flow: the reference's single-process ``--sharded``. A device may be
  listed more than once: its ranks then share it under gloo, the halos
  passing through host memory (how one GPU runs a sharded solve).
- called inside an initialised ``torch.distributed`` group, every rank
  calls it (SPMD) and gets its own slab of the flow: the multi-process
  path (``distributed.py``, the command line's ``--distributed``).
"""

from __future__ import annotations

import math
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch

from tpuflow3d_torch.backend import check_supported
from tpuflow3d_torch.grid import HaloCtx, shard_ctx
from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.pipeline import compute_flow_impl
from tpuflow3d_torch.utils.profiling import PhaseTimer

# Sharded runs need a static displacement bound: it sizes the warp's Z
# halo (ceil(clamp)+1 planes, +1 tricubic). The clamp caps the motion a
# level can recover, so raise FlowParams.flow_clamp for large motions: the
# halo grows with it linearly.
DEFAULT_FLOW_CLAMP = 4.0
# Seconds a spawned rank may take to report after another one has failed
# before the rest are stopped.
_GRACE_S = 60.0


def prepare_params(params: FlowParams, n_shards: int) -> FlowParams:
    """Make params shard-compatible: every level's Z dim a multiple of the
    shard count, and a positive flow clamp (bounds the warp halo)."""
    if params.z_multiple % n_shards != 0:
        params = params.replace(
            z_multiple=params.z_multiple * n_shards
            // math.gcd(params.z_multiple, n_shards))
    if params.flow_clamp <= 0.0:
        params = params.replace(flow_clamp=DEFAULT_FLOW_CLAMP)
    return params


def make_z_group(n_devices: int | None = None,
                 devices=None) -> tuple[torch.device, ...]:
    """The devices of a sharded run, one rank on each, in Z order (the
    counterpart of the reference's ``make_z_mesh``): ``devices`` as given
    (a device may repeat: its ranks share it), else every visible GPU, or
    the first ``n_devices`` of them. Raises where there is no GPU and no
    device is named (``["cpu"] * n`` runs n ranks on the CPU), or where
    ``n_devices`` is more than there are."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a sharded run puts one rank on each GPU, and "
                "torch.cuda.is_available() is false; pass devices=[\"cpu\"] "
                "* n to run n ranks on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"{n_devices} devices asked for, "
                                 f"{len(devices)} visible")
            devices = devices[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a sharded run needs at least one device")
    return devices


def process_z_range(d_global: int, n_shards: int,
                    rank: int) -> tuple[int, int]:
    """The global Z planes [lo, hi) of rank ``rank``'s slab."""
    if d_global % n_shards:
        raise ValueError(f"Z extent {d_global} not divisible by "
                         f"{n_shards} shards")
    per = d_global // n_shards
    return rank * per, (rank + 1) * per


def compute_flow_slab(i0l: torch.Tensor, i1l: torch.Tensor, p: FlowParams,
                      ctx: HaloCtx, diagnostics: bool = False,
                      checkpoint_dir: str | None = None, timer=None):
    """This rank's slab of the flow, (3, D/n, H, W) on the slabs' device,
    from its slabs of the two volumes (every rank calls it; ``p`` already
    through ``prepare_params``): ``pipeline.compute_flow_impl`` under the
    rank's context, the level loop the one-device solve replays."""
    check_supported(p, i0l)
    return compute_flow_impl(i0l, i1l, p, ctx, diagnostics, checkpoint_dir,
                             timer)


def compute_flow_sharded(i0, i1, params: FlowParams = FlowParams(),
                         devices=None, diagnostics: bool = False,
                         checkpoint_dir: str | None = None, timer=None,
                         group=None):
    """Z-sharded dense 3D optical flow.

    i0/i1: (D, H, W) volumes (numpy arrays or tensors) with D divisible by
    the number of ranks (pad with ``volume.pad_to_multiple``). ``params``
    go through ``prepare_params``.

    - Outside ``torch.distributed``: one rank per device of
      ``make_z_group(devices=devices)`` (every visible GPU by default),
      spawned for this call (one device runs in this process); returns the
      (3, D, H, W) flow as a CPU tensor (and rank 0's diagnostics dict
      with ``diagnostics``).
    - Inside an initialised group (``group`` with ``devices``, else the
      group and device ``distributed.initialize`` made): every rank calls
      it with the same volumes and gets its own slab (3, D/n, H, W) on its
      device; ``process_z_range`` gives its planes.

    ``checkpoint_dir``: the flow is saved per rank at every pyramid-level
    boundary and an interrupted run resumes at the level it reached, each
    rank reading only its own slab. ``timer``: a ``PhaseTimer`` given the
    pyramid build and each level (rank 0's in the spawned form)."""
    import torch.distributed as dist
    if diagnostics and (checkpoint_dir is not None or timer is not None):
        raise ValueError("diagnostics is not supported with "
                         "checkpoint_dir/timer (levels run one by one)")
    if dist.is_available() and dist.is_initialized():
        from tpuflow3d_torch import distributed as tdist
        if group is not None and devices is None:
            raise ValueError("compute_flow_sharded with a group needs the "
                             "devices of its ranks")
        z = tdist.global_z_group() if group is None else None
        ctx = shard_ctx(group if z is None else z.group)
        dev = (z.device if devices is None
               else torch.device(list(devices)[ctx.rank]))
        p = prepare_params(params, ctx.n_shards)
        lo, hi = process_z_range(i0.shape[0], ctx.n_shards, ctx.rank)
        return compute_flow_slab(_slab(i0, lo, hi, dev),
                                 _slab(i1, lo, hi, dev), p, ctx, diagnostics,
                                 checkpoint_dir, timer)
    devs = make_z_group(devices=devices)
    n = len(devs)
    p = prepare_params(params, n)
    if i0.shape != i1.shape or len(i0.shape) != 3:
        raise ValueError(f"expected two equal-shape 3D volumes, got "
                         f"{tuple(i0.shape)} vs {tuple(i1.shape)}")
    if i0.shape[0] % n:
        raise ValueError(f"Z extent {i0.shape[0]} not divisible by {n} "
                         "devices; pad with volume.pad_to_multiple first")
    if n == 1:
        dev = devs[0]
        out = compute_flow_slab(_slab(i0, 0, i0.shape[0], dev),
                                _slab(i1, 0, i1.shape[0], dev), p, HaloCtx(),
                                diagnostics, checkpoint_dir, timer)
        if diagnostics:
            return out[0].cpu(), {k: v.cpu() for k, v in out[1].items()}
        return out.cpu()
    return _spawn(devs, _host(i0), _host(i1), p, diagnostics, checkpoint_dir,
                  timer)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _slab(x, lo: int, hi: int, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x[lo:hi].to(dev).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x[lo:hi]), device=dev)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(devs, i0, i1, p: FlowParams, diagnostics, checkpoint_dir, timer):
    """One process per device, each running ``_rank_main`` on its slab;
    the flow slabs gathered in rank order. A rank that fails, or dies
    without reporting, stops the run: the others are terminated and the
    first error raised."""
    import queue as queue_mod

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    n = len(devs)
    port = free_port()
    results = ctx.Queue()
    procs = []
    for r in range(n):
        lo, hi = process_z_range(i0.shape[0], n, r)
        procs.append(ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n, port, str(devs[r]), i0[lo:hi].copy(),
                  i1[lo:hi].copy(), p, diagnostics, checkpoint_dir,
                  timer is not None, results)))
    for proc in procs:
        proc.start()
    got, error, failed_at = {}, None, None
    try:
        while len(got) < n:
            try:
                r, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, proc in enumerate(procs)
                        if proc.exitcode not in (None, 0) and i not in got]
                if dead and error is None:
                    error = (f"rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode} without a result")
                if error is not None:
                    failed_at = failed_at or time.monotonic()
                    if time.monotonic() - failed_at > _GRACE_S or all(
                            proc.exitcode is not None for proc in procs):
                        break
                continue
            if isinstance(payload, str):
                error = error or f"rank {r} failed:\n{payload}"
                failed_at = failed_at or time.monotonic()
            else:
                got[r] = payload
    finally:
        if error is not None or len(got) < n:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
        for proc in procs:
            proc.join(timeout=30)
    if error is not None or len(got) < n:
        raise RuntimeError(f"sharded run over {n} ranks failed: "
                           f"{error or 'ranks stopped without a result'}")
    flow = torch.from_numpy(np.concatenate([got[r]["flow"] for r in range(n)],
                                           axis=1))
    if timer is not None:
        for name, rec in got[0]["timer"].items():
            timer.times[name] = timer.times.get(name, 0.0) + rec["seconds"]
            timer.counts[name] = timer.counts.get(name, 0) + rec["calls"]
    if diagnostics:
        return flow, {k: torch.from_numpy(v) for k, v in got[0]["diag"].items()}
    return flow


def _rank_main(rank, n, port, device, i0l, i1l, p, diagnostics,
               checkpoint_dir, timed, results) -> None:
    """A spawned rank: join the group, solve its slab, report the flow slab
    (or the traceback) on ``results``."""
    from tpuflow3d_torch import distributed as tdist
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        z = tdist.initialize(f"localhost:{port}", n, rank, device=device)
        ctx = shard_ctx(z.group)
        timer = PhaseTimer() if timed else None
        out = compute_flow_slab(torch.as_tensor(i0l, device=z.device),
                                torch.as_tensor(i1l, device=z.device), p, ctx,
                                diagnostics, checkpoint_dir, timer)
        flow, diag = out if diagnostics else (out, {})
        results.put((rank, {
            "flow": flow.cpu().numpy(),
            "diag": {k: v.cpu().numpy() for k, v in diag.items()},
            "timer": timer.report() if timer is not None else {}}))
    except BaseException:
        # The traceback reaches the caller before this rank leaves without
        # waiting for its peers.
        results.put((rank, traceback.format_exc()))
        results.close()
        results.join_thread()
        sys.stderr.flush()
        os._exit(1)
    tdist.shutdown()

