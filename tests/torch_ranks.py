"""A pool of ``torch.distributed`` ranks for the port's sharded tests.

``RankPool(n, device)`` spawns n processes once (gloo on localhost, a free
port), each joined through ``tpuflow3d_torch.distributed.initialize``
with sub-groups of its first k ranks for every k < n, and runs the cases
a test sends it: ``pool.run(fn, *args, ranks=k)`` calls the module-level
function ``fn`` of this file on ranks 0..k-1 (SPMD, with ``group`` and
``device`` given) and returns their results in rank order. A module's
tests share one pool, so the spawn is paid once.

The cases import the port only (no JAX in the ranks).
"""

from __future__ import annotations

import os
import queue
import sys
import traceback

import numpy as np

_CASE_TIMEOUT_S = 600.0


class RankPool:
    def __init__(self, n: int, device: str = "cpu", threads: int = 1):
        import torch.multiprocessing as mp

        from tpuflow3d_torch.sharding import free_port
        ctx = mp.get_context("spawn")
        self.n = n
        self._results = ctx.Queue()
        self._cmds = [ctx.Queue() for _ in range(n)]
        port = free_port()
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, n, port, device, threads,
                                         self._cmds[r], self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, ranks: int | None = None, **kwargs) -> list:
        """fn(*args, group=, device=, **kwargs) on ranks 0..ranks-1 (all by
        default); their results in rank order. Raises with a rank's
        traceback if one failed."""
        k = self.n if ranks is None else ranks
        for q in self._cmds:
            q.put((fn.__name__, args, kwargs, k))
        out, errors = {}, []
        for _ in range(self.n):
            try:
                r, ok, payload = self._results.get(timeout=_CASE_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"{fn.__name__}: the ranks gave no "
                                     f"result in {_CASE_TIMEOUT_S} s")
            if not ok:
                errors.append(f"rank {r}:\n{payload}")
            elif r < k:
                out[r] = payload
        if errors:
            raise AssertionError(f"{fn.__name__} failed:\n" + "\n".join(errors))
        return [out[r] for r in range(k)]

    def close(self) -> None:
        for q in self._cmds:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


def _worker(rank, n, port, device, threads, cmds, results) -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    from tpuflow3d_torch import distributed as tdist
    z = tdist.initialize(f"127.0.0.1:{port}", n, rank, device=device)
    groups = {n: z.group}
    for k in range(2, n):
        groups[k] = dist.new_group(list(range(k)))
    this = sys.modules[__name__]
    while True:
        cmd = cmds.get()
        if cmd is None:
            break
        name, args, kwargs, k = cmd
        try:
            res = (getattr(this, name)(*args, group=groups[k],
                                       device=z.device, **kwargs)
                   if rank < k else None)
            results.put((rank, True, res))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    tdist.shutdown()


def backend_choice(rank, ports, devices, results) -> None:
    """Rank ``rank`` of a two-process job on a host made to report two
    GPUs (``torch.cuda`` patched; ``new_group`` records the backend it is
    asked for): joins once for each entry of ``devices`` through
    ``distributed.initialize(..., device=entry)`` and puts (rank, [(the
    backend it picked, the device it took), ...]) on ``results``."""
    import torch
    import torch.distributed as dist

    from tpuflow3d_torch import distributed as tdist
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 2
    torch.cuda.set_device = lambda dev: None
    dist.new_group = lambda backend=None, **kw: None
    try:
        out = []
        for port, device in zip(ports, devices):
            z = tdist.initialize(f"127.0.0.1:{port}", 2, rank, device=device)
            out.append((z.backend, str(z.device)))
            tdist.shutdown()
        results.put((rank, out))
    except Exception:
        results.put((rank, traceback.format_exc()))


def _ctx(group):
    from tpuflow3d_torch.grid import shard_ctx
    return shard_ctx(group)


def _np(t):
    return t.detach().cpu().numpy()


# ---- cases (run on each rank; args are the global arrays) ----

def zpad_slabs(x, nh, group, device):
    """This rank's slab of x (Z-split) padded through the sharded
    context."""
    import torch

    from tpuflow3d_torch.sharding import process_z_range
    ctx = _ctx(group)
    lo, hi = process_z_range(x.shape[-3], ctx.n_shards, ctx.rank)
    xs = torch.as_tensor(np.ascontiguousarray(x[..., lo:hi, :, :]),
                         device=device)
    return _np(ctx.zpad(xs, nh))


def halo_planes(x, group, device):
    import torch

    from tpuflow3d_torch.sharding import process_z_range
    ctx = _ctx(group)
    lo, hi = process_z_range(x.shape[-3], ctx.n_shards, ctx.rank)
    xs = torch.as_tensor(np.ascontiguousarray(x[..., lo:hi, :, :]),
                         device=device)
    return tuple(_np(t) for t in ctx.z_halo_planes(xs))


def reductions(values, group, device):
    """psum, pmin and pmax of this rank's entry of ``values``."""
    import torch
    ctx = _ctx(group)
    v = torch.tensor(values[ctx.rank], dtype=torch.float32, device=device)
    return tuple(float(f(v)) for f in (ctx.psum, ctx.pmin, ctx.pmax))


def sharded_flow(i0, i1, p, group, device, checkpoint_dir=None,
                 diagnostics=False):
    """This rank's slab of ``compute_flow_sharded`` (SPMD);
    ``checkpoint_dir`` may hold ``{rank}``, each rank's own directory."""
    import torch.distributed as dist

    from tpuflow3d_torch.sharding import compute_flow_sharded
    n = dist.get_world_size(group)
    if checkpoint_dir is not None:
        checkpoint_dir = checkpoint_dir.format(rank=dist.get_rank(group))
    out = compute_flow_sharded(i0, i1, p, devices=[device] * n,
                               checkpoint_dir=checkpoint_dir, group=group,
                               diagnostics=diagnostics)
    if diagnostics:
        return _np(out[0]), {k: _np(v) for k, v in out[1].items()}
    return _np(out)


def distributed_flow(frame0, frame1, shape, p, group, device,
                     out_prefix=None, checkpoint_dir=None):
    """This rank's slab of ``compute_flow_distributed`` on the raw files."""
    import torch.distributed as dist

    from tpuflow3d_torch import distributed as tdist
    from tpuflow3d_torch.volume import VolumeMeta
    z = tdist.ZGroup(group=group, rank=dist.get_rank(group),
                     size=dist.get_world_size(group), device=device,
                     backend="gloo")
    return _np(tdist.compute_flow_distributed(
        frame0, frame1, VolumeMeta(tuple(shape), "float32"), p, z=z,
        out_prefix=out_prefix, checkpoint_dir=checkpoint_dir))


def load_slab(path, shape, group, device):
    import torch.distributed as dist

    from tpuflow3d_torch import distributed as tdist
    from tpuflow3d_torch.volume import VolumeMeta
    z = tdist.ZGroup(group=group, rank=dist.get_rank(group),
                     size=dist.get_world_size(group), device=device,
                     backend="gloo")
    t = tdist.load_sharded_volume(path, VolumeMeta(tuple(shape), "float32"),
                                  z)
    return _np(t), str(t.device)


def gather(slabs) -> np.ndarray:
    """The global (3, D, H, W) flow from the ranks' slabs."""
    return np.concatenate(slabs, axis=-3)


def warp_halo_case(i0, i1, flow, max_disp, interp, emit, group, device):
    """K2/K5 in halo form on this rank's slab against the plain sharded
    warp + derivatives: (bitwise equal, max |diff|, launches by kernel)."""
    import torch

    from tpuflow3d_torch import kernels
    from tpuflow3d_torch.derivatives import derivatives
    from tpuflow3d_torch.kernels.warp_grad import warp_grad
    from tpuflow3d_torch.sharding import process_z_range
    from tpuflow3d_torch.warp import warp_volume
    ctx = _ctx(group)
    lo, hi = process_z_range(i0.shape[0], ctx.n_shards, ctx.rank)

    def cut(a):
        return torch.as_tensor(np.ascontiguousarray(a[..., lo:hi, :, :]),
                               device=device)

    i0s, i1s, fls = cut(i0), cut(i1), cut(flow)
    kernels.reset_launches()
    got = warp_grad(i1s, fls, i0s, ctx, interp=interp, emit_warped=emit,
                    max_disp=max_disp)
    torch.cuda.synchronize(device)
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    i1w = warp_volume(i1s, fls, ctx, max_disp=max_disp, interp=interp)
    ref = (*derivatives(i0s, i1w, ctx), i1w)[:3 if emit else 2]
    same = len(got) == len(ref) and all(torch.equal(a, b)
                                        for a, b in zip(got, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    return same, err, launches
