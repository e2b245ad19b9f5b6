"""Per-level checkpoint and resume.

Port of ``tpuflow3d.checkpoint``. The only live state of a coarse-to-fine
run at a pyramid-level boundary is the accumulated flow, so that is what
is saved, and a resumed run re-enters the level loop there.

A Z-sharded run (``sharding.py``) saves per rank: each rank writes only its
own slab into the level's files, a barrier waits for every rank's planes,
and rank 0 writes the meta; a resumed rank reads only its own slab
(``load_level_checkpoint(path, z0, nz)``), so no process holds the global
flow.

Crash safety: flow components go to level-suffixed files
(``flow{c}_L{level}.raw``), so a crash mid-save cannot corrupt the level
saved before, and ``checkpoint.json`` is written last through an atomic
rename: the meta always points at a fully written set of files; stale
levels are pruned after it. A meta whose files are missing or short (a
torn checkpoint) reads as no checkpoint. The files and the meta are the
reference's, so each package resumes from the other's checkpoints.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.volume import VolumeMeta, read_raw_slab, write_raw_slab


def _meta_path(path: str) -> str:
    return os.path.join(path, "checkpoint.json")


def _flow_path(path: str, c: int, level: int) -> str:
    return os.path.join(path, f"flow{c}_L{level}.raw")


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _sync_processes(group=None) -> None:
    """Barrier over ``group`` (the default group when None) so that every
    process's slab writes land before the meta; nothing to wait for
    without an initialised ``torch.distributed``."""
    if _distributed():
        dist.barrier(group=group)


def _write_meta_atomic(path: str, meta: dict) -> None:
    tmp = _meta_path(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _meta_path(path))


def _prune_stale(path: str, level: int) -> None:
    """Drop flow files of other levels (superseded by this checkpoint)."""
    for name in os.listdir(path):
        if name.startswith("flow") and name.endswith(".raw") \
                and f"_L{level}." not in name:
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


def save_level_checkpoint(path: str, flow, level: int,
                          params: FlowParams, z0: int = 0,
                          d_global: int | None = None, group=None) -> None:
    """Save the flow (3, D, H, W), a numpy array or a tensor on any device,
    at a level boundary: ``level`` is the level it is ready to solve. A Z
    shard passes its slab with the global z of its plane 0 and the
    volume's depth, and every rank of ``group`` must call it: each writes
    its slab, then rank 0 the meta once all have written."""
    os.makedirs(path, exist_ok=True)
    if isinstance(flow, torch.Tensor):
        flow = flow.detach().cpu().numpy()
    flow = np.asarray(flow)
    _, d, h, w = flow.shape
    d = d if d_global is None else d_global
    comp_meta = VolumeMeta((d, h, w), "float32")
    for c in range(3):
        write_raw_slab(_flow_path(path, c, level), comp_meta, z0, flow[c])
    _sync_processes(group)
    if not _distributed() or dist.get_rank(group) == 0:
        _write_meta_atomic(path, {"level": level, "shape": [d, h, w],
                                  "params": repr(params)})
        _prune_stale(path, level)


def peek_level_checkpoint(path: str):
    """Returns (shape (D, H, W), level) without reading flow data, or None
    (no meta, or a torn checkpoint)."""
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        meta = json.load(f)
    level = int(meta["level"])
    d, h, w = meta["shape"]
    comp_meta = VolumeMeta((d, h, w), "float32")
    for c in range(3):
        fp = _flow_path(path, c, level)
        if not os.path.exists(fp) or os.path.getsize(fp) != comp_meta.nbytes:
            return None
    return (d, h, w), level


def load_level_checkpoint(path: str, z0: int = 0, nz: int | None = None):
    """Returns (flow ndarray (3, nz, H, W) float32, level) or None. z0 and
    nz select a Z slab (nz None: to the end)."""
    peek = peek_level_checkpoint(path)
    if peek is None:
        return None
    (d, h, w), level = peek
    if nz is None:
        nz = d - z0
    comp_meta = VolumeMeta((d, h, w), "float32")
    comps = [read_raw_slab(_flow_path(path, c, level), comp_meta, z0, nz)
             for c in range(3)]
    return np.stack(comps), level


def resume_state(path: str, shapes, ctx=None, device=None):
    """(flow ndarray, level) of the checkpoint in ``path`` when it belongs
    to this pyramid (``shapes``, fine to coarse, global: its level exists
    and its shape is that level's), else None: a run re-enters the level
    loop there, or starts afresh.

    Under a Z-sharded ``ctx`` (a ``grid.HaloCtx``; every rank calls it)
    the flow is this rank's slab, read alone, and the ranks must agree on
    what they found: each peeks its own view of the directory, and if the
    views differ (a directory that is not shared, a host's files lost) the
    ranks would enter different levels with mismatched exchanges and hang,
    so all start afresh. ``device``: where that agreement's all-gather
    runs (the slabs' device)."""
    state = peek_level_checkpoint(path)
    sharded = ctx is not None and ctx.has_z_neighbors
    if sharded:
        enc = torch.tensor(tuple(state[0]) + (state[1],) if state is not None
                           else (-1, -1, -1, -1), dtype=torch.int64,
                           device=device)
        views = ctx._all_gather(enc)
        if not all(torch.equal(v, views[0]) for v in views):
            print("tpuflow3d_torch: checkpoint visibility/content differs "
                  "across processes; starting fresh on all (resume needs a "
                  "uniformly visible checkpoint directory)", file=sys.stderr)
            return None
    if state is None:
        return None
    (d, h, w), level = state
    if not (0 <= level < len(shapes) and (d, h, w) == tuple(shapes[level])):
        if sharded:
            print(f"tpuflow3d_torch: checkpoint at {path} has shape "
                  f"{(d, h, w)} (level {level}) which does not match this "
                  "run's pyramid; starting fresh", file=sys.stderr)
        return None
    nz = d if ctx is None else d // ctx.n_shards
    flow, _ = load_level_checkpoint(path, 0 if ctx is None else ctx.z0(nz),
                                    nz)
    return flow, level
