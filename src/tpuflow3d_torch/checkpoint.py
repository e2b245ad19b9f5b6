"""Per-level checkpoint and resume.

Port of ``tpuflow3d.checkpoint`` for one device. The only live state of a
coarse-to-fine run at a pyramid-level boundary is the accumulated flow, so
that is what is saved, and a resumed run re-enters the level loop there.

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

import numpy as np
import torch

from tpuflow3d_torch.params import FlowParams
from tpuflow3d_torch.volume import VolumeMeta, read_raw_slab, write_raw_slab


def _meta_path(path: str) -> str:
    return os.path.join(path, "checkpoint.json")


def _flow_path(path: str, c: int, level: int) -> str:
    return os.path.join(path, f"flow{c}_L{level}.raw")


def _sync_processes() -> None:
    """Barrier so that every process's slab writes land before the meta.
    A no-op: the port runs one process until its multi-process layer
    (``distributed.py``, ROADMAP queue 1, item 13) exists."""


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
                          params: FlowParams) -> None:
    """Save the flow (3, D, H, W), a numpy array or a tensor on any device,
    at a level boundary: ``level`` is the level it is ready to solve."""
    os.makedirs(path, exist_ok=True)
    if isinstance(flow, torch.Tensor):
        flow = flow.detach().cpu().numpy()
    flow = np.asarray(flow)
    _, d, h, w = flow.shape
    comp_meta = VolumeMeta((d, h, w), "float32")
    for c in range(3):
        write_raw_slab(_flow_path(path, c, level), comp_meta, 0, flow[c])
    _sync_processes()
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


def resume_state(path: str, shapes):
    """(flow ndarray, level) of the checkpoint in ``path`` when it belongs
    to this pyramid (``shapes``, fine to coarse: its level exists and its
    shape is that level's), else None: a run re-enters the level loop
    there, or starts afresh."""
    state = load_level_checkpoint(path)
    if state is None:
        return None
    flow, level = state
    if 0 <= level < len(shapes) and flow.shape[1:] == tuple(shapes[level]):
        return flow, level
    return None
