"""Structured logging: a JSON-lines logger and a summary of the residual
curves.

Port of ``tpuflow3d.utils.logging`` (numpy only; the port keeps its own
copy so that it runs without JAX). The events and their keys are the
reference's, so one reader serves the logs of both command lines.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import IO, Any

import numpy as np


class JsonlLogger:
    """One JSON object per event, on ``stream`` (stderr by default) and,
    when ``path`` is given, appended to that file."""

    def __init__(self, stream: IO | None = None, path: str | None = None):
        self._stream = stream or sys.stderr
        self._file = open(path, "a") if path else None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event}
        for k, v in fields.items():
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                v = dataclasses.asdict(v)
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            rec[k] = v
        line = json.dumps(rec)
        print(line, file=self._stream, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()


def summarize_residuals(residuals: np.ndarray) -> list[dict]:
    """residuals: (levels, warps, inner*sweeps) from diagnostics. Returns a
    compact per-level summary (first/last residual per warp)."""
    out = []
    for li in range(residuals.shape[0]):
        warps = []
        for wi in range(residuals.shape[1]):
            r = residuals[li, wi]
            nz = r[r > 0]
            if nz.size:
                warps.append({"first": float(nz[0]), "last": float(nz[-1])})
        out.append({"level": li, "warps": warps})
    return out
