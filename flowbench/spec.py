"""What a cell is made of, found by name: ``BENCHMARK.json``'s workload,
its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the limits its check holds it to
(``limits/<workload>.json``) and its per-layer metrics
(``metrics/<name>.py``). Adding any of them takes a new file and a
``BENCHMARK.json`` entry, never an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = _json(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        self.chips = self.workload["chips"]
        self.config = _json(HERE / "configs" / f"{self.workload['config']}.json")
        self.traffic = _json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.mode = self.traffic["mode"]
        edge = self.config["edge"][self.mode]
        self.shape = (edge, edge, edge)
        self.params = solver_params(self.config, self.traffic, self.shape)
        self.end_to_end = _metrics_for(bench["end_to_end"], name)
        self.per_layer = _metrics_for(bench["per_layer"], name)

    @property
    def voxels(self) -> int:
        d, h, w = self.shape
        return d * h * w

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``, or, for a
        quantity split by the end-to-end metric it moves
        (``<quantity>.<part>``), of ``metrics/<quantity>.py``."""
        path = HERE / "metrics" / f"{metric}.py"
        if not path.exists():
            path = HERE / "metrics" / f"{base(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            f"flowbench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def base(metric: str) -> str:
    """The quantity a metric's name measures: the part before its first
    dot (``voxels_per_s.stream`` is ``voxels_per_s`` in streamed cells)."""
    return metric.split(".", 1)[0]


def _metrics_for(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def solver_params(config: dict, traffic: dict, shape) -> dict:
    """The solver settings a cell runs (``FlowParams``' fields): the
    configuration's ``params``, ``levels`` so that the coarsest level has
    ``coarsest_planes`` planes, and, streamed, the traffic's
    ``default_flow_clamp`` where the configuration sets no clamp (the
    streamed margins need a bound)."""
    p = dict(config["params"])
    p["levels"] = 1 + int(round(math.log2(shape[0]
                                          / config["coarsest_planes"])))
    if traffic["mode"] == "stream" and p.get("flow_clamp", 0.0) <= 0.0:
        p["flow_clamp"] = traffic["default_flow_clamp"]
    return p
