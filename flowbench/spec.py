"""What a cell is made of, found by name: ``BENCHMARK.json``'s workload,
its configuration (``configs/<name>.json``), the plain reference that
configuration names (``reference/<name>.py``, ``"reference"`` in the
configuration's file, ``solve`` where it names none), its traffic mix
(``traffic/<name>.json``), the limits its check holds it to
(``limits/<workload>.json``) and its per-layer metrics
(``metrics/<name>.py``). Adding any of them takes a new file and a
``BENCHMARK.json`` entry, never an edit here.

A reference module gives ``Params.from_dict(settings)``, an object with
``level_shapes(shape)``, and ``solve(i0, i1, p, stream_chunk)``, the
(3, D, H, W) float32 flow of a pair of (D, H, W) tensors on their device
(``stream_chunk`` None in core, else the streamed mode's chunk); it raises
on settings it does not compute. A reference may also take ``devices``
(``solve(i0, i1, p, stream_chunk, devices=...)``): the cards of a sharded
cell, in rank order, for a volume that no one card holds. It then gets the
pair as tensors on the host and returns the flow on the host, computing
where it likes on those cards. The check passes ``devices`` only in a
sharded cell and only to a reference that takes them; every other call is
``solve(i0, i1, p, stream_chunk)`` on the first card.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import math
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


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
        self.name, self.root = name, root
        self.workload = found[0]
        self.chips = self.workload["chips"]
        self.config = _json(HERE / "configs" / f"{self.workload['config']}.json")
        self.reference = reference(self.config.get("reference", "solve"))
        self.traffic = _json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.mode = self.traffic["mode"]
        edge = self.config["edge"][self.mode]
        self.shape = (edge, edge, edge)
        self.params = solver_params(self.config, self.traffic, self.shape,
                                    self.chips)
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
        return _load("flowbench_metric", metric, path).read


def reference(name: str):
    """The module ``reference/<name>.py``: a configuration's plain
    reference. Raises, naming the file, where there is none."""
    if not NAME.fullmatch(name):
        raise ValueError(f"reference name {name!r} is not a name")
    path = HERE / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference {name!r}: {path} is missing")
    return _load("flowbench_reference", name, path)


def _load(prefix: str, name: str, path: Path):
    """The module at ``path``, executed once per process under a name of
    its own (registered before it runs, as a dataclass in it needs)."""
    key = f"{prefix}_{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def base(metric: str) -> str:
    """The quantity a metric's name measures: the part before its first
    dot (``voxels_per_s.stream`` is ``voxels_per_s`` in streamed cells)."""
    return metric.split(".", 1)[0]


def _metrics_for(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def solver_params(config: dict, traffic: dict, shape, chips: int = 1
                  ) -> dict:
    """The solver settings a cell runs (``FlowParams``' fields): the
    configuration's ``params``, ``levels`` so that the coarsest level has
    ``coarsest_planes`` planes, and, streamed or sharded, the traffic's
    ``default_flow_clamp`` where the configuration sets no clamp (the
    streamed margins and the sharded warp's halo need a bound). Sharded,
    also ``z_multiple`` raised to a multiple of the ``chips`` ranks: the
    two rules of the program's ``sharding.prepare_params``, applied here so
    that the reference solves the problem the ranks solve."""
    p = dict(config["params"])
    p["levels"] = 1 + int(round(math.log2(shape[0]
                                          / config["coarsest_planes"])))
    if traffic["mode"] in ("stream", "sharded") and \
            p.get("flow_clamp", 0.0) <= 0.0:
        p["flow_clamp"] = traffic["default_flow_clamp"]
    if traffic["mode"] == "sharded":
        zm = p.get("z_multiple", 1)
        p["z_multiple"] = zm * chips // math.gcd(zm, chips)
    return p


def takes_devices(reference) -> bool:
    """Whether a reference module's ``solve`` takes ``devices``."""
    return "devices" in inspect.signature(reference.solve).parameters
