"""The harness found by name and driven end to end on the CPU at 16^3.

A temporary copy of ``flowbench/`` gets a configuration, a traffic mix, a
limits file and a per-layer metric of its own, and ``BENCHMARK.json`` a
workload for them; ``run.py --device cpu`` (the flag is for these tests
only) must find and run them with no other edit. The last line must carry
exactly the result's keys, and every name and unit of the real
``BENCHMARK.json`` only the characters a name or a unit may hold.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}

TINY_CONFIG = {
    "source": "a 16^3 copy of the ladder for the harness's tests",
    "params": {"warps": 2, "inner_iterations": 2, "sweeps": 4,
               "solver": "sor", "median": True, "flow_clamp": 0.0},
    "coarsest_planes": 8,
    "edge": {"incore": 16, "stream": 16},
    "reduced": [], "assumed": {}, "why": "tests"}
TINY_METRIC = '''
def read(obs):
    if obs is None or not obs.device:
        return None
    return float(len(obs.device))
'''


def _copy(tmp: Path, traffic: str) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "flowbench", root / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    fb = root / "flowbench"
    (fb / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    tr = json.loads((fb / "traffic" / f"{traffic}.json").read_text())
    tr["profile_pairs"] = 1
    (fb / "traffic" / "tiny-mix.json").write_text(json.dumps(tr))
    # Both modes read 0 against the reference here.
    (fb / "limits" / "tiny-cell.json").write_text(
        json.dumps({"flow_max_gap": 1e-6, "flow_mean_gap": 1e-7}))
    (fb / "metrics" / "device_events.py").write_text(TINY_METRIC)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "voxels_per_s":
            m["workloads"].append("tiny-cell")
    bench["per_layer"].append({
        "name": "device_events", "unit": "events", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "voxels_per_s", "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, *extra: str, seed: int = 2**31 + 7,
             trace: int = 0) -> tuple[int, str, str]:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(root / "flowbench" / "run.py"),
         "--workload", "tiny-cell", "--seed", str(seed), "--seconds", "0.5",
         "--trace", str(trace), "--device", "cpu", *extra],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.mark.parametrize("traffic", ["incore", "stream-c64"])
def test_added_files_are_found_and_run(tmp_path, traffic):
    root = _copy(tmp_path, traffic)
    rc, out, err = run_cell(root)
    assert rc == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == KEYS
    assert list(last)[-1] == "checks"
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] >= 2 and last["failed"] == 0
    assert set(last["metrics"]) == {"voxels_per_s", "peak_bytes_per_voxel",
                                    "epe", "setup_s"}
    # No device memory on the CPU: the peak reads 0 there only.
    assert all(m["value"] > 0 for k, m in last["metrics"].items()
               if k != "peak_bytes_per_voxel")
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # The compared numbers end standard error, each beside its limit.
    tail = err.strip().splitlines()[-2:]
    assert [t.split()[0] for t in tail] == ["flow_max_gap", "flow_mean_gap"]


def test_traced_run_reports_the_added_metric(tmp_path):
    root = _copy(tmp_path, "incore")
    rc, out, err = run_cell(root, trace=1)
    assert rc == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == KEYS | {"breakdown"}
    # On the CPU the profiler sees no device activity: every device reader
    # finds nothing and returns nothing, the added one included.
    assert "device_idle_share" not in last["metrics"]
    assert last["device"]["window_s"] > 0


def test_no_result_without_a_card(tmp_path):
    """Without --device cpu a run needs CUDA; here there is none."""
    root = _copy(tmp_path, "incore")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(root / "flowbench" / "run.py"), "--workload",
         "tiny-cell", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    root = _copy(tmp_path, "incore")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(root / "flowbench" / "run.py"), "--workload",
         "tiny-cell", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")


def test_benchmark_json_names_and_units():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg)
    for w in bench["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (REPO / "flowbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "flowbench" / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    # A cell takes 4 cards only where a sharded traffic needs them; at most
    # a quarter of the cells (rounded down), or one, take them.
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in four:
        tr = json.loads((REPO / "flowbench" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        assert tr["mode"] == "sharded"
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        quantity = m["name"].split(".", 1)[0]
        assert (REPO / "flowbench" / "metrics" / f"{quantity}.py").is_file()
        assert set(m["workloads"]) <= cells
        # Every cell it lists reports the end-to-end metric it moves.
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                                cells))
    for w in cells:
        reported = [m for m in bench["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2 and "setup_s" in {m["name"]
                                                    for m in reported}
        assert any(w in m["workloads"] for m in bench["per_layer"])
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for f in (REPO / "flowbench").rglob("*"):
        if "__pycache__" not in f.parts:
            rel = f.relative_to(REPO).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
