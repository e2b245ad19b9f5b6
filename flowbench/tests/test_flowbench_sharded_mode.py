"""The sharded mode driven end to end on the CPU, and what the one-card
modes keep.

A temporary checkout (``test_flowbench_harness._copy``) gets a scratch
sharded cell as new files: ladder's params at 32^3 (2 levels), a traffic
with ``"mode": "sharded"`` over 2 gloo ranks, reference ``solve``. Its run
(``run.py --device cpu``) must be correct, count whole rounds, report each
rank's peak, and keep the flow the program computes on one device with the
same prepared settings (``sharding.py``: bitwise); its EPE must be that of
the same solve run in core. A rank that raises ends the run non-zero, with
no result and no rank left behind, and a run killed from outside takes its
ranks with it; a rank whose slab is wrong, a warp that
changes nothing, and halo exchanges left out each make ``correct`` false.
``readings.py`` reads the cell a run a seed, and its control fails.

Beside it: ``spec.solver_params`` and the reference call of the four
cells of ``BENCHMARK.json`` are what they were, and ``slabwise.epe`` and
planes filled apart (``gen.fill_planes``) are ``gen.make_pair``'s, bit for
bit.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_flowbench_harness import KEYS, REPO, _copy

sys.path[:0] = [str(REPO), str(REPO / "src")]

from flowbench import gen, harness, slabwise, spec  # noqa: E402

torch.set_num_threads(2)

EDGE = 32
LIMITS = {"flow_max_gap": 1e-6, "flow_mean_gap": 1e-7}
SEED = 2**31 + 11

# Drives ``harness.main`` in a checkout with a rank fault planted (the
# ranks' target replaced by ``faultplant.rank_main``) and the parent's
# check wrapped so that the kept flows and the pairs are saved.
RUNNER = r'''
import json, sys
root, src, here, fault, saved = sys.argv[1:6]
sys.path[:0] = [root, src, here]
import numpy as np
from flowbench import harness, run, sharded
import faultplant
if fault != "none":
    sharded.rank_main = faultplant.rank_main
check = sharded.check


def saving(cell, pairs, kept, seed, devices):
    np.savez(saved, i0=np.stack([p[0] for p in pairs]),
             i1=np.stack([p[1] for p in pairs]), kept=np.stack(kept))
    return check(cell, pairs, kept, seed, devices)


sharded.check = saving
sys.exit(harness.main(run.parse(sys.argv[6:])))
'''

FAULTPLANT = r'''
import os
import time

import torch

from flowbench import sharded


def rank_main(rank, job, port, memory, out):
    """``sharded.rank_main`` with the fault of FLOWBENCH_FAULT planted in
    the program, and this rank's pid written beside this file."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, f"rank{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    fault = os.environ["FLOWBENCH_FAULT"]
    from tpuflow3d_torch import grid, pipeline, sharding
    if fault == "unchanged":
        pipeline._warp = lambda i0l, i1l, flow, slot, p, ctx: (flow.clone(),)
    elif fault == "exchange":
        grid.HaloCtx._neighbor_planes = lambda self, x, nh: (
            grid._edge_planes(x, nh, "lo"), grid._edge_planes(x, nh, "hi"))
    else:
        solve, calls = sharding.compute_flow_sharded, [0]

        def broken(*a, **k):
            calls[0] += 1
            flow = solve(*a, **k)
            if rank != 1:
                return flow
            if fault == "raise" and calls[0] == 2:
                raise RuntimeError("a planted fault")
            if fault == "hang" and calls[0] == 2:
                time.sleep(3600)
            if fault == "half":
                return torch.zeros_like(flow)
            if fault == "altered":
                flow = flow.clone()
                d, h, w = flow.shape[-3:]
                flow[0, d // 2, h // 2, w // 2] += 1.0
            return flow

        sharding.compute_flow_sharded = broken
    sharded.rank_main(rank, job, port, memory, out)
'''


# A per-layer metric added as a new file: the traced rank's halo exchanges
# over the unprofiled pairs, as the program counts them.
HALO_EXCHANGES = '''
def read(obs):
    if obs is None or not obs.comm.get("exchanges"):
        return None
    return float(obs.comm["exchanges"])
'''


def _configs() -> tuple[dict, dict]:
    """Ladder's configuration at 32^3 (2 levels), sharded and in core, and
    the same with the clamp the sharded mode gives it set in the
    configuration (the in-core twin solves what the ranks solve)."""
    cfg = json.loads((REPO / "flowbench" / "configs" / "ladder.json")
                     .read_text())
    cfg["edge"] = {"sharded": EDGE, "incore": EDGE}
    twin = json.loads(json.dumps(cfg))
    twin["params"]["flow_clamp"] = 4.0
    return cfg, twin


def _traffic(mode: str) -> dict:
    tr = json.loads((REPO / "flowbench" / "traffic" / "incore.json")
                    .read_text())
    tr["profile_pairs"] = 1
    if mode == "sharded":
        tr.update(mode="sharded", default_flow_clamp=4.0)
    return tr


@pytest.fixture(scope="module")
def checkout(tmp_path_factory) -> Path:
    """The harness tests' checkout with the cells ``shard-cell`` (2 ranks)
    and ``shard-twin`` (its in-core twin) added as new files."""
    tmp = tmp_path_factory.mktemp("sharded")
    root = _copy(tmp, "incore")
    fb = root / "flowbench"
    cfg, twin = _configs()
    (fb / "configs" / "shard32.json").write_text(json.dumps(cfg))
    (fb / "configs" / "shard32-twin.json").write_text(json.dumps(twin))
    (fb / "traffic" / "shard-mix.json").write_text(
        json.dumps(_traffic("sharded")))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config, traffic, chips in (
            ("shard-cell", "shard32", "shard-mix", 2),
            ("shard-twin", "shard32-twin", "tiny-mix", 1)):
        (fb / "limits" / f"{name}.json").write_text(json.dumps(LIMITS))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": chips,
                                   "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in ("voxels_per_s", "device_events"):
                m["workloads"].append(name)
    bench["per_layer"].append({
        "name": "halo_exchanges", "unit": "exchanges", "better": "lower",
        "source": "program_counter", "layer": "sharded ranks",
        "moves": "voxels_per_s", "workloads": ["shard-cell"]})
    (fb / "metrics" / "halo_exchanges.py").write_text(HALO_EXCHANGES)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "faultplant.py").write_text(FAULTPLANT)
    return root


def _drive(root: Path, workload: str, fault: str = "none", trace: int = 0,
           seed: int = SEED) -> tuple:
    """(exit code, stdout, stderr, seconds, the saved arrays or None)."""
    saved = root.parent / f"saved-{workload}-{fault}-{trace}.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               FLOWBENCH_FAULT=fault)
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(root), str(REPO / "src"),
         str(root.parent), fault, str(saved), "--workload", workload,
         "--seed", str(seed), "--seconds", "0.1", "--trace", str(trace),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    arrays = dict(np.load(saved)) if saved.exists() else None
    return (proc.returncode, proc.stdout, proc.stderr,
            time.monotonic() - t, arrays)


def _last(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sharded_run(checkout):
    return _drive(checkout, "shard-cell")


def test_sharded_cell_is_correct(sharded_run):
    rc, out, err, _, _ = sharded_run
    assert rc == 0, err
    last = _last(out)
    assert set(last) == KEYS and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0, last["checks"]
    for k, c in last["checks"].items():
        assert c["value"] <= c["limit"] == LIMITS[k]
    # Whole rounds of the 2 distinct pairs.
    assert last["attempted"] >= 2 and last["attempted"] % 2 == 0
    dev = last["device"]
    assert dev["count"] == 2 and len(dev["memory_peak_bytes_by_rank"]) == 2
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_rank"])
    assert set(last["metrics"]) == {"voxels_per_s", "peak_bytes_per_voxel",
                                    "epe", "setup_s"}
    tail = err.strip().splitlines()[-2:]
    assert [t.split()[0] for t in tail] == ["flow_max_gap", "flow_mean_gap"]
    assert "backend gloo" in err


def test_sharded_flow_is_the_one_device_flow(sharded_run):
    from tpuflow3d_torch import FlowParams, compute_flow
    from tpuflow3d_torch.sharding import prepare_params
    saved = sharded_run[4]
    # The pairs are Bench.make_pairs': the traffic's fields in the seed's
    # order, each gen.make_pair's.
    tr = _traffic("sharded")
    order = np.random.default_rng([SEED, 0]).permutation(2)
    for k, j in enumerate(order.tolist()):
        i0, i1 = gen.make_pair((EDGE,) * 3, tr["field_seeds"][j],
                               tr["texture"], tr["deformation"], "cpu")
        assert np.array_equal(saved["i0"][k], i0)
        assert np.array_equal(saved["i1"][k], i1)
    cfg, _ = _configs()
    params = spec.solver_params(cfg, _traffic("sharded"), (EDGE,) * 3, 2)
    assert params["flow_clamp"] == 4.0 and params["z_multiple"] % 2 == 0
    p = FlowParams(**params)
    assert prepare_params(p, 2) == p
    for i0, i1, kept in zip(saved["i0"], saved["i1"], saved["kept"]):
        want = compute_flow(i0, i1, p, device="cpu").numpy()
        assert np.array_equal(kept, want)


def test_sharded_epe_is_the_in_core_epe(checkout, sharded_run):
    rc, out, err, _, _ = _drive(checkout, "shard-twin")
    assert rc == 0, err
    twin = _last(out)
    assert twin["correct"] is True
    assert _last(sharded_run[1])["metrics"]["epe"]["value"] == \
        twin["metrics"]["epe"]["value"]


def test_traced_sharded_run_gives_rank_1s_breakdown(checkout):
    rc, out, err, _, _ = _drive(checkout, "shard-cell", trace=1)
    assert rc == 0, err
    last = _last(out)
    assert set(last) == KEYS | {"breakdown"}
    assert last["correct"] is True
    dev = last["device"]
    assert len(dev["busy_s_by_rank"]) == len(dev["window_s_by_rank"]) == 2
    assert all(s > 0 for s in dev["window_s_by_rank"])
    assert dev["window_s"] == pytest.approx(sum(dev["window_s_by_rank"]) / 2)
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    # Rank 1's trace, with the program's count of its exchanges.
    assert last["metrics"]["halo_exchanges"]["value"] > 0


@pytest.mark.parametrize("control", [False, True])
def test_readings_of_a_sharded_cell(checkout, control):
    """``readings.py`` reads a sharded cell a run a seed: the program reads
    gap 0, its bfloat16 control fails the limits."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(checkout / "flowbench" / "readings.py"),
         "--workload", "shard-cell", "--seeds", "3", "--device", "cpu",
         *(["--control"] if control else [])],
        capture_output=True, text=True, env=env, cwd=checkout, timeout=600)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["seed"] == 3 and line["ranks"] == 2 and line["pairs"] == 2
    assert line["control"] is control
    assert (line["failed"] >= 1) is control
    assert (line["flow_max_gap"] == 0.0) is not control


def _ended(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def test_a_rank_that_raises_ends_the_run(checkout):
    for f in checkout.parent.glob("rank*.pid"):
        f.unlink()
    rc, out, err, seconds, _ = _drive(checkout, "shard-cell", "raise")
    assert rc != 0
    assert not any(line.startswith("{") for line in out.splitlines())
    assert "a planted fault" in err
    assert seconds < 120
    pids = [int(f.read_text()) for f in checkout.parent.glob("rank*.pid")]
    assert len(pids) == 2 and all(_ended(pid) for pid in pids)


def test_a_run_killed_from_outside_leaves_no_rank(checkout):
    """The run's process killed while a rank hangs: no rank outlives it."""
    for f in checkout.parent.glob("rank*.pid"):
        f.unlink()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               FLOWBENCH_FAULT="hang")
    proc = subprocess.Popen(
        [sys.executable, "-c", RUNNER, str(checkout), str(REPO / "src"),
         str(checkout.parent), "hang", str(checkout.parent / "hang.npz"),
         "--workload", "shard-cell", "--seed", "7", "--seconds", "0.1",
         "--trace", "0", "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
        cwd=checkout)
    try:
        deadline = time.monotonic() + 120
        while len(list(checkout.parent.glob("rank*.pid"))) < 2:
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.2)
        time.sleep(5)   # into the window, where rank 1 hangs
        assert proc.poll() is None
    finally:
        proc.kill()
        proc.wait(timeout=30)
    pids = [int(f.read_text()) for f in checkout.parent.glob("rank*.pid")]
    deadline = time.monotonic() + 30
    while not all(_ended(pid) for pid in pids):
        assert time.monotonic() < deadline, pids
        time.sleep(0.2)


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged",
                                   "exchange"])
def test_a_wrong_rank_is_not_correct(checkout, fault):
    rc, out, err, _, _ = _drive(checkout, "shard-cell", fault)
    assert rc == 0, err
    last = _last(out)
    assert last["correct"] is False, last["checks"]
    assert last["failed"] >= 1


def _cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def _solver_params_before(config: dict, traffic: dict, shape) -> dict:
    """``spec.solver_params`` as it was before the sharded mode."""
    p = dict(config["params"])
    p["levels"] = 1 + int(round(math.log2(shape[0]
                                          / config["coarsest_planes"])))
    if traffic["mode"] == "stream" and p.get("flow_clamp", 0.0) <= 0.0:
        p["flow_clamp"] = traffic["default_flow_clamp"]
    return p


@pytest.mark.parametrize("name", ["ladder-512-incore", "accurate-256-incore",
                                  "ladder-256-stream", "gamma-512-incore"])
def test_one_card_cells_keep_their_params_and_reference_call(
        monkeypatch, name):
    assert name in _cells()
    cell = spec.Cell(name)
    assert cell.mode in ("incore", "stream") and cell.chips == 1
    assert cell.params == _solver_params_before(cell.config, cell.traffic,
                                                cell.shape)
    calls = []

    def solve(*a, **k):
        calls.append((a, k))
        return torch.zeros((3, 4, 4, 4))

    monkeypatch.setattr(cell.reference, "solve", solve)
    bench = harness.Bench(cell, torch.device("cpu"))
    pair = (np.ones((4, 4, 4), np.float32), np.ones((4, 4, 4), np.float32))
    kept = [np.zeros((3, 4, 4, 4), np.float32)] * 2
    gaps, failed = bench.check([pair, pair], kept, 5, cell.limits)
    assert failed == 0 and gaps["flow_max_gap"] == 0.0
    (args, kwargs), = calls
    assert kwargs == {} and len(args) == 4
    assert args[2] == cell.reference.Params.from_dict(cell.params)
    assert args[3] == (cell.traffic["chunk_z"] if cell.mode == "stream"
                       else None)


def test_sharded_params_follow_prepare_params():
    from tpuflow3d_torch import FlowParams
    from tpuflow3d_torch.sharding import prepare_params
    cfg = json.loads((REPO / "flowbench" / "configs" / "ladder.json")
                     .read_text())
    tr = _traffic("sharded")
    for chips, zm in ((2, 8), (3, 24), (4, 8), (16, 16)):
        p = spec.solver_params(cfg, tr, (256,) * 3, chips)
        assert p["flow_clamp"] == 4.0 and p["z_multiple"] == zm
        assert prepare_params(FlowParams(**p), chips) == FlowParams(**p)
    # A clamp the configuration sets is kept.
    cfg["params"]["flow_clamp"] = 2.0
    assert spec.solver_params(cfg, tr, (256,) * 3, 4)["flow_clamp"] == 2.0


@pytest.mark.parametrize("slab_planes", [3, None])
def test_slabwise_epe_is_gen_epe(monkeypatch, slab_planes):
    shape = (32, 32, 32)
    tr = _traffic("incore")
    i0, i1 = gen.make_pair(shape, [17, 1], tr["texture"], tr["deformation"],
                           "cpu")
    flow = np.stack([i0 - i1, i1, 0.5 * i0]).astype(np.float32)
    if slab_planes is not None:
        monkeypatch.setattr(gen, "_SLAB_VOXELS", slab_planes * 32 * 32)
    m = tr["epe_mask"]
    for border in (m["border"], 0):
        want = gen.epe(flow, i0, tr["deformation"], m["quantile"], border,
                       "cpu")
        got = slabwise.epe(flow, i0, tr["deformation"], m["quantile"],
                           border, "cpu")
        assert got == want


def test_planes_are_make_pairs(monkeypatch):
    shape = (24, 20, 16)
    tr = _traffic("incore")
    intensity = {"kind": "offset", "std_fraction": 0.25}
    want = gen.make_pair(shape, [5, 0], tr["texture"], tr["deformation"],
                         "cpu", intensity)
    monkeypatch.setattr(gen, "_SLAB_VOXELS", 2 * 20 * 16)
    i0, i1 = np.empty(shape, np.float32), np.empty(shape, np.float32)
    for lo, hi in ((0, 7), (7, 16), (16, 24)):
        gen.fill_planes(i0, i1, [5, 0], tr["texture"], tr["deformation"],
                        lo, hi, "cpu")
    gen.add_intensity(i1, intensity)
    assert i0.tobytes() == want[0].tobytes()
    assert i1.tobytes() == want[1].tobytes()


def test_compare_is_the_whole_volume_gap(monkeypatch):
    monkeypatch.setattr(gen, "_SLAB_VOXELS", 3 * 8 * 8)
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 16, 8, 8)).astype(np.float32)
    b = torch.as_tensor(a + rng.normal(size=a.shape).astype(np.float32))
    worst, mean = slabwise.compare(a, b, "cpu")
    diff = (torch.as_tensor(a).double() - b.double()).abs()
    assert worst == float(diff.max())
    assert mean == pytest.approx(float(diff.mean()), rel=1e-12)
    b[1, 5, 2, 2] = float("nan")
    assert slabwise.compare(a, b, "cpu") == (float("inf"), float("inf"))
