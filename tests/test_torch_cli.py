"""The port's command line (``python -m tpuflow3d_torch.cli``, run here with
``--platform cpu``) against the JAX package's (``tpuflow3d.cli``, pinned to
the CPU by conftest) on the same raw files.

Tolerances: u/v/w/magnitude within atol 2e-4 (the sharded-vs-unsharded
gate of the JAX suite; the port's flow is within ~1.3e-5 of the JAX
package's at 32^3, tests/test_torch_pipeline.py); tracks within 1e-4
voxel; derived fields and the consistency map, which difference the
flows, within 1e-3; warped volumes (one flow file, two warps) within
1e-5; statistics of the inputs within rtol 1e-5 and of the flow within
2e-4. Every run is 24^3 with two pyramid levels."""

import json
import os

import numpy as np
import pytest
import torch

from tpuflow3d import cli as ref_cli
from tpuflow3d import synthetic as ref_syn
from tpuflow3d import volume as ref_vio
from tpuflow3d_torch import cli, postproc, volume as vio, vtkio
from tpuflow3d_torch.params import PRESETS
from tpuflow3d_torch.utils import memory as mem

torch.set_num_threads(2)

SHAPE = (24, 24, 24)
COMMON = ["--levels", "2", "--residuals"]
FLOW_ATOL = 2e-4


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Raw frames (i0, i1 and i0 again, with sidecars) and a seeds CSV."""
    d = tmp_path_factory.mktemp("frames")
    i0, i1, _ = ref_syn.make_pair(SHAPE, ref_syn.translation((0.5, -0.5, 1.0)),
                                  seed=1)
    paths = {}
    for name, arr in (("f0", i0), ("f1", i1), ("f2", i0)):
        paths[name] = str(d / f"{name}.raw")
        ref_vio.write_raw(paths[name], arr)
    rng = np.random.default_rng(2)
    seeds = rng.uniform(4.0, 19.0, (12, 3))
    paths["seeds"] = str(d / "seeds.csv")
    with open(paths["seeds"], "w") as fh:
        fh.write("z,y,x\n")
        for z, y, x in seeds:
            fh.write(f"{z:.4f},{y:.4f},{x:.4f}\n")
    return paths


def run_both(tmp_path, argv, port_extra=(), ref_extra=()):
    """Run both command lines with ``argv`` (``{out}`` and ``{log}`` are
    filled in per side); return {side: (rc, out prefix, events)}."""
    res = {}
    for side, main, extra in (("ref", ref_cli.main, ref_extra),
                              ("port", cli.main,
                               ("--platform", "cpu", *port_extra))):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        out, log = str(d / "o_"), str(d / "log.jsonl")
        args = [a.format(out=out, log=log, dir=str(d)) for a in argv]
        rc = main([*args, "--out", out, "--log-json", log, *extra])
        events = ([json.loads(ln) for ln in open(log)]
                  if os.path.exists(log) else [])
        res[side] = (rc, out, events)
    return res


def flow_files(prefix, names=("u", "v", "w", "magnitude")):
    return {n: ref_vio.read_raw(f"{prefix}{n}.raw") for n in names}


def assert_flows_close(res, atol=FLOW_ATOL, names=("u", "v", "w",
                                                   "magnitude"), t=None):
    pre = "" if t is None else f"{t:04d}_"
    want = flow_files(res["ref"][1] + pre, names)
    got = flow_files(res["port"][1] + pre, names)
    for n in names:
        assert got[n].shape == SHAPE and got[n].dtype == np.float32
        np.testing.assert_allclose(got[n], want[n], atol=atol, rtol=0,
                                   err_msg=n)
    return got


def events_of(res, side, kind):
    return [e for e in res[side][2] if e["event"] == kind]


@pytest.fixture(scope="module")
def pair_run(frames, tmp_path_factory):
    """Default params (two levels) with every output and diagnostic."""
    tmp = tmp_path_factory.mktemp("pair")
    res = run_both(tmp, ["--frame0", frames["f0"], "--frame1", frames["f1"],
                         *COMMON, "--derived", "divergence,curl,jacdet",
                         "--export-vtk", "--stats", "--report-fit"])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    return res


def test_default_pair(pair_run):
    got = assert_flows_close(pair_run)
    # the prescribed translation (x 1.0, y -0.5, z 0.5) is found
    assert abs(np.median(got["u"][6:-6, 6:-6, 6:-6]) - 1.0) < 0.2
    for kind in ("start", "done", "written", "residuals"):
        assert len(events_of(pair_run, "port", kind)) == 1, kind
    start = events_of(pair_run, "port", "start")[0]
    assert set(start) == set(events_of(pair_run, "ref", "start")[0])


def test_residual_summaries(pair_run):
    mine = events_of(pair_run, "port", "residuals")[0]["summary"]
    ref = events_of(pair_run, "ref", "residuals")[0]["summary"]
    assert len(mine) == len(ref) == 2
    for lm, lr in zip(mine, ref):
        assert len(lm["warps"]) == len(lr["warps"])
        for wm, wr in zip(lm["warps"], lr["warps"]):
            np.testing.assert_allclose([wm["first"], wm["last"]],
                                       [wr["first"], wr["last"]], rtol=1e-2)


def test_derived_and_vtk(pair_run):
    names = ("divergence", "curl_u", "curl_v", "curl_w", "jacdet")
    assert_flows_close(pair_run, atol=1e-3, names=names)
    for side in ("ref", "port"):
        ev = events_of(pair_run, side, "derived_written")[0]
        assert ev["fields"] == ["divergence", "curl", "jacdet"]
        ev = events_of(pair_run, side, "vtk_written")[0]
        assert [os.path.basename(f) for f in ev["files"]] == [
            "o_flow.vtk", "o_magnitude.vtk"]
    for name in ("flow", "magnitude"):
        got, kind = vtkio.read_vtk(f"{pair_run['port'][1]}{name}.vtk")
        want, kind_r = vtkio.read_vtk(f"{pair_run['ref'][1]}{name}.vtk")
        assert kind == kind_r
        np.testing.assert_allclose(got, want, atol=FLOW_ATOL, rtol=0)
    # the VTK flow is the raw flow
    flow, _ = vtkio.read_vtk(f"{pair_run['port'][1]}flow.vtk")
    raws = flow_files(pair_run["port"][1], ("u", "v", "w"))
    np.testing.assert_array_equal(flow, np.stack([raws["w"], raws["v"],
                                                  raws["u"]]))


def test_stats_and_fit(pair_run):
    stats = {side: {e["volume"]: e for e in events_of(pair_run, side,
                                                      "statistics")}
             for side in ("ref", "port")}
    assert set(stats["port"]) == {"frame0", "frame1", "flow_magnitude"}
    assert set(stats["port"]) == set(stats["ref"])
    for vol, e in stats["port"].items():
        for key in ("min", "max", "mean", "l2"):
            want = stats["ref"][vol][key]
            if vol == "flow_magnitude":
                tol = dict(atol=FLOW_ATOL * (np.sqrt(np.prod(SHAPE))
                                             if key == "l2" else 1), rtol=0)
            else:
                tol = dict(rtol=1e-5, atol=0)
            np.testing.assert_allclose(e[key], want, **tol,
                                       err_msg=f"{vol} {key}")
    fit = {side: events_of(pair_run, side, "fit")[0]
           for side in ("ref", "port")}
    for key in ("mean_residual", "max_residual", "mean_abs_diff_unwarped"):
        np.testing.assert_allclose(fit["port"][key], fit["ref"][key],
                                   atol=1e-4, rtol=0, err_msg=key)


def test_accurate_preset(frames, tmp_path):
    res = run_both(tmp_path, ["--frame0", frames["f0"], "--frame1",
                              frames["f1"], "--preset", "accurate",
                              "--levels", "2"])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    assert_flows_close(res)


@pytest.fixture(scope="module")
def piecewise_run(frames, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("piecewise")
    res = run_both(tmp, ["--frame0", frames["f0"], "--frame1", frames["f1"],
                         "--levels", "2", "--piecewise", "--chunk-z", "8",
                         "--report-fit", "--stats"])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    return res


def test_piecewise(piecewise_run):
    assert_flows_close(piecewise_run)
    # streamed diagnostics: the fit and the host statistics
    for kind in ("fit", "statistics"):
        assert events_of(piecewise_run, "port", kind)
    kinds = [e["event"] for e in piecewise_run["port"][2]]
    assert kinds.index("written") < kinds.index("fit")


def test_auto_mode_selects_piecewise(frames, tmp_path, monkeypatch,
                                     piecewise_run):
    """A budget below both packages' in-core models: both choose the
    out-of-core path (the JAX package would first try its 8 virtual CPU
    devices, which the budget is also below), and the flows are those of
    the explicit --piecewise runs."""
    monkeypatch.setenv("TPUFLOW_DEVICE_BYTES", "1000")
    res = run_both(tmp_path, ["--frame0", frames["f0"], "--frame1",
                              frames["f1"], "--levels", "2", "--chunk-z",
                              "8"])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    for side in ("ref", "port"):
        ev = events_of(res, side, "auto_mode")
        assert len(ev) == 1 and ev[0]["selected"] == "piecewise"
        assert set(ev[0]) == {"ts", "event", "selected", "need_bytes",
                              "device_budget_bytes", "devices"}
    assert_flows_close(res)
    for n, arr in flow_files(res["port"][1]).items():
        np.testing.assert_array_equal(
            arr, flow_files(piecewise_run["port"][1])[n])


def test_auto_mode_selects_sharded_over_several_gpus(monkeypatch):
    """With several GPUs and a budget below the in-core model but above a
    rank's (memory.sharded_peak_bytes), the path is sharded over all of
    them; with one GPU, or a budget below a rank's model, piecewise."""
    shape = (256, 256, 256)
    p = PRESETS["ladder256"]
    need = mem.incore_peak_bytes(shape, p)
    rank = mem.sharded_peak_bytes(shape, p, 2)
    assert rank < need
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    dev = torch.device("cuda")

    class Log:
        def __init__(self):
            self.events = []

        def log(self, event, **kw):
            self.events.append({"event": event, **kw})

    for budget, gpus, want in ((rank, 2, "sharded"), (rank - 1, 2,
                                                      "piecewise"),
                               (rank, 1, "piecewise"), (need, 2, None)):
        monkeypatch.setenv("TPUFLOW_DEVICE_BYTES", str(budget))
        monkeypatch.setattr(torch.cuda, "device_count", lambda g=gpus: g)
        args = cli.build_parser().parse_args(["--frame0", "a", "--frame1",
                                              "b"])
        log = Log()
        cli._auto_mode(args, shape, p, log, dev)
        got = [e["selected"] for e in log.events if e["event"] == "auto_mode"]
        assert got == ([want] if want else []), (budget, gpus)
        assert args.sharded == (want == "sharded")
        assert args.piecewise == (want == "piecewise")


def test_auto_chunk_is_pick_chunk_z(frames, tmp_path, monkeypatch):
    """--piecewise without --chunk-z takes memory.pick_chunk_z's chunk for
    the budget, logs it, and gives the flow of that chunk given
    explicitly."""
    p = PRESETS["ladder256"].replace(levels=2, warps=1, sweeps=5)
    flags = ["--preset", "ladder256", "--levels", "2", "--warps", "1",
             "--sweeps", "5", "--platform", "cpu"]
    budget = mem.streamed_peak_bytes(SHAPE, p, 12)
    monkeypatch.setenv("TPUFLOW_DEVICE_BYTES", str(budget))
    chunk = mem.pick_chunk_z(SHAPE, p, budget)
    assert 8 <= chunk < SHAPE[0]
    outs = {}
    for label, extra in (("auto", []), ("given", ["--chunk-z", str(chunk)])):
        out, log = str(tmp_path / f"{label}_"), str(tmp_path / f"{label}.j")
        assert cli.main(["--frame0", frames["f0"], "--frame1", frames["f1"],
                         "--piecewise", *flags, *extra, "--out", out,
                         "--log-json", log]) == 0
        outs[label] = (out, [json.loads(ln) for ln in open(log)])
    ev = [e for e in outs["auto"][1] if e["event"] == "auto_chunk"]
    assert ev == [{**ev[0], "chunk_z": chunk, "device_budget_bytes": budget}]
    assert not [e for e in outs["given"][1] if e["event"] == "auto_chunk"]
    for n, arr in flow_files(outs["auto"][0]).items():
        np.testing.assert_array_equal(arr, flow_files(outs["given"][0])[n])


def test_checkpoint_and_resume(frames, tmp_path):
    argv = ["--frame0", frames["f0"], "--frame1", frames["f1"], *COMMON,
            "--checkpoint-dir", "{dir}/ck", "--timings"]
    full = run_both(tmp_path, argv)
    assert full["ref"][0] == 0 and full["port"][0] == 0
    first = assert_flows_close(full)
    saved = {side: sorted(os.listdir(tmp_path / side / "ck"))
             for side in ("ref", "port")}
    assert saved["port"] == saved["ref"]
    assert [f"flow{c}_L0.raw" for c in range(3)] == [
        n for n in saved["port"] if n.endswith(".raw")]
    for side in ("ref", "port"):
        assert events_of(full, side, "timings")
    resumed = run_both(tmp_path, argv)
    assert resumed["ref"][0] == 0 and resumed["port"][0] == 0
    again = assert_flows_close(resumed)
    for n in first:
        np.testing.assert_allclose(again[n], first[n], atol=1e-6, rtol=0)
    # the resumed run solved only the finest level
    phases = events_of(resumed, "port", "timings")[-1]["phases"]
    assert [k for k in phases if k.startswith("level")] == [
        "level0 (24, 24, 24)"]


def test_frames_with_tracks(frames, tmp_path):
    res = run_both(tmp_path, ["--frames", frames["f0"], frames["f1"],
                              frames["f2"], *COMMON, "--track",
                              frames["seeds"]])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    for t in range(2):
        assert_flows_close(res, t=t)
    tracks = {}
    for side in ("ref", "port"):
        path = f"{res[side][1]}tracks.csv"
        tracks[side] = np.loadtxt(path, delimiter=",", skiprows=1)
        assert [e["t"] for e in events_of(res, side, "pair_done")] == [0, 1]
        ev = events_of(res, side, "tracks_written")
        assert ev and ev[0]["points"] == 12 and ev[0]["steps"] == 2
    assert tracks["port"].shape == (3 * 12, 5)
    np.testing.assert_array_equal(tracks["port"][:, :2], tracks["ref"][:, :2])
    np.testing.assert_allclose(tracks["port"][:, 2:], tracks["ref"][:, 2:],
                               atol=1e-4, rtol=0)
    # i0 -> i1 -> i0: the points come back to their seeds
    seeds = postproc.read_seed_csv(frames["seeds"])
    back = tracks["port"][-12:, 2:]
    assert np.abs(back - seeds).max() < 0.1


def test_apply_flow(frames, pair_run, tmp_path):
    res = run_both(tmp_path, ["--apply-flow", pair_run["ref"][1],
                              "--frame1", frames["f1"]])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    got = ref_vio.read_raw(f"{res['port'][1]}warped.raw")
    want = ref_vio.read_raw(f"{res['ref'][1]}warped.raw")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the warp undoes the motion: warped i1 is nearer i0 than i1 is
    i0, i1 = (vio.read_raw(frames[k]) for k in ("f0", "f1"))
    inner = (slice(4, -4),) * 3
    assert (np.abs(got - i0)[inner].mean()
            < 0.5 * np.abs(i1 - i0)[inner].mean())


def test_check_consistency(frames, tmp_path):
    res = run_both(tmp_path, ["--frame0", frames["f0"], "--frame1",
                              frames["f1"], *COMMON, "--check-consistency"])
    assert res["ref"][0] == 0 and res["port"][0] == 0
    assert_flows_close(res)
    got, want = (ref_vio.read_raw(f"{res[s][1]}consistency.raw")
                 for s in ("port", "ref"))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.median(got[4:-4, 4:-4, 4:-4]) < 0.25
    ev = {s: events_of(res, s, "consistency")[0] for s in ("ref", "port")}
    assert set(ev["port"]) == set(ev["ref"])
    np.testing.assert_allclose(ev["port"]["mean"], ev["ref"]["mean"],
                               atol=1e-4)


def test_list_ops(capsys):
    assert ref_cli.main(["--list-ops"]) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(["--list-ops"]) == 0
    out = capsys.readouterr().out

    def catalog(text):
        """(name, halo rule, counterpart in cuda-flow3d) of each op; the
        reference's notes in parentheses after a rule or a counterpart
        speak of its own route (ppermute, a Pallas pass) and are not
        compared."""
        return [(ln[:16].strip(), ln.split("halo:")[1].split("ref:")[0]
                 .split(" (")[0].strip(),
                 ln.split("ref:")[1].split(" (")[0].strip())
                for ln in text.splitlines() if "halo:" in ln]

    assert catalog(out) == catalog(ref_out)
    assert len(catalog(out)) == 10


def _error_of(stderr: str) -> str:
    line = [ln for ln in stderr.splitlines() if ": error: " in ln][-1]
    return line.split(": error: ", 1)[1].replace("tpuflow3d_torch.",
                                                 "tpuflow3d.")


CONFLICTS = {
    "apply_frames": ["--apply-flow", "p_", "--frame1", "b", "--frames", "a",
                     "b"],
    "apply_piecewise": ["--apply-flow", "p_", "--frame1", "b",
                        "--piecewise"],
    "apply_sharded": ["--apply-flow", "p_", "--frame1", "b", "--sharded"],
    "apply_distributed": ["--apply-flow", "p_", "--frame1", "b",
                          "--distributed"],
    "apply_track": ["--apply-flow", "p_", "--frame1", "b", "--track", "s"],
    "apply_derived": ["--apply-flow", "p_", "--frame1", "b", "--derived",
                      "curl"],
    "apply_no_frame1": ["--apply-flow", "p_"],
    "no_frames": [],
    "frame0_only": ["--frame0", "a"],
    "frames_and_frame0": ["--frames", "a", "b", "--frame0", "x"],
    "one_frame": ["--frames", "a"],
    "piecewise_incore": ["--frame0", "a", "--frame1", "b", "--piecewise",
                         "--incore"],
    "piecewise_sharded": ["--frame0", "a", "--frame1", "b", "--piecewise",
                          "--sharded"],
    "sharded_distributed": ["--frame0", "a", "--frame1", "b", "--sharded",
                            "--distributed"],
    "bad_derived": ["--frame0", "a", "--frame1", "b", "--derived",
                    "divergence,shear"],
    "track_no_frames": ["--frame0", "a", "--frame1", "b", "--track", "s"],
    "derived_distributed": ["--frame0", "a", "--frame1", "b", "--derived",
                            "curl", "--distributed"],
    "vtk_distributed": ["--frame0", "a", "--frame1", "b", "--export-vtk",
                        "--distributed"],
    "consistency_frames": ["--frames", "a", "b", "--check-consistency"],
    "consistency_distributed": ["--frame0", "a", "--frame1", "b",
                                "--check-consistency", "--distributed"],
    "missing_file": ["--frame0", "missing.raw", "--frame1", "missing.raw"],
}


@pytest.mark.parametrize("name", sorted(CONFLICTS))
def test_conflicts_exit_2_with_the_reference_message(name, tmp_path,
                                                     monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = CONFLICTS[name]
    assert ref_cli.main(argv) == 2
    want = _error_of(capsys.readouterr().err)
    assert cli.main([*argv, "--platform", "cpu"]) == 2
    assert _error_of(capsys.readouterr().err) == want


# flag -> the arguments with which it cannot run: more ranks than the
# CPU has cores, more GPUs than are visible (one, here), and the
# multi-process addresses given in part.
MULTI_DEVICE_FAULTS = {
    "--sharded": ["--sharded", "--devices", str(len(os.sched_getaffinity(0))
                                                + 1)],
    "--devices": ["--sharded", "--devices", "2"],
    "--distributed": ["--distributed", "--num-processes", "2"],
    "--coordinator": ["--distributed", "--coordinator", "localhost:1234"],
    "--num-processes": ["--distributed", "--num-processes", "2"],
    "--process-id": ["--distributed", "--process-id", "0"],
}


@pytest.mark.parametrize("flag", [["--sharded"], ["--devices", "2"],
                                  ["--distributed"],
                                  ["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"],
                                  ["--process-id", "0"]],
                         ids=lambda f: f[0])
def test_multi_device_flags_exit_2(flag, frames, tmp_path, capsys,
                                   monkeypatch):
    """The Z-sharded and multi-process flags exit 2, naming the flag and
    writing nothing, where they cannot run: --devices past the CPU's cores
    (--platform cpu) or past the GPUs (one visible: a card is not shared
    unasked), and --coordinator, --num-processes and --process-id given in
    part."""
    out = str(tmp_path / "o_")
    argv = ["--frame0", frames["f0"], "--frame1", frames["f1"],
            *MULTI_DEVICE_FAULTS[flag[0]], "--out", out]
    if flag[0] == "--devices":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    else:
        argv += ["--platform", "cpu"]
    assert cli.main(argv) == 2
    err = _error_of(capsys.readouterr().err)
    assert flag[0] in err
    assert os.listdir(tmp_path) == []


def test_no_gpu_without_platform_exits_2(frames, tmp_path, capsys):
    """Without --platform the run takes the GPU; where there is none it
    exits 2 with pipeline.default_device's message and writes nothing (no
    log file, no flow)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the run would take it")
    log = str(tmp_path / "log.jsonl")
    rc = cli.main(["--frame0", frames["f0"], "--frame1", frames["f1"],
                   "--out", str(tmp_path / "o_"), "--log-json", log,
                   "--levels", "2"])
    assert rc == 2
    err = _error_of(capsys.readouterr().err)
    assert "torch.cuda.is_available() is false" in err
    assert 'device="cpu"' in err
    assert os.listdir(tmp_path) == []
    assert cli.main(["--apply-flow", "p_", "--frame1", frames["f1"],
                     "--out", str(tmp_path / "o_")]) == 2
    assert "is_available" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_profile_dir_writes_a_trace(frames, tmp_path):
    """--profile-dir writes torch.profiler's Chrome trace there (the
    reference writes a jax.profiler trace)."""
    prof = tmp_path / "prof"
    assert cli.main(["--frame0", frames["f0"], "--frame1", frames["f1"],
                     "--levels", "2", "--warps", "1", "--sweeps", "2",
                     "--platform", "cpu", "--out", str(tmp_path / "o_"),
                     "--profile-dir", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_time_fn():
    from tpuflow3d_torch.utils.profiling import time_fn

    calls = []
    assert time_fn(lambda x: calls.append(x), 1, warmup=2, iters=3) >= 0.0
    assert calls == [1] * 5
