"""The port's multi-process layer (``tpuflow3d_torch.distributed``) and the
command line's ``--sharded`` and ``--distributed`` on the CPU (gloo ranks,
plain versions), against the JAX package where it has the same surface:

- ``load_sharded_volume`` reads each rank's slab alone, on its device;
- ``compute_flow_distributed`` on the raw files equals the sharded solve
  bitwise, and its u/v/w slabs land in the global files;
- a two-rank checkpointed run resumed from its own per-rank slabs equals
  the full run, and sharded checkpoints cross-load both ways: the JAX
  package's ``compute_flow_sharded`` resumes from the port's, the port
  from the JAX package's, each to its own full run within the flows'
  agreement (tests/test_torch_sharding.py);
- a rank killed right after the first level checkpoint (``--distributed``
  processes): the survivor exits non-zero within the bound and does not
  hang, and a relaunch resumes to the uninterrupted flow (JAX
  tests/test_multiprocess.py:158-216);
- ``--distributed --frames``: each pair's slabs bitwise the sharded solve;
- ``--sharded --devices 2 --platform cpu`` against the JAX command line's
  ``--sharded --devices 2`` on the conftest's virtual devices.

One pool of two ranks serves the in-process cases; the command-line
cases start their own processes on free ports."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from tpuflow3d import FlowParams as RP
from tpuflow3d import cli as ref_cli
from tpuflow3d import synthetic as rsyn
from tpuflow3d import volume as rvio
from tpuflow3d.sharding import compute_flow_sharded as ref_sharded
from tpuflow3d.sharding import make_z_mesh
from tpuflow3d_torch import FlowParams
from tpuflow3d_torch import checkpoint as ckpt
from tpuflow3d_torch import cli
from tpuflow3d_torch import volume as vio
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.sharding import free_port

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs >=2 virtual devices")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# The flows of the two packages agree to 3e-5 (tests/test_torch_sharding.py).
CROSS = dict(atol=3e-5, rtol=0.0)
# Seconds the survivor of a killed rank may take to exit.
FAULT_BOUND_S = 120
RP_SMALL = RP(levels=2, warps=1, inner_iterations=1, sweeps=5, alpha=0.05)


@pytest.fixture(scope="module")
def pool():
    p = torch_ranks.RankPool(2)
    yield p
    p.close()


def _pair(shape, seed=11):
    return rsyn.make_pair(shape, rsyn.translation((0.5, 0.0, 0.5)),
                          seed=seed)[:2]


def _write_pair(tmp_path, shape, seed=11):
    i0, i1 = _pair(shape, seed)
    f0, f1 = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    vio.write_raw(f0, i0)
    vio.write_raw(f1, i1)
    return i0, i1, f0, f1


def test_load_sharded_volume(pool, tmp_path):
    vol = np.random.default_rng(0).normal(size=(16, 6, 6)).astype(np.float32)
    path = str(tmp_path / "v.raw")
    vio.write_raw(path, vol)
    got = pool.run(torch_ranks.load_slab, path, vol.shape)
    for r, (slab, dev) in enumerate(got):
        assert dev == "cpu"
        np.testing.assert_array_equal(slab, vol[8 * r:8 * (r + 1)])


def test_distributed_matches_sharded(pool, tmp_path):
    shape = (32, 16, 16)
    i0, i1, f0, f1 = _write_pair(tmp_path, shape, seed=7)
    p = from_reference(RP_SMALL)
    prefix = str(tmp_path / "flow_")
    dist = torch_ranks.gather(pool.run(torch_ranks.distributed_flow, f0, f1,
                                       shape, p, out_prefix=prefix))
    shard = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1, p))
    np.testing.assert_array_equal(dist, shard)
    meta = vio.VolumeMeta(shape, "float32")
    for name, c in (("u", 2), ("v", 1), ("w", 0)):
        np.testing.assert_array_equal(vio.read_raw(prefix + f"{name}.raw",
                                                   meta), dist[c])
    ref = np.asarray(ref_sharded(i0, i1, RP_SMALL, mesh=make_z_mesh(2)))
    np.testing.assert_allclose(dist, ref, **CROSS)


def test_checkpoint_resume_two_ranks(pool, tmp_path):
    """Per-rank slab saves: the level files and the meta of the last
    boundary; the resumed run (each rank reading its slab) equals the
    full one; the files are the reference's."""
    shape = (32, 16, 16)
    i0, i1 = _pair(shape, seed=3)
    p = from_reference(RP(levels=3, warps=2, inner_iterations=1, sweeps=5,
                          alpha=0.05))
    ck = str(tmp_path / "ck")
    full = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1, p,
                                       checkpoint_dir=ck))
    assert sorted(n for n in os.listdir(ck) if n.endswith(".raw")) == \
        ["flow0_L0.raw", "flow1_L0.raw", "flow2_L0.raw"]
    assert ckpt.peek_level_checkpoint(ck) == ((32, 16, 16), 0)
    resumed = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1,
                                          p, checkpoint_dir=ck))
    np.testing.assert_array_equal(resumed, full)
    plain = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1, p))
    np.testing.assert_array_equal(full, plain)


def test_resume_needs_every_rank_to_see_the_checkpoint(pool, tmp_path):
    """Rank 0 finds a checkpoint (a perturbed flow, ready for level 0) that
    rank 1 does not see: the ranks must not enter different levels, so
    both start afresh and give the plain flow; where both see it, both
    resume from it."""
    shape = (32, 16, 16)
    i0, i1 = _pair(shape, seed=3)
    p = from_reference(RP(levels=3, warps=2, inner_iterations=1, sweeps=5,
                          alpha=0.05))
    plain = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1, p))
    ck = str(tmp_path / "ck{rank}")
    seen = np.full((3, *shape), 0.25, np.float32)
    ckpt.save_level_checkpoint(ck.format(rank=0), seen, 0, p)
    fresh = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1, p,
                                        checkpoint_dir=ck))
    np.testing.assert_array_equal(fresh, plain)
    for r in range(2):
        ckpt.save_level_checkpoint(ck.format(rank=r), seen, 0, p)
    resumed = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1,
                                          p, checkpoint_dir=ck))
    assert not np.array_equal(resumed, plain)


def test_initialize_backend_follows_devices():
    """On a host with two GPUs, two processes pinned to cuda:0 take gloo
    (NCCL refuses a shared GPU); left to choose, they take cuda:0 and
    cuda:1 and NCCL; on the CPU, gloo."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    devices = ["cuda:0", None, "cpu"]
    ports = [free_port() for _ in devices]
    procs = [ctx.Process(target=torch_ranks.backend_choice, daemon=True,
                         args=(r, ports, devices, results)) for r in range(2)]
    for proc in procs:
        proc.start()
    got = dict(results.get(timeout=120) for _ in procs)
    for proc in procs:
        proc.join(timeout=30)
    for r in range(2):
        assert got[r] == [("gloo", "cuda:0"), ("nccl", f"cuda:{r}"),
                          ("gloo", "cpu")], got[r]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_checkpoints_cross_load(pool, tmp_path, writer):
    """A sharded checkpoint written by one package (ready for level 0) is
    resumed by the other's sharded run, which then solves only level 0
    from the writer's flow: it must land on the resumer's own full run."""
    shape = (32, 16, 16)
    i0, i1 = _pair(shape, seed=5)
    rp = RP(levels=3, warps=2, inner_iterations=1, sweeps=5, alpha=0.05)
    p = from_reference(rp)
    mesh = make_z_mesh(2)
    ck = str(tmp_path / "ck")
    if writer == "port":
        pool.run(torch_ranks.sharded_flow, i0, i1, p, checkpoint_dir=ck)
        assert ckpt.peek_level_checkpoint(ck)[1] == 0
        got = np.asarray(ref_sharded(i0, i1, rp, mesh=mesh,
                                     checkpoint_dir=ck))
        want = np.asarray(ref_sharded(i0, i1, rp, mesh=mesh))
    else:
        np.asarray(ref_sharded(i0, i1, rp, mesh=mesh, checkpoint_dir=ck))
        assert ckpt.peek_level_checkpoint(ck)[1] == 0
        got = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1,
                                          p, checkpoint_dir=ck))
        want = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1,
                                           p))
    np.testing.assert_allclose(got, want, **CROSS)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


# Rank 1 of the fault run: a thread ends the process (exit 17) the moment
# the first level checkpoint appears, mid-solve; then the command line.
_DIE_AT_FIRST_CHECKPOINT = """
import os, sys, threading, time
from tpuflow3d_torch import checkpoint, cli
ck = sys.argv[sys.argv.index("--checkpoint-dir") + 1]
def watch():
    while checkpoint.peek_level_checkpoint(ck) is None:
        time.sleep(0.02)
    os._exit(17)
threading.Thread(target=watch, daemon=True).start()
sys.exit(cli.main(sys.argv[1:]))
"""


def _distributed_cli(f0, f1, out, ck, die=False):
    port = free_port()
    procs = []
    for r in range(2):
        head = ([sys.executable, "-c", _DIE_AT_FIRST_CHECKPOINT]
                if die and r == 1 else
                [sys.executable, "-m", "tpuflow3d_torch.cli"])
        argv = head + [
            "--distributed", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(r),
            "--frame0", f0, "--frame1", f1, "--out", out,
            "--checkpoint-dir", ck, "--platform", "cpu", "--levels", "3",
            "--warps", "1", "--inner-iterations", "1", "--sweeps", "40",
            "--alpha", "0.05"]
        procs.append(subprocess.Popen(argv, env=_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    return procs


def test_killed_rank_detected_and_resumed(pool, tmp_path):
    shape = (24, 16, 16)
    i0, i1, f0, f1 = _write_pair(tmp_path, shape)
    out, ck = str(tmp_path / "mp_"), str(tmp_path / "ck")
    procs = _distributed_cli(f0, f1, out, ck, die=True)
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=FAULT_BOUND_S)[0].decode())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert procs[1].returncode == 17, outs[1]
    # Detection: the survivor failed within the bound (not a hang, not a
    # success).
    assert procs[0].returncode not in (0, None), outs[0]
    assert ckpt.peek_level_checkpoint(ck) is not None

    procs = _distributed_cli(f0, f1, out, ck)
    for proc in procs:
        text = proc.communicate(timeout=300)[0].decode()
        assert proc.returncode == 0, text
    meta = vio.VolumeMeta(shape, "float32")
    want = torch_ranks.gather(pool.run(torch_ranks.sharded_flow, i0, i1,
                                       FlowParams(levels=3, warps=1,
                                                  inner_iterations=1,
                                                  sweeps=40, alpha=0.05)))
    for name, c in (("u", 2), ("v", 1), ("w", 0)):
        np.testing.assert_array_equal(vio.read_raw(f"{out}{name}.raw", meta),
                                      want[c])


def test_cli_distributed_sequence(pool, tmp_path):
    """--frames over two --distributed processes: 3 frames, 2 flows, each
    pair's u/v/w slabs bitwise the sharded solve of that pair."""
    shape = (16, 12, 12)
    a, b, _ = rsyn.make_pair(shape, rsyn.translation((0.5, 0.0, 0.5)),
                             seed=11)
    c = rsyn.make_pair(shape, rsyn.translation((1.0, 0.0, 1.0)), seed=11)[1]
    paths = []
    for name, arr in (("t0", a), ("t1", b), ("t2", c)):
        paths.append(str(tmp_path / f"{name}.raw"))
        vio.write_raw(paths[-1], arr)
    out = str(tmp_path / "seq_")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpuflow3d_torch.cli", "--distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r), "--frames", *paths, "--out", out,
         "--platform", "cpu", "--levels", "2", "--warps", "1",
         "--inner-iterations", "1", "--sweeps", "5", "--alpha", "0.05"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    for proc in procs:
        text = proc.communicate(timeout=300)[0].decode()
        assert proc.returncode == 0, text
    p = FlowParams(levels=2, warps=1, inner_iterations=1, sweeps=5,
                   alpha=0.05)
    meta = vio.VolumeMeta(shape, "float32")
    frames = (a, b, c)
    for t in range(2):
        want = torch_ranks.gather(pool.run(torch_ranks.sharded_flow,
                                           frames[t], frames[t + 1], p))
        for name, comp in (("u", 2), ("v", 1), ("w", 0)):
            np.testing.assert_array_equal(
                vio.read_raw(f"{out}{t:04d}_{name}.raw", meta), want[comp])


def test_cli_sharded_matches_jax_cli(tmp_path, monkeypatch):
    shape = (32, 16, 16)
    i0, i1, f0, f1 = _write_pair(tmp_path, shape, seed=7)
    args = ["--frame0", f0, "--frame1", f1, "--sharded", "--devices", "2",
            "--levels", "2", "--warps", "2", "--inner-iterations", "1",
            "--sweeps", "8", "--alpha", "0.05", "--platform", "cpu"]
    monkeypatch.chdir(tmp_path)
    assert ref_cli.main([*args, "--out", "ref_"]) == 0
    assert cli.main([*args, "--out", "port_"]) == 0
    meta = vio.VolumeMeta(shape, "float32")
    for name in ("u", "v", "w", "magnitude"):
        np.testing.assert_allclose(vio.read_raw(f"port_{name}.raw", meta),
                                   rvio.read_raw(f"ref_{name}.raw", meta),
                                   **CROSS)


def test_cli_devices_past_the_gpus_exit_2(tmp_path, monkeypatch, capsys):
    """--devices 3 on a machine with one GPU exits 2 before any work: the
    command line does not share a card unasked."""
    _, _, f0, f1 = _write_pair(tmp_path, (8, 8, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = str(tmp_path / "o_")
    assert cli.main(["--frame0", f0, "--frame1", f1, "--sharded",
                     "--devices", "3", "--out", out]) == 2
    assert "--devices 3: 1 GPUs visible" in capsys.readouterr().err
    assert not [n for n in os.listdir(tmp_path) if n.startswith("o_")]
