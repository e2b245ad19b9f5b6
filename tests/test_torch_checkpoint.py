"""The port's per-level checkpoints (``tpuflow3d_torch.checkpoint``) on one
device: save, peek, slab-local load, a torn checkpoint read as none,
level-suffixed files with stale levels pruned (the one-device parts of
tests/test_checkpoint_sharded.py); the files are the reference's, so a
checkpoint written by either package loads in the other; and resume:
``compute_flow_piecewise`` and ``compute_flow_checkpointed`` resumed from
their own checkpoints equal a full run (atol 1e-6), the port's piecewise
mode resumes from the JAX package's checkpoint to the JAX package's flow,
and a checkpoint of another pyramid is ignored."""

import os

import numpy as np
import pytest
import torch

from tpuflow3d import FlowParams as RP
from tpuflow3d import checkpoint as ref_ckpt
from tpuflow3d import synthetic as rsyn
from tpuflow3d.piecewise import compute_flow_piecewise as ref_piecewise
from tpuflow3d_torch import FlowParams, compute_flow
from tpuflow3d_torch import checkpoint as ckpt
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.params import from_reference
from tpuflow3d_torch.pipeline import compute_flow_checkpointed
from tpuflow3d_torch.piecewise import compute_flow_piecewise

torch.set_num_threads(2)


def _raw_names(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".raw"))


def test_slab_local_load(tmp_path):
    flow = np.random.default_rng(0).normal(size=(3, 16, 8, 8)) \
        .astype(np.float32)
    path = str(tmp_path / "ck")
    ckpt.save_level_checkpoint(path, flow, level=1, params=FlowParams())
    assert ckpt.peek_level_checkpoint(path) == ((16, 8, 8), 1)
    slab, level = ckpt.load_level_checkpoint(path, z0=4, nz=8)
    assert level == 1 and slab.shape == (3, 8, 8, 8)
    np.testing.assert_array_equal(slab, flow[:, 4:12])
    whole, _ = ckpt.load_level_checkpoint(path)
    np.testing.assert_array_equal(whole, flow)


def test_tensor_flow_is_saved(tmp_path):
    flow = torch.randn((3, 4, 5, 6),
                       generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "ck")
    ckpt.save_level_checkpoint(path, flow, level=0, params=FlowParams())
    back, level = ckpt.load_level_checkpoint(path)
    assert level == 0
    np.testing.assert_array_equal(back, flow.numpy())


def test_torn_checkpoint_detected(tmp_path):
    flow = np.random.default_rng(1).normal(size=(3, 8, 8, 8)) \
        .astype(np.float32)
    path = str(tmp_path / "ck")
    assert ckpt.peek_level_checkpoint(path) is None
    ckpt.save_level_checkpoint(path, flow, level=0, params=FlowParams())
    with open(os.path.join(path, "flow1_L0.raw"), "r+b") as f:
        f.truncate(100)
    assert ckpt.peek_level_checkpoint(path) is None
    assert ckpt.load_level_checkpoint(path) is None
    os.remove(os.path.join(path, "flow1_L0.raw"))
    assert ckpt.load_level_checkpoint(path) is None


def test_level_suffixed_files_and_pruning(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "ck")
    f2 = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    ckpt.save_level_checkpoint(path, f2, level=2, params=FlowParams())
    assert _raw_names(path) == [f"flow{c}_L2.raw" for c in range(3)]
    f1 = rng.normal(size=(3, 8, 8, 8)).astype(np.float32)
    ckpt.save_level_checkpoint(path, f1, level=1, params=FlowParams())
    assert _raw_names(path) == [f"flow{c}_L1.raw" for c in range(3)]
    assert "checkpoint.json" in os.listdir(path)
    back, level = ckpt.load_level_checkpoint(path)
    assert level == 1
    np.testing.assert_array_equal(back, f1)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_load(tmp_path, writer):
    """Each package reads the other's checkpoint, slab-local loads too."""
    flow = np.random.default_rng(3).normal(size=(3, 12, 6, 10)) \
        .astype(np.float32)
    path = str(tmp_path / "ck")
    save, load, peek = (
        (ckpt.save_level_checkpoint, ref_ckpt.load_level_checkpoint,
         ref_ckpt.peek_level_checkpoint) if writer == "port" else
        (ref_ckpt.save_level_checkpoint, ckpt.load_level_checkpoint,
         ckpt.peek_level_checkpoint))
    save(path, flow, 2, RP() if writer == "reference" else FlowParams())
    assert tuple(peek(path)[0]) == (12, 6, 10) and peek(path)[1] == 2
    back, level = load(path)
    assert level == 2
    np.testing.assert_array_equal(back, flow)
    slab, _ = load(path, 3, 5)
    np.testing.assert_array_equal(slab, flow[:, 3:8])


def _case():
    i0, i1, _ = syn.make_pair((16, 16, 16), syn.translation((0.7, 0.0, 0.5)),
                              seed=9)
    rp = RP(levels=3, warps=1, inner_iterations=1, sweeps=5, alpha=0.05,
            flow_clamp=4.0, backend="xla")
    return i0, i1, rp


def test_piecewise_resume_matches_full(tmp_path):
    i0, i1, rp = _case()
    p = from_reference(rp)
    ck = str(tmp_path / "ck")
    full = compute_flow_piecewise(i0, i1, p, chunk_z=8, checkpoint_dir=ck,
                                  device="cpu")
    # The saved state is "ready to solve level 0".
    assert _raw_names(ck) == [f"flow{c}_L0.raw" for c in range(3)]
    resumed = compute_flow_piecewise(i0, i1, p, chunk_z=8,
                                     checkpoint_dir=ck, device="cpu")
    np.testing.assert_allclose(resumed, full, atol=1e-6)
    plain = compute_flow_piecewise(i0, i1, p, chunk_z=8, device="cpu")
    np.testing.assert_array_equal(full, plain)


def test_piecewise_resumes_from_the_reference_checkpoint(tmp_path):
    """The port's piecewise mode resumes from the JAX package's level
    checkpoint and ends within the piecewise tolerance (5e-6,
    tests/test_torch_piecewise.py) of the JAX package's flow."""
    i0, i1, rp = _case()
    ck = str(tmp_path / "ck")
    ri0, ri1, _ = rsyn.make_pair((16, 16, 16),
                                 rsyn.translation((0.7, 0.0, 0.5)), seed=9)
    want = ref_piecewise(ri0, ri1, rp, chunk_z=8, checkpoint_dir=ck)
    got = compute_flow_piecewise(i0, i1, from_reference(rp), chunk_z=8,
                                 checkpoint_dir=ck, device="cpu")
    np.testing.assert_allclose(got, want, atol=5e-6)


def test_checkpointed_resume_matches_full(tmp_path):
    i0, i1, rp = _case()
    p = from_reference(rp)
    ck = str(tmp_path / "ck")
    full = compute_flow_checkpointed(i0, i1, p, checkpoint_dir=ck,
                                     device="cpu")
    assert _raw_names(ck) == [f"flow{c}_L0.raw" for c in range(3)]
    resumed = compute_flow_checkpointed(i0, i1, p, checkpoint_dir=ck,
                                        device="cpu")
    np.testing.assert_allclose(resumed.numpy(), full.numpy(), atol=1e-6)
    # Level by level, it is compute_flow.
    np.testing.assert_array_equal(
        full.numpy(), compute_flow(i0, i1, p, device="cpu").numpy())


def test_checkpointed_timer_and_no_directory():
    from tpuflow3d_torch.utils.profiling import PhaseTimer

    i0, i1, rp = _case()
    p = from_reference(rp)
    timer = PhaseTimer()
    flow = compute_flow_checkpointed(i0, i1, p, timer=timer, device="cpu")
    assert flow.shape == (3, 16, 16, 16)
    report = timer.report()
    assert "pyramids" in report and sum(
        k.startswith("level") for k in report) == len(
            p.level_shapes((16, 16, 16)))


def test_other_pyramid_starts_fresh(tmp_path):
    """A checkpoint whose shape is not this pyramid's level is ignored."""
    i0, i1, rp = _case()
    p = from_reference(rp)
    ck = str(tmp_path / "ck")
    ckpt.save_level_checkpoint(ck, np.full((3, 5, 5, 5), 9.0, np.float32),
                               level=0, params=p)
    a = compute_flow_piecewise(i0, i1, p, chunk_z=8, checkpoint_dir=ck,
                               device="cpu")
    ckpt.save_level_checkpoint(ck, np.full((3, 5, 5, 5), 9.0, np.float32),
                               level=0, params=p)
    b = compute_flow_checkpointed(i0, i1, p, checkpoint_dir=ck,
                                  device="cpu")
    np.testing.assert_array_equal(
        a, compute_flow_piecewise(i0, i1, p, chunk_z=8, device="cpu"))
    np.testing.assert_array_equal(
        b.numpy(), compute_flow(i0, i1, p, device="cpu").numpy())
