"""The port's post-processing (``tpuflow3d_torch.postproc``) against the JAX
package's on seeded inputs: derived fields and their files, point sampling
and tracking, the seed-CSV rules (the malformed cases of
tests/test_postproc.py), and the forward-backward consistency map, whose
warp runs on the port's device (the CPU here)."""

import numpy as np
import pytest
import torch

from tpuflow3d import postproc as ref
from tpuflow3d_torch import postproc

torch.set_num_threads(2)


def _flow(shape=(11, 9, 10), scale=1.5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (3, *shape))).astype(np.float32)


@pytest.mark.parametrize("name", ["divergence", "curl", "jacobian_det"])
@pytest.mark.parametrize("chunk_z", [64, 4])
def test_derived_fields_equal_reference(name, chunk_z):
    flow = _flow()
    got = getattr(postproc, name)(flow, chunk_z=chunk_z)
    want = getattr(ref, name)(flow, chunk_z=chunk_z)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_write_derived_byte_identical(tmp_path):
    assert postproc.DERIVED_FIELDS == ref.DERIVED_FIELDS
    flow = _flow(seed=1)
    which = ("divergence", "curl", "jacdet")
    mine = postproc.write_derived(str(tmp_path / "m_"), flow, which)
    theirs = ref.write_derived(str(tmp_path / "r_"), flow, which)
    assert [p.replace("m_", "r_") for p in mine] == theirs
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="unknown derived field"):
        postproc.write_derived(str(tmp_path / "x_"), flow, ("shear",))


def test_sample_and_advance_equal_reference():
    flow = _flow(seed=2).astype(np.float64)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2.0, 12.0, (50, 3))  # some outside: clamped
    np.testing.assert_array_equal(postproc.sample_flow_at(flow, pts),
                                  ref.sample_flow_at(flow, pts))
    np.testing.assert_array_equal(postproc.advance_points(flow, pts),
                                  ref.advance_points(flow, pts))


@pytest.mark.parametrize("bad", ["nan", "pts_shape", "flow_shape", "tiny"])
def test_sample_flow_at_rejects(bad):
    flow = np.zeros((3, 4, 4, 4))
    pts = np.ones((2, 3))
    if bad == "nan":
        pts[1, 0] = np.nan
    elif bad == "pts_shape":
        pts = np.ones((2, 2))
    elif bad == "flow_shape":
        flow = np.zeros((2, 4, 4, 4))
    else:
        flow = np.zeros((3, 1, 4, 4))
    msgs = []
    for mod in (postproc, ref):
        with pytest.raises(ValueError) as err:
            mod.sample_flow_at(flow, pts)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_write_tracks_csv_byte_identical(tmp_path):
    tracks = np.random.default_rng(4).uniform(0, 30, (3, 7, 3))
    postproc.write_tracks_csv(str(tmp_path / "m.csv"), tracks)
    ref.write_tracks_csv(str(tmp_path / "r.csv"), tracks)
    assert (tmp_path / "m.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()


# The seed files of tests/test_postproc.py (and a few more edges): each
# parses to the same points in both packages, or both raise with the same
# message (line number included).
SEED_FILES = {
    "header": "z,y,x\n1.0,2.0,3.0\n\n4.5,5.5,6.5\n",
    "short_row": "z,y,x\n1.0,2.0,3.0\n1,2\n",
    "typo_later_row": "1.0,2.0,3.0\n4.x,5.0,6.0\n",
    "text_header": "z,y,x\n7.0,8.0,9.0\n",
    "comment_header": "# my seed points\n1.0,2.0,3.0\n",
    "space_header": "z y x\n4.0,5.0,6.0\n",
    "short_first_row": "1,2\n4.0,5.0,6.0\n",
    "typod_first_row": "1.0,2.0,3.O\n4.0,5.0,6.0\n",
    "numeric_comment": "# shift 1.5, -1.0, 0.75\n4.0,5.0,6.0\n",
    "number_in_header": "z,y,x,1\n4.0,5.0,6.0\n",
    "empty": "\n\n",
    "header_only": "z,y,x\n",
    "extra_columns": "1,2,3,4\n5,6,7,8\n",
}


@pytest.mark.parametrize("name", sorted(SEED_FILES))
def test_read_seed_csv_matches_reference(tmp_path, name):
    path = tmp_path / f"{name}.csv"
    path.write_text(SEED_FILES[name])
    try:
        want = ref.read_seed_csv(str(path))
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            postproc.read_seed_csv(str(path))
        assert str(err.value) == str(e)
        return
    np.testing.assert_array_equal(postproc.read_seed_csv(str(path)), want)


@pytest.mark.parametrize("interp", ["trilinear", "tricubic"])
@pytest.mark.parametrize("chunk_z", [64, 5])
def test_consistency_error_equals_reference(interp, chunk_z):
    """The streamed map against the reference's (its warp in XLA, the
    port's in plain PyTorch on the CPU): within 1e-5 (float32 warps; the
    measured gap is printed by the assertion on failure)."""
    fwd = _flow((13, 9, 8), scale=1.2, seed=5)
    bwd = -fwd + _flow((13, 9, 8), scale=0.1, seed=6)
    got = postproc.consistency_error(fwd, bwd, interp=interp,
                                     chunk_z=chunk_z, device="cpu")
    want = ref.consistency_error(fwd, bwd, interp=interp, chunk_z=chunk_z)
    assert got.dtype == np.float32 and got.shape == fwd.shape[1:]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_consistency_error_flags_disagreement():
    fwd = np.full((3, 8, 8, 8), 0.5, np.float32)
    err = postproc.consistency_error(fwd, np.zeros_like(fwd), device="cpu")
    np.testing.assert_allclose(err, np.sqrt(3 * 0.25), atol=1e-5)


def test_consistency_error_takes_the_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    fwd = np.zeros((3, 4, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        postproc.consistency_error(fwd, fwd)
