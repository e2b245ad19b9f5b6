"""The port's host IO against the JAX package's: raw volumes, sidecars and
flow files (``volume.py``), legacy-VTK files (``vtkio.py``) byte for byte,
the JSON-lines logger's events, and the native library
(``utils/native.py``, built with g++ from the port's own
``csrc/flowio.cpp``) against numpy."""

import json

import numpy as np
import pytest
import torch

from tpuflow3d import volume as ref_vio
from tpuflow3d import vtkio as ref_vtk
from tpuflow3d.params import FlowParams as RefParams
from tpuflow3d.utils import logging as ref_logging
from tpuflow3d_torch import FlowParams, volume as vio, vtkio
from tpuflow3d_torch.utils import logging as tlog
from tpuflow3d_torch.utils import native

torch.set_num_threads(2)

DTYPES = ["float32", "uint16", "uint8", "int16"]


def _volume(dtype, shape=(6, 5, 7), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.normal(size=shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True,
                        dtype=dtype)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", DTYPES)
def test_raw_and_sidecar_byte_identical(tmp_path, dtype):
    arr = _volume(dtype)
    mine, ref = str(tmp_path / "mine.raw"), str(tmp_path / "ref.raw")
    vio.write_raw(mine, arr)
    ref_vio.write_raw(ref, arr)
    assert _bytes(mine) == _bytes(ref)
    assert _bytes(mine + ".json") == _bytes(ref + ".json")
    assert vio.read_sidecar(ref) == vio.VolumeMeta(arr.shape, dtype)
    for reader in (vio.read_raw, ref_vio.read_raw):
        back = reader(mine)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(
        vio.read_raw(ref, vio.VolumeMeta(arr.shape, dtype), mmap=True), arr)
    np.testing.assert_array_equal(
        vio.read_raw_slab(ref, vio.VolumeMeta(arr.shape, dtype), 2, 3),
        arr[2:5])


def test_raw_errors_match(tmp_path):
    arr = _volume("float32")
    path = str(tmp_path / "v.raw")
    vio.write_raw(path, arr, sidecar=False)
    for mod in (vio, ref_vio):
        with pytest.raises(ValueError, match="no dims given"):
            mod.read_raw(path)
        with pytest.raises(ValueError, match="expected"):
            mod.read_raw(path, mod.VolumeMeta((6, 5, 8)))
        with pytest.raises(ValueError, match="out of range"):
            mod.read_raw_slab(path, mod.VolumeMeta(arr.shape), 4, 3)


def test_slab_writes_byte_identical(tmp_path):
    """Slabs written out of order into a new file, and over an existing
    one, by both packages give the same bytes; the file is extended, never
    truncated."""
    arr = _volume("float32", (12, 4, 6), seed=1)
    files = {}
    for name, mod in (("mine", vio), ("ref", ref_vio)):
        path = str(tmp_path / f"{name}.raw")
        meta = mod.VolumeMeta(arr.shape)
        mod.write_raw_slab(path, meta, 8, arr[8:])
        mod.write_raw_slab(path, meta, 0, arr[:8])
        mod.write_raw_slab(path, meta, 3, arr[3:5] * 2)
        files[name] = _bytes(path)
    assert files["mine"] == files["ref"]
    back = np.frombuffer(files["mine"], np.float32).reshape(arr.shape)
    np.testing.assert_array_equal(back[3:5], arr[3:5] * 2)
    np.testing.assert_array_equal(back[5:], arr[5:])


@pytest.mark.parametrize("magnitude", [True, False])
def test_write_flow_byte_identical(tmp_path, magnitude):
    assert vio.FLOW_COMPONENT_FILES == ref_vio.FLOW_COMPONENT_FILES
    flow = _volume("float32", (3, 5, 4, 6), seed=2)
    mine, ref = str(tmp_path / "m_"), str(tmp_path / "r_")
    vio.write_flow(mine, flow, magnitude=magnitude)
    ref_vio.write_flow(ref, flow, magnitude=magnitude)
    names = ["u", "v", "w"] + (["magnitude"] if magnitude else [])
    for name in names:
        for ext in (".raw", ".raw.json"):
            assert _bytes(f"{mine}{name}{ext}") == _bytes(f"{ref}{name}{ext}")
    assert not (tmp_path / "m_magnitude.raw").exists() or magnitude


@pytest.mark.parametrize("d,m", [(7, 4), (8, 4), (5, 1), (9, 8)])
def test_pad_to_multiple(d, m):
    vol = _volume("float32", (d, 3, 4))
    np.testing.assert_array_equal(vio.pad_to_multiple(vol, m),
                                  ref_vio.pad_to_multiple(vol, m))


@pytest.mark.parametrize("shape", [(4, 5, 6), (1, 3, 2)])
def test_vtk_byte_identical(tmp_path, shape):
    vol = _volume("float32", shape, seed=3)
    flow = _volume("float32", (3, *shape), seed=4)
    for fn, ref_fn, x, kw in (
            (vtkio.write_vtk_scalar, ref_vtk.write_vtk_scalar, vol,
             {"name": "flow_magnitude"}),
            (vtkio.write_vtk_flow, ref_vtk.write_vtk_flow, flow, {})):
        mine, ref = tmp_path / "mine.vtk", tmp_path / "ref.vtk"
        fn(str(mine), x, **kw)
        ref_fn(str(ref), x, **kw)
        assert mine.read_bytes() == ref.read_bytes()
        for reader in (vtkio.read_vtk, ref_vtk.read_vtk):
            back, kind = reader(str(mine))
            assert kind == ("vector" if x.ndim == 4 else "scalar")
            np.testing.assert_array_equal(back, x)


def test_vtk_rejects_bad_shapes(tmp_path):
    with pytest.raises(ValueError, match="scalar volume"):
        vtkio.write_vtk_scalar(str(tmp_path / "a.vtk"), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="flow must be"):
        vtkio.write_vtk_flow(str(tmp_path / "a.vtk"), np.zeros((2, 2, 2, 2)))


def test_logger_lines_match(tmp_path):
    """The same events give the same JSON lines (the timestamp aside); the
    params record has the reference's keys."""
    rng = np.random.default_rng(5)
    res = rng.uniform(0, 1, (2, 3, 4)).astype(np.float32)
    res[1, 2] = 0.0
    lines = {}
    for name, mod, params in (("mine", tlog, FlowParams()),
                              ("ref", ref_logging, RefParams())):
        path = tmp_path / f"{name}.jsonl"
        log = mod.JsonlLogger(stream=open(tmp_path / f"{name}.err", "w"),
                              path=str(path))
        log.log("start", params=params, frame0="a.raw", frames=None)
        log.log("residuals", summary=mod.summarize_residuals(res))
        log.log("statistics", volume="frame0", arr=np.arange(3.0), min=0.5)
        log.close()
        lines[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert [json.loads(ln) for ln in
                (tmp_path / f"{name}.err").read_text().splitlines()] \
            == lines[name]
    for mine, ref in zip(lines["mine"], lines["ref"], strict=True):
        assert set(mine) == set(ref)
        mine.pop("ts"), ref.pop("ts")
        if mine["event"] == "start":
            assert set(mine.pop("params")) == set(ref.pop("params"))
        assert mine == ref


def test_native_builds_here():
    """With g++ on the path (the CPU test machines have it) the port's
    own copy builds into build/tpuflow3d_torch/, beside the kernels."""
    assert native.available(), native.build_error()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "tpuflow3d_torch"


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16"])
def test_native_to_f32(dtype):
    arr = _volume(dtype, (9, 33, 17), seed=6)
    out = native.to_f32(arr)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, arr.astype(np.float32))
    assert native.to_f32(arr.astype(np.float32)) is None


def test_native_minmax_and_io(tmp_path):
    arr = _volume("float32", (9, 33, 17), seed=7)
    assert native.minmax_f32(arr) == (float(arr.min()), float(arr.max()))
    assert native.minmax_f32(arr.astype(np.float64)) is None
    path = str(tmp_path / "n.raw")
    assert native.write_bytes(path, 4 * 10, arr[0, 0, :5], total_bytes=400)
    raw = np.fromfile(path, np.float32)
    assert raw.size == 100
    np.testing.assert_array_equal(raw[10:15], arr[0, 0, :5])
    assert not raw[:10].any() and not raw[15:].any()
    np.testing.assert_array_equal(
        native.read_bytes(path, 40, 20).view(np.float32), arr[0, 0, :5])
    with pytest.raises(OSError):
        native.read_bytes(path, 400, 4)


def test_volume_routes_agree(tmp_path, monkeypatch):
    """The native and the numpy routes of volume.py give the same arrays
    and files."""
    arr = _volume("float32", (8, 6, 5), seed=8)
    meta = vio.VolumeMeta(arr.shape)
    out = {}
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setattr(native, "read_bytes", lambda *a: None)
            monkeypatch.setattr(native, "write_bytes", lambda *a: False)
        path = str(tmp_path / f"{route}.raw")
        vio.write_raw_slab(path, meta, 4, arr[4:])
        vio.write_raw_slab(path, meta, 0, arr[:4])
        out[route] = (_bytes(path), vio.read_raw(path, meta),
                      vio.read_raw_slab(path, meta, 2, 5))
    assert out["native"][0] == out["numpy"][0]
    for a, b in zip(out["native"][1:], out["numpy"][1:]):
        np.testing.assert_array_equal(a, b)
