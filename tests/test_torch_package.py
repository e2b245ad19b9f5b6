"""Package-level properties of tpuflow3d_torch: it imports with JAX
blocked and names neither jax nor tpuflow3d; no fallback from kernels to
plain; unsupported settings raise; the synthetic-data copy is bitwise the
reference's; and the kernel build fails loudly without nvcc."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow3d import synthetic as ref_syn
from tpuflow3d_torch import FlowParams, compute_flow, kernels
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.backend import check_supported

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "tpuflow3d_torch"


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpuflow3d'] = None\n"
        "import tpuflow3d_torch\n"
        "for m in pkgutil.walk_packages(tpuflow3d_torch.__path__, "
        "'tpuflow3d_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not [m for m in sys.modules if m.startswith('jax') and "
        "sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_file_names_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpuflow3d)\b(?!_torch)",
                     re.MULTILINE)
    files = list(PKG.rglob("*.py"))
    assert len(files) >= 14
    assert [f for f in files if pat.search(f.read_text())] == []


def test_kernels_backend_on_cpu_raises():
    vol = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_flow(vol, vol, FlowParams(levels=1, backend="kernels"),
                     device="cpu")


def test_device_argument():
    """Numpy input needs a device; tensor input runs where it lies, and a
    device argument that names another place raises."""
    vol = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="device"):
        compute_flow(vol, vol, FlowParams(levels=1))
    t = torch.from_numpy(vol)
    p = FlowParams(levels=1, warps=1, inner_iterations=1, sweeps=1)
    assert compute_flow(t, t, p, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="device"):
        compute_flow(t, t, p, device="meta")


@pytest.mark.parametrize("kw", [
    dict(solver="multigrid"), dict(interp="tricubic"), dict(gamma=1.0),
    dict(deriv_order=4), dict(terms_dtype="bfloat16"),
    dict(dtype="bfloat16")], ids=lambda kw: "-".join(map(str, kw.values())))
def test_unsupported_settings_raise(kw):
    vol = np.zeros((8, 8, 8), np.float32)
    for backend in ("auto", "plain"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compute_flow(vol, vol, FlowParams(levels=1, backend=backend,
                                              **kw), device="cpu")


def test_packed_layout_runs_plain_on_cpu():
    """The packed layout is a kernel layout: on CPU tensors the plain
    versions serve it; it raises only where kernels would run (CUDA)."""
    check_supported(FlowParams(sweep_layout="packed"), torch.zeros(1))


@pytest.mark.parametrize("texture", ["blobs", "fourier"])
def test_synthetic_copy_is_bitwise(texture):
    shape = (9, 12, 10)
    for fn_name, args in (("translation", ((1.5, -1.0, 0.75),)),
                          ("rotation", ((4, 6, 5), "y", 3.0)),
                          ("sinusoid", (shape, 1.2))):
        a = syn.make_pair(shape, getattr(syn, fn_name)(*args), seed=3,
                          texture=texture)
        b = ref_syn.make_pair(shape, getattr(ref_syn, fn_name)(*args),
                              seed=3, texture=texture)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    i0, _, true = a
    assert np.array_equal(syn.gradient_mask(i0, 0.75),
                          ref_syn.gradient_mask(i0, 0.75))
    assert np.array_equal(syn.interior_mask(shape, (0, 2, 3)),
                          ref_syn.interior_mask(shape, (0, 2, 3)))
    mask = syn.interior_mask(shape, 2)
    assert syn.epe(true * 0.9, true, mask) == ref_syn.epe(true * 0.9, true,
                                                          mask)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    import shutil

    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    assert list(tmp_path.iterdir()) == []


def test_library_path_follows_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "tpuflow3d_torch")
    assert re.fullmatch(r"lib[0-9a-f]{16}\.so", path.name)
    assert {p.name for p in kernels.CSRC_DIR.glob("*.cu")} == {
        "sor.cu", "warp_grad.cu", "median3.cu"}


def test_launch_counters_reset():
    kernels.LAUNCHES["median3"] += 2
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}
