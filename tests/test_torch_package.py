"""Package-level properties of tpuflow3d_torch: it imports with JAX
blocked and names neither jax nor tpuflow3d; no fallback from kernels to
plain; unsupported settings raise and the ported ones run; the
synthetic-data copy is bitwise the reference's; and the kernel build fails
loudly without nvcc."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow3d import synthetic as ref_syn
from tpuflow3d.params import PRESETS as REF_PRESETS
from tpuflow3d_torch import PRESETS, FlowParams, compute_flow, kernels
from tpuflow3d_torch import synthetic as syn
from tpuflow3d_torch.backend import check_supported, unsupported
from tpuflow3d_torch.params import from_reference

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
    dict(deriv_order=4), dict(terms_dtype="bfloat16"),
    dict(dtype="bfloat16")], ids=lambda kw: "-".join(map(str, kw.values())))
def test_unsupported_settings_raise(kw):
    vol = np.zeros((8, 8, 8), np.float32)
    for backend in ("auto", "plain"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compute_flow(vol, vol, FlowParams(levels=1, backend=backend,
                                              **kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(solver="multigrid"), dict(interp="tricubic"), dict(gamma=1.0)],
    ids=lambda kw: "-".join(map(str, kw.values())))
def test_ported_settings_run(kw):
    """Settings that raised before multigrid, tricubic and gamma were
    ported now run, on any backend, to a finite flow."""
    i0, i1, _ = syn.make_pair((8, 8, 8), syn.translation((0.5, 0.0, 0.5)))
    for backend in ("auto", "plain"):
        p = FlowParams(levels=1, warps=2, inner_iterations=2, sweeps=4,
                       backend=backend, **kw)
        flow = compute_flow(i0, i1, p, device="cpu")
        assert flow.shape == (3, 8, 8, 8)
        assert bool(torch.isfinite(flow).all()) and float(flow.abs().max()) > 0


def test_packed_layout_runs_plain_on_cpu():
    """The packed layout is a kernel layout: on CPU tensors the plain
    versions serve it; it raises only where kernels would run (CUDA)."""
    check_supported(FlowParams(sweep_layout="packed"), torch.zeros(1))


def test_reference_accurate_preset_is_served_on_the_kernel_route():
    """The reference's ``accurate`` preset keeps its default packed layout,
    which the JAX package never sweeps under multigrid: the check passes
    where the kernels run. Packed SOR there still raises (K4; K7 with
    gamma), and both reference accurate presets map onto the port's."""
    acc = from_reference(REF_PRESETS["accurate"])
    assert acc.sweep_layout == "packed" and acc.solver == "multigrid"
    assert unsupported(acc, kernels=True) == []
    assert acc.replace(sweep_layout="flat") == PRESETS["accurate"]
    for gamma, k in ((0.0, "K4"), (1.0, "K7")):
        sor = acc.replace(solver="sor", gamma=gamma)
        assert unsupported(sor, kernels=False) == []
        (msg,) = unsupported(sor, kernels=True)
        assert "packed" in msg and f"ROADMAP queue 2, {k}" in msg
    (msg,) = unsupported(from_reference(REF_PRESETS["accurate-bf16"]),
                         kernels=True)
    assert "item 5" in msg


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
        "sor.cu", "warp_grad.cu", "median3.cu", "sor_gc.cu"}


def test_kernels_build_without_fma_contraction(monkeypatch):
    """The kernels must round as their plain versions (the ``accurate``
    path amplifies last-bit differences), so nvcc may not fuse a multiply
    and an add, and the flag is part of the library's hash."""
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    path = kernels.library_path()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", tuple(
        f for f in kernels.NVCC_FLAGS if f != "-fmad=false"))
    assert kernels.library_path() != path


def test_launch_counters_reset():
    kernels.LAUNCHES["median3"] += 2
    kernels.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}
