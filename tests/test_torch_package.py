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


# The command line, the host modules it needs, and the Z-sharded and
# multi-process layers: the guard must reach them.
HOST_MODULES = {"tpuflow3d_torch.cli", "tpuflow3d_torch.postproc",
                "tpuflow3d_torch.sharding", "tpuflow3d_torch.distributed",
                "tpuflow3d_torch.vtkio", "tpuflow3d_torch.volume",
                "tpuflow3d_torch.ops.registry",
                "tpuflow3d_torch.utils.logging",
                "tpuflow3d_torch.utils.memory",
                "tpuflow3d_torch.utils.native",
                "tpuflow3d_torch.utils.profiling"}


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpuflow3d'] = None\n"
        "import tpuflow3d_torch\n"
        "for m in pkgutil.walk_packages(tpuflow3d_torch.__path__, "
        "'tpuflow3d_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print(m.name)\n"
        "assert not [m for m in sys.modules if m.startswith('jax') and "
        "sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    lines = out.stdout.split()
    assert out.returncode == 0 and lines[-1] == "ok", out.stderr
    assert HOST_MODULES <= set(lines)


def test_no_file_names_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpuflow3d)\b(?!_torch)",
                     re.MULTILINE)
    files = list(PKG.rglob("*.py"))
    assert len(files) >= 24
    names = {".".join(f.relative_to(SRC).with_suffix("").parts)
             for f in files}
    assert HOST_MODULES <= names
    assert [f for f in files if pat.search(f.read_text())] == []


def test_kernels_backend_on_cpu_raises():
    vol = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_flow(vol, vol, FlowParams(levels=1, backend="kernels"),
                     device="cpu")


def test_device_argument():
    """Numpy input runs on the GPU unless a device is named, and where
    there is no GPU that raises, naming device="cpu", instead of running on
    the CPU; tensor input runs where it lies, and a device argument that
    names another place raises."""
    vol = np.zeros((8, 8, 8), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r'device="cpu"'):
            compute_flow(vol, vol, FlowParams(levels=1))
    assert compute_flow(vol, vol, FlowParams(levels=1, warps=1, sweeps=1),
                        device="cpu").device.type == "cpu"
    t = torch.from_numpy(vol)
    p = FlowParams(levels=1, warps=1, inner_iterations=1, sweeps=1)
    assert compute_flow(t, t, p, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="device"):
        compute_flow(t, t, p, device="meta")


@pytest.mark.parametrize("kw", [
    dict(dtype="bfloat16"), dict(terms_dtype="float16")],
    ids=lambda kw: "-".join(map(str, kw.values())))
def test_unsupported_settings_raise(kw):
    """A solver dtype other than float32 raises, saying why (the reference
    documents float32 as its only one); so does a storage type of the
    sweep constants that the kernels have no instantiation for."""
    vol = np.zeros((8, 8, 8), np.float32)
    for backend in ("auto", "plain"):
        with pytest.raises(NotImplementedError, match="float32"):
            compute_flow(vol, vol, FlowParams(levels=1, backend=backend,
                                              **kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(solver="multigrid"), dict(interp="tricubic"), dict(gamma=1.0),
    dict(deriv_order=4), dict(terms_dtype="bfloat16"),
    dict(sweep_layout="packed"), dict(sweep_layout="packed", gamma=1.0),
    dict(solver="multigrid", terms_dtype="bfloat16")],
    ids=lambda kw: "-".join(map(str, kw.values())))
def test_ported_settings_run(kw):
    """Settings that raised before they were ported (multigrid, tricubic,
    gamma; then order-4 stencils, bfloat16 term storage and the packed
    layout) run, on any backend, to a finite flow."""
    i0, i1, _ = syn.make_pair((8, 8, 8), syn.translation((0.5, 0.0, 0.5)))
    for backend in ("auto", "plain"):
        p = FlowParams(levels=1, warps=2, inner_iterations=2, sweeps=4,
                       backend=backend, **kw)
        flow = compute_flow(i0, i1, p, device="cpu")
        assert flow.shape == (3, 8, 8, 8)
        assert bool(torch.isfinite(flow).all()) and float(flow.abs().max()) > 0


def test_packed_layout_runs_plain_on_cpu():
    """The packed layout is served on any device: on CPU tensors the plain
    versions of K4 and K7 run it, and the flow is bitwise the flat
    layout's."""
    check_supported(FlowParams(sweep_layout="packed"), torch.zeros(1))
    i0, i1, _ = syn.make_pair((8, 8, 8), syn.translation((0.5, 0.0, 0.5)))
    p = FlowParams(levels=1, warps=2, inner_iterations=2, sweeps=4)
    before = dict(kernels.LAUNCHES)
    flat = compute_flow(i0, i1, p, device="cpu")
    packed = compute_flow(i0, i1, p.replace(sweep_layout="packed"),
                          device="cpu")
    assert kernels.LAUNCHES == before
    assert torch.equal(packed, flat)


def test_reference_accurate_preset_is_served_on_the_kernel_route():
    """Every preset of the reference maps onto a configuration this port
    serves, where the kernels run and where they do not: ``accurate`` and
    ``accurate-bf16`` (packed by the reference's default, which it never
    sweeps under multigrid; bfloat16 terms), the packed ``ladder*`` SOR
    presets (K4; K7 with gamma), and order-4 stencils."""
    assert set(REF_PRESETS) == set(PRESETS)
    for name, rp in REF_PRESETS.items():
        p = from_reference(rp)
        assert p.sweep_layout == "packed"
        assert p.replace(sweep_layout="flat") == PRESETS[name]
        for q in (p, p.replace(gamma=1.0), p.replace(deriv_order=4)):
            assert unsupported(q) == [], name
            for backend in ("auto", "plain"):
                check_supported(q.replace(backend=backend), torch.zeros(1))
    acc = from_reference(REF_PRESETS["accurate-bf16"])
    assert acc.solver == "multigrid" and acc.terms_dtype == "bfloat16"
    (msg,) = unsupported(acc.replace(dtype="bfloat16"))
    assert "terms_dtype='bfloat16'" in msg and "only solver dtype" in msg


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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_set_coord_dtype_is_the_references(dtype):
    """make_pair under float32 coordinates (and under the float64 default)
    is bitwise the reference's; the module global is restored, so other
    tests in the same process see the default."""
    shape = (10, 12, 9)
    pairs = {}
    try:
        for mod in (syn, ref_syn):
            mod.set_coord_dtype(dtype)
            pairs[mod] = mod.make_pair(shape, mod.sinusoid(shape, 1.2),
                                       seed=3)
    finally:
        syn.set_coord_dtype(np.float64)
        ref_syn.set_coord_dtype(np.float64)
    for x, y in zip(pairs[syn], pairs[ref_syn]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert syn._COORD_DTYPE == np.float64
    default = syn.make_pair(shape, syn.sinusoid(shape, 1.2), seed=3)
    same = all(np.array_equal(a, b) for a, b in zip(default, pairs[syn]))
    assert same == (dtype == np.float64)


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
        "sor.cu", "warp_grad.cu", "median3.cu", "sor_gc.cu", "sor_packed.cu",
        "sor_gc_packed.cu", "probe.cu", "terms.cu", "mg_transfer.cu"}


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """The hash covers the headers the sources include, so an edited
    header rebuilds."""
    import shutil
    path = kernels.library_path()
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    assert kernels.library_path() == path
    assert (csrc / "terms.cuh").is_file()
    with open(csrc / "terms.cuh", "a") as f:
        f.write("// edited\n")
    assert kernels.library_path() != path


def test_every_entry_point_is_declared_and_counted():
    """Each extern "C" entry point of the sources has its argument types
    declared, and each kernel its launch counter."""
    entries = set()
    for src in kernels.CSRC_DIR.glob("*.cu"):
        entries |= set(re.findall(r'extern "C" int (\w+)\(',
                                  src.read_text()))
    assert entries == set(kernels._SIGNATURES)
    assert set(kernels.LAUNCHES) == {
        "sor_halfsweep", "warp_grad", "median3", "warp_grad_tricubic",
        "sor_gc", "sor_packed", "sor_gc_packed", "terms", "terms_gc",
        "mg_restrict", "mg_prolong"}


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
