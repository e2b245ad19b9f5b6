"""Hand-written CUDA kernels for Hopper, built at first use.

The sources are ``tpuflow3d_torch/csrc/*.cu``, each with a plain C entry
point that launches its kernel on a given stream and returns
``cudaGetLastError()``. ``load_library`` compiles them with nvcc for
``sm_90a`` into ``build/tpuflow3d_torch/lib<hash>.so`` at the root of the
checkout (the hash covers the sources and the flags, so an edited source
rebuilds) and loads it with ctypes. A missing nvcc or a failed build
raises, with nvcc's output; nothing falls back to the plain versions.

``LAUNCHES`` counts the launches of each kernel: each wrapper adds one
where it launches, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpuflow3d_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"sor_halfsweep": 0, "warp_grad": 0, "median3": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # du, c, g, psi_s, psi_d, du_lo, du_hi, ps_lo, ps_hi, out, D, H, W, z0,
    # dg, half_alpha, omega, one_minus_omega, color, stream
    "tf3d_sor_halfsweep": [_P] * 10 + [_I] * 5 + [_F] * 3 + [_I, _P],
    # i1, flow, i0, g, it, D, H, W, stream
    "tf3d_warp_grad": [_P] * 5 + [_I] * 3 + [_P],
    # x, lo, hi, out, C, D, H, W, stream
    "tf3d_median3": [_P] * 4 + [_I] * 4 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (not on PATH, no CUDA_HOME): the "
                           "CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Concurrent builds are safe: each writes a temporary file and renames
    it into place."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=lib.stem + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what every kernel takes)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(name: str, fn, *args) -> None:
    """Call a C entry point (which launches on the current stream), raise on
    a launch error, and count the launch."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
