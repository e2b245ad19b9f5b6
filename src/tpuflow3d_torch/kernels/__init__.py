"""Hand-written CUDA kernels for Hopper, built at first use.

The sources are ``tpuflow3d_torch/csrc/*.cu``, each with a plain C entry
point that launches its kernel on a given stream and returns
``cudaGetLastError()``:

- ``sor.cu`` K1, the flat rank-1 SOR sweeps (``kernels/sor.py``): one
  colour per launch, or red and black fused in one launch;
- ``sor_packed.cu`` K4, the same on colour-packed arrays
  (``kernels/sor_packed.py``, with the layout ``pack_color`` /
  ``unpack_colors``);
- ``sor_gc.cu`` K6, the same for the general SPD system: gamma > 0 and
  every multigrid level (``kernels/sor_gc.py``); K1 and K6 share their
  kernels (``csrc/sor_sweep.cuh``);
- ``sor_gc_packed.cu`` K7, K6 on colour-packed arrays
  (``kernels/sor_gc_packed.py``);
- ``warp_grad.cu`` K2 (trilinear) and K5 (tricubic), the fused warp +
  derivatives (``kernels/warp_grad.py``), on a whole volume, a streamed
  window or, in halo form, a Z shard;
- ``median3.cu`` K3, the 3x3x3 median (``kernels/median3.py``);
- ``terms.cu`` K8, the rank-1 nonlinearity update of a whole volume,
  ``solver.compute_terms``' c, psi_s and psi_d, and K9, the same of the
  general system (gamma > 0): c, psi_s and ainv (``kernels/terms.py``);
- ``mg_transfer.cu`` K10, the multigrid V-cycle's residual fused with its
  restriction, and K11, its prolongation fused with the correction, on a
  whole in-core grid (``kernels/mg_transfer.py``);
- ``probe.cu`` no kernel of the path: the streaming copy and the
  fminf/fmaxf loop with which ``utils/roofline.py`` measures the card.

The four sweep kernels read ``c`` (and ``g``) stored in float32 or in
bfloat16 (``csrc/terms.cuh``). ``load_library`` compiles them with nvcc for
``sm_90a``, one nvcc per source, all started together, links the objects
into ``build/tpuflow3d_torch/lib<hash>.so`` at the root of the checkout
(the hash covers the sources, their headers and the flags, so an edited
source rebuilds)
and loads it with ctypes. A missing nvcc or a failed build raises, with
nvcc's output; nothing falls back to the plain versions.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into one
FMA, so a kernel that does its plain version's operations in the same
order rounds as it does. The ``accurate`` path needs that: its multigrid
solve amplifies last-bit differences, and with contraction the kernel and
plain flows drifted apart by up to 2e-3 at 256^3 (NVIDIA H100 80GB HBM3,
700 W); without it they are bitwise equal there.

``LAUNCHES`` counts the launches of each kernel: each wrapper adds one
where it launches, so a run can show that its main path went through the
kernels. Under a CUDA graph (``graphs.py``) a wrapper runs at its
segment's warm-up and capture, not at a replay: both are counted apart
(``counted_apart``), and each replay adds the capture's launches
(``add_launches``).
"""

from __future__ import annotations

import contextlib
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
              "-fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES = {"sor_halfsweep": 0, "warp_grad": 0, "median3": 0,
            "warp_grad_tricubic": 0, "sor_gc": 0, "sor_packed": 0,
            "sor_gc_packed": 0, "terms": 0, "terms_gc": 0,
            "mg_restrict": 0, "mg_prolong": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # du, c, g, psi_s, psi_d (K6: ainv), du_lo, du_hi, ps_lo, ps_hi, buf0,
    # buf1, z0_dev (the origin in device memory, may be null), D, H, W, z0,
    # dg, hz, hy, hx, omega, one_minus_omega, colours, nsweeps, terms_bf16,
    # launched (int*), stream
    "tf3d_sor_sweeps": ([_P] * 12 + [_I] * 5 + [_F] * 5 + [_I] * 3
                        + [_IP, _P]),
    "tf3d_sor_gc_sweeps": ([_P] * 12 + [_I] * 5 + [_F] * 5 + [_I] * 3
                           + [_IP, _P]),
    # i1, flow, i0, g, it, i1w (may be null), D, H, W, z0_dev (may be null),
    # z0, dg, ip (I1's pad planes in the halo form, else 0), cubic, staged,
    # tiles (int[2] on the device, may be null), stream
    "tf3d_warp_grad": [_P] * 6 + [_I] * 3 + [_P] + [_I] * 5 + [_P, _P],
    # du_a, du_o, c_a, g_a, ps_a, ps_o, pd_a, duo_lo, duo_hi, pso_lo, pso_hi,
    # out, D, H, WP, z0, dg, half_alpha, omega, one_minus_omega, color,
    # terms_bf16, stream
    "tf3d_sor_halfsweep_packed": ([_P] * 12 + [_I] * 5 + [_F] * 3
                                  + [_I, _I, _P]),
    # du_a, du_o, c_a, ainv_a, ps_a, ps_o, duo_lo, duo_hi, pso_lo, pso_hi,
    # out, D, H, WP, z0, dg, half_alpha, omega, one_minus_omega, color,
    # terms_bf16, stream
    "tf3d_sor_halfsweep_gc_packed": ([_P] * 11 + [_I] * 5 + [_F] * 3
                                     + [_I, _I, _P]),
    # x, lo, hi (both null on one device), out, C, D, H, W, stream
    "tf3d_median3": [_P] * 4 + [_I] * 4 + [_P],
    # g, it, flow, du, c, psi_s, psi_d, D, H, W, half_alpha, eps_data^2,
    # eps_smooth^2, Charbonnier data, Charbonnier smoothness, stream
    "tf3d_terms_rank1": [_P] * 7 + [_I] * 3 + [_F] * 3 + [_I] * 2 + [_P],
    # g, it, flow, du, gc_g, gc_it, c, psi_s, ainv, D, H, W, half_alpha,
    # eps_data^2, eps_smooth^2, eps_grad^2, gamma, Charbonnier data,
    # smoothness and gradient, stream
    "tf3d_terms_gc": [_P] * 9 + [_I] * 3 + [_F] * 5 + [_I] * 3 + [_P],
    # du, rhs, psi_s, d6, rc, the z, y and x tables, D, H, W, Dc, Hc, Wc,
    # hz, hy, hx, rhs_bf16, stream
    "tf3d_mg_restrict": [_P] * 8 + [_I] * 6 + [_F] * 3 + [_I, _P],
    # du, ec, out, the z, y and x tables, D, H, W, Dc, Hc, Wc, stream
    "tf3d_mg_prolong": [_P] * 6 + [_I] * 6 + [_P],
    # The probes of utils/roofline.py. dst, src, float4 count, reps, stream
    "tf3d_copy_probe": [_P, _P, ctypes.c_longlong, _I, _P],
    # out, blocks, iters, stream
    "tf3d_minmax_probe": [_P, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def counted_apart():
    """Launches made inside are left out of ``LAUNCHES``; the dict it
    yields receives them (kernel -> count) on exit."""
    before = dict(LAUNCHES)
    made = {}
    try:
        yield made
    finally:
        made.update({k: n - before[k] for k, n in LAUNCHES.items()
                     if n != before[k]})
        LAUNCHES.update(before)


def add_launches(made: dict) -> None:
    """Count launches made elsewhere (a CUDA graph's replay)."""
    for name, n in made.items():
        LAUNCHES[name] += n


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
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands together; raise with the output of the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, started together, then one link. Concurrent
    builds are safe: each works in a temporary directory and renames the
    library into place."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=lib.stem + ".",
                                     dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(_sources(), objs)])
        out = os.path.join(tmp, lib.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]])
        os.replace(out, lib)
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
                 device: torch.device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` (what every kernel takes; only the stored sweep constants
    may be other than float32)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(name: str, fn, *args, launched=None) -> None:
    """Call a C entry point (which launches on the current stream), raise on
    a launch error, and count the launch; an entry that launches several
    kernels reports how many through ``launched`` (a ctypes int it was
    passed by reference)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1 if launched is None else launched.value


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (a kernel
    launches on the current one): nothing to enter when it already is."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def origin(z0, device: torch.device) -> tuple:
    """A window's origin as the flat sweep and warp entries take it: (the
    address of a device int32, 0) for a 0-d tensor on ``device`` (a
    streamed slab replayed from a CUDA graph), else (None, the int)."""
    if isinstance(z0, torch.Tensor):
        check_tensor("z0", z0, (), device, torch.int32)
        return z0.data_ptr(), 0
    return None, int(z0)


def terms_dtype(c: torch.Tensor) -> torch.dtype:
    """The storage type of the sweep constants, from ``c``: float32 or
    bfloat16 (what the sweep kernels are instantiated for), else raise."""
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c: dtype {c.dtype}, expected torch.float32 or "
                        f"torch.bfloat16")
    return c.dtype
