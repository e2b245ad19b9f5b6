"""ctypes binding of the native host IO library (``csrc/flowio.cpp``).

Port of ``tpuflow3d.utils.native``: threaded raw reads and writes at an
offset, and threaded widening of uint8/uint16/int16 voxels to float32. The
library is host code, not a device kernel. It is built at first use with
``g++ -O3 -fPIC -shared -pthread -std=c++17`` into
``build/tpuflow3d_torch/libflowio-<hash>.so`` at the root of the checkout,
beside the CUDA kernels (the hash covers the source and the flags, so an
edited source rebuilds). As in the reference it is optional: where there
is no compiler, or the build fails, each function returns None or False
and ``volume.py`` takes its numpy route, which gives the same results;
``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flowio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpuflow3d_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
_error = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libflowio-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    """Compile the library into a temporary file and rename it into place
    (concurrent builds are safe); raise with the compiler's output."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=lib.stem + ".",
                                     dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, lib.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, lib)


def get_lib():
    """The loaded library, or None if it cannot be built or loaded."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = str(e)
            return None
        lib.flowio_read.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_void_p]
        lib.flowio_read.restype = ctypes.c_int
        lib.flowio_write.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int64]
        lib.flowio_write.restype = ctypes.c_int
        lib.flowio_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int]
        lib.flowio_to_f32.restype = ctypes.c_int
        lib.flowio_minmax_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.POINTER(ctypes.c_float)]
        lib.flowio_minmax_f32.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    """Why the library is unavailable (None if it loaded or was not
    tried)."""
    return _error


def read_bytes(path: str, offset: int, nbytes: int) -> np.ndarray | None:
    """Threaded pread into a fresh buffer; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(nbytes, np.uint8)
    rc = lib.flowio_read(path.encode(), offset, nbytes,
                         buf.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(-rc, f"flowio_read({path}, {offset}, {nbytes})")
    return buf


def write_bytes(path: str, offset: int, data: np.ndarray,
                total_bytes: int = -1) -> bool:
    """Threaded pwrite of ``data`` at ``offset``, the file created and
    extended to ``total_bytes`` first (never truncated); False if native
    unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data)
    rc = lib.flowio_write(path.encode(), offset, data.nbytes,
                          data.ctypes.data_as(ctypes.c_void_p), total_bytes)
    if rc != 0:
        raise OSError(-rc, f"flowio_write({path}, {offset})")
    return True


_KIND = {"uint8": 0, "uint16": 1, "int16": 2}


def to_f32(arr: np.ndarray) -> np.ndarray | None:
    """Threaded widen of u8/u16/i16 to f32; None if not applicable."""
    lib = get_lib()
    kind = _KIND.get(str(arr.dtype))
    if lib is None or kind is None:
        return None
    arr = np.ascontiguousarray(arr)
    out = np.empty(arr.shape, np.float32)
    rc = lib.flowio_to_f32(arr.ctypes.data_as(ctypes.c_void_p),
                           out.ctypes.data_as(ctypes.c_void_p),
                           arr.size, kind)
    if rc != 0:
        raise OSError(-rc, "flowio_to_f32")
    return out


def minmax_f32(arr: np.ndarray):
    """(min, max) of a float32 array, threaded; None if not applicable."""
    lib = get_lib()
    if lib is None or arr.dtype != np.float32:
        return None
    arr = np.ascontiguousarray(arr)
    mn = ctypes.c_float()
    mx = ctypes.c_float()
    rc = lib.flowio_minmax_f32(arr.ctypes.data_as(ctypes.c_void_p), arr.size,
                               ctypes.byref(mn), ctypes.byref(mx))
    if rc != 0:
        raise OSError(-rc, "flowio_minmax_f32")
    return float(mn.value), float(mx.value)
