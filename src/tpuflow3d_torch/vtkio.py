"""Legacy-VTK structured-points export for ParaView/VisIt.

Port of ``tpuflow3d.vtkio`` (numpy only; the port's own copy): one
self-describing .vtk file per field, the flow as a VECTORS attribute, byte
for byte the files the reference writes.

Format notes:
- Legacy VTK BINARY payloads are big-endian by spec, regardless of host.
- STRUCTURED_POINTS point order is x-fastest, then y, then z: the (Z, Y, X)
  C-order memory layout, so the payload is a byteswap and, for vectors, a
  component interleave, no transpose.
- The flow array is (3, Z, Y, X) with component 0 = dz, 1 = dy, 2 = dx
  (volume.FLOW_COMPONENT_FILES); VTK vectors are (vx, vy, vz).
"""

from __future__ import annotations

import numpy as np

_HEADER = (
    "# vtk DataFile Version 3.0\n"
    "{title}\n"
    "BINARY\n"
    "DATASET STRUCTURED_POINTS\n"
    "DIMENSIONS {nx} {ny} {nz}\n"
    "ORIGIN 0 0 0\n"
    "SPACING 1 1 1\n"
    "POINT_DATA {npts}\n"
)


def _be32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=">f4")


def write_vtk_scalar(path: str, vol: np.ndarray, name: str = "value",
                     title: str = "tpuflow3d scalar field") -> None:
    """Write one (Z, Y, X) scalar volume as a legacy-VTK file."""
    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError(f"scalar volume must be (Z,Y,X), got {vol.shape}")
    d, h, w = vol.shape
    hdr = _HEADER.format(title=title, nx=w, ny=h, nz=d, npts=d * h * w)
    with open(path, "wb") as f:
        f.write(hdr.encode("ascii"))
        f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n"
                .encode("ascii"))
        f.write(_be32(vol).tobytes())


def write_vtk_flow(path: str, flow: np.ndarray, name: str = "flow",
                   title: str = "tpuflow3d optical flow") -> None:
    """Write a (3, Z, Y, X) flow field as a legacy-VTK VECTORS attribute.

    Component order on disk is (vx, vy, vz) per voxel as VTK requires;
    our storage order (dz, dy, dx) is reversed into that.
    """
    flow = np.asarray(flow)
    if flow.ndim != 4 or flow.shape[0] != 3:
        raise ValueError(f"flow must be (3,Z,Y,X), got {flow.shape}")
    d, h, w = flow.shape[1:]
    hdr = _HEADER.format(title=title, nx=w, ny=h, nz=d, npts=d * h * w)
    # (3,Z,Y,X) -> (Z,Y,X,3) with components reversed to (dx,dy,dz).
    interleaved = np.moveaxis(flow[::-1], 0, -1)
    with open(path, "wb") as f:
        f.write(hdr.encode("ascii"))
        f.write(f"VECTORS {name} float\n".encode("ascii"))
        f.write(_be32(interleaved).tobytes())


def read_vtk(path: str):
    """Minimal reader for the files this module writes (round-trip tests
    and quick inspection — not a general VTK parser).

    Returns (array, kind) where kind is "scalar" (array (Z,Y,X)) or
    "vector" (array (3,Z,Y,X) in tpuflow3d (dz,dy,dx) component order).
    """
    with open(path, "rb") as f:
        raw = f.read()
    # Header lines are ASCII up to the attribute declaration line.
    lines = []
    pos = 0
    while len(lines) < 16:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii")
        lines.append(line)
        pos = nl + 1
        if line.startswith(("VECTORS", "LOOKUP_TABLE")):
            break
    dims = next(ln for ln in lines if ln.startswith("DIMENSIONS")).split()
    nx, ny, nz = int(dims[1]), int(dims[2]), int(dims[3])
    n = nx * ny * nz
    if any(ln.startswith("VECTORS") for ln in lines):
        data = np.frombuffer(raw, dtype=">f4", count=3 * n, offset=pos)
        arr = data.astype(np.float32).reshape(nz, ny, nx, 3)
        return np.moveaxis(arr, -1, 0)[::-1].copy(), "vector"
    data = np.frombuffer(raw, dtype=">f4", count=n, offset=pos)
    return data.astype(np.float32).reshape(nz, ny, nx), "scalar"
