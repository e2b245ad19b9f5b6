"""Derived-field post-processing of a computed flow.

Port of ``tpuflow3d.postproc``: divergence (volumetric expansion rate),
curl (vorticity), the Jacobian determinant det(I + grad s) (local volume
ratio of x -> x + s, the strain measure of 4D-CT deformation analysis),
forward-backward consistency, and Lagrangian tracking of seed points
through a series of flows. One headerless ``.raw`` per scalar field, as
the flow outputs.

Host-side numpy, as in the reference (the port's own copy): it runs once
per job, and every stencil op streams Z-chunks (replicate-edge margins)
so that its temporaries are per slab. Stencils match the solver's
convention (central differences with replicate edges: half-slope at the
boundary). ``consistency_error`` streams Z-chunks through the port's
``warp.warp_volume`` on the run's device instead.
"""

from __future__ import annotations

import numpy as np

DERIVED_FIELDS = ("divergence", "curl", "jacdet")

# Flow channel c holds the displacement along volume axis c, in voxels,
# with axes (0, 1, 2) = (z, y, x) — volume.FLOW_COMPONENT_FILES maps
# channel 2 to u (x), 1 to v (y), 0 to w (z).


def _slab(x: np.ndarray, lo: int, size: int) -> np.ndarray:
    """Host window [lo, lo+size) along axis -3 with edge replication
    (same convention as piecewise._host_slab)."""
    d = x.shape[-3]
    idx = np.clip(np.arange(lo, lo + size), 0, d - 1)
    return np.take(x, idx, axis=-3)


def _stream_z(fn, flow: np.ndarray, out_channels: int,
              chunk_z: int = 64) -> np.ndarray:
    """Apply a radius-1 stencil op per Z-chunk. Each slab carries one real
    margin plane per side (replicate at global faces), so the stitched
    result is exactly the full-volume computation while temporaries stay
    per-slab."""
    d = flow.shape[-3]
    shape = flow.shape[1:]
    out = np.empty((out_channels, *shape) if out_channels > 1 else shape,
                   flow.dtype)
    for z0 in range(0, d, chunk_z):
        z1 = min(z0 + chunk_z, d)
        r = fn(_slab(flow, z0 - 1, (z1 - z0) + 2))
        out[..., z0:z1, :, :] = r[..., 1:1 + (z1 - z0), :, :]
    return out


def _cdiff(x: np.ndarray, axis: int) -> np.ndarray:
    """Central difference with replicate edges (half-slope boundary),
    matching derivatives.central_diff."""
    xp = np.concatenate([np.take(x, [0], axis=axis), x,
                         np.take(x, [-1], axis=axis)], axis=axis)
    n = x.shape[axis]
    fwd = np.take(xp, range(2, n + 2), axis=axis)
    bwd = np.take(xp, range(0, n), axis=axis)
    return ((fwd - bwd) * 0.5).astype(x.dtype)


def _div_impl(flow: np.ndarray) -> np.ndarray:
    out = _cdiff(flow[0], 0)
    for a in (1, 2):
        out += _cdiff(flow[a], a)
    return out


def divergence(flow: np.ndarray, chunk_z: int = 64) -> np.ndarray:
    """div s = sum_a d(s_a)/d(axis_a): positive where the material locally
    expands between frames."""
    return _stream_z(_div_impl, np.asarray(flow), 1, chunk_z)


def _curl_impl(flow: np.ndarray) -> np.ndarray:
    d = {(j, k): _cdiff(flow[k], j)
         for j in range(3) for k in range(3) if j != k}
    return np.stack([
        d[(1, 2)] - d[(2, 1)],
        d[(2, 0)] - d[(0, 2)],
        d[(0, 1)] - d[(1, 0)],
    ])


def curl(flow: np.ndarray, chunk_z: int = 64) -> np.ndarray:
    """Vorticity curl s, components in the same (z, y, x) channel order as
    the flow: curl[i] = eps_ijk d_j s_k over axis indices (0,1,2)=(z,y,x).
    For a rigid rotation of angular velocity vector omega (in that basis),
    curl = 2*omega."""
    return _stream_z(_curl_impl, np.asarray(flow), 3, chunk_z)


def _jacdet_impl(flow: np.ndarray) -> np.ndarray:
    def j(c, a):
        e = _cdiff(flow[c], a)
        if c == a:
            e += 1.0
        return e

    # Cofactor expansion along row 0 (slab-local, so temporaries are cheap).
    j10, j11, j12 = j(1, 0), j(1, 1), j(1, 2)
    j20, j21, j22 = j(2, 0), j(2, 1), j(2, 2)
    det = j(0, 0) * (j11 * j22 - j12 * j21)
    det -= j(0, 1) * (j10 * j22 - j12 * j20)
    det += j(0, 2) * (j10 * j21 - j11 * j20)
    return det


def jacobian_det(flow: np.ndarray, chunk_z: int = 64) -> np.ndarray:
    """det(I + grad s) of the deformation x -> x + s(x): the local volume
    ratio (1 = incompressible, <1 compression, >1 expansion)."""
    return _stream_z(_jacdet_impl, np.asarray(flow), 1, chunk_z)


def consistency_error(flow_fwd: np.ndarray, flow_bwd: np.ndarray,
                      interp: str = "trilinear", chunk_z: int = 64,
                      device=None) -> np.ndarray:
    """Forward-backward consistency error map (voxels).

    e(x) = | s_f(x) + s_b(x + s_f(x)) |: zero wherever the forward and
    backward solves agree (for a diffeomorphic true motion,
    s_b(x + s_f(x)) = -s_f(x)); large where matching failed or material
    became occluded/disoccluded between frames. Thresholding it gives an
    occlusion mask.

    Streams Z-chunks through the port's warp (``warp.warp_volume``, plain
    PyTorch, as the reference's XLA warp) under a window ``HaloCtx`` on
    ``device`` (the GPU unless the caller names another; where there is
    none that raises, pass ``device="cpu"``), so the device never holds
    both whole flow fields. The warp margin is taken from the forward
    field (it bounds the Z reach of the backward-flow samples). On a CUDA
    device the slab is one CUDA graph replayed for every chunk, its origin
    in device memory (``graphs.stream_runner``, as the streamed solve's
    phases)."""
    from functools import partial

    from tpuflow3d_torch import graphs
    from tpuflow3d_torch.piecewise import _Stager
    from tpuflow3d_torch.pipeline import default_device

    dev = default_device(device)
    ff = np.asarray(flow_fwd, np.float32)
    fb = np.asarray(flow_bwd, np.float32)
    d = ff.shape[-3]
    mw = (int(np.ceil(float(np.abs(ff[0]).max()))) + 1
          + (1 if interp == "tricubic" else 0))
    chunk = min(chunk_z, d)
    size = chunk + 2 * mw

    st = _Stager(dev, graphs.stream_runner(
        ("consistency", interp, ff.shape, chunk), dev,
        arena=7 * graphs.aligned(size * ff.shape[-2] * ff.shape[-1])))
    ph = st.phase(partial(_consistency_slab, dg=d, interp=interp), (ff, fb),
                  size)
    out = np.empty(ff.shape[1:], np.float32)
    for z0 in range(0, d, chunk):
        z1 = min(z0 + chunk, d)
        lo = z0 - mw
        (r,) = ph(st.put_all(ph, (ff, fb), lo, size), (lo,))
        st.store(out[z0:z1], st.get(r[mw:mw + (z1 - z0)]))
    return out


def _consistency_slab(ffs, fbs, z0, dg: int, interp: str):
    """|s_f + s_b(x + s_f)| on a slab of the forward and backward flows
    whose plane 0 is global plane z0 (an int or a 0-d tensor)."""
    import torch

    from tpuflow3d_torch.grid import HaloCtx
    from tpuflow3d_torch.warp import warp_volume

    ctx = HaloCtx(window_z0=z0, window_d_global=dg)
    bw = torch.stack([warp_volume(fbs[c], ffs, ctx, interp=interp)
                      for c in range(3)])
    return torch.sqrt(torch.sum((ffs + bw) ** 2, dim=0))


def write_derived(prefix: str, flow: np.ndarray, which) -> list[str]:
    """Compute and write the requested derived fields next to the flow
    outputs. ``which``: iterable of names from DERIVED_FIELDS. Returns the
    written file paths. curl writes one raw per component using the u/v/w
    (x/y/z) suffix convention of volume.write_flow."""
    from tpuflow3d_torch import volume as vio

    written = []
    for name in which:
        if name == "divergence":
            vio.write_raw(f"{prefix}divergence.raw", divergence(flow))
            written.append(f"{prefix}divergence.raw")
        elif name == "curl":
            c = curl(flow)
            for suffix, ci in vio.FLOW_COMPONENT_FILES.items():
                vio.write_raw(f"{prefix}curl_{suffix}.raw", c[ci])
                written.append(f"{prefix}curl_{suffix}.raw")
        elif name == "jacdet":
            vio.write_raw(f"{prefix}jacdet.raw", jacobian_det(flow))
            written.append(f"{prefix}jacdet.raw")
        else:
            raise ValueError(f"unknown derived field {name!r}; "
                             f"choose from {DERIVED_FIELDS}")
    return written


def sample_flow_at(flow: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Trilinearly sample a (3, D, H, W) flow at scattered (N, 3) points.

    ``pts`` are fractional (z, y, x) voxel coordinates; out-of-range
    points clamp to the boundary (the solver's warp convention,
    SURVEY.md §10 "out-of-range warp lookups clamp"). Returns (N, 3)
    displacement vectors in (dz, dy, dx) channel order.
    """
    flow = np.asarray(flow)
    pts = np.asarray(pts, np.float64)
    if flow.ndim != 4 or flow.shape[0] != 3:
        raise ValueError(f"flow must be (3,D,H,W), got {flow.shape}")
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (N,3) zyx, got {pts.shape}")
    if not np.isfinite(pts).all():
        bad = np.where(~np.isfinite(pts).all(axis=1))[0]
        raise ValueError(f"non-finite sample point(s) at row(s) "
                         f"{bad[:8].tolist()}: corrupt seeds would produce "
                         f"silently wrong trajectories")
    if min(flow.shape[1:]) < 2:
        raise ValueError(f"flow grid too small to interpolate: "
                         f"{flow.shape[1:]}")
    dims = np.asarray(flow.shape[1:], np.float64)
    p = np.clip(pts, 0.0, dims - 1.0)
    lo = np.minimum(np.floor(p), dims - 2.0).astype(np.int64)
    lo = np.maximum(lo, 0)
    f = p - lo  # (N, 3) in [0, 1]
    out = np.zeros((pts.shape[0], 3), np.float64)
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                wgt = (np.where(cz, f[:, 0], 1 - f[:, 0])
                       * np.where(cy, f[:, 1], 1 - f[:, 1])
                       * np.where(cx, f[:, 2], 1 - f[:, 2]))
                vals = flow[:, lo[:, 0] + cz, lo[:, 1] + cy, lo[:, 2] + cx]
                out += wgt[:, None] * vals.T
    return out


def advance_points(flow: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """One Lagrangian step: p_{t+1} = p_t + s_t(p_t).

    The solver's field satisfies I1(x + s(x)) = I0(x) — a particle at x
    in the fixed frame sits at x + s(x) in the moving frame — so
    integrating a --frames sequence tracks material points through the
    4D acquisition (the standard downstream use of the reference's
    output in time-resolved tomography).
    """
    return np.asarray(pts, np.float64) + sample_flow_at(flow, pts)


def read_seed_csv(path: str) -> np.ndarray:
    """Read (z, y, x) seed points, one comma-separated triple per line.

    Only a non-numeric FIRST line is tolerated as a header; any later
    malformed or short row raises with its line number — a typo'd seed
    must fail loudly, not vanish from the track set."""
    rows = []
    first_content_line = True
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            try:
                vals = [float(v) for v in parts[:3]]
                numeric = True
            except ValueError:
                numeric = False
            if first_content_line and not numeric:
                # A '#'-prefixed first line is ALWAYS a comment header
                # (it may legitimately contain numbers: '# shift 1.5,
                # -1.0'). Otherwise only a first line with NO parseable
                # float passes as a header — 'z y x', 'z,y,x' land here;
                # a first line that parses PARTIALLY ('1.0,2.0,3.O') is
                # a typo'd data row, not a header: fall through and
                # raise with the line number instead of dropping it.
                def _is_float(v):
                    try:
                        float(v)
                        return True
                    except ValueError:
                        return False
                if line.startswith("#") or \
                        not any(_is_float(v) for v in parts):
                    first_content_line = False
                    continue
            first_content_line = False
            if len(parts) < 3:
                raise ValueError(
                    f"{path}:{lineno}: expected 3 comma-separated values "
                    f"(z,y,x), got {len(parts)}: {line!r}")
            if not numeric:
                raise ValueError(f"{path}:{lineno}: could not parse seed "
                                 f"row {line!r}")
            rows.append(vals)
    if not rows:
        raise ValueError(f"no seed points in {path}")
    return np.asarray(rows, np.float64)


def write_tracks_csv(path: str, tracks: np.ndarray) -> None:
    """Write (T, N, 3) trajectories as CSV rows t,point,z,y,x."""
    tracks = np.asarray(tracks)
    with open(path, "w") as fh:
        fh.write("t,point,z,y,x\n")
        for t in range(tracks.shape[0]):
            for n in range(tracks.shape[1]):
                z, y, x = tracks[t, n]
                fh.write(f"{t},{n},{z:.6f},{y:.6f},{x:.6f}\n")
