"""Command-line app of the port.

Port of ``tpuflow3d.cli`` with the same flags, events, output files, exit
codes and error messages: parse arguments and settings, load two raw
volumes (or a series), choose the execution path, compute the flow and
write u/v/w (and magnitude) raws. It runs on the GPU: without
``--platform`` a machine without one exits 2, and ``--platform cpu`` runs
the plain versions of the kernels on the CPU.

The path is in-core (``pipeline.compute_flow``) unless the in-core peak
that ``utils.memory`` models for the run passes the device's budget, or
the volume passes a kernel's 32-bit index limits: then it is Z-sharded
over the GPUs where there are several and a rank's slab fits
(``sharding.compute_flow_sharded``, ``memory.sharded_peak_bytes``), else
the out-of-core mode (``piecewise.compute_flow_piecewise``), with a
Z-chunk from ``memory.pick_chunk_z``. On the GPU the in-core solve and
the streamed one replay CUDA graphs (``graphs.py``) captured by their
first pair, which every pair of a ``--frames`` series of one shape
reuses; a solve drops the other kind's graphs first, a sharded one all. ``--incore``, ``--piecewise`` and
``--sharded`` (one rank per GPU, ``--devices N`` of them; more than there
are exits 2) pin it. ``--distributed`` is the multi-process path: every
process runs this command with ``--coordinator``, ``--num-processes`` and
``--process-id`` (or torchrun's environment), reads and writes only its
own Z slab of the raw files (``distributed.compute_flow_distributed``).

Example:
    python -m tpuflow3d_torch.cli --frame0 a.raw --frame1 b.raw \
        --dims 256 256 256 --dtype uint8 --preset ladder256 --out flow_
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpuflow3d_torch import volume as vio
from tpuflow3d_torch.params import _REFERENCE_BACKENDS, PRESETS, FlowParams
from tpuflow3d_torch.utils.logging import JsonlLogger, summarize_residuals

PROG = "tpuflow3d-torch"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Dense 3D optical flow (variational, coarse-to-fine) "
                    "in PyTorch, with CUDA kernels for the GPU.")
    ap.add_argument("--frame0", help="fixed volume (.raw)")
    ap.add_argument("--frame1", help="moving volume (.raw)")
    ap.add_argument("--frames", nargs="+", metavar="RAW", default=None,
                    help="time series: N>=2 volumes -> N-1 flow fields "
                         "(frame t -> t+1), written as <out><t>_u.raw etc. "
                         "The next frame loads while a pair solves, and a "
                         "pair's outputs are written during the next solve")
    ap.add_argument("--list-ops", action="store_true",
                    help="print the device-op catalog (halo rule, bytes per "
                         "voxel, reference counterpart) and exit")
    ap.add_argument("--dims", type=int, nargs=3, metavar=("D", "H", "W"),
                    help="volume dims, z y x order (or use a .json sidecar)")
    ap.add_argument("--dtype", default=None,
                    help="input dtype (uint8/uint16/float32/...)")
    ap.add_argument("--out", default="flow_", help="output path prefix")
    ap.add_argument("--no-magnitude", action="store_true")
    ap.add_argument("--export-vtk", action="store_true",
                    help="also write <out>flow.vtk (legacy-VTK VECTORS, "
                         "ParaView drag-and-drop; + <out>magnitude.vtk "
                         "unless --no-magnitude)")
    ap.add_argument("--track", default=None, metavar="SEEDS.csv",
                    help="with --frames: Lagrangian particle tracking — "
                         "advance the seed points (CSV lines z,y,x) "
                         "through each pair's flow (p += s_t(p), flow "
                         "sampled trilinearly at the moving points) and "
                         "write <out>tracks.csv (t,point,z,y,x)")
    ap.add_argument("--apply-flow", default=None, metavar="PREFIX",
                    help="no solve: backward-warp --frame1 by an existing "
                         "flow (<PREFIX>{u,v,w}.raw) and write "
                         "<out>warped.raw — motion compensation of any "
                         "volume (e.g. a segmentation) by a computed "
                         "field; honors --interp")
    ap.add_argument("--derived", default=None, metavar="FIELDS",
                    help="comma list of derived fields to write next to "
                         "u/v/w: divergence (expansion rate), curl "
                         "(vorticity, 3 raws), jacdet (det(I+grad s), "
                         "local volume ratio — the 4D-CT strain measure)")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--settings", default=None,
                    help="JSON file of FlowParams overrides")
    for name, typ in [("alpha", float), ("levels", int),
                      ("scale_factor", float), ("warps", int),
                      ("inner_iterations", int), ("sweeps", int),
                      ("omega", float), ("presmooth_sigma", float),
                      ("eps_data", float), ("eps_smooth", float),
                      ("flow_clamp", float), ("deriv_order", int),
                      ("residual_tol", float), ("gamma", float),
                      ("eps_grad", float), ("mg_cycles", int),
                      ("mg_pre", int), ("mg_post", int),
                      ("mg_coarse_sweeps", int), ("mg_omega", float)]:
        ap.add_argument(f"--{name.replace('_', '-')}", type=typ, default=None,
                        dest=name)
    ap.add_argument("--interp", choices=["trilinear", "tricubic"],
                    default=None,
                    help="warp sampling: trilinear (reference behavior) or "
                         "tricubic Catmull-Rom (lower sub-voxel "
                         "interpolation bias)")
    ap.add_argument("--penalizer-data", choices=["charbonnier", "quadratic"],
                    default=None, dest="penalizer_data")
    ap.add_argument("--penalizer-smooth", choices=["charbonnier", "quadratic"],
                    default=None, dest="penalizer_smooth")
    ap.add_argument("--penalizer-grad", choices=["charbonnier", "quadratic"],
                    default=None, dest="penalizer_grad",
                    help="penalizer for the gradient-constancy term "
                         "(--gamma > 0: Brox-style robustness to additive "
                         "intensity changes)")
    ap.add_argument("--no-median", action="store_true")
    ap.add_argument("--solver", choices=["sor", "jacobi", "multigrid"],
                    default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="Z-shard across all visible GPUs, one rank each "
                         "(with --platform cpu: --devices ranks on the CPU)")
    ap.add_argument("--devices", type=int, default=None,
                    help="number of devices for --sharded (more than are "
                         "visible exits 2)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process run: torch.distributed bring-up, "
                         "host-local slab IO, Z-sharded solve over every "
                         "process (NCCL when each process has a GPU of its "
                         "own, gloo otherwise)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rank 0's address for --distributed (omit all three "
                         "under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="process count for --distributed manual launches")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's id for --distributed manual "
                         "launches")
    ap.add_argument("--piecewise", action="store_true",
                    help="out-of-core: stream Z-chunks through one device "
                         "(for volumes larger than device memory, or past "
                         "the kernels' 32-bit index limits)")
    ap.add_argument("--incore", action="store_true",
                    help="pin the single-device in-core path (disables the "
                         "automatic memory-based path selection)")
    ap.add_argument("--chunk-z", type=int, default=None,
                    help="Z-chunk planes for --piecewise (default: sized "
                         "automatically from device memory; 64 when the "
                         "budget is unknown)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/resume the flow at pyramid-level boundaries")
    ap.add_argument("--check-consistency", action="store_true",
                    help="also solve the reverse pair and write the "
                         "forward-backward consistency error map "
                         "(<out>consistency.raw, voxels) — the standard "
                         "flow-reliability/occlusion diagnostic. Doubles "
                         "solve time")
    ap.add_argument("--residuals", action="store_true",
                    help="log per-sweep residual curves")
    ap.add_argument("--timings", action="store_true",
                    help="log per-phase wall times (pyramid build + each "
                         "level, each ending in a device synchronize)")
    ap.add_argument("--report-fit", action="store_true",
                    help="log the data-term fit |I1(x+s) - I0| after the "
                         "solve (registration quality diagnostic)")
    ap.add_argument("--stats", action="store_true",
                    help="log min/max/mean/L2 of each input volume and of "
                         "the flow magnitude (ops registry 'statistics' op)")
    ap.add_argument("--log-json", default=None, help="JSONL log file path")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace "
                         "(trace.json) to this directory")
    ap.add_argument("--traceback", action="store_true",
                    help="show full tracebacks instead of one-line errors")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="where to run (default: the GPU, and exit 2 where "
                         "there is none; cpu runs the kernels' plain "
                         "versions)")
    return ap


def params_from_args(args) -> FlowParams:
    p = PRESETS[args.preset] if args.preset else FlowParams()
    overrides = {}
    if args.settings:
        with open(args.settings) as f:
            overrides.update(json.load(f))
        if "backend" in overrides:
            # A reference settings file names the reference's backends.
            overrides["backend"] = _REFERENCE_BACKENDS.get(
                overrides["backend"], overrides["backend"])
    for name in ["alpha", "levels", "scale_factor", "warps",
                 "inner_iterations", "sweeps", "omega", "presmooth_sigma",
                 "eps_data", "eps_smooth", "flow_clamp", "deriv_order",
                 "residual_tol", "gamma", "eps_grad", "penalizer_data",
                 "penalizer_smooth", "penalizer_grad", "solver", "interp",
                 "mg_cycles", "mg_pre", "mg_post", "mg_coarse_sweeps",
                 "mg_omega"]:
        v = getattr(args, name, None)
        if v is not None:
            overrides[name] = v
    if args.no_median:
        overrides["median"] = False
    if args.residuals:
        overrides["track_residuals"] = True
    return p.replace(**overrides)


def _device(args) -> torch.device:
    """The run's device: the CPU for ``--platform cpu``, else the GPU,
    raising ValueError (exit 2) where there is none."""
    if args.platform == "cpu":
        return torch.device("cpu")
    from tpuflow3d_torch.pipeline import default_device
    try:
        return default_device(None)
    except RuntimeError as e:
        raise ValueError(f"{e} (here: --platform cpu)") from None


def _sharded_devices(args, dev) -> list[str]:
    """The devices of --sharded, one rank each: the first --devices GPUs
    (all of them by default), or --devices ranks on the CPU with
    --platform cpu (one by default). More than are visible (GPUs, or
    the CPU cores this process may use) raises ValueError (exit 2): a card
    is never shared without being asked for (``compute_flow_sharded``'s
    ``devices`` list can)."""
    if dev.type == "cpu":
        have, what = len(os.sched_getaffinity(0)), "CPU cores"
    else:
        have, what = torch.cuda.device_count(), "GPUs"
    n = args.devices if args.devices is not None else (
        have if dev.type == "cuda" else 1)
    if n < 1 or n > have:
        raise ValueError(f"--sharded --devices {n}: {have} {what} visible "
                         "(ranks share a GPU only where the devices list of "
                         "sharding.compute_flow_sharded names it twice)")
    return ["cpu"] * n if dev.type == "cpu" else [f"cuda:{i}"
                                                  for i in range(n)]


def _load(path: str, dims, dtype) -> np.ndarray:
    meta = None
    if dims is not None:
        meta = vio.VolumeMeta(tuple(dims), dtype or "float32")
    arr = vio.read_raw(path, meta)
    if arr.dtype != np.float32:
        from tpuflow3d_torch.utils import native
        widened = native.to_f32(arr)  # threaded C++ route
        arr = widened if widened is not None else arr.astype(np.float32)
    return arr


def _list_ops() -> int:
    from tpuflow3d_torch.ops import OPS
    for name, spec in OPS.items():
        print(f"{name:16s}  {spec.bytes_per_voxel:5.0f} B/vox  "
              f"halo: {spec.z_halo:42s}  ref: {spec.reference}")
        if spec.byte_variants:
            var = ", ".join(f"{k}: {v:.1f}"
                            for k, v in spec.byte_variants.items())
            print(f"{'':16s}  bytes by form — {var}")
    return 0


def _apply_flow(args) -> int:
    """Warp --frame1 by an already-computed flow field (no solve): the
    backward warp I(x + s(x)) the solver applies, on the run's device."""
    from tpuflow3d_torch.warp import warp_volume

    if not args.frame1:
        raise ValueError("--apply-flow needs --frame1 (the volume to warp)")
    dev = _device(args)
    vol = _load(args.frame1, args.dims, args.dtype)
    comps = {}
    for name, ci in vio.FLOW_COMPONENT_FILES.items():
        comps[ci] = vio.read_raw(f"{args.apply_flow}{name}.raw",
                                 vio.VolumeMeta(vol.shape, "float32")
                                 if args.dims else None)
    flow = np.stack([comps[0], comps[1], comps[2]])
    if flow.shape[1:] != vol.shape:
        raise ValueError(f"flow grid {flow.shape[1:]} != volume grid "
                         f"{vol.shape}")
    interp = args.interp or "trilinear"
    warped = warp_volume(torch.as_tensor(vol, device=dev),
                         torch.as_tensor(flow, device=dev), interp=interp)
    out = f"{args.out}warped.raw"
    vio.write_raw(out, warped.cpu().numpy())
    print(f"{PROG}: warped {args.frame1} by {args.apply_flow} "
          f"({interp}) -> {out}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_ops:
        return _list_ops()
    if args.apply_flow:
        try:
            conflicts = [name for name, on in [
                ("--frames", bool(args.frames)),
                ("--piecewise", args.piecewise),
                ("--sharded", args.sharded),
                ("--distributed", args.distributed),
                ("--track", bool(args.track)),
                ("--derived", bool(args.derived))] if on]
            if conflicts:
                raise ValueError(
                    f"--apply-flow is a standalone post-processing mode; "
                    f"it cannot be combined with {' or '.join(conflicts)}")
            return _apply_flow(args)
        except (ValueError, OSError) as e:
            if args.traceback:
                raise
            print(f"{PROG}: error: {e}", file=sys.stderr)
            return 2
    if not args.frames and (not args.frame0 or not args.frame1):
        print(f"{PROG}: error: --frame0 and --frame1 (or --frames) are "
              "required", file=sys.stderr)
        return 2
    if args.frames and (args.frame0 or args.frame1):
        print(f"{PROG}: error: --frames and --frame0/--frame1 are "
              "mutually exclusive", file=sys.stderr)
        return 2
    try:
        return _run(args)
    except (ValueError, OSError) as e:
        if args.traceback:
            raise
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 2


def _check_path_flags(args) -> None:
    """The execution paths are mutually exclusive (checkpointing composes
    with all of them): reject ambiguous combinations instead of silently
    picking one."""
    modes = [name for name, on in [("--piecewise", args.piecewise),
                                   ("--sharded", args.sharded),
                                   ("--distributed", args.distributed),
                                   ("--incore", args.incore)]
             if on]
    if len(modes) > 1:
        raise ValueError(f"{' and '.join(modes)} are mutually exclusive")
    # Validate --derived before the (potentially hours-long) solve.
    _parse_derived(args)
    if args.track and not args.frames:
        raise ValueError("--track requires --frames (a time series to "
                         "integrate the seed points through)")
    if args.derived and args.distributed:
        raise ValueError(
            "--derived needs the assembled global flow; the distributed "
            "path writes per-process slabs. Compute derived fields from "
            "the written u/v/w raws afterwards (tpuflow3d_torch.postproc).")
    if args.export_vtk and args.distributed:
        raise ValueError(
            "--export-vtk needs the assembled global flow; the distributed "
            "path writes per-process slabs. Export VTK from the written "
            "u/v/w raws afterwards (tpuflow3d_torch.vtkio).")
    if args.check_consistency and (args.distributed or args.frames):
        raise ValueError(
            "--check-consistency supports the single-pair paths only "
            "(solve each direction explicitly for series/distributed "
            "runs and use tpuflow3d_torch.postproc.consistency_error)")


def _parse_derived(args) -> tuple:
    if not args.derived:
        return ()
    from tpuflow3d_torch.postproc import DERIVED_FIELDS
    which = tuple(s.strip() for s in args.derived.split(",") if s.strip())
    for name in which:
        if name not in DERIVED_FIELDS:
            raise ValueError(f"unknown --derived field {name!r}; choose "
                             f"from {', '.join(DERIVED_FIELDS)}")
    return which


def _export_vtk(args, log, prefix: str, flow) -> None:
    if not args.export_vtk:
        return
    from tpuflow3d_torch import vtkio
    files = [f"{prefix}flow.vtk"]
    vtkio.write_vtk_flow(files[0], flow)
    if not args.no_magnitude:
        mag = np.sqrt((flow ** 2).sum(axis=0, dtype=np.float32))
        files.append(f"{prefix}magnitude.vtk")
        vtkio.write_vtk_scalar(files[1], mag, name="flow_magnitude")
    log.log("vtk_written", files=files)


def _write_derived(args, log, prefix: str, flow) -> None:
    which = _parse_derived(args)
    if not which:
        return
    from tpuflow3d_torch.postproc import write_derived
    files = write_derived(prefix, flow, which)
    log.log("derived_written", fields=list(which), files=files)


def _auto_mode(args, shape, params, log, dev) -> None:
    """Choose in-core, sharded or piecewise (the reference's main() picks
    entire-data or piecewise by free GPU memory): where the in-core peak
    modelled for this run passes the device's budget, or the volume passes
    a kernel's 32-bit index limits (on the GPU), which raise in-core, the
    run is sharded over the GPUs when there are several and a rank's slab
    fits (its modelled peak within the budget, its arrays within the
    limits), else piecewise. --incore/--piecewise/--sharded/--distributed
    pin the path."""
    if args.incore or args.piecewise or args.sharded or args.distributed:
        return
    from tpuflow3d_torch.utils import memory as mem

    budget = mem.device_budget_bytes(dev)
    if budget is None:  # the CPU: in-core is host memory
        return
    need = mem.incore_peak_bytes(shape, params)
    past_limits = (dev.type == "cuda"
                   and not mem.incore_fits_index_limits(shape, params))
    if need <= budget and not past_limits:
        return
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > 1 and mem.sharded_peak_bytes(shape, params, n) <= budget \
            and mem.sharded_fits_index_limits(shape, params, n):
        args.sharded = True
        mode = f"sharded over {n} devices"
    else:
        args.piecewise = True
        mode = (f"piecewise (chunk_z={args.chunk_z})"
                if args.chunk_z is not None else "piecewise (auto chunk)")
    log.log("auto_mode", selected="sharded" if args.sharded else "piecewise",
            need_bytes=need, device_budget_bytes=budget, devices=n)

    def gib(b):
        return (f"{b / 2**30:.1f} GiB" if b >= 2**29
                else f"{b / 2**20:.1f} MiB")

    why = (f"in-core peak ~{gib(need)} exceeds device memory ~{gib(budget)}"
           if need > budget else
           f"{tuple(shape)} passes the kernels' 32-bit index limits in-core")
    print(f"{PROG}: note: {why}; selected {mode} (pin a path with "
          "--incore/--piecewise/--sharded)", file=sys.stderr)


def _distributed_setup(args, log, first_frame: str):
    """The --distributed bring-up: ``distributed.initialize`` (its device:
    the CPU with --platform cpu, else a GPU), the volume meta (float32:
    the slabs are read straight from the raw files). Returns
    (distributed module, meta, Z group)."""
    if args.timings:
        print(f"{PROG}: note: --timings is not supported with "
              "--distributed (phase timers are per-process); ignoring",
              file=sys.stderr)
    given = [args.coordinator, args.num_processes, args.process_id]
    if any(v is not None for v in given) and None in given:
        raise ValueError("--distributed: --coordinator, --num-processes and "
                         "--process-id go together (or none of them, under "
                         "torchrun)")
    from tpuflow3d_torch import distributed as tdist

    z = tdist.initialize(args.coordinator, args.num_processes,
                         args.process_id,
                         device="cpu" if args.platform == "cpu" else None)
    log.log("distributed", process=z.rank, n_processes=z.size,
            n_devices=z.size, device=str(z.device), backend=z.backend)
    if args.dims is not None:
        meta = vio.VolumeMeta(tuple(args.dims), args.dtype or "float32")
    else:
        meta = vio.read_sidecar(first_frame)
        if meta is None:
            raise ValueError(f"--distributed needs --dims or a .json "
                             f"sidecar for {first_frame}")
    if meta.dtype != "float32":
        raise ValueError("--distributed reads slabs directly from the raw "
                         "files; convert inputs to float32 first "
                         "(non-f32 widening happens in-memory otherwise)")
    return tdist, meta, z


def _run_distributed(args, params, log) -> int:
    """The multi-process entry: each process solves its Z slab and writes
    its planes of u/v/w."""
    tdist, meta, z = _distributed_setup(args, log, args.frame0)
    try:
        params = _notice_flow_clamp(params, z.size, log)
        t0 = time.perf_counter()
        flow = tdist.compute_flow_distributed(
            args.frame0, args.frame1, meta, params, z, out_prefix=args.out,
            checkpoint_dir=args.checkpoint_dir)
        if flow.device.type == "cuda":
            torch.cuda.synchronize(flow.device)
        dt = time.perf_counter() - t0
        voxels = float(np.prod(meta.shape))
        log.log("done", seconds=dt, voxels_per_s=voxels / dt,
                process=z.rank)
        log.log("written", prefix=args.out, note="u/v/w slabs per process")
    finally:
        tdist.shutdown()
    return 0


def _notice_flow_clamp(params, n, log):
    from tpuflow3d_torch.sharding import DEFAULT_FLOW_CLAMP, prepare_params
    pp = prepare_params(params, n)
    if params.flow_clamp <= 0.0 and pp.flow_clamp == DEFAULT_FLOW_CLAMP:
        log.log("notice", flow_clamp=pp.flow_clamp,
                message=f"sharded run defaulted flow_clamp to "
                        f"{pp.flow_clamp} (bounds the warp halo); raise "
                        "--flow-clamp if per-level motion exceeds it")
        print(f"{PROG}: note: sharded run caps per-level flow at "
              f"{pp.flow_clamp} voxels (warp halo bound); pass "
              "--flow-clamp to raise", file=sys.stderr)
    return pp


def _solve_pair(args, params, i0, i1, log, timer, checkpoint_dir, dev):
    """One frame pair through the selected execution path. Returns
    (flow ndarray, diagnostics dict of ndarrays)."""
    diagnostics = params.track_residuals
    if args.sharded:
        # The in-core graphs (one entry, reused by every pair of a series)
        # would hold device memory the ranks need. A streamed solve drops
        # them itself when it makes its entry.
        from tpuflow3d_torch import graphs
        graphs.clear()
    if args.piecewise:
        from tpuflow3d_torch.piecewise import compute_flow_piecewise
        if args.chunk_z is None:
            from tpuflow3d_torch.utils import memory as mem
            budget = mem.device_budget_bytes(dev)
            args.chunk_z = (mem.pick_chunk_z(i0.shape, params, budget)
                            if budget else 64)
            log.log("auto_chunk", chunk_z=args.chunk_z,
                    device_budget_bytes=budget)
        flow = compute_flow_piecewise(i0, i1, params, chunk_z=args.chunk_z,
                                      checkpoint_dir=checkpoint_dir,
                                      timer=timer, device=dev)
        return flow, {}
    if args.sharded:
        from tpuflow3d_torch.sharding import compute_flow_sharded
        devices = _sharded_devices(args, dev)
        n = len(devices)
        pp = _notice_flow_clamp(params, n, log)
        out = compute_flow_sharded(vio.pad_to_multiple(i0, n),
                                   vio.pad_to_multiple(i1, n), pp,
                                   devices=devices, diagnostics=diagnostics,
                                   checkpoint_dir=checkpoint_dir, timer=timer)
        flow, diag = out if diagnostics else (out, {})
        return (flow[:, :i0.shape[0]].numpy(),
                {k: v.numpy() for k, v in diag.items()})
    if checkpoint_dir or timer is not None:
        from tpuflow3d_torch.pipeline import compute_flow_checkpointed
        flow = compute_flow_checkpointed(i0, i1, params,
                                         checkpoint_dir=checkpoint_dir,
                                         timer=timer, device=dev)
        return flow.cpu().numpy(), {}
    from tpuflow3d_torch.pipeline import compute_flow
    out = compute_flow(i0, i1, params, device=dev, diagnostics=diagnostics)
    flow, diag = out if diagnostics else (out, {})
    return (flow.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in diag.items()})


def _log_stats(log, arrays: dict, dev, device: bool = True, **extra):
    """Volume statistics (--stats) via the ops-registry 'statistics' op,
    one JSONL event per array. device=False computes host-side in chunks
    (piecewise runs: a whole volume must never land on the device)."""
    if not device:
        for name, a in arrays.items():
            flat = np.asarray(a).reshape(-1)
            tot = ssq = 0.0
            step = 1 << 24
            for off in range(0, flat.size, step):
                c = flat[off:off + step]
                tot += float(c.sum(dtype=np.float64))
                ssq += float(np.square(c, dtype=np.float64).sum())
            log.log("statistics", volume=name, min=float(flat.min()),
                    max=float(flat.max()), mean=tot / flat.size,
                    l2=float(np.sqrt(ssq)), **extra)
        return
    from tpuflow3d_torch.ops import get_op

    fn = get_op("statistics").fn
    for name, a in arrays.items():
        s = {k: float(v) for k, v in fn(torch.as_tensor(a, device=dev))
             .items()}
        log.log("statistics", volume=name, **s, **extra)


def _log_fit(log, i0, i1, flow, dev, params=None, chunk_z=None, **extra):
    """Registration-fit diagnostic (--report-fit): |warp(i1, flow) - i0|
    against the unwarped difference. chunk_z streams it in Z-chunks
    (piecewise runs: the in-core form holds i0, i1, the flow and the
    warped volume on the device)."""
    if chunk_z:
        from tpuflow3d_torch.piecewise import registration_fit_streamed
        mean_r, max_r, before = registration_fit_streamed(
            i0, i1, flow, params, chunk_z, device=dev)
        log.log("fit", mean_residual=mean_r, max_residual=max_r,
                mean_abs_diff_unwarped=before, **extra)
        return
    from tpuflow3d_torch.warp import warp_volume

    i0a, i1a, fl = (torch.as_tensor(x, device=dev) for x in (i0, i1, flow))
    r = (warp_volume(i1a, fl) - i0a).abs()
    log.log("fit", mean_residual=float(r.mean()), max_residual=float(r.max()),
            mean_abs_diff_unwarped=float((i1a - i0a).abs().mean()), **extra)


def _pair_diagnostics(args, log, params, i0, i1, flow, dev,
                      include_frames: bool, **extra):
    """The shared --report-fit/--stats block for a solved pair; streams on
    piecewise runs so diagnostics can never run the device out of memory
    after an out-of-core solve."""
    chunk = args.chunk_z if args.piecewise else None
    if args.report_fit:
        _log_fit(log, i0, i1, flow, dev, params=params, chunk_z=chunk,
                 **extra)
    if args.stats:
        mag = np.sqrt(np.sum(np.square(flow, dtype=np.float64), axis=0))
        arrays = {"flow_magnitude": mag.astype(np.float32)}
        if include_frames:
            arrays = {"frame0": i0, "frame1": i1, **arrays}
        _log_stats(log, arrays, dev, device=not args.piecewise, **extra)


def _run_sequence_distributed(args, params, log) -> int:
    """Time-series mode over the processes: each consecutive pair runs the
    host-local-IO sharded solve, with a checkpoint directory per pair."""
    tdist, meta, z = _distributed_setup(args, log, args.frames[0])
    try:
        params = _notice_flow_clamp(params, z.size, log)
        voxels = float(np.prod(meta.shape))
        for t in range(len(args.frames) - 1):
            ck = (f"{args.checkpoint_dir.rstrip('/')}/pair{t:04d}"
                  if args.checkpoint_dir else None)
            prefix = f"{args.out}{t:04d}_"
            t0 = time.perf_counter()
            flow = tdist.compute_flow_distributed(
                args.frames[t], args.frames[t + 1], meta, params, z,
                out_prefix=prefix, checkpoint_dir=ck)
            if flow.device.type == "cuda":
                torch.cuda.synchronize(flow.device)
            dt = time.perf_counter() - t0
            log.log("pair_done", t=t, frame0=args.frames[t],
                    frame1=args.frames[t + 1], seconds=dt,
                    voxels_per_s=voxels / dt, prefix=prefix, process=z.rank)
            if z.rank == 0:
                print(f"{PROG}: pair {t} ({dt:.2f}s) -> {prefix}",
                      file=sys.stderr)
    finally:
        tdist.shutdown()
    return 0


def _run_sequence(args, params, log, dev) -> int:
    """Time-series mode: consecutive-pair flows over N frames."""
    if len(args.frames) < 2:
        raise ValueError("--frames needs at least 2 volumes")
    if args.distributed:
        if args.track:
            raise ValueError(
                "--track needs the assembled global flow; run it on the "
                "written flows afterwards (tpuflow3d_torch.postproc)")
        return _run_sequence_distributed(args, params, log)
    tracks = None
    if args.track:
        from tpuflow3d_torch import postproc
        tracks = [postproc.read_seed_csv(args.track)]
    timer = None
    if args.timings:
        from tpuflow3d_torch.utils.profiling import PhaseTimer
        timer = PhaseTimer()
    from tpuflow3d_torch.utils.profiling import device_trace

    # `with` so that a mid-sequence error still finishes the trace and
    # joins the IO threads.
    with contextlib.ExitStack() as stack:
        stack.enter_context(device_trace(args.profile_dir))
        # Frame IO overlaps the solve: frame t+2 loads (threaded C++ pread
        # and widening) while pair t computes on the device.
        pool = stack.enter_context(ThreadPoolExecutor(max_workers=1))
        writer = stack.enter_context(ThreadPoolExecutor(max_workers=1))
        wfut = None
        i0 = _load(args.frames[0], args.dims, args.dtype)
        _auto_mode(args, i0.shape, params, log, dev)
        pending = pool.submit(_load, args.frames[1], args.dims, args.dtype)
        for t, path in enumerate(args.frames[1:]):
            i1 = pending.result()
            if t + 2 < len(args.frames):
                pending = pool.submit(_load, args.frames[t + 2], args.dims,
                                      args.dtype)
            if i0.shape != i1.shape:
                raise ValueError(f"frame shapes differ at t={t}: "
                                 f"{i0.shape} vs {i1.shape} ({path})")
            ck = (f"{args.checkpoint_dir.rstrip('/')}/pair{t:04d}"
                  if args.checkpoint_dir else None)
            t0 = time.perf_counter()
            flow, diag = _solve_pair(args, params, i0, i1, log, timer, ck,
                                     dev)
            dt = time.perf_counter() - t0
            prefix = f"{args.out}{t:04d}_"
            # Writes overlap the next pair's solve (at most one pending,
            # bounding host memory to one retained flow field).
            if wfut is not None:
                wfut.result()

            def _write_outputs(prefix=prefix, flow=flow):
                vio.write_flow(prefix, flow,
                               magnitude=not args.no_magnitude)
                _write_derived(args, log, prefix, flow)
                _export_vtk(args, log, prefix, flow)

            wfut = writer.submit(_write_outputs)
            if tracks is not None:
                from tpuflow3d_torch import postproc
                tracks.append(postproc.advance_points(flow, tracks[-1]))
            log.log("pair_done", t=t, frame0=args.frames[t], frame1=path,
                    seconds=dt, voxels_per_s=float(np.prod(i0.shape)) / dt,
                    prefix=prefix)
            if params.track_residuals and "residuals" in diag:
                log.log("residuals", t=t, summary=summarize_residuals(
                    diag["residuals"]))
            _pair_diagnostics(args, log, params, i0, i1, flow, dev,
                              include_frames=False, t=t)
            print(f"{PROG}: pair {t} ({dt:.2f}s) -> {prefix}",
                  file=sys.stderr)
            i0 = i1
        if wfut is not None:
            wfut.result()  # surface writer errors before declaring success
    if tracks is not None:
        from tpuflow3d_torch import postproc
        path = f"{args.out}tracks.csv"
        postproc.write_tracks_csv(path, np.stack(tracks))
        log.log("tracks_written", path=path, points=len(tracks[0]),
                steps=len(tracks) - 1)
        print(f"{PROG}: {len(tracks[0])} tracks over "
              f"{len(tracks) - 1} steps -> {path}", file=sys.stderr)
    if timer is not None:
        log.log("timings", phases=timer.report())
    return 0


def _run(args) -> int:
    dev = _device(args)  # before any output: no GPU, no files
    log = JsonlLogger(path=args.log_json)
    params = params_from_args(args)
    log.log("start", params=params, frame0=args.frame0, frame1=args.frame1,
            frames=args.frames)
    _check_path_flags(args)

    if args.sharded:
        _sharded_devices(args, dev)  # too many --devices: exit 2 now
    if args.frames:
        return _run_sequence(args, params, log, dev)
    if args.distributed:
        return _run_distributed(args, params, log)

    i0 = _load(args.frame0, args.dims, args.dtype)
    i1 = _load(args.frame1, args.dims, args.dtype)
    if i0.shape != i1.shape:
        print(f"frame shapes differ: {i0.shape} vs {i1.shape}",
              file=sys.stderr)
        return 2
    _auto_mode(args, i0.shape, params, log, dev)

    from tpuflow3d_torch.utils.profiling import device_trace

    t0 = time.perf_counter()
    timer = None
    if args.timings:
        from tpuflow3d_torch.utils.profiling import PhaseTimer
        timer = PhaseTimer()
    with device_trace(args.profile_dir):
        flow, diag = _solve_pair(args, params, i0, i1, log, timer,
                                 args.checkpoint_dir, dev)
    dt = time.perf_counter() - t0
    if timer is not None:
        report = timer.report()
        log.log("timings", phases=report)
        for name, rec in report.items():
            print(f"{PROG}: {name}: {rec['seconds']:.3f}s", file=sys.stderr)

    voxels = float(np.prod(i0.shape))
    log.log("done", seconds=dt, voxels_per_s=voxels / dt)
    if "residuals" in diag:
        log.log("residuals", summary=summarize_residuals(diag["residuals"]))

    # Outputs first, diagnostics after: a failing diagnostic must never
    # discard the completed flow of a long run.
    vio.write_flow(args.out, flow, magnitude=not args.no_magnitude)
    log.log("written", prefix=args.out)
    _write_derived(args, log, args.out, flow)
    _export_vtk(args, log, args.out, flow)
    if args.check_consistency:
        from tpuflow3d_torch.postproc import consistency_error
        flow_bwd, _ = _solve_pair(args, params, i1, i0, log, None, None, dev)
        err = consistency_error(flow, flow_bwd, interp=params.interp,
                                device=dev)
        vio.write_raw(f"{args.out}consistency.raw", err.astype(np.float32))
        frac = float((err > 1.0).mean())
        log.log("consistency", mean=float(err.mean()), max=float(err.max()),
                frac_above_1vox=frac, path=f"{args.out}consistency.raw")
        print(f"{PROG}: fwd-bwd consistency mean {err.mean():.4f} vox, "
              f"{100 * frac:.2f}% above 1 voxel", file=sys.stderr)
    _pair_diagnostics(args, log, params, i0, i1, flow, dev,
                      include_frames=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
