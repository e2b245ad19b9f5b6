"""Roofline ("speed of light") model of the port's kernels on the card.

Port of ``tpuflow3d.utils.roofline``, with the port's own numbers: the
data sheet's rates of the card by name, the bandwidth and the fminf/fmaxf
rate measured on this card (the probes of ``csrc/probe.cu``), the bytes
and operations each kernel needs, and the end-to-end voxels/s bound of a
run. ``chip_smoke.py`` takes its bounds from here, and ``ops/registry.py``
its sweep bytes.

- A kernel's bound (``bound``) is the larger of its bytes (each input read
  once, each output written once) over the memory rate and the operations
  its function needs over their rate: the least time the card could take.
  At the data sheet's rate no kernel can beat it; at the probed rate a
  kernel that mostly reads can (a copy writes as much as it reads).
- The byte counts are those of the port's kernels, per voxel of the
  volume, which departs from the reference's where the kernels do
  (``SweepByteModel``).

Every function that needs the card takes ``device``: None is the card
(raises where there is none, never the CPU unasked); ``"cpu"`` runs the
plain versions and has placeholder rates, for tests only.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

# Device memory rate (bytes/s) and float32 rate outside the tensor cores
# (FLOP/s, an FMA counted as two), by torch.cuda.get_device_name(): NVIDIA's
# H100 data sheet (SXM, PCIe and NVL parts, dense). "cpu" is a placeholder
# for the tests, not a measurement.
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
    "cpu": 5.0e10,
}
FP32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
    "NVIDIA H100 PCIe": 51e12,
    "NVIDIA H100 NVL": 60e12,
    "cpu": 1e12,
}

# kernel (the names of kernels.LAUNCHES) -> (operations its function needs
# per element, the rate they are held to). The sweeps per updated voxel
# (six neighbours at 9, or 8 without the weight sum, plus the point solve)
# and the fused warps per voxel (coordinates, taps, stencils; one sample per
# voxel) are multiplications and additions at the float32 rate. The median
# per output value: 39 comparisons, the proven least that select the median
# of 27 values (n + min(t - 1, n - t) - 1 for the t-th of n; Blum, Floyd,
# Pratt, Rivest, Tarjan 1973), one per instruction, at the min/max rate
# (``peak_rates`` assumes one per lane and clock, half the float32 rate;
# ``minmax_rate`` measures it). Neighbouring voxels share 18 of their 27
# values, so shared work could only lower that count: bytes bound the
# median either way.
OPS = {"sor_halfsweep": (86, "fp32"), "sor_packed": (86, "fp32"),
       "sor_gc": (72, "fp32"), "sor_gc_packed": (72, "fp32"),
       "warp_grad": (40, "fp32"), "warp_grad_tricubic": (265, "fp32"),
       "median3": (39, "minmax"), "terms": (130, "fp32"),
       "terms_gc": (270, "fp32"), "mg_restrict": (92, "fp32"),
       "mg_prolong": (66, "fp32")}
# What csrc/median3.cu's selection network executes per output value: min
# and max instructions of the separable network (sorted rows, merged 3x3
# blocks shared by two rows and three planes, one merge of two planes shared
# by two output planes, an 18-instruction selection), counted in the
# kernel's machine code: 336 FMNMX a loop step, which yields 4 output
# values, and a step without outputs that starts each 64-plane chunk:
# (33 * 336 - 168) / 128 = 85.3. Not part of the bound (a cheaper selection
# computes the same function).
MEDIAN3_NETWORK_OPS = 85.3
# Float32 operations per voxel of the volume for one red-black half-sweep,
# the reference's unit: OPS's per updated voxel over two.
SWEEP_FLOPS_PER_VOXEL = {"sor_flat": 43.0, "sor": 43.0, "sor_bf16": 43.0,
                         "sor_gc": 36.0, "sor_gc_packed": 36.0}
# Bytes per voxel of the volume of one call of the fused warp +
# derivatives (K2, K5): i1, the three flow components and i0 read, the
# three gradients and it written; i1w too where it is emitted. And of the
# median (K3): the three components read and written.
WARP_BYTES_PER_VOXEL = {False: 4 + 12 + 4 + 16, True: 4 + 12 + 4 + 20}
MEDIAN3_BYTES_PER_VOXEL = 24
# The rank-1 nonlinearity update (K8): g (12), it, flow (12) and du (12)
# read, c (12), psi_s and psi_d written. Its 130 operations a voxel: psi_d
# 9, flow + du 3, psi_s 38 (three central differences of three components
# squared and summed), the six weights 18, the neighbour sums 54, c 8.
TERMS_BYTES_PER_VOXEL = 12 + 4 + 12 + 12 + 12 + 4 + 4
# The general system's update (K9, gamma > 0): gc_g (36) and gc_it (12)
# read beside K8's inputs, c (12), psi_s and ainv (24) written. Its 270
# operations a voxel: K8's 130, the residuals r_g 18, psi_g 8, the
# gradient-constancy part of c 21, d 54, sw 6, m's diagonal 3, the
# cofactors 18, the determinant and its inverse 6, ainv 6.
TERMS_GC_BYTES_PER_VOXEL = 12 + 4 + 12 + 12 + 36 + 12 + 12 + 4 + 24
# The multigrid V-cycle's grid transfers, in bytes a fine and a coarse
# voxel: K10 reads du (12), rhs (12), psi_s and d6 (24) a fine voxel and
# writes rc (12) a coarse one; K11 reads and writes du (24) a fine voxel
# and reads ec (12) a coarse one. Their operations a fine voxel (OPS): K10
# the six weights 18, sw 6, the neighbour sums 36, D du 15, the residual
# 9, the lerps ~8 (63 a coarse voxel); K11 the lerps and the add, 22 a
# component.
MG_RESTRICT_BYTES = (12 + 12 + 4 + 24, 12)
MG_PROLONG_BYTES = (24, 12)


def mg_transfer_bytes(name: str, fine, coarse) -> int:
    """The bytes a K10 ("mg_restrict") or K11 ("mg_prolong") launch on the
    grids of shapes ``fine`` and ``coarse`` needs (float32 rhs)."""
    per_fine, per_coarse = {"mg_restrict": MG_RESTRICT_BYTES,
                            "mg_prolong": MG_PROLONG_BYTES}[name]
    return (per_fine * fine[0] * fine[1] * fine[2]
            + per_coarse * coarse[0] * coarse[1] * coarse[2])


# csrc/probe.cu's min/max loop: compare-exchanges an iteration, x 2.
MINMAX_PER_ITER = 30
# The default footprint of the bandwidth probe, a side: 20x the H100's
# 50 MB L2 and more, so no pass is served from the cache.
PROBE_BYTES = 1 << 30
# A probe whose 16 copies do not take 12-20x one copy's time was not timed
# by its events.
PROBE_RATIO = (12.0, 20.0)


def card_rates(name: str) -> tuple[float, float]:
    """(bytes/s, float32 FLOP/s) of the data sheet for a device name as
    ``torch.cuda.get_device_name`` gives it ("cpu" for the CPU); raises for
    a card the tables do not hold."""
    if name not in HBM_BW:
        raise KeyError(f"no data-sheet rates for the device {name!r}; "
                       f"known: {sorted(HBM_BW)}")
    return HBM_BW[name], FP32_FLOPS[name]


def resolve_device(device=None) -> torch.device:
    """``device``, or the current GPU when it is None; raises where there
    is no GPU rather than measure the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the roofline is the card's by default, and "
                "torch.cuda.is_available() is false; pass device=\"cpu\" "
                "for the CPU's placeholder rates")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device=None) -> str:
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def device_hbm_bw(device=None) -> float:
    """Data-sheet device memory rate (bytes/s) of ``device``."""
    return card_rates(device_name(device))[0]


def peak_rates(device=None) -> dict:
    """The rates ``OPS`` are held to on ``device``: ``fp32`` the data
    sheet's float32 rate, ``minmax`` one min/max per lane and clock (half
    of it) until ``minmax_rate`` measures it."""
    fp32 = card_rates(device_name(device))[1]
    return {"fp32": fp32, "minmax": fp32 / 2}


def bound(name: str, nbytes: float, elements: float, bw: float | None = None,
          rates: dict | None = None, device=None) -> dict:
    """The least time the card could take for a call of kernel ``name``
    moving ``nbytes`` over ``elements`` (what ``OPS`` counts per): the
    bytes over ``bw`` (the data sheet's by default) or the operations over
    their rate (``peak_rates`` by default), whichever is larger."""
    if bw is None:
        bw = device_hbm_bw(device)
    if rates is None:
        rates = peak_rates(device)
    ops, kind = OPS[name]
    by_bytes = 1e3 * nbytes / bw
    by_ops = 1e3 * ops * elements / rates[kind]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_operations_ms": by_ops,
            "bytes": nbytes}


def expected_hw_fraction(bytes_per_voxel: float, flops_per_voxel: float,
                         bw: float | None = None,
                         flops_rate: float | None = None,
                         device=None) -> float:
    """The fraction of the bytes roof a kernel can reach: 1.0 where bytes
    bind, t_bytes/t_ops where operations do (the reference's arithmetic, at
    this card's data-sheet rates by default)."""
    if bw is None:
        bw = device_hbm_bw(device)
    if flops_rate is None:
        flops_rate = peak_rates(device)["fp32"]
    t_bytes = bytes_per_voxel / bw
    t_ops = flops_per_voxel / flops_rate
    if t_ops <= 0.0:
        return 1.0
    return min(1.0, t_bytes / t_ops)


def warp_flops_per_voxel(clamp: float, interp: str = "trilinear") -> float:
    """Float32 operations per voxel of the fused warp + derivatives: 40
    trilinear, 265 tricubic (64 taps), whatever the clamp. The port's K2/K5
    gather their taps directly; the reference's 3 k^3 terms of a
    (2 ceil(clamp) + 2)^3 select window are the TPU's workaround for a
    gather and do not apply here."""
    del clamp
    return float(OPS["warp_grad_tricubic" if interp == "tricubic"
                     else "warp_grad"][0])


@dataclass(frozen=True)
class SweepByteModel:
    """Bytes per voxel of the volume that the port's sweep kernels move,
    each argument read once and the result written once (the sweep
    constants c, g at ``terms_bytes`` a value; du, psi_s, psi_d, ainv in
    float32).

    Flat (K1; ``gc`` K6, the general SPD system of gamma > 0 and
    multigrid): ``per_sweep`` is one fused red+black launch, which reads
    du, c, g (K6: ainv), psi_s and psi_d once and writes du: 56 B (bf16
    terms 44; K6 64, 58). ``per_half_sweep`` is one colour alone, as the
    streamed and sharded paths launch it: du and the result whole, psi_s
    whole (both colours' weights), the rest for the active colour: 42 B
    (36; K6 46, 43). The reference's flat model is 56 B a *half*-sweep and
    112 a sweep, because its Pallas kernel reads everything on each colour;
    the port's fused sweep reads it once.

    Packed (K4; ``gc`` K7), per launch of one colour on the arrays packed
    by colour: the active du, c, g (K7: ainv), psi_s, psi_d, the other
    colour's du and psi_s, and the result: 36 B (30; K7 40, 37), the
    reference's 36 and 30 for K4; ``per_sweep`` is two launches.

    Neither counts the halo planes a slab that is not the whole volume
    reads beyond its Z faces (``halo_plane_bytes``)."""
    packed: bool = False
    terms_bytes: int = 4
    gc: bool = False

    @property
    def per_half_sweep(self) -> float:
        tb = self.terms_bytes
        if self.packed:
            # du active, other colour, written (6 + 6 + 6); psi_s both (2 +
            # 2); c (1.5 tb); g (1.5 tb) and psi_d (2), or ainv (12).
            return 6 + 6 + 6 + 2 + 2 + 1.5 * tb + (12 if self.gc
                                                   else 1.5 * tb + 2)
        # du and the result (24), psi_s (4), half of c (3 tb) and g (3 tb)
        # and psi_d (4), or of c and ainv (24).
        return 24 + 4 + 0.5 * (3 * tb + (24 if self.gc else 3 * tb + 4))

    @property
    def per_sweep(self) -> float:
        if self.packed:
            return 2 * self.per_half_sweep
        tb = self.terms_bytes
        return 24 + 4 + 3 * tb + (24 if self.gc else 3 * tb + 4)

    def halo_plane_bytes(self, depth: int) -> float:
        """Bytes per voxel of a ``depth``-plane slab of the copied halo
        planes a single-colour launch reads beyond its Z faces: du's three
        components and psi_s, one plane each side (packed: the other
        colour's half of them)."""
        per_plane_voxel = 2 * (12 + 4) * (0.5 if self.packed else 1.0)
        return per_plane_voxel / depth


def sweep_byte_model(params) -> SweepByteModel:
    """The byte model of the sweep kernel ``params`` make the port run on
    one device: the layout, the storage of c and g, and gamma > 0 (K6 or
    K7 for the general system)."""
    tb = 2 if getattr(params, "terms_dtype", "float32") == "bfloat16" else 4
    return SweepByteModel(packed=params.sweep_layout == "packed",
                          terms_bytes=tb, gc=params.gamma > 0)


def sweep_roofline_voxels_per_s(bw: float | None = None,
                                model: SweepByteModel = SweepByteModel(),
                                device=None) -> float:
    """Upper bound on voxel updates/s of full sweeps of ``model``."""
    if bw is None:
        bw = device_hbm_bw(device)
    return bw / model.per_sweep


def pipeline_sweep_equivalents(levels_shapes, params) -> float:
    """Fine-voxel sweep equivalents of a full run: the sum over levels of
    voxels(level) x warps x inner iterations x sweeps, in units of the
    finest level's voxels (the reference's arithmetic)."""
    fine = 1.0 * levels_shapes[0][0] * levels_shapes[0][1] * levels_shapes[0][2]
    total = 0.0
    for (d, h, w) in levels_shapes:
        total += (d * h * w) / fine
    return total * params.warps * params.inner_iterations * params.sweeps


def end_to_end_roofline(levels_shapes, params, bw: float | None = None,
                        device=None) -> float:
    """Upper bound on the end-to-end voxels/s of a coarse-to-fine run: the
    sweep roofline of the kernel ``params`` make the port run, over the
    run's sweep equivalents (warps, medians and the pyramid left out, so
    it is a true upper bound). Defined for SOR only: multigrid does not run
    ``params.sweeps`` sweeps a level, and Jacobi runs no sweep kernel."""
    if params.solver != "sor":
        why = ("multigrid runs V-cycles, not params.sweeps SOR sweeps a "
               "level" if params.solver == "multigrid" else
               "Jacobi iterations run plain PyTorch, not a sweep kernel")
        raise ValueError(f"no end-to-end roofline for solver="
                         f"{params.solver!r}: {why}")
    per_sweep = sweep_roofline_voxels_per_s(bw, sweep_byte_model(params),
                                            device)
    return per_sweep / pipeline_sweep_equivalents(levels_shapes, params)


# ---------------------------------------------------------------------------
# The probes (csrc/probe.cu) and their plain versions.


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no probe kernel for {t.device}")
    return False


def copy_probe(dst: torch.Tensor, src: torch.Tensor, reps: int = 1) -> None:
    """dst <- src, ``reps`` times: the probe's copy kernel for CUDA tensors
    (float32, contiguous, a multiple of 4 elements), ``Tensor.copy_`` for
    CPU tensors."""
    if _is_cpu(src):
        for _ in range(reps):
            dst.copy_(src)
        return
    from tpuflow3d_torch import kernels
    if (dst.dtype != torch.float32 or src.dtype != torch.float32
            or dst.numel() != src.numel() or src.numel() % 4
            or not (dst.is_contiguous() and src.is_contiguous())
            or dst.device != src.device):
        raise ValueError("copy_probe: dst and src must be contiguous float32 "
                         "tensors of one device and size, a multiple of 4")
    with kernels.on_device(src.device):
        err = kernels.load_library().tf3d_copy_probe(
            dst.data_ptr(), src.data_ptr(), src.numel() // 4, reps,
            kernels.stream_handle(src.device))
    if err:
        raise RuntimeError(f"copy_probe: CUDA launch failed with error {err}")


def minmax_probe_plain(blocks: int, iters: int) -> torch.Tensor:
    """What ``tf3d_minmax_probe`` writes, on the CPU: each of 256 threads'
    16 values through ``iters`` iterations of the network, summed in
    order, for each block."""
    t = torch.arange(256, dtype=torch.int32)[:, None] * 16 + torch.arange(16)
    v = t.to(torch.float32) * torch.tensor(1e-3, dtype=torch.float32)
    for _ in range(iters):
        a, b = v[:, 0::2], v[:, 1::2]
        v = torch.stack((torch.minimum(a, b), torch.maximum(a, b)),
                        -1).reshape(256, 16)
        a, b = v[:, 1:15:2], v[:, 2:16:2]
        mid = torch.stack((torch.minimum(a, b), torch.maximum(a, b)),
                          -1).reshape(256, 14)
        v = torch.cat((v[:, :1], mid, v[:, 15:]), 1)
    s = torch.zeros(256, dtype=torch.float32)
    for k in range(16):
        s = s + v[:, k]
    return s.repeat(blocks)


def minmax_probe(out: torch.Tensor, iters: int) -> torch.Tensor:
    """The min/max loop into ``out`` (blocks x 256 float32 values): the
    kernel for a CUDA tensor, ``minmax_probe_plain`` for a CPU one."""
    if (out.numel() % 256 or out.dtype != torch.float32
            or not out.is_contiguous()):
        raise ValueError("minmax_probe: out must be contiguous float32, "
                         "blocks x 256")
    blocks = out.numel() // 256
    if _is_cpu(out):
        out.copy_(minmax_probe_plain(blocks, iters))
        return out
    from tpuflow3d_torch import kernels
    with kernels.on_device(out.device):
        err = kernels.load_library().tf3d_minmax_probe(
            out.data_ptr(), blocks, iters, kernels.stream_handle(out.device))
    if err:
        raise RuntimeError(f"minmax_probe: CUDA launch failed with error "
                           f"{err}")
    return out


def median_ms(fn, device, reps: int = 10, warmup: int = 2) -> float:
    """Median time of fn() in ms after ``warmup`` runs: one CUDA-event pair
    a run on a GPU, the host clock on the CPU (where the work is
    synchronous)."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            fn()
            end.record(torch.cuda.current_stream(dev))
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


class Probe(NamedTuple):
    """One bandwidth probe: the copy's rate (bytes read and written per
    second, from 16 copies), t16/t1, the median times of one and of 16
    copies, and ``Tensor.copy_``'s rate on the same tensors."""
    bytes_per_s: float
    ratio: float
    t1_ms: float
    t16_ms: float
    copy_bytes_per_s: float
    nbytes: int
    device: str


_PROBE_CACHE: dict = {}


def probe_timing_model(nbytes: int = PROBE_BYTES, device=None) -> Probe:
    """Time one and 16 copies of ``nbytes`` (a side) on ``device``, 2 warm
    ups and the median of 10 each: the probe's copy kernel on a GPU,
    ``Tensor.copy_`` (the plain version) on the CPU. Cached per (device,
    nbytes). Nothing is checked here (``check_probe``): a small footprint
    may be served from the L2 and pass the data sheet."""
    dev = resolve_device(device)
    key = (str(dev), int(nbytes))
    if key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    if nbytes % 16:
        raise ValueError(f"probe footprint {nbytes} B: not a multiple of 16")
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
    dst = torch.zeros_like(src)
    t1 = median_ms(lambda: copy_probe(dst, src, 1), dev)
    t16 = median_ms(lambda: copy_probe(dst, src, 16), dev)
    if not torch.equal(dst, src):
        raise RuntimeError("probe: the copy differs from its source")
    t_copy = median_ms(lambda: dst.copy_(src), dev)
    del src, dst
    probe = Probe(bytes_per_s=16 * 2.0 * nbytes / (1e-3 * t16),
                  ratio=t16 / t1, t1_ms=t1, t16_ms=t16,
                  copy_bytes_per_s=2.0 * nbytes / (1e-3 * t_copy),
                  nbytes=int(nbytes), device=device_name(dev))
    _PROBE_CACHE[key] = probe
    return probe


def check_probe(probe: Probe) -> str | None:
    """Why a GPU probe cannot be the card's bandwidth, or None: 16 copies
    not 12-20x one copy's time, or a rate past the data sheet's (either
    means the events did not time the work, or the cache served it)."""
    lo, hi = PROBE_RATIO
    if not lo <= probe.ratio <= hi:
        return f"t16/t1 = {probe.ratio:.2f}, outside [{lo:g}, {hi:g}]"
    sheet = card_rates(probe.device)[0]
    if probe.bytes_per_s > sheet:
        return (f"{probe.bytes_per_s:.4g} B/s, past the data sheet's "
                f"{sheet:.4g}")
    return None


def measure_hbm_bw(nbytes: int = PROBE_BYTES, device=None) -> float:
    """The sustained streaming rate of this device (bytes read and written
    per second): ``probe_timing_model``'s copy rate. On a GPU it raises
    where ``check_probe`` finds the probe wrong; on the CPU it is the rate
    of ``Tensor.copy_`` on the host clock, unchecked."""
    dev = resolve_device(device)
    probe = probe_timing_model(nbytes, dev)
    if dev.type == "cuda":
        fault = check_probe(probe)
        if fault:
            raise RuntimeError(f"bandwidth probe of {probe.device} at "
                               f"{nbytes} B: {fault}")
    return probe.bytes_per_s


def minmax_rate(device=None) -> float:
    """fminf/fmaxf per second on ``device``: the min/max loop on 8 blocks
    of 256 threads per SM, 4096 iterations, timed with CUDA events (median
    of 10); on the CPU the plain network on one block at 64 iterations, on
    the host clock."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        blocks = 8 * torch.cuda.get_device_properties(
            dev).multi_processor_count
        iters = 4096
    else:
        blocks, iters = 1, 64
    out = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    ms = median_ms(lambda: minmax_probe(out, iters), dev)
    return blocks * 256 * iters * MINMAX_PER_ITER / (1e-3 * ms)
