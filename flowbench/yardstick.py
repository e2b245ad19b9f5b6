"""The frozen yardstick: the card's data-sheet peaks and the bytes each
kernel's work needs, copied from the program's ``utils/roofline.py`` at the
time the benchmark was written so that later changes to the program cannot
move them. Every roofline share divides these bytes by the data sheet's
memory rate and by the kernel's device time from the trace.
"""

from __future__ import annotations

# Device memory rate (bytes/s) by torch.cuda.get_device_name(): NVIDIA's
# H100 data sheet (SXM5, PCIe and NVL parts). No bandwidth is probed.
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

# Bytes per voxel of the volume that one fused red+black SOR sweep needs,
# each argument read once and the result written once (SweepByteModel,
# flat, float32 terms): du and the result (24), psi_s (4), c (12), g (12)
# and psi_d (4) for the rank-1 system (K1); c, the symmetric inverse
# (24) in place of g and psi_d for the general one (K6).
SWEEP_BYTES = {"rank1": 56, "general": 64}
# The fused warp + derivatives (K2, K5): i1, the flow, i0 read; the three
# gradients and it written; the warped volume too where it is emitted.
WARP_BYTES = {False: 36, True: 40}
# The 3x3x3 median of the increment (K3): three components read, written.
MEDIAN_BYTES = 24


def hbm_bw(device_name: str) -> float | None:
    """The data sheet's memory rate of a card, None for one not listed (a
    share is then not reported rather than guessed)."""
    return HBM_BW.get(device_name)


def voxels(shape) -> int:
    d, h, w = shape
    return d * h * w
