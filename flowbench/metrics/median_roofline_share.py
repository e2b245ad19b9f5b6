"""median_roofline_share: the bytes of the median calls the parameters
prescribe (24 B a voxel: the increment's three components read and
written), one a warp iteration on every level of the profiled pairs, over
the data sheet's memory rate, divided by the device time of K3."""

from flowbench import yardstick as ys

K3 = r"median3_kernel\("


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K3)
    if not p.get("median", True) or bw is None or t <= 0:
        return None
    nbytes = (obs.pairs * p["warps"] * ys.MEDIAN_BYTES
              * sum(ys.voxels(s) for s in obs.shapes))
    return 100.0 * nbytes / bw / t
