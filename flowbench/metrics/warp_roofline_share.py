"""warp_roofline_share: the bytes of the warp calls the parameters
prescribe (36 B a voxel, 40 where the warped volume is emitted: gamma >
0), one a warp iteration on every level of the profiled pairs, over the
data sheet's memory rate, divided by the device time of K2/K5."""

from flowbench import yardstick as ys

K2_K5 = r"warp_grad_kernel<"


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K2_K5)
    if bw is None or t <= 0 or p.get("deriv_order", 2) != 2:
        return None
    nbytes = (obs.pairs * p["warps"]
              * ys.WARP_BYTES[p.get("gamma", 0.0) > 0]
              * sum(ys.voxels(s) for s in obs.shapes))
    return 100.0 * nbytes / bw / t
