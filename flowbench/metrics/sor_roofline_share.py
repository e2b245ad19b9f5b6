"""sor_roofline_share: the bytes the SOR sweeps the parameters prescribe
need (56 B a voxel a fused float32 sweep, rank-1 system) over the data
sheet's memory rate, divided by the device time of the K1 kernels. The
work counted is warps x inner iterations x sweeps on every level of the
profiled pairs, whatever kernels ran it (a streamed slab's margins are not
work)."""

from flowbench import yardstick as ys

# K1: the templates of csrc/sor_sweep.cuh for the rank-1 system (second
# template argument false).
K1 = r"tf3d_sweep::\w+_kernel<[\w ]+, *(false|\(bool\)0)"


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K1)
    if p["solver"] != "sor" or p.get("gamma", 0.0) > 0 or bw is None \
            or t <= 0:
        return None
    sweeps = p["warps"] * p["inner_iterations"] * p["sweeps"]
    nbytes = (obs.pairs * sweeps * ys.SWEEP_BYTES["rank1"]
              * sum(ys.voxels(s) for s in obs.shapes))
    return 100.0 * nbytes / bw / t
