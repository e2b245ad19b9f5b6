"""gc_sor_roofline_share: the bytes the SOR sweeps the parameters
prescribe need with gradient constancy (64 B a voxel a fused float32
sweep of the general system, ``yardstick.SWEEP_BYTES["general"]``) over
the data sheet's memory rate, divided by the device time of the K6
kernels. The work counted is warps x inner iterations x sweeps on every
level of the profiled pairs. Only the SOR solve with gamma > 0 sweeps the
general system with K6 as its whole solver (multigrid runs K6 as its
smoother, ``mg_smoother_roofline_share``); elsewhere, and where K6 left
no kernel time, the share is not reported."""

from flowbench import yardstick as ys

# K6: the templates of csrc/sor_sweep.cuh for the general system (second
# template argument true), as mg_smoother_roofline_share finds them.
K6 = r"tf3d_sweep::\w+_kernel<[\w ]+, *(true|\(bool\)1)"


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K6)
    if p["solver"] != "sor" or p.get("gamma", 0.0) <= 0 or bw is None \
            or t <= 0:
        return None
    sweeps = p["warps"] * p["inner_iterations"] * p["sweeps"]
    nbytes = (obs.pairs * sweeps * ys.SWEEP_BYTES["general"]
              * sum(ys.voxels(s) for s in obs.shapes))
    return 100.0 * nbytes / bw / t
