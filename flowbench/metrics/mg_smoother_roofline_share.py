"""mg_smoother_roofline_share: the bytes of the multigrid smoother's
sweeps that ran (64 B a voxel a fused float32 sweep of the general
system) over the data sheet's memory rate, divided by the device time of
the K6 kernels.

The early stop decides how many V-cycles run, so the sweeps are counted
from the V-cycles: each replay of a level's ``("body", level)`` graph is
one V-cycle (``system.replay_counts``), which sweeps each grid of that
level's hierarchy mg_pre + mg_post times, the coarsest mg_pre +
mg_coarse_sweeps times. Launches are not sweeps: a grid of at most 4096
voxels runs all its sweeps in one launch."""

from flowbench import yardstick as ys
from flowbench.reference.solve import mg_shapes

# K6: the templates of csrc/sor_sweep.cuh for the general system.
K6 = r"tf3d_sweep::\w+_kernel<[\w ]+, *(true|\(bool\)1)"


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K6)
    if p["solver"] != "multigrid" or bw is None or t <= 0:
        return None
    nbytes = 0
    for key, cycles in obs.replays.items():
        if len(key) != 2 or key[0] != "body":
            continue
        grids = mg_shapes(obs.shapes[key[1]])
        per_cycle = sum(
            ys.voxels(g) * (p["mg_pre"] + (p["mg_coarse_sweeps"]
                                           if i == len(grids) - 1
                                           else p["mg_post"]))
            for i, g in enumerate(grids))
        nbytes += cycles * per_cycle * ys.SWEEP_BYTES["general"]
    if nbytes == 0:
        return None
    return 100.0 * nbytes / bw / t
