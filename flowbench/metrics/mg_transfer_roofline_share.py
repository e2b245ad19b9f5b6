"""mg_transfer_roofline_share: the bytes of the multigrid V-cycle's grid
transfers that ran over the data sheet's memory rate, divided by the
device time of the ``tf3d_mg::`` kernels (K10, the residual and its
restriction; K11, the prolongation and the correction). Per transfer from
a grid of F voxels to one of C: K10 reads du, rhs, psi_s and d6 (52 B a
fine voxel) and writes the coarse residual (12 B a coarse voxel); K11
reads and writes du (24 B a fine voxel) and reads the correction (12 B a
coarse voxel).

The early stop decides how many V-cycles run, so the transfers are counted
from the V-cycles: each replay of a level's ``("body", level)`` graph is
one V-cycle (``system.replay_counts``), which restricts and prolongs once
between each pair of neighbouring grids of that level's hierarchy. A
program without these kernels, or a run outside multigrid, shows no such
time: the share is then not reported."""

from flowbench import yardstick as ys
from flowbench.reference.solve import mg_shapes

# K10 and K11: the kernels of csrc/mg_transfer.cu.
KERNELS = r"tf3d_mg::"
# Bytes a fine voxel and a coarse voxel, of K10 and K11 together.
FINE_BYTES = 52 + 24
COARSE_BYTES = 12 + 12


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(KERNELS)
    if p["solver"] != "multigrid" or bw is None or t <= 0:
        return None
    nbytes = 0
    for key, cycles in obs.replays.items():
        if len(key) != 2 or key[0] != "body":
            continue
        grids = mg_shapes(obs.shapes[key[1]])
        per_cycle = sum(FINE_BYTES * ys.voxels(f) + COARSE_BYTES * ys.voxels(c)
                        for f, c in zip(grids, grids[1:]))
        nbytes += cycles * per_cycle
    if nbytes == 0:
        return None
    return 100.0 * nbytes / bw / t
