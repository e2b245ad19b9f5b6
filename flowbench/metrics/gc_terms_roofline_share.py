"""gc_terms_roofline_share: the bytes the nonlinearity updates of the
general system need (128 B a voxel a call: g, it, flow, du, gc_g and
gc_it read, c, psi_s and ainv written) over the data sheet's memory rate,
divided by the device time of the K9 kernel (``tf3d_terms::gc_kernel`` of
``csrc/terms.cu``). The work counted is warps x inner iterations calls on
every level of the profiled pairs. Only the in-core SOR solve with gamma >
0 runs K9; elsewhere, and where K9 left no kernel time (a program without
it), the share is not reported."""

from flowbench import yardstick as ys

K9 = r"tf3d_terms::gc_kernel"
# g (12), it (4), flow (12), du (12), gc_g (36), gc_it (12) read; c (12),
# psi_s (4), ainv (24) written.
GC_TERMS_BYTES = 128


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K9)
    if obs.mode != "incore" or p.get("gamma", 0.0) <= 0 \
            or p["solver"] != "sor" or bw is None or t <= 0:
        return None
    calls = p["warps"] * p["inner_iterations"]
    nbytes = (obs.pairs * calls * GC_TERMS_BYTES
              * sum(ys.voxels(s) for s in obs.shapes))
    return 100.0 * nbytes / bw / t
