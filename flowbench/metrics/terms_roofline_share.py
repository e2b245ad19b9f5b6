"""terms_roofline_share: the bytes the nonlinearity updates need (60 B a
voxel a call of the rank-1 update: g, it, flow and du read, c, psi_s and
psi_d written) over the data sheet's memory rate, divided by the device
time of the K8 kernel (``csrc/terms.cu``). The work counted is warps x
inner iterations calls on every level of the profiled pairs. Only the
in-core solve of the rank-1 system with SOR or multigrid runs K8; the
streamed mode, gamma > 0 and Jacobi run the plain update, and a program
without K8 shows no kernel time: the share is then not reported."""

from flowbench import yardstick as ys

# K8: the kernels of csrc/terms.cu.
K8 = r"tf3d_terms::"
# g (12), it (4), flow (12) and du (12) read; c (12), psi_s and psi_d
# written.
TERMS_BYTES = 60


def read(obs):
    if obs is None:
        return None
    p = obs.params
    bw, t = ys.hbm_bw(obs.card), obs.seconds(K8)
    if obs.mode != "incore" or p.get("gamma", 0.0) > 0 \
            or p["solver"] not in ("sor", "multigrid") or bw is None \
            or t <= 0:
        return None
    calls = p["warps"] * p["inner_iterations"]
    nbytes = (obs.pairs * calls * TERMS_BYTES
              * sum(ys.voxels(s) for s in obs.shapes))
    return 100.0 * nbytes / bw / t
