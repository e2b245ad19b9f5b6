"""plain_ops_share: device time of the kernels that are not built from the
program's ``csrc`` (PyTorch's own: compute_terms, the multigrid levels'
arithmetic, the pyramid), over all device time; copies and memsets count
in the whole only."""

# The program's kernels as the profiler names them: K1/K6 (the templates
# of csrc/sor_sweep.cuh), K2/K5, K3, K4, K7.
CSRC = (r"tf3d_sweep::|warp_grad_kernel<|median3_kernel\(|"
        r"sor_halfsweep_packed_kernel|sor_halfsweep_gc_packed_kernel")


def read(obs):
    if obs is None:
        return None
    total = obs.seconds(None, kinds=("kernel", "memcpy", "memset"))
    if total <= 0:
        return None
    return 100.0 * (obs.seconds(None) - obs.seconds(CSRC)) / total
