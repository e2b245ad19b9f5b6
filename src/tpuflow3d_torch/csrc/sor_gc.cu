// K6: red-black SOR sweeps of the linearized Euler-Lagrange system with a
// general SPD 3x3 point matrix (c, ainv, psi_s), for Hopper (sm_90a). It is
// the sweep of the gradient-constancy mode (gamma > 0) and the smoother of
// every multigrid level.
//
// Replaces the TPU kernel src/tpuflow3d/pallas/sor_gc.py:
// sor_halfsweep_gc_pallas. Plain version: tpuflow3d_torch.solver.
// sor_halfsweep on SolveTerms with ainv set, red then black.
//
// One deliberate difference from the TPU kernel: it takes a half-alpha per
// axis (z, y, x) instead of one alpha. The TPU kernel's single alpha limits
// it to multigrid levels whose axis scales are uniform (the JAX package
// sweeps the others in XLA); with three, this kernel serves every level, and
// the fine gamma sweep passes (alpha, alpha, alpha)/2.
//
// The function, the design and the kernels are in sor_sweep.cuh, shared with
// K1 (sor.cu): quads of four x (16-byte loads where W % 4 == 0; the coarse
// multigrid grids of odd W go lane by lane), one colour per launch with Z
// halo planes, red and black fused in one launch on a whole volume, and, for
// a grid of at most 4096 voxels (the coarse multigrid levels, the 16^3
// level of a 256^3 pyramid), all n sweeps of a call in one launch of one
// block with the iterate in shared memory.
//
// What bounds it on the card: device-memory bytes. One pass over a full
// sweep's arguments is du 12 + c 12 + ainv 24 + psi_s 4 + out 12 = 64 B/voxel
// (58 with c stored in bfloat16; ainv stays float32): 0.32 ms at 256^3 and
// 3.35 TB/s. The small multigrid levels are bound by the launch, not by
// bytes.

#include "sor_sweep.cuh"

// c points to bfloat16 when terms_bf16 is non-zero, else to float32. The
// other arguments as tf3d_sweep::launch has them; h = alpha_axis/2. Full
// sweeps of a grid of at most 4096 voxels run in the one-block kernel.
extern "C" int tf3d_sor_gc_sweeps(
    const float* du, const void* c, const void* g_unused, const float* psi_s,
    const float* ainv, const float* du_lo, const float* du_hi,
    const float* ps_lo, const float* ps_hi, float* buf0, float* buf1,
    const int* z0_dev, int D, int H, int W, int z0, int dg, float hz,
    float hy, float hx, float omega, float one_minus_omega, int colours,
    int nsweeps, int terms_bf16, int* launched, void* stream) {
  return tf3d_sweep::launch<true>(
      du, c, g_unused, psi_s, ainv, du_lo, du_hi, ps_lo, ps_hi, buf0,
      buf1, z0_dev, D, H, W, z0, dg, hz, hy, hx, omega, one_minus_omega,
      colours, nsweeps, terms_bf16, launched, stream);
}
