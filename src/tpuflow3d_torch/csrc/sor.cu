// K1: red-black SOR sweeps of the linearized Euler-Lagrange system, rank-1
// point system (compact terms c, g, psi_s, psi_d), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/sor.py:sor_halfsweep_pallas.
// Plain version: tpuflow3d_torch.solver.sor_halfsweep, red then black.
//
// The function, the design and the kernels are in sor_sweep.cuh, shared with
// K6 (sor_gc.cu): 16 bytes a thread (a quad of four x), one colour per
// launch with Z halo planes (a half-sweep, for a Z-sharded caller), or red
// and black fused in one launch when the slab is the whole volume, the red
// values handed to the black update through shared memory.
//
// What bounds it on the card: device-memory bytes. One pass over a full
// sweep's arguments is du 12 + c 12 + g 12 + psi_s 4 + psi_d 4 + out 12 = 56
// B/voxel (44 with c and g stored in bfloat16): 0.28 ms at 256^3 and 3.35
// TB/s, which the fused sweep is held to; a single colour launched alone
// moves the same bytes for half the updates.

#include "sor_sweep.cuh"

// c and g point to bfloat16 when terms_bf16 is non-zero, else to float32.
// The other arguments as tf3d_sweep::launch has them; h = alpha/2.
extern "C" int tf3d_sor_sweeps(
    const float* du, const void* c, const void* g, const float* psi_s,
    const float* psi_d, const float* du_lo, const float* du_hi,
    const float* ps_lo, const float* ps_hi, float* buf0, float* buf1, int D,
    int H, int W, int z0, int dg, float hz, float hy, float hx, float omega,
    float one_minus_omega, int colours, int nsweeps, int terms_bf16,
    int* launched, void* stream) {
  return tf3d_sweep::launch<false>(
      du, c, g, psi_s, psi_d, du_lo, du_hi, ps_lo, ps_hi, buf0, buf1, D, H, W,
      z0, dg, hz, hy, hx, omega, one_minus_omega, colours, nsweeps,
      terms_bf16, launched, stream);
}
