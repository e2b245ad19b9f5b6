// K6: one red-black SOR half-sweep of the linearized Euler-Lagrange system
// with a general SPD 3x3 point matrix, for Hopper (sm_90a). It is the sweep
// of the gradient-constancy mode (gamma > 0) and the smoother of every
// multigrid level.
//
// Replaces the TPU kernel src/tpuflow3d/pallas/sor_gc.py:
// sor_halfsweep_gc_pallas. Plain version: tpuflow3d_torch.solver.
// sor_halfsweep on SolveTerms with ainv set.
//
// For each voxel p of the active colour (global parity (z0+z+y+x)&1 ==
// color) and each neighbour q in the order z+, z-, y+, y-, x+, x-:
//   w_pq = h_axis*(psi_s[p]+psi_s[q])   (h_axis = alpha_axis/2; a neighbour
//                                         across a global face has zero
//                                         weight and is skipped)
//   b    = c + sum_q w_pq du_q
// then x = A^-1 b with the precomputed symmetric inverse, rows (00, 01, 02,
// 11, 12, 22), and out = (1-omega) du + omega x; voxels of the other colour
// are copied. Z neighbours across the local slab come from the halo planes
// (du_lo/du_hi, ps_lo/ps_hi); z0 is the global z of plane 0.
//
// One deliberate difference from the TPU kernel: it takes a half-alpha per
// axis (z, y, x) instead of one alpha. The TPU kernel's single alpha limits
// it to multigrid levels whose axis scales are uniform (the JAX package
// sweeps the others in XLA); with three, this kernel serves every level, and
// the fine gamma sweep passes (alpha, alpha, alpha)/2.
//
// What bounds it on the card: device-memory bytes. A half-sweep reads du, c
// (3 floats each), ainv (6) and psi_s and writes du: 64 B/voxel against
// ~50 flops/voxel for the active half. The design is K1's (csrc/sor.cu):
// one thread per x-pair (one active and one copied voxel), neighbouring
// threads on neighbouring addresses, neighbour reads of du and psi_s served
// from L1/L2, out-of-place. Any D, H, W >= 1, odd W included (the coarse
// multigrid grids are 4^3 to 8^3 with odd H and W). c may be stored in
// bfloat16 (T; 58 B/voxel): it is widened as it is loaded; ainv stays
// float32.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) sor_halfsweep_gc_kernel(
    const float* __restrict__ du, const T* __restrict__ c,
    const float* __restrict__ ainv, const float* __restrict__ ps,
    const float* __restrict__ du_lo, const float* __restrict__ du_hi,
    const float* __restrict__ ps_lo, const float* __restrict__ ps_hi,
    float* __restrict__ out, int D, int H, int W, int z0, int dg, float hz,
    float hy, float hx, float omega, float one_minus_omega, int color) {
  const int W2 = (W + 1) >> 1;
  const long long npairs = (long long)D * H * W2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= npairs) return;
  const int xp = (int)(idx % W2);
  const long long zy = idx / W2;
  const int y = (int)(zy % H);
  const int z = (int)(zy / H);
  const int zg = z0 + z;
  const int shift = (zg + y + color) & 1;  // x parity of the active voxel
  const int xa = 2 * xp + shift;
  const int xo = 2 * xp + 1 - shift;
  const long long HW = (long long)H * W;
  const long long N = (long long)D * HW;
  const long long row = (long long)z * HW + (long long)y * W;

  if (xo < W) {
    const long long q = row + xo;
    out[q] = du[q];
    out[N + q] = du[N + q];
    out[2 * N + q] = du[2 * N + q];
  }
  if (xa >= W) return;

  const long long p = row + xa;
  const long long hp = (long long)y * W + xa;  // index within a halo plane
  const float psp = ps[p];
  float b0 = load_term(c, p), b1 = load_term(c, N + p);
  float b2 = load_term(c, 2 * N + p);
  auto add = [&](float h, float psq, float d0, float d1, float d2) {
    const float w = h * (psp + psq);
    b0 += w * d0;
    b1 += w * d1;
    b2 += w * d2;
  };
  auto add_at = [&](float h, long long q) {
    add(h, ps[q], du[q], du[N + q], du[2 * N + q]);
  };
  if (zg < dg - 1) {
    if (z + 1 < D) add_at(hz, p + HW);
    else add(hz, ps_hi[hp], du_hi[hp], du_hi[HW + hp], du_hi[2 * HW + hp]);
  }
  if (zg > 0) {
    if (z > 0) add_at(hz, p - HW);
    else add(hz, ps_lo[hp], du_lo[hp], du_lo[HW + hp], du_lo[2 * HW + hp]);
  }
  if (y < H - 1) add_at(hy, p + W);
  if (y > 0) add_at(hy, p - W);
  if (xa < W - 1) add_at(hx, p + 1);
  if (xa > 0) add_at(hx, p - 1);

  const float a00 = ainv[p], a01 = ainv[N + p], a02 = ainv[2 * N + p];
  const float a11 = ainv[3 * N + p], a12 = ainv[4 * N + p];
  const float a22 = ainv[5 * N + p];
  const float x0 = a00 * b0 + a01 * b1 + a02 * b2;
  const float x1 = a01 * b0 + a11 * b1 + a12 * b2;
  const float x2 = a02 * b0 + a12 * b1 + a22 * b2;
  out[p] = one_minus_omega * du[p] + omega * x0;
  out[N + p] = one_minus_omega * du[N + p] + omega * x1;
  out[2 * N + p] = one_minus_omega * du[2 * N + p] + omega * x2;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). c
// points to bfloat16 when terms_bf16 is non-zero, else to float32.
extern "C" int tf3d_sor_halfsweep_gc(
    const float* du, const void* c, const float* ainv, const float* psi_s,
    const float* du_lo, const float* du_hi, const float* ps_lo,
    const float* ps_hi, float* out, int D, int H, int W, int z0, int dg,
    float hz, float hy, float hx, float omega, float one_minus_omega,
    int color, int terms_bf16, void* stream) {
  const long long npairs = (long long)D * H * ((W + 1) / 2);
  if (npairs == 0) return 0;
  const unsigned blocks = (unsigned)((npairs + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (terms_bf16) {
    sor_halfsweep_gc_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        du, (const __nv_bfloat16*)c, ainv, psi_s, du_lo, du_hi, ps_lo, ps_hi,
        out, D, H, W, z0, dg, hz, hy, hx, omega, one_minus_omega, color);
  } else {
    sor_halfsweep_gc_kernel<float><<<blocks, kThreads, 0, s>>>(
        du, (const float*)c, ainv, psi_s, du_lo, du_hi, ps_lo, ps_hi, out, D,
        H, W, z0, dg, hz, hy, hx, omega, one_minus_omega, color);
  }
  return (int)cudaGetLastError();
}
