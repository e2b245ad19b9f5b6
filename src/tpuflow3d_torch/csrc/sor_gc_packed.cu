// K7: one red-black SOR half-sweep on colour-packed arrays with a general
// SPD 3x3 point matrix (the gradient-constancy mode, gamma > 0), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/sor_gc_packed.py:
// sor_halfsweep_gc_packed. Plain version: tpuflow3d_torch.kernels.
// sor_gc_packed.sor_halfsweep_gc_packed_plain.
//
// The layout and the neighbour indexing are K4's (csrc/sor_packed.cu): the
// element at packed index i of row (z, y) of colour c is the voxel
// x = 2i+off, off = (z0+z+y+c)&1; its z and y neighbours are the other
// colour's elements at the same index, x+1 is the other colour's index
// i+off and x-1 its index i+off-1. The arithmetic is K6's (csrc/sor_gc.cu)
// in the same order: for each neighbour q in the order z+, z-, y+, y-, x+,
// x-
//   w_pq = alpha*(psi_s[p]+psi_s[q])/2   (a neighbour across a global face
//                                         has zero weight and is skipped)
//   b    = c + sum_q w_pq du_q
// then x = A^-1 b with the precomputed symmetric inverse, rows (00, 01, 02,
// 11, 12, 22), and out = (1-omega) du + omega x for every element. One alpha,
// as the TPU kernel: the packed layout serves the fine SOR sweep only; the
// multigrid levels, with their per-axis alphas, sweep flat through K6.
//
// What bounds it on the card: device-memory bytes. Per voxel of the full
// volume a half-sweep reads the active colour's du and c (12 B), ainv
// (12 B) and psi_s (2 B), the other colour's du and psi_s (8 B), and writes
// the active du (6 B): 40 B/voxel against the flat K6's 64 (37 with bfloat16
// c). Design as K4: one thread per packed element, dense coalesced loads and
// store of its own colour, the other colour through L1/L2, no shared memory,
// Z halos as the other colour's planes (null: replicas of the slab's own
// faces, nothing copied), global parity from z0. Out-of-place,
// for the caller's early stop and residuals; in place would be legal and is
// left to the change that makes the kernel fast.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) sor_halfsweep_gc_packed_kernel(
    const float* __restrict__ du_a, const float* __restrict__ du_o,
    const T* __restrict__ c, const float* __restrict__ ainv,
    const float* __restrict__ ps_a, const float* __restrict__ ps_o,
    const float* __restrict__ duo_lo, const float* __restrict__ duo_hi,
    const float* __restrict__ pso_lo, const float* __restrict__ pso_hi,
    float* __restrict__ out, int D, int H, int WP, int z0, int dg,
    float half_alpha, float omega, float one_minus_omega, int color) {
  const long long HW = (long long)H * WP;
  const long long N = (long long)D * HW;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int i = (int)(p % WP);
  const long long zy = p / WP;
  const int y = (int)(zy % H);
  const int z = (int)(zy / H);
  const int zg = z0 + z;
  const int off = (zg + y + color) & 1;  // x parity of this row's elements
  const int xa = 2 * i + off;            // the voxel's x
  const int W = 2 * WP;
  const long long hp = (long long)y * WP + i;  // index within a halo plane

  const float psp = ps_a[p];
  float b0 = load_term(c, p), b1 = load_term(c, N + p);
  float b2 = load_term(c, 2 * N + p);
  auto add = [&](float psq, float d0, float d1, float d2) {
    const float w = half_alpha * (psp + psq);
    b0 += w * d0;
    b1 += w * d1;
    b2 += w * d2;
  };
  auto add_at = [&](long long q) {
    add(ps_o[q], du_o[q], du_o[N + q], du_o[2 * N + q]);
  };
  // Beyond the slab's Z faces: the halo planes, or, when they are null, the
  // other colour's own face plane at the same index (replication).
  if (zg < dg - 1) {
    if (z + 1 < D) add_at(p + HW);
    else if (duo_hi == nullptr) add_at(p);
    else add(pso_hi[hp], duo_hi[hp], duo_hi[HW + hp], duo_hi[2 * HW + hp]);
  }
  if (zg > 0) {
    if (z > 0) add_at(p - HW);
    else if (duo_lo == nullptr) add_at(p);
    else add(pso_lo[hp], duo_lo[hp], duo_lo[HW + hp], duo_lo[2 * HW + hp]);
  }
  if (y < H - 1) add_at(p + WP);
  if (y > 0) add_at(p - WP);
  // x+1 at index i+off (= WP only when xa = W-1) and x-1 at i+off-1 (= -1
  // only when xa = 0): the face tests keep both inside the row.
  if (xa < W - 1) add_at(p + off);
  if (xa > 0) add_at(p + off - 1);

  const float a00 = ainv[p], a01 = ainv[N + p], a02 = ainv[2 * N + p];
  const float a11 = ainv[3 * N + p], a12 = ainv[4 * N + p];
  const float a22 = ainv[5 * N + p];
  const float x0 = a00 * b0 + a01 * b1 + a02 * b2;
  const float x1 = a01 * b0 + a11 * b1 + a12 * b2;
  const float x2 = a02 * b0 + a12 * b1 + a22 * b2;
  out[p] = one_minus_omega * du_a[p] + omega * x0;
  out[N + p] = one_minus_omega * du_a[N + p] + omega * x1;
  out[2 * N + p] = one_minus_omega * du_a[2 * N + p] + omega * x2;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). c
// points to bfloat16 when terms_bf16 is non-zero, else to float32.
extern "C" int tf3d_sor_halfsweep_gc_packed(
    const float* du_a, const float* du_o, const void* c, const float* ainv,
    const float* ps_a, const float* ps_o, const float* duo_lo,
    const float* duo_hi, const float* pso_lo, const float* pso_hi,
    float* out, int D, int H, int WP, int z0, int dg, float half_alpha,
    float omega, float one_minus_omega, int color, int terms_bf16,
    void* stream) {
  const long long n = (long long)D * H * WP;
  if (n == 0) return 0;
  // The four planes are given together or all null.
  const int given = (duo_lo != nullptr) + (duo_hi != nullptr) +
                    (pso_lo != nullptr) + (pso_hi != nullptr);
  if (given != 0 && given != 4) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (terms_bf16) {
    sor_halfsweep_gc_packed_kernel<__nv_bfloat16>
        <<<blocks, kThreads, 0, s>>>(
            du_a, du_o, (const __nv_bfloat16*)c, ainv, ps_a, ps_o, duo_lo,
            duo_hi, pso_lo, pso_hi, out, D, H, WP, z0, dg, half_alpha, omega,
            one_minus_omega, color);
  } else {
    sor_halfsweep_gc_packed_kernel<float><<<blocks, kThreads, 0, s>>>(
        du_a, du_o, (const float*)c, ainv, ps_a, ps_o, duo_lo, duo_hi, pso_lo,
        pso_hi, out, D, H, WP, z0, dg, half_alpha, omega, one_minus_omega,
        color);
  }
  return (int)cudaGetLastError();
}
