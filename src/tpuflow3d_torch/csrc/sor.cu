// K1: one red-black SOR half-sweep of the linearized Euler-Lagrange system,
// compact-terms form, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/sor.py:sor_halfsweep_pallas.
// Plain version: tpuflow3d_torch.solver.sor_halfsweep.
//
// For each voxel p of the active colour (global parity (z0+z+y+x)&1 ==
// color) and each neighbour q in the order z+, z-, y+, y-, x+, x-:
//   w_pq = alpha*(psi_s[p]+psi_s[q])/2   (a neighbour across a global face
//                                         has zero weight and is skipped)
//   b    = c + sum_q w_pq du_q,  sw = sum_q w_pq
// then the Sherman-Morrison solve of (sw*I + psi_d g g^T) x = b and
//   out = (1-omega) du + omega x;
// voxels of the other colour are copied. A neighbour across the local Z
// face comes from the halo planes (du_lo/du_hi, ps_lo/ps_hi), so a Z-sharded
// caller can pass its neighbours' planes; z0 is the global z of plane 0.
//
// What bounds it on the card: device-memory bytes. A half-sweep reads du,
// c, g (3 floats each), psi_s and psi_d and writes du: 56 B/voxel, against
// ~60 flops/voxel for the active half. Design: one thread per x-pair (one
// active and one copied voxel), so every thread does the same work and
// neighbouring threads touch neighbouring addresses; neighbour reads of du
// and psi_s hit L1/L2, so device memory sees each array about once.
// Out-of-place, as the plain version: the inactive colour is copied.
// c and g may be stored in bfloat16 (T; 44 B/voxel): they are widened as
// they are loaded and the arithmetic stays in float32.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) sor_halfsweep_kernel(
    const float* __restrict__ du, const T* __restrict__ c,
    const T* __restrict__ g, const float* __restrict__ ps,
    const float* __restrict__ pd,
    const float* __restrict__ du_lo, const float* __restrict__ du_hi,
    const float* __restrict__ ps_lo, const float* __restrict__ ps_hi,
    float* __restrict__ out, int D, int H, int W, int z0, int dg,
    float half_alpha, float omega, float one_minus_omega, int color) {
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
  float sw = 0.f;
  auto add = [&](float psq, float d0, float d1, float d2) {
    const float w = half_alpha * (psp + psq);
    sw += w;
    b0 += w * d0;
    b1 += w * d1;
    b2 += w * d2;
  };
  auto add_at = [&](long long q) {
    add(ps[q], du[q], du[N + q], du[2 * N + q]);
  };
  if (zg < dg - 1) {
    if (z + 1 < D) add_at(p + HW);
    else add(ps_hi[hp], du_hi[hp], du_hi[HW + hp], du_hi[2 * HW + hp]);
  }
  if (zg > 0) {
    if (z > 0) add_at(p - HW);
    else add(ps_lo[hp], du_lo[hp], du_lo[HW + hp], du_lo[2 * HW + hp]);
  }
  if (y < H - 1) add_at(p + W);
  if (y > 0) add_at(p - W);
  if (xa < W - 1) add_at(p + 1);
  if (xa > 0) add_at(p - 1);

  const float g0 = load_term(g, p), g1 = load_term(g, N + p);
  const float g2 = load_term(g, 2 * N + p);
  const float pdp = pd[p];
  const float sw_inv = 1.f / sw;
  const float q = pdp * (g0 * g0 + g1 * g1 + g2 * g2);
  const float smt = pdp * sw_inv / (sw + q);
  const float gbs = (g0 * b0 + g1 * b1 + g2 * b2) * smt;
  out[p] = one_minus_omega * du[p] + omega * (b0 * sw_inv - g0 * gbs);
  out[N + p] = one_minus_omega * du[N + p] + omega * (b1 * sw_inv - g1 * gbs);
  out[2 * N + p] =
      one_minus_omega * du[2 * N + p] + omega * (b2 * sw_inv - g2 * gbs);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). c and g
// point to bfloat16 when terms_bf16 is non-zero, else to float32.
extern "C" int tf3d_sor_halfsweep(
    const float* du, const void* c, const void* g, const float* psi_s,
    const float* psi_d, const float* du_lo, const float* du_hi,
    const float* ps_lo, const float* ps_hi, float* out, int D, int H, int W,
    int z0, int dg, float half_alpha, float omega, float one_minus_omega,
    int color, int terms_bf16, void* stream) {
  const long long npairs = (long long)D * H * ((W + 1) / 2);
  if (npairs == 0) return 0;
  const unsigned blocks = (unsigned)((npairs + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (terms_bf16) {
    sor_halfsweep_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        du, (const __nv_bfloat16*)c, (const __nv_bfloat16*)g, psi_s, psi_d,
        du_lo, du_hi, ps_lo, ps_hi, out, D, H, W, z0, dg, half_alpha, omega,
        one_minus_omega, color);
  } else {
    sor_halfsweep_kernel<float><<<blocks, kThreads, 0, s>>>(
        du, (const float*)c, (const float*)g, psi_s, psi_d, du_lo, du_hi,
        ps_lo, ps_hi, out, D, H, W, z0, dg, half_alpha, omega,
        one_minus_omega, color);
  }
  return (int)cudaGetLastError();
}
