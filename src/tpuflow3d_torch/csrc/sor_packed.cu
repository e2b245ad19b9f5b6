// K4: one red-black SOR half-sweep on colour-packed arrays, rank-1 system,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/sor_packed.py:
// sor_halfsweep_packed. Plain version: tpuflow3d_torch.kernels.sor_packed.
// sor_halfsweep_packed_plain.
//
// Layout (kernels/sor_packed.py pack_color): voxel (z, y, x) of colour
// (z0+z+y+x)&1 lives at packed index i = x/2 of that colour's (D, H, WP)
// array, WP = W/2, W even. Row (z, y) of colour c starts at x parity
// off = (z0+z+y+c)&1, so the element at packed index i is the voxel
// x = 2i+off. All six neighbours of a voxel have the other colour:
//   z+-1, y+-1: the other colour's array at the same packed index;
//   x+1: its index i+off;   x-1: its index i+off-1.
// The arithmetic is K1's (csrc/sor.cu), in the same order: for each
// neighbour q in the order z+, z-, y+, y-, x+, x-
//   w_pq = alpha*(psi_s[p]+psi_s[q])/2   (a neighbour across a global face
//                                         has zero weight and is skipped)
//   b    = c + sum_q w_pq du_q,  sw = sum_q w_pq
// then the Sherman-Morrison solve of (sw*I + psi_d g g^T) x = b and
//   out = (1-omega) du + omega x
// for every element: each is an active voxel, there is no parity select and
// nothing is copied. A neighbour across the local Z face comes from the
// OTHER colour's halo planes (duo_lo/duo_hi, pso_lo/pso_hi), so a Z-sharded
// caller can pass its neighbours' planes; null planes stand for replicas of
// the slab's own faces (the other colour's plane 0 or D-1), so a caller on
// one device copies none; z0 is the global z of plane 0 and
// sets both the faces and the row offset (global parity, not slab-local).
//
// What bounds it on the card: device-memory bytes. Per voxel of the full
// volume a half-sweep reads the active colour's du, c, g (3 floats each on
// half the voxels: 18 B), psi_s and psi_d (4 B), the other colour's du and
// psi_s (8 B) and writes the active du (6 B): 36 B/voxel against the flat
// K1's 56, which moves the inactive colour's terms through every 32-byte
// sector and copies its du (30 B/voxel with bfloat16 c, g). Design: one
// thread per packed element; its own loads and its store are dense and
// coalesced, the other colour's du and psi_s are read at the same index in
// rows y+-1, planes z+-1 and at i, i+-1, which L1/L2 serve, so device memory
// sees each array about once. No shared memory. Out-of-place: the caller's
// early stop and residual tracking need the previous iterate. In place would
// be legal (a half-sweep never reads the array it writes) and would save the
// allocation; that is for the change that makes this kernel fast, as are
// 16-byte loads.

#include <cuda_runtime.h>

#include "terms.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) sor_halfsweep_packed_kernel(
    const float* __restrict__ du_a, const float* __restrict__ du_o,
    const T* __restrict__ c, const T* __restrict__ g,
    const float* __restrict__ ps_a, const float* __restrict__ ps_o,
    const float* __restrict__ pd,
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
  float sw = 0.f;
  auto add = [&](float psq, float d0, float d1, float d2) {
    const float w = half_alpha * (psp + psq);
    sw += w;
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

  const float g0 = load_term(g, p), g1 = load_term(g, N + p);
  const float g2 = load_term(g, 2 * N + p);
  const float pdp = pd[p];
  const float sw_inv = 1.f / sw;
  const float q = pdp * (g0 * g0 + g1 * g1 + g2 * g2);
  const float smt = pdp * sw_inv / (sw + q);
  const float gbs = (g0 * b0 + g1 * b1 + g2 * b2) * smt;
  out[p] = one_minus_omega * du_a[p] + omega * (b0 * sw_inv - g0 * gbs);
  out[N + p] =
      one_minus_omega * du_a[N + p] + omega * (b1 * sw_inv - g1 * gbs);
  out[2 * N + p] =
      one_minus_omega * du_a[2 * N + p] + omega * (b2 * sw_inv - g2 * gbs);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). c and g
// point to bfloat16 when terms_bf16 is non-zero, else to float32.
extern "C" int tf3d_sor_halfsweep_packed(
    const float* du_a, const float* du_o, const void* c, const void* g,
    const float* ps_a, const float* ps_o, const float* pd,
    const float* duo_lo, const float* duo_hi, const float* pso_lo,
    const float* pso_hi, float* out, int D, int H, int WP, int z0, int dg,
    float half_alpha, float omega, float one_minus_omega, int color,
    int terms_bf16, void* stream) {
  const long long n = (long long)D * H * WP;
  if (n == 0) return 0;
  // The four planes are given together or all null.
  const int given = (duo_lo != nullptr) + (duo_hi != nullptr) +
                    (pso_lo != nullptr) + (pso_hi != nullptr);
  if (given != 0 && given != 4) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (terms_bf16) {
    sor_halfsweep_packed_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        du_a, du_o, (const __nv_bfloat16*)c, (const __nv_bfloat16*)g, ps_a,
        ps_o, pd, duo_lo, duo_hi, pso_lo, pso_hi, out, D, H, WP, z0, dg,
        half_alpha, omega, one_minus_omega, color);
  } else {
    sor_halfsweep_packed_kernel<float><<<blocks, kThreads, 0, s>>>(
        du_a, du_o, (const float*)c, (const float*)g, ps_a, ps_o, pd, duo_lo,
        duo_hi, pso_lo, pso_hi, out, D, H, WP, z0, dg, half_alpha, omega,
        one_minus_omega, color);
  }
  return (int)cudaGetLastError();
}
