// K3: exact 27-point (3x3x3) median of each component, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/median3.py:median3_pallas.
// Plain version: tpuflow3d_torch.median.median3 (stack, sort, index 13).
//
// Y/X edges are replicated in-kernel; the planes beyond the local Z faces
// come from the halo planes lo/hi (edge replicas on one device, neighbour
// planes when Z-sharded). Selection is forgetful selection, as in the TPU
// kernel: keep the first 15 values, repeatedly drop the running min and max
// and admit the next value. Only min/max touch the values, so the result
// is bitwise the 14th-smallest value, as sort()[13] gives.
//
// What bounds it on the card: instructions, not bytes (~210 compare-
// exchanges per output voxel against 8 B of device traffic; the 27 loads
// of a thread overlap its neighbours' and hit L1). Design: one thread per
// (component, voxel), the working set in registers (fully unrolled, no
// local memory).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cswap(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// Survivors are s[LO .. LO+N-1]: bubble the max to the end and the min to
// the front, leaving the N-2 survivors s[LO+1 .. LO+N-2].
template <int LO, int N>
__device__ __forceinline__ void drop_min_max(float (&s)[15]) {
#pragma unroll
  for (int i = LO; i < LO + N - 1; ++i) cswap(s[i], s[i + 1]);
#pragma unroll
  for (int i = LO + N - 2; i > LO; --i) cswap(s[i - 1], s[i]);
}

// Cycle K admits value 15+K into the slot the last max was dropped from
// (s[14]), then drops min and max: survivors shrink from s[1+K .. 14] to
// s[2+K .. 13].
template <int K>
__device__ __forceinline__ void admit(float (&s)[15], const float (&v)[27]) {
  if constexpr (K < 12) {
    s[14] = v[15 + K];
    drop_min_max<1 + K, 14 - K>(s);
    admit<K + 1>(s, v);
  }
}

__global__ void __launch_bounds__(kThreads) median3_kernel(
    const float* __restrict__ x, const float* __restrict__ lo,
    const float* __restrict__ hi, float* __restrict__ out, int C, int D,
    int H, int W) {
  const long long total = (long long)C * D * H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int xx = (int)(idx % W);
  long long r = idx / W;
  const int y = (int)(r % H);
  r /= H;
  const int z = (int)(r % D);
  const int c = (int)(r / D);
  const long long HW = (long long)H * W;

  const float* planes[3] = {
      z > 0 ? x + ((long long)c * D + z - 1) * HW : lo + c * HW,
      x + ((long long)c * D + z) * HW,
      z < D - 1 ? x + ((long long)c * D + z + 1) * HW : hi + c * HW,
  };
  const long long ys[3] = {(long long)max(y - 1, 0) * W, (long long)y * W,
                           (long long)min(y + 1, H - 1) * W};
  const int xs[3] = {max(xx - 1, 0), xx, min(xx + 1, W - 1)};

  float v[27];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        v[9 * dz + 3 * dy + dx] = planes[dz][ys[dy] + xs[dx]];

  float s[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) s[i] = v[i];
  drop_min_max<0, 15>(s);  // survivors s[1 .. 13]
  admit<0>(s, v);          // survivor s[13]
  out[idx] = s[13];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tf3d_median3(const float* x, const float* lo, const float* hi,
                            float* out, int C, int D, int H, int W,
                            void* stream) {
  const long long total = (long long)C * D * H * W;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  median3_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, lo, hi, out, C, D, H, W);
  return (int)cudaGetLastError();
}
