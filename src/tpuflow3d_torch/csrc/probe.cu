// Probes of this card's own rates, for utils/roofline.py. Neither replaces
// a TPU kernel: the JAX package measured its bandwidth with a chain of
// jitted axpys (tpuflow3d/utils/roofline.py, _timed_axpy_loop).
//
// - tf3d_copy_probe: a float4 copy, dst <- src, launched `reps` times back
//   to back. Bound by bytes (16 read and 16 written per float4); what
//   measure_hbm_bw reports is its sustained rate on a footprint far past
//   the 50 MB L2, so every pass streams device memory. One block per 512
//   float4 of the array, two loads a thread in flight before the stores:
//   on the H100 this form streams at Tensor.copy_'s rate, where a
//   grid-stride loop over 8 blocks an SM fell short of it (PERF.md §6).
// - tf3d_minmax_probe: 16 values a thread compare-exchanged in two
//   alternating layers (an odd-even transposition network, 30 fminf/fmaxf
//   an iteration, 8 independent pairs a layer), then summed in order:
//   bound by the min/max issue rate, the rate K3's selection network is
//   held to.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kPerBlock = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
copy_kernel(float4* __restrict__ dst, const float4* __restrict__ src,
            long long n4) {
  const long long base = (long long)blockIdx.x * kPerBlock + threadIdx.x;
  float4 v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + k * kThreads;
    if (j < n4) v[k] = src[j];
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = base + k * kThreads;
    if (j < n4) dst[j] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
minmax_kernel(float* __restrict__ out, int iters) {
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = (threadIdx.x * 16 + k) * 1e-3f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; k += 2) {
      const float a = v[k], b = v[k + 1];
      v[k] = fminf(a, b);
      v[k + 1] = fmaxf(a, b);
    }
#pragma unroll
    for (int k = 1; k < 15; k += 2) {
      const float a = v[k], b = v[k + 1];
      v[k] = fminf(a, b);
      v[k + 1] = fmaxf(a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += v[k];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// dst, src: n4 float4 each (16-byte aligned), n4 below 2^40.
extern "C" int tf3d_copy_probe(void* dst, const void* src, long long n4,
                               int reps, void* stream) {
  const unsigned blocks = (unsigned)((n4 + kPerBlock - 1) / kPerBlock);
  for (int r = 0; r < reps && blocks > 0; ++r) {
    copy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (float4*)dst, (const float4*)src, n4);
  }
  return (int)cudaGetLastError();
}

// out: blocks * 256 floats.
extern "C" int tf3d_minmax_probe(float* out, int blocks, int iters,
                                 void* stream) {
  minmax_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
