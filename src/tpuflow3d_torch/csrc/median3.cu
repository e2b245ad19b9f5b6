// K3: exact 27-point (3x3x3) median of each component, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/median3.py:median3_pallas.
// Plain version: tpuflow3d_torch.median.median3 (stack, sort, index 13).
//
// What bounds it on the card: the selection, not the bytes. Device traffic
// is 8 B per output value (0.12 ms at 256^3 x 3), while one value selected
// alone takes ~200 min/max (the TPU kernel's forgetful network: 390), and
// min/max run at half the float32 FMA rate on the H100 (16.5 T/s
// measured).
//
// Design: the selection is shared between neighbouring voxels (separable
// sorting networks, A. Adams, "Fast median filters using separable sorting
// networks", ACM TOG 40(4), 2021). A block owns a (16 x 32) column tile of
// one component and marches z over a chunk of up to 64 planes (fewer where
// a small volume would give the card fewer than ~512 blocks); a thread owns
// two rows of one column.
// - Each plane is staged once in shared memory with its one-voxel Y/X rim
//   (edges replicated as it is loaded), two planes per barrier; the loads
//   of the next two planes are in flight while the current two are worked
//   on.
// - In a plane, each row triple (x-1, x, x+1) is sorted (3 compare-
//   exchanges) and merged along y into the sorted 9 values of each 3x3
//   block; the two rows of a thread share the merge of their common rows.
//   Each plane's lists are made once and serve the three output planes
//   around it.
// - Output planes go in pairs: the merge P of planes z and z+1 serves z
//   (with plane z-1) and z+1 (with plane z+2). The 14th smallest of a
//   sorted 9 and the sorted 18 is the least, over the 10 splits i + j = 14,
//   of max(a_i, b_j): 18 min/max, reading only P's ranks 5..14, so the
//   compiler drops the rest of P's merge network.
// - Batcher's odd-even merge, written for any two sizes, fully unrolled in
//   registers; only min/max touch the values, so the result is bitwise the
//   14th-smallest value, as sort()[13] gives (up to the sign of a zero).
// 85.3 min/max per output value.
// 32-bit indices (the wrapper bounds C*D*H*W). Z faces: the planes beyond
// the local slab come from lo/hi (neighbour planes when Z-sharded); null
// lo/hi replicate the slab's own face planes, so on one device nothing is
// copied.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;                  // threads along x, one column each
constexpr int kTY = 8;                   // threads along y
constexpr int kRows = 2;                 // rows a thread owns (even)
constexpr int kZChunk = 64;              // output planes per block, at most
constexpr int kGridBlocks = 512;         // blocks a launch aims at (4 an SM)
constexpr int kBY = kTY * kRows;         // rows of the tile
constexpr int kPX = kTX + 2;             // staged plane with its rim
constexpr int kPY = kBY + 2;
constexpr int kPlane = kPX * kPY;
constexpr int kThreads = kTX * kTY;

template <int N>
struct Vec {
  float v[N > 0 ? N : 1];
};

__device__ __forceinline__ Vec<3> sort3(float a, float b, float c) {
  const float a1 = fminf(a, b), b1 = fmaxf(a, b);
  const float b2 = fminf(b1, c), c2 = fmaxf(b1, c);
  return {{fminf(a1, b2), fmaxf(a1, b2), c2}};
}

// Batcher's odd-even merge of sorted a and b into one sorted list: merge
// the even-indexed and the odd-indexed elements apart, then one layer of
// compare-exchanges between neighbours of the interleaved results.
template <int N, int M>
__device__ __forceinline__ Vec<N + M> merge(const Vec<N>& a,
                                            const Vec<M>& b) {
  Vec<N + M> out;
  if constexpr (N == 0 || M == 0) {
#pragma unroll
    for (int i = 0; i < N + M; ++i) out.v[i] = i < N ? a.v[i] : b.v[i - N];
  } else if constexpr (N == 1 && M == 1) {
    out.v[0] = fminf(a.v[0], b.v[0]);
    out.v[1] = fmaxf(a.v[0], b.v[0]);
  } else {
    constexpr int NE = (N + 1) / 2, NO = N / 2, ME = (M + 1) / 2, MO = M / 2;
    constexpr int V = NE + ME, W = NO + MO;
    Vec<NE> ae;
    Vec<NO> ao;
    Vec<ME> be;
    Vec<MO> bo;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i % 2) ao.v[i / 2] = a.v[i];
      else ae.v[i / 2] = a.v[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i % 2) bo.v[i / 2] = b.v[i];
      else be.v[i / 2] = b.v[i];
    }
    const Vec<V> v = merge(ae, be);
    const Vec<W> w = merge(ao, bo);
    out.v[0] = v.v[0];
    constexpr int T = W > V - 1 ? W : V - 1;
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if (k < W && k + 1 < V) {
        out.v[1 + 2 * k] = fminf(w.v[k], v.v[k + 1]);
        out.v[2 + 2 * k] = fmaxf(w.v[k], v.v[k + 1]);
      } else if (k < W) {
        out.v[1 + 2 * k] = w.v[k];
      } else {
        out.v[1 + 2 * k] = v.v[k + 1];
      }
    }
  }
  return out;
}

// The K-th smallest (1-based) of sorted a and b together: the least, over
// the splits i + j = K, of max(a_i, b_j) (a_0, b_0: no element).
template <int K, int N, int M>
__device__ __forceinline__ float select(const Vec<N>& a, const Vec<M>& b) {
  constexpr int I0 = K - M > 0 ? K - M : 0, I1 = N < K ? N : K;
  float r = 0.f;
#pragma unroll
  for (int i = I0; i <= I1; ++i) {
    const int j = K - i;
    const float t = i == 0   ? b.v[j - 1]
                    : j == 0 ? a.v[i - 1]
                             : fmaxf(a.v[i - 1], b.v[j - 1]);
    r = i == I0 ? t : fminf(r, t);
  }
  return r;
}

// The sorted 3x3 blocks around the kRows rows of a thread in one staged
// plane (rows ty*kRows-1 .. ty*kRows+kRows of the tile, columns tx-1..tx+1).
__device__ __forceinline__ void plane_lists(const float* s, int ty, int tx,
                                            Vec<9> (&m)[kRows]) {
  Vec<3> row[kRows + 2];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r) {
    const float* p = s + (ty * kRows + r) * kPX + tx;
    row[r] = sort3(p[0], p[1], p[2]);
  }
#pragma unroll
  for (int r = 0; r < kRows; r += 2) {
    const Vec<6> q = merge(row[r + 1], row[r + 2]);
    m[r] = merge(row[r], q);
    m[r + 1] = merge(q, row[r + 3]);
  }
}

__global__ void __launch_bounds__(kThreads) median3_kernel(
    const float* __restrict__ x, const float* __restrict__ lo,
    const float* __restrict__ hi, float* __restrict__ out, int D, int H,
    int W, int zchunk, int zchunks) {
  __shared__ float s_plane[4][kPlane];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int bx = blockIdx.x * kTX, by = blockIdx.y * kBY;
  const int c = blockIdx.z / zchunks;
  const int z0 = (blockIdx.z % zchunks) * zchunk;
  const int zend = min(z0 + zchunk, D);
  const int HW = H * W;
  const float* xc = x + c * D * HW;

  // The staged planes: two sets of two, each plane with its rim, Y/X edges
  // replicated as loaded. A thread fetches its elements of the next two
  // planes (beyond the slab: lo/hi, or the face plane when null) before
  // it works on the current two, and stores them after.
  constexpr int kPer = (kPlane + kThreads - 1) / kThreads;
  auto fetch = [&](float (&v)[kPer], int z) {
    const float* src = z < 0    ? (lo != nullptr ? lo + c * HW : xc)
                       : z >= D ? (hi != nullptr ? hi + c * HW
                                                 : xc + (D - 1) * HW)
                                : xc + z * HW;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < kPlane) {
        const int ly = e / kPX, lx = e - ly * kPX;
        const int yy = min(max(by + ly - 1, 0), H - 1);
        const int xx = min(max(bx + lx - 1, 0), W - 1);
        v[k] = src[yy * W + xx];
      }
    }
  };
  auto put = [&](float* dst, const float (&v)[kPer]) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < kPlane) dst[e] = v[k];
    }
  };

  const int xo = bx + tx;
  float va[kPer], vb[kPer];
  fetch(va, z0 - 1);
  fetch(vb, z0);
  put(s_plane[0], va);
  put(s_plane[1], vb);
  __syncthreads();
  // m[0..3]: the sorted lists of planes p-2 .. p+1 for each row.
  Vec<9> m[4][kRows];
  for (int p = z0 - 1, step = 0; p - 1 < zend; p += 2, ++step) {
    const int cur = 2 * (step & 1), nxt = 2 - cur;
    const bool more = p + 1 < zend;  // the next step has outputs
    if (more) {
      fetch(va, p + 2);
      fetch(vb, p + 3);
    }
    plane_lists(s_plane[cur], ty, tx, m[2]);
    plane_lists(s_plane[cur + 1], ty, tx, m[3]);
    if (step > 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int yo = by + ty * kRows + r;
        const Vec<18> pm = merge(m[1][r], m[2][r]);
        const float a = select<14>(m[0][r], pm);
        const float b = select<14>(pm, m[3][r]);
        if (xo < W && yo < H) {
          float* o = out + (c * D + p - 1) * HW + yo * W + xo;
          o[0] = a;
          if (p < zend) o[HW] = b;
        }
      }
    }
    if (more) {
      put(s_plane[nxt], va);
      put(s_plane[nxt + 1], vb);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[0][r] = m[2][r];
      m[1][r] = m[3][r];
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// lo and hi may be null (no Z neighbours: the face planes are replicated).
extern "C" int tf3d_median3(const float* x, const float* lo, const float* hi,
                            float* out, int C, int D, int H, int W,
                            void* stream) {
  if ((long long)C * D * H * W == 0) return 0;
  // kZChunk planes a block, or fewer (an even number) where a small volume
  // would leave the card with fewer than kGridBlocks blocks.
  const int tiles = C * ((W + kTX - 1) / kTX) * ((H + kBY - 1) / kBY);
  const int fit = (int)(((long long)D * tiles + kGridBlocks - 1) /
                        kGridBlocks);
  const int zchunk = max(2, min(kZChunk, (fit + 1) & ~1));
  const int zchunks = (D + zchunk - 1) / zchunk;
  const dim3 grid((W + kTX - 1) / kTX, (H + kBY - 1) / kBY, C * zchunks);
  median3_kernel<<<grid, dim3(kTX, kTY), 0, (cudaStream_t)stream>>>(
      x, lo, hi, out, D, H, W, zchunk, zchunks);
  return (int)cudaGetLastError();
}
