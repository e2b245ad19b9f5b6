// K2 and K5: fused backward warp (K2 trilinear, K5 tricubic) + 2-point
// derivatives, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/tpuflow3d/pallas/warp_grad.py:warp_grad_pallas
// (K2: interp="trilinear"; K5: interp="tricubic", its Catmull-Rom variant).
// Plain version: tpuflow3d_torch.warp.warp_volume followed by
// tpuflow3d_torch.derivatives.derivatives.
//
//   i1w(x) = I1 at x + s(x), coordinates clipped to the volume
//   ibar   = (i0 + i1w) / 2
//   g      = central difference of ibar, replicate edges   (3, D, H, W)
//   it     = i1w - i0                                        (D, H, W)
//   i1w    itself, when the caller passes an output for it (gradient
//          constancy reads it)
//
// Window form (the streamed out-of-core mode): the volume passed is a slab
// of D planes whose plane 0 is global plane z0 of a volume of dg planes (z0
// may be negative: margins hanging below the volume). z is then clipped to
// the true volume in the slab's frame, then to the slab, in the plain
// version's float operations: clip(clip(z + s_z, -z0, dg-1-z0), 0, D-1).
// With z0 = 0 and dg = D the outer clip changes nothing, so the one-device
// call is the window form with the whole volume as its slab.
//
// Halo form (a Z shard: planes z0 .. z0+D-1 of a volume of dg): I1 comes
// padded by ip planes a side, flow and i0 by one, each pad holding the
// neighbouring shards' planes on an interior face and edge replicas on a
// global one (the TPU kernel's layout, pallas/warp_grad.py:321-342: ip =
// ceil(max_disp) + 2, + 3 for tricubic). Every sample plane, those beyond
// an interior face included (the derivatives' z-1 and z+D, the
// neighbour's own planes: its flow and i0 from the pad), is sampled at
// global coordinates, clip(z0 + z + s_z, 0, dg-1), its floor shifted by
// the integer ip - z0 into the padded slab: the one-device arithmetic,
// so a shard gives the one-device bits (as the plain sharded warp does).
// With |s_z| <= max_disp no tap reaches past the pad.
//
// The TPU kernel needs a bounded displacement (a select-interpolate over
// statically shifted slabs, clamp <= 2); a CUDA gather has no such bound,
// so this kernel serves any flow. Coordinate maths is float32, as in the
// reference: clip(z + s_z, 0, D-1), floor; trilinear takes the upper corner
// min(i+1, D-1), tricubic clamps each of its 4x4x4 tap indices to the
// volume and weights them with warp._cubic_weights' polynomials,
// accumulated in its order (per z tap pz += wy*(wx*v), then acc += wz*pz).
//
// What bounds it on the card: device-memory bytes (reads i0, flow and i1,
// writes g and it: 36 B/voxel) once the gathers stop setting the pace. A
// tricubic sample makes 64 dependent gathers; from device memory, each
// behind a per-tap clamp, their locality sets the pace (the time doubles
// from flows of +-2 to +-6).
//
// Design: a block owns a 16 x 32 (y, x) column tile over a chunk of up to
// 32 planes (fewer where a small volume would give the card fewer than ~512
// blocks) and marches z in slabs of 2 sample planes; ibar (with the
// one-voxel Y/X halo) rolls through a ring of 4 planes in shared memory, so
// a sample serves every output stencil that reads it:
// (34/32)(18*34)/(16*32) = 1.27 samples per output voxel (an 8x8x32 tile
// with its halo takes 1.66). it and i1w leave from the sample itself (each
// voxel of the tile is sampled by its own block once).
// - Per slab, each thread loads the flow and i0 of its points at once and
//   the block reduces the floor of the clipped sample coordinates to a min
//   and max per axis. Where the tap box (min-1 .. max+2 for tricubic,
//   min .. max+1 for trilinear) fits the interpolation's budget (below:
//   trilinear has none), the block stages that box
//   of I1 in shared memory, 16-byte rows copied with cp.async, each
//   element clamped to the volume as it is loaded, and the taps are
//   gathered from shared memory with no per-tap clamp. A slab whose box
//   does not fit (a large or rough displacement) gathers from device
//   memory with the per-tap clamps, in the same kernel with the same
//   arithmetic: a branch per slab on the data. Both give the same bits.
// - 32-bit indices (the wrapper bounds 3*D*H*W).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32, kTY = 16;       // output column tile (x, y)
constexpr int kRowsPerThread = 2;       // 32 x 8 threads
constexpr int kThreads = kTX * kTY / kRowsPerThread;
constexpr int kZChunk = 32;             // output planes per block, at most
constexpr int kGridBlocks = 512;        // blocks a launch aims at
constexpr int kSlab = 2;                // sample planes per slab
constexpr int kEX = kTX + 2, kEY = kTY + 2;
constexpr int kPlanePts = kEX * kEY;    // one sample plane with its halo
constexpr int kSlabPts = kSlab * kPlanePts;
constexpr int kPts = (kSlabPts + kThreads - 1) / kThreads;  // per thread
constexpr int kRing = kSlab + 2;        // ibar planes kept
// Per interpolation: the staged box's budget in floats, and the blocks per
// SM the registers are held to. Tricubic: 8448 (a random +-2 flow's box, 8
// x 24 x 44), three blocks of 43 KB: 130 KB of shared memory, which leaves
// ~120 KB of the SM's 256 KB to L1 for the device-memory gathers (with four
// blocks and 64 registers the tricubic sample spills, with more shared
// memory L1 shrinks: both measured slower). Trilinear: no box, four blocks
// of 10 KB. Its 8 taps a sample hit L1 as often as a box would serve them,
// and staging a 5632-float box measured 12% slower on smooth and random
// +-2 flows (PERF.md); every trilinear slab takes the device-memory
// branch.
constexpr int kBoxCubic = 8448, kBoxLinear = 0;
constexpr int kBlocksCubic = 3, kBlocksLinear = 4;
template <bool kCubic>
constexpr int kBoxFloats = kCubic ? kBoxCubic : kBoxLinear;
// The ibar ring, then the box.
template <bool kCubic>
constexpr int kSmemBytes = (kRing * kPlanePts + kBoxFloats<kCubic>) * 4;
static_assert((kRing & (kRing - 1)) == 0, "the ring is indexed by a mask");
static_assert(kRing * kPlanePts % 4 == 0, "the box starts 16-byte aligned");

__device__ __forceinline__ void cubic_weights(float f, float w[4]) {
  const float f2 = f * f;
  const float f3 = f2 * f;
  w[0] = 0.5f * (-f3 + 2.f * f2 - f);
  w[1] = 0.5f * (3.f * f3 - 5.f * f2 + 2.f);
  w[2] = 0.5f * (-3.f * f3 + 4.f * f2 + f);
  w[3] = 0.5f * (f3 - f2);
}

// 16 bytes from device memory to shared memory without passing registers.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void wait_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Where the taps come from: I1 in device memory, each index clamped to the
// volume (kClamp), or the staged box, whose origin is (z0, y0, x0) and
// whose elements are already the clamped ones.
template <bool kClamp>
struct Taps {
  const float* p;
  int z0, y0, x0, ny, nx, zmax, ymax, xmax;
  __device__ __forceinline__ int z(int i) const {
    return kClamp ? min(max(i, 0), zmax) : i - z0;
  }
  __device__ __forceinline__ int y(int i) const {
    return kClamp ? min(max(i, 0), ymax) : i - y0;
  }
  __device__ __forceinline__ int x(int i) const {
    return kClamp ? min(max(i, 0), xmax) : i - x0;
  }
  __device__ __forceinline__ const float* row(int zi, int yi) const {
    return p + (z(zi) * ny + y(yi)) * nx;
  }
};

// zsh shifts the floor of cz into I1's planes (the halo form's global
// coordinates into the padded slab; 0 otherwise).
template <bool kCubic, bool kClamp>
__device__ __forceinline__ float interp(const Taps<kClamp>& t, float cz,
                                        float cy, float cx, int zsh) {
  const float fz0 = floorf(cz), fy0 = floorf(cy), fx0 = floorf(cx);
  const int z0 = (int)fz0 + zsh, y0 = (int)fy0, x0 = (int)fx0;
  if constexpr (kCubic) {
    float wz[4], wy[4], wx[4];
    cubic_weights(cz - fz0, wz);
    cubic_weights(cy - fy0, wy);
    cubic_weights(cx - fx0, wx);
    int xi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) xi[k] = t.x(x0 + k - 1);
    float acc = 0.f;
#pragma unroll
    for (int iz = 0; iz < 4; ++iz) {
      float pz = 0.f;
#pragma unroll
      for (int iy = 0; iy < 4; ++iy) {
        const float* r = t.row(z0 + iz - 1, y0 + iy - 1);
#pragma unroll
        for (int ix = 0; ix < 4; ++ix) pz += wy[iy] * (wx[ix] * r[xi[ix]]);
      }
      acc += wz[iz] * pz;
    }
    return acc;
  } else {
    const float fz = cz - fz0, fy = cy - fy0, fx = cx - fx0;
    const int xa = t.x(x0), xb = t.x(x0 + 1);
    const float* r00 = t.row(z0, y0);
    const float* r01 = t.row(z0, y0 + 1);
    const float* r10 = t.row(z0 + 1, y0);
    const float* r11 = t.row(z0 + 1, y0 + 1);
    const float c00 = r00[xa] * (1.f - fx) + r00[xb] * fx;
    const float c01 = r01[xa] * (1.f - fx) + r01[xb] * fx;
    const float c10 = r10[xa] * (1.f - fx) + r10[xb] * fx;
    const float c11 = r11[xa] * (1.f - fx) + r11[xb] * fx;
    const float c0 = c00 * (1.f - fy) + c01 * fy;
    const float c1 = c10 * (1.f - fy) + c11 * fy;
    return c0 * (1.f - fz) + c1 * fz;
  }
}

template <bool kCubic>
__global__ void __launch_bounds__(kThreads,
                                  kCubic ? kBlocksCubic : kBlocksLinear)
    warp_grad_kernel(
    const float* __restrict__ i1, const float* __restrict__ flow,
    const float* __restrict__ i0, float* __restrict__ g,
    float* __restrict__ it, float* __restrict__ i1w, int D, int H, int W,
    int z0g, int dg, int ip, int zchunk, int box_floats, int vec_rows,
    int* __restrict__ tiles) {
  extern __shared__ float4 s_dyn[];
  float* s_bar = reinterpret_cast<float*>(s_dyn);  // [kRing][kEY][kEX]
  float* s_box = s_bar + kRing * kPlanePts;         // the staged box
  __shared__ int s_red[2][6];  // per slab parity: min z, y, x; max z, y, x
  constexpr int kLo = kCubic ? 1 : 0, kHi = kCubic ? 2 : 1;

  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int bx = blockIdx.x * kTX, by = blockIdx.y * kTY;
  const int z0 = blockIdx.z * zchunk, zend = min(z0 + zchunk, D);
  const int N = D * H * W;
  // The halo form (ip > 0): flow and i0 padded by one plane (fp), I1 by ip
  // (its last plane zmax; global plane g is its plane g + zsh),
  // neighbours beyond the faces that are interior.
  const bool halo = ip > 0;
  const int fp = halo ? 1 : 0, Nf = (D + 2 * fp) * H * W;
  const int zmax = D + 2 * ip - 1, zsh = halo ? ip - z0g : 0;
  const bool nb_lo = halo && z0g > 0, nb_hi = halo && z0g + D < dg;
  // The true volume's Z range in the slab's frame.
  const float zlo = (float)(-z0g), zhi = (float)(dg - 1 - z0g);
  // Sample plane zl (-1 .. D) -> the flow/i0 plane it reads (unpadded
  // index): itself beyond an interior face, else the nearest slab plane
  // (a replica beyond a global face or a window's).
  auto plane = [&](int zl) {
    return (nb_lo && zl < 0) || (nb_hi && zl >= D) ? zl
                                                   : min(max(zl, 0), D - 1);
  };
  if (tid < 12) s_red[tid / 6][tid % 6] = tid % 6 < 3 ? INT_MAX : INT_MIN;
  __syncthreads();

  // Slab s holds sample planes a .. a+kSlab-1 (z0-1 .. zend in all; a
  // plane outside the volume takes the warped face plane, as a halo voxel
  // outside it in y or x takes its face voxel's: the replicate padding
  // the derivatives need). Sample point e of a slab is plane e / kPlanePts,
  // halo row and column (e % kPlanePts) / kEX and % kEX; a thread takes
  // points tid, tid + kThreads, ...
  for (int s = 0, a = z0 - 1; a <= zend; ++s, a += kSlab) {
    // 1. Each point's clipped coordinates and i0, all loads in flight
    // together.
    float cz[kPts], cy[kPts], cx[kPts], i0v[kPts];
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const int e = tid + i * kThreads;
      const int pz = e / kPlanePts, r = e - pz * kPlanePts;
      if (e < kSlabPts && a + pz <= zend) {
        const int ey = r / kEX, ex = r - ey * kEX;
        const int z = plane(a + pz);
        const int y = min(max(by + ey - 1, 0), H - 1);
        const int x = min(max(bx + ex - 1, 0), W - 1);
        const int v = ((z + fp) * H + y) * W + x;
        cz[i] = halo ? fminf(fmaxf((float)(z0g + z) + flow[v], 0.f),
                             (float)(dg - 1))
                     : fminf(fmaxf(fminf(fmaxf((float)z + flow[v], zlo), zhi),
                                   0.f),
                             (float)(D - 1));
        cy[i] = fminf(fmaxf((float)y + flow[Nf + v], 0.f), (float)(H - 1));
        cx[i] = fminf(fmaxf((float)x + flow[2 * Nf + v], 0.f),
                      (float)(W - 1));
        i0v[i] = i0[v];
      }
    }

    // 2. With a box budget: the floors' min and max per axis over the
    // block, and the tap box staged if it fits, in rows of 16-byte vectors
    // (those inside the row copied without passing registers), each
    // element clamped to the volume.
    bool staged = false;
    Taps<false> box{s_box, 0, 0, 0, 0, 0, 0, 0, 0};
    if constexpr (kBoxFloats<kCubic> > 0) {
      int* red = s_red[s & 1];
      int lo[3] = {INT_MAX, INT_MAX, INT_MAX};
      int hi[3] = {INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int e = tid + i * kThreads;
        if (e < kSlabPts && a + e / kPlanePts <= zend) {
          const int f[3] = {(int)floorf(cz[i]) + zsh, (int)floorf(cy[i]),
                            (int)floorf(cx[i])};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            lo[k] = min(lo[k], f[k]);
            hi[k] = max(hi[k], f[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = __reduce_min_sync(0xffffffffu, lo[k]);
        hi[k] = __reduce_max_sync(0xffffffffu, hi[k]);
      }
      if ((tid & 31) == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          atomicMin(&red[k], lo[k]);
          atomicMax(&red[3 + k], hi[k]);
        }
      }
      __syncthreads();
      const int bz0 = red[0] - kLo, by0 = red[1] - kLo;
      const int bx0 = (red[2] - kLo) & ~3;  // 16-byte aligned rows
      const int nz = red[3] + kHi - bz0 + 1, ny = red[4] + kHi - by0 + 1;
      const int nx = (red[5] + kHi - bx0 + 4) & ~3;
      staged = (long long)nz * ny * nx <= box_floats;
      box = Taps<false>{s_box, bz0, by0, bx0, ny, nx, 0, 0, 0};
      if (tid == 0) {
        int* next = s_red[(s + 1) & 1];
        next[0] = next[1] = next[2] = INT_MAX;
        next[3] = next[4] = next[5] = INT_MIN;
      }
      if (staged) {
        const int nx4 = nx / 4;
        for (int e = tid; e < nz * ny * nx4; e += kThreads) {
          const int row = e / nx4, k = e - row * nx4;
          const int kz = row / ny, ky = row - kz * ny;
          const float* src = i1 + (min(max(bz0 + kz, 0), zmax) * H +
                                   min(max(by0 + ky, 0), H - 1)) * W;
          const int gx = bx0 + 4 * k;
          float* dst = s_box + 4 * e;
          if (vec_rows && gx >= 0 && gx + 3 < W) {
            copy16_async(dst, src + gx);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dst[j] = src[min(max(gx + j, 0), W - 1)];
            }
          }
        }
        wait_async();
      }
    }
    if (tid == 0 && tiles != nullptr) atomicAdd(&tiles[staged ? 0 : 1], 1);
    __syncthreads();

    // 3. Warp each point: ibar into the ring; it (and i1w) straight out
    // for the points that are this block's own voxels.
    auto sample = [&](const auto& taps) {
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const int e = tid + i * kThreads;
        const int pz = e / kPlanePts, r = e - pz * kPlanePts;
        if (e < kSlabPts && a + pz <= zend) {
          const float w = interp<kCubic>(taps, cz[i], cy[i], cx[i], zsh);
          s_bar[((a + pz - z0 + 1) & (kRing - 1)) * kPlanePts + r] =
              0.5f * (i0v[i] + w);
          const int ey = r / kEX, ex = r - ey * kEX;
          const int z = a + pz, y = by + ey - 1, x = bx + ex - 1;
          if (z >= z0 && z < zend && ey >= 1 && ey <= kTY && ex >= 1 &&
              ex <= kTX && y < H && x < W) {
            const int v = (z * H + y) * W + x;
            it[v] = w - i0v[i];
            if (i1w != nullptr) i1w[v] = w;
          }
        }
      }
    };
    if (staged) {
      sample(box);
    } else {
      sample(Taps<true>{i1, 0, 0, 0, H, W, zmax, H - 1, W - 1});
    }
    __syncthreads();

    // 4. g on the output planes whose three ibar planes are in the ring:
    // a-1 .. a+kSlab-2.
    const int x = bx + threadIdx.x;
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      const int ty = threadIdx.y + rr * (kTY / kRowsPerThread);
      const int y = by + ty;
      const int o = (ty + 1) * kEX + threadIdx.x + 1;
#pragma unroll
      for (int k = 0; k < kSlab; ++k) {
        const int z = a - 1 + k;
        if (z < z0 || z >= zend || x >= W || y >= H) continue;
        const float* bm = s_bar + ((z - z0) & (kRing - 1)) * kPlanePts + o;
        const float* bc = s_bar + ((z - z0 + 1) & (kRing - 1)) * kPlanePts + o;
        const float* bp = s_bar + ((z - z0 + 2) & (kRing - 1)) * kPlanePts + o;
        const int v = (z * H + y) * W + x;
        g[v] = 0.5f * (bp[0] - bm[0]);
        g[N + v] = 0.5f * (bc[kEX] - bc[-kEX]);
        g[2 * N + v] = 0.5f * (bc[1] - bc[-1]);
      }
    }
  }
}

template <bool kCubic>
int launch(const float* i1, const float* flow, const float* i0, float* g,
           float* it, float* i1w, int D, int H, int W, int z0, int dg,
           int ip, bool staged, int* tiles, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      warp_grad_kernel<kCubic>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<kCubic>);
  if (err != cudaSuccess) return (int)err;
  const int vec_rows = W % 4 == 0 && (unsigned long long)i1 % 16 == 0;
  // kZChunk planes a block, or fewer (an even number) where a small volume
  // would leave the card with fewer than kGridBlocks blocks.
  const int tiles_yx = ((W + kTX - 1) / kTX) * ((H + kTY - 1) / kTY);
  const int fit = (int)(((long long)D * tiles_yx + kGridBlocks - 1) /
                        kGridBlocks);
  const int zchunk = max(2, min(kZChunk, (fit + 1) & ~1));
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY,
                  (D + zchunk - 1) / zchunk);
  warp_grad_kernel<kCubic><<<grid, dim3(kTX, kTY / kRowsPerThread),
                             kSmemBytes<kCubic>, stream>>>(
      i1, flow, i0, g, it, i1w, D, H, W, z0, dg, ip, zchunk,
      staged ? kBoxFloats<kCubic> : 0, vec_rows, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// i1w may be null (no warped volume wanted); cubic != 0 selects K5. z0 and
// dg place the volume as a window of a larger one (see above): 0 and D for
// the whole volume. ip > 0 selects the halo form of a Z shard (above): i1
// then holds D + 2*ip planes, flow and i0 D + 2.
// staged == 0 sends every slab to the device-memory gathers; tiles, when
// not null, is a device int[2] to which each slab adds one: [0] staged,
// [1] gathered from device memory.
extern "C" int tf3d_warp_grad(const float* i1, const float* flow,
                              const float* i0, float* g, float* it,
                              float* i1w, int D, int H, int W, int z0,
                              int dg, int ip, int cubic, int staged,
                              int* tiles, void* stream) {
  if ((long long)D * H * W == 0) return 0;
  return cubic ? launch<true>(i1, flow, i0, g, it, i1w, D, H, W, z0, dg, ip,
                              staged != 0, tiles, (cudaStream_t)stream)
               : launch<false>(i1, flow, i0, g, it, i1w, D, H, W, z0, dg,
                               ip, staged != 0, tiles, (cudaStream_t)stream);
}
