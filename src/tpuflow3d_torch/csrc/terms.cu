// K8, the rank-1 nonlinearity update of a whole volume for Hopper (sm_90a):
// tpuflow3d_torch.solver.compute_terms' (c, psi_s, psi_d) when gamma = 0,
// in one launch. The JAX package leaves this arithmetic to XLA; the plain
// version, solver.rank1_terms, makes some fifty passes over the volume.
//
// The function (per voxel p; neighbours q in the order z+, z-, y+, y-, x+,
// x-, edge-replicated; h = alpha/2; m_q = 0 across the volume's faces):
//   r      = it + ((g0 du0 + g1 du1) + g2 du2)
//   psi_d  = rsqrt(r r + eps_d^2)                 (1 for "quadratic")
//   T      = flow + du
//   S_a    = (d0 d0 + d1 d1) + d2 d2,  d_k = 0.5 (T_k[p + e_a] - T_k[p - e_a])
//   psi_s  = rsqrt(((0 + S_z) + S_y) + S_x + eps_s^2)  (1 for "quadratic")
//   w_q    = (h (psi_s[p] + psi_s[q])) m_q
//   nbu_k  = sum over q in order, from 0, of w_q (flow_k[q] - flow_k[p])
//   c_k    = (-(psi_d it)) g_k + nbu_k
// Every step is the plain version's operation in its order (built with
// -fmad=false, rsqrtf as ATen's rsqrt), so the three fields are bitwise
// the plain version's on the card.
//
// What bounds it: device-memory bytes. g 12 + it 4 + flow 12 + du 12 read,
// c 12 + psi_s 4 + psi_d 4 written: 60 B/voxel, against ~130 flops.
//
// Design. A block owns a (y, x) tile of kTY x kTX voxels, one thread a
// voxel, and marches it along a chunk of z. Per step it loads one plane:
// flow and du on the tile and two voxels around it (T = flow + du into a
// ring of 3 planes in shared memory, flow on the tile and one voxel around
// into a ring of 5), and g and it on the tile, where psi_d and the data
// part of c are made at once (the latter waits two steps in registers).
// After a barrier it makes psi_s one plane behind on the tile and one
// voxel around (a ring of 3 planes), and after another, c two planes
// behind. The next plane's loads are issued before the barriers, so they
// are in flight while the block computes. Each input crosses the bus
// once, apart from the halos (from L2) and the four planes each z chunk
// reads past its ends. Neighbours past the volume's faces are read at the
// clamped (replicated) position, as the plain version pads.

#include <cstdint>

#include <cuda_runtime.h>

namespace tf3d_terms {

constexpr int kTX = 32;                        // tile columns: a warp a row
constexpr int kTY = 16;                        // tile rows
constexpr int kThreads = kTX * kTY;            // one voxel of the tile each
constexpr int kX2 = kTX + 4, kP2 = kX2 * (kTY + 4);  // the tile + 2 around
constexpr int kX1 = kTX + 2, kP1 = kX1 * (kTY + 2);  // the tile + 1 around
constexpr int kHalo2 = kP2 - kThreads;         // entries of the + 2 ring
constexpr int kRim1 = kP1 - kThreads;          // entries of the + 1 ring
constexpr int kTSlots = 3, kFSlots = 5, kPSlots = 3;
constexpr int kSmemFloats = kTSlots * 3 * kP2 + kFSlots * 3 * kP1
                            + kPSlots * kP1;
constexpr int kZChunk = 32;                    // planes a block marches
constexpr int kMinBlocks = 2;                  // blocks per SM to allow
constexpr int kSMs = 132;                      // the H100 SXM's SM count
constexpr int kMaxDevices = 64;
static_assert(kHalo2 <= kThreads && kRim1 <= kThreads,
              "one ring entry a thread at most");

struct Args {
  const float* g;
  const float* it;
  const float* flow;
  const float* du;
  float* c;
  float* ps;
  float* pd;
  int D, H, W, HW;
  long long N;  // voxels: the stride between components
  float half_alpha, eps2_d, eps2_s;
  int charb_d, charb_s;  // 1: Charbonnier, 0: quadratic
};

__device__ __forceinline__ float penalizer(float q2, float eps2, int charb) {
  return charb ? rsqrtf(q2 + eps2) : 1.f;
}

// psi_s at the centre i of the ring entries (+ 2 layout) of planes k-1
// (tm), k (t0) and k+1 (tp), each three components kP2 apart.
__device__ __forceinline__ float psi_s_at(const Args& a, const float* tm,
                                          const float* t0, const float* tp,
                                          int i) {
  float sq[3];
  const int off[3][2] = {{0, 0}, {kX2, -kX2}, {1, -1}};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float hi = ax == 0 ? tp[k * kP2 + i] : t0[k * kP2 + i + off[ax][0]];
      const float lo = ax == 0 ? tm[k * kP2 + i] : t0[k * kP2 + i + off[ax][1]];
      d[k] = 0.5f * (hi - lo);
    }
    sq[ax] = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
  }
  float s2 = 0.f;
  s2 = s2 + sq[0];
  s2 = s2 + sq[1];
  s2 = s2 + sq[2];
  return penalizer(s2, a.eps2_s, a.charb_s);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rank1_kernel(const Args a, int zchunk) {
  extern __shared__ __align__(16) float smem[];
  float* const tot = smem;                          // [3][3][kP2]
  float* const flw = tot + kTSlots * 3 * kP2;       // [5][3][kP1]
  float* const psi = flw + kFSlots * 3 * kP1;       // [3][kP1]

  const int t = threadIdx.x;
  const int tx = t % kTX, ty = t / kTX;
  const int x0 = (int)blockIdx.x * kTX, y0 = (int)blockIdx.y * kTY;
  const int zs = (int)blockIdx.z * zchunk;
  const int ze = min(a.D, zs + zchunk);
  const long long N = a.N;

  // This thread's voxel of the tile; one past the volume still loads (at
  // the clamped position: the replica its neighbours read) but writes
  // nothing.
  const int x = x0 + tx, y = y0 + ty;
  const bool valid = x < a.W && y < a.H;
  const int own = min(y, a.H - 1) * a.W + min(x, a.W - 1);
  const int own2 = (ty + 2) * kX2 + tx + 2;
  const int own1 = (ty + 1) * kX1 + tx + 1;

  // This thread's entry of the + 2 ring (two rows above and below, two
  // columns left and right), if any, and of the + 1 ring.
  int h_off = 0, h2 = -1, h1 = -1;
  if (t < kHalo2) {
    int ry, rx;
    if (t < 2 * kX2) {
      ry = t / kX2;
      rx = t % kX2;
    } else if (t < 4 * kX2) {
      ry = kTY + 2 + (t - 2 * kX2) / kX2;
      rx = (t - 2 * kX2) % kX2;
    } else {
      const int k = t - 4 * kX2;
      ry = 2 + k / 4;
      rx = k % 4 < 2 ? k % 4 : kTX + k % 4;
    }
    const int gy = min(max(y0 + ry - 2, 0), a.H - 1);
    const int gx = min(max(x0 + rx - 2, 0), a.W - 1);
    h_off = gy * a.W + gx;
    h2 = ry * kX2 + rx;
    if (ry >= 1 && ry <= kTY + 2 && rx >= 1 && rx <= kTX + 2)
      h1 = (ry - 1) * kX1 + rx - 1;
  }
  int r1 = -1, r1c = 0;  // a + 1 ring entry, and its centre in + 2 layout
  if (t < kRim1) {
    int ry, rx;
    if (t < kX1) {
      ry = 0;
      rx = t;
    } else if (t < 2 * kX1) {
      ry = kTY + 1;
      rx = t - kX1;
    } else {
      const int k = t - 2 * kX1;
      ry = 1 + k / 2;
      rx = k % 2 ? kTX + 1 : 0;
    }
    r1 = ry * kX1 + rx;
    r1c = (ry + 1) * kX2 + rx + 1;
  }

  // The face masks of this voxel along y and x, and its neighbours' offsets
  // in the + 1 layout, clamped (edge replicas) at the faces.
  const float m_yp = y < a.H - 1 ? 1.f : 0.f, m_ym = y > 0 ? 1.f : 0.f;
  const float m_xp = x < a.W - 1 ? 1.f : 0.f, m_xm = x > 0 ? 1.f : 0.f;
  const int o_yp = y < a.H - 1 ? kX1 : 0, o_ym = y > 0 ? -kX1 : 0;
  const int o_xp = x < a.W - 1 ? 1 : 0, o_xm = x > 0 ? -1 : 0;

  // Loads of one plane, issued a step ahead of their use.
  float rf[3], rd[3], rg[3], rit = 0.f, hf[3], hd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rf[k] = rd[k] = rg[k] = hf[k] = hd[k] = 0.f;
  auto fetch = [&](int z) {
    const long long pb = (long long)min(max(z, 0), a.D - 1) * a.HW;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rf[k] = a.flow[k * N + pb + own];
      rd[k] = a.du[k * N + pb + own];
    }
    if (z >= zs && z < ze) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rg[k] = a.g[k * N + pb + own];
      rit = a.it[pb + own];
    }
    if (h2 >= 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        hf[k] = a.flow[k * N + pb + h_off];
        hd[k] = a.du[k * N + pb + h_off];
      }
    }
  };

  // The data part of c, -(psi_d it) g, of the planes loaded one (q1) and
  // two (q2) steps before.
  float q1[3] = {0.f, 0.f, 0.f}, q2[3] = {0.f, 0.f, 0.f};
  const float h = a.half_alpha;
  fetch(zs - 2);
  // Step j loads plane k = zs - 2 + j; a plane's slot in each ring is its
  // step modulo the ring's size.
  for (int k = zs - 2, j = 0; k <= ze + 1; ++k, ++j) {
    {  // Plane k into the rings; psi_d and the data part of c.
      float* tk = tot + (j % kTSlots) * 3 * kP2;
      float* fk = flw + (j % kFSlots) * 3 * kP1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tk[c * kP2 + own2] = rf[c] + rd[c];
        fk[c * kP1 + own1] = rf[c];
        if (h2 >= 0) {
          tk[c * kP2 + h2] = hf[c] + hd[c];
          if (h1 >= 0) fk[c * kP1 + h1] = hf[c];
        }
      }
    }
    float dt[3] = {0.f, 0.f, 0.f};
    if (k >= zs && k < ze) {
      const float r = rit + ((rg[0] * rd[0] + rg[1] * rd[1]) + rg[2] * rd[2]);
      const float pd = penalizer(r * r, a.eps2_d, a.charb_d);
      if (valid) a.pd[(long long)k * a.HW + own] = pd;
      const float npi = -(pd * rit);
#pragma unroll
      for (int c = 0; c < 3; ++c) dt[c] = npi * rg[c];
    }
    if (k <= ze) fetch(k + 1);
    __syncthreads();

    // psi_s of plane k-1 from T of planes k-2, k-1, k.
    if (j >= 2) {
      const float* tm = tot + ((j + 1) % kTSlots) * 3 * kP2;
      const float* t0 = tot + ((j + 2) % kTSlots) * 3 * kP2;
      const float* tp = tot + (j % kTSlots) * 3 * kP2;
      float* pk = psi + ((j + 2) % kPSlots) * kP1;
      const float v = psi_s_at(a, tm, t0, tp, own2);
      pk[own1] = v;
      if (valid && k - 1 >= zs && k - 1 < ze)
        a.ps[(long long)(k - 1) * a.HW + own] = v;
      if (r1 >= 0) pk[r1] = psi_s_at(a, tm, t0, tp, r1c);
    }
    __syncthreads();

    // c of plane z = k-2 from psi_s and flow of planes z-1, z, z+1.
    const int z = k - 2;
    if (j >= 4 && valid) {
      const bool zp = z < a.D - 1, zm = z > 0;
      const float* p0 = psi + ((j + 1) % kPSlots) * kP1;
      const float* pp = psi + ((zp ? j + 2 : j + 1) % kPSlots) * kP1;
      const float* pm = psi + ((zm ? j : j + 1) % kPSlots) * kP1;
      const float* f0 = flw + ((j + 3) % kFSlots) * 3 * kP1;
      const float* fp = flw + ((zp ? j + 4 : j + 3) % kFSlots) * 3 * kP1;
      const float* fm = flw + ((zm ? j + 2 : j + 3) % kFSlots) * 3 * kP1;
      const float psp = p0[own1];
      const float w[6] = {(h * (psp + pp[own1])) * (zp ? 1.f : 0.f),
                          (h * (psp + pm[own1])) * (zm ? 1.f : 0.f),
                          (h * (psp + p0[own1 + o_yp])) * m_yp,
                          (h * (psp + p0[own1 + o_ym])) * m_ym,
                          (h * (psp + p0[own1 + o_xp])) * m_xp,
                          (h * (psp + p0[own1 + o_xm])) * m_xm};
      const long long pb = (long long)z * a.HW + own;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int o = c * kP1 + own1;
        const float u = f0[o];
        float n = 0.f;
        n = n + w[0] * (fp[o] - u);
        n = n + w[1] * (fm[o] - u);
        n = n + w[2] * (f0[o + o_yp] - u);
        n = n + w[3] * (f0[o + o_ym] - u);
        n = n + w[4] * (f0[o + o_xp] - u);
        n = n + w[5] * (f0[o + o_xm] - u);
        a.c[c * N + pb] = q2[c] + n;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q2[c] = q1[c];
      q1[c] = dt[c];
    }
  }
}

}  // namespace tf3d_terms

// g, it, flow, du (float32, contiguous, (3,)D,H,W) -> c, psi_s, psi_d.
// eps2_*: the squared epsilons as float32; charb_*: 1 for Charbonnier, 0
// for the quadratic penalizer. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a grid the launch cannot take (D or the tiles
// along H past 65535, a plane of 2^31 voxels or more).
extern "C" int tf3d_terms_rank1(const float* g, const float* it,
                                const float* flow, const float* du, float* c,
                                float* ps, float* pd, int D, int H, int W,
                                float half_alpha, float eps2_d, float eps2_s,
                                int charb_d, int charb_s, void* stream) {
  using namespace tf3d_terms;
  if (D < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if ((long long)D * H * W == 0) return 0;
  const int ty = (H + kTY - 1) / kTY, tx = (W + kTX - 1) / kTX;
  if (D > 65535 || ty > 65535 || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // The dynamic shared memory past 48 KB is allowed once per device (the
  // first launch is an eager one: graphs warm up before they capture).
  static bool allowed[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const int bytes = kSmemFloats * (int)sizeof(float);
  if (dev >= kMaxDevices || !allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  // Chunks of z short enough that each SM gets its kMinBlocks blocks.
  int zchunk = kZChunk;
  while (zchunk > 8 && tx * ty * ((D + zchunk - 1) / zchunk) <
                           kMinBlocks * kSMs)
    zchunk /= 2;
  Args a{g,  it, flow, du, c, ps, pd, D, H, W, H * W,
         (long long)D * H * W, half_alpha, eps2_d, eps2_s, charb_d, charb_s};
  rank1_kernel<<<dim3(tx, ty, (D + zchunk - 1) / zchunk), kThreads, bytes,
                 (cudaStream_t)stream>>>(a, zchunk);
  return (int)cudaGetLastError();
}
