// K8 and K9, the nonlinearity update of a whole volume for Hopper
// (sm_90a): tpuflow3d_torch.solver.compute_terms in one launch. K8
// (rank1_kernel) makes the rank-1 system's (c, psi_s, psi_d) when gamma =
// 0; K9 (gc_kernel) the general system's (c, psi_s, ainv) when gamma > 0.
// The JAX package leaves this arithmetic to XLA; there is no TPU kernel to
// port. The plain versions, solver.rank1_terms and solver.general_terms,
// make some fifty and some hundred and fifty passes over the volume.
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
// and in K9, with G = gc_g (G[a][k]: the derivative along a of g_k) and
// I = gc_it:
//   r_a    = I_a + ((G[a][0] du0 + G[a][1] du1) + G[a][2] du2)
//   psi_g  = gamma rsqrt(((r_0 r_0 + r_1 r_1) + r_2 r_2) + eps_g^2)
//                                                 (gamma for "quadratic")
//   c_k    = c_k - (((psi_g I_0) G[0][k] + (psi_g I_1) G[1][k])
//                   + (psi_g I_2) G[2][k])
//   d_ij   = (psi_d g_i) g_j + psi_g ((G[0][i] G[0][j] + G[1][i] G[1][j])
//                                     + G[2][i] G[2][j])
//   sw     = sum over q in order, from 0, of w_q;  m = d + sw I
//   ainv   = the cofactors of m times 1 / ((m00 c00 + m01 c01) + m02 c02)
// Every step is the plain version's operation in its order (built with
// -fmad=false, rsqrtf as ATen's rsqrt, IEEE division as ATen's 1 / x), so
// the fields are bitwise the plain version's on the card.
//
// What bounds them: device-memory bytes. K8 reads g 12 + it 4 + flow 12 +
// du 12 and writes c 12 + psi_s 4 + psi_d 4: 60 B/voxel, against ~130
// flops. K9 reads gc_g 36 and gc_it 12 more and writes ainv 24 in place of
// psi_d: 128 B/voxel, against ~270 flops.
//
// Design. A block owns a (y, x) tile of kTY x kTX voxels, one thread a
// voxel, and marches it along a chunk of z. Per step it loads one plane:
// flow and du on the tile and two voxels around it (T = flow + du into a
// ring of 3 planes in shared memory, flow on the tile and one voxel around
// into a ring of 5), and in K8 g and it on the tile, where psi_d and the
// data part of c are made at once (the latter waits two steps in
// registers). After a barrier it makes psi_s one plane behind on the tile
// and one voxel around (a ring of 3 planes), and after another, c two
// planes behind. The next plane's loads are issued before the barriers, so
// they are in flight while the block computes. K9 does all its pointwise
// work at the plane of c: it keeps du two steps in registers, and loads g,
// it, gc_g and gc_it of that plane one step ahead, so that those sixteen
// values are in flight across the barriers and not held for two steps.
// Each input crosses the bus once, apart from the halos (from L2) and the
// four planes each z chunk reads past its ends. Neighbours past the
// volume's faces are read at the clamped (replicated) position, as the
// plain version pads. Both kernels are one template (march): K8's
// instantiation carries none of K9's work.

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
// K9 at two blocks an SM spills (64 registers, 48 bytes a thread); at one
// it takes 117 registers and no spill, and runs 3% faster (7.37 against
// 7.62 ms at 512^3; NVIDIA H100 80GB HBM3, 700 W).
constexpr int kGcMinBlocks = 1;
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

// K9's further inputs and its output in psi_d's place.
struct GcArgs {
  const float* gg;  // gc_g (3, 3, D, H, W): [a][k] at (3 a + k) N
  const float* gi;  // gc_it (3, D, H, W)
  float* ainv;      // (6, D, H, W): rows 00, 01, 02, 11, 12, 22
  float gamma, eps2_g;
  int charb_g;
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

// The z march of one block: K8 (kGc false) or K9 (kGc true).
template <bool kGc>
__device__ __forceinline__ void march(const Args& a, const GcArgs& ga,
                                      int zchunk) {
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
    if (!kGc && z >= zs && z < ze) {
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
  // K9: du of the plane loaded this step (e0) and of the two before (e1,
  // e2), and g, it, gc_g, gc_it of the plane of c, loaded a step ahead.
  float e0[3] = {0.f, 0.f, 0.f}, e1[3] = {0.f, 0.f, 0.f},
        e2[3] = {0.f, 0.f, 0.f}, cg[3], cit, gG[9], gI[3];
  auto fetch_c = [&](int z) {
    const long long pb = (long long)z * a.HW + own;
#pragma unroll
    for (int k = 0; k < 3; ++k) cg[k] = a.g[k * N + pb];
    cit = a.it[pb];
#pragma unroll
    for (int i = 0; i < 9; ++i) gG[i] = ga.gg[i * N + pb];
#pragma unroll
    for (int k = 0; k < 3; ++k) gI[k] = ga.gi[k * N + pb];
  };
  const float h = a.half_alpha;
  if (kGc && valid) fetch_c(zs);
  fetch(zs - 2);
  // Step j loads plane k = zs - 2 + j; a plane's slot in each ring is its
  // step modulo the ring's size.
  for (int k = zs - 2, j = 0; k <= ze + 1; ++k, ++j) {
    {  // Plane k into the rings; K8: psi_d and the data part of c; K9:
       // du kept for its plane of c.
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
    if constexpr (kGc) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e2[c] = e1[c];
        e1[c] = e0[c];
        e0[c] = rd[c];
      }
    } else if (k >= zs && k < ze) {
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
      float pd = 0.f, npi = 0.f, pg = 0.f, pI[3] = {0.f, 0.f, 0.f};
      if constexpr (kGc) {
        // psi_d and the data part of c, as K8 makes them, and psi_g.
        const float r = cit + ((cg[0] * e2[0] + cg[1] * e2[1])
                               + cg[2] * e2[2]);
        pd = penalizer(r * r, a.eps2_d, a.charb_d);
        npi = -(pd * cit);
        float rr[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          rr[i] = gI[i] + ((gG[3 * i] * e2[0] + gG[3 * i + 1] * e2[1])
                           + gG[3 * i + 2] * e2[2]);
        pg = ga.gamma * penalizer((rr[0] * rr[0] + rr[1] * rr[1])
                                  + rr[2] * rr[2], ga.eps2_g, ga.charb_g);
#pragma unroll
        for (int i = 0; i < 3; ++i) pI[i] = pg * gI[i];
      }
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
        if constexpr (kGc)
          a.c[c * N + pb] = (npi * cg[c] + n)
                            - ((pI[0] * gG[c] + pI[1] * gG[3 + c])
                               + pI[2] * gG[6 + c]);
        else
          a.c[c * N + pb] = q2[c] + n;
      }
      if constexpr (kGc) {
        // m = d + sw I and its inverse, as solver._sym3_inverse.
        float sw = 0.f;
#pragma unroll
        for (int q = 0; q < 6; ++q) sw = sw + w[q];
        auto d = [&](int i, int j) {
          return (pd * cg[i]) * cg[j]
                 + pg * ((gG[i] * gG[j] + gG[3 + i] * gG[3 + j])
                         + gG[6 + i] * gG[6 + j]);
        };
        const float m00 = d(0, 0) + sw, m01 = d(0, 1), m02 = d(0, 2);
        const float m11 = d(1, 1) + sw, m12 = d(1, 2), m22 = d(2, 2) + sw;
        const float cof[6] = {m11 * m22 - m12 * m12, m02 * m12 - m01 * m22,
                              m01 * m12 - m02 * m11, m00 * m22 - m02 * m02,
                              m01 * m02 - m00 * m12, m00 * m11 - m01 * m01};
        const float det_inv =
            1.f / ((m00 * cof[0] + m01 * cof[1]) + m02 * cof[2]);
#pragma unroll
        for (int q = 0; q < 6; ++q) ga.ainv[q * N + pb] = cof[q] * det_inv;
      }
    }
    if constexpr (kGc) {
      if (j >= 4 && valid && z + 1 < ze) fetch_c(z + 1);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q2[c] = q1[c];
        q1[c] = dt[c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rank1_kernel(const Args a, int zchunk) {
  march<false>(a, GcArgs{}, zchunk);
}

__global__ void __launch_bounds__(kThreads, kGcMinBlocks)
    gc_kernel(const Args a, const GcArgs ga, int zchunk) {
  march<true>(a, ga, zchunk);
}

// Sets up a launch of `kernel` over a (D, H, W) volume: 0 with the grid
// and the z chunk, -1 for an empty volume, or an error: cudaErrorInvalidValue
// for a grid the launch cannot take (D or the tiles along H past 65535, a
// plane of 2^31 voxels or more). `allowed` records per device that the
// dynamic shared memory past 48 KB was allowed (the first launch is an
// eager one: graphs warm up before they capture).
template <typename Kernel>
int plan(Kernel kernel, bool* allowed, int min_blocks, int D, int H, int W,
         dim3& grid, int& zchunk) {
  if (D < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if ((long long)D * H * W == 0) return -1;
  const int ty = (H + kTY - 1) / kTY, tx = (W + kTX - 1) / kTX;
  if (D > 65535 || ty > 65535 || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemFloats * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  // Chunks of z short enough that each SM gets its blocks.
  zchunk = kZChunk;
  while (zchunk > 8 && tx * ty * ((D + zchunk - 1) / zchunk) <
                           min_blocks * kSMs)
    zchunk /= 2;
  grid = dim3(tx, ty, (D + zchunk - 1) / zchunk);
  return 0;
}

}  // namespace tf3d_terms

// g, it, flow, du (float32, contiguous, (3,)D,H,W) -> c, psi_s, psi_d.
// eps2_*: the squared epsilons as float32; charb_*: 1 for Charbonnier, 0
// for the quadratic penalizer. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a grid the launch cannot take (tf3d_terms::plan).
extern "C" int tf3d_terms_rank1(const float* g, const float* it,
                                const float* flow, const float* du, float* c,
                                float* ps, float* pd, int D, int H, int W,
                                float half_alpha, float eps2_d, float eps2_s,
                                int charb_d, int charb_s, void* stream) {
  using namespace tf3d_terms;
  static bool allowed[kMaxDevices];
  dim3 grid;
  int zchunk = 0;
  const int e = plan(rank1_kernel, allowed, kMinBlocks, D, H, W, grid,
                     zchunk);
  if (e) return e < 0 ? 0 : e;
  Args a{g,  it, flow, du, c, ps, pd, D, H, W, H * W,
         (long long)D * H * W, half_alpha, eps2_d, eps2_s, charb_d, charb_s};
  rank1_kernel<<<grid, kThreads, kSmemFloats * (int)sizeof(float),
                 (cudaStream_t)stream>>>(a, zchunk);
  return (int)cudaGetLastError();
}

// K9: g, it, flow, du and gc_g (3, 3, D, H, W), gc_it (3, D, H, W), all
// float32 and contiguous -> c, psi_s, ainv (6, D, H, W). gamma: the float32
// weight of gradient constancy; eps2_g, charb_g: its penalizer, as those of
// the data and smoothness terms. Returns as tf3d_terms_rank1.
extern "C" int tf3d_terms_gc(const float* g, const float* it,
                             const float* flow, const float* du,
                             const float* gc_g, const float* gc_it, float* c,
                             float* ps, float* ainv, int D, int H, int W,
                             float half_alpha, float eps2_d, float eps2_s,
                             float eps2_g, float gamma, int charb_d,
                             int charb_s, int charb_g, void* stream) {
  using namespace tf3d_terms;
  static bool allowed[kMaxDevices];
  dim3 grid;
  int zchunk = 0;
  const int e = plan(gc_kernel, allowed, kGcMinBlocks, D, H, W, grid,
                     zchunk);
  if (e) return e < 0 ? 0 : e;
  Args a{g,  it, flow, du, c, ps, nullptr, D, H, W, H * W,
         (long long)D * H * W, half_alpha, eps2_d, eps2_s, charb_d, charb_s};
  GcArgs ga{gc_g, gc_it, ainv, gamma, eps2_g, charb_g};
  gc_kernel<<<grid, kThreads, kSmemFloats * (int)sizeof(float),
              (cudaStream_t)stream>>>(a, ga, zchunk);
  return (int)cudaGetLastError();
}
