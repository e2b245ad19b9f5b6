// The flat red-black SOR sweeps K1 (csrc/sor.cu, rank-1 point system) and K6
// (csrc/sor_gc.cu, general SPD point system) for Hopper (sm_90a): one source
// for both, for every colour set and for float32 or bfloat16 stored terms.
//
// The function (per voxel p of the active colour, global parity
// (z0+z+y+x)&1 == colour; neighbours q in the order z+, z-, y+, y-, x+, x-):
//   w_pq = h_axis*(psi_s[p]+psi_s[q])   (h = alpha/2; a neighbour across a
//                                         global face is skipped)
//   b    = c + sum_q w_pq du_q,  sw = sum_q w_pq
//   x    = (sw*I + psi_d g g^T)^-1 b  by Sherman-Morrison       (rank-1), or
//   x    = A^-1 b with the stored symmetric inverse (00, 01, 02, 11, 12, 22)
//   out  = (1-omega) du + omega x;  voxels of the other colour keep du.
// Every form below does exactly these operations in this order per voxel
// (built with -fmad=false), so all are bitwise equal to the plain version,
// tpuflow3d_torch.solver.sor_halfsweep, red then black.
//
// What bounds a sweep on the card: device-memory bytes. One pass over the
// arguments of a full red+black sweep is du 12 + c 12 + g 12 + psi_s 4 +
// psi_d 4 + out 12 = 56 B/voxel (general system: c 12 + ainv 24, 64
// B/voxel; with bfloat16 c, g 44 and 58), against ~170 flops/voxel.
//
// Design.
// - The unit of work is a quad: four consecutive x of one row (two red, two
//   black), owned by one thread. Where W % 4 == 0 and every base pointer is
//   16-byte aligned a quad is one 16-byte load per field (8 bytes for four
//   bfloat16) and one 16-byte store per component; otherwise (the coarse
//   multigrid grids have odd W) the same code loads and stores a quad's valid
//   lanes one by one. The z and y neighbours of a quad are quads too; the x
//   neighbours are its own lanes plus one scalar at x0-1 or x0+4. Which two
//   lanes are active depends on the row's parity and is resolved by selects,
//   so a warp does not diverge on it. Indices are 32-bit.
// - colour_kernel: one colour per launch (a half-sweep). A Z-sharded caller
//   needs it, because the halo planes must be exchanged between the colours;
//   a neighbour across the slab's local Z face comes from the plane
//   arguments, which are never dereferenced when the slab is the whole volume
//   (they may be null then).
// - fused_kernel: red then black in one launch, when the slab is the whole
//   volume. A block owns a (y, x) tile of kTY x 4*kTXQ voxels and marches it
//   along a chunk of z. Per plane its (kTY+2) x (kTXQ+2) threads relax red on
//   the tile plus a one-voxel rim (the rim redundantly: the neighbouring
//   block computes the same bits from the same inputs) and put du after the
//   red half-sweep into shared memory, four planes resident (the three the
//   black update reads and the one red writes next, so one barrier a plane
//   is enough); after the barrier the tile's threads relax black on the
//   plane before from those values and write both colours once. c, g or ainv and psi_d cross the bus
//   once per sweep: the black lanes of the quad loaded for the red update
//   wait in registers for one step. psi_s of the neighbours comes through
//   L1/L2 both times.
// - resident_kernel: for a whole-volume grid of at most kResidentMax voxels
//   of the general system (the coarse multigrid levels) all n sweeps of a
//   call in one launch of one block, the iterate in shared memory throughout.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "terms.cuh"

namespace tf3d_sweep {

// fused_kernel's tile: the fastest of the variants measured at 256^3 on an
// NVIDIA H100 80GB HBM3, 700 W (PERF.md has the table).
constexpr int kTXQ = 16;        // quads per tile row: 64 voxels
constexpr int kTY = 8;          // rows per tile
constexpr int kZChunk = 32;     // planes a block marches (fewer on a small grid)
constexpr int kMinBlocks = 2;   // blocks per SM the register count must allow
// Resident planes of du after red: the three the black update reads and the
// one red writes next, so one barrier a plane is enough.
constexpr int kSlots = 4;
constexpr int kSMs = 132;       // the H100 SXM's SM count
constexpr int kFusedX = kTXQ + 2;
constexpr int kFusedThreads = kFusedX * (kTY + 2);
constexpr int kRowF = kFusedX * 4;           // floats per shared row
constexpr int kPlaneF = (kTY + 2) * kRowF;   // floats per shared component
static_assert(kSlots * 3 * kPlaneF * 4 <= 48 * 1024,
              "the tile's planes must fit static shared memory");
constexpr int kCX = 32, kCY = 8;             // colour_kernel's block
constexpr int kResidentMax = 4096;           // voxels: 3 * 4 B * 4096 = 48 KB
constexpr int kResidentThreads = 1024;

struct F4x3 {
  float4 a, b, c;
};

struct Nb {  // one neighbour of one voxel
  bool ok;
  float ps, d0, d1, d2;
};

struct NbQuad {  // the same-lane neighbours of a quad along z or y
  bool ok;
  float4 ps;
  F4x3 du;
};

// kGC false: aux = psi_d (1 field), g read. kGC true: aux = ainv (6 fields),
// g not read.
template <typename T>
struct Args {
  const float* du;
  const T* c;
  const T* g;
  const float* ps;
  const float* aux;
  const float* du_lo;
  const float* du_hi;
  const float* ps_lo;
  const float* ps_hi;
  // The slab's global origin: z0_dev when it is not null (a streamed slab
  // under a CUDA graph replayed for every slab, whose origin changes between
  // replays), else z0.
  const int* z0_dev;
  int D, H, W, HW, N, z0, dg;
  float hz, hy, hx, omega, omo;
};

template <bool kGC>
struct NTerms {
  static constexpr int value = kGC ? 9 : 7;  // c(3) + ainv(6) | c(3)+g(3)+pd
};

// --- quad loads and stores -------------------------------------------------

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int i, int n) {
  if (kVec) return *reinterpret_cast<const float4*>(p + i);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = p[i];
  if (n > 1) v.y = p[i + 1];
  if (n > 2) v.z = p[i + 2];
  if (n > 3) v.w = p[i + 3];
  return v;
}

// bfloat16 is the top half of a float32: widening is a shift.
template <bool kVec>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int i, int n) {
  if (kVec) {
    const uint2 r = *reinterpret_cast<const uint2*>(p + i);
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = __bfloat162float(p[i]);
  if (n > 1) v.y = __bfloat162float(p[i + 1]);
  if (n > 2) v.z = __bfloat162float(p[i + 2]);
  if (n > 3) v.w = __bfloat162float(p[i + 3]);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int i, int n, float4 v) {
  if (kVec) {
    *reinterpret_cast<float4*>(p + i) = v;
    return;
  }
  p[i] = v.x;
  if (n > 1) p[i + 1] = v.y;
  if (n > 2) p[i + 2] = v.z;
  if (n > 3) p[i + 3] = v.w;
}

// The two active lanes of a quad whose first active lane is s (0 or 1).
__device__ __forceinline__ float lane_a(float4 v, int s) {
  return s ? v.y : v.x;
}
__device__ __forceinline__ float lane_b(float4 v, int s) {
  return s ? v.w : v.z;
}

// --- one voxel ---------------------------------------------------------------

// t: the voxel's terms, c(3) then g(3), psi_d or ainv(6). nb: z+, z-, y+, y-,
// x+, x-. u: the voxel's du.
template <bool kGC, typename A>
__device__ __forceinline__ void relax(const A& a, float psp, const float* t,
                                      const Nb* nb, float u0, float u1,
                                      float u2, float& o0, float& o1,
                                      float& o2) {
  float b0 = t[0], b1 = t[1], b2 = t[2];
  float sw = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (nb[k].ok) {
      const float h = k < 2 ? a.hz : (k < 4 ? a.hy : a.hx);
      const float w = h * (psp + nb[k].ps);
      if constexpr (!kGC) sw += w;
      b0 += w * nb[k].d0;
      b1 += w * nb[k].d1;
      b2 += w * nb[k].d2;
    }
  }
  float x0, x1, x2;
  if constexpr (kGC) {
    const float a00 = t[3], a01 = t[4], a02 = t[5];
    const float a11 = t[6], a12 = t[7], a22 = t[8];
    x0 = a00 * b0 + a01 * b1 + a02 * b2;
    x1 = a01 * b0 + a11 * b1 + a12 * b2;
    x2 = a02 * b0 + a12 * b1 + a22 * b2;
  } else {
    const float g0 = t[3], g1 = t[4], g2 = t[5], pdp = t[6];
    const float sw_inv = 1.f / sw;
    const float q = pdp * (g0 * g0 + g1 * g1 + g2 * g2);
    const float smt = pdp * sw_inv / (sw + q);
    const float gbs = (g0 * b0 + g1 * b1 + g2 * b2) * smt;
    x0 = b0 * sw_inv - g0 * gbs;
    x1 = b1 * sw_inv - g1 * gbs;
    x2 = b2 * sw_inv - g2 * gbs;
  }
  o0 = a.omo * u0 + a.omega * x0;
  o1 = a.omo * u1 + a.omega * x1;
  o2 = a.omo * u2 + a.omega * x2;
}

// --- one quad ----------------------------------------------------------------

// Relaxes the two active lanes (s, s+2) of a quad and returns the quad with
// the other two lanes unchanged. n: valid lanes (4 but at a ragged row end).
// xl, xr: the voxels at x0-1 and x0+4 (read only where the neighbouring lane
// is active). ta, tb: the terms of lanes s and s+2.
template <bool kGC, typename A>
__device__ __forceinline__ F4x3 quad_relax(const A& a, int s, int n,
                                           float4 ps, const F4x3& du,
                                           const NbQuad& zp, const NbQuad& zm,
                                           const NbQuad& yp, const NbQuad& ym,
                                           const Nb& xl, const Nb& xr,
                                           const float* ta, const float* tb) {
  // Along x: L | lane s | M | lane s+2 | R.
  Nb L, M, R;
  L.ok = s ? true : xl.ok;
  L.ps = s ? ps.x : xl.ps;
  L.d0 = s ? du.a.x : xl.d0;
  L.d1 = s ? du.b.x : xl.d1;
  L.d2 = s ? du.c.x : xl.d2;
  M.ok = (s ? 2 : 1) < n;
  M.ps = s ? ps.z : ps.y;
  M.d0 = s ? du.a.z : du.a.y;
  M.d1 = s ? du.b.z : du.b.y;
  M.d2 = s ? du.c.z : du.c.y;
  R.ok = s ? xr.ok : (3 < n);
  R.ps = s ? xr.ps : ps.w;
  R.d0 = s ? xr.d0 : du.a.w;
  R.d1 = s ? xr.d1 : du.b.w;
  R.d2 = s ? xr.d2 : du.c.w;

  // Lane s (second == false) or s+2 of a z or y neighbour quad.
  auto pick = [&](const NbQuad& q, bool second) {
    Nb v;
    v.ok = q.ok;
    v.ps = second ? lane_b(q.ps, s) : lane_a(q.ps, s);
    v.d0 = second ? lane_b(q.du.a, s) : lane_a(q.du.a, s);
    v.d1 = second ? lane_b(q.du.b, s) : lane_a(q.du.b, s);
    v.d2 = second ? lane_b(q.du.c, s) : lane_a(q.du.c, s);
    return v;
  };
  float na0, na1, na2, nb0, nb1, nb2;
  {
    const Nb nb[6] = {pick(zp, false), pick(zm, false), pick(yp, false),
                      pick(ym, false), M, L};
    relax<kGC>(a, lane_a(ps, s), ta, nb, lane_a(du.a, s), lane_a(du.b, s),
               lane_a(du.c, s), na0, na1, na2);
  }
  {
    Nb Mb = M;
    Mb.ok = true;  // lane s+2 is stored only if valid, and then M is too
    const Nb nb[6] = {pick(zp, true), pick(zm, true), pick(yp, true),
                      pick(ym, true), R, Mb};
    relax<kGC>(a, lane_b(ps, s), tb, nb, lane_b(du.a, s), lane_b(du.b, s),
               lane_b(du.c, s), nb0, nb1, nb2);
  }

  F4x3 o;
  o.a = s ? make_float4(du.a.x, na0, du.a.z, nb0)
          : make_float4(na0, du.a.y, nb0, du.a.w);
  o.b = s ? make_float4(du.b.x, na1, du.b.z, nb1)
          : make_float4(na1, du.b.y, nb1, du.b.w);
  o.c = s ? make_float4(du.c.x, na2, du.c.z, nb2)
          : make_float4(na2, du.c.y, nb2, du.c.w);
  return o;
}

template <bool kVec>
__device__ __forceinline__ NbQuad load_nb(bool ok, const float* ps,
                                          const float* du, int i, int cs,
                                          int n) {
  NbQuad q;
  q.ok = ok;
  q.ps = q.du.a = q.du.b = q.du.c = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    q.ps = load4<kVec>(ps, i, n);
    q.du.a = load4<kVec>(du, i, n);
    q.du.b = load4<kVec>(du + cs, i, n);
    q.du.c = load4<kVec>(du + 2 * cs, i, n);
  }
  return q;
}

__device__ __forceinline__ Nb load_x(bool ok, const float* ps,
                                     const float* du, int i, int cs) {
  Nb v;
  v.ok = ok;
  v.ps = v.d0 = v.d1 = v.d2 = 0.f;
  if (ok) {
    v.ps = ps[i];
    v.d0 = du[i];
    v.d1 = du[cs + i];
    v.d2 = du[2 * cs + i];
  }
  return v;
}

// The terms of the quad at flat index i: lanes s, s+2 into ta, tb and, when
// `rest` is given, the other two lanes into rest[0..NT) and rest[NT..2NT).
template <typename T, bool kGC, bool kVec>
__device__ __forceinline__ void load_terms(const Args<T>& a, int i, int n,
                                           int s, float* ta, float* tb,
                                           float* rest) {
  constexpr int NT = NTerms<kGC>::value;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float4 v;
    if (j < 3) v = load4<kVec>(a.c + j * a.N, i, n);
    else if (kGC) v = load4<kVec>(a.aux + (j - 3) * a.N, i, n);
    else if (j < 6) v = load4<kVec>(a.g + (j - 3) * a.N, i, n);
    else v = load4<kVec>(a.aux, i, n);
    ta[j] = lane_a(v, s);
    tb[j] = lane_b(v, s);
    if (rest != nullptr) {
      rest[j] = lane_a(v, 1 - s);
      rest[NT + j] = lane_b(v, 1 - s);
    }
  }
}

// One colour of the quad (z, y, x0) of a slab whose plane 0 is global plane
// z0, every input from device memory.
template <typename T, bool kGC, bool kVec>
__device__ __forceinline__ F4x3 colour_quad(const Args<T>& a, int z0, int z,
                                            int y, int x0, int colour,
                                            float* rest) {
  constexpr int NT = NTerms<kGC>::value;
  const int zg = z0 + z;
  const int s = (zg + y + colour) & 1;
  const int n = min(4, a.W - x0);
  const int hp = y * a.W + x0;  // index within a halo plane
  const int i = z * a.HW + hp;
  const float4 ps = load4<kVec>(a.ps, i, n);
  F4x3 du;
  du.a = load4<kVec>(a.du, i, n);
  du.b = load4<kVec>(a.du + a.N, i, n);
  du.c = load4<kVec>(a.du + 2 * a.N, i, n);
  const bool okzp = zg < a.dg - 1, okzm = zg > 0;
  const NbQuad zp = z + 1 < a.D
      ? load_nb<kVec>(okzp, a.ps, a.du, i + a.HW, a.N, n)
      : load_nb<kVec>(okzp, a.ps_hi, a.du_hi, hp, a.HW, n);
  const NbQuad zm = z > 0
      ? load_nb<kVec>(okzm, a.ps, a.du, i - a.HW, a.N, n)
      : load_nb<kVec>(okzm, a.ps_lo, a.du_lo, hp, a.HW, n);
  const NbQuad yp = load_nb<kVec>(y < a.H - 1, a.ps, a.du, i + a.W, a.N, n);
  const NbQuad ym = load_nb<kVec>(y > 0, a.ps, a.du, i - a.W, a.N, n);
  const Nb xl = load_x(x0 > 0 && s == 0, a.ps, a.du, i - 1, a.N);
  const Nb xr = load_x(x0 + 4 < a.W && s == 1, a.ps, a.du, i + 4, a.N);
  float ta[NT], tb[NT];
  load_terms<T, kGC, kVec>(a, i, n, s, ta, tb, rest);
  return quad_relax<kGC>(a, s, n, ps, du, zp, zm, yp, ym, xl, xr, ta, tb);
}

// --- kernels -----------------------------------------------------------------

template <typename T, bool kGC, bool kVec>
__global__ void __launch_bounds__(kCX* kCY)
    colour_kernel(const Args<T> a, float* __restrict__ out, int colour) {
  const int x0 = 4 * (blockIdx.x * kCX + threadIdx.x);
  const int y = blockIdx.y * kCY + threadIdx.y;
  const int z = blockIdx.z;
  if (x0 >= a.W || y >= a.H) return;
  const int z0 = a.z0_dev != nullptr ? *a.z0_dev : a.z0;
  const F4x3 o = colour_quad<T, kGC, kVec>(a, z0, z, y, x0, colour, nullptr);
  const int i = z * a.HW + y * a.W + x0;
  const int n = min(4, a.W - x0);
  store4<kVec>(out, i, n, o.a);
  store4<kVec>(out + a.N, i, n, o.b);
  store4<kVec>(out + 2 * a.N, i, n, o.c);
}

template <typename T, bool kGC, bool kVec>
__global__ void __launch_bounds__(kFusedThreads, kMinBlocks)
    fused_kernel(const Args<T> a, float* __restrict__ out, int zchunk) {
  constexpr int NT = NTerms<kGC>::value;
  // du after the red half-sweep: [plane slot][component][row][x].
  __shared__ __align__(16) float sm[kSlots][3][kPlaneF];
  const int tx = threadIdx.x % kFusedX, ty = threadIdx.x / kFusedX;
  const int x0 = 4 * ((int)blockIdx.x * kTXQ - 1 + tx);
  const int y = (int)blockIdx.y * kTY - 1 + ty;
  const bool in_vol = x0 >= 0 && x0 < a.W && y >= 0 && y < a.H;
  const bool rim_x = tx == 0 || tx == kFusedX - 1;
  const bool rim_y = ty == 0 || ty == kTY + 1;
  const bool interior = in_vol && !rim_x && !rim_y;
  const int zs = (int)blockIdx.z * zchunk;
  const int ze = min(a.D, zs + zchunk);
  const int so = ty * kRowF + tx * 4;  // this thread's quad in a shared plane
  const int n = min(4, a.W - x0);
  const int hp = y * a.W + x0;
  float black[2 * NT], black_next[2 * NT];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) black[j] = black_next[j] = 0.f;

  for (int k = zs - 1; k <= ze; ++k) {
    // Red on plane k: the tile, the rim rows, and a rim column's quad when
    // its lane next to the tile is red.
    if (k >= 0 && k < a.D && in_vol && !(rim_x && rim_y)) {
      const int s = (k + y) & 1;
      if (!rim_x || (tx == 0 ? s == 1 : s == 0)) {
        const F4x3 q = colour_quad<T, kGC, kVec>(
            a, a.z0, k, y, x0, 0, black_next);
        float(*pl)[kPlaneF] = sm[(k + 1) % kSlots];
        *reinterpret_cast<float4*>(&pl[0][so]) = q.a;
        *reinterpret_cast<float4*>(&pl[1][so]) = q.b;
        *reinterpret_cast<float4*>(&pl[2][so]) = q.c;
      }
    }
    __syncthreads();
    // Black on plane k-1 from the red values of planes k-2, k-1, k.
    const int zb = k - 1;
    if (zb >= zs && interior) {
      const int s = (zb + y + 1) & 1;
      const int i = zb * a.HW + hp;
      const float(*p0)[kPlaneF] = sm[(zb + 1) % kSlots];
      const float(*pp)[kPlaneF] = sm[(zb + 2) % kSlots];
      const float(*pm)[kPlaneF] = sm[zb % kSlots];
      auto quad_at = [&](bool ok, const float(*pl)[kPlaneF], int off,
                         int gi) {
        NbQuad q;
        q.ok = ok;
        q.ps = q.du.a = q.du.b = q.du.c = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          q.ps = load4<kVec>(a.ps, gi, n);
          q.du.a = *reinterpret_cast<const float4*>(&pl[0][off]);
          q.du.b = *reinterpret_cast<const float4*>(&pl[1][off]);
          q.du.c = *reinterpret_cast<const float4*>(&pl[2][off]);
        }
        return q;
      };
      const NbQuad own = quad_at(true, p0, so, i);
      const NbQuad zp = quad_at(zb < a.D - 1, pp, so, i + a.HW);
      const NbQuad zm = quad_at(zb > 0, pm, so, i - a.HW);
      const NbQuad yp = quad_at(y < a.H - 1, p0, so + kRowF, i + a.W);
      const NbQuad ym = quad_at(y > 0, p0, so - kRowF, i - a.W);
      auto x_at = [&](bool ok, int off, int gi) {
        Nb v;
        v.ok = ok;
        v.ps = v.d0 = v.d1 = v.d2 = 0.f;
        if (ok) {
          v.ps = a.ps[gi];
          v.d0 = p0[0][off];
          v.d1 = p0[1][off];
          v.d2 = p0[2][off];
        }
        return v;
      };
      const Nb xl = x_at(x0 > 0 && s == 0, so - 1, i - 1);
      const Nb xr = x_at(x0 + 4 < a.W && s == 1, so + 4, i + 4);
      const F4x3 o = quad_relax<kGC>(a, s, n, own.ps, own.du, zp, zm, yp, ym,
                                     xl, xr, black, black + NT);
      store4<kVec>(out, i, n, o.a);
      store4<kVec>(out + a.N, i, n, o.b);
      store4<kVec>(out + 2 * a.N, i, n, o.c);
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) black[j] = black_next[j];
  }
}

// All n sweeps of a grid of at most kResidentMax voxels in one block.
template <typename T, bool kGC>
__global__ void __launch_bounds__(kResidentThreads)
    resident_kernel(const Args<T> a, float* __restrict__ out, int nsweeps) {
  constexpr int NT = NTerms<kGC>::value;
  __shared__ float sdu[3 * kResidentMax];
  const int N = a.N;
  for (int i = threadIdx.x; i < 3 * N; i += kResidentThreads)
    sdu[i] = a.du[i];
  __syncthreads();
  for (int half = 0; half < 2 * nsweeps; ++half) {
    const int colour = half & 1;
    for (int p = threadIdx.x; p < N; p += kResidentThreads) {
      const int z = p / a.HW, r = p - z * a.HW;
      const int y = r / a.W, x = r - y * a.W;
      if (((z + y + x) & 1) != colour) continue;
      const bool ok[6] = {z < a.D - 1, z > 0,       y < a.H - 1,
                          y > 0,       x < a.W - 1, x > 0};
      const int q[6] = {p + a.HW, p - a.HW, p + a.W, p - a.W, p + 1, p - 1};
      Nb nb[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        nb[k].ok = ok[k];
        nb[k].ps = nb[k].d0 = nb[k].d1 = nb[k].d2 = 0.f;
        if (ok[k]) {
          nb[k].ps = a.ps[q[k]];
          nb[k].d0 = sdu[q[k]];
          nb[k].d1 = sdu[N + q[k]];
          nb[k].d2 = sdu[2 * N + q[k]];
        }
      }
      float t[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < 3) t[j] = load_term(a.c, (long long)j * N + p);
        else if (kGC) t[j] = a.aux[(j - 3) * N + p];
        else if (j < 6) t[j] = load_term(a.g, (long long)(j - 3) * N + p);
        else t[j] = a.aux[p];
      }
      float o0, o1, o2;
      relax<kGC>(a, a.ps[p], t, nb, sdu[p], sdu[N + p], sdu[2 * N + p], o0,
                 o1, o2);
      sdu[p] = o0;
      sdu[N + p] = o1;
      sdu[2 * N + p] = o2;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 3 * N; i += kResidentThreads) out[i] = sdu[i];
}

// --- launch ------------------------------------------------------------------

template <typename T, bool kGC, bool kVec>
int run(Args<T> a, float* buf0, float* buf1, int colours, int nsweeps,
        int* launched, cudaStream_t st) {
  if (colours < 2) {
    const dim3 grid((a.W + 4 * kCX - 1) / (4 * kCX), (a.H + kCY - 1) / kCY,
                    a.D);
    colour_kernel<T, kGC, kVec>
        <<<grid, dim3(kCX, kCY), 0, st>>>(a, buf0, colours);
    *launched = 1;
    return (int)cudaGetLastError();
  }
  // The one-block form is instantiated for the general system only: the
  // small multigrid levels, which are launch-bound, are its use.
  if constexpr (kGC) {
    if (a.N <= kResidentMax) {
      resident_kernel<T, kGC>
          <<<1, kResidentThreads, 0, st>>>(a, buf0, nsweeps);
      *launched = 1;
      return (int)cudaGetLastError();
    }
  }
  // Chunks of z short enough that each SM gets its kMinBlocks blocks.
  const int tiles = ((a.W + 4 * kTXQ - 1) / (4 * kTXQ)) *
                    ((a.H + kTY - 1) / kTY);
  int zchunk = kZChunk;
  while (zchunk > 8 &&
         tiles * ((a.D + zchunk - 1) / zchunk) < kMinBlocks * kSMs)
    zchunk /= 2;
  const dim3 grid((a.W + 4 * kTXQ - 1) / (4 * kTXQ), (a.H + kTY - 1) / kTY,
                  (a.D + zchunk - 1) / zchunk);
  for (int it = 0; it < nsweeps; ++it) {
    float* dst = (it & 1) ? buf1 : buf0;
    fused_kernel<T, kGC, kVec><<<grid, kFusedThreads, 0, st>>>(a, dst, zchunk);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++*launched;
    a.du = dst;
  }
  return 0;
}

// The C entries of sor.cu and sor_gc.cu. colours: 0 red, 1 black (one
// half-sweep, du -> buf0, nsweeps must be 1), 2 red then black (nsweeps full
// sweeps; the slab must be the whole volume: z0_dev null, z0 == 0, dg == D;
// du -> buf0 ->
// buf1 -> buf0 ..., or, for the general system on a grid of at most
// kResidentMax voxels, all of them in one launch into buf0).
// *launched gets the number of kernel launches made; the result is in buf0
// when it is odd, else in buf1. The plane pointers may be null on the whole
// volume. z0_dev, when not null, points to the slab's origin in device memory
// (an int, read by each thread of a launch), which then takes the place of
// z0; such a slab is never taken for the whole volume.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments no
// kernel here takes; among them a grid past the kernels' limits: D and the
// blocks along H at most 65535 (grid dimensions), 6 * D*H*W below 2^31
// (32-bit indices into ainv).
template <bool kGC>
int launch(const float* du, const void* c, const void* g, const float* ps,
           const float* aux, const float* du_lo, const float* du_hi,
           const float* ps_lo, const float* ps_hi, float* buf0, float* buf1,
           const int* z0_dev, int D, int H, int W, int z0, int dg, float hz,
           float hy, float hx,
           float omega, float omo, int colours, int nsweeps, int terms_bf16,
           int* launched, void* stream) {
  *launched = 0;
  const long long N = (long long)D * H * W;
  if (N == 0 || nsweeps == 0) return 0;
  const bool whole = z0_dev == nullptr && z0 == 0 && dg == D;
  constexpr int kRows = kCY < kTY ? kCY : kTY;  // the shorter block along H
  if (D < 0 || H < 0 || W < 0 || D > 65535 || (H + kRows - 1) / kRows > 65535 ||
      6 * N >= (1LL << 31) || colours < 0 || colours > 2 || nsweeps < 0 ||
      (colours < 2 && nsweeps != 1) || (colours == 2 && !whole) ||
      (!whole && !(du_lo && du_hi && ps_lo && ps_hi)) ||
      (nsweeps > 1 && buf1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits = (uintptr_t)du | (uintptr_t)ps | (uintptr_t)aux |
                         (uintptr_t)du_lo | (uintptr_t)du_hi |
                         (uintptr_t)ps_lo | (uintptr_t)ps_hi |
                         (uintptr_t)buf0 | (uintptr_t)buf1;
  const uintptr_t tbits = (uintptr_t)c | (uintptr_t)g;
  const bool vec = W % 4 == 0 && bits % 16 == 0 &&
                   tbits % (terms_bf16 ? 8 : 16) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto tag) {
    using T = decltype(tag);
    Args<T> a{du,    (const T*)c, (const T*)g, ps,     aux,
              du_lo, du_hi,       ps_lo,       ps_hi,  z0_dev,
              D,     H,           W,           H * W,  (int)N,
              z0,    dg,          hz,          hy,     hx,
              omega, omo};
    return vec ? run<T, kGC, true>(a, buf0, buf1, colours, nsweeps, launched,
                                   st)
               : run<T, kGC, false>(a, buf0, buf1, colours, nsweeps, launched,
                                    st);
  };
  return terms_bf16 ? go(__nv_bfloat16()) : go(float());
}

}  // namespace tf3d_sweep
