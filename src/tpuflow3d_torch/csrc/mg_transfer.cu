// K10 and K11, the grid transfers of the multigrid V-cycle for Hopper
// (sm_90a): tpuflow3d_torch.mgsolver._vcycle's restriction of the residual
// and prolongation of the correction on a whole in-core grid, each in one
// launch. The JAX package leaves them to XLA; there is no TPU kernel to
// port. Their plain versions (mgsolver.restrict_residual_plain and
// prolong_add_plain) make some forty and some twenty passes over the grid.
//
// K10 (restrict_kernel): rc = resize3(r, coarse), r = mg_residual(du) on
// the fine grid, r never written to memory. Per fine voxel p, neighbours q
// in the order z+, z-, y+, y-, x+, x-, edge-replicated, h_q the half-alpha
// of q's axis, m_q = 0 across the grid's faces:
//   r_k    = rhs_k, then for each q in order: r_k = r_k + w_q du_k[q],
//            w_q = (h_q (psi_s[p] + psi_s[q])) m_q
//   sw     = sum over q in order, from 0, of w_q
//   Ddu_0  = (d00 du0 + d01 du1) + d02 du2, and rows 1, 2 alike
//   r_k    = r_k - (du_k sw + Ddu_k)
// and per coarse voxel the z, then the y, then the x lerp of r, each
// a (1 - f) + b f from the axis's table (i0, i1, f): the plain resize's
// coordinates, made once per hierarchy (mgsolver.transfer_tables). Every
// axis changes its length between neighbouring grids (mgsolver.mg_shapes),
// so every axis lerps.
//
// K11 (prolong_kernel): out = du + resize3(ec, fine), the z, y and x
// lerps of the coarse correction from the up tables, then the add; out
// may be du itself (each thread reads its voxel before it writes it).
//
// Every step is the plain version's operation in its order (built with
// -fmad=false), so both are bitwise their plain versions on the card.
//
// What bounds them: device-memory bytes. K10 reads du 12, rhs 12 (6 in
// bfloat16), psi_s 4 and d6 24: 52 B a fine voxel, and writes rc, 12 B a
// coarse voxel, against ~80 flops a fine voxel. K11 reads and writes du,
// 24 B a fine voxel, and reads ec, 12 B a coarse voxel.
//
// Design. K10: a block owns a kCY x kCX tile of one coarse plane. It
// first makes r on the fine voxels the tile's lerps read (two fine planes,
// at most 2 kCY + 1 rows and 2 kCX + 1 columns where the y and x ratios
// are at most 2, as mgsolver.mg_shapes makes them) into shared memory,
// threads along x so that each row's loads are coalesced; the stencil's
// neighbours come from L1 and L2. Then each thread makes one coarse
// voxel's lerps from shared memory. K11: a block owns a kPY x kPX tile of
// one fine plane; it makes the z lerp of the coarse rows and columns the
// tile reads (at most kPY + 2 and kPX + 2 where the coarse grid is no
// larger than the fine) into shared memory, then each thread one fine
// voxel's y and x lerps and the add.

#include <cstdint>

#include <cuda_runtime.h>

#include "terms.cuh"

namespace tf3d_mg {

constexpr int kCX = 32;                     // coarse tile columns
constexpr int kCY = 8;                      // coarse tile rows
constexpr int kThreads = kCX * kCY;         // one coarse voxel each
constexpr int kFX = 2 * kCX + 2;            // fine columns a tile may read
constexpr int kFY = 2 * kCY + 2;            // fine rows a tile may read
constexpr int kPlane = kFX * kFY;
constexpr int kPX = 32, kPY = 8;            // K11's fine tile

// One axis's lerp table: (3, n) int32, rows i0, i1 and the bits of f.
struct Axis {
  const int* t;
  int n;  // output length
  __device__ __forceinline__ int i0(int i) const { return t[i]; }
  __device__ __forceinline__ int i1(int i) const { return t[n + i]; }
  __device__ __forceinline__ float f(int i) const {
    return __int_as_float(t[2 * n + i]);
  }
};

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return a * (1.f - f) + b * f;
}

template <typename R>
struct RArgs {
  const float* du;
  const R* rhs;
  const float* ps;
  const float* d6;
  float* rc;
  Axis tz, ty, tx;
  int D, H, W, Dc, Hc, Wc;
  long long N, Nc;  // voxels of a fine, a coarse component
  float hz, hy, hx;
};

// The residual's three components at fine voxel (z, y, x).
template <typename R>
__device__ __forceinline__ void residual(const RArgs<R>& a, int z, int y,
                                         int x, float r[3]) {
  const long long HW = (long long)a.H * a.W, N = a.N;
  const long long p = z * HW + (long long)y * a.W + x;
  const bool zp = z < a.D - 1, zm = z > 0, yp = y < a.H - 1, ym = y > 0,
             xp = x < a.W - 1, xm = x > 0;
  const long long off[6] = {zp ? HW : 0, zm ? -HW : 0,
                            yp ? (long long)a.W : 0,
                            ym ? -(long long)a.W : 0, xp ? 1 : 0,
                            xm ? -1 : 0};
  const float m[6] = {zp ? 1.f : 0.f, zm ? 1.f : 0.f, yp ? 1.f : 0.f,
                      ym ? 1.f : 0.f, xp ? 1.f : 0.f, xm ? 1.f : 0.f};
  const float h[6] = {a.hz, a.hz, a.hy, a.hy, a.hx, a.hx};
  const float ps = a.ps[p];
  float u[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[k] = a.du[k * N + p];
    r[k] = load_term(a.rhs, k * N + p);
  }
  float sw = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float w = (h[q] * (ps + a.ps[p + off[q]])) * m[q];
    sw = sw + w;
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = r[k] + w * a.du[k * N + p + off[q]];
  }
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = a.d6[i * N + p];
  const float dd[3] = {(d[0] * u[0] + d[1] * u[1]) + d[2] * u[2],
                       (d[1] * u[0] + d[3] * u[1]) + d[4] * u[2],
                       (d[2] * u[0] + d[4] * u[1]) + d[5] * u[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = r[k] - (u[k] * sw + dd[k]);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const RArgs<R> a) {
  __shared__ float res[2][3][kPlane];
  const int t = threadIdx.x;
  const int cx0 = (int)blockIdx.x * kCX, cy0 = (int)blockIdx.y * kCY;
  const int cz = (int)blockIdx.z;
  const int cx1 = min(cx0 + kCX, a.Wc) - 1, cy1 = min(cy0 + kCY, a.Hc) - 1;

  // The fine planes, rows and columns the tile's lerps read.
  const int pz[2] = {a.tz.i0(cz), a.tz.i1(cz)};
  const int fy0 = a.ty.i0(cy0), fy1 = a.ty.i1(cy1);
  const int fx0 = a.tx.i0(cx0), fx1 = a.tx.i1(cx1);
  const int ny = fy1 - fy0 + 1, nx = fx1 - fx0 + 1;

  for (int k = t; k < 2 * ny * nx; k += kThreads) {
    const int pl = k / (ny * nx), rem = k - pl * (ny * nx);
    const int iy = rem / nx, ix = rem - iy * nx;
    float r[3];
    residual(a, pz[pl], fy0 + iy, fx0 + ix, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) res[pl][c][iy * kFX + ix] = r[c];
  }
  __syncthreads();

  const int cy = cy0 + t / kCX, cx = cx0 + t % kCX;
  if (cy > cy1 || cx > cx1) return;
  const float fz = a.tz.f(cz), fy = a.ty.f(cy), fx = a.tx.f(cx);
  const int y0 = a.ty.i0(cy) - fy0, y1 = a.ty.i1(cy) - fy0;
  const int x0 = a.tx.i0(cx) - fx0, x1 = a.tx.i1(cx) - fx0;
  const long long o = ((long long)cz * a.Hc + cy) * a.Wc + cx;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    auto zl = [&](int iy, int ix) {
      return lerp(res[0][c][iy * kFX + ix], res[1][c][iy * kFX + ix], fz);
    };
    auto yl = [&](int ix) { return lerp(zl(y0, ix), zl(y1, ix), fy); };
    a.rc[c * a.Nc + o] = lerp(yl(x0), yl(x1), fx);
  }
}

struct PArgs {
  const float* du;
  const float* ec;
  float* out;  // may be du
  Axis tz, ty, tx;
  int D, H, W, Dc, Hc, Wc;
  long long N, Nc;
};

__global__ void __launch_bounds__(kPX * kPY) prolong_kernel(const PArgs a) {
  __shared__ float zl[3][(kPY + 2) * (kPX + 2)];
  const int t = threadIdx.x;
  const int x0 = (int)blockIdx.x * kPX, y0 = (int)blockIdx.y * kPY;
  const int z = (int)blockIdx.z;
  const int x1 = min(x0 + kPX, a.W) - 1, y1 = min(y0 + kPY, a.H) - 1;

  // The coarse rows and columns the tile's lerps read, their z lerp
  // (the plain resize's first pass) into shared memory.
  const int z0 = a.tz.i0(z), z1 = a.tz.i1(z);
  const float fz = a.tz.f(z);
  const int cy0 = a.ty.i0(y0), cy1 = a.ty.i1(y1);
  const int cx0 = a.tx.i0(x0), cx1 = a.tx.i1(x1);
  const int ny = cy1 - cy0 + 1, nx = cx1 - cx0 + 1;
  const long long HWc = (long long)a.Hc * a.Wc;
  for (int k = t; k < ny * nx; k += kPX * kPY) {
    const int iy = k / nx, ix = k - iy * nx;
    const long long q = (long long)(cy0 + iy) * a.Wc + cx0 + ix;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* e = a.ec + c * a.Nc;
      zl[c][iy * (kPX + 2) + ix] = lerp(e[z0 * HWc + q], e[z1 * HWc + q], fz);
    }
  }
  __syncthreads();

  const int x = x0 + t % kPX, y = y0 + t / kPX;
  if (x > x1 || y > y1) return;
  const int ry0 = a.ty.i0(y) - cy0, ry1 = a.ty.i1(y) - cy0;
  const int rx0 = a.tx.i0(x) - cx0, rx1 = a.tx.i1(x) - cx0;
  const float fy = a.ty.f(y), fx = a.tx.f(x);
  const long long p = ((long long)z * a.H + y) * a.W + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* s = zl[c];
    auto yl = [&](int ix) {
      return lerp(s[ry0 * (kPX + 2) + ix], s[ry1 * (kPX + 2) + ix], fy);
    };
    const float up = lerp(yl(rx0), yl(rx1), fx);
    a.out[c * a.N + p] = a.du[c * a.N + p] + up;
  }
}

// The launch grid's limits: the tiles along H and the depth at most 65535.
inline bool fits(int d, int h, int tile_h) {
  return d <= 65535 && (h + tile_h - 1) / tile_h <= 65535;
}

}  // namespace tf3d_mg

// K10: du (3, D, H, W), rhs (3, D, H, W; float32, or bfloat16 where
// rhs_bf16), psi_s (D, H, W) and d6 (6, D, H, W), all contiguous ->
// rc (3, Dc, Hc, Wc). tz, ty, tx: the lerp tables (3, Dc), (3, Hc),
// (3, Wc); Hc and Wc at least half of H and W. hz, hy, hx: the half-alphas of the three axes as float32.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a grid the
// launch cannot take.
extern "C" int tf3d_mg_restrict(const float* du, const void* rhs,
                                const float* ps, const float* d6, float* rc,
                                const int* tz, const int* ty, const int* tx,
                                int D, int H, int W, int Dc, int Hc, int Wc,
                                float hz, float hy, float hx, int rhs_bf16,
                                void* stream) {
  using namespace tf3d_mg;
  if ((long long)Dc * Hc * Wc == 0) return 0;
  if (!fits(Dc, Hc, kCY) || 2LL * Hc < H || 2LL * Wc < W)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Wc + kCX - 1) / kCX, (Hc + kCY - 1) / kCY, Dc);
  const Axis az{tz, Dc}, ay{ty, Hc}, ax{tx, Wc};
  const long long N = (long long)D * H * W, Nc = (long long)Dc * Hc * Wc;
  if (rhs_bf16) {
    const RArgs<__nv_bfloat16> a{du, (const __nv_bfloat16*)rhs, ps, d6, rc,
                                 az, ay, ax, D, H, W, Dc, Hc, Wc, N, Nc,
                                 hz, hy, hx};
    restrict_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    const RArgs<float> a{du, (const float*)rhs, ps, d6, rc, az, ay, ax,
                         D, H, W, Dc, Hc, Wc, N, Nc, hz, hy, hx};
    restrict_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// K11: du (3, D, H, W) and ec (3, Dc, Hc, Wc), contiguous float32 ->
// out = du + resize3(ec, (D, H, W)); out may be du. tz, ty, tx: the lerp
// tables (3, D), (3, H), (3, W); Hc and Wc at most H and W.
// Returns as tf3d_mg_restrict.
extern "C" int tf3d_mg_prolong(const float* du, const float* ec, float* out,
                               const int* tz, const int* ty, const int* tx,
                               int D, int H, int W, int Dc, int Hc, int Wc,
                               void* stream) {
  using namespace tf3d_mg;
  if ((long long)D * H * W == 0) return 0;
  if (!fits(D, H, kPY) || Hc > H || Wc > W) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kPX - 1) / kPX, (H + kPY - 1) / kPY, D);
  const PArgs a{du, ec, out, {tz, D}, {ty, H}, {tx, W}, D, H, W, Dc, Hc, Wc,
                (long long)D * H * W, (long long)Dc * Hc * Wc};
  prolong_kernel<<<grid, kPX * kPY, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
