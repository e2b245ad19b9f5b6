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
// The TPU kernel needs a bounded displacement (a select-interpolate over
// statically shifted slabs, clamp <= 2); a CUDA gather has no such bound,
// so this kernel serves any flow. Coordinate maths is float32, as in the
// reference: clip(z + s_z, 0, D-1), floor; trilinear takes the upper corner
// min(i+1, D-1), tricubic clamps each of its 4x4x4 tap indices to the
// volume and weights them with warp._cubic_weights' polynomials,
// accumulated in its order (per z tap pz += wy*(wx*v), then acc += wz*pz).
//
// What bounds it on the card: K2, device-memory bytes (reads i0, flow and
// the gathered i1, writes g and it: ~36 B/voxel) plus the 8-corner gather's
// latency; K5, the 64 dependent gathers per sample (load issue and L1/L2
// latency, not DRAM bytes). Design: a block owns a TZ x TY x TX output
// tile; it warps every voxel of the tile and its one-voxel halo once, into
// shared memory (a halo voxel outside the volume takes the warped value of
// the face voxel, which is the replicate padding the derivative needs),
// then takes the stencils from shared memory. The halo costs
// (TZ+2)(TY+2)(TX+2)/(TZ TY TX) = 1.66x samples per output voxel; the
// gathers of neighbouring threads fall on neighbouring addresses of I1 and
// hit L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8, TZ = 8;
constexpr int EX = TX + 2, EY = TY + 2, EZ = TZ + 2;

__device__ __forceinline__ void cubic_weights(float f, float w[4]) {
  const float f2 = f * f;
  const float f3 = f2 * f;
  w[0] = 0.5f * (-f3 + 2.f * f2 - f);
  w[1] = 0.5f * (3.f * f3 - 5.f * f2 + 2.f);
  w[2] = 0.5f * (-3.f * f3 + 4.f * f2 + f);
  w[3] = 0.5f * (f3 - f2);
}

template <bool kCubic>
__device__ __forceinline__ float warp_at(const float* __restrict__ i1,
                                         const float* __restrict__ flow,
                                         int z, int y, int x, int D, int H,
                                         int W, long long N) {
  const long long v = ((long long)z * H + y) * W + x;
  const float cz = fminf(fmaxf((float)z + flow[v], 0.f), (float)(D - 1));
  const float cy = fminf(fmaxf((float)y + flow[N + v], 0.f), (float)(H - 1));
  const float cx =
      fminf(fmaxf((float)x + flow[2 * N + v], 0.f), (float)(W - 1));
  const float fz0 = floorf(cz), fy0 = floorf(cy), fx0 = floorf(cx);
  const int z0 = (int)fz0, y0 = (int)fy0, x0 = (int)fx0;
  if constexpr (kCubic) {
    float wz[4], wy[4], wx[4];
    cubic_weights(cz - fz0, wz);
    cubic_weights(cy - fy0, wy);
    cubic_weights(cx - fx0, wx);
    int xi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) xi[k] = min(max(x0 + k - 1, 0), W - 1);
    float acc = 0.f;
#pragma unroll
    for (int iz = 0; iz < 4; ++iz) {
      const long long zrow = (long long)min(max(z0 + iz - 1, 0), D - 1) * H;
      float pz = 0.f;
#pragma unroll
      for (int iy = 0; iy < 4; ++iy) {
        const float* r = i1 + (zrow + min(max(y0 + iy - 1, 0), H - 1)) * W;
#pragma unroll
        for (int ix = 0; ix < 4; ++ix) pz += wy[iy] * (wx[ix] * r[xi[ix]]);
      }
      acc += wz[iz] * pz;
    }
    return acc;
  } else {
    const float fz = cz - fz0, fy = cy - fy0, fx = cx - fx0;
    const int z1 = min(z0 + 1, D - 1), y1 = min(y0 + 1, H - 1),
              x1 = min(x0 + 1, W - 1);
    auto at = [&](int zz, int yy, int xx) {
      return i1[((long long)zz * H + yy) * W + xx];
    };
    const float c00 = at(z0, y0, x0) * (1.f - fx) + at(z0, y0, x1) * fx;
    const float c01 = at(z0, y1, x0) * (1.f - fx) + at(z0, y1, x1) * fx;
    const float c10 = at(z1, y0, x0) * (1.f - fx) + at(z1, y0, x1) * fx;
    const float c11 = at(z1, y1, x0) * (1.f - fx) + at(z1, y1, x1) * fx;
    const float c0 = c00 * (1.f - fy) + c01 * fy;
    const float c1 = c10 * (1.f - fy) + c11 * fy;
    return c0 * (1.f - fz) + c1 * fz;
  }
}

template <bool kCubic>
__global__ void __launch_bounds__(TX * TY) warp_grad_kernel(
    const float* __restrict__ i1, const float* __restrict__ flow,
    const float* __restrict__ i0, float* __restrict__ g,
    float* __restrict__ it, float* __restrict__ i1w, int D, int H, int W) {
  __shared__ float s_bar[EZ][EY][EX];   // ibar on the tile + halo
  __shared__ float s_warp[EZ][EY][EX];  // i1w on the tile + halo
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY, bz = blockIdx.z * TZ;
  const long long N = (long long)D * H * W;

  for (int e = threadIdx.y * TX + threadIdx.x; e < EZ * EY * EX;
       e += TX * TY) {
    const int ex = e % EX, ey = (e / EX) % EY, ez = e / (EX * EY);
    const int x = min(max(bx + ex - 1, 0), W - 1);
    const int y = min(max(by + ey - 1, 0), H - 1);
    const int z = min(max(bz + ez - 1, 0), D - 1);
    const float w = warp_at<kCubic>(i1, flow, z, y, x, D, H, W, N);
    s_warp[ez][ey][ex] = w;
    s_bar[ez][ey][ex] = 0.5f * (i0[((long long)z * H + y) * W + x] + w);
  }
  __syncthreads();

  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ex = threadIdx.x + 1, ey = threadIdx.y + 1;
  for (int tz = 0; tz < TZ && bz + tz < D; ++tz) {
    const int ez = tz + 1;
    const long long v = ((long long)(bz + tz) * H + y) * W + x;
    g[v] = 0.5f * (s_bar[ez + 1][ey][ex] - s_bar[ez - 1][ey][ex]);
    g[N + v] = 0.5f * (s_bar[ez][ey + 1][ex] - s_bar[ez][ey - 1][ex]);
    g[2 * N + v] = 0.5f * (s_bar[ez][ey][ex + 1] - s_bar[ez][ey][ex - 1]);
    it[v] = s_warp[ez][ey][ex] - i0[v];
    if (i1w != nullptr) i1w[v] = s_warp[ez][ey][ex];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// i1w may be null (no warped volume wanted); cubic != 0 selects K5.
extern "C" int tf3d_warp_grad(const float* i1, const float* flow,
                              const float* i0, float* g, float* it,
                              float* i1w, int D, int H, int W, int cubic,
                              void* stream) {
  if ((long long)D * H * W == 0) return 0;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, (D + TZ - 1) / TZ);
  if (cubic) {
    warp_grad_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        i1, flow, i0, g, it, i1w, D, H, W);
  } else {
    warp_grad_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        i1, flow, i0, g, it, i1w, D, H, W);
  }
  return (int)cudaGetLastError();
}
