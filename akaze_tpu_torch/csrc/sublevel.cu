// K1: one whole nonlinear scale-space sublevel per launch.
//
// Replaces akaze_tpu/ops/pallas_sublevel.py:fused_sublevel_batch (and
// fused_sublevel, its B = 1 case); kernel body there: _make_kernel.
//
// Per sublevel the plain PyTorch version (ops/sublevel.py) runs some 40
// stencil passes over whole planes: sigma-1 smooth, Scharr flow, one pass
// per FED step (up to 29), scaled first derivatives and the Hessian, each
// reading and writing device memory.  The work per pixel is a few hundred
// flops, so the plain version is bound by device-memory traffic.  Here
// each block loads its output tile plus the stencil halo of `src` (and of
// `smooth`, when the octave start supplies it) into shared memory ONCE,
// runs every stage there, and writes only the four result planes:
//
//   smooth (radius-r Gaussian, or the given one) -> flow g(ikc |Scharr|^2)
//   -> FED chain (ping-pong buffers; the valid region shrinks one ring per
//   step) -> Lx, Ly at stride `step` -> det = Lxx Lyy - Lxy^2.
//
// What bounds it now is the redundant halo work (a 32x32 tile carries up
// to 32 px of halo on each side at the smallest octave) and one block per
// SM at the largest halo (4 buffers of 96x96 f32 = 147 KB of shared
// memory); the full-resolution octave, where the time goes, has halos of
// 8-10 px and 43-53 KB blocks.
//
// A launch's halo is capped at MAX_HALO, which keeps a block inside the
// shared memory one block may use.  A FED chain too long for that (octaves
// past the fourth of large images) is split by the wrapper into launches
// that continue the chain from the previous launch's L (`L_in`, with the
// flow recomputed from `src`/`smooth`); only the first writes Lx, Ly and
// det, which do not depend on the chain.
//
// Borders are reflect-101 through a mirror index; no padded copy is made.
// The halo holds the mirrored field, and diffusing a mirrored field evolves
// it exactly like the reflect-indexed computation, so L, Lx and Ly equal
// the plain version everywhere.  det equals it on the interior: within
// 2*step+2 px of the border det sees the analytic continuation of Lx/Ly,
// where the plain version reflects the derivative plane (an odd function,
// so its sign flips).  That band lies inside the extrema border.
//
// Expression order follows ops/conv.py, ops/diffusion.py and
// ops/scharr.py; built with --fmad=false (see _build.py).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 32;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int MAX_HALO = 32;     // ops/sublevel.py MAX_HALO
constexpr int MAX_TAUS = MAX_HALO;
constexpr int MAX_RADIUS = 5;
constexpr float FAC1 = 0.09375f;   // SCHARR_FAC1
constexpr float FAC2 = 0.3125f;    // SCHARR_FAC2

struct SublevelArgs {
  int B, H, W;
  int halo;            // stencil reach of the sublevel, px
  int step;            // sigma_size: stride of the derivative stencils
  int diffusivity;     // config.Diffusivity
  int first_sublevel;  // L = the smooth (base lowpass of the first sublevel)
  int write_derivs;    // write Lx, Ly and det (the first launch of a chain)
  int smooth_outside;  // smooth given (octave start), not computed
  int ntaus;
  int radius;          // radius of the in-kernel smooth
  float half_tau[MAX_TAUS];     // 0.5 * tau of each FED step, float32
  float kern[MAX_RADIUS + 1];   // half Gaussian [k0..kr], float32
};

__device__ __forceinline__ float flow_from_dif2(float d, int diffusivity) {
  switch (diffusivity) {
    case 0:  // PM_G1
      return expf(-d);
    case 1:  // PM_G2
      return 1.0f / (1.0f + d);
    case 2: {  // WEICKERT
      const float d2 = d * d;
      return 1.0f - expf(-0x1.a851ecp+1f / (d2 * d2));   // -3.315f
    }
    default:  // CHARBONNIER
      return 1.0f / sqrtf(1.0f + d);
  }
}

__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
sublevel_kernel(const SublevelArgs a, const float* __restrict__ src,
                const float* __restrict__ smooth_in,
                const float* __restrict__ L_in,
                const float* __restrict__ ikc, float* __restrict__ L,
                float* __restrict__ det, float* __restrict__ lx,
                float* __restrict__ ly) {
  extern __shared__ float smem[];
  const int halo = a.halo;
  const int EW = TILE_X + 2 * halo;   // extended tile: output tile + halo
  const int EH = TILE_Y + 2 * halo;
  const int ES = EW * EH;
  float* bufA = smem;                 // start of the chain, FED ping; later Ly
  float* bufB = smem + ES;            // src of a continued chain; FED pong
  float* bufF = smem + 2 * ES;        // row-pass scratch, flow; later Lx
  float* bufS = smem + 3 * ES;        // smooth

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * TILE_X;     // image origin of the output tile
  const int oy = blockIdx.y * TILE_Y;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  // the chain starts from src, or from L_in when it continues a chain;
  // the smooth comes from outside or is taken of src (bufA or bufB)
  const float* startb = (L_in ? L_in : src) + b * plane;
  const float* smb = a.smooth_outside ? smooth_in + b * plane : nullptr;
  const float* srcb = (L_in && !smb) ? src + b * plane : nullptr;
  const float* sbuf = srcb ? bufB : bufA;

  for (int ey = ty; ey < EH; ey += THREADS_Y) {
    const size_t row = static_cast<size_t>(mirror_index(oy - halo + ey, a.H)) * a.W;
    for (int ex = tx; ex < EW; ex += THREADS_X) {
      const int gx = mirror_index(ox - halo + ex, a.W);
      bufA[ey * EW + ex] = startb[row + gx];
      if (smb) bufS[ey * EW + ex] = smb[row + gx];
      if (srcb) bufB[ey * EW + ex] = srcb[row + gx];
    }
  }
  __syncthreads();

  // invalid margin (px from the extended tile's edge) of each stage
  int ms = 0;
  if (!a.smooth_outside) {
    const int r = a.radius;
    for (int ey = ty; ey < EH; ey += THREADS_Y) {
      for (int ex = r + tx; ex < EW - r; ex += THREADS_X) {
        const float* p = sbuf + ey * EW + ex;
        float v = a.kern[0] * p[0];
        for (int i = 1; i <= r; ++i) v = v + a.kern[i] * (p[-i] + p[i]);
        bufF[ey * EW + ex] = v;
      }
    }
    __syncthreads();
    for (int ey = r + ty; ey < EH - r; ey += THREADS_Y) {
      for (int ex = r + tx; ex < EW - r; ex += THREADS_X) {
        const float* p = bufF + ey * EW + ex;
        float v = a.kern[0] * p[0];
        for (int i = 1; i <= r; ++i)
          v = v + a.kern[i] * (p[-i * EW] + p[i * EW]);
        bufS[ey * EW + ex] = v;
      }
    }
    __syncthreads();
    ms = r;
  }

  const float* Lbuf = a.first_sublevel ? bufS : bufA;
  if (a.ntaus > 0) {
    const float kc = ikc[b];
    const int mf = ms + 1;
    for (int ey = mf + ty; ey < EH - mf; ey += THREADS_Y) {
      for (int ex = mf + tx; ex < EW - mf; ex += THREADS_X) {
        const float* p = bufS + ey * EW + ex;
        const float gx = 10.0f * (p[1] - p[-1])
            + 3.0f * (p[-EW + 1] + p[EW + 1] - p[-EW - 1] - p[EW - 1]);
        const float gy = 10.0f * (p[EW] - p[-EW])
            + 3.0f * (p[EW - 1] + p[EW + 1] - p[-EW - 1] - p[-EW + 1]);
        bufF[ey * EW + ex] = flow_from_dif2(kc * (gx * gx + gy * gy),
                                            a.diffusivity);
      }
    }
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    for (int k = 0; k < a.ntaus; ++k) {
      const int m = mf + 1 + k;
      const float c = a.half_tau[k];
      for (int ey = m + ty; ey < EH - m; ey += THREADS_Y) {
        for (int ex = m + tx; ex < EW - m; ex += THREADS_X) {
          const int i = ey * EW + ex;
          const float ic = cur[i];
          const float fc = bufF[i];
          const float s = (fc + bufF[i + 1]) * (cur[i + 1] - ic)
              + (fc + bufF[i - 1]) * (cur[i - 1] - ic)
              + (fc + bufF[i + EW]) * (cur[i + EW] - ic)
              + (fc + bufF[i - EW]) * (cur[i - EW] - ic);
          nxt[i] = ic + c * s;
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    Lbuf = cur;
  }

  for (int y = ty; y < TILE_Y && oy + y < a.H; y += THREADS_Y) {
    for (int x = tx; x < TILE_X && ox + x < a.W; x += THREADS_X) {
      L[b * plane + static_cast<size_t>(oy + y) * a.W + ox + x] =
          Lbuf[(y + halo) * EW + x + halo];
    }
  }
  if (!a.write_derivs) return;
  __syncthreads();   // L is out: bufA, bufB and bufF are free

  const int st = a.step;
  const int so = st * EW;
  float* bufX = bufF;
  float* bufY = bufA;
  const int md = halo - st;
  for (int ey = md + ty; ey < EH - md; ey += THREADS_Y) {
    for (int ex = md + tx; ex < EW - md; ex += THREADS_X) {
      const float* p = bufS + ey * EW + ex;
      bufX[ey * EW + ex] = FAC1 * (p[-so + st] + p[so + st] - p[-so - st]
                                   - p[so - st])
          + FAC2 * (p[st] - p[-st]);
      bufY[ey * EW + ex] = FAC1 * (p[so + st] + p[so - st] - p[-so + st]
                                   - p[-so - st])
          + FAC2 * (p[so] - p[-so]);
    }
  }
  __syncthreads();

  for (int y = ty; y < TILE_Y && oy + y < a.H; y += THREADS_Y) {
    for (int x = tx; x < TILE_X && ox + x < a.W; x += THREADS_X) {
      const int i = (y + halo) * EW + x + halo;
      const size_t g = b * plane + static_cast<size_t>(oy + y) * a.W + ox + x;
      const float* X = bufX + i;
      const float* Y = bufY + i;
      const float dxx = FAC1 * (X[-so + st] + X[so + st] - X[-so - st]
                                - X[so - st])
          + FAC2 * (X[st] - X[-st]);
      const float dxy = FAC1 * (X[so + st] + X[so - st] - X[-so + st]
                                - X[-so - st])
          + FAC2 * (X[so] - X[-so]);
      const float dyy = FAC1 * (Y[so + st] + Y[so - st] - Y[-so + st]
                                - Y[-so - st])
          + FAC2 * (Y[so] - Y[-so]);
      lx[g] = X[0];
      ly[g] = Y[0];
      det[g] = dxx * dyy - dxy * dxy;
    }
  }
}

}  // namespace

// src, smooth (or NULL), L_in (or NULL), L/det/lx/ly: [B, H, W] float32
// device arrays, L distinct from L_in; ikc: [B] float32 device array;
// half_taus [ntaus] and kern [radius + 1]: float32 HOST arrays, copied into
// the launch arguments.  det/lx/ly are written only when write_derivs.
extern "C" int akaze_sublevel(const float* src, const float* smooth,
                              const float* L_in, const float* ikc, float* L,
                              float* det, float* lx, float* ly, int B, int H,
                              int W, int halo, int step, int diffusivity,
                              int first_sublevel, int write_derivs,
                              int ntaus, const float* half_taus, int radius,
                              const float* kern, void* stream) {
  if (B < 1 || B > 65535 || ntaus < 0 || ntaus > MAX_TAUS || radius < 0 ||
      radius > MAX_RADIUS || step < 1 || halo > MAX_HALO ||
      (write_derivs && halo < 2 * step + radius) ||
      halo < ntaus + radius + 1 || H <= halo || W <= halo || L == L_in)
    return static_cast<int>(cudaErrorInvalidValue);
  SublevelArgs a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.halo = halo;
  a.step = step;
  a.diffusivity = diffusivity;
  a.first_sublevel = first_sublevel;
  a.write_derivs = write_derivs;
  a.smooth_outside = smooth != nullptr;
  a.ntaus = ntaus;
  a.radius = radius;
  for (int i = 0; i < ntaus; ++i) a.half_tau[i] = half_taus[i];
  for (int i = 0; i <= radius; ++i) a.kern[i] = kern[i];
  const size_t EW = TILE_X + 2 * halo;
  const size_t EH = TILE_Y + 2 * halo;
  const size_t bytes = 4 * EW * EH * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sublevel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, B);
  const dim3 block(THREADS_X, THREADS_Y);
  sublevel_kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
      a, src, smooth, L_in, ikc, L, det, lx, ly);
  return static_cast<int>(cudaGetLastError());
}
