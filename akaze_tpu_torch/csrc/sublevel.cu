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
// Two flavours, one body templated on the plane type T (Flavour<T>):
// float32, and the 16.16 fixed point of the reference's fast path (int32
// planes; the Gaussian, Scharr, FED step and derivatives in integers with
// an arithmetic >> 16 after each weighted sum; the conductivity in float,
// stored int(g * 65536 + 0.5); akazed.cu:3406-3473).  The fixed flavour
// sums and multiplies in uint32 and converts back, so that its int32
// arithmetic wraps as XLA's does (signed overflow is undefined in C++, and
// a long FED step's factor times its neighbourhood sum does overflow).
// int32 buffers are 4 bytes like float ones: tiling, halo and shared
// memory are the same for both.
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

// The arithmetic of each flavour.  A is the type a weighted stencil sum
// accumulates in; out() turns such a sum into a plane value.
template <typename T>
struct Flavour;

template <>
struct Flavour<float> {
  using A = float;
  __device__ static float fac1() { return 0.09375f; }   // SCHARR_FAC1
  __device__ static float fac2() { return 0.3125f; }    // SCHARR_FAC2
  __device__ static float out(float v) { return v; }
  __device__ static float flow(float g) { return g; }
  // one FED step; c = 0.5 * tau
  __device__ static float fed(float ic, float c, float s) {
    return ic + c * s;
  }
};

template <>
struct Flavour<int> {
  using A = unsigned;                                // wraps modulo 2^32
  __device__ static unsigned fac1() { return 6144u; }    // SCHARR_IFAC1
  __device__ static unsigned fac2() { return 20480u; }   // SCHARR_IFAC2
  __device__ static int out(unsigned v) { return static_cast<int>(v) >> 16; }
  // a float conductivity stored 16.16, truncated
  __device__ static int flow(float g) {
    return static_cast<int>(g * 65536.0f + 0.5f);
  }
  // one FED step; c = the 16.16 step factor:
  // ((c * (s >> 16)) >> 16) + ic
  __device__ static int fed(int ic, int c, unsigned s) {
    const unsigned prod =
        static_cast<unsigned>(c) * static_cast<unsigned>(out(s));
    return static_cast<int>(static_cast<unsigned>(out(prod)) +
                            static_cast<unsigned>(ic));
  }
};

template <typename T>
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
  T factor[MAX_TAUS];  // each FED step's factor: 0.5 * tau, or 16.16
  T kern[MAX_RADIUS + 1];   // half Gaussian [k0..kr], float32 or 16.16
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

template <typename T>
__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
sublevel_kernel(const SublevelArgs<T> a, const T* __restrict__ src,
                const T* __restrict__ smooth_in, const T* __restrict__ L_in,
                const float* __restrict__ ikc, T* __restrict__ L,
                T* __restrict__ det, T* __restrict__ lx,
                T* __restrict__ ly) {
  using F = Flavour<T>;
  using A = typename F::A;
  auto w = [](T v) { return static_cast<A>(v); };

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int halo = a.halo;
  const int EW = TILE_X + 2 * halo;   // extended tile: output tile + halo
  const int EH = TILE_Y + 2 * halo;
  const int ES = EW * EH;
  T* bufA = smem;                     // start of the chain, FED ping; later Ly
  T* bufB = smem + ES;                // src of a continued chain; FED pong
  T* bufF = smem + 2 * ES;            // row-pass scratch, flow; later Lx
  T* bufS = smem + 3 * ES;            // smooth

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * TILE_X;     // image origin of the output tile
  const int oy = blockIdx.y * TILE_Y;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  // the chain starts from src, or from L_in when it continues a chain;
  // the smooth comes from outside or is taken of src (bufA or bufB)
  const T* startb = (L_in ? L_in : src) + b * plane;
  const T* smb = a.smooth_outside ? smooth_in + b * plane : nullptr;
  const T* srcb = (L_in && !smb) ? src + b * plane : nullptr;
  const T* sbuf = srcb ? bufB : bufA;

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
        const T* p = sbuf + ey * EW + ex;
        A v = w(a.kern[0]) * w(p[0]);
        for (int i = 1; i <= r; ++i)
          v = v + w(a.kern[i]) * (w(p[-i]) + w(p[i]));
        bufF[ey * EW + ex] = F::out(v);
      }
    }
    __syncthreads();
    for (int ey = r + ty; ey < EH - r; ey += THREADS_Y) {
      for (int ex = r + tx; ex < EW - r; ex += THREADS_X) {
        const T* p = bufF + ey * EW + ex;
        A v = w(a.kern[0]) * w(p[0]);
        for (int i = 1; i <= r; ++i)
          v = v + w(a.kern[i]) * (w(p[-i * EW]) + w(p[i * EW]));
        bufS[ey * EW + ex] = F::out(v);
      }
    }
    __syncthreads();
    ms = r;
  }

  const T* Lbuf = a.first_sublevel ? bufS : bufA;
  if (a.ntaus > 0) {
    const float kc = ikc[b];
    const int mf = ms + 1;
    for (int ey = mf + ty; ey < EH - mf; ey += THREADS_Y) {
      for (int ex = mf + tx; ex < EW - mf; ex += THREADS_X) {
        const T* p = bufS + ey * EW + ex;
        const A gx = w(10) * (w(p[1]) - w(p[-1]))
            + w(3) * (w(p[-EW + 1]) + w(p[EW + 1]) - w(p[-EW - 1])
                      - w(p[EW - 1]));
        const A gy = w(10) * (w(p[EW]) - w(p[-EW]))
            + w(3) * (w(p[EW - 1]) + w(p[EW + 1]) - w(p[-EW - 1])
                      - w(p[-EW + 1]));
        const float m2 = static_cast<float>(static_cast<T>(gx * gx + gy * gy));
        bufF[ey * EW + ex] = F::flow(flow_from_dif2(kc * m2, a.diffusivity));
      }
    }
    __syncthreads();
    T* cur = bufA;
    T* nxt = bufB;
    for (int k = 0; k < a.ntaus; ++k) {
      const int m = mf + 1 + k;
      const T c = a.factor[k];
      for (int ey = m + ty; ey < EH - m; ey += THREADS_Y) {
        for (int ex = m + tx; ex < EW - m; ex += THREADS_X) {
          const int i = ey * EW + ex;
          const T ic = cur[i];
          const A fc = w(bufF[i]);
          const A s = (fc + w(bufF[i + 1])) * (w(cur[i + 1]) - w(ic))
              + (fc + w(bufF[i - 1])) * (w(cur[i - 1]) - w(ic))
              + (fc + w(bufF[i + EW])) * (w(cur[i + EW]) - w(ic))
              + (fc + w(bufF[i - EW])) * (w(cur[i - EW]) - w(ic));
          nxt[i] = F::fed(ic, c, s);
        }
      }
      __syncthreads();
      T* t = cur;
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
  const A f1 = F::fac1();
  const A f2 = F::fac2();
  T* bufX = bufF;
  T* bufY = bufA;
  const int md = halo - st;
  for (int ey = md + ty; ey < EH - md; ey += THREADS_Y) {
    for (int ex = md + tx; ex < EW - md; ex += THREADS_X) {
      const T* p = bufS + ey * EW + ex;
      bufX[ey * EW + ex] = F::out(
          f1 * (w(p[-so + st]) + w(p[so + st]) - w(p[-so - st]) - w(p[so - st]))
          + f2 * (w(p[st]) - w(p[-st])));
      bufY[ey * EW + ex] = F::out(
          f1 * (w(p[so + st]) + w(p[so - st]) - w(p[-so + st]) - w(p[-so - st]))
          + f2 * (w(p[so]) - w(p[-so])));
    }
  }
  __syncthreads();

  for (int y = ty; y < TILE_Y && oy + y < a.H; y += THREADS_Y) {
    for (int x = tx; x < TILE_X && ox + x < a.W; x += THREADS_X) {
      const int i = (y + halo) * EW + x + halo;
      const size_t g = b * plane + static_cast<size_t>(oy + y) * a.W + ox + x;
      const T* X = bufX + i;
      const T* Y = bufY + i;
      const T dxx = F::out(
          f1 * (w(X[-so + st]) + w(X[so + st]) - w(X[-so - st]) - w(X[so - st]))
          + f2 * (w(X[st]) - w(X[-st])));
      const T dxy = F::out(
          f1 * (w(X[so + st]) + w(X[so - st]) - w(X[-so + st]) - w(X[-so - st]))
          + f2 * (w(X[so]) - w(X[-so])));
      const T dyy = F::out(
          f1 * (w(Y[so + st]) + w(Y[so - st]) - w(Y[-so + st]) - w(Y[-so - st]))
          + f2 * (w(Y[so]) - w(Y[-so])));
      lx[g] = X[0];
      ly[g] = Y[0];
      det[g] = static_cast<T>(w(dxx) * w(dyy) - w(dxy) * w(dxy));
    }
  }
}

template <typename T>
int launch(const void* src, const void* smooth, const void* L_in,
           const float* ikc, void* L, void* det, void* lx, void* ly, int B,
           int H, int W, int halo, int step, int diffusivity,
           int first_sublevel, int write_derivs, int ntaus,
           const void* factors, int radius, const void* kern,
           cudaStream_t stream) {
  SublevelArgs<T> a{};
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
  const T* f = static_cast<const T*>(factors);
  const T* k = static_cast<const T*>(kern);
  for (int i = 0; i < ntaus; ++i) a.factor[i] = f[i];
  for (int i = 0; i <= radius; ++i) a.kern[i] = k[i];
  const size_t EW = TILE_X + 2 * halo;
  const size_t EH = TILE_Y + 2 * halo;
  const size_t bytes = 4 * EW * EH * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      sublevel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, B);
  const dim3 block(THREADS_X, THREADS_Y);
  sublevel_kernel<T><<<grid, block, bytes, stream>>>(
      a, static_cast<const T*>(src), static_cast<const T*>(smooth),
      static_cast<const T*>(L_in), ikc, static_cast<T*>(L),
      static_cast<T*>(det), static_cast<T*>(lx), static_cast<T*>(ly));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src, smooth (or NULL), L_in (or NULL), L/det/lx/ly: [B, H, W] device
// arrays of float32, or int32 when `fixed`; L distinct from L_in.  ikc:
// [B] float32 device array.  factors [ntaus] (0.5 * tau, or the 16.16 step
// factors) and kern [radius + 1]: HOST arrays of the planes' type, copied
// into the launch arguments.  det/lx/ly are written only when write_derivs.
extern "C" int akaze_sublevel(const void* src, const void* smooth,
                              const void* L_in, const float* ikc, void* L,
                              void* det, void* lx, void* ly, int B, int H,
                              int W, int halo, int step, int diffusivity,
                              int first_sublevel, int write_derivs,
                              int ntaus, const void* factors, int radius,
                              const void* kern, int fixed, void* stream) {
  if (B < 1 || B > 65535 || ntaus < 0 || ntaus > MAX_TAUS || radius < 0 ||
      radius > MAX_RADIUS || step < 1 || halo > MAX_HALO ||
      (write_derivs && halo < 2 * step + radius) ||
      halo < ntaus + radius + 1 || H <= halo || W <= halo || L == L_in)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed)
    return launch<int>(src, smooth, L_in, ikc, L, det, lx, ly, B, H, W, halo,
                       step, diffusivity, first_sublevel, write_derivs, ntaus,
                       factors, radius, kern, s);
  return launch<float>(src, smooth, L_in, ikc, L, det, lx, ly, B, H, W, halo,
                       step, diffusivity, first_sublevel, write_derivs, ntaus,
                       factors, radius, kern, s);
}
