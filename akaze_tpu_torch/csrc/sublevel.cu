// K1: the nonlinear scale space, as two kernels.
//
// Replaces akaze_tpu/ops/pallas_sublevel.py:fused_sublevel_batch (and
// fused_sublevel, its B = 1 case); kernel body there: _make_kernel.
//
// Per sublevel the plain PyTorch version (ops/sublevel.py) runs some 40
// stencil passes over whole planes: sigma-1 smooth, Scharr flow, one pass
// per FED step (up to 29 at 960x1280, 57 at five octaves), scaled first
// derivatives and the Hessian, each reading and writing device memory.
// What K1 must move is each launch's input plane and its four result
// planes (L, det, Lx, Ly): about 264 MB per 960x1280 pair, 79 us at
// 3.35 TB/s.  Both kernels read the input once and write each result
// once, straight into the octave's stacked [4, B, S, H, W] planes
// (strided batch pointers).
//
// tiled_kernel: one sublevel per launch, for octaves too large for one
// cluster's shared memory.  Each block loads a 64x32 output tile plus the
// stencil halo of `src` (and of `smooth`, when the octave start supplies
// it) into shared memory once and runs every stage there:
//
//   smooth (radius-r Gaussian, or the given one) -> flow g(ikc |Scharr|^2)
//   -> FED chain (ping-pong buffers; the valid region shrinks one ring per
//   step) -> Lx, Ly at stride `step` -> det = Lxx Lyy - Lxy^2.
//
// It is bound by the redundant work on the halo (at halo 8 the extended
// tile is 1.9x the output tile) and by instruction issue.  A launch's halo
// is capped at MAX_HALO, which keeps a block inside the shared memory one
// block may use; a longer FED chain is split by the wrapper into launches
// that continue the chain from the previous launch's L (`L_in`, with the
// flow recomputed from `src`/`smooth`); only the first writes Lx, Ly and
// det.  Borders are reflect-101 through a mirror index: L, Lx and Ly equal
// the plain version everywhere; det equals it on the interior (within
// 2*step+2 px of the border det sees the analytic continuation of Lx/Ly
// where the plain version reflects the derivative plane).
//
// octave_kernel: a whole octave (every sublevel) per launch, for small
// octaves (ops/sublevel.py routes_resident) whose four working planes
// (cur, nxt, flow, smooth) fit one thread-block cluster's shared memory.
// One cluster of 16 CTAs per image; CTA r holds rows [r*rows, (r+1)*rows)
// of every plane plus halo rows above and below.  After a cluster.sync()
// ends a stage, each CTA copies the halo rows the next stage reads from
// the bands that own them (distributed shared memory,
// cluster.map_shared_rank; reflected at the plane border), then runs the
// stage on plain shared memory.  The FED chain exchanges halos once per
// FED_DEPTH steps and recomputes the halo rows in between (temporal
// blocking), with the barrier split so that the wait overlaps a step.
// Nothing is recomputed across sublevels, no chain is ever split, and
// every stage reflects at the plane's own border as the plain version
// does, so all four planes, det included, equal the plain version on the
// whole plane.  It is bound by the latency of its serial steps (about 100
// FED steps at 120x160, each a few shared-memory round trips and a block
// barrier) on the 32 SMs a pair uses, not by bytes.
//
// Two flavours, one body templated on the plane type T (Flavour<T>):
// float32, and the 16.16 fixed point of the reference's fast path (int32
// planes; the Gaussian, Scharr, FED step and derivatives in integers with
// an arithmetic >> 16 after each weighted sum; the conductivity in float,
// stored int(g * 65536 + 0.5); akazed.cu:3406-3473).  The fixed flavour
// sums and multiplies in uint32 and converts back, so that its int32
// arithmetic wraps as XLA's does (signed overflow is undefined in C++, and
// a long FED step's factor times its neighbourhood sum does overflow).
//
// Expression order follows ops/conv.py, ops/diffusion.py and
// ops/scharr.py; built with --fmad=false (see _build.py).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_X = 64;
constexpr int TILE_Y = 32;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 16;
constexpr int MAX_HALO = 32;     // ops/sublevel.py MAX_HALO
constexpr int MAX_TAUS = MAX_HALO;
constexpr int MAX_RADIUS = 5;
constexpr int MAX_SCALES = 8;    // ops/sublevel.py MAX_SCALES
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 16;

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
  __device__ static float bits(int v) { return __int_as_float(v); }
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
  __device__ static int bits(int v) { return v; }
  // one FED step; c = the 16.16 step factor:
  // ((c * (s >> 16)) >> 16) + ic
  __device__ static int fed(int ic, int c, unsigned s) {
    const unsigned prod =
        static_cast<unsigned>(c) * static_cast<unsigned>(out(s));
    return static_cast<int>(static_cast<unsigned>(out(prod)) +
                            static_cast<unsigned>(ic));
  }
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

// cudaFuncSetAttribute once per (kernel, device, larger shared memory size)
template <typename K>
cudaError_t allow_smem(K kernel, int* have, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (have[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have[dev] = bytes;
  return e;
}

// ---------------------------------------------------------------------------
// tiled_kernel: one sublevel
// ---------------------------------------------------------------------------

// Built once per sublevel by the wrapper (ops/sublevel.py TiledParams):
// 4-byte words; factor and kern hold the bits of the plane type.
struct TiledParams {
  int fixed, H, W, halo, step, diffusivity, first_sublevel, write_derivs,
      ntaus, radius;
  int factor[MAX_TAUS];      // each FED step's factor: 0.5 * tau, or 16.16
  int kern[MAX_RADIUS + 1];  // half Gaussian [k0..kr], float32 or 16.16
};

// Batch strides (elements) of the arrays of one launch.
struct Strides {
  long long src, smooth, L_in, L, out;
};

template <typename T>
__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
tiled_kernel(const TiledParams a, const Strides bs, const T* __restrict__ src,
             const T* __restrict__ smooth_in, const T* __restrict__ L_in,
             const float* __restrict__ ikc, T* __restrict__ L,
             T* __restrict__ det, T* __restrict__ lx, T* __restrict__ ly) {
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
  // the chain starts from src, or from L_in when it continues a chain;
  // the smooth comes from outside or is taken of src (bufA or bufB)
  const T* startb = L_in ? L_in + b * bs.L_in : src + b * bs.src;
  const T* smb = smooth_in ? smooth_in + b * bs.smooth : nullptr;
  const T* srcb = (L_in && !smb) ? src + b * bs.src : nullptr;
  const T* sbuf = srcb ? bufB : bufA;

  // asynchronous copies (cp.async): every element's load is in flight at
  // once instead of one load round trip per element and thread
  for (int ey = ty; ey < EH; ey += THREADS_Y) {
    const size_t row = static_cast<size_t>(mirror_index(oy - halo + ey, a.H)) * a.W;
    for (int ex = tx; ex < EW; ex += THREADS_X) {
      const int gx = mirror_index(ox - halo + ex, a.W);
      __pipeline_memcpy_async(bufA + ey * EW + ex, startb + row + gx,
                              sizeof(T));
      if (smb)
        __pipeline_memcpy_async(bufS + ey * EW + ex, smb + row + gx,
                                sizeof(T));
      if (srcb)
        __pipeline_memcpy_async(bufB + ey * EW + ex, srcb + row + gx,
                                sizeof(T));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // invalid margin (px from the extended tile's edge) of each stage
  int ms = 0;
  if (!smb) {
    const int r = a.radius;
    T kk[MAX_RADIUS + 1];
#pragma unroll
    for (int i = 0; i <= MAX_RADIUS; ++i) kk[i] = F::bits(a.kern[i]);
    for (int ey = ty; ey < EH; ey += THREADS_Y) {
      for (int ex = r + tx; ex < EW - r; ex += THREADS_X) {
        const T* p = sbuf + ey * EW + ex;
        A v = w(kk[0]) * w(p[0]);
#pragma unroll
        for (int i = 1; i <= MAX_RADIUS; ++i)
          if (i <= r) v = v + w(kk[i]) * (w(p[-i]) + w(p[i]));
        bufF[ey * EW + ex] = F::out(v);
      }
    }
    __syncthreads();
    for (int ey = r + ty; ey < EH - r; ey += THREADS_Y) {
      for (int ex = r + tx; ex < EW - r; ex += THREADS_X) {
        const T* p = bufF + ey * EW + ex;
        A v = w(kk[0]) * w(p[0]);
#pragma unroll
        for (int i = 1; i <= MAX_RADIUS; ++i)
          if (i <= r) v = v + w(kk[i]) * (w(p[-i * EW]) + w(p[i * EW]));
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
      const T c = F::bits(a.factor[k]);
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

  T* Lb = L + b * bs.L;
  for (int y = ty; y < TILE_Y && oy + y < a.H; y += THREADS_Y) {
    for (int x = tx; x < TILE_X && ox + x < a.W; x += THREADS_X) {
      Lb[static_cast<size_t>(oy + y) * a.W + ox + x] =
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

  const size_t ob = b * bs.out;
  for (int y = ty; y < TILE_Y && oy + y < a.H; y += THREADS_Y) {
    for (int x = tx; x < TILE_X && ox + x < a.W; x += THREADS_X) {
      const int i = (y + halo) * EW + x + halo;
      const size_t g = ob + static_cast<size_t>(oy + y) * a.W + ox + x;
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
int launch_tiled(const TiledParams& a, const Strides& bs, const void* src,
                 const void* smooth, const void* L_in, const float* ikc,
                 void* L, void* det, void* lx, void* ly, int B,
                 cudaStream_t stream) {
  static int have[MAX_DEVICES] = {};
  const size_t EW = TILE_X + 2 * a.halo;
  const size_t EH = TILE_Y + 2 * a.halo;
  const int bytes = static_cast<int>(4 * EW * EH * sizeof(T));
  cudaError_t e = allow_smem(tiled_kernel<T>, have, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.W + TILE_X - 1) / TILE_X, (a.H + TILE_Y - 1) / TILE_Y, B);
  const dim3 block(THREADS_X, THREADS_Y);
  tiled_kernel<T><<<grid, block, bytes, stream>>>(
      a, bs, static_cast<const T*>(src), static_cast<const T*>(smooth),
      static_cast<const T*>(L_in), ikc, static_cast<T*>(L),
      static_cast<T*>(det), static_cast<T*>(lx), static_cast<T*>(ly));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// octave_kernel: every sublevel of one octave, the octave resident in one
// cluster's shared memory
// ---------------------------------------------------------------------------

// Built once per octave by the wrapper (ops/sublevel.py OctaveParams).
struct OctaveParams {
  int fixed, H, W, S, diffusivity, first_sublevel;
  int reach;                 // halo rows: the largest step or radius, and
                             // at least FED_DEPTH
  int total_taus;            // FED steps of the octave
  int step[MAX_SCALES];
  int ntaus[MAX_SCALES];
  int tau_off[MAX_SCALES];   // first factor of each sublevel in `factors`
  int radius[MAX_SCALES];    // in-kernel smooth of each sublevel
  int kern[MAX_SCALES][MAX_RADIUS + 1];   // bits of the plane type
};

constexpr int FED_DEPTH = 4; // FED steps per halo exchange (ops/sublevel.py)
constexpr int NT = THREADS_X * THREADS_Y;

// The two halves of cluster.sync(), so that work can run between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// reflect-101 of i in [-n + 1, 2n - 2] into [0, n)
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Each CTA holds, per plane, its `rows` band rows plus `hr` halo rows above
// and below (pitch W).  fill_halo copies the `reach` halo rows on each
// side from the bands that own them (reflected at the plane border): a
// neighbour's shared memory through DSMEM, or the CTA's own band.  Every
// thread first loads up to HALO_BATCH elements and then stores them, so
// the DSMEM round trips overlap.  The owners' bands must be complete (a
// cluster.sync() before); the caller syncs the block after.
constexpr int HALO_BATCH = 4;

template <typename T>
__device__ __forceinline__ void fill_halo(cg::cluster_group& cl, T* buf,
                                          int reach, int y0, int ny, int H,
                                          int rows, int hr, int rank, int W) {
  if (ny == 0) return;   // a CTA past the plane's last row
  const int total = 2 * reach * W;
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  for (int e0 = tid; e0 < total; e0 += HALO_BATCH * NT) {
    T v[HALO_BATCH];
    T* to[HALO_BATCH];
#pragma unroll
    for (int u = 0; u < HALO_BATCH; ++u) {
      const int e = e0 + u * NT;
      to[u] = nullptr;
      if (e < total) {
        const int j = e / W;
        const int x = e - j * W;
        const int gy = j < reach ? y0 - reach + j : y0 + ny + j - reach;
        const int sy = reflect(gy, H);
        const int owner = sy / rows;
        const T* from = owner == rank ? buf : cl.map_shared_rank(buf, owner);
        v[u] = from[(hr + sy - owner * rows) * W + x];
        to[u] = buf + (hr + gy - y0) * W + x;
      }
    }
#pragma unroll
    for (int u = 0; u < HALO_BATCH; ++u)
      if (to[u]) *to[u] = v[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
octave_kernel(const OctaveParams p, const T* __restrict__ src,
              long long src_bs, const T* __restrict__ smooth_in,
              long long smooth_bs, const float* __restrict__ ikc,
              const T* __restrict__ factors, T* __restrict__ out, int B) {
  using F = Flavour<T>;
  using A = typename F::A;
  auto w = [](T v) { return static_cast<A>(v); };

  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / C;
  const int H = p.H;
  const int W = p.W;
  const int hr = p.reach;
  const int rows = (H + C - 1) / C;
  const int y0 = rank * rows;
  const int ny = max(0, min(rows, H - y0));   // rows this CTA owns
  const int n = (rows + 2 * hr) * W;          // one plane's buffer

  // each pointer is the plane's band row 0; rows -hr..-1 and ny..ny+hr-1
  // are its halo
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw) + hr * W;   // the chain; L
  T* nxt = cur + n;                    // FED pong, row-pass scratch, Ly
  T* flo = cur + 2 * n;                // flow, Lx
  T* sm = cur + 3 * n;                 // smooth
  // every FED factor of the octave, read once from device memory
  T* sfac = reinterpret_cast<T*>(smem_raw) + 4 * n;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * THREADS_X + tx;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t kstride = static_cast<size_t>(B) * p.S * plane;
  // this CTA's rows of image b, sublevel 0, plane L of [4, B, S, H, W]
  T* const outb = out + static_cast<size_t>(b) * p.S * plane +
                  static_cast<size_t>(y0) * W;
  const float kc = ikc[b];
  const A f1 = F::fac1();
  const A f2 = F::fac2();
  auto halo = [&](T* buf, int reach) {
    fill_halo(cl, buf - hr * W, reach, y0, ny, H, rows, hr, rank, W);
  };

  const T* srcb = src + b * src_bs + static_cast<size_t>(y0) * W;
  const T* smb = smooth_in
      ? smooth_in + b * smooth_bs + static_cast<size_t>(y0) * W : nullptr;
  for (int y = ty; y < ny; y += THREADS_Y)
    for (int x = tx; x < W; x += THREADS_X) {
      __pipeline_memcpy_async(cur + y * W + x, srcb + y * W + x, sizeof(T));
      if (smb)
        __pipeline_memcpy_async(sm + y * W + x, smb + y * W + x, sizeof(T));
    }
  for (int i = tid; i < p.total_taus; i += NT)
    __pipeline_memcpy_async(sfac + i, factors + i, sizeof(T));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  cl.sync();

  for (int s = 0; s < p.S; ++s) {
    if (!(s == 0 && smb)) {
      // smooth of cur: row pass into nxt, column pass into sm
      const int r = p.radius[s];
      T kk[MAX_RADIUS + 1];
#pragma unroll
      for (int i = 0; i <= MAX_RADIUS; ++i) kk[i] = F::bits(p.kern[s][i]);
      for (int y = ty; y < ny; y += THREADS_Y) {
        const T* q = cur + y * W;
        for (int x = tx; x < W; x += THREADS_X) {
          A v = w(kk[0]) * w(q[x]);
#pragma unroll
          for (int i = 1; i <= MAX_RADIUS; ++i)
            if (i <= r)
              v = v + w(kk[i]) * (w(q[reflect(x - i, W)]) +
                                  w(q[reflect(x + i, W)]));
          nxt[y * W + x] = F::out(v);
        }
      }
      cl.sync();
      halo(nxt, r);
      __syncthreads();
      for (int y = ty; y < ny; y += THREADS_Y) {
        const T* q = nxt + y * W;
        for (int x = tx; x < W; x += THREADS_X) {
          A v = w(kk[0]) * w(q[x]);
#pragma unroll
          for (int i = 1; i <= MAX_RADIUS; ++i)
            if (i <= r)
              v = v + w(kk[i]) * (w(q[x - i * W]) + w(q[x + i * W]));
          sm[y * W + x] = F::out(v);
        }
      }
      cl.sync();
    }

    // Lx into flo, Ly into nxt, both out
    const int st = p.step[s];
    const int so = st * W;
    halo(sm, max(st, 1));
    __syncthreads();
    T* const olx = outb + 2 * kstride + s * plane;
    T* const oly = outb + 3 * kstride + s * plane;
    for (int y = ty; y < ny; y += THREADS_Y) {
      const T* q = sm + y * W;
      for (int x = tx; x < W; x += THREADS_X) {
        const int xm = reflect(x - st, W);
        const int xp = reflect(x + st, W);
        const T vx = F::out(
            f1 * (w(q[xp - so]) + w(q[xp + so]) - w(q[xm - so]) -
                  w(q[xm + so]))
            + f2 * (w(q[xp]) - w(q[xm])));
        const T vy = F::out(
            f1 * (w(q[xp + so]) + w(q[xm + so]) - w(q[xp - so]) -
                  w(q[xm - so]))
            + f2 * (w(q[x + so]) - w(q[x - so])));
        flo[y * W + x] = vx;
        nxt[y * W + x] = vy;
        olx[y * W + x] = vx;
        oly[y * W + x] = vy;
      }
    }
    cl.sync();

    // det from Lx (flo) and Ly (nxt), reflected at the plane border
    halo(flo, st);
    halo(nxt, st);
    __syncthreads();
    T* const odet = outb + kstride + s * plane;
    for (int y = ty; y < ny; y += THREADS_Y) {
      const T* X = flo + y * W;
      const T* Y = nxt + y * W;
      for (int x = tx; x < W; x += THREADS_X) {
        const int cm = reflect(x - st, W);
        const int cp = reflect(x + st, W);
        const T dxx = F::out(
            f1 * (w(X[cp - so]) + w(X[cp + so]) - w(X[cm - so]) -
                  w(X[cm + so]))
            + f2 * (w(X[cp]) - w(X[cm])));
        const T dxy = F::out(
            f1 * (w(X[cp + so]) + w(X[cm + so]) - w(X[cp - so]) -
                  w(X[cm - so]))
            + f2 * (w(X[x + so]) - w(X[x - so])));
        const T dyy = F::out(
            f1 * (w(Y[cp + so]) + w(Y[cm + so]) - w(Y[cp - so]) -
                  w(Y[cm - so]))
            + f2 * (w(Y[x + so]) - w(Y[x - so])));
        odet[y * W + x] = static_cast<T>(w(dxx) * w(dyy) - w(dxy) * w(dxy));
      }
    }
    cl.sync();   // every CTA is done with the flo and nxt bands

    const int nt = p.ntaus[s];
    if (nt > 0) {
      for (int y = ty; y < ny; y += THREADS_Y) {
        const T* q = sm + y * W;
        for (int x = tx; x < W; x += THREADS_X) {
          const int xm = reflect(x - 1, W);
          const int xp = reflect(x + 1, W);
          const A gx = w(10) * (w(q[xp]) - w(q[xm]))
              + w(3) * (w(q[xp - W]) + w(q[xp + W]) - w(q[xm - W])
                        - w(q[xm + W]));
          const A gyv = w(10) * (w(q[x + W]) - w(q[x - W]))
              + w(3) * (w(q[xm + W]) + w(q[xp + W]) - w(q[xm - W])
                        - w(q[xp - W]));
          const float m2 =
              static_cast<float>(static_cast<T>(gx * gx + gyv * gyv));
          flo[y * W + x] = F::flow(flow_from_dif2(kc * m2, p.diffusivity));
        }
      }
      // The FED chain in blocks of up to D steps per halo exchange: after
      // an exchange cur holds D valid halo rows, and step j of a block of
      // d computes rows [-(d - j), ny + d - j), so the halo's valid depth
      // shrinks one row per step and the block's last step leaves the
      // band itself.  A halo row inside the plane is a neighbour's row,
      // computed with the same arithmetic; one past the plane's border is
      // copied from its reflection after each step, as the plain
      // version's reflect padding has it.
      cl.sync();
      const int D = min(FED_DEPTH, hr);
      halo(flo, D);
      halo(cur, min(D, nt));
      __syncthreads();
      // split barrier: arrive once done reading the neighbours' bands,
      // wait before overwriting the band they may still be copying
      cluster_arrive();
      bool pending = true;
      const T* fac = sfac + p.tau_off[s];
      T c = fac[0];
      for (int k0 = 0; k0 < nt; k0 += D) {
        const int d = min(D, nt - k0);
        for (int j = 1; j <= d; ++j) {
          const T cn = fac[min(k0 + j, nt - 1)];
          if (j == 2 && pending) {
            cluster_wait();
            pending = false;
          }
          // rows [lo, hi) of this step; those inside the plane,
          // [clo, chi), are computed, those past its border reflected
          const int lo = j - d;
          const int hi = ny + d - j;
          const int clo = max(lo, -y0);
          const int chi = min(hi, H - y0);
          for (int y = clo + ty; y < chi; y += THREADS_Y) {
            const int i = y * W;
#pragma unroll 4
            for (int x = tx; x < W; x += THREADS_X) {
              const int xm = x > 0 ? x - 1 : 1;
              const int xp = x < W - 1 ? x + 1 : W - 2;
              const T cC = cur[i + x];
              const A fc = w(flo[i + x]);
              const A sum = (fc + w(flo[i + xp])) * (w(cur[i + xp]) - w(cC))
                  + (fc + w(flo[i + xm])) * (w(cur[i + xm]) - w(cC))
                  + (fc + w(flo[i + W + x])) * (w(cur[i + W + x]) - w(cC))
                  + (fc + w(flo[i - W + x])) * (w(cur[i - W + x]) - w(cC));
              nxt[i + x] = F::fed(cC, c, sum);
            }
          }
          __syncthreads();
          if (ny && (clo > lo || chi < hi)) {
            // the reflected rows: copies of rows computed above, exactly
            // what the plain version's reflect padding reads
            for (int e = tid; e < (clo - lo + hi - chi) * W; e += NT) {
              const int r = e / W;
              const int x = e - r * W;
              const int y = r < clo - lo ? lo + r : chi + r - (clo - lo);
              nxt[y * W + x] = nxt[(reflect(y0 + y, H) - y0) * W + x];
            }
            __syncthreads();
          }
          T* t = cur;
          cur = nxt;
          nxt = t;
          c = cn;
        }
        if (pending) {
          cluster_wait();
          pending = false;
        }
        if (k0 + d < nt) {
          cl.sync();   // every band of this block's result is complete
          halo(cur, min(D, nt - k0 - d));
          __syncthreads();
          cluster_arrive();
          pending = true;
        }
      }
    } else if (s == 0 && p.first_sublevel) {
      // L = the base smooth (no diffusion)
      for (int y = ty; y < ny; y += THREADS_Y)
        for (int x = tx; x < W; x += THREADS_X) cur[y * W + x] = sm[y * W + x];
      __syncthreads();
    }

    T* const oL = outb + s * plane;
    for (int y = ty; y < ny; y += THREADS_Y)
      for (int x = tx; x < W; x += THREADS_X) oL[y * W + x] = cur[y * W + x];
  }
  // every read of a neighbour's shared memory lies before this barrier
  cl.sync();
}

template <typename T>
int launch_octave(const OctaveParams& p, const void* src, long long src_bs,
                  const void* smooth, long long smooth_bs, const float* ikc,
                  const void* factors, void* out, int B, int cluster,
                  cudaStream_t stream) {
  static int have[MAX_DEVICES] = {};
  static bool nonportable[MAX_DEVICES] = {};
  const int rows = (p.H + cluster - 1) / cluster;
  const int bytes = static_cast<int>(
      sizeof(T) * (4 * (rows + 2 * p.reach) * p.W + p.total_taus));
  cudaError_t e = allow_smem(octave_kernel<T>, have, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cluster > 8) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!nonportable[dev]) {
      e = cudaFuncSetAttribute(octave_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
      if (e != cudaSuccess) return static_cast<int>(e);
      nonportable[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * B, 1, 1);
  cfg.blockDim = dim3(THREADS_X, THREADS_Y, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, octave_kernel<T>, p,
                         static_cast<const T*>(src), src_bs,
                         static_cast<const T*>(smooth), smooth_bs, ikc,
                         static_cast<const T*>(factors), static_cast<T*>(out),
                         B);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One sublevel on the tiled kernel.  params: a host TiledParams (its
// factor/kern words hold float32 or int32 bits per `fixed`).  src, smooth
// (or NULL), L_in (or NULL), L, det, lx, ly: device planes of [H, W] per
// image, each with its own batch stride (elements) in `strides` (src,
// smooth, L_in, L, and one for det/lx/ly); L distinct from L_in.  ikc:
// [B] float32.  det/lx/ly are written only when write_derivs.
extern "C" int akaze_sublevel(const void* params, const void* strides,
                              const void* src, const void* smooth,
                              const void* L_in, const float* ikc, void* L,
                              void* det, void* lx, void* ly, int B,
                              void* stream) {
  const TiledParams& a = *static_cast<const TiledParams*>(params);
  const int halo = a.halo;
  if (B < 1 || B > 65535 || a.ntaus < 0 || a.ntaus > MAX_TAUS ||
      a.radius < 0 || a.radius > MAX_RADIUS || a.step < 1 ||
      halo > MAX_HALO || (a.write_derivs && halo < 2 * a.step + a.radius) ||
      halo < a.ntaus + a.radius + 1 || a.H <= halo || a.W <= halo ||
      L == L_in)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides& bs = *static_cast<const Strides*>(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.fixed)
    return launch_tiled<int>(a, bs, src, smooth, L_in, ikc, L, det, lx, ly, B,
                             s);
  return launch_tiled<float>(a, bs, src, smooth, L_in, ikc, L, det, lx, ly, B,
                             s);
}

// Every sublevel of one octave on the octave-resident kernel, one cluster
// of `cluster` CTAs per image.  params: a host OctaveParams.  src: [H, W]
// per image at batch stride src_bs; smooth (or NULL: computed) likewise;
// ikc: [B] float32; factors: DEVICE array of every FED step's factor in
// the plane type; out: [4, B, S, H, W] (L, det, Lx, Ly).
extern "C" int akaze_octave(const void* params, const void* src,
                            long long src_bs, const void* smooth,
                            long long smooth_bs, const float* ikc,
                            const void* factors, void* out, int B,
                            int cluster, void* stream) {
  const OctaveParams& p = *static_cast<const OctaveParams*>(params);
  if (B < 1 || cluster < 1 || cluster > MAX_CLUSTER || p.S < 1 ||
      p.S > MAX_SCALES || p.H < 2 || p.W < 2 ||
      static_cast<long long>(B) * cluster > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.reach < 1 || p.reach >= p.H || p.reach >= p.W || p.total_taus < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < p.S; ++s)
    if (p.radius[s] < 0 || p.radius[s] > MAX_RADIUS || p.step[s] < 1 ||
        p.step[s] > p.reach || p.radius[s] > p.reach || p.ntaus[s] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.fixed)
    return launch_octave<int>(p, src, src_bs, smooth, smooth_bs, ikc, factors,
                              out, B, cluster, s);
  return launch_octave<float>(p, src, src_bs, smooth, smooth_bs, ikc, factors,
                              out, B, cluster, s);
}
