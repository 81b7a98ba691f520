// Detection's full-map stages in one launch for a whole batch: per-scale
// extrema, the octave merge and the circular NMS.
//
// Replaces no TPU kernel.  The JAX package leaves these stages to XLA
// (akaze_tpu/detect.py build_extrema_maps and nms), which fuses their
// elementwise passes.  Their plain PyTorch form (detect.py, the twin that
// ops/detect.py runs on CPU tensors) launches ~1,170 kernels over whole
// maps for a 960x1280 pair: ~4 per offset for NMS's 80 offsets, and per
// octave 8 shifted compares, a border rectangle, a scale argmax and
// strided write-backs.  A trace of the pair path put those kernels at
// about a third of the pair's device time, ~100x above the bound below.
//
// What bounds it on the H100: bytes.  Each det stack is read once (~26 MB
// per 960x1280 image in float32) and three full-resolution maps are
// written once (resp and layer 4 bytes a pixel, the mask 1 byte; ~11 MB
// per image): ~74 MB a pair, 22 us at 3.35 TB/s.  The work is a few
// comparisons a pixel.
//
// The design: one CTA of 512 threads per TH x TW full-resolution output
// tile of one image.  Phase 1 computes, for each pixel of the tile and of
// its NMS halo of R = max_nms_radius pixels, what build_extrema_maps
// writes there, octave by octave: the CTA stages the octave's det stack
// under the tile and halo (one ring more, the min fill outside the plane)
// into shared memory with asynchronous copies, each value loaded once and
// all of them in flight together; then, for each octave pixel there,
// every scale's strict 3x3 maximum above the threshold inside the scale's
// border rectangle, the lowest-index scale argmax, and the
// strictly-greater merge into the full-resolution maps (earlier octaves
// win; the layer only above the threshold).  The response of every halo
// tile pixel, and the layer and the truncated squared size of the tile's
// own pixels, stay in shared memory.  Phase 2 writes resp and layer, lists
// the tile's candidates inside the NMS region, and runs the circular
// suppression of each with a warp, its lanes over the circle's offsets.
//
// What was measured on the H100 (960x1280 pair, PERF.md): reading the 3x3
// neighbourhoods through the read-only cache, with a thread per pixel in
// the suppression, took 0.24 ms (the CTAs' working sets overflow L1: L2
// traffic); staging in shared memory 0.21 ms; a warp per candidate (they
// are ~2% of the pixels, and a thread per pixel left most lanes idle)
// and 512 threads 0.13 ms, 6x the byte bound.  Staging every octave at
// once, or smaller or larger tiles, measured slower.
//
// A radius whose halo tile and staged stack do not fit one CTA's shared
// memory (R > 28 with 4 scales; shipped plans have R = 4) takes two
// launches: this kernel with no halo (R = 0: the maps, and every
// candidate in the mask), then nms_wide_kernel, a thread per candidate
// reading its neighbours from the response map in global memory, as the
// reference's gNmsRNaive does.  No radius is refused.
//
// Bit for bit the plain chain: the same comparisons on the same values (no
// arithmetic on a response), size * size one float32 product truncated to
// int32 (--fmad=false, see _build.py), out-of-image pixels the min fill,
// ties broken as the plain version breaks them.  Two flavours: float32 det
// planes, and the 16.16 fixed path's int32 planes with its integer
// threshold.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TH = 32;              // tile rows
constexpr int TW = 64;              // tile columns
constexpr int THREADS = 512;
constexpr int MAX_OCTAVES = 16;     // ops/detect.py MAX_OCTAVES
constexpr int MAX_SCALES = 8;       // ops/detect.py MAX_SCALES
constexpr int MAX_SMEM = 232448;    // shared memory one CTA may use
constexpr int MAX_DEVICES = 16;

// Built once per plan by the wrapper (ops/detect.py layout): 4-byte words.
struct Layout {
  int fixed, H, W, noct, nscale, R, psz;   // nscale: max_scale
  int threshold;                       // float32 bits, or the int threshold
  int hw[MAX_OCTAVES][2];              // each octave's (h, w)
  int rect[MAX_OCTAVES][MAX_SCALES][4];   // x_lo, x_hi, y_lo, y_hi
  int size[MAX_OCTAVES][MAX_SCALES];   // float32 bits of each scale's size
};

struct Args {
  Layout p;
  const void* det[MAX_OCTAVES];        // [B, nscale, h, w] per octave
};

template <typename T>
struct Flavour;

template <>
struct Flavour<float> {
  __device__ static float fill() { return -1.0e6f; }   // detect.FMIN_VAL
  __device__ static float bits(int v) { return __int_as_float(v); }
};

template <>
struct Flavour<int> {
  __device__ static int fill() { return -(1 << 30); }   // detect.IMIN_VAL
  __device__ static int bits(int v) { return v; }
};

// The full-resolution pixels of a CTA's tile and halo that octave o holds:
// octave rows [lo, hi) whose full-resolution row y << o lies in [a, b),
// the octave's rows [0, n) only.
__device__ __forceinline__ void octave_span(int a, int b, int o, int n,
                                            int& lo, int& hi) {
  const int r = 1 << o;
  lo = (max(a, 0) + r - 1) >> o;
  hi = min((b + r - 1) >> o, n);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
extrema_nms_kernel(const __grid_constant__ Args a, T* __restrict__ resp_out,
                   int* __restrict__ layer_out,
                   unsigned char* __restrict__ mask_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  using F = Flavour<T>;
  const Layout& p = a.p;
  const int R = p.R, H = p.H, W = p.W, S = p.nscale;
  const int row = TW + 2 * R;         // halo tile row length
  const int n_halo = (TH + 2 * R) * row;
  T* s_resp = reinterpret_cast<T*>(smem);
  short* s_layer = reinterpret_cast<short*>(s_resp + n_halo);
  short* s_sq = s_layer + TH * TW;
  T* stage = reinterpret_cast<T*>(s_sq + TH * TW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int Y0 = y0 - R, X0 = x0 - R;   // the halo tile's origin
  const T fill = F::fill();
  const T thr = F::bits(p.threshold);

  // the border rectangles, read once from the parameters
  __shared__ int s_rect[MAX_OCTAVES * MAX_SCALES * 4];
  for (int k = tid; k < p.noct * MAX_SCALES * 4; k += THREADS)
    s_rect[k] = (&p.rect[0][0][0])[k];
  for (int k = tid; k < n_halo; k += THREADS) s_resp[k] = fill;
  for (int k = tid; k < TH * TW; k += THREADS) {
    s_layer[k] = -1;
    s_sq[k] = 0;
  }

  // phase 1, octave by octave: stage the det stack under the tile and
  // halo (one ring more for the 3x3 test, the min fill outside the plane)
  // into shared memory with asynchronous copies, then merge each of the
  // octave's pixels into the maps
  for (int o = 0; o < p.noct; ++o) {
    const int h = p.hw[o][0], w = p.hw[o][1];
    int ylo, yhi, xlo, xhi;
    octave_span(Y0, Y0 + TH + 2 * R, o, h, ylo, yhi);
    octave_span(X0, X0 + TW + 2 * R, o, w, xlo, xhi);
    if (ylo >= yhi || xlo >= xhi) break;   // nor any smaller octave
    const int nr = yhi - ylo + 2, nc = xhi - xlo + 2;
    const T* det = static_cast<const T*>(a.det[o]) +
                   static_cast<ptrdiff_t>(b) * S * h * w;
    __syncthreads();   // the previous octave's reads of the stage are done
    for (int r = warp; r < S * nr; r += THREADS / 32) {
      const int sc = r / nr, y = ylo - 1 + (r - sc * nr);
      T* dst = stage + r * nc;
      const bool row_in = y >= 0 && y < h;
      const T* src = det + (static_cast<ptrdiff_t>(sc) * h + y) * w;
      for (int c = lane; c < nc; c += 32) {
        const int x = xlo - 1 + c;
        if (row_in && x >= 0 && x < w)
          __pipeline_memcpy_async(dst + c, src + x, sizeof(T));
        else
          dst[c] = fill;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int nx = xhi - xlo;
    for (int k = tid; k < (yhi - ylo) * nx; k += THREADS) {
      const int y = ylo + k / nx, x = xlo + k % nx;
      const T* centre = stage + (y - ylo + 1) * nc + (x - xlo + 1);
      T best = fill;
      int bs = 0;
      for (int sc = 0; sc < S; ++sc) {
        const int* rc = s_rect + (o * MAX_SCALES + sc) * 4;
        const T* q = centre + sc * nr * nc;
        T v = fill;
        if (x >= rc[0] && x <= rc[1] && y >= rc[2] && y <= rc[3]) {
          const T c = q[0];
          // strict 3x3 maximum above the threshold
          if (c > thr && c > q[-nc - 1] && c > q[-nc] && c > q[-nc + 1] &&
              c > q[-1] && c > q[1] && c > q[nc - 1] && c > q[nc] &&
              c > q[nc + 1])
            v = c;
        }
        if (sc == 0 || v > best) {   // argmax: the lowest scale on ties
          best = v;
          bs = sc;
        }
      }
      const int Y = y << o, X = x << o;
      T& resp = s_resp[(Y - Y0) * row + (X - X0)];
      if (best > resp) {   // strictly greater: earlier octaves win
        resp = best;
        const int iy = Y - y0, ix = X - x0;
        if (iy >= 0 && iy < TH && ix >= 0 && ix < TW) {
          const float size = __int_as_float(p.size[o][bs]);
          // int sqsz = fsz * fsz truncates (akazed.cu:1571)
          s_sq[iy * TW + ix] =
              static_cast<short>(__float2int_rz(__fmul_rn(size, size)));
          if (best > thr)
            s_layer[iy * TW + ix] = static_cast<short>(o * S + bs);
        }
      }
    }
  }
  __syncthreads();

  // phase 2: the writes, and the tile's candidates inside the NMS region
  // listed (in the stage, free now) with a table of the circle's offsets
  int* s_cand = reinterpret_cast<int*>(stage);
  const int side = 2 * R + 1, n_off = side * side;
  int* s_addr = s_cand + TH * TW;   // offset (i, j) in s_resp
  int* s_key = s_addr + n_off;      // (i^2 + j^2) << 1 | top-left quadrant
  __shared__ int s_ncand;
  if (tid == 0) s_ncand = 0;
  for (int t = tid; t < n_off; t += THREADS) {
    const int i = t / side - R, j = t % side - R;
    s_addr[t] = i * row + j;
    s_key[t] = (i == 0 && j == 0)
                   ? 0x7fffffff   // the centre: inside no circle
                   : ((i * i + j * j) << 1) | (i <= 0 && j <= 0);
  }
  __syncthreads();
  for (int k = tid; k < TH * TW; k += THREADS) {
    const int iy = k / TW, ix = k - iy * TW;
    const int Y = y0 + iy, X = x0 + ix;
    if (Y >= H || X >= W) continue;
    const int layer = s_layer[k];
    const size_t at = (static_cast<size_t>(b) * H + Y) * W + X;
    resp_out[at] = s_resp[(iy + R) * row + ix + R];
    layer_out[at] = layer;
    if (layer >= 0 && X >= p.psz && X + p.psz < W && Y >= p.psz &&
        Y + p.psz < H)
      s_cand[atomicAdd(&s_ncand, 1)] = k;
    else
      mask_out[at] = 0;
  }
  __syncthreads();

  // circular NMS, a warp per candidate, its lanes over the offsets: a
  // neighbour inside i^2 + j^2 < int(size^2) suppresses the candidate if
  // it is larger, or equal and in the top-left quadrant (i <= 0, j <= 0;
  // akazed.cu:1586-1588).  Candidates are a few percent of the pixels; a
  // thread per pixel left most lanes of a warp idle.
  const int ncand = s_ncand;
  for (int ci = warp; ci < ncand; ci += THREADS / 32) {
    const int k = s_cand[ci];
    const int iy = k / TW, ix = k - iy * TW;
    const T* centre = s_resp + (iy + R) * row + ix + R;
    const T c = *centre;
    const int sq = s_sq[k];
    bool suppressed = false;
    for (int t0 = 0; t0 < n_off; t0 += 32) {
      const int t = t0 + lane;
      bool beaten = false;
      if (t < n_off) {
        const int key = s_key[t];
        if ((key >> 1) < sq) {
          const T n = centre[s_addr[t]];
          beaten = n > c || ((key & 1) && n == c);
        }
      }
      if (__any_sync(0xffffffffu, beaten)) {
        suppressed = true;
        break;
      }
    }
    if (lane == 0)
      mask_out[(static_cast<size_t>(b) * H + y0 + iy) * W + x0 + ix] =
          suppressed ? 0 : 1;
  }
}

// The suppression alone, for radii too wide for extrema_nms_kernel's
// halo: a thread per pixel of the maps its R = 0 launch wrote, whose mask
// then holds every candidate.  The same test as there: a neighbour
// inside i^2 + j^2 < int(size^2), the size of the candidate's layer,
// suppresses it if larger, or equal and in the top-left quadrant;
// neighbours outside the image hold the min fill and never do.
template <typename T>
__global__ void __launch_bounds__(256)
nms_wide_kernel(const __grid_constant__ Layout p, const T* __restrict__ resp,
                const int* __restrict__ layer,
                unsigned char* __restrict__ mask) {
  const int H = p.H, W = p.W, R = p.R;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H * W) return;
  const size_t image = static_cast<size_t>(blockIdx.y) * H * W;
  if (!mask[image + k]) return;
  const int Y = k / W, X = k - Y * W, l = layer[image + k];
  const float size = __int_as_float(p.size[l / p.nscale][l % p.nscale]);
  const int sq = __float2int_rz(__fmul_rn(size, size));
  const T* map = resp + image;
  const T c = map[k];
  for (int i = max(-R, -Y); i <= min(R, H - 1 - Y); ++i)
    for (int j = max(-R, -X); j <= min(R, W - 1 - X); ++j) {
      if ((i == 0 && j == 0) || i * i + j * j >= sq) continue;
      const T n = map[k + i * W + j];
      if (n > c || (i <= 0 && j <= 0 && n == c)) {
        mask[image + k] = 0;
        return;
      }
    }
}

// Shared memory of one CTA: the halo tile's responses, the tile's layers
// and squared sizes, and one octave's staged det stack.
size_t smem_bytes(const Layout& p) {
  return sizeof(int) * (TH + 2 * p.R) * (TW + 2 * p.R) +
         2 * sizeof(short) * TH * TW +
         sizeof(int) * p.nscale * (TH + 2 * p.R + 2) * (TW + 2 * p.R + 2);
}

// Whether extrema_nms_kernel holds radius p.R in one launch: its shared
// memory fits, and the stage, which phase 2 reuses, holds the candidate
// list and the circle's two tables.
bool fused(const Layout& p) {
  const long side = 2 * p.R + 1;
  return smem_bytes(p) <= MAX_SMEM &&
         TH * TW + 2 * side * side <= static_cast<long>(p.nscale) *
                                          (TH + 2 * p.R + 2) *
                                          (TW + 2 * p.R + 2);
}

template <typename T>
cudaError_t launch(const Args& a, void* resp, void* layer, void* mask, int B,
                   cudaStream_t stream, int* launches) {
  static int have[MAX_DEVICES] = {};
  const bool whole = fused(a.p);
  Args one = a;
  if (!whole) one.p.R = 0;
  const int smem = static_cast<int>(smem_bytes(one.p));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (have[dev] < smem) {
    e = cudaFuncSetAttribute(extrema_nms_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    have[dev] = smem;
  }
  const dim3 grid((a.p.W + TW - 1) / TW, (a.p.H + TH - 1) / TH, B);
  extrema_nms_kernel<T><<<grid, THREADS, smem, stream>>>(
      one, static_cast<T*>(resp), static_cast<int*>(layer),
      static_cast<unsigned char*>(mask));
  *launches = 1;
  e = cudaGetLastError();
  if (whole || e != cudaSuccess) return e;
  const dim3 pixels((a.p.H * a.p.W + 255) / 256, B);
  nms_wide_kernel<T><<<pixels, 256, 0, stream>>>(
      a.p, static_cast<const T*>(resp), static_cast<const int*>(layer),
      static_cast<unsigned char*>(mask));
  *launches = 2;
  return cudaGetLastError();
}

}  // namespace

// Every image's full-resolution response, layer and NMS survivor mask.
// layout: a host Layout of `words` 4-byte words (ops/detect.py layout).
// dets: host array of `noct` device pointers, octave o's det stack
// [B, nscale, h_o, w_o] (float32, or int32 when layout.fixed).  Out, each
// [B, H, W]: resp (the det type), layer (int32), mask (bytes 0 / 1);
// launches: the kernels launched, 1, or 2 for a radius too wide for one.
extern "C" int akaze_extrema_nms(const void* layout, int words,
                                 const void* const* dets, int noct, int B,
                                 void* resp, void* layer, void* mask,
                                 void* stream, int* launches) {
  *launches = 0;
  if (words != static_cast<int>(sizeof(Layout) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.p = *static_cast<const Layout*>(layout);
  const Layout& p = a.p;
  if (B < 1 || B > 65535 || p.noct != noct || noct < 1 ||
      noct > MAX_OCTAVES || p.nscale < 1 || p.nscale > MAX_SCALES ||
      p.R < 0 || p.H < 1 || p.W < 1 || (p.H + TH - 1) / TH > 65535 ||
      static_cast<long>(p.H) * p.W > (1L << 31) - 256)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int o = 0; o < MAX_OCTAVES; ++o) {
    a.det[o] = o < noct ? dets[o] : nullptr;
    if (o < noct && (dets[o] == nullptr || p.hw[o][0] < 1 || p.hw[o][1] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.fixed)
    return static_cast<int>(launch<int>(a, resp, layer, mask, B, s, launches));
  return static_cast<int>(
      launch<float>(a, resp, layer, mask, B, s, launches));
}
