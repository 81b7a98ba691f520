// K2: per-keypoint orientation and MLDB cell sums.
//
// Replaces akaze_tpu/ops/pallas_describe.py:orient_describe_banded (kernel
// body _make_banded_kernel).  The TPU kernel band-sorts keypoints and
// streams row bands of the planes through VMEM, because the TPU has no
// fast per-lane gather.  Here one warp serves one keypoint slot and reads
// each tap where it lies in the [P, Hp, Wp] bf16 plane stacks.
//
// Per keypoint:
//   orientation - 121 taps (109 live: the r^2 < 36 disc) of Lx, Ly at
//     stride iscale around the integer centre, Gaussian-weighted; the angle
//     of each by the accurate polynomial atan2 (the TPU kernel's
//     _atan2_poly) picks one of 42 bins; the 7-bin (pi/3) circular window
//     sums are compared by magnitude, the FIRST maximum wins, and the final
//     angle is the reference's fast polynomial atan2 (dFastAtan2), wrapped
//     into [0, 2 pi).
//   MLDB - 441 rotated nearest-neighbour taps of L, Lx, Ly at
//     (int)(c + scale * (k cos - l sin) + 0.5) (C truncation), summed into
//     29 cells; the two derivative cell sums are then rotated by the angle
//     (rotation is linear, so it commutes with the sums; the TPU kernel
//     rotates the cell sums too).  Output: acc[n, cell * 3 + channel].
//
// Window rule: a tap outside the keypoint's [128, 128] window
// (origin x0, y0 from descriptor.slot_params) reads 0.  Dead slots
// (live == 0) write zeros.
//
// Sums run in a fixed order (taps ascending), the same order as the plain
// version in ops/describe.py; with --fmad=false (see _build.py) the two
// agree bit for bit wherever cosf/sinf do.
//
// Bound: ~1,600 scattered 2-byte reads per keypoint from planes that do
// not fit in L2 (3 x 32 planes of 960 x 1280 bf16 = 236 MB at the pair's
// full size), i.e. memory latency; 4 warps per block and many blocks per
// SM keep enough reads in flight.  The per-cell sums are serial loops over
// the taps on 29 lanes, a few hundred instructions per keypoint.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WS = 128;        // window side
constexpr int NOR = 121;       // 11 x 11 orientation taps
constexpr int NBINS = 42;
constexpr int NCELLS = 29;
constexpr int MAX_TAPS = 441;  // 21 x 21 descriptor taps (pattern size 10)
constexpr int WARPS = 4;

constexpr float H_PI = 0x1.921fb6p+0f;       // float32(pi / 2)
constexpr float PI = 0x1.921fb6p+1f;         // float32(pi)
constexpr float TWO_PI = 0x1.921fb6p+2f;     // float32(2 pi)
constexpr float BIN_SCALE = 0x1.abcefap+2f;  // float32(21 / pi)

// atan(z)/z on [0, 1] as a degree-9 polynomial in z^2
// (pallas_describe.py:_ATAN_COEFS, each rounded to float32)
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float absx = fabsf(x);
  const float absy = fabsf(y);
  const float mx = fmaxf(absx, absy);
  const float mn = fminf(absx, absy);
  const float z = mn / (mx == 0.0f ? 1.0f : mx);
  const float t = z * z;
  float acc = -0x1.ec30e2p-10f;
  acc = acc * t + 0x1.70e3ccp-7f;
  acc = acc * t + -0x1.0419b0p-5f;
  acc = acc * t + 0x1.dee2f0p-5f;
  acc = acc * t + -0x1.59321ap-4f;
  acc = acc * t + 0x1.c0dac2p-4f;
  acc = acc * t + -0x1.24251ep-3f;
  acc = acc * t + 0x1.9991e8p-3f;
  acc = acc * t + -0x1.55553ap-2f;
  acc = acc * t + 0x1.000000p+0f;
  float r = acc * z;
  r = absy > absx ? H_PI - r : r;
  r = x < 0.0f ? PI - r : r;
  return y < 0.0f ? -r : r;
}

// dFastAtan2 (akazed.cu:173-185)
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float absx = fabsf(x);
  const float absy = fabsf(y);
  const float mx = fmaxf(absx, absy);
  const float mn = fminf(absx, absy);
  const float a = mn / (mx == 0.0f ? 1.0f : mx);
  const float s = a * a;
  float r = ((-0x1.7ce62cp-5f * s + 0x1.464688p-3f) * s - 0x1.4f7c58p-2f)
      * s * a + a;
  r = absy > absx ? H_PI - r : r;
  r = x < 0.0f ? PI - r : r;
  return y < 0.0f ? -r : r;
}

__global__ void __launch_bounds__(WARPS * 32)
describe_kernel(const __nv_bfloat16* __restrict__ Lp,
                const __nv_bfloat16* __restrict__ Xp,
                const __nv_bfloat16* __restrict__ Yp,
                const int* __restrict__ iparams,
                const float* __restrict__ fparams,
                const float* __restrict__ orient_w,
                const float* __restrict__ lof, const float* __restrict__ kof,
                const int* __restrict__ cells, float* __restrict__ angle_out,
                float* __restrict__ acc_out, int N, int Hp, int Wp,
                int ntaps) {
  __shared__ float s_dx[WARPS][NOR];
  __shared__ float s_dy[WARPS][NOR];
  __shared__ int s_bin[WARPS][NOR];
  __shared__ float s_rx[WARPS][NBINS];
  __shared__ float s_ry[WARPS][NBINS];
  __shared__ float s_tap[WARPS][3][MAX_TAPS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;   // a whole warp; only warp-level syncs below

  const int* ip = iparams + 8 * n;
  float* acc = acc_out + static_cast<size_t>(n) * 3 * NCELLS;
  if (ip[6] == 0) {
    if (lane == 0) angle_out[n] = 0.0f;
    for (int c = lane; c < 3 * NCELLS; c += 32) acc[c] = 0.0f;
    return;
  }
  const int p = ip[0], y0 = ip[1], x0 = ip[2];
  const int oy = ip[3], ox = ip[4], isc = ip[5];
  const float yf = fparams[2 * n];
  const float xf = fparams[2 * n + 1];
  const size_t base = (static_cast<size_t>(p) * Hp + y0) * Wp + x0;
  auto tap = [&](const __nv_bfloat16* plane, int r, int c) -> float {
    if (r < 0 || r >= WS || c < 0 || c >= WS) return 0.0f;
    return __bfloat162float(plane[base + static_cast<size_t>(r) * Wp + c]);
  };

  // ---- orientation ----
  for (int t = lane; t < NOR; t += 32) {
    const int r = oy + isc * (t / 11 - 5);
    const int c = ox + isc * (t % 11 - 5);
    const float w = orient_w[t];
    const float dx = w * tap(Xp, r, c);
    const float dy = w * tap(Yp, r, c);
    s_dx[warp][t] = dx;
    s_dy[warp][t] = dy;
    const int bin = static_cast<int>(atan2_poly(dy, dx) * BIN_SCALE) + 21;
    s_bin[warp][t] = w > 0.0f ? min(max(bin, 0), NBINS - 1) : -1;
  }
  __syncwarp();
  for (int b = lane; b < NBINS; b += 32) {
    float rx = 0.0f, ry = 0.0f;
    for (int t = 0; t < NOR; ++t) {
      if (s_bin[warp][t] == b) {
        rx = rx + s_dx[warp][t];
        ry = ry + s_dy[warp][t];
      }
    }
    s_rx[warp][b] = rx;
    s_ry[warp][b] = ry;
  }
  __syncwarp();
  float ang = 0.0f;
  if (lane == 0) {
    float best = -1.0f, bx = 0.0f, by = 0.0f;
    for (int b = 0; b < NBINS; ++b) {
      float ex = 0.0f, ey = 0.0f;
      for (int d = 0; d < 7; ++d) {
        ex = ex + s_rx[warp][(b + d) % NBINS];
        ey = ey + s_ry[warp][(b + d) % NBINS];
      }
      const float mag = ex * ex + ey * ey;
      if (mag > best) {   // strict: the first maximum wins
        best = mag;
        bx = ex;
        by = ey;
      }
    }
    ang = fast_atan2(by, bx);
    if (ang < 0.0f) ang = ang + TWO_PI;
    angle_out[n] = ang;
  }
  ang = __shfl_sync(0xffffffffu, ang, 0);

  // ---- MLDB taps and cell sums ----
  const float co = cosf(ang);
  const float si = sinf(ang);
  const float sc = static_cast<float>(isc);
  for (int t = lane; t < ntaps; t += 32) {
    const float l = lof[t];
    const float k = kof[t];
    const int xs = static_cast<int>(xf + sc * (k * co - l * si) + 0.5f);
    const int ys = static_cast<int>(yf + sc * (k * si + l * co) + 0.5f);
    s_tap[warp][0][t] = tap(Lp, ys, xs);
    s_tap[warp][1][t] = tap(Xp, ys, xs);
    s_tap[warp][2][t] = tap(Yp, ys, xs);
  }
  __syncwarp();
  if (lane < NCELLS) {
    const int grid = lane < 4 ? 0 : (lane < 13 ? 1 : 2);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int t = 0; t < ntaps; ++t) {
      if (cells[3 * t + grid] == lane) {
        a0 = a0 + s_tap[warp][0][t];
        a1 = a1 + s_tap[warp][1][t];
        a2 = a2 + s_tap[warp][2][t];
      }
    }
    acc[3 * lane] = a0;
    acc[3 * lane + 1] = (-si) * a1 + co * a2;
    acc[3 * lane + 2] = co * a1 + si * a2;
  }
}

}  // namespace

// Planes: three [P, Hp, Wp] bf16 device arrays.  iparams [N, 8] int32,
// fparams [N, 2] float32 (descriptor.slot_params).  Tables (device):
// orient_w [121], lof/kof [ntaps] float32, cells [ntaps, 3] int32 (the
// tap's cell in each grid, -1 for none).  Out: angle [N], acc [N, 87].
extern "C" int akaze_describe(const void* L, const void* Lx, const void* Ly,
                              const int* iparams, const float* fparams,
                              const float* orient_w, const float* lof,
                              const float* kof, const int* cells,
                              float* angle, float* acc, int N, int Hp,
                              int Wp, int ntaps, void* stream) {
  if (N < 0 || ntaps < 1 || ntaps > MAX_TAPS || Hp < WS || Wp < WS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (N + WARPS - 1) / WARPS;
  describe_kernel<<<blocks, WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(L),
      static_cast<const __nv_bfloat16*>(Lx),
      static_cast<const __nv_bfloat16*>(Ly), iparams, fparams, orient_w, lof,
      kof, cells, angle, acc, N, Hp, Wp, ntaps);
  return static_cast<int>(cudaGetLastError());
}
