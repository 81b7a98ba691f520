// K2: per-keypoint orientation and MLDB cell sums.
//
// Replaces akaze_tpu/ops/pallas_describe.py:orient_describe_banded (kernel
// body _make_banded_kernel) and its private-window twin orient_describe
// (K3, body _make_kernel), whose outputs are the same: the two differ only
// in how windows reach VMEM.  The TPU kernels band-sort keypoints or copy
// one window per keypoint, because the TPU has no fast per-lane gather.
// Here one warp serves one keypoint slot and reads each tap where it lies
// in the [P, Hp, Wp] plane stacks.
//
// Two flavours, one body templated on the plane type P and FIXED:
//   float (bf16 planes, or f32 planes when bf16_sampling is off): as
//     described below;
//   fixed (f32 planes holding the 16.16 path's integers; the bit-faithful
//     fastakaze descriptor, pallas_describe.py:901,1031-1059): the bins
//     take the fast polynomial atan2 of each tap, and each tap's (Lx, Ly)
//     is rotated by the angle and truncated to an integer BEFORE the cell
//     sums (akazed.cu:3779-3780), which are then not rotated.
//
// Per keypoint (float flavour):
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
// Every float sum runs in the plain version's order (ops/describe.py:
// taps ascending within a bin or a cell, window bins d = 0..6); with
// --fmad=false (see _build.py) the two agree bit for bit wherever
// cosf/sinf do.
//
// What bounds it on the H100 (tools/k2_profile.py; numbers in PERF.md).
// The ~4,000 live slots of a 960x1280 pair read ~1,540 scattered taps
// each, 2 bytes (fixed: 4) of planes that do not fit in L2.  Counted as
// the 32-byte sectors they touch, that is 36 MB per pair (fixed 71 MB,
// more than the 50 MB L2), three times as much counted per slot: the
// kernel pays sectors, not the ~6 us that the taps' own bytes would take.
// Even with every tap a cache hit it takes ~28 us: ~2,000 instructions
// per warp (atan2 and cos/sin without FMA, the 100-step cell chain, tap
// addresses) and gathers whose 32 lanes touch many cache lines.  The live
// slots fill about one wave, so all warps pass through the phases in
// step.  The design:
//   - loads in flight: each lane issues all its orientation loads, then
//     its MLDB loads in batches of BATCH rounds (21 loads float, 42
//     fixed), before using any; a tap outside the window is a
//     predicated-off load that reads 0;
//   - MLDB taps in an order that follows the angle: per bucket of
//     2 pi / ORDERS, the taps sorted by rotated half-row band, then
//     column (the tap_order table), so the 32 lanes of one load touch few
//     cache lines; each lane stores its tap at the tap's own index;
//   - orientation with busy lanes: __match_any_sync groups each 32-tap
//     round by bin; the group's leader stores the round's mask for that
//     bin, and the lane that owns a bin walks its set bits in ascending
//     tap order (a bin's sum is as long as its population, not 121 steps);
//     the 42 window sums run on 42 lanes from a table of wrapped bin
//     indices, and a warp argmax keeps the lowest bin among equal maxima
//     (the first maximum);
//   - cell sums from per-cell tap lists: lane c walks the taps of cell c
//     only (25, 49 or 100 of them, ascending, from the [steps, 32] table
//     lane_taps), three channels per step from shared memory.  A 2x2 cell
//     is a 100-term chain in a fixed order, so no order-keeping split can
//     take fewer than 100 steps; every other lane's list fits inside them;
//   - occupancy: the float flavour fits 64 registers, so 32 warps per SM
//     hold every live slot at once; the fixed flavour takes 90 (20 warps
//     per SM), and fewer slots in flight keep more of its sectors' reuse
//     in L2;
//   - dead slots exit after one load and 87 zero stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WS = 128;        // window side
constexpr int NOR = 121;       // 11 x 11 orientation taps
constexpr int NOR_ROUNDS = 4;  // ceil(121 / 32)
constexpr int NBINS = 42;
constexpr int WIN = 7;         // bins per orientation window (pi/3)
constexpr int NCELLS = 29;
constexpr int MAX_TAPS = 441;  // 21 x 21 descriptor taps (pattern size 10)
constexpr int TAP_ROUNDS = 14; // ceil(441 / 32)
constexpr int TAP_SLOTS = 448; // MAX_TAPS + a zero tap, rounded up
constexpr int WARPS = 4;       // slots (warps) per block
constexpr int ORDERS = 32;     // angle buckets of the MLDB tap order
// Per flavour: the resident warps per SM that the register cap must allow
// (65536 / (32 x that) registers a thread), and the MLDB rounds whose
// loads are in flight at once.
template <bool FIXED> constexpr int SM_WARPS = FIXED ? 16 : 32;
template <bool FIXED> constexpr int BATCH = FIXED ? 14 : 7;
constexpr unsigned FULL = 0xffffffffu;

constexpr float H_PI = 0x1.921fb6p+0f;       // float32(pi / 2)
constexpr float PI = 0x1.921fb6p+1f;         // float32(pi)
constexpr float TWO_PI = 0x1.921fb6p+2f;     // float32(2 pi)
constexpr float BIN_SCALE = 0x1.abcefap+2f;  // float32(21 / pi)

// One warp's shared memory: the orientation phase's taps and bin masks,
// then (aliased) the MLDB taps, L apart from (Lx, Ly).
union WarpSmem {
  struct {
    float dx[NOR_ROUNDS * 32];
    float dy[NOR_ROUNDS * 32];
    unsigned mask[NOR_ROUNDS][NBINS];  // round k, bin b: its taps' lanes
    float rx[NBINS];
    float ry[NBINS];
  } o;
  struct {
    float l[TAP_SLOTS];
    float2 xy[TAP_SLOTS];
  } t;
};

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

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

// plane[off] if the tap lies in the window, else 0 (a predicated load)
template <typename P>
__device__ __forceinline__ float tap(const P* __restrict__ plane, bool in,
                                     long long off) {
  return in ? to_float(__ldg(plane + off)) : 0.0f;
}

template <typename P, bool FIXED>
__global__ void __launch_bounds__(WARPS * 32, SM_WARPS<FIXED> / WARPS)
describe_kernel(const P* __restrict__ Lp, const P* __restrict__ Xp,
                const P* __restrict__ Yp, const int* __restrict__ iparams,
                const float* __restrict__ fparams,
                const float* __restrict__ orient_w,
                const float* __restrict__ lof, const float* __restrict__ kof,
                const short* __restrict__ lane_taps,
                const short* __restrict__ tap_order,
                const int* __restrict__ window, float* __restrict__ angle_out,
                float* __restrict__ acc_out, int N, int Hp, int Wp,
                int ntaps, int steps) {
  __shared__ WarpSmem smem[WARPS];

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
  WarpSmem& s = smem[warp];
  const int p = ip[0], y0 = ip[1], x0 = ip[2];
  const int oy = ip[3], ox = ip[4], isc = ip[5];
  const float yf = fparams[2 * n];
  const float xf = fparams[2 * n + 1];
  const long long base = (static_cast<long long>(p) * Hp + y0) * Wp + x0;

  // ---- orientation: every load first ----
  float gx[NOR_ROUNDS], gy[NOR_ROUNDS], w[NOR_ROUNDS];
#pragma unroll
  for (int k = 0; k < NOR_ROUNDS; ++k) {
    const int t = lane + 32 * k;
    const int r = oy + isc * (t / 11 - 5);
    const int c = ox + isc * (t % 11 - 5);
    const bool in = t < NOR && r >= 0 && r < WS && c >= 0 && c < WS;
    const long long off = base + static_cast<long long>(r) * Wp + c;
    gx[k] = tap(Xp, in, off);
    gy[k] = tap(Yp, in, off);
    w[k] = t < NOR ? __ldg(orient_w + t) : 0.0f;
  }
  for (int i = lane; i < NOR_ROUNDS * NBINS; i += 32)
    (&s.o.mask[0][0])[i] = 0u;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NOR_ROUNDS; ++k) {
    const int t = lane + 32 * k;
    const float dx = w[k] * gx[k];
    const float dy = w[k] * gy[k];
    s.o.dx[t] = dx;
    s.o.dy[t] = dy;
    const float a = FIXED ? fast_atan2(dy, dx) : atan2_poly(dy, dx);
    const int bin = w[k] > 0.0f
        ? min(max(static_cast<int>(a * BIN_SCALE) + 21, 0), NBINS - 1)
        : -1;
    const unsigned same = __match_any_sync(FULL, bin);
    if (bin >= 0 && lane == __ffs(same) - 1) s.o.mask[k][bin] = same;
  }
  __syncwarp();

  // bin sums: lane b owns bins b and b + 32 and adds their taps in
  // ascending order, a round's set bits at a time
  const int b2 = lane + 32;
  const bool has2 = b2 < NBINS;
  float rx1 = 0.0f, ry1 = 0.0f, rx2 = 0.0f, ry2 = 0.0f;
#pragma unroll
  for (int k = 0; k < NOR_ROUNDS; ++k) {
    unsigned m1 = s.o.mask[k][lane];
    unsigned m2 = has2 ? s.o.mask[k][b2] : 0u;
    while (m1 | m2) {
      if (m1) {
        const int t = 32 * k + __ffs(m1) - 1;
        m1 &= m1 - 1;
        rx1 = rx1 + s.o.dx[t];
        ry1 = ry1 + s.o.dy[t];
      }
      if (m2) {
        const int t = 32 * k + __ffs(m2) - 1;
        m2 &= m2 - 1;
        rx2 = rx2 + s.o.dx[t];
        ry2 = ry2 + s.o.dy[t];
      }
    }
  }
  s.o.rx[lane] = rx1;
  s.o.ry[lane] = ry1;
  if (has2) {
    s.o.rx[b2] = rx2;
    s.o.ry[b2] = ry2;
  }
  __syncwarp();

  // window sums, d = 0..6 from the table of wrapped bins
  const int* w1 = window + lane * WIN;
  const int* w2 = window + (has2 ? b2 : lane) * WIN;
  float ex1 = 0.0f, ey1 = 0.0f, ex2 = 0.0f, ey2 = 0.0f;
#pragma unroll
  for (int d = 0; d < WIN; ++d) {
    const int i1 = __ldg(w1 + d);
    const int i2 = __ldg(w2 + d);
    ex1 = ex1 + s.o.rx[i1];
    ey1 = ey1 + s.o.ry[i1];
    ex2 = ex2 + s.o.rx[i2];
    ey2 = ey2 + s.o.ry[i2];
  }
  // warp argmax of the magnitudes, the lowest bin among equal maxima
  float best = ex1 * ex1 + ey1 * ey1;
  int bb = lane;
  const float mag2 = ex2 * ex2 + ey2 * ey2;
  if (has2 && mag2 > best) {
    best = mag2;
    bb = b2;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(FULL, best, o);
    const int ob = __shfl_xor_sync(FULL, bb, o);
    if (om > best || (om == best && ob < bb)) {
      best = om;
      bb = ob;
    }
  }
  const bool second = bb >= 32;
  const float bx = __shfl_sync(FULL, second ? ex2 : ex1, bb & 31);
  const float by = __shfl_sync(FULL, second ? ey2 : ey1, bb & 31);
  float ang = fast_atan2(by, bx);
  if (ang < 0.0f) ang = ang + TWO_PI;
  if (lane == 0) angle_out[n] = ang;

  // ---- MLDB taps in the angle bucket's order: a batch's loads in flight,
  // then each tap into shared memory at its own index ----
  const float co = cosf(ang);
  const float si = sinf(ang);
  const float sc = static_cast<float>(isc);
  const short* order = tap_order
      + min(static_cast<int>(ang * (ORDERS / TWO_PI)), ORDERS - 1)
      * (TAP_ROUNDS * 32);
  __syncwarp();   // the orientation arrays are overwritten from here
  if (lane == 0) {
    s.t.l[ntaps] = 0.0f;
    s.t.xy[ntaps] = make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int r0 = 0; r0 < TAP_ROUNDS; r0 += BATCH<FIXED>) {
    float vl[BATCH<FIXED>], vx[BATCH<FIXED>], vy[BATCH<FIXED>];
    int tt[BATCH<FIXED>];
#pragma unroll
    for (int j = 0; j < BATCH<FIXED>; ++j) {
      const int t = __ldg(order + 32 * (r0 + j) + lane);
      tt[j] = t;
      const bool live = t < ntaps;
      const float l = __ldg(lof + (live ? t : 0));
      const float k = __ldg(kof + (live ? t : 0));
      const int xs = static_cast<int>(xf + sc * (k * co - l * si) + 0.5f);
      const int ys = static_cast<int>(yf + sc * (k * si + l * co) + 0.5f);
      const bool in = live && ys >= 0 && ys < WS && xs >= 0 && xs < WS;
      const long long off = base + static_cast<long long>(ys) * Wp + xs;
      vl[j] = tap(Lp, in, off);
      vx[j] = tap(Xp, in, off);
      vy[j] = tap(Yp, in, off);
    }
#pragma unroll
    for (int j = 0; j < BATCH<FIXED>; ++j) {
      const int t = tt[j];
      if (t < ntaps) {
        const float x = vx[j];
        const float y = vy[j];
        s.t.l[t] = vl[j];
        if (FIXED)   // rotate, then truncate toward zero
          s.t.xy[t] = make_float2(
              static_cast<float>(static_cast<int>((-si) * x + co * y)),
              static_cast<float>(static_cast<int>(co * x + si * y)));
        else
          s.t.xy[t] = make_float2(x, y);
      }
    }
  }
  __syncwarp();

  // ---- cell sums: lane c walks the taps of cell c ----
  const short* list = lane_taps + lane;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
    const int t = __ldg(list + 32 * i);
    const float2 v = s.t.xy[t];
    a0 = a0 + s.t.l[t];
    a1 = a1 + v.x;
    a2 = a2 + v.y;
  }
  if (lane < NCELLS) {
    acc[3 * lane] = a0;
    acc[3 * lane + 1] = FIXED ? a1 : (-si) * a1 + co * a2;
    acc[3 * lane + 2] = FIXED ? a2 : co * a1 + si * a2;
  }
}

template <typename P, bool FIXED>
void launch(const void* L, const void* Lx, const void* Ly,
            const int* iparams, const float* fparams, const float* orient_w,
            const float* lof, const float* kof, const short* lane_taps,
            const short* tap_order, const int* window, float* angle,
            float* acc, int N, int Hp,
            int Wp, int ntaps, int steps, cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  describe_kernel<P, FIXED><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const P*>(L), static_cast<const P*>(Lx),
      static_cast<const P*>(Ly), iparams, fparams, orient_w, lof, kof,
      lane_taps, tap_order, window, angle, acc, N, Hp, Wp, ntaps, steps);
}

}  // namespace

// Planes: three [P, Hp, Wp] device arrays, float32 when `f32` != 0, else
// bf16; the fixed flavour (`fixed` != 0) takes float32.  iparams [N, 8] int32,
// fparams [N, 2] float32 (descriptor.slot_params).  Tables (device,
// ops/describe.describe_tables): orient_w [121], lof/kof [ntaps] float32,
// lane_taps [steps, 32] int16 (step i, lane c: the i-th tap of cell c in
// ascending order, padded with ntaps, the zero tap), window [42, 7] int32
// (the wrapped bins of each orientation window).  Out: angle [N],
// acc [N, 87].
extern "C" int akaze_describe(const void* L, const void* Lx, const void* Ly,
                              const int* iparams, const float* fparams,
                              const float* orient_w, const float* lof,
                              const float* kof, const short* lane_taps,
                              const short* tap_order, const int* window,
                              float* angle, float* acc,
                              int N, int Hp, int Wp, int ntaps, int steps,
                              int fixed, int f32, void* stream) {
  if (N < 0 || ntaps < 1 || ntaps > MAX_TAPS || steps < 1 ||
      steps > MAX_TAPS || Hp < WS || Wp < WS || (fixed && !f32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fixed)
    launch<float, true>(L, Lx, Ly, iparams, fparams, orient_w, lof, kof,
                        lane_taps, tap_order, window, angle, acc, N, Hp, Wp,
                        ntaps, steps, s);
  else if (f32)
    launch<float, false>(L, Lx, Ly, iparams, fparams, orient_w, lof, kof,
                         lane_taps, tap_order, window, angle, acc, N, Hp, Wp,
                         ntaps, steps, s);
  else
    launch<__nv_bfloat16, false>(L, Lx, Ly, iparams, fparams, orient_w, lof,
                                 kof, lane_taps, tap_order, window, angle,
                                 acc, N, Hp, Wp, ntaps, steps, s);
  return static_cast<int>(cudaGetLastError());
}
