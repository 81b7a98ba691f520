// K4: brute-force Hamming 1-NN with a running (best, second, index).
//
// Replaces akaze_tpu/ops/pallas_match.py:hamming_top2 (kernel body
// _make_kernel).  The TPU kernel turns the bits into +-1 bf16 vectors and
// rides the matrix unit: hamming = (486 - <sa, sb>) / 2.  Here a distance
// is 16 XORs and 16 __popc of the packed 32-bit words; the 26 pad bits are
// zero on both sides, so no mask is needed and the result is exact.
//
// A block serves 32 queries, one per lane, with 8 warps.  Train rows are
// staged through shared memory 256 at a time; warp w scans rows
// [32w, 32w + 32) of each tile, all lanes reading the same row (a shared
// memory broadcast).  Each lane keeps (best, second, index) over the rows
// it scanned, in ascending order, so its first minimum wins and an equal
// minimum sets second = best.  The 8 partial results of a query merge with
// the same rules: the smaller best wins, an equal best keeps the LOWER
// index, and second = min(max(best_a, best_b), min(second_a, second_b)).
//
// Invalid train rows are skipped (they never win); the scan stops at the
// last live train row, and queries past the last live query report
// (BIG, BIG, -1) without scanning.
//
// Bound: popcount throughput.  At 10,000 x 10,000 descriptors a pair needs
// 1.6e9 XOR + popcount word operations and reads each train tile from
// shared memory once per warp; device memory traffic is ~0.6 MB of words
// per block pass, served from L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int QB = 32;     // queries per block, one per lane
constexpr int WARPS = 8;
constexpr int TT = WARPS * 32;  // train rows per staged tile
constexpr int BIG = 1 << 20;

__device__ __forceinline__ void merge(int& b, int& s, int& i, int b2, int s2,
                                      int i2) {
  const int ns = min(max(b, b2), min(s, s2));
  i = b2 < b ? i2 : (b2 == b ? min(i, i2) : i);
  b = min(b, b2);
  s = ns;
}

__global__ void __launch_bounds__(WARPS * 32)
hamming_kernel(const uint4* __restrict__ q, int n1,
               const int* __restrict__ q_count, const uint4* __restrict__ t,
               const unsigned char* __restrict__ tvalid, int n2,
               const int* __restrict__ t_count, int* __restrict__ best_out,
               int* __restrict__ second_out, int* __restrict__ idx_out) {
  __shared__ uint4 s_t[TT][4];
  __shared__ unsigned char s_v[TT];
  __shared__ int s_best[WARPS][QB];
  __shared__ int s_second[WARPS][QB];
  __shared__ int s_idx[WARPS][QB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;
  const int qi = q0 + lane;
  const int nq = min(*q_count, n1);
  const int nt = min(*t_count, n2);
  if (q0 >= nq) {   // the whole block lies past the last live query
    if (warp == 0 && qi < n1) {
      best_out[qi] = BIG;
      second_out[qi] = BIG;
      idx_out[qi] = -1;
    }
    return;
  }

  uint4 qw[4];
  for (int w = 0; w < 4; ++w)
    qw[w] = qi < n1 ? q[4 * qi + w] : make_uint4(0u, 0u, 0u, 0u);

  int best = BIG, second = BIG, bidx = -1;
  for (int base = 0; base < nt; base += TT) {
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * TT; i += blockDim.x) {
      const int r = base + i / 4;
      s_t[i / 4][i % 4] = r < nt ? t[4 * r + i % 4]
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < TT; i += blockDim.x)
      s_v[i] = base + i < nt ? tvalid[base + i] : 0;
    __syncthreads();
    for (int j = 0; j < 32; ++j) {
      const int r = warp * 32 + j;
      if (!s_v[r]) continue;
      int d = 0;
      for (int w = 0; w < 4; ++w) {
        const uint4 tw = s_t[r][w];
        d += __popc(qw[w].x ^ tw.x) + __popc(qw[w].y ^ tw.y)
            + __popc(qw[w].z ^ tw.z) + __popc(qw[w].w ^ tw.w);
      }
      if (d < best) {
        second = best;
        best = d;
        bidx = base + r;
      } else if (d < second) {
        second = d;
      }
    }
  }
  s_best[warp][lane] = best;
  s_second[warp][lane] = second;
  s_idx[warp][lane] = bidx;
  __syncthreads();
  if (warp == 0 && qi < n1) {
    for (int w = 1; w < WARPS; ++w)
      merge(best, second, bidx, s_best[w][lane], s_second[w][lane],
            s_idx[w][lane]);
    const bool live = qi < nq;
    best_out[qi] = live ? best : BIG;
    second_out[qi] = live ? second : BIG;
    idx_out[qi] = live ? bidx : -1;
  }
}

}  // namespace

// q [n1, 16], t [n2, 16]: 32-bit descriptor words (16-byte aligned);
// tvalid [n2] bytes; q_count, t_count: device int32 scalars, one past the
// last live query / train row.  Out: best, second, idx [n1] int32.
extern "C" int akaze_hamming_top2(const void* q, int n1, const int* q_count,
                                  const void* t, const void* tvalid, int n2,
                                  const int* t_count, int* best, int* second,
                                  int* idx, void* stream) {
  if (n1 < 0 || n2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n1 + QB - 1) / QB;
  hamming_kernel<<<blocks, WARPS * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), n1, q_count,
      static_cast<const uint4*>(t),
      static_cast<const unsigned char*>(tvalid), n2, t_count, best, second,
      idx);
  return static_cast<int>(cudaGetLastError());
}
