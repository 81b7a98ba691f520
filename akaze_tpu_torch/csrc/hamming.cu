// K4: brute-force Hamming 1-NN with a running (best, second, index).
//
// Replaces akaze_tpu/ops/pallas_match.py:hamming_top2 (kernel body
// _make_kernel).  The TPU kernel turns the bits into +-1 bf16 vectors and
// rides the matrix unit: hamming = (486 - <sa, sb>) / 2.  This kernel does
// the same on Hopper's int8 tensor cores: each descriptor's 512 bits (486
// and 26 pad bits) become +-1 int8 lanes, a warpgroup's
// wgmma.m64n64k32.s8 gives 64 x 64 exact int32 dot products per k-step,
// and hamming = (512 - dot) / 2 over all 16 words.  That is the popcount
// of the XOR of the words, which the plain version computes, on any
// input; the pad bits are zero on both sides of a real descriptor, so it
// is also the 486-bit distance.
//
// What bounds it on the H100 (tools/k4_profile.py; numbers in PERF.md).
// A pair's ~2,000 x ~2,000 live descriptors need 4e6 distances:
// 2 x 512 x 4e6 = 4.2e9 int8 operations, 2 us at the published dense int8
// rate (16 us of XOR + popcount at 16 popcounts per SM and clock, the
// previous kernel's form, which also left 68 of 132 SMs idle).  The
// products are cheap; what costs is the instructions around them,
// expanding bits into +-1 lanes and the top-2 epilogue, and at the pair's
// size the latency of a CTA's short chain (load, expand, two chunks,
// merge).  The design:
//   - fill the card: a CTA takes QB = 128 queries (two warpgroups of 64),
//     and a cluster of RANKS = 8 CTAs shares one query tile and splits the
//     live train range [0, count2) between its ranks: the pair's 16 live
//     query tiles give 128 busy CTAs, and 128 registers a thread let two
//     CTAs share an SM where there are more; the grid is sized from the
//     capacities, and tiles at or past count1 exit at once;
//   - the product on the tensor cores, asynchronous: each warpgroup holds
//     its 64 queries' +-1 A fragments in registers for the whole scan; a
//     chunk of CH = 64 train rows, staged with cp.async (three row
//     buffers), is expanded by the CTA once into a +-1 B tile in shared
//     memory (K-major, no swizzle: 8-row x 16-byte core matrices), and 17
//     wgmma of k32 per warpgroup consume it.  While they run, the CTA
//     expands the next chunk into the other B tile;
//   - bit planes, so that a lane costs little to make: k-step s is word s,
//     and lanes 4j..4j+3 of it are bit j of the word's bytes 0..3, in A and
//     B alike; four lanes are one shift, one mask and one multiply-add;
//   - validity inside the product: a 17th k-step adds -128 x 32 = -4096
//     to the dot of every invalid train row (and of rows past count2), so
//     it ranks below any real dot in [-512, 512] and never wins; a result
//     below -512 at the end means "none";
//   - a top-2 epilogue on the accumulator fragments: a thread packs each
//     dot with its column's place in the thread's ascending visiting
//     order, key = dot * 16 + (15 - v), keeps the two largest keys of a
//     chunk per row (3 integer min/max each), and merges them into its
//     running (best, second, index) once per chunk;
//   - merges: the 4 lanes of a quad, then the cluster's ranks through
//     distributed shared memory, by one rule: the larger dot (smaller
//     distance) wins, an equal one keeps the LOWER index, and second =
//     max(min(b1, b2), max(s1, s2)); with it the result depends on no scan
//     or merge order: the best is the first minimum, and an equal minimum
//     gives second == best;
//   - the whole match in one launch (hamming_kernel<Accept>, C entry
//     akaze_hamming_match): a matched pair's cost was the host path
//     around the kernel, two plain extent reductions, ~10 plain
//     acceptance ops and a CUDA graph's input copies and output clones,
//     ~280 us of host against 13 us of K4 (PERF.md).  So the kernel finds
//     its own scan extents, a query tile by its validity bytes (a tile
//     with no valid query exits at once) and the train extent by a
//     cluster-wide scan of the validity, an eighth a rank, the maxima
//     meeting through distributed shared memory; and the writer threads
//     apply the acceptance rule to the merged (best, second, index) and
//     write the four Matches fields, gathering x and y of accepted rows;
//   - hamming_kernel<Top2> (akaze_hamming_top2) writes the raw top-2 for
//     extents given as device scalars, for the tools and tests;
//   - no host sync, no allocation, one launch on the caller's stream
//     (cudaLaunchKernelEx for the cluster).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int GROUPS = 2;           // warpgroups per CTA, 64 queries each
constexpr int QB = 64 * GROUPS;     // queries per CTA
constexpr int THREADS = 128 * GROUPS;
constexpr int RANKS = 8;            // CTAs per cluster (train range split)
constexpr int CH = 64;              // train rows per chunk: the wgmma's N
constexpr int KS = 16;              // k-steps of 32 lanes: 512 bits
constexpr int ROWB = 80;            // staged row stride in bytes (banks)
constexpr int HALF = CH * 16;       // bytes of one k-step's 16-lane half
constexpr int KSTEP = 2 * HALF;     // bytes of one k-step of the B tile
constexpr int TILE = (KS + 1) * KSTEP;   // a chunk's B tile, + the bias
constexpr int BITS = 512;
constexpr int BIG = 1 << 20;
constexpr int NONE = -(1 << 30);    // below any dot, invalid ones included
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 16;

// bit 0 of each byte of x -> that byte's int8 lane: +1 for a 0 bit, -1 for
// a 1 bit (b * 0xFE + 1)
__device__ __forceinline__ uint32_t pm1(uint32_t x) {
  return (x & 0x01010101u) * 0xFEu + 0x01010101u;
}

// B tile descriptor of one k-step: K-major, no swizzle; core matrices of
// 8 rows x 16 bytes, rows 16 bytes apart; the two 16-lane halves of the
// k-step HALF bytes apart (leading byte offset), 8-row groups 128 bytes
// apart (stride byte offset)
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(smem));
  return ((a & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(HALF >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// the accumulators are the wgmma's between issue and wait: keep every
// other access on the far side of these
__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// two partial results of disjoint column sets, in any order
__device__ __forceinline__ void merge(int& b, int& s, int& i, int b2, int s2,
                                      int i2) {
  s = max(min(b, b2), max(s, s2));
  i = b2 > b ? i2 : (b2 == b ? min(i, i2) : i);
  b = max(b, b2);
}

// shared memory of one CTA (dynamic: more than the 48 KB of static); the
// B tiles lead, 128-byte aligned
struct Smem {
  unsigned char tile[2][TILE];       // +-1 B tiles of two chunks
  unsigned char rows[3][CH * ROWB];  // staged rows of three chunks
  int part[3][QB];   // best dot, second dot, index per query
  int warp_last[THREADS / 32];       // train extent: per warp, then
  int last;                          // this rank's slice
};

// What a launch writes per query row, from its merged (best dot, second
// dot, index); a dot below -512 is no train row.  ``live``: the row lies
// in the scanned query range.

// hamming_top2's raw result; the scan extents are device scalars
struct Top2 {
  const int* q_count;   // one past the last live query
  const int* t_count;   // one past the last live train row
  int* best;
  int* second;
  int* idx;

  __device__ void write(int row, bool live, int b, int s, int i) const {
    best[row] = live && b >= -BITS ? (BITS - b) >> 1 : BIG;
    second[row] = live && s >= -BITS ? (BITS - s) >> 1 : BIG;
    idx[row] = live && b >= -BITS ? i : -1;
  }
};

// hamming_match's Matches: the rule of match.py's matches_from_top2 (a
// unique minimum below max_dist for a valid query), integer comparisons
// and gathers, so equal to the plain chain bit for bit; rejected rows hold
// -1 in every field
struct Accept {
  const unsigned char* q_valid;
  const float* tx;
  const float* ty;
  int max_dist;
  int* index;
  float* distance;
  float* x;
  float* y;

  __device__ void write(int row, bool live, int b, int s, int i) const {
    const int best = (BITS - b) >> 1;
    const int second = s >= -BITS ? (BITS - s) >> 1 : BIG;
    const bool ok = live && b >= -BITS && best < second && best < max_dist &&
                    q_valid[row] != 0;
    index[row] = ok ? i : -1;
    distance[row] = ok ? static_cast<float>(best) : -1.0f;
    x[row] = ok ? tx[i] : -1.0f;
    y[row] = ok ? ty[i] : -1.0f;
  }
};

// one past the last nonzero byte of valid[0, n) (0 if none), on every CTA
// of the cluster: each rank scans an eighth, the ranks' maxima meet
// through distributed shared memory
__device__ int cluster_last_live(const unsigned char* __restrict__ valid,
                                 int n, Smem& sm,
                                 cg::cluster_group& cluster, int rank,
                                 int tid) {
  const int span = (n + RANKS - 1) / RANKS;
  const int end = min((rank + 1) * span, n);
  int last = 0;
#pragma unroll 4
  for (int j = rank * span + tid; j < end; j += THREADS)
    if (__ldg(valid + j) != 0) last = j + 1;
  last = __reduce_max_sync(FULL, last);
  if ((tid & 31) == 0) sm.warp_last[tid >> 5] = last;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) last = max(last, sm.warp_last[w]);
    sm.last = last;
  }
  cluster.sync();
  int all = 0;
#pragma unroll
  for (int k = 0; k < RANKS; ++k)
    all = max(all, *cluster.map_shared_rank(&sm.last, k));
  return all;
}

template <class Out>
__global__ void __launch_bounds__(THREADS, 2)
hamming_kernel(const uint32_t* __restrict__ q, int n1,
               const uint32_t* __restrict__ t,
               const unsigned char* __restrict__ tvalid, int n2, Out out) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  constexpr bool kTop2 = std::is_same<Out, Top2>::value;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;      // in warpgroup warp / 4; rows from 16 warp
  const int g = lane >> 2;        // quad: row of A and of the accumulator
  const int tq = lane & 3;        // lane in the quad: bit planes tq, tq + 4
  const int q0 = static_cast<int>(blockIdx.x) / RANKS * QB;

  // scan extents: top-2 reads them; the match finds them here, a query
  // tile by its own validity (a row past the last valid query is invalid
  // itself, so rejected either way), the train range by the cluster
  int nq = n1, nt = n2;
  bool idle;
  if constexpr (kTop2) {
    nq = max(min(*out.q_count, n1), 0);
    nt = max(min(*out.t_count, n2), 0);
    idle = q0 >= nq;
  } else {
    idle = !__syncthreads_or(tid < QB && q0 + tid < n1 &&
                             out.q_valid[q0 + tid] != 0);
  }
  if (idle) {   // the same for every rank of the cluster
    if (rank == 0 && tid < QB && q0 + tid < n1)
      out.write(q0 + tid, false, NONE, NONE, -1);
    return;
  }
  if constexpr (!kTop2) nt = cluster_last_live(tvalid, n2, sm, cluster,
                                               rank, tid);

  // this rank's share of the live train range, whole chunks but the last
  const int per = ((nt + RANKS - 1) / RANKS + CH - 1) / CH * CH;
  const int lo = min(rank * per, nt);
  const int hi = min(lo + per, nt);
  const int chunks = (hi - lo + CH - 1) / CH;

  // running (best dot, second dot, index) of rows 16 warp + g + 8h
  int bd[2] = {NONE, NONE}, sd[2] = {NONE, NONE}, bi[2] = {-1, -1};

  if (chunks > 0) {
    // stage chunk c's rows (zero-filled past hi) into rows[c % 3]
    auto stage = [&](int c) {
      const int base = lo + c * CH;
#pragma unroll
      for (int i = 0; i < CH * 4 / THREADS; ++i) {
        const int p = tid + i * THREADS;
        const int r = p >> 2;
        const bool in = base + r < hi;
        cp_async16(&sm.rows[c % 3][r * ROWB + (p & 3) * 16],
                   t + (in ? 16 * static_cast<size_t>(base + r) + 4 * (p & 3)
                           : 0),
                   in ? 16 : 0);
      }
    };
    // the B tile of chunk c: thread (row n, words 4k..4k+3) writes k-steps
    // 4k..4k+3, both halves; the threads of rows 0..63 the bias k-step;
    // then the tile is made visible to the tensor cores' reads
    auto expand = [&](int c) {
      const int n = tid & (CH - 1);
      const int r = lo + c * CH + n;
      const bool valid = tid < CH && r < hi && __ldg(tvalid + r) != 0;
      unsigned char* tile = sm.tile[c & 1];
#pragma unroll
      for (int k = tid / CH; k < KS / 4; k += THREADS / CH) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            &sm.rows[c % 3][n * ROWB + 16 * k]);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = ws[j];
          unsigned char* at = tile + (4 * k + j) * KSTEP + n * 16;
          *reinterpret_cast<uint4*>(at) = make_uint4(
              pm1(v), pm1(v >> 1), pm1(v >> 2), pm1(v >> 3));
          *reinterpret_cast<uint4*>(at + HALF) = make_uint4(
              pm1(v >> 4), pm1(v >> 5), pm1(v >> 6), pm1(v >> 7));
        }
      }
      if (tid < CH) {
        const uint32_t b = valid ? 0u : 0x80808080u;
        unsigned char* at = tile + KS * KSTEP + n * 16;
        *reinterpret_cast<uint4*>(at) = make_uint4(b, b, b, b);
        *reinterpret_cast<uint4*>(at + HALF) = make_uint4(b, b, b, b);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };

    stage(0);
    cp_async_commit();
    if (chunks > 1) stage(1);
    cp_async_commit();
    if (chunks > 2) stage(2);
    cp_async_commit();

    // A fragments of rows ra (a[s][0], a[s][2]) and ra + 8 (a[s][1],
    // a[s][3]), k-step s, as wgmma takes them from registers
    uint32_t a[KS + 1][4];
    const int ra = q0 + 16 * warp + g;
    const uint4* q4 = reinterpret_cast<const uint4*>(q);
#pragma unroll
    for (int w = 0; w < KS / 4; ++w) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const uint4 va = ra < n1 ? __ldg(q4 + 4 * ra + w) : z;
      const uint4 vb = ra + 8 < n1 ? __ldg(q4 + 4 * (ra + 8) + w) : z;
      const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
      const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * w + j;
        a[s][0] = pm1(wa[j] >> tq);
        a[s][1] = pm1(wb[j] >> tq);
        a[s][2] = pm1(wa[j] >> (tq + 4));
        a[s][3] = pm1(wb[j] >> (tq + 4));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[KS][i] = 0x01010101u;   // bias k-step

    cp_async_wait1();   // chunks 0 and 1 have landed
    __syncthreads();
    expand(0);

    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();   // chunk c's tile written, chunk c - 1's consumed
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      fence_regs(acc);
      const unsigned char* tile = sm.tile[c & 1];
#pragma unroll
      for (int s = 0; s <= KS; ++s)
        wgmma_s8(acc, a[s], b_desc(tile + s * KSTEP), s > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // while the tensor cores work: stage chunk c + 3 into the rows of
      // chunk c (expanded already), expand chunk c + 1
      if (c + 3 < chunks) stage(c + 3);
      cp_async_commit();
      if (c + 1 < chunks) expand(c + 1);
      cp_async_wait1();   // chunk c + 2 has landed
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);

      // acc[4i + e] is row g, column 8i + 2tq + e; acc[4i + 2 + e] row
      // g + 8.  Visiting order v = 2i + e ascends with the column.
      int kb[2] = {NONE, NONE}, ks[2] = {NONE, NONE};
#pragma unroll
      for (int i = 0; i < CH / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = acc[4 * i + 2 * h + e] * 16 + (15 - 2 * i - e);
            ks[h] = max(ks[h], min(kb[h], key));
            kb[h] = max(kb[h], key);
          }
      const int col0 = lo + c * CH + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 15 - (kb[h] & 15);
        merge(bd[h], sd[h], bi[h], kb[h] >> 4, ks[h] >> 4,
              col0 + 8 * (v >> 1) + (v & 1));
      }
    }
  }

  // the quad's four column sets, then this CTA's partials
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      merge(bd[h], sd[h], bi[h], __shfl_xor_sync(FULL, bd[h], off),
            __shfl_xor_sync(FULL, sd[h], off),
            __shfl_xor_sync(FULL, bi[h], off));
    if (tq == 0) {
      const int r = 16 * warp + g + 8 * h;
      sm.part[0][r] = bd[h];
      sm.part[1][r] = sd[h];
      sm.part[2][r] = bi[h];
    }
  }
  cluster.sync();

  // rank k merges rows [k * QB / RANKS, (k + 1) * QB / RANKS) over the
  // ranks' partials and writes them
  if (tid < QB / RANKS) {
    const int r = rank * (QB / RANKS) + tid;
    int b = NONE, s = NONE, i = -1;
#pragma unroll
    for (int k = 0; k < RANKS; ++k) {
      const int* part = cluster.map_shared_rank(&sm.part[0][0], k);
      merge(b, s, i, part[r], part[QB + r], part[2 * QB + r]);
    }
    const int row = q0 + r;
    if (row < n1) out.write(row, row < nq, b, s, i);
  }
  cluster.sync();   // no rank leaves while another reads its partials
}

// one launch of hamming_kernel<Out> over n1 queries on the current device
template <class Out>
int launch(const void* q, int n1, const void* t, const void* tvalid, int n2,
           const Out& out, void* stream) {
  if (n1 < 0 || n2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool ready[MAX_DEVICES] = {};   // one per kernel
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(hamming_kernel<Out>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n1 + QB - 1) / QB * RANKS), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, hamming_kernel<Out>,
                         static_cast<const uint32_t*>(q), n1,
                         static_cast<const uint32_t*>(t),
                         static_cast<const unsigned char*>(tvalid), n2, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [n1, 16], t [n2, 16]: 32-bit descriptor words (16-byte aligned);
// tvalid [n2] bytes; q_count, t_count: device int32 scalars, one past the
// last live query / train row.  Out: best, second, idx [n1] int32.
extern "C" int akaze_hamming_top2(const void* q, int n1, const int* q_count,
                                  const void* t, const void* tvalid, int n2,
                                  const int* t_count, int* best, int* second,
                                  int* idx, void* stream) {
  return launch(q, n1, t, tvalid, n2,
                Top2{q_count, t_count, best, second, idx}, stream);
}

// The whole match in one launch on ``device`` (made current for it): q
// [n1, 16] and qvalid [n1] bytes, t [n2, 16], tvalid [n2], tx, ty [n2]
// float; queries accepted below max_dist.  Out: index [n1] int32,
// distance, x, y [n1] float.
extern "C" int akaze_hamming_match(int device, const void* q,
                                   const void* qvalid, int n1, const void* t,
                                   const void* tvalid, int n2, const void* tx,
                                   const void* ty, int max_dist, void* index,
                                   void* distance, void* x, void* y,
                                   void* stream) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (current != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(e);
  const int err = launch(
      q, n1, t, tvalid, n2,
      Accept{static_cast<const unsigned char*>(qvalid),
             static_cast<const float*>(tx), static_cast<const float*>(ty),
             max_dist, static_cast<int*>(index),
             static_cast<float*>(distance), static_cast<float*>(x),
             static_cast<float*>(y)},
      stream);
  if (current != device) cudaSetDevice(current);
  return err;
}
