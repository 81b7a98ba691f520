// Pose-graph optimisation in one launch: the whole Gauss-Newton loop of
// slam/posegraph.py (`gauss_newton` with one graph on one device) in one
// thread block, bit for bit what the plain loop computes on the card.
//
// Replaces no TPU kernel.  The JAX package leaves PGO to XLA
// (akaze_tpu/slam/posegraph.py), which compiles its loops into one
// program.  The plain PyTorch form, which ops/pgo.py runs on CPU tensors
// and which `optimize_pose_graph` captured into a CUDA graph before, is
// ~16,000 small kernels a call (10 Gauss-Newton steps, each 50 CG steps of
// ~25 kernels, plus the derivative blocks and the median): on the SLAM
// route's graphs (16 poses, 32 edges) it took 41-47 ms a call on the
// H100, ~2.4 us a kernel, for a few hundred FLOPs each.
//
// What bounds it on the H100: the latency of the chain of dependent steps.
// A CG step is ~8 block-wide barriers apart (J p; J^T J p; the two dot
// products, each Reduce.cuh's lane sums and tree; the new direction, read
// by every thread of the next step); the bytes (one read of the graph, one
// write of the poses) and the FLOPs (a few thousand a CG step) cost
// nothing beside it.
//
// Why bit for bit: the SLAM route's graphs are ill-conditioned (keyframe
// translations from 1 to 1e5 under a monocular scale drift), so the plain
// loop itself, run on the CPU instead of the card, ends radians away; any
// other order of sums would do the same.  So every sum runs in the order
// of the PyTorch operation it replaces (csrc/se3.cuh: cuBLAS's fused
// chains for the small products, the reductions' lanes):
//   - J v and J^T u are cuBLAS matrix-vector products (se3::dot); the
//     plain loop's blocks are column-major (a permuted tangent), so J v
//     takes the transposed kernel's pattern (by the batch, se3::gemv_t)
//     and J^T u the untransposed one;
//   - J^T u's sum over a node's edges is a product with a one-hot matrix:
//     cuBLAS splits the edges into chunks of a size it picks by shape
//     (`onehot_chunk`), adds each chunk's edges in order and the chunks in
//     order;
//   - dot products and costs are `torch.sum` over the whole vector, whose
//     lanes and tree (`torch_sum`) follow Reduce.cuh.
//
// The design: one CTA of 256 threads solves one graph.  Poses, edges,
// residuals, IRLS weights, the derivative blocks [E, 6, 12] and the CG
// vectors [N, 6] live in shared memory (the main path's graphs need under
// 40 KB); a graph whose blocks do not fit keeps them, and one whose other
// arrays do not fit keeps those too, in a global scratch buffer that the
// wrapper allocates (`akaze_pgo_scratch` gives its size).  Per
// Gauss-Newton step, as `gauss_newton` does it:
//   - each edge's residual (a thread an edge); with a robust loss the
//     threshold robust_delta x the lower median of the residual norms
//     over the edges of weight > 0 (each such edge's rank in a strict
//     total order, NaN last as torch.sort puts it), and the IRLS
//     sqrt-weights h of `_irls_weights`;
//   - the derivative blocks d r_e / d xi_i and d r_e / d xi_j at xi = 0,
//     a thread per (edge, basis direction): forward-mode dual numbers
//     through the retraction and the residual (se3::edge_column), times
//     h_e and the free masks;
//   - g = J^T (r h); CG on (J^T J + damping I) from x0 = 0 (J v a thread
//     per (edge, row); J^T u a thread per (node, row) over its incident
//     edges, from incidence lists built once a launch), the update masked
//     by `free`, the right retraction T exp(dx), kept only where the
//     IRLS-weighted cost falls.
// The final unweighted cost is returned.
//
// No atomics, so the kernel repeats bit for bit.  Two early exits give the
// same result as running on: CG stops once |r|^2 <= tol^2 |b|^2 (the plain
// solver freezes its iterate there), and Gauss-Newton stops at its first
// rejected step (the poses are unchanged, so every later step computes the
// same rejected update).
#include <cuda_runtime.h>

#include "se3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK = 72;           // one edge's blocks: 6 rows x 12 columns
constexpr int LANES = 512;          // Reduce.cuh's widest block
constexpr int MAX_SMEM = 232448;    // shared memory one CTA may use
constexpr int STATIC_SMEM = 1024;   // room kept for the static arrays below
constexpr int MAX_DEVICES = 16;
// tol^2 of linalg.cg (tol 1e-5), a Python number rounded to float32
constexpr float CG_TOL2 = static_cast<float>(1e-5 * 1e-5);

enum Robust { NONE = 0, HUBER = 1, CAUCHY = 2 };

// Offsets (4-byte words) of the arrays other than the blocks.
struct Layout {
  long R, t, R2, t2, free, Rm, tij, tm, w, ei, ej, res, h, nrm, u, x, r, p,
      Ap, offI, lstI, offJ, lstJ, lanes, total;
};

__host__ __device__ Layout layout(int N, int E) {
  Layout L;
  long o = 0;
  L.R = o;     o += 9L * N;
  L.t = o;     o += 3L * N;
  L.R2 = o;    o += 9L * N;
  L.t2 = o;    o += 3L * N;
  L.free = o;  o += N;
  L.Rm = o;    o += 9L * E;     // R_ij^T
  L.tij = o;   o += 3L * E;
  L.tm = o;    o += 3L * E;     // -R_ij^T t_ij
  L.w = o;     o += E;
  L.ei = o;    o += E;
  L.ej = o;    o += E;
  L.res = o;   o += 6L * E;
  L.h = o;     o += E;
  L.nrm = o;   o += E;
  L.u = o;     o += 6L * E;
  L.x = o;     o += 6L * N;
  L.r = o;     o += 6L * N;
  L.p = o;     o += 6L * N;
  L.Ap = o;    o += 6L * N;
  L.offI = o;  o += N + 1;
  L.lstI = o;  o += E;
  L.offJ = o;  o += N + 1;
  L.lstJ = o;  o += E;
  L.lanes = o; o += LANES;
  L.total = o;
  return L;
}

// Where the arrays live: `a_smem` the arrays of Layout, `j_smem` the
// blocks, each in dynamic shared memory or else in the scratch buffer.
struct Plan {
  int a_smem, j_smem, smem;
  long long scratch;          // floats of global scratch needed
};

Plan plan(int N, int E) {
  const long a = layout(N, E).total, j = static_cast<long>(BLOCK) * E;
  const long room = (MAX_SMEM - STATIC_SMEM) / 4;
  Plan P;
  P.a_smem = a <= room;
  P.j_smem = a + j <= room;
  P.smem = static_cast<int>(4 * ((P.a_smem ? a : 0) + (P.j_smem ? j : 0)));
  P.scratch = (P.a_smem ? 0 : a) + (P.j_smem ? 0 : j);
  return P;
}

struct Args {
  const float *R0, *t0, *Rij, *tij, *w, *damping;
  const int *ei, *ej;
  const unsigned char* fixed;
  float *R, *t, *cost, *scratch;
  int N, E, iters, cg_iters, robust;
  float robust_delta;
  Plan plan;
};

// The chunk of edges (K) in which cuBLAS sums the product of an [N, E]
// one-hot matrix with [E, 6] values on the H100 (read off the card for N
// 8-512, E 8-2048); other shapes take one chunk.
__host__ __device__ int onehot_chunk(int N, int E) {
  switch (E) {
    case 8: return 4;
    case 16: return N <= 16 ? 8 : 4;
    case 32: return N <= 16 ? 16 : 32;
    case 64:
    case 128: return 32;
    case 256: return N == 32 ? 64 : 32;
    case 512: return N == 32 ? 128 : 32;
    case 1024: return N <= 16 || N == 128 ? 32 : 64;
    case 2048: return N <= 16 ? 64 : (N <= 64 ? 128 : (N == 128 ? 32 : 64));
    default: return E > 0 ? E : 1;
  }
}

__device__ int last_pow2(int n) {
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}

// torch.sum of value(0..n-1) as Reduce.cuh sums a contiguous float32
// tensor whole: lane L of a block of `bw` lanes adds its share into four
// accumulators (4-wide loads from 128 values on), combined in order; a
// tree over the lanes, in shared memory down to 32 and then shuffles.
// Every thread returns the sum.  `lanes`: LANES floats.
template <class F>
__device__ float torch_sum(int n, F value, float* lanes, float* slot) {
  const bool vec = n >= 128;
  const int dim0 = vec ? n / 4 : n;
  const int bw = dim0 < LANES ? last_pow2(dim0 > 0 ? dim0 : 1) : LANES;
  for (int L = threadIdx.x; L < bw; L += THREADS) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (vec) {
      for (int i = L; 4 * i + 3 < n; i += bw) {
        a0 = a0 + value(4 * i);
        a1 = a1 + value(4 * i + 1);
        a2 = a2 + value(4 * i + 2);
        a3 = a3 + value(4 * i + 3);
      }
      const int tail = n - n % 4;
      if (tail + L < n) a0 = a0 + value(tail + L);
    } else {
      int i = L;
      for (; i + 3 * bw < n; i += 4 * bw) {
        a0 = a0 + value(i);
        a1 = a1 + value(i + bw);
        a2 = a2 + value(i + 2 * bw);
        a3 = a3 + value(i + 3 * bw);
      }
      float* acc[4] = {&a0, &a1, &a2, &a3};
      for (int k = 0; k < 4 && i < n; ++k, i += bw) *acc[k] = *acc[k] + value(i);
    }
    lanes[L] = ((a0 + a1) + a2) + a3;
  }
  __syncthreads();
  for (int off = bw / 2; off >= 32; off >>= 1) {
    for (int L = threadIdx.x; L < off; L += THREADS)
      lanes[L] = lanes[L] + lanes[L + off];
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    const int dim = bw < 32 ? bw : 32;
    float v = static_cast<int>(threadIdx.x) < dim ? lanes[threadIdx.x] : 0.0f;
    for (int off = dim / 2; off > 0; off >>= 1)
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) *slot = v;
  }
  __syncthreads();
  return *slot;
}

// The median's order: by norm, NaN last (as torch.sort), ties by index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return nb;
  if (!na && a != b) return a < b;
  return ia < ib;
}

// One segment_sum of `jt`: the sum over node n's incident edges `lst`
// (ascending) of J_e^T u_e's component c, block `side` (0 the left, 6 the
// right), grouped in the one-hot product's chunks of `chunk` edges.
__device__ __forceinline__ float segment(const float* J, const float* u,
                                         const int* lst, int lo, int hi,
                                         int side, int c, int chunk) {
  float total = 0.0f, part = 0.0f;
  int at = -1;
  for (int a = lo; a < hi; ++a) {
    const int e = lst[a];
    const float* Je = J + static_cast<long>(BLOCK) * e + side + c;
    const float col[6] = {Je[0], Je[12], Je[24], Je[36], Je[48], Je[60]};
    const float v = se3::dot<6>(col, u + 6 * e, se3::HALVES);
    if (e / chunk != at) {
      total = total + part;
      part = 0.0f;
      at = e / chunk;
    }
    part = part + v;
  }
  return total + part;
}

__device__ __forceinline__ float irls(float norm, float delta, int robust) {
  if (robust == CAUCHY) {
    const float q = norm / delta;
    return sqrtf(1.0f / (1.0f + q * q));
  }
  if (robust == HUBER)
    return sqrtf(se3::clamp_(delta / se3::clamp_(norm, 1e-12f, INFINITY),
                             -INFINITY, 1.0f));
  return 1.0f;
}

__global__ void __launch_bounds__(THREADS) pgo_solve_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float s_slot, s_median;
  __shared__ int s_bad, s_count;
  const int tid = threadIdx.x, N = a.N, E = a.E;
  const Layout L = layout(N, E);
  float* A = a.plan.a_smem ? smem : a.scratch;
  float* J = a.plan.j_smem ? smem + L.total
                           : a.scratch + (a.plan.a_smem ? 0 : L.total);
  float *R = A + L.R, *t = A + L.t, *R2 = A + L.R2, *t2 = A + L.t2;
  float *freef = A + L.free, *Rm = A + L.Rm, *tij = A + L.tij;
  float *tm = A + L.tm, *w = A + L.w, *res = A + L.res, *h = A + L.h;
  float *nrm = A + L.nrm, *u = A + L.u, *x = A + L.x, *r = A + L.r;
  float *p = A + L.p, *Ap = A + L.Ap, *lanes = A + L.lanes;
  int* ei = reinterpret_cast<int*>(A + L.ei);
  int* ej = reinterpret_cast<int*>(A + L.ej);
  int* offI = reinterpret_cast<int*>(A + L.offI);
  int* lstI = reinterpret_cast<int*>(A + L.lstI);
  int* offJ = reinterpret_cast<int*>(A + L.offJ);
  int* lstJ = reinterpret_cast<int*>(A + L.lstJ);
  const float damping = *a.damping;
  const int V = 6 * N;
  const int pat_e = se3::gemv_t(E);       // products over the E edges
  const int chunk = onehot_chunk(N, E);

  // ---- the graph, once a launch
  if (tid == 0) {
    s_bad = 0;
    s_count = 0;
  }
  __syncthreads();
  for (int n = tid; n < N; n += THREADS) {
    for (int k = 0; k < 9; ++k) R[9 * n + k] = a.R0[9 * n + k];
    for (int k = 0; k < 3; ++k) t[3 * n + k] = a.t0[3 * n + k];
    freef[n] = a.fixed[n] ? 0.0f : 1.0f;
  }
  for (int e = tid; e < E; e += THREADS) {
    int i = a.ei[e], j = a.ej[e];
    if (i < 0 || i >= N || j < 0 || j >= N) {   // no such pose: cost NaN
      s_bad = 1;
      i = i < 0 ? 0 : (i >= N ? N - 1 : i);
      j = j < 0 ? 0 : (j >= N ? N - 1 : j);
    }
    ei[e] = i;
    ej[e] = j;
    w[e] = a.w[e];
    if (a.w[e] > 0.0f) atomicAdd(&s_count, 1);   // an integer: exact
    for (int k = 0; k < 3; ++k) tij[3 * e + k] = a.tij[3 * e + k];
    se3::inverse(a.Rij + 9 * e, a.tij + 3 * e, Rm + 9 * e, tm + 3 * e,
                 pat_e);
  }
  __syncthreads();
  const int count = s_count;
  const int median_rank = (count > 0 ? count - 1 : 0) / 2;
  for (int n = tid; n < N; n += THREADS) {
    int ci = 0, cj = 0;
    for (int e = 0; e < E; ++e) {
      ci += ei[e] == n;
      cj += ej[e] == n;
    }
    offI[n + 1] = ci;
    offJ[n + 1] = cj;
  }
  __syncthreads();
  if (tid == 0) {
    offI[0] = offJ[0] = 0;
    for (int n = 0; n < N; ++n) {
      offI[n + 1] += offI[n];
      offJ[n + 1] += offJ[n];
    }
  }
  __syncthreads();
  for (int n = tid; n < N; n += THREADS) {
    int ai = offI[n], aj = offJ[n];
    for (int e = 0; e < E; ++e) {
      if (ei[e] == n) lstI[ai++] = e;
      if (ej[e] == n) lstJ[aj++] = e;
    }
  }
  __syncthreads();

  // (J^T u + damping v)[q], q = 6 n + c (damping v left out when v is null)
  auto jtu = [&](int q, const float* v) {
    const int n = q / 6, c = q % 6;
    const float s =
        segment(J, u, lstI, offI[n], offI[n + 1], 0, c, chunk) +
        segment(J, u, lstJ, offJ[n], offJ[n + 1], 6, c, chunk);
    return v ? s + damping * v[q] : s;
  };

  // ---- Gauss-Newton
  for (int it = 0; it < a.iters; ++it) {
    for (int e = tid; e < E; e += THREADS) {
      float* re = res + 6 * e;
      se3::pair_residual(R + 9 * ei[e], t + 3 * ei[e], R + 9 * ej[e],
                         t + 3 * ej[e], Rm + 9 * e, tm + 3 * e, w[e], re,
                         pat_e, pat_e);
      float sq[6];
      for (int k = 0; k < 6; ++k) sq[k] = re[k] * re[k];
      nrm[e] = sqrtf(se3::sum6(sq));
    }
    __syncthreads();
    float delta = 1.0f;
    if (a.robust != NONE) {
      for (int e = tid; e < E; e += THREADS) {
        if (!(w[e] > 0.0f)) continue;
        int rank = 0;
        for (int f = 0; f < E; ++f)
          rank += w[f] > 0.0f && before(nrm[f], f, nrm[e], e);
        if (rank == median_rank) s_median = nrm[e];
      }
      __syncthreads();
      const float d = a.robust_delta * (count > 0 ? s_median : 0.0f);
      delta = d < 1e-12f ? 1e-12f : d;
    }
    // derivative blocks of r_e h_e in the free updates; g's edge vectors
    for (int q = tid; q < 12 * E; q += THREADS) {
      const int e = q / 12, col = q % 12, i = ei[e], j = ej[e];
      float column[6];
      se3::edge_column(R + 9 * i, t + 3 * i, R + 9 * j, t + 3 * j,
                       Rm + 9 * e, tij + 3 * e, w[e], col, E, column);
      const float he = irls(nrm[e], delta, a.robust);
      const float scale = he * freef[col < 6 ? i : j];
      float* Je = J + static_cast<long>(BLOCK) * e + col;
      for (int k = 0; k < 6; ++k) Je[12 * k] = column[k] * scale;
      if (col == 0) h[e] = he;
      if (col < 6) u[6 * e + col] = res[6 * e + col] * he;
    }
    __syncthreads();
    // b = -J^T (r h); x = 0, r = b, p = r
    for (int q = tid; q < V; q += THREADS) {
      const float b = -jtu(q, nullptr);
      x[q] = 0.0f;
      r[q] = b;
      p[q] = b;
    }
    __syncthreads();
    float gamma = torch_sum(V, [&](int q) { return r[q] * r[q]; }, lanes,
                            &s_slot);
    const float atol2 = CG_TOL2 * gamma;
    for (int k = 0; k < a.cg_iters && gamma > atol2; ++k) {
      for (int q = tid; q < 6 * E; q += THREADS) {
        const int e = q / 6, row = q % 6;
        const float* Je = J + static_cast<long>(BLOCK) * e + 12 * row;
        u[q] = se3::dot<6>(Je, p + 6 * ei[e], pat_e) +
               se3::dot<6>(Je + 6, p + 6 * ej[e], pat_e);
      }
      __syncthreads();
      for (int q = tid; q < V; q += THREADS) Ap[q] = jtu(q, p);
      __syncthreads();
      const float alpha =
          gamma / torch_sum(V, [&](int q) { return p[q] * Ap[q]; }, lanes,
                            &s_slot);
      for (int q = tid; q < V; q += THREADS) {
        x[q] = x[q] + alpha * p[q];
        r[q] = r[q] - alpha * Ap[q];
      }
      __syncthreads();
      const float gamma_new = torch_sum(
          V, [&](int q) { return r[q] * r[q]; }, lanes, &s_slot);
      const float beta = gamma_new / gamma;
      for (int q = tid; q < V; q += THREADS) p[q] = r[q] + beta * p[q];
      gamma = gamma_new;
      __syncthreads();
    }
    // the candidate poses T exp(dx free)
    for (int n = tid; n < N; n += THREADS) {
      float dx[6];
      for (int c = 0; c < 6; ++c) dx[c] = x[6 * n + c] * freef[n];
      se3::retract(R + 9 * n, t + 3 * n, dx, R2 + 9 * n, t2 + 3 * n);
    }
    __syncthreads();
    // the candidate's IRLS-weighted residuals, into u
    for (int e = tid; e < E; e += THREADS) {
      float r2[6];
      se3::pair_residual(R2 + 9 * ei[e], t2 + 3 * ei[e], R2 + 9 * ej[e],
                         t2 + 3 * ej[e], Rm + 9 * e, tm + 3 * e, w[e], r2,
                         pat_e, pat_e);
      for (int k = 0; k < 6; ++k) u[6 * e + k] = r2[k] * h[e];
    }
    __syncthreads();
    const float cost2 =
        0.5f * torch_sum(6 * E, [&](int q) { return u[q] * u[q]; }, lanes,
                         &s_slot);
    const float cost1 = 0.5f * torch_sum(6 * E, [&](int q) {
                          const float c = res[q] * h[q / 6];
                          return c * c;
                        }, lanes, &s_slot);
    if (!(cost2 < cost1)) break;   // rejected: the same every step on
    for (int n = tid; n < N; n += THREADS) {
      for (int k = 0; k < 9; ++k) R[9 * n + k] = R2[9 * n + k];
      for (int k = 0; k < 3; ++k) t[3 * n + k] = t2[3 * n + k];
    }
    __syncthreads();
  }

  // ---- the unweighted cost of the final poses, and the poses
  for (int e = tid; e < E; e += THREADS)
    se3::pair_residual(R + 9 * ei[e], t + 3 * ei[e], R + 9 * ej[e],
                       t + 3 * ej[e], Rm + 9 * e, tm + 3 * e, w[e],
                       res + 6 * e, pat_e, pat_e);
  __syncthreads();
  const float cost =
      0.5f * torch_sum(6 * E, [&](int q) { return res[q] * res[q]; }, lanes,
                       &s_slot);
  for (int n = tid; n < N; n += THREADS) {
    for (int k = 0; k < 9; ++k) a.R[9 * n + k] = R[9 * n + k];
    for (int k = 0; k < 3; ++k) a.t[3 * n + k] = t[3 * n + k];
  }
  if (tid == 0) *a.cost = s_bad ? __int_as_float(0x7fc00000) : cost;
}

}  // namespace

// Floats of global scratch that `akaze_pgo_solve` needs for a graph of N
// poses and E edges (0 when everything fits in shared memory).
extern "C" int akaze_pgo_scratch(int N, int E, long long* floats) {
  if (N < 0 || E < 0) return static_cast<int>(cudaErrorInvalidValue);
  *floats = plan(N, E).scratch;
  return 0;
}

// PGO of one graph (ops/pgo.py pgo_solve): poses R0 [N, 3, 3], t0 [N, 3];
// edges ei, ej [E] (int32), Rij [E, 3, 3], tij [E, 3], w [E]; fixed [N]
// (bytes 0 / 1); damping: a device float; robust 0 none, 1 huber, 2
// cauchy.  Out: R [N, 3, 3], t [N, 3], cost (a device float; NaN if an
// edge names no pose).  scratch: `akaze_pgo_scratch` floats of device
// memory (may be null when that is 0).  launches: the kernels launched.
extern "C" int akaze_pgo_solve(const void* R0, const void* t0,
                               const void* ei, const void* ej,
                               const void* Rij, const void* tij,
                               const void* w, const void* fixed,
                               const void* damping, int N, int E, int iters,
                               int cg_iters, int robust, float robust_delta,
                               void* R, void* t, void* cost, void* scratch,
                               long long scratch_floats, void* stream,
                               int* launches) {
  static int have[MAX_DEVICES] = {};
  *launches = 0;
  const Plan P = plan(N, E);
  if (N < 1 || E < 0 || robust < NONE || robust > CAUCHY ||
      scratch_floats < P.scratch || (P.scratch > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.R0 = static_cast<const float*>(R0);
  a.t0 = static_cast<const float*>(t0);
  a.Rij = static_cast<const float*>(Rij);
  a.tij = static_cast<const float*>(tij);
  a.w = static_cast<const float*>(w);
  a.damping = static_cast<const float*>(damping);
  a.ei = static_cast<const int*>(ei);
  a.ej = static_cast<const int*>(ej);
  a.fixed = static_cast<const unsigned char*>(fixed);
  a.R = static_cast<float*>(R);
  a.t = static_cast<float*>(t);
  a.cost = static_cast<float*>(cost);
  a.scratch = static_cast<float*>(scratch);
  a.N = N;
  a.E = E;
  a.iters = iters;
  a.cg_iters = cg_iters;
  a.robust = robust;
  a.robust_delta = robust_delta;
  a.plan = P;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (have[dev] < P.smem) {
    e = cudaFuncSetAttribute(pgo_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    have[dev] = P.smem;
  }
  pgo_solve_kernel<<<1, THREADS, P.smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  *launches = 1;
  return static_cast<int>(cudaGetLastError());
}
