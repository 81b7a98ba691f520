// SE(3) maps of geometry/se3.py and the pose-graph residual of
// slam/posegraph.py, for csrc/pgo.cu: templates over float and over
// forward-mode dual numbers (`Dual`, a value and one tangent), so that one
// pass of the residual with a tangent on one basis direction of the update
// gives one column of the residual's derivative, as `_edge_blocks`'
// forward-mode AD does.
//
// Bit for bit what the plain versions compute on the card (an H100 under
// PyTorch 2.11 / CUDA 12.8), where each PyTorch operation rounds on its
// own:
//   - a product of small matrices is a cuBLAS call, whose sums run in a
//     fixed pattern of fused multiply-adds (`Gemv`): a 3x3 by 3x3 product
//     one chain over k; a matrix by a vector, the vector's two halves each
//     a chain, added; a transposed matrix by a vector (`R^T t`, `J^T u`) a
//     pattern that depends on the batch (`gemv_t`);
//   - `torch.sum` over 3 or 6 values runs Reduce.cuh's lanes:
//     (a0 + a2) + a1 and ((a0 + a4) + a2) + ((a1 + a5) + a3);
//   - a division by a Python number multiplies by its float32 reciprocal;
//   - each branch of `_safe_norm`, `_sinc`, `_cosc`, `so3_log` (small
//     angle, regular, near pi) and `se3_log`/`se3_exp` is chosen on the
//     same test of the value; thresholds are the Python numbers rounded to
//     float32;
//   - tangents follow PyTorch's forward-AD formulas: (a b)' = a' b + a b',
//     (a / b)' = (a' - b' (a / b)) / b, sqrt(a)' = a' / (2 sqrt(a)),
//     acos(a)' = a' (-rsqrt(-a a + 1)), a matrix product's the sum of two
//     products, clamp's passed where min <= a <= max.
// The library builds with --fmad=false, so no other product fuses with a
// sum.  The patterns were read off the card by comparing its results with
// every candidate order (PERF.md); a card or library that chooses other
// patterns gives results that agree to rounding, no longer bit for bit.
//
// The functions compile for the host too (plain C++), so that the kernel's
// arithmetic can be held against the plain versions without a card.
#pragma once

#include <cmath>

#ifdef __CUDACC__
#define SE3_FN __host__ __device__ __forceinline__
#else
#define SE3_FN inline
#endif

namespace se3 {

struct Dual {
  float v, d;
};

SE3_FN float val(float x) { return x; }
SE3_FN float val(Dual x) { return x.v; }

template <class T>
SE3_FN T lift(float x);
template <>
SE3_FN float lift<float>(float x) { return x; }
template <>
SE3_FN Dual lift<Dual>(float x) { return {x, 0.0f}; }

SE3_FN Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
SE3_FN Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
SE3_FN Dual operator-(Dual a) { return {-a.v, -a.d}; }
SE3_FN Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
SE3_FN Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - b.d * q) / b.v};
}
SE3_FN Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
SE3_FN Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
SE3_FN Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
SE3_FN Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
SE3_FN Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
SE3_FN Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }

SE3_FN float sqrt_(float x) { return sqrtf(x); }
SE3_FN Dual sqrt_(Dual x) {
  const float r = sqrtf(x.v);
  return {r, x.d / (2.0f * r)};
}
#ifdef __CUDA_ARCH__
SE3_FN float rsqrt_(float x) { return rsqrtf(x); }
#else
SE3_FN float rsqrt_(float x) { return 1.0f / sqrtf(x); }
#endif
SE3_FN float acos_(float x) { return acosf(x); }
SE3_FN Dual acos_(Dual x) {
  return {acosf(x.v), x.d * -rsqrt_(-x.v * x.v + 1.0f)};
}
SE3_FN float sin_(float x) { return sinf(x); }
SE3_FN Dual sin_(Dual x) { return {sinf(x.v), x.d * cosf(x.v)}; }
SE3_FN float cos_(float x) { return cosf(x); }
SE3_FN Dual cos_(Dual x) { return {cosf(x.v), x.d * -sinf(x.v)}; }

// torch.clamp: NaN stays NaN; the tangent passes where lo <= x <= hi
SE3_FN float clamp_(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
SE3_FN Dual clamp_(Dual x, float lo, float hi) {
  const bool in = x.v >= lo && x.v <= hi;
  return {clamp_(x.v, lo, hi), in ? x.d : 0.0f};
}

// float32 thresholds of se3.py (Python numbers compared in float32)
constexpr float EPS = 1e-8f;                  // _EPS
constexpr float SMALL = 1e-2f;                // _SMALL
constexpr float NORM_EPS = 1e-12f;            // _safe_norm's eps
constexpr float COS_SMALL = static_cast<float>(1.0 - 1e-4);
constexpr float COS_PI = static_cast<float>(-1.0 + 1e-4);
// x / c for a Python number c: x times float32(1 / float32(c))
constexpr float INV6 = 1.0f / 6.0f;
constexpr float INV24 = 1.0f / 24.0f;
constexpr float INV120 = 1.0f / 120.0f;
constexpr float INV720 = 1.0f / 720.0f;

// ---- sums as the card's PyTorch runs them ------------------------------

// The order of a dot product's terms in a cuBLAS kernel (see the header).
enum Gemv {
  CHAIN = 0,     // one fused chain over k
  HALVES = 1,    // a chain over each half (the first the longer), added
  SHUFFLE = 2,   // products summed by a shuffle tree over 8 lanes
  EVEN_ODD = 3,  // a chain over the even k and one over the odd k, added
  CHUNK4 = 4,    // a chain over k < 4 and one over the rest, added
};

// The pattern of a transposed matrix times a vector, for `batch` products
// (cuBLAS's choice on the H100: read off the card for batches of 8 to
// 12288)
SE3_FN int gemv_t(long batch) {
  if (batch <= 96) return CHUNK4;
  if (batch <= 128) return SHUFFLE;
  if (batch >= 1536 && batch <= 2304) return EVEN_ODD;
  return HALVES;
}

SE3_FN float fma_(float a, float b, float c) { return fmaf(a, b, c); }

// sum_k a[k] b[k] over k < K (3 or 6) in pattern `p`
template <int K>
SE3_FN float dot(const float* a, const float* b, int p) {
  float pr[K];
  for (int k = 0; k < K; ++k) pr[k] = a[k] * b[k];
  if (p == SHUFFLE) {
    if (K == 3) return (pr[0] + pr[2]) + pr[1];
    return ((pr[0] + pr[4]) + pr[2]) + ((pr[1] + pr[5]) + pr[3]);
  }
  if (p == EVEN_ODD) {
    float e = pr[0], o = pr[1];
    for (int k = 2; k < K; k += 2) e = fma_(a[k], b[k], e);
    for (int k = 3; k < K; k += 2) o = fma_(a[k], b[k], o);
    return e + o;
  }
  const int split = p == HALVES ? (K + 1) / 2 : (p == CHUNK4 ? 4 : K);
  float s = pr[0];
  for (int k = 1; k < split && k < K; ++k) s = fma_(a[k], b[k], s);
  if (split >= K) return s;
  float t = pr[split];
  for (int k = split + 1; k < K; ++k) t = fma_(a[k], b[k], t);
  return s + t;
}

// torch.sum over the last axis of 3 and of 6 values
template <class T>
SE3_FN T sum3(T a0, T a1, T a2) { return (a0 + a2) + a1; }
template <class T>
SE3_FN T sum6(const T* a) {
  return ((a[0] + a[4]) + a[2]) + ((a[1] + a[5]) + a[3]);
}

// ---- 3x3 products --------------------------------------------------------

// c = a @ b (row-major 3x3): one chain over k
SE3_FN void mul33(const float* a, const float* b, float* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float col[3] = {b[j], b[3 + j], b[6 + j]};
      c[3 * i + j] = dot<3>(a + 3 * i, col, CHAIN);
    }
}
SE3_FN void mul33(const Dual* a, const Dual* b, Dual* c) {
  float av[9], ad[9], bv[9], bd[9], x[9], y[9], z[9];
  for (int k = 0; k < 9; ++k) {
    av[k] = a[k].v; ad[k] = a[k].d; bv[k] = b[k].v; bd[k] = b[k].d;
  }
  mul33(av, bv, x);
  mul33(ad, bv, y);
  mul33(av, bd, z);
  for (int k = 0; k < 9; ++k) c[k] = {x[k], y[k] + z[k]};
}

// y = a @ x in pattern `p`
SE3_FN void mul3(const float* a, const float* x, float* y, int p) {
  for (int i = 0; i < 3; ++i) y[i] = dot<3>(a + 3 * i, x, p);
}
SE3_FN void mul3(const Dual* a, const Dual* x, Dual* y, int p) {
  float av[9], ad[9], xv[3], xd[3], u[3], v[3], w[3];
  for (int k = 0; k < 9; ++k) { av[k] = a[k].v; ad[k] = a[k].d; }
  for (int k = 0; k < 3; ++k) { xv[k] = x[k].v; xd[k] = x[k].d; }
  mul3(av, xv, u, p);
  mul3(ad, xv, v, p);
  mul3(av, xd, w, p);
  for (int k = 0; k < 3; ++k) y[k] = {u[k], v[k] + w[k]};
}

template <class T>
SE3_FN void transpose(const T* R, T* Rt) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
}

// ---- the maps -------------------------------------------------------------

template <class T>
SE3_FN void hat(const T* w, T* W) {
  const T z = lift<T>(0.0f);
  W[0] = z;     W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = z;     W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = z;
}

template <class T>
SE3_FN T safe_norm(const T* w) {
  const T n2 = sum3(w[0] * w[0], w[1] * w[1], w[2] * w[2]);
  return val(n2) < NORM_EPS ? lift<T>(0.0f) : sqrt_(n2);
}

template <class T>
SE3_FN T sinc(T x) {
  if (fabsf(val(x)) < SMALL) {
    const T x2 = x * x;
    return 1.0f - x2 * INV6 + (x2 * x2) * INV120;
  }
  return sin_(x) / x;
}

template <class T>
SE3_FN T cosc(T x) {
  if (fabsf(val(x)) < SMALL) {
    const T x2 = x * x;
    return 0.5f - x2 * INV24 + (x2 * x2) * INV720;
  }
  return (1.0f - cos_(x)) / (x * x);
}

template <class T>
SE3_FN void so3_exp(const T* w, T* R) {
  const T theta = safe_norm(w);
  T W[9], W2[9];
  hat(w, W);
  mul33(W, W, W2);
  const T a = sinc(theta), b = cosc(theta);
  for (int k = 0; k < 9; ++k)
    R[k] = ((k % 4 == 0 ? 1.0f : 0.0f) + a * W[k]) + b * W2[k];
}

// twist xi = (v, w) -> (R, t), t = V(w) v
template <class T>
SE3_FN void se3_exp(const T* xi, T* R, T* t) {
  const T* v = xi;
  const T* w = xi + 3;
  const T theta = safe_norm(w);
  T W[9], W2[9], V[9];
  hat(w, W);
  mul33(W, W, W2);
  so3_exp(w, R);
  const T b = cosc(theta);
  const T c = val(theta) < SMALL
                  ? static_cast<float>(1.0 / 6.0) - (theta * theta) * INV120
                  : (theta - sin_(theta)) / ((theta * theta) * theta);
  for (int k = 0; k < 9; ++k)
    V[k] = ((k % 4 == 0 ? 1.0f : 0.0f) + b * W[k]) + c * W2[k];
  mul3(V, v, t, HALVES);
}

template <class T>
SE3_FN void so3_log(const T* R, T* w) {
  const T trace = (R[0] + R[4]) + R[8];
  const T cos_t = clamp_((trace - 1.0f) * 0.5f, -1.0f, 1.0f);
  const T ws[3] = {(R[7] - R[5]) * 0.5f, (R[2] - R[6]) * 0.5f,
                   (R[3] - R[1]) * 0.5f};      // sin(theta) * axis
  const T n2 = sum3(ws[0] * ws[0], ws[1] * ws[1], ws[2] * ws[2]);
  if (val(cos_t) > COS_SMALL) {               // theta/sin = 1 + sin^2/6
    const T s = 1.0f + n2 * INV6;
    for (int k = 0; k < 3; ++k) w[k] = ws[k] * s;
  } else if (val(cos_t) < COS_PI) {           // axis from the symmetric part
    const T theta = acos_(cos_t);
    const T one_m_cos = clamp_(1.0f - cos_t, EPS, INFINITY);
    T axis[3];
    for (int k = 0; k < 3; ++k) {
      const T diag = (R[4 * k] + R[4 * k]) * 0.5f - 1.0f;
      axis[k] = sqrt_(clamp_(diag / one_m_cos + 1.0f, 0.0f, INFINITY)) *
                (val(ws[k]) >= 0.0f ? 1.0f : -1.0f);
    }
    const T norm = clamp_(safe_norm(axis), EPS, INFINITY);
    for (int k = 0; k < 3; ++k) w[k] = axis[k] / norm * theta;
  } else {
    const T s = acos_(cos_t) / sqrt_(clamp_(n2, 1e-20f, INFINITY));
    for (int k = 0; k < 3; ++k) w[k] = ws[k] * s;
  }
}

// (R, t) -> twist (v, w), v = V(w)^-1 t
template <class T>
SE3_FN void se3_log(const T* R, const T* t, T* xi) {
  T* w = xi + 3;
  so3_log(R, w);
  const T theta = safe_norm(w);
  T W[9], W2[9], Vinv[9];
  hat(w, W);
  mul33(W, W, W2);
  const T coef =
      val(theta) < SMALL
          ? static_cast<float>(1.0 / 12.0) + (theta * theta) * INV720
          : (1.0f - sinc(theta) / (2.0f * cosc(theta))) / (theta * theta);
  for (int k = 0; k < 9; ++k)
    Vinv[k] = ((k % 4 == 0 ? 1.0f : 0.0f) - 0.5f * W[k]) + coef * W2[k];
  mul3(Vinv, t, xi, HALVES);
}

// (R^T, -(R^T t)): `Rt` the transposed values, `-R^T t` in pattern `p`
template <class T>
SE3_FN void inverse(const T* R, const T* t, T* Rt, T* ti, int p) {
  transpose(R, Rt);
  T u[3];
  mul3(Rt, t, u, p);
  for (int k = 0; k < 3; ++k) ti[k] = -u[k];
}

// (Ra, ta) * (Rb, tb): b first, then a; Ra tb in pattern `p`
template <class T>
SE3_FN void compose(const T* Ra, const T* ta, const T* Rb, const T* tb,
                    T* Rc, T* tc, int p) {
  mul33(Ra, Rb, Rc);
  T u[3];
  mul3(Ra, tb, u, p);
  for (int k = 0; k < 3; ++k) tc[k] = u[k] + ta[k];
}

// the right retraction T exp(xi)
template <class T>
SE3_FN void retract(const T* R, const T* t, const T* xi, T* R2, T* t2) {
  T dR[9], dt[3];
  se3_exp(xi, dR, dt);
  compose(R, t, dR, dt, R2, t2, HALVES);
}

// `_pair_residuals` of one edge: w log(T_ij^-1 T_i^-1 T_j), with the
// measurement's inverse (Rm, tm) given; the products with the transposed
// R_i in pattern `pi`, with Rm in pattern `pm`
template <class T>
SE3_FN void pair_residual(const T* Ri, const T* ti, const T* Rj, const T* tj,
                          const T* Rm, const T* tm, T weight, T* r, int pi,
                          int pm) {
  T Rinv[9], tinv[3], Rrel[9], trel[3], Re[9], te[3];
  inverse(Ri, ti, Rinv, tinv, pi);
  compose(Rinv, tinv, Rj, tj, Rrel, trel, pi);
  compose(Rm, tm, Rrel, trel, Re, te, pm);
  se3_log(Re, te, r);
  for (int k = 0; k < 6; ++k) r[k] = r[k] * weight;
}

// Column `col` of the edge's derivative [d r / d xi_i | d r / d xi_j] at
// xi = 0 (col < 6: xi_i's basis direction col, else xi_j's col - 6), as
// `_edge_blocks` computes it for `edges` edges: the residual of the
// retracted poses on dual numbers whose tangent is that direction.  Its
// products with the transposed R_i run over 12 x edges matrices; those
// with the measurement's inverse, expanded over the 12 directions, run
// on a copy, in the untransposed pattern.  Rmt: the measurement's R_ij^T.
SE3_FN void edge_column(const float* Ri, const float* ti, const float* Rj,
                        const float* tj, const float* Rmt, const float* tij,
                        float weight, int col, long edges, float* column) {
  Dual R[2][9], t[2][3], R2[2][9], t2[2][3], xi[2][6], M[9], tmeas[3],
      m[3], out[6];
  for (int k = 0; k < 9; ++k) {
    R[0][k] = lift<Dual>(Ri[k]);
    R[1][k] = lift<Dual>(Rj[k]);
    M[k] = lift<Dual>(Rmt[k]);
  }
  for (int k = 0; k < 3; ++k) {
    t[0][k] = lift<Dual>(ti[k]);
    t[1][k] = lift<Dual>(tj[k]);
    tmeas[k] = lift<Dual>(tij[k]);
  }
  for (int s = 0; s < 2; ++s) {
    for (int k = 0; k < 6; ++k)
      xi[s][k] = {0.0f, col == 6 * s + k ? 1.0f : 0.0f};
    retract(R[s], t[s], xi[s], R2[s], t2[s]);
  }
  Dual u[3];
  mul3(M, tmeas, u, HALVES);
  for (int k = 0; k < 3; ++k) m[k] = -u[k];
  pair_residual(R2[0], t2[0], R2[1], t2[1], M, m, lift<Dual>(weight), out,
                gemv_t(12 * edges), HALVES);
  for (int k = 0; k < 6; ++k) column[k] = out[k].d;
}

}  // namespace se3
