// One round of adaptive spherical RANSAC for Hopper (sm_90a), float64 and
// float32: for every pair still running, the 3-point solve of each of the
// round's sampled triples, the MSAC scoring of its (up to) four candidates
// over the pair's matches, the MSAC-best candidate, and its keep where it
// beats the pair's running best, in one launch.
//
// Replaces no TPU kernel: the JAX package runs the round in plain XLA
// (sphericalsfm_tpu/ransac/spherical.py, solve_spherical_3pt then the
// scoring under vmap). On the card the plain PyTorch round
// (ransac/spherical.py::_round_plain) is ~595 small launches for a chunk
// of 128 pairs, ~18 ms a round with the device idle ~90% of it, for ~3 GFLOP
// of float64 work, and it writes a (B, 4R, N) float64 error tensor and its
// Sampson temporaries (~0.5 and ~1.6 GB at 128 x 128 x 1024) every round.
//
// What it computes, per pair b (one thread block), as the plain round:
//
//   solve     for each triple of rows (i, j, k) of u, v: the epipolar rows
//             in the 6 spherical parameters, their nullspace by modified
//             Gram-Schmidt with the completion from the three unit vectors
//             of largest residual (a stable order on ties, as
//             ops/linalg.py::_mgs_complete), the ten cubic constraints at the
//             ten nodes turned into monomial coefficients with _VAND_INV_T,
//             the 6x6 Cholesky of C1^T C1 (a failed factorisation gives NaN),
//             the quartic in y by Ferrari on (re, im) pairs
//             (solvers/quartic.py), two clamped Newton steps on the real
//             parts, x by back-substitution, and each candidate normalised
//             to |p| = 1 where valid (|p| finite and > 1e-12), else zero;
//   score     the MSAC score of each candidate over `mask`: the sum of
//             min(s_i, thr), s_i the squared Sampson error with its 1e-30
//             floor, non-finite s_i counted as thr; +inf if not valid;
//   best      the lowest score, the lowest candidate index (4 * triple +
//             root) on exact ties, as torch.argmin;
//   keep      where the best scores strictly lower than score_in and the
//             pair is active: its E, score and inlier row (s_i < thr) & mask;
//             otherwise, and for every inactive pair, the inputs as they were.
//
// What bounds it on the H100: FP64 arithmetic. Scoring is 38 operations a
// candidate and a match, 4R candidates over N matches a pair (20.4 MFLOP at
// R = 128, N = 1024), and the solve ~6,000 operations a triple (see
// chip_smoke.py::round_flops), ~2.7 GFLOP a 128-pair chunk: ~80 us at
// 33.5 TFLOP/s. The bytes are small (a pair's rows are 48 KB in float64),
// so the design keeps everything on the SM and writes nothing but the kept
// model:
// - one block of 256 threads a pair; a pair that is no longer active copies
//   its inputs and leaves, so a round costs what its running pairs cost;
// - the pair's valid rows are compacted, in order, into shared memory when
//   they fit (N * 48 bytes in float64 up to 96 KB), else read from device
//   memory through L1 with the mask tested per row. Both paths give the same
//   bits; at 128 x 128 x 1024 in float64 on an H100 the staged rows take
//   0.371 ms a round against 0.425 ms through L1 alone (0.355 against 0.415
//   with 60% of the pairs active), so the staging stays;
// - triples go in tiles of 128: threads 0-127 solve one triple each and put
//   its four normalised parameter vectors in shared memory, then every
//   thread scores two candidates over all rows, summing in row order; the
//   best of a tile is a fixed shuffle tree and the warp results in warp
//   order, and a tile's best replaces the running one only if strictly
//   lower: no atomics, so a repeat is bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTriples = 128;
constexpr int kTileCands = 4 * kTileTriples;     // two a thread
constexpr int kNodes = 10;
constexpr int kConsts = kNodes * kNodes + kNodes * 3;  // _VAND_INV_T, then the nodes (x, y, 1)
constexpr size_t kMaxStagedBytes = 96 * 1024;

// The precise math functions (no fast math) under names of their own, so the
// templates call one name for float and double.
__device__ __forceinline__ double sqrt_of(double x) { return ::sqrt(x); }
__device__ __forceinline__ float sqrt_of(float x) { return ::sqrtf(x); }
__device__ __forceinline__ double hypot_of(double x, double y) { return ::hypot(x, y); }
__device__ __forceinline__ float hypot_of(float x, float y) { return ::hypotf(x, y); }
__device__ __forceinline__ double atan2_of(double y, double x) { return ::atan2(y, x); }
__device__ __forceinline__ float atan2_of(float y, float x) { return ::atan2f(y, x); }
__device__ __forceinline__ double pow_of(double x, double y) { return ::pow(x, y); }
__device__ __forceinline__ float pow_of(float x, float y) { return ::powf(x, y); }
__device__ __forceinline__ double cos_of(double x) { return ::cos(x); }
__device__ __forceinline__ float cos_of(float x) { return ::cosf(x); }
__device__ __forceinline__ double sin_of(double x) { return ::sin(x); }
__device__ __forceinline__ float sin_of(float x) { return ::sinf(x); }
__device__ __forceinline__ double abs_of(double x) { return ::fabs(x); }
__device__ __forceinline__ float abs_of(float x) { return ::fabsf(x); }

// the smallest normal number, torch.finfo(dtype).tiny
template <typename T>
__device__ __forceinline__ T tiny_of();
template <>
__device__ __forceinline__ double tiny_of<double>() { return 2.2250738585072014e-308; }
template <>
__device__ __forceinline__ float tiny_of<float>() { return 1.17549435e-38f; }

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <>
__device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
template <>
__device__ __forceinline__ float nan_of<float>() { return __int_as_float(0x7fc00000); }

// A number whose every product, quotient, sum and difference is rounded on
// its own, as PyTorch's elementwise kernels round them, so the round's bits do
// not hang on which a * b + c nvcc fuses into one multiply-add: the solve's
// normal equations carry the last bit far on ill-conditioned triples, and the
// round's picks feed every later stage. On an H100 it costs no time (0.3707
// ms a round at 128 x 128 x 1024 against 0.3716 with fused multiply-adds) and
// leaves the candidates as far from the plain solve's as fused multiply-adds
// do (chip_smoke.py::round_agreement holds them).
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

template <typename T>
struct Ex {
  T x;
  Ex() = default;
  __device__ __forceinline__ Ex(T v) : x(v) {}
  friend __device__ __forceinline__ Ex operator+(Ex a, Ex b) { return Ex(add_rn(a.x, b.x)); }
  friend __device__ __forceinline__ Ex operator-(Ex a, Ex b) { return Ex(sub_rn(a.x, b.x)); }
  friend __device__ __forceinline__ Ex operator*(Ex a, Ex b) { return Ex(mul_rn(a.x, b.x)); }
  friend __device__ __forceinline__ Ex operator/(Ex a, Ex b) { return Ex(div_rn(a.x, b.x)); }
  friend __device__ __forceinline__ Ex operator-(Ex a) { return Ex(-a.x); }
  friend __device__ __forceinline__ bool operator==(Ex a, Ex b) { return a.x == b.x; }
  __device__ __forceinline__ Ex& operator+=(Ex b) { return *this = *this + b; }
  __device__ __forceinline__ Ex& operator-=(Ex b) { return *this = *this - b; }
};

template <typename T>
__device__ __forceinline__ Ex<T> sqrt_of(Ex<T> a) { return Ex<T>(sqrt_of(a.x)); }
template <typename T>
__device__ __forceinline__ Ex<T> abs_of(Ex<T> a) { return Ex<T>(abs_of(a.x)); }
template <typename T>
__device__ __forceinline__ Ex<T> hypot_of(Ex<T> a, Ex<T> b) { return Ex<T>(hypot_of(a.x, b.x)); }
template <typename T>
__device__ __forceinline__ Ex<T> atan2_of(Ex<T> a, Ex<T> b) { return Ex<T>(atan2_of(a.x, b.x)); }
template <typename T>
__device__ __forceinline__ Ex<T> pow_of(Ex<T> a, Ex<T> b) { return Ex<T>(pow_of(a.x, b.x)); }
template <typename T>
__device__ __forceinline__ Ex<T> cos_of(Ex<T> a) { return Ex<T>(cos_of(a.x)); }
template <typename T>
__device__ __forceinline__ Ex<T> sin_of(Ex<T> a) { return Ex<T>(sin_of(a.x)); }

// false for inf and NaN, as torch.isfinite
template <typename T>
__device__ __forceinline__ bool is_finite(Ex<T> a) {
  return a - a == Ex<T>(T(0));
}

// torch.clamp's min and max: NaN passes through
template <typename T>
__device__ __forceinline__ Ex<T> clamp_min(Ex<T> a, T lo) {
  return a.x < lo ? Ex<T>(lo) : a;
}
template <typename T>
__device__ __forceinline__ Ex<T> clamp_to(Ex<T> a, T lo, T hi) {
  return a.x < lo ? Ex<T>(lo) : (a.x > hi ? Ex<T>(hi) : a);
}

// complex arithmetic on (re, im) pairs, as solvers/quartic.py
template <typename T>
__device__ __forceinline__ void c_mul(Ex<T> ar, Ex<T> ai, Ex<T> br, Ex<T> bi, Ex<T>& re,
                                      Ex<T>& im) {
  re = ar * br - ai * bi;
  im = ar * bi + ai * br;
}
template <typename T>
__device__ __forceinline__ void c_div(Ex<T> ar, Ex<T> ai, Ex<T> br, Ex<T> bi, Ex<T>& re,
                                      Ex<T>& im) {
  Ex<T> den = br * br + bi * bi;
  den = den.x > T(0) ? den : Ex<T>(tiny_of<T>());
  re = (ar * br + ai * bi) / den;
  im = (ai * br - ar * bi) / den;
}
template <typename T>
__device__ __forceinline__ void c_sqrt(Ex<T> ar, Ex<T> ai, Ex<T>& re, Ex<T>& im) {
  const Ex<T> mag = hypot_of(ar, ai);
  re = sqrt_of(clamp_min(Ex<T>(T(0.5)) * (mag + ar), T(0)));
  const Ex<T> im_abs = sqrt_of(clamp_min(Ex<T>(T(0.5)) * (mag - ar), T(0)));
  im = ai.x >= T(0) ? im_abs : -im_abs;
}
template <typename T>
__device__ __forceinline__ void c_cbrt(Ex<T> ar, Ex<T> ai, Ex<T>& re, Ex<T>& im) {
  const Ex<T> mag = hypot_of(ar, ai);
  const Ex<T> a3 = atan2_of(ai, ar) / Ex<T>(T(3));
  const Ex<T> m = pow_of(mag, Ex<T>(T(1.0 / 3.0)));
  re = m * cos_of(a3);
  im = m * sin_of(a3);
}

// Real parts of the four roots of a y^4 + b y^3 + c y^2 + d y + e (Ferrari),
// the arithmetic of solvers/quartic.py::solve_quartic.
template <typename T>
__device__ void quartic_real_roots(Ex<T> a, Ex<T> b, Ex<T> c, Ex<T> d, Ex<T> e,
                                   Ex<T> (&y)[4]) {
  using S = Ex<T>;
  const S a2 = a * a, b2 = b * b;
  const S a3 = a2 * a, b3 = b2 * b;
  const S a4 = a3 * a, b4 = b3 * b;
  const S alpha = S(T(-3)) * b2 / (S(T(8)) * a2) + c / a;
  const S beta = b3 / (S(T(8)) * a3) - b * c / (S(T(2)) * a2) + d / a;
  const S gamma = S(T(-3)) * b4 / (S(T(256)) * a4) + b2 * c / (S(T(16)) * a3) -
                  b * d / (S(T(4)) * a2) + e / a;
  const S alpha2 = alpha * alpha;
  const S alpha3 = alpha2 * alpha;
  const S zero = S(T(0));
  const S P_re = -alpha2 / S(T(12)) - gamma;
  const S Q_re = -alpha3 / S(T(108)) + alpha * gamma / S(T(3)) - beta * beta / S(T(8));
  S Q2_re, Q2_im, P2_re, P2_im, P3_re, P3_im;
  c_mul(Q_re, zero, Q_re, zero, Q2_re, Q2_im);
  c_mul(P_re, zero, P_re, zero, P2_re, P2_im);
  c_mul(P2_re, P2_im, P_re, zero, P3_re, P3_im);
  S s_re, s_im;
  c_sqrt(Q2_re / S(T(4)) + P3_re / S(T(27)), Q2_im / S(T(4)) + P3_im / S(T(27)), s_re, s_im);
  const S R_re = -Q_re / S(T(2)) + s_re;
  const S R_im = -zero / S(T(2)) + s_im;
  S U_re, U_im;
  c_cbrt(R_re, R_im, U_re, U_im);
  const bool small_U = abs_of(U_re).x < T(1e-8);
  S nq_re, nq_im;
  c_cbrt(Q_re, zero, nq_re, nq_im);
  const S U_safe_re = small_U ? S(T(1)) : U_re;
  const S U_safe_im = small_U ? S(T(0)) : U_im;
  S PdU_re, PdU_im;
  c_div(P_re, zero, S(T(3)) * U_safe_re, S(T(3)) * U_safe_im, PdU_re, PdU_im);
  const S y_re = S(T(-5)) * alpha / S(T(6)) + (small_U ? -nq_re : -PdU_re + U_re);
  const S y_im = small_U ? -nq_im : -PdU_im + U_im;
  S w_re, w_im;
  c_sqrt(alpha + S(T(2)) * y_re, S(T(2)) * y_im, w_re, w_im);
  S tbw_re, tbw_im;
  c_div(S(T(2)) * beta, zero, w_re, w_im, tbw_re, tbw_im);
  const S base = -b / (S(T(4)) * a);
  S sp_re, sp_im, sm_re, sm_im;
  c_sqrt(-(S(T(3)) * alpha + S(T(2)) * y_re + tbw_re), -(S(T(2)) * y_im + tbw_im), sp_re,
         sp_im);
  c_sqrt(-(S(T(3)) * alpha + S(T(2)) * y_re - tbw_re), -(S(T(2)) * y_im - tbw_im), sm_re,
         sm_im);
  const S half = S(T(0.5));
  y[0] = base + half * (w_re + sp_re);
  y[1] = base + half * (w_re - sp_re);
  y[2] = base + half * (-w_re + sm_re);
  y[3] = base + half * (-w_re - sm_re);
}

// Modified Gram-Schmidt of three 6-vectors in place, each normalised by its
// norm clamped to 1e-30.
template <typename T>
__device__ __forceinline__ void mgs3(Ex<T> (&q)[3][6]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      Ex<T> dot = q[j][0] * q[i][0];
#pragma unroll
      for (int k = 1; k < 6; ++k) dot += q[j][k] * q[i][k];
#pragma unroll
      for (int k = 0; k < 6; ++k) q[i][k] = q[i][k] - q[j][k] * dot;
    }
    Ex<T> n2 = q[i][0] * q[i][0];
#pragma unroll
    for (int k = 1; k < 6; ++k) n2 += q[i][k] * q[i][k];
    const Ex<T> n = clamp_min(sqrt_of(n2), T(1e-30));
#pragma unroll
    for (int k = 0; k < 6; ++k) q[i][k] = q[i][k] / n;
  }
}

// key_a sorts before key_b in torch.argsort(key, stable=True): ascending,
// NaN last, the lower index first on ties
template <typename T>
__device__ __forceinline__ bool sorts_before(T ka, int ia, T kb, int ib) {
  const bool na = ka != ka, nb = kb != kb;
  if (na || nb) return na && nb ? ia < ib : nb;
  return ka < kb || (ka == kb && ia < ib);
}

// The four candidates of one triple: normalised parameters p (4 x 6) and
// their validity, as solvers/spherical.py::solve_spherical_3pt, every
// operation rounded on its own (Ex).
template <typename T>
__device__ void solve_triple(const T (&u_in)[3][3], const T (&v_in)[3][3], const T* consts,
                             T (&p_out)[4][6], bool (&valid)[4]) {
  using S = Ex<T>;
  // the epipolar rows v^T E u = 0 in (a, b, c, d, e, f), orthonormalised
  S q[3][6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const S u0 = u_in[i][0], u1 = u_in[i][1], u2 = u_in[i][2];
    const S v0 = v_in[i][0], v1 = v_in[i][1], v2 = v_in[i][2];
    q[i][0] = v0 * u0 - v1 * u1;
    q[i][1] = v0 * u1 + v1 * u0;
    q[i][2] = v0 * u2;
    q[i][3] = v1 * u2;
    q[i][4] = v2 * u0;
    q[i][5] = v2 * u1;
  }
  mgs3(q);
  // the unit vectors' residuals off the row space, and the three largest
  S resid[6][6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int k = 0; k < 6; ++k) resid[r][k] = S(r == k ? T(1) : T(0));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      S dot = q[j][0] * resid[r][0];
#pragma unroll
      for (int k = 1; k < 6; ++k) dot += q[j][k] * resid[r][k];
#pragma unroll
      for (int k = 0; k < 6; ++k) resid[r][k] = resid[r][k] - q[j][k] * dot;
    }
  }
  T key[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    S n2 = resid[r][0] * resid[r][0];
#pragma unroll
    for (int k = 1; k < 6; ++k) n2 += resid[r][k] * resid[r][k];
    key[r] = -sqrt_of(n2).x;
  }
  S nb[3][6];  // the nullspace basis, one vector a row (columns of B)
  unsigned taken = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int pick = -1;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (!(taken & (1u << r)) && (pick < 0 || sorts_before(key[r], r, key[pick], pick))) pick = r;
    }
    taken |= 1u << pick;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      if (r == pick) {
#pragma unroll
        for (int k = 0; k < 6; ++k) nb[i][k] = resid[r][k];
      }
    }
  }
  mgs3(nb);

  // the constraints at the nodes, to monomial coefficients C (eqs x monomials)
  S C[10][10];
  for (int n = 0; n < kNodes; ++n) {
    const S x = consts[kNodes * kNodes + 3 * n], y = consts[kNodes * kNodes + 3 * n + 1];
    const S z = consts[kNodes * kNodes + 3 * n + 2];
    S a[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = nb[0][k] * x + nb[1][k] * y + nb[2][k] * z;
    const S E[3][3] = {{a[0], a[1], a[2]}, {a[1], -a[0], a[3]}, {a[4], a[5], S(T(0))}};
    S EEt[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        EEt[i][j] = E[i][0] * E[j][0] + E[i][1] * E[j][1] + E[i][2] * E[j][2];
      }
    }
    const S tr = EEt[0][0] + EEt[1][1] + EEt[2][2];
    S g[10];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const S m = EEt[i][0] * E[0][j] + EEt[i][1] * E[1][j] + EEt[i][2] * E[2][j];
        g[3 * i + j] = S(T(2)) * m - tr * E[i][j];
      }
    }
    g[9] = E[0][0] * (E[1][1] * E[2][2] - E[1][2] * E[2][1]) -
           E[0][1] * (E[1][0] * E[2][2] - E[1][2] * E[2][0]) +
           E[0][2] * (E[1][0] * E[2][1] - E[1][1] * E[2][0]);
    const T* vinv = consts + kNodes * n;  // _VAND_INV_T's row n
#pragma unroll
    for (int e = 0; e < 10; ++e) {
#pragma unroll
      for (int m = 0; m < 10; ++m) {
        const S t = g[e] * S(vinv[m]);
        C[e][m] = n == 0 ? t : C[e][m] + t;
      }
    }
  }

  // G = (C1^T C1)^-1 C1^T C2 by Cholesky; only its rows 4 and 5 are needed
  S L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      S s = C[0][i] * C[0][j];
#pragma unroll
      for (int k = 1; k < 10; ++k) s += C[k][i] * C[k][j];
      L[i][j] = s;
    }
  }
  S Y[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      S s = C[0][i] * C[0][6 + j];
#pragma unroll
      for (int k = 1; k < 10; ++k) s += C[k][i] * C[k][6 + j];
      Y[i][j] = s;
    }
  }
  bool factored = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    S s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    factored = factored && s.x > T(0);
    L[j][j] = sqrt_of(s);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      S t = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      S s = Y[i][c];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][c];
      Y[i][c] = s / L[i][i];
    }
  }
  S g5[4], g4[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    g5[c] = Y[5][c] / L[5][5];
    g4[c] = (Y[4][c] - L[5][4] * g5[c]) / L[4][4];
    if (!factored) {
      g5[c] = S(nan_of<T>());
      g4[c] = S(nan_of<T>());
    }
  }

  const S qa = g5[0], qb = g5[1] - g4[0], qc = g5[2] - g4[1], qd = g5[3] - g4[2], qe = -g4[3];
  S y[4];
  quartic_real_roots(qa, qb, qc, qd, qe, y);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    S yr = y[r];
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // Newton polish of the real parts
      const S f = (((qa * yr + qb) * yr + qc) * yr + qd) * yr + qe;
      const S df = ((S(T(4)) * qa * yr + S(T(3)) * qb) * yr + S(T(2)) * qc) * yr + qd;
      const S step = f / (abs_of(df).x > T(1e-30) ? df : S(T(1e-30)));
      yr = yr - clamp_to(step, T(-1), T(1));
    }
    const S xr = -(g5[0] * (yr * yr * yr) + g5[1] * yr * yr + g5[2] * yr + g5[3]);
    S p[6];
    S n2 = S(T(0));
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      p[k] = nb[0][k] * xr + nb[1][k] * yr + nb[2][k] * S(T(1));
      n2 = k == 0 ? p[k] * p[k] : n2 + p[k] * p[k];
    }
    const S norm = sqrt_of(n2);
    valid[r] = is_finite(norm) && norm.x > T(1e-12);
#pragma unroll
    for (int k = 0; k < 6; ++k) p_out[r][k] = valid[r] ? (p[k] / norm).x : T(0);
  }
}

// The squared Sampson error's numerator (v^T E u)^2 and floored denominator
// for E = [[a, b, c], [b, -a, d], [e, f, 0]].
template <typename T>
__device__ __forceinline__ void sampson_parts(const T (&p)[6], const T* u, const T* v, T& num,
                                              T& den) {
  const T Eu0 = p[0] * u[0] + p[1] * u[1] + p[2] * u[2];
  const T Eu1 = p[1] * u[0] - p[0] * u[1] + p[3] * u[2];
  const T Eu2 = p[4] * u[0] + p[5] * u[1];
  const T Etv0 = p[0] * v[0] + p[1] * v[1] + p[4] * v[2];
  const T Etv1 = p[1] * v[0] - p[0] * v[1] + p[5] * v[2];
  const T d = v[0] * Eu0 + v[1] * Eu1 + v[2] * Eu2;
  den = Eu0 * Eu0 + Eu1 * Eu1 + Etv0 * Etv0 + Etv1 * Etv1;
  den = den > T(1e-30) ? den : T(1e-30);
  num = d * d;
}

// min(s, thr) with a non-finite s counted as thr; the division only where
// the error can be under the threshold
template <typename T>
__device__ __forceinline__ T capped_error(const T (&p)[6], const T* u, const T* v, T thr) {
  T num, den;
  sampson_parts(p, u, v, num, den);
  if (!(num < thr * den)) return thr;
  const T s = num / den;
  return s < thr ? s : thr;
}

// (score, index) a before b: the lower score, the lower index on ties
template <typename T>
__device__ __forceinline__ bool better_pick(T sa, int ia, T sb, int ib) {
  return sa < sb || (sa == sb && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    spherical_round_kernel(const int64_t* __restrict__ triples, const T* __restrict__ u,
                           const T* __restrict__ v, const uint8_t* __restrict__ mask,
                           const T* __restrict__ consts, const T* __restrict__ E_in,
                           const T* __restrict__ score_in, const uint8_t* __restrict__ inl_in,
                           const uint8_t* __restrict__ active, int R, int N, T thr, int staged,
                           T* __restrict__ E_out, T* __restrict__ score_out,
                           uint8_t* __restrict__ inl_out, T* __restrict__ cand_E,
                           uint8_t* __restrict__ cand_valid, T* __restrict__ cand_score) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_consts = reinterpret_cast<T*>(smem);
  T* s_par = s_consts + kConsts;            // kTileCands x 6 parameters
  T* s_rows = s_par + kTileCands * 6;       // staged rows: u0 u1 u2 v0 v1 v2
  __shared__ uint8_t s_valid[kTileCands];
  __shared__ T red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_count[kWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = static_cast<size_t>(b) * N;
  const T* ub = u + 3 * row;
  const T* vb = v + 3 * row;
  const uint8_t* mb = mask + row;

  if (!active[b]) {
    if (tid < 9) E_out[9 * b + tid] = E_in[9 * b + tid];
    if (tid == 0) score_out[b] = score_in[b];
    for (int i = tid; i < N; i += kThreads) inl_out[row + i] = inl_in[row + i];
    return;
  }

  for (int i = tid; i < kConsts; i += kThreads) s_consts[i] = consts[i];
  // the valid rows, compacted in order
  int nv = 0;
  if (staged) {
    for (int base = 0; base < N; base += kThreads) {
      const int i = base + tid;
      const bool keep = i < N && mb[i];
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int pos = nv + __popc(ballot & ((1u << lane) - 1u));
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) pos += s_count[w];
        total += s_count[w];
      }
      if (keep) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          s_rows[6 * pos + k] = ub[3 * i + k];
          s_rows[6 * pos + 3 + k] = vb[3 * i + k];
        }
      }
      nv += total;
      __syncthreads();
    }
  }
  __syncthreads();

  T best = inf_of<T>();
  T best_p[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int t0 = 0; t0 < R; t0 += kTileTriples) {
    const int nt = min(kTileTriples, R - t0);
    if (tid < kTileTriples) {
      T p[4][6];
      bool ok[4] = {false, false, false, false};
      if (tid < nt) {
        const int64_t* tr = triples + (static_cast<size_t>(b) * R + t0 + tid) * 3;
        T uu[3][3], vv[3][3];
        bool inside = true;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int64_t j = tr[i];
          inside = inside && j >= 0 && j < N;
          const int64_t jj = inside ? j : 0;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            uu[i][k] = ub[3 * jj + k];
            vv[i][k] = vb[3 * jj + k];
          }
        }
        solve_triple(uu, vv, s_consts, p, ok);
        if (!inside) ok[0] = ok[1] = ok[2] = ok[3] = false;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s_valid[4 * tid + r] = ok[r];
#pragma unroll
        for (int k = 0; k < 6; ++k) s_par[6 * (4 * tid + r) + k] = ok[r] ? p[r][k] : T(0);
      }
    }
    __syncthreads();

    // two candidates a thread, each summed over the rows in order
    const int c0 = tid, c1 = tid + kThreads;
    T p0[6], p1[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      p0[k] = s_par[6 * c0 + k];
      p1[k] = s_par[6 * c1 + k];
    }
    T acc0 = T(0), acc1 = T(0);
    if (staged) {
#pragma unroll 2
      for (int j = 0; j < nv; ++j) {
        const T* r = s_rows + 6 * j;
        acc0 += capped_error(p0, r, r + 3, thr);
        acc1 += capped_error(p1, r, r + 3, thr);
      }
    } else {
      for (int i = 0; i < N; ++i) {
        if (!mb[i]) continue;
        acc0 += capped_error(p0, ub + 3 * i, vb + 3 * i, thr);
        acc1 += capped_error(p1, ub + 3 * i, vb + 3 * i, thr);
      }
    }
    const T sc0 = s_valid[c0] ? acc0 : inf_of<T>();
    const T sc1 = s_valid[c1] ? acc1 : inf_of<T>();
    if (cand_E != nullptr) {
      const int cs[2] = {c0, c1};
      const T ss[2] = {sc0, sc1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = cs[h];
        if (c < 4 * nt) {
          const size_t o = static_cast<size_t>(b) * 4 * R + 4 * t0 + c;
          const T* q = s_par + 6 * c;
          const T E[9] = {q[0], q[1], q[2], q[1], -q[0], q[3], q[4], q[5], T(0)};
#pragma unroll
          for (int k = 0; k < 9; ++k) cand_E[9 * o + k] = s_valid[c] ? E[k] : T(0);
          cand_valid[o] = s_valid[c];
          cand_score[o] = ss[h];
        }
      }
    }

    // the tile's best: a shuffle tree in each warp, then the warps in order
    T s = sc0;
    int c = c0;
    if (better_pick(sc1, c1, s, c)) {
      s = sc1;
      c = c1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T so = __shfl_down_sync(0xffffffffu, s, off);
      const int co = __shfl_down_sync(0xffffffffu, c, off);
      if (better_pick(so, co, s, c)) {
        s = so;
        c = co;
      }
    }
    if (lane == 0) {
      red_s[warp] = s;
      red_i[warp] = c;
    }
    __syncthreads();
    s = red_s[0];
    c = red_i[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (better_pick(red_s[w], red_i[w], s, c)) {
        s = red_s[w];
        c = red_i[w];
      }
    }
    if (s < best) {  // strictly lower: earlier tiles win ties
      best = s;
#pragma unroll
      for (int k = 0; k < 6; ++k) best_p[k] = s_par[6 * c + k];
    }
    __syncthreads();  // before the next tile's solve overwrites s_par
  }

  const T score_old = score_in[b];
  const bool better = best < score_old;
  if (tid < 9) {
    const T E[9] = {best_p[0], best_p[1], best_p[2], best_p[1], -best_p[0],
                    best_p[3], best_p[4], best_p[5], T(0)};
    E_out[9 * b + tid] = better ? E[tid] : E_in[9 * b + tid];
  }
  if (tid == 0) score_out[b] = better ? best : score_old;
  for (int i = tid; i < N; i += kThreads) {
    uint8_t flag = inl_in[row + i];
    if (better) {
      T num, den;
      sampson_parts(best_p, ub + 3 * i, vb + 3 * i, num, den);
      flag = mb[i] && (num / den < thr);
    }
    inl_out[row + i] = flag;
  }
}

template <typename T>
int launch(const void* triples, const void* u, const void* v, const void* mask,
           const void* consts, const void* E_in, const void* score_in, const void* inl_in,
           const void* active, int B, int R, int N, double thr, void* E_out, void* score_out,
           void* inl_out, void* cand_E, void* cand_valid, void* cand_score, void* stream) {
  if (B < 0 || R < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t rows_bytes = static_cast<size_t>(N) * 6 * sizeof(T);
  const int staged = rows_bytes <= kMaxStagedBytes;
  const size_t smem = (kConsts + kTileCands * 6) * sizeof(T) + (staged ? rows_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(spherical_round_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  spherical_round_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(triples), static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(consts),
      static_cast<const T*>(E_in), static_cast<const T*>(score_in),
      static_cast<const uint8_t*>(inl_in), static_cast<const uint8_t*>(active), R, N,
      static_cast<T>(thr), staged, static_cast<T*>(E_out), static_cast<T*>(score_out),
      static_cast<uint8_t*>(inl_out), static_cast<T*>(cand_E),
      static_cast<uint8_t*>(cand_valid), static_cast<T*>(cand_score));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Arguments, each row-major and contiguous on one device: triples (B, R, 3)
// int64 row indices, u and v (B, N, 3), mask (B, N) bool, consts (130,):
// _VAND_INV_T (10 x 10) then the ten nodes (x, y, 1), in the type of u;
// the running best E_in (B, 3, 3), score_in (B,), inl_in (B, N) bool, and
// active (B,) bool. Outputs E_out (B, 3, 3), score_out (B,), inl_out (B, N)
// bool; cand_E (B, 4R, 3, 3), cand_valid (B, 4R) bool and cand_score
// (B, 4R) receive every candidate of the active pairs when cand_E is not
// null. Returns the CUDA error of the launch (0 on success).
extern "C" int spherical_round_f64_launch(const void* triples, const void* u, const void* v,
                                          const void* mask, const void* consts,
                                          const void* E_in, const void* score_in,
                                          const void* inl_in, const void* active, int B, int R,
                                          int N, double thr, void* E_out, void* score_out,
                                          void* inl_out, void* cand_E, void* cand_valid,
                                          void* cand_score, void* stream) {
  return launch<double>(triples, u, v, mask, consts, E_in, score_in, inl_in, active, B, R, N,
                        thr, E_out, score_out, inl_out, cand_E, cand_valid, cand_score, stream);
}

extern "C" int spherical_round_f32_launch(const void* triples, const void* u, const void* v,
                                          const void* mask, const void* consts,
                                          const void* E_in, const void* score_in,
                                          const void* inl_in, const void* active, int B, int R,
                                          int N, double thr, void* E_out, void* score_out,
                                          void* inl_out, void* cand_E, void* cand_valid,
                                          void* cand_score, void* stream) {
  return launch<float>(triples, u, v, mask, consts, E_in, score_in, inl_in, active, B, R, N,
                       thr, E_out, score_out, inl_out, cand_E, cand_valid, cand_score, stream);
}
