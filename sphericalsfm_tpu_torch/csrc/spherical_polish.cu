// Spherical RANSAC's final rotation polish for Hopper (sm_90a), float64 and
// float32: the whole Levenberg-Marquardt refinement of each pair's relative
// rotation on the squared Sampson cost, and the MSAC rescoring that decides
// whether the polished model replaces the RANSAC best, in one launch.
//
// Replaces no TPU kernel: the JAX package polishes with plain XLA
// (sphericalsfm_tpu/ransac/spherical.py::_refine_rotation under vmap). On
// the card the plain PyTorch path (ransac/spherical.py::_polish_plain, the
// generic optim/lm.py::levenberg_marquardt) breaks each of its 25 iterations
// into a few hundred tiny launches (vmap(jacfwd) of the residual, einsums, a
// batched solve) and reads a flag back to the host every iteration, so it
// was bound by launches and host syncs: ~0.4 s a chunk of 128 pairs for
// ~1 GFLOP of float64 work. This kernel runs every iteration on chip.
//
// What it computes, per pair b (one thread block), exactly the plain path:
//
//   residual  s_i(r) = (v_i^T E u_i)^2 / max'(|(E u_i)_01|^2 + |(E^T v_i)_01|^2),
//             max'(x) = x if x > 1e-30 else 1e-30 (NaN -> 1e-30),
//             E(r) = [t]x R, R = so3_exp(r), t = R e3 - e3 (negated inward),
//             so3_exp with its theta^2 < 1e-16 Taylor branch;
//   cost      0.5 * sum_i w_i s_i^2, w_i = RANSAC inlier flag;
//   Jacobian  ds_i/dr by forward-mode dual numbers (3 tangents) through the
//             same branches, as torch.func.jacfwd does;
//   step      (J^T W J + lam diag(clamp(diag J^T W J, 1e-12))) dx = -J^T W s,
//             Gaussian elimination with partial pivoting;
//   accept    bad = !isfinite(c_new) || c_new > c; lam *10 if bad, else
//             max(0.3 lam, 1e-12); stop on (!bad && rel < 1e-10) or
//             |dx| < 1e-14 (|x| + 1e-14) or lam > 1e10, after at most
//             max_iters iterations from lam = 1e-6;
//   rescore   E_ref = E(r), MSAC score sum_{mask} min(s_i, thr) (NaN kept),
//             kept only where strictly lower than the RANSAC score; then the
//             inlier row (s_i < thr) & mask.
//
// It writes the polished rotation, the kept E, score and inlier row, the
// pair's LM iterations and whether the polished model was accepted.
//
// What bounds it on the H100: ~200 FP64 operations a match for each
// Jacobian evaluation and ~50 for each cost evaluation, two of each an
// iteration (see chip_smoke.py::polish_flops for the count), so a chunk of
// 128 pairs x 1024 matches is ~1 GFLOP: ~30 us at 33.5 TFLOP/s FP64. The
// pair's rows are 50 KB in float64 and are read ~50 times, so the design
// keeps them on the SM and reduces in the block, with no round trip to the
// host between iterations:
// - one block of 256 threads a pair; the rows (u, v, mask, inlier flags) are
//   read from device memory on every pass and stay in the SM's L1 (at 1024
//   matches, the most the pipeline's configurations keep a pair, copying
//   them into shared memory first measured 0.1618 against 0.1626 ms a
//   128-pair chunk on an H100 80GB HBM3, so the kernel does not);
// - each thread owns matches tid, tid + 256, ... and sums them in that
//   order; a block sum is a fixed shuffle tree in each warp, then the warp
//   partials in warp order: no atomics, so a repeat is bit for bit;
// - every thread holds the block's sums and computes the 3x3 solve and the
//   stop rules itself, so all threads leave the loop at the same iteration
//   and a finished pair holds back no other pair and waits on no host.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 9;  // J^T W J (6 entries) and J^T W s (3)

// The precise math functions (no fast math) under names of their own for
// float, double and the dual numbers below, so the templates call one name
// on either type; names of the math library's own would clash with it.
__device__ __forceinline__ double sqrt_of(double x) { return ::sqrt(x); }
__device__ __forceinline__ float sqrt_of(float x) { return ::sqrtf(x); }
__device__ __forceinline__ double sin_of(double x) { return ::sin(x); }
__device__ __forceinline__ float sin_of(float x) { return ::sinf(x); }
__device__ __forceinline__ double cos_of(double x) { return ::cos(x); }
__device__ __forceinline__ float cos_of(float x) { return ::cosf(x); }
__device__ __forceinline__ double abs_of(double x) { return ::fabs(x); }
__device__ __forceinline__ float abs_of(float x) { return ::fabsf(x); }

// a value and its derivatives along the three coordinates of r
template <typename T>
struct Dual {
  T v;
  T d[3];
};

template <typename T>
__device__ __forceinline__ Dual<T> lift(T v) {
  return {v, {T(0), T(0), T(0)}};
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  return {a.v + b.v, {a.d[0] + b.d[0], a.d[1] + b.d[1], a.d[2] + b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  return {a.v - b.v, {a.d[0] - b.d[0], a.d[1] - b.d[1], a.d[2] - b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  return {-a.v, {-a.d[0], -a.d[1], -a.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  return {a.v * b.v, {a.d[0] * b.v + a.v * b.d[0], a.d[1] * b.v + a.v * b.d[1],
                      a.d[2] * b.v + a.v * b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, T b) {
  return {a.v * b, {a.d[0] * b, a.d[1] * b, a.d[2] * b}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, const Dual<T>& b) {
  return b * a;
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  const T q = a.v / b.v;
  return {q, {(a.d[0] - q * b.d[0]) / b.v, (a.d[1] - q * b.d[1]) / b.v,
              (a.d[2] - q * b.d[2]) / b.v}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, T b) {
  return {a.v / b, {a.d[0] / b, a.d[1] / b, a.d[2] / b}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, T b) {
  return {a.v - b, {a.d[0], a.d[1], a.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, const Dual<T>& b) {
  return {a - b.v, {-b.d[0], -b.d[1], -b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, const Dual<T>& b) {
  return {a + b.v, {b.d[0], b.d[1], b.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> sqrt_of(const Dual<T>& a) {
  const T s = sqrt_of(a.v);
  return {s, {a.d[0] / (T(2) * s), a.d[1] / (T(2) * s), a.d[2] / (T(2) * s)}};
}
template <typename T>
__device__ __forceinline__ Dual<T> sin_of(const Dual<T>& a) {
  const T c = cos_of(a.v);
  return {sin_of(a.v), {c * a.d[0], c * a.d[1], c * a.d[2]}};
}
template <typename T>
__device__ __forceinline__ Dual<T> cos_of(const Dual<T>& a) {
  const T s = -sin_of(a.v);
  return {cos_of(a.v), {s * a.d[0], s * a.d[1], s * a.d[2]}};
}

__device__ __forceinline__ double value(double x) { return x; }
__device__ __forceinline__ float value(float x) { return x; }
template <typename T>
__device__ __forceinline__ T value(const Dual<T>& x) {
  return x.v;
}

// c as a constant of x's type
template <typename T>
__device__ __forceinline__ T constant_like(T, T c) {
  return c;
}
template <typename T>
__device__ __forceinline__ Dual<T> constant_like(const Dual<T>&, T c) {
  return lift(c);
}

// false for inf and NaN, as torch.isfinite
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return x - x == T(0);
}

// x if x >= lo else lo, keeping NaN, as torch.clamp(x, min=lo)
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// E = [t]x R with R = so3_exp(r) (Rodrigues with the Taylor limits of
// sin(th)/th and (1 - cos th)/th^2 below th^2 = 1e-16) and the spherical
// translation t = R e3 - e3, negated when inward. S is T or Dual<T>.
template <typename T, typename S>
__device__ __forceinline__ void essential(const S (&r)[3], bool inward, S (&E)[3][3]) {
  const S theta2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  S a, b;
  if (value(theta2) < T(1e-16)) {
    a = T(1) - theta2 / T(6);
    b = T(0.5) - theta2 / T(24);
  } else {
    const S theta = sqrt_of(theta2);
    a = sin_of(theta) / theta;
    b = (T(1) - cos_of(theta)) / (theta * theta);
  }
  // R = I + a K + b (r r^T - theta^2 I), K = [r]x
  S R[3][3];
  R[0][0] = T(1) + b * (r[0] * r[0] - theta2);
  R[1][1] = T(1) + b * (r[1] * r[1] - theta2);
  R[2][2] = T(1) + b * (r[2] * r[2] - theta2);
  R[0][1] = a * (-r[2]) + b * (r[0] * r[1]);
  R[0][2] = a * r[1] + b * (r[0] * r[2]);
  R[1][0] = a * r[2] + b * (r[1] * r[0]);
  R[1][2] = a * (-r[0]) + b * (r[1] * r[2]);
  R[2][0] = a * (-r[1]) + b * (r[2] * r[0]);
  R[2][1] = a * r[0] + b * (r[2] * r[1]);
  S t0 = R[0][2], t1 = R[1][2], t2 = R[2][2] - T(1);
  if (inward) {
    t0 = -t0;
    t1 = -t1;
    t2 = -t2;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    E[0][j] = t1 * R[2][j] - t2 * R[1][j];
    E[1][j] = t2 * R[0][j] - t0 * R[2][j];
    E[2][j] = t0 * R[1][j] - t1 * R[0][j];
  }
}

// squared Sampson error of v^T E u, with the denominator's 1e-30 floor
template <typename T, typename S>
__device__ __forceinline__ S sampson(const S (&E)[3][3], const T* u, const T* v) {
  S Eu[3], Etv[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) Eu[i] = E[i][0] * u[0] + E[i][1] * u[1] + E[i][2] * u[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) Etv[i] = E[0][i] * v[0] + E[1][i] * v[1] + E[2][i] * v[2];
  const S d = Eu[0] * v[0] + Eu[1] * v[1] + Eu[2] * v[2];
  S den = Eu[0] * Eu[0] + Eu[1] * Eu[1] + Etv[0] * Etv[0] + Etv[1] * Etv[1];
  if (!(value(den) > T(1e-30))) den = constant_like(den, T(1e-30));
  return d * d / den;
}

// Sum each of K values over the block: a shuffle tree in each warp, then
// the warp partials in warp order. Every thread gets the sums.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&acc)[K], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * K + k] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = red[k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * K + k];
    acc[k] = s;
  }
  __syncthreads();
}

// A x = b for 3x3 A by Gaussian elimination with partial pivoting (the
// first largest pivot), as LAPACK's getrf/getrs; the swaps select among
// fixed indices so A stays in registers.
template <typename T>
__device__ __forceinline__ void solve3(T (&A)[3][3], T (&b)[3], T (&x)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    T best = abs_of(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (abs_of(A[i][k]) > best) {
        best = abs_of(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T tmp = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = tmp;
        }
        const T tmp = b[k];
        b[k] = b[i];
        b[i] = tmp;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const T l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    T s = b[k];
#pragma unroll
    for (int j = k + 1; j < 3; ++j) s -= A[k][j] * x[j];
    x[k] = s / A[k][k];
  }
}

template <typename T>
struct Rows {
  const T* u;
  const T* v;
  const uint8_t* mask;
  const uint8_t* inl;
  int n;
};

// 0.5 * sum_i w_i s_i(x)^2 over the block
template <typename T>
__device__ __forceinline__ T half_cost(const T (&x)[3], bool inward, const Rows<T>& rows,
                                       T* red) {
  T E[3][3];
  essential<T>(x, inward, E);
  T acc[1] = {T(0)};
  for (int i = threadIdx.x; i < rows.n; i += kThreads) {
    const T s = sampson<T>(E, rows.u + 3 * i, rows.v + 3 * i);
    acc[0] += (rows.inl[i] ? T(1) : T(0)) * (s * s);
  }
  block_sum<T, 1>(acc, red);
  return T(0.5) * acc[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    spherical_polish_kernel(const T* __restrict__ r0, const T* __restrict__ u,
                            const T* __restrict__ v, const uint8_t* __restrict__ mask,
                            const uint8_t* __restrict__ inl, const T* __restrict__ E_in,
                            const T* __restrict__ score_in, int N, T thr, int inward,
                            int max_iters, T* __restrict__ r_out,
                            T* __restrict__ E_out, T* __restrict__ score_out,
                            uint8_t* __restrict__ inl_out, long long* __restrict__ iters_out,
                            uint8_t* __restrict__ accepted_out) {
  __shared__ T red[kWarps * kSums];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * N;
  const Rows<T> rows{u + 3 * row, v + 3 * row, mask + row, inl + row, N};
  const bool in = inward != 0;

  T x[3] = {r0[3 * b], r0[3 * b + 1], r0[3 * b + 2]};
  T cost = half_cost<T>(x, in, rows, red);
  T lam = T(1e-6);
  long long iters = 0;
  for (int it = 0; it < max_iters; ++it) {
    Dual<T> xd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xd[k] = lift(x[k]);
      xd[k].d[k] = T(1);
    }
    Dual<T> Ed[3][3];
    essential<T>(xd, in, Ed);
    T acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = T(0);
    for (int i = tid; i < N; i += kThreads) {
      const Dual<T> s = sampson<T>(Ed, rows.u + 3 * i, rows.v + 3 * i);
      const T w = rows.inl[i] ? T(1) : T(0);
      const T j0 = s.d[0] * w, j1 = s.d[1] * w, j2 = s.d[2] * w;
      acc[0] += j0 * s.d[0];
      acc[1] += j0 * s.d[1];
      acc[2] += j0 * s.d[2];
      acc[3] += j1 * s.d[1];
      acc[4] += j1 * s.d[2];
      acc[5] += j2 * s.d[2];
      acc[6] += j0 * s.v;
      acc[7] += j1 * s.v;
      acc[8] += j2 * s.v;
    }
    block_sum<T, kSums>(acc, red);
    T A[3][3] = {{acc[0] + lam * clamp_min(acc[0], T(1e-12)), acc[1], acc[2]},
                 {acc[1], acc[3] + lam * clamp_min(acc[3], T(1e-12)), acc[4]},
                 {acc[2], acc[4], acc[5] + lam * clamp_min(acc[5], T(1e-12))}};
    T rhs[3] = {-acc[6], -acc[7], -acc[8]};
    T dx[3];
    solve3(A, rhs, dx);
    const T xn[3] = {x[0] + dx[0], x[1] + dx[1], x[2] + dx[2]};
    const T cost_new = half_cost<T>(xn, in, rows, red);
    const bool bad = !is_finite(cost_new) || cost_new > cost;
    const T lam_n = bad ? lam * T(10) : clamp_min(lam * T(0.3), T(1e-12));
    if (!bad) {
      x[0] = xn[0];
      x[1] = xn[1];
      x[2] = xn[2];
    }
    const T cost_n = bad ? cost : cost_new;
    const T rel = (cost - cost_n) / clamp_min(cost, T(1e-30));
    const T step = sqrt_of(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
    const T norm = sqrt_of(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
    const bool stop = (!bad && rel < T(1e-10)) || step < T(1e-14) * (norm + T(1e-14)) ||
                      lam_n > T(1e10);
    lam = lam_n;
    cost = cost_n;
    ++iters;
    if (stop) break;
  }

  // rescore the polished model; keep it where its MSAC score is lower
  T E[3][3];
  essential<T>(x, in, E);
  T score[1] = {T(0)};
  uint8_t* out_row = inl_out + row;
  for (int i = tid; i < N; i += kThreads) {
    const T s = sampson<T>(E, rows.u + 3 * i, rows.v + 3 * i);
    const T capped = s > thr ? thr : s;
    score[0] += rows.mask[i] ? capped : T(0);
    out_row[i] = (s < thr) && rows.mask[i];
  }
  block_sum<T, 1>(score, red);
  const T best = score_in[b];
  const bool better = score[0] < best;
  if (!better) {
    for (int i = tid; i < N; i += kThreads) out_row[i] = rows.inl[i];
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) E_out[9 * b + k] = better ? E[k / 3][k % 3] : E_in[9 * b + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) r_out[3 * b + k] = x[k];
    score_out[b] = better ? score[0] : best;
    iters_out[b] = iters;
    accepted_out[b] = better;
  }
}

template <typename T>
int launch(const void* r0, const void* u, const void* v, const void* mask, const void* inl,
           const void* E_in, const void* score_in, int B, int N, double thr, int inward,
           int max_iters, void* r_out, void* E_out, void* score_out, void* inl_out,
           void* iters_out, void* accepted_out, void* stream) {
  if (B < 0 || N < 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  spherical_polish_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r0), static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(inl),
      static_cast<const T*>(E_in), static_cast<const T*>(score_in), N, static_cast<T>(thr),
      inward, max_iters, static_cast<T*>(r_out), static_cast<T*>(E_out),
      static_cast<T*>(score_out), static_cast<uint8_t*>(inl_out),
      static_cast<long long*>(iters_out), static_cast<uint8_t*>(accepted_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Arguments, each row-major and contiguous on one device: r0 (B, 3), u and
// v (B, N, 3), mask and inl (B, N) bool, E_in (B, 3, 3), score_in (B,);
// outputs r_out (B, 3), E_out (B, 3, 3), score_out (B,), inl_out (B, N)
// bool, iters_out (B,) int64, accepted_out (B,) bool. Returns the CUDA error
// of the launch (0 on success).
extern "C" int spherical_polish_f64_launch(const void* r0, const void* u, const void* v,
                                           const void* mask, const void* inl, const void* E_in,
                                           const void* score_in, int B, int N, double thr,
                                           int inward, int max_iters, void* r_out, void* E_out,
                                           void* score_out, void* inl_out, void* iters_out,
                                           void* accepted_out, void* stream) {
  return launch<double>(r0, u, v, mask, inl, E_in, score_in, B, N, thr, inward, max_iters,
                        r_out, E_out, score_out, inl_out, iters_out, accepted_out, stream);
}

extern "C" int spherical_polish_f32_launch(const void* r0, const void* u, const void* v,
                                           const void* mask, const void* inl, const void* E_in,
                                           const void* score_in, int B, int N, double thr,
                                           int inward, int max_iters, void* r_out, void* E_out,
                                           void* score_out, void* inl_out, void* iters_out,
                                           void* accepted_out, void* stream) {
  return launch<float>(r0, u, v, mask, inl, E_in, score_in, B, N, thr, inward, max_iters,
                       r_out, E_out, score_out, inl_out, iters_out, accepted_out, stream);
}
