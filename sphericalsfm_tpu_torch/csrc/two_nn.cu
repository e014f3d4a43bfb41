// Streaming two-nearest-neighbour matcher for Hopper (sm_90a), float32
// inputs on plain FMAs: the exact checker of the matcher's contract.
//
// Replaces sphericalsfm_tpu/ops/pallas_matching.py::_match_kernel, the
// Pallas TPU kernel of the exhaustive matching sweep, for float32 inputs
// (compute_dtype="float32", the JAX package's exactness mode); bf16 inputs,
// the working type, go to csrc/two_nn_wgmma.cu on the tensor cores. For each
// image pair p and each query descriptor q of frame pair_j[p], over the
// train descriptors t of frame pair_i[p]:
//
//   d(t) = 2 - 2 <desc[pair_j[p], q], desc[pair_i[p], t]>   (valid t only)
//   m1   = min d,  m2 = second smallest (m2 = m1 on duplicates),
//   idx  = argmin with the lowest index on ties, -1 if no train row is valid,
//   m1 = m2 = +inf for invalid queries.
//
// Every product accumulates in f32, as the Pallas kernel's
// preferred_element_type=f32 does. The kernel reads the frame-level tables
// directly (desc (F, K, 128), valid (F, K), pair_i, pair_j (P,)), so the
// caller never materialises the gathered desc[a] / desc[b] copies.
//
// What bounds it on the H100: one pair is 2*K*K*128 FLOP against 2*K*128*4 B
// of float32 input, so it is bound by arithmetic: 67 TFLOP/s of float32
// outside the tensor cores. This version is the simple, exact one: plain f32
// FMAs from shared memory. Each block holds one (pair, 64-query tile),
// transposed in shared memory, and streams the train rows through shared
// memory in 64-row tiles. Four threads share a query; each scans a
// contiguous 16-row slice of every tile in ascending order with
//   if (d < m1) {m2 = m1; m1 = d; idx = t} else if (d < m2) m2 = d;
// keeping its running (m1, m2, idx) in registers, and the four partial
// top-2s merge at the end with index tie-breaks. That reproduces the TPU
// semantics exactly.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;       // descriptor length
constexpr int kQT = 64;       // queries per block
constexpr int kTT = 64;       // train rows per shared-memory tile
constexpr int kSplit = 4;     // threads per query
constexpr int kRows = kTT / kSplit;   // train rows each thread scans per tile
constexpr int kThreads = kQT * kSplit;
constexpr int kQStride = kQT + 1;     // padded: conflict-free transposed stores
constexpr int kTStride = kTT + 4;     // padded, keeps float4 reads aligned

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
two_nn_kernel(const T* __restrict__ desc, const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ pair_i, const int32_t* __restrict__ pair_j,
              int K, float* __restrict__ m1_out, float* __restrict__ m2_out,
              int32_t* __restrict__ idx_out) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [kD][kQStride]
  float* t_s = q_s + kD * kQStride;           // [kD][kTStride]
  float* tbias = t_s + kD * kTStride;         // [kTT]: 0 valid, +inf otherwise

  const int p = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int tid = threadIdx.x;
  const int qi = tid % kQT;                   // query within the tile
  const int s = tid / kQT;                    // which 16-row slice it scans
  const size_t fi = static_cast<size_t>(pair_i[p]);
  const size_t fj = static_cast<size_t>(pair_j[p]);
  const T* train = desc + fi * K * kD;
  const T* query = desc + fj * K * kD;
  const uint8_t* tvalid = valid + fi * K;

  // query tile, transposed: q_s[k][row]
  for (int e = tid; e < kQT * kD; e += kThreads) {
    const int row = e / kD, k = e % kD;
    const int q = q0 + row;
    q_s[k * kQStride + row] = q < K ? to_f32(query[static_cast<size_t>(q) * kD + k]) : 0.f;
  }

  float m1 = CUDART_INF_F, m2 = CUDART_INF_F;
  int idx = -1;
  for (int t0 = 0; t0 < K; t0 += kTT) {
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int e = tid; e < kTT * kD; e += kThreads) {
      const int row = e / kD, k = e % kD;
      const int t = t0 + row;
      t_s[k * kTStride + row] = t < K ? to_f32(train[static_cast<size_t>(t) * kD + k]) : 0.f;
    }
    if (tid < kTT) {
      const int t = t0 + tid;
      tbias[tid] = (t < K && tvalid[t]) ? 0.f : CUDART_INF_F;
    }
    __syncthreads();

    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
    const float* tcol = t_s + s * kRows;
#pragma unroll 4
    for (int k = 0; k < kD; ++k) {
      const float qk = q_s[k * kQStride + qi];
      const float4* trow = reinterpret_cast<const float4*>(tcol + k * kTStride);
#pragma unroll
      for (int j4 = 0; j4 < kRows / 4; ++j4) {
        const float4 tv = trow[j4];
        acc[4 * j4 + 0] = fmaf(qk, tv.x, acc[4 * j4 + 0]);
        acc[4 * j4 + 1] = fmaf(qk, tv.y, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(qk, tv.z, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(qk, tv.w, acc[4 * j4 + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = s * kRows + j;
      const float d = 2.f - 2.f * acc[j] + tbias[row];
      if (d < m1) {
        m2 = m1;
        m1 = d;
        idx = t0 + row;
      } else if (d < m2) {
        m2 = d;
      }
    }
  }

  // merge the kSplit partial top-2s of each query (exact multiset merge;
  // equal minima keep the lower train index)
  __syncthreads();
  float* pm1 = smem;                       // reuse q_s: [kSplit][kQT]
  float* pm2 = pm1 + kSplit * kQT;
  int* pidx = reinterpret_cast<int*>(pm2 + kSplit * kQT);
  pm1[s * kQT + qi] = m1;
  pm2[s * kQT + qi] = m2;
  pidx[s * kQT + qi] = idx;
  __syncthreads();
  if (s == 0) {
    for (int o = 1; o < kSplit; ++o) {
      const float a1 = pm1[o * kQT + qi], a2 = pm2[o * kQT + qi];
      const int ai = pidx[o * kQT + qi];
      const float n2 = fminf(fmaxf(m1, a1), fminf(m2, a2));
      // a finite partial minimum has ai >= 0; when m1 is finite, idx >= 0
      if (a1 < m1 || (a1 == m1 && ai >= 0 && ai < idx)) idx = ai;
      m1 = fminf(m1, a1);
      m2 = n2;
    }
    const int q = q0 + qi;
    if (q < K) {
      const size_t o = static_cast<size_t>(p) * K + q;
      const bool qvalid = valid[fj * K + q] != 0;
      m1_out[o] = qvalid ? m1 : CUDART_INF_F;
      m2_out[o] = qvalid ? m2 : CUDART_INF_F;
      idx_out[o] = idx;
    }
  }
}

template <typename T>
int launch(const void* desc, const void* valid, const void* pair_i, const void* pair_j,
           int P, int K, void* m1, void* m2, void* idx, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kD * kQStride + kD * kTStride + kTT);
  cudaFuncSetAttribute(two_nn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((K + kQT - 1) / kQT, P);
  two_nn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(desc), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(pair_i), static_cast<const int32_t*>(pair_j), K,
      static_cast<float*>(m1), static_cast<float*>(m2), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes: desc is the (F, K, 128) float32
// frame table. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int two_nn_f32_launch(const void* desc, const void* valid, const void* pair_i,
                                 const void* pair_j, int P, int K, int D, void* m1, void* m2,
                                 void* idx, void* stream) {
  if (D != kD || P <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(desc, valid, pair_i, pair_j, P, K, m1, m2, idx,
                       static_cast<cudaStream_t>(stream));
}
