// Two-nearest-neighbour descriptor matcher for Hopper (sm_90a), float32
// inputs on the FP32 FMA pipe: the exact checker of the matcher's contract.
//
// Replaces sphericalsfm_tpu/ops/pallas_matching.py::_match_kernel (launched
// at :127 by two_nearest_neighbors_batched) for float32 inputs
// (compute_dtype="float32", the JAX package's exactness mode); bf16 inputs,
// the working type, go to csrc/two_nn_wgmma.cu on the tensor cores. For each
// pair p and each query q of frame pair_j[p], over the train rows t of frame
// pair_i[p]:
//
//   d(t) = 2 - 2 <desc[pair_j[p], q], desc[pair_i[p], t]> + bias(t),
//          bias = 0 for valid rows, +inf for invalid ones and rows past K,
//   m1   = min d,  m2 = second smallest (m2 = m1 on duplicates),
//   idx  = argmin with the lowest index on ties, -1 if no train row is valid,
//   m1 = m2 = +inf for invalid queries.
//
// Exactness. Each inner product is one fmaf chain over k = 0..127 in
// ascending order from 0.f, and d is `2.f - 2.f * acc + bias`: the
// arithmetic of the first, simple version of this kernel (1 query x 16 train
// rows a thread, tiles copied synchronously), so the distances are its
// distances bit for bit. No split-k, no fast math, no tensor cores.
// The top-2 is exact (strict-< updates in ascending train order per thread,
// lowest-index tie-breaks when partial top-2s merge), so equal distances
// give equal (m1, m2, idx) in any visiting order. Inputs are finite.
//
// What bounds it on the H100: a pair is 2*K*K*128 FLOP against 2*K*512 B of
// float32 descriptors, so the FP32 pipe bounds it: 67 TFLOP/s outside the
// tensor cores, 1.956 ms for 32 pairs x 4000. Every instruction slot that is not
// an FFMA is lost to that pipe, and shared memory returns 128 B a clock to
// an SM that does 128 FMAs a clock, so the design keeps the FFMA share of
// the instruction stream high and reads less than a byte a FMA:
//
// Design. One block per (pair, 128-query tile), 256 threads, ~194 KB of
// shared memory, one block an SM:
// - the copies. Thread 0 brings the query tile (128 x 128 f32, 64 KB) into
//   shared memory once, then streams the train frame in 256-row tiles, each
//   as two units of 64 k (64 KB), through a 2-stage ring: unit h of every
//   tile goes to stage h. All copies are TMA (cp.async.bulk.tensor over 3-D
//   maps (F, K, 128) of float32, 32-column boxes of 128 query or 256 train
//   rows, 128-byte swizzle, rows past K zero-filled) completing on full
//   mbarriers; thread 0 refills a stage once every thread has arrived on its
//   empty mbarrier, a unit ahead of its use.
// - the products. The threads form a 16 x 16 grid, each with an 8 x 16
//   register micro-tile: queries ty + 16i and train rows tx + 16j, 128
//   accumulators. Per group of 4 k a thread reads 8 query and 16 train
//   float4s (24 LDS.128, 0.75 B, for 512 FFMA), the next train row while
//   the current one's FMAs run. The swizzle puts the 16-byte chunk c of row
//   r at c ^ (r % 8), and a warp's eight train rows (and four query rows)
//   differ in r % 8, so every float4 read is conflict-free.
// - the top-2, after each tile, in registers: per query, the thread's 16
//   columns in ascending order; at the end the 16 threads of a query row
//   merge with an index tie-break, 8 through warp shuffles and the last 2
//   through shared memory. It is ~5 ALU instructions a distance on the
//   half-rate pipe, against 128 FFMAs.
// The grid is one-dimensional, pairs major (blockIdx.x = p * tiles + qt),
// so any pair count up to 2^31 - 1 blocks runs; blocks of one pair run side
// by side and share its train frame in L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                         // descriptor length
constexpr int kBoxK = 32;                       // floats in one 128-byte swizzle row
constexpr int kBM = 128;                        // queries per block
constexpr int kBN = 256;                        // train rows per tile
constexpr int kHalfK = kD / 2;                  // k per ring stage: a tile is two stages
constexpr int kStages = 2;                      // stage h holds k = 64h .. 64h + 63
constexpr int kMi = 8;                          // a thread's queries
constexpr int kMj = 16;                         // a thread's train rows per tile
constexpr int kSpan = 16;                       // threads across each side
constexpr int kThreads = kSpan * kSpan;         // 256
constexpr int kRowBytes = kBoxK * 4;            // 128
constexpr int kQBoxBytes = kBM * kRowBytes;     // a query box: 128 rows x 128 B
constexpr int kTBoxBytes = kBN * kRowBytes;     // a train box: 256 rows x 128 B
constexpr int kQTileBytes = (kD / kBoxK) * kQBoxBytes;       // 64 KB
constexpr int kStageBytes = (kHalfK / kBoxK) * kTBoxBytes;   // 64 KB
constexpr int kIStride = kSpan * kRowBytes;     // bytes between rows r and r + 16
constexpr int kRingOff = kQTileBytes;           // the query tile sits at offset 0
constexpr int kMergeOff = kRingOff + kStages * kStageBytes;
constexpr int kBarOff = kMergeOff + kBM * 12;
constexpr int kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
static_assert(kBM == kSpan * kMi && kBN == kSpan * kMj, "the thread grid covers the tiles");
static_assert(kSmemBytes <= 232448, "over the H100's shared memory per block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity to complete. A copy or an
// arrival that never comes traps after two seconds instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - start > 2000000000ull) __trap();
}

// One 32-column box of the (F, K, 128) map at (column c0, row c1, frame c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `boxes` 32-column boxes of rows r0.. of frame f, from column c0, into
// dst, completing on bar.
__device__ __forceinline__ void tma_boxes(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int boxes, int box_bytes, int c0, int r0, int f) {
  mbar_arrive_expect_tx(bar, boxes * box_bytes);
  for (int b = 0; b < boxes; ++b) tma_load(dst + b * box_bytes, map, bar, c0 + b * kBoxK, r0, f);
}

// Byte offset of float4 group g (k = 4g .. 4g + 3 from the buffer's first
// column) of row r, as the 128-byte swizzle placed it: box g / 8, chunk
// (g % 8) ^ (r % 8). Rows r + 16i share r % 8, so callers add i * kIStride.
__device__ __forceinline__ int swizzled(int g, int r, int box_bytes) {
  return (g >> 3) * box_bytes + r * kRowBytes + (((g ^ r) & 7) << 4);
}

__device__ __forceinline__ float4 lds4(const uint8_t* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The products of one group of 4 k for the thread's 8 x 16 micro-tile: the
// 8 query float4s in registers, the 16 train float4s read one row ahead.
// Each accumulator takes its 4 k in ascending order.
__device__ __forceinline__ void fma_group(float (&acc)[kMi][kMj], const float4 (&q)[kMi],
                                          const uint8_t* tp) {
  float4 tn = lds4(tp);
#pragma unroll
  for (int j = 0; j < kMj; ++j) {
    const float4 t = tn;
    if (j + 1 < kMj) tn = lds4(tp + (j + 1) * kIStride);
#pragma unroll
    for (int i = 0; i < kMi; ++i) acc[i][j] = fmaf(q[i].x, t.x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < kMi; ++i) acc[i][j] = fmaf(q[i].y, t.y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < kMi; ++i) acc[i][j] = fmaf(q[i].z, t.z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < kMi; ++i) acc[i][j] = fmaf(q[i].w, t.w, acc[i][j]);
  }
}

// Running top-2 of one query row over the columns a thread has seen.
struct Top2 {
  float m1, m2;
  int idx;
};

// The strict-< update, visited in ascending train order: equal minima keep
// the earlier index, and a duplicate minimum becomes m2. As min / max, with
// no select of m1 into m2.
__device__ __forceinline__ void top2(Top2& t, float d, int j) {
  t.idx = d < t.m1 ? j : t.idx;
  t.m2 = fminf(t.m2, fmaxf(t.m1, d));
  t.m1 = fminf(t.m1, d);
}

// Merge a partial top-2 over disjoint columns: equal minima keep the lower
// index. A finite minimum always has an index >= 0.
__device__ __forceinline__ void merge(Top2& t, float b1, float b2, int bi) {
  t.m2 = fminf(fmaxf(t.m1, b1), fminf(t.m2, b2));
  if (b1 < t.m1 || (b1 == t.m1 && bi >= 0 && bi < t.idx)) t.idx = bi;
  t.m1 = fminf(t.m1, b1);
}

__device__ __forceinline__ void merge_lanes(Top2& t, int mask) {
  merge(t, __shfl_xor_sync(0xffffffffu, t.m1, mask), __shfl_xor_sync(0xffffffffu, t.m2, mask),
        __shfl_xor_sync(0xffffffffu, t.idx, mask));
}

__global__ void __launch_bounds__(kThreads, 1)
two_nn_f32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap t_map,
                  const uint8_t* __restrict__ valid, const int32_t* __restrict__ pair_i,
                  const int32_t* __restrict__ pair_j, int K, float* __restrict__ m1_out,
                  float* __restrict__ m2_out, int32_t* __restrict__ idx_out) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte alignment in the shared address space
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kBarOff;                     // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;

  const int q_tiles = (K + kBM - 1) / kBM;
  const int p = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBM;
  const int fi = pair_i[p];
  const int fj = pair_j[p];
  const int tiles = (K + kBN - 1) / kBN;
  const int tid = threadIdx.x;

  // thread 0 starts every copy: the query tile, then each unit u = 2n + h
  // (the half h of train tile n) into stage h once every thread is past
  // unit u - 2
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);           // thread 0's arrival + the bytes
      mbar_init(empty0 + 8 * s, kThreads);   // every thread, after its products
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    tma_boxes(sbase, &q_map, qbar, kD / kBoxK, kQBoxBytes, 0, q0, fj);
    for (int h = 0; h < kStages; ++h)
      tma_boxes(sbase + kRingOff + h * kStageBytes, &t_map, full0 + 8 * h, kHalfK / kBoxK,
                kTBoxBytes, h * kHalfK, 0, fi);
  }
  __syncthreads();

  // a warp covers 8 train columns (tx) x 4 query rows (ty)
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tx = (lane & 7) + 8 * (warp & 1);    // train rows tx + 16 j of every tile
  const int ty = (lane >> 3) + 4 * (warp >> 1);  // queries q0 + ty + 16 i
  const uint8_t* tvalid = valid + static_cast<size_t>(fi) * K;

  Top2 r[kMi];
#pragma unroll
  for (int i = 0; i < kMi; ++i) r[i] = Top2{CUDART_INF_F, CUDART_INF_F, -1};

  mbar_wait(qbar, 0);
  for (int n = 0; n < tiles; ++n) {
    float acc[kMi][kMj];
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int j = 0; j < kMj; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int h = 0; h < kStages; ++h) {   // stage h holds k = 64h .. 64h + 63
      const int u = 2 * n + h;
      if (tid == 0 && u >= 1 && u + 1 < 2 * tiles) {
        // unit u + 1 into the stage of unit u - 1, once every thread is past it
        const int sp = 1 - h;
        mbar_wait(empty0 + 8 * sp, ((u - 1) / 2) & 1);
        tma_boxes(sbase + kRingOff + sp * kStageBytes, &t_map, full0 + 8 * sp, kHalfK / kBoxK,
                  kTBoxBytes, sp * kHalfK, ((u + 1) / 2) * kBN, fi);
      }
      mbar_wait(full0 + 8 * h, n & 1);
      const uint8_t* t_stage = smem + kRingOff + h * kStageBytes;
#pragma unroll 1
      for (int lg = 0; lg < kHalfK / 4; ++lg) {
        const uint8_t* qp = smem + swizzled(h * (kHalfK / 4) + lg, ty, kQBoxBytes);
        float4 q[kMi];
#pragma unroll
        for (int i = 0; i < kMi; ++i) q[i] = lds4(qp + i * kIStride);
        fma_group(acc, q, t_stage + swizzled(lg, tx, kTBoxBytes));
      }
      mbar_arrive(empty0 + 8 * h);   // this thread is done with the stage
    }

    // the tile's distances, each query's columns in ascending order
    const int col0 = n * kBN + tx;
#pragma unroll
    for (int j = 0; j < kMj; ++j) {
      const int t = col0 + kSpan * j;
      const bool ok = tvalid[min(t, K - 1)] != 0;   // clamped: a read with no branch
      const float bias = (t < K && ok) ? 0.f : CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kMi; ++i) top2(r[i], 2.f - 2.f * acc[i][j] + bias, t);
    }
  }

  // merge the 16 threads of each query row: the 8 lanes of a warp, then the
  // warp that holds the other 8 columns (warp ^ 1), through shared memory
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    merge_lanes(r[i], 1);
    merge_lanes(r[i], 2);
    merge_lanes(r[i], 4);
  }
  float* pm1 = reinterpret_cast<float*>(smem + kMergeOff);   // [kBM]
  float* pm2 = pm1 + kBM;
  int* pidx = reinterpret_cast<int*>(pm2 + kBM);
  const bool upper = (warp & 1) != 0;
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    if (upper && (lane & 7) == i) {
      const int row = ty + kSpan * i;
      pm1[row] = r[i].m1;
      pm2[row] = r[i].m2;
      pidx[row] = r[i].idx;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    const int row = ty + kSpan * i;
    const int q = q0 + row;
    if (!upper && (lane & 7) == i && q < K) {
      merge(r[i], pm1[row], pm2[row], pidx[row]);
      const size_t o = static_cast<size_t>(p) * K + q;
      const bool qvalid = valid[static_cast<size_t>(fj) * K + q] != 0;
      m1_out[o] = qvalid ? r[i].m1 : CUDART_INF_F;
      m2_out[o] = qvalid ? r[i].m2 : CUDART_INF_F;
      idx_out[o] = r[i].idx;
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

}  // namespace

// Plain C entry point, bound with ctypes: desc is the (F, K, 128) float32
// frame table, 16-byte aligned. Returns 0 on success, else a cudaError_t
// (cudaGetLastError() after the launch; cudaErrorInvalidValue for shapes it
// does not take, among them P * ceil(K / 128) >= 2^31; cudaErrorSymbolNotFound
// when the driver has no tensor-map encoder or refuses the map; the error of
// cudaFuncSetAttribute).
extern "C" int two_nn_f32_launch(const void* desc, int F, const void* valid, const void* pair_i,
                                 const void* pair_j, int P, int K, int D, void* m1, void* m2,
                                 void* idx, void* stream) {
  if (D != kD || P <= 0 || K <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(P) * ((K + kBM - 1) / kBM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // one map per box shape: query boxes of kBM rows, train boxes of kBN
  CUtensorMap maps[2];
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(F)};
  const cuuint64_t strides[2] = {kD * 4, static_cast<cuuint64_t>(K) * kD * 4};  // bytes
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  for (int m = 0; m < 2; ++m) {
    const cuuint32_t box[3] = {kBoxK, static_cast<cuuint32_t>(m ? kBN : kBM), 1};
    if (encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(desc), dims,
               strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      two_nn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  two_nn_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pair_i),
      static_cast<const int32_t*>(pair_j), K, static_cast<float*>(m1), static_cast<float*>(m2),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
