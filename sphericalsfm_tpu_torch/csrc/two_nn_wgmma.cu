// Two-nearest-neighbour descriptor matcher on Hopper's tensor cores (sm_90a),
// bfloat16 inputs with float32 accumulation.
//
// Replaces sphericalsfm_tpu/ops/pallas_matching.py::_match_kernel (launched
// at :127 by two_nearest_neighbors_batched) for bf16 inputs, the matcher's
// working type; csrc/two_nn.cu keeps the exact float32 FMA version. The
// contract is that kernel's: for each pair p and each query q of frame
// pair_j[p], over the train rows t of frame pair_i[p],
//
//   d(t) = 2 - 2 <desc[pair_j[p], q], desc[pair_i[p], t]> + bias(t),
//          bias = +inf for invalid train rows and for rows at or past K,
//   m1   = min d,  m2 = second smallest (m2 = m1 on duplicates),
//   idx  = argmin with the lowest index on ties, -1 if no train row is valid,
//   m1 = m2 = +inf for invalid queries.
//
// What bounds it on the H100: a pair is 2*K*K*128 FLOP against 2*K*256 B
// of bf16 descriptors, ~1000 FLOP/B at K = 4000, far above the card's ~295
// FLOP/B bf16 ridge. So the tensor cores bound it: 32 pairs x 4000 is 131
// GFLOP, 133 us at 989 TFLOP/s dense bf16. What bounds this design, as
// measured (scripts/two_nn_ablation.py, PERF.md): the wgmma work alone runs
// near the tensor-core rate, but the top-2 epilogue costs about as much
// again and does not overlap it. Each distance takes one FMA and about five
// compare/select/min instructions, which issue on the half-rate ALU pipe.
// Two accumulator sets per warpgroup, and the next tile's k-steps
// interleaved with the epilogue, left that unchanged, so this version keeps
// one set; an epilogue with fewer ALU instructions per distance is the next
// step.
//
// Design. One block per (pair, 128-query tile), 288 threads:
// - a producer warp. Lane 0 brings the query tile (128 x 128 bf16, 32 KB)
//   into shared memory once, then streams the train frame in 128-row tiles
//   through a 4-stage ring, all with TMA (cp.async.bulk.tensor over a 3-D
//   map (F, K, 128), two 64-column boxes a tile, 128-byte swizzle, rows past
//   K zero-filled) and full/empty mbarriers. The warp writes each tile's
//   bias (2 for a valid row, +inf otherwise) beside it, so d is one FMA.
// - two consumer warpgroups of 64 query rows. Per train tile each issues
//   eight wgmma.m64n128k16.f32.bf16.bf16 with both operands read from
//   shared memory (K-major, 128-byte swizzle) into 64 f32 accumulators a
//   thread.
// - the top-2 epilogue runs in registers, in the accumulator layout: a
//   thread holds query rows r and r + 8 and, for each, the columns
//   8i + 2(lane % 4) + {0, 1}. It visits them in ascending order with the
//   strict-< update of two_nn.cu, so the lowest index wins ties within a
//   thread; the tile's top-2 then merges into the running one (tiles come in
//   order, so equal minima keep the earlier index), and at the end the four
//   lanes of a row merge with an index tie-break through warp shuffles.
// The frame table is read through pair_i / pair_j: no gathered copies.
// Copies and tensor-core work overlap through the ring.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                         // descriptor length
constexpr int kHalf = 64;                       // bf16 columns in one 128-byte swizzle row
constexpr int kBM = 128;                        // queries per block
constexpr int kBN = 128;                        // train rows per tile
constexpr int kStages = 4;                      // train tiles in the ring
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kThreads = kConsumers + 32;       // + the producer warp
constexpr int kHalfBytes = kBN * kHalf * 2;     // one TMA box: 128 rows x 128 B
constexpr int kTileBytes = 2 * kHalfBytes;      // 32 KB, query and train tiles alike
constexpr int kRingOff = kTileBytes;            // the query tile sits at offset 0
constexpr int kBiasOff = kRingOff + kStages * kTileBytes;
constexpr int kBarOff = kBiasOff + kStages * kBN * 4;
constexpr int kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
static_assert(kBM == kBN, "the query and train tiles share one box shape");

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

// One 64-column box of the (F, K, 128) map at (column c0, row c1, frame c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle that TMA wrote: start address >> 4; leading byte offset 16 B (not
// used by this layout); stride byte offset 1024 B, one 8-row x 128 B atom;
// layout type 1 = 128-byte swizzle. Atoms start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 128 per warpgroup) (+)= A (64 x 16) * B (16 x 128), A and B K-major
// in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Pin the accumulators in program order around the asynchronous wgmma: the
// compiler may not move their reads across this point.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Running top-2 of one query row over the columns a thread has seen.
struct Top2 {
  float m1, m2;
  int idx;
};

__device__ __forceinline__ Top2 top2_empty() { return Top2{CUDART_INF_F, CUDART_INF_F, -1}; }

// The strict-< update of two_nn.cu: visited in ascending column order,
// equal minima keep the earlier column j.
__device__ __forceinline__ void top2(Top2& t, float d, int j) {
  const bool lt = d < t.m1;
  t.m2 = lt ? t.m1 : fminf(t.m2, d);
  t.m1 = lt ? d : t.m1;
  t.idx = lt ? j : t.idx;
}

// Merge a top-2 over later columns into the running one: equal minima keep
// the running index.
__device__ __forceinline__ void merge_later(Top2& t, const Top2& b, int bidx) {
  t.m2 = fminf(fmaxf(t.m1, b.m1), fminf(t.m2, b.m2));
  if (b.m1 < t.m1) t.idx = bidx;
  t.m1 = fminf(t.m1, b.m1);
}

// Merge with the lane `mask` away (disjoint, interleaved columns): equal
// minima keep the lower index. A finite minimum always has an index >= 0.
__device__ __forceinline__ void merge_lanes(Top2& t, int mask) {
  const float b1 = __shfl_xor_sync(0xffffffffu, t.m1, mask);
  const float b2 = __shfl_xor_sync(0xffffffffu, t.m2, mask);
  const int bi = __shfl_xor_sync(0xffffffffu, t.idx, mask);
  t.m2 = fminf(fmaxf(t.m1, b1), fminf(t.m2, b2));
  if (b1 < t.m1 || (b1 == t.m1 && bi >= 0 && bi < t.idx)) t.idx = bi;
  t.m1 = fminf(t.m1, b1);
}

// The eight k-steps of one train tile's products into acc, as one commit
// group. Step k moves 16 columns (32 B) along the swizzled rows; steps 4..7
// read the second 64-column box.
__device__ __forceinline__ void issue_tile(float (&acc)[64], uint32_t a_base, uint32_t b_base) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) {
    const uint32_t off = (k / 4) * kHalfBytes + (k % 4) * 32;
    wgmma_m64n128k16(acc, sw128_desc(a_base + off), sw128_desc(b_base + off), k > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Fold train tile n (products in acc, complete) into the running top-2s of
// rows r (acc[4i], acc[4i + 1]) and r + 8 (acc[4i + 2], acc[4i + 3]), whose
// columns are 8i + 2 quad + {0, 1}, and free tile n's stage.
__device__ __forceinline__ void reduce_tile(float (&acc)[64], int n, uint32_t sbase,
                                            const float* bias, int quad, Top2& ra, Top2& rb) {
  fence_acc(acc);
  const int s = n % kStages;
  const float* b2 = bias + s * kBN + 2 * quad;
  Top2 a = top2_empty(), b = top2_empty();   // over tile-local columns j = 2i + c
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 bb = *reinterpret_cast<const float2*>(b2 + 8 * i);
    top2(a, fmaf(-2.f, acc[4 * i + 0], bb.x), 2 * i);
    top2(a, fmaf(-2.f, acc[4 * i + 1], bb.y), 2 * i + 1);
    top2(b, fmaf(-2.f, acc[4 * i + 2], bb.x), 2 * i);
    top2(b, fmaf(-2.f, acc[4 * i + 3], bb.y), 2 * i + 1);
  }
  mbar_arrive(sbase + kBarOff + 8 * kStages + 8 * s);   // empty[s]
  const int col0 = n * kBN + 2 * quad;
  merge_later(ra, a, a.idx < 0 ? -1 : col0 + 8 * (a.idx >> 1) + (a.idx & 1));
  merge_later(rb, b, b.idx < 0 ? -1 : col0 + 8 * (b.idx >> 1) + (b.idx & 1));
}

__global__ void __launch_bounds__(kThreads, 1)
two_nn_wgmma_kernel(const __grid_constant__ CUtensorMap desc_map, const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ pair_i, const int32_t* __restrict__ pair_j, int K,
                    float* __restrict__ m1_out, float* __restrict__ m2_out,
                    int32_t* __restrict__ idx_out) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte alignment in the shared address space
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  float* bias = reinterpret_cast<float*>(smem + kBiasOff);   // [kStages][kBN]
  const uint32_t full0 = sbase + kBarOff;                     // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;

  const int p = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int fi = pair_i[p];
  const int fj = pair_j[p];
  const int tiles = (K + kBN - 1) / kBN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);            // the producer warp's 32 lanes
      mbar_init(empty0 + 8 * s, kConsumers);   // every consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: the query tile once, then the train tiles through the ring
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, kTileBytes);
      tma_load(sbase, &desc_map, qbar, 0, q0, fj);
      tma_load(sbase + kHalfBytes, &desc_map, qbar, kHalf, q0, fj);
    }
    const uint8_t* tvalid = valid + static_cast<size_t>(fi) * K;
    for (int n = 0; n < tiles; ++n) {
      const int s = n % kStages;
      mbar_wait(empty0 + 8 * s, ((n / kStages) & 1) ^ 1);
      const int t0 = n * kBN;
      const int t = t0 + 4 * lane;
      reinterpret_cast<float4*>(bias + s * kBN)[lane] = make_float4(
          (t < K && tvalid[t]) ? 2.f : CUDART_INF_F,
          (t + 1 < K && tvalid[t + 1]) ? 2.f : CUDART_INF_F,
          (t + 2 < K && tvalid[t + 2]) ? 2.f : CUDART_INF_F,
          (t + 3 < K && tvalid[t + 3]) ? 2.f : CUDART_INF_F);
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        const uint32_t dst = sbase + kRingOff + s * kTileBytes;
        mbar_arrive_expect_tx(full, kTileBytes);
        tma_load(dst, &desc_map, full, 0, t0, fi);
        tma_load(dst + kHalfBytes, &desc_map, full, kHalf, t0, fi);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows wg*64 .. wg*64 + 63 of the tile
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int row = wg * 64 + warp * 16 + lane / 4;   // and row + 8
  const uint32_t a_base = sbase + wg * 64 * 128;    // 64 rows x 128 B into each half

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  Top2 ra = top2_empty(), rb = top2_empty();   // rows `row` and `row + 8`

  mbar_wait(qbar, 0);
  for (int n = 0; n < tiles; ++n) {
    const int s = n % kStages;
    mbar_wait(full0 + 8 * s, (n / kStages) & 1);
    __syncwarp();
    issue_tile(acc, a_base, sbase + kRingOff + s * kTileBytes);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    reduce_tile(acc, n, sbase, bias, quad, ra, rb);
  }

  merge_lanes(ra, 1);
  merge_lanes(ra, 2);
  merge_lanes(rb, 1);
  merge_lanes(rb, 2);
  const int q = q0 + row + 8 * quad;   // quad 0 stores row `row`, quad 1 row `row + 8`
  if (quad < 2 && q < K) {
    const size_t o = static_cast<size_t>(p) * K + q;
    const bool qvalid = valid[static_cast<size_t>(fj) * K + q] != 0;
    m1_out[o] = qvalid ? (quad ? rb.m1 : ra.m1) : CUDART_INF_F;
    m2_out[o] = qvalid ? (quad ? rb.m2 : ra.m2) : CUDART_INF_F;
    idx_out[o] = quad ? rb.idx : ra.idx;
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

// Plain C entry point, bound with ctypes: desc is the (F, K, 128) bf16 frame
// table. Returns 0 on success, else a cudaError_t (cudaGetLastError() after
// the launch; cudaErrorInvalidValue for shapes it does not take;
// cudaErrorSymbolNotFound when the driver has no tensor-map encoder or
// refuses the map).
extern "C" int two_nn_wgmma_launch(const void* desc, int F, const void* valid,
                                   const void* pair_i, const void* pair_j, int P, int K, int D,
                                   void* m1, void* m2, void* idx, void* stream) {
  if (D != kD || P <= 0 || P > 65535 || K <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(F)};
  const cuuint64_t strides[2] = {kD * 2, static_cast<cuuint64_t>(K) * kD * 2};  // bytes
  const cuuint32_t box[3] = {kHalf, kBN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(desc), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorSymbolNotFound);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        two_nn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((K + kBM - 1) / kBM, P);
  two_nn_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(pair_i),
      static_cast<const int32_t*>(pair_j), K, static_cast<float*>(m1), static_cast<float*>(m2),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
