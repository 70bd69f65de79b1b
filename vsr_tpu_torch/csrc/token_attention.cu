// Token attention for Hopper (sm_90a): out = softmax(q k^T * scale + key_bias) v
// over pre-tokenized patch tokens q [B, Nq, D], k/v [B, Nk, D], bias [B, Nk].
//
// Replaces the Pallas TPU kernel vsr_tpu/ops/pallas_token_attention.py
// (flash_token_attention, body _flash_kernel). Same contract: scores, softmax
// statistics and the output accumulator are fp32 whatever the input type; the
// additive key bias is applied in fp32 after the scale; the output is written
// in q's type. Keys past Nk get -inf here, so the caller pads nothing and a
// row whose real keys all carry the -1e9 bias spreads its weight over the
// real keys only, as the Pallas kernel does.
//
// What bounds it on this card: arithmetic. The STTN small-patch scales have
// D = 960 (N = 5120 at L = 16) and D = 3200 (N = 1536): 4 N^2 D is 100.7 and
// 30.2 GFLOP a call against 39.3 MB of q, k, v and out, far above the ~295
// bf16 operations a byte at which the tensor cores, not memory, set the pace.
// A flash-attention block cannot keep its fp32 [rows, D] accumulator on chip
// at D = 3200 (800 KB for 64 rows), so the bf16 route splits the work in two
// kernels and computes q k^T once per (query, key) pair:
//
//  1. score_kernel, one block per (128-key tile, 256-query tile, b): streams
//     Q and K in 64-deep slices of D through a TMA ring and runs q k^T on
//     wgmma (m64n128k16 by four warpgroups of 64 rows, both operands in
//     shared memory, fp32 accumulators).
//     Epilogue: s = acc * scale + bias (log2 domain), tile row max m_t,
//     p = 2^(s - m_t) stored as bf16 to P [B, Nq, Nk_pad] by TMA, and the row
//     sum l_t (fp32, of the unrounded p) with m_t to partials [B, key tiles,
//     Nq_pad].
//  2. pv_kernel, one block per (160 columns of D, 128-query tile, b): merges
//     the row's partials (m = max m_t, l = sum l_t 2^(m_t - m)), streams P
//     and V tiles by TMA, scales each P fragment by 2^(m_t - m) / l of its
//     key tile in registers, and runs p v on wgmma (m64n160k16, A from
//     registers, V read MN-major through the transpose flag from five
//     [64 keys][32 columns] tiles, 64-byte swizzle). Two sets of
//     fragments alternate, so one 64-key stage is loaded and scaled while
//     the previous stage's products run. The bf16 output goes out through
//     shared memory by TMA stores.
//
// Both kernels are warp-specialised: one producer warp keeps a ring of
// shared-memory stages filled with TMA loads (128-byte swizzle, matching the
// wgmma descriptors) and consumer warpgroups of 64 rows each run wgmma. Each
// kernel takes an SM alone. A tile's operands must reach its SM as fast as
// its products use them: a 128 x 128 score tile brings 64 FLOP per operand
// byte, about the 67 at which 64 bytes a clock into the SM (an estimate of
// its port from L2) just keeps the tensor cores fed, and ran at under half
// their rate; the 256 x 128 tile brings 85. The p v kernel moves registers
// from its producer warpgroup to its consumers (setmaxnreg) for the
// accumulators and the two sets of fragments. Its 160-column tiles split
// D = 960 and 3200 exactly, into 240 blocks at both sttn-auto scales
// (256-column tiles gave 160 and 156 blocks: two waves on 132 SMs, the second
// barely used). The price of the split is P in device memory: 2 Nq Nk_pad
// bytes written once and read once per column tile, the reads mostly from L2
// since a query tile's column blocks run side by side.
// Tensor maps are 3-D [B, N, D], so rows past N read as zeros rather than
// the next batch's; they need D % 8 == 0 and 16-byte aligned bases (the
// wrapper copies other inputs into an aligned, zero-padded buffer).
//
// fp32 inputs keep the plain FMA kernels (stats_kernel, output_kernel): a
// stats pass over key splits and an output pass per 256-column slice that
// recomputes the scores. They serve fp32 checks and compute_dtype="float32",
// not the bf16 main path.
//
// Plain C entry points (bound with ctypes), each returning 0 or a
// cudaError_t (tensor-map failures: kTensorMapError + CUresult):
// token_attention_tiles, token_attention_splits, token_attention_f32,
// token_attention_bf16.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTensorMapError = 10000;

// ---------------------------------------------------------------------------
// bf16 route: score_kernel + pv_kernel (TMA ring, wgmma)
// ---------------------------------------------------------------------------

constexpr int kTile = 128;       // keys per score tile; query rows per p v block
constexpr int kScoreRows = 256;  // query rows per score block (four warpgroups)
constexpr int kDepth = 64;       // one ring stage of D (score) or of keys (p v): 128 bytes of bf16
// Output columns of D per p v block: 960 = 6 x 160 and 3200 = 20 x 160, so
// both sttn-auto widths split into 240 blocks without a ragged column tile.
constexpr int kCols = 160;
// Columns of one V tile and of one output TMA store: [64 rows][32 bf16], the
// 64-byte swizzle. 32 divides kCols, so a stage loads the block's 160 V
// columns and no more.
constexpr int kVBox = 32;
constexpr int kOutBox = 32;
constexpr int kConsumerWarps = 8;  // p v: two warpgroups of 64 rows each
constexpr int kScoreWarps = kScoreRows / 16;  // score: one warpgroup per 64 rows
constexpr int kScoreThreads = kScoreWarps * 32 + 32;  // + one producer warp
// p v: a whole producer warpgroup (one warp of it works), so that its
// registers can go to the consumers' accumulators and fragments (setmaxnreg)
constexpr int kPvThreads = kConsumerWarps * 32 + 128;
constexpr int kScoreStages = 4;
constexpr int kPvStages = 5;
constexpr uint32_t kBox = 64 * 128;  // bytes of one [64 rows][64 bf16] swizzled tile
constexpr uint32_t kScoreStage = (kScoreRows / 64 + 2) * kBox;  // Q [256][64] + K [128][64]
constexpr uint32_t kVTile = kDepth * kVBox * 2;     // one [64 keys][32 bf16] V tile
constexpr uint32_t kPvStage = 2 * kBox + kCols / kVBox * kVTile;  // P [128][64] + V [64][160]
constexpr uint32_t kOutStage = 64 * kOutBox * 2;       // one [64 rows][32 bf16] output tile
constexpr size_t kScoreSmem = 1024 + kScoreStages * kScoreStage + 16 * kScoreStages;
constexpr size_t kPvSmem = 1024 + kPvStages * kPvStage + 16 * kPvStages;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kScoreRows / 64 * 2 * kBox <= kScoreStages * kScoreStage,
              "P staging fits in the score ring");
static_assert(2 * (kCols / kOutBox) * kOutStage <= kPvStages * kPvStage,
              "output staging fits in the p v ring");
static_assert(kCols % kOutBox == 0 && kCols % kVBox == 0, "p v column tiling");
static_assert(kPvStage % 1024 == 0, "p v stages keep the 128-byte swizzle's alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Out-of-range rows and columns of the box are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// Waits until the issued TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a [rows][128 bytes]
// tile written by TMA with the 128-byte swizzle (tile base 1024-aligned).
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The same for a [rows][64 bytes] tile and the 64-byte swizzle (base
// 512-aligned).
__device__ __forceinline__ uint32_t swizzled64(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// wgmma shared-memory descriptor. lbo / sbo in bytes; layout 1 is the
// 128-byte swizzle, 2 the 64-byte one.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t layout = 1) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading accumulators before wgmma_wait returns.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b^T for a 64x16 A tile and a 128x16 B tile, both K-major in
// shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b for a 64x16 A tile in registers (the m16n8k16 A fragment of
// each warp's 16 rows) and a 16x160 B tile read MN-major from shared memory
// (64-byte swizzle).
__device__ __forceinline__ void wgmma_m64n160k16_rs(float (&d)[80], const uint32_t (&a)[4],
                                                     uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float f) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(v.x * f, v.y * f);
}

// Rows and keys past the tensors' ends read as zeros (TMA); rows past Nq
// are computed and not stored, keys past Nk get -inf.
__global__ void __launch_bounds__(kScoreThreads, 1)
score_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_p, const float* __restrict__ bias,
             float* __restrict__ part_m, float* __restrict__ part_l, int Nk, int nq_pad,
             int depth_stages, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kScoreStages * kScoreStage;  // one 8-byte mbarrier a stage
  const uint32_t empty = full + 8 * kScoreStages;
  const int kt = blockIdx.x, q0 = blockIdx.y * kScoreRows, b = blockIdx.z, k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kScoreStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kScoreWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kScoreWarps) {  // producer
    if (lane == 0) {
      for (int i = 0; i < depth_stages; ++i) {
        const int s = i % kScoreStages;
        if (i >= kScoreStages) mbar_wait(empty + 8 * s, (i / kScoreStages - 1) & 1);
        const uint32_t dst = ring + s * kScoreStage;
        mbar_expect_tx(full + 8 * s, kScoreStage);
        tma_load(dst, &tm_q, full + 8 * s, i * kDepth, q0, b);
        tma_load(dst + kScoreRows / 64 * kBox, &tm_k, full + 8 * s, i * kDepth, k0, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, ww = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < depth_stages; ++i) {
    const int s = i % kScoreStages;
    mbar_wait(full + 8 * s, (i / kScoreStages) & 1);
    const uint32_t qa = ring + s * kScoreStage + wg * kBox;  // this warpgroup's 64 rows
    const uint32_t kb = ring + s * kScoreStage + kScoreRows / 64 * kBox;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kDepth / 16; ++j)
      wgmma_m64n128k16_ss(acc, wgmma_desc(qa + 32 * j, 16, 1024),
                          wgmma_desc(kb + 32 * j, 16, 1024), i > 0 || j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kScoreStages));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4 n + e]: row 16 ww + g (+8 for e >= 2), key 8 n + 2 t + (e & 1)
  const float* bb = bias ? bias + (size_t)b * Nk : nullptr;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * n + 2 * t + e;
      const float bk = key < Nk ? (bb ? __ldg(bb + key) * kLog2e : 0.f) : -INFINITY;
      acc[4 * n + e] = fmaf(acc[4 * n + e], scale_log2, bk);
      acc[4 * n + 2 + e] = fmaf(acc[4 * n + 2 + e], scale_log2, bk);
      m0 = fmaxf(m0, acc[4 * n + e]);
      m1 = fmaxf(m1, acc[4 * n + 2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      acc[4 * n + e] = exp2f(acc[4 * n + e] - m0);
      acc[4 * n + 2 + e] = exp2f(acc[4 * n + 2 + e] - m1);
      l0 += acc[4 * n + e];
      l1 += acc[4 * n + 2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row = 16 * ww + g;  // within the warpgroup's 64 rows
  if (t == 0) {
    const size_t at = ((size_t)b * gridDim.x + kt) * nq_pad + q0 + 64 * wg + row;
    part_m[at] = m0;
    part_l[at] = l0;
    part_m[at + 8] = m1;
    part_l[at + 8] = l1;
  }

  // P tile out: all warpgroups are done reading the ring, so each stages its
  // 64 rows as two swizzled [64][64] bf16 tiles there and stores them by TMA.
  named_barrier(1, kScoreWarps * 32);
  const uint32_t stage = ring + wg * 2 * kBox;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const uint32_t at = stage + (n >> 3) * kBox + swizzled(row, n & 7) + 4 * t;
    st_shared(at, pack_bf16(acc[4 * n], acc[4 * n + 1]));
    st_shared(at + 8 * 128, pack_bf16(acc[4 * n + 2], acc[4 * n + 3]));
  }
  fence_async_smem();
  named_barrier(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    tma_store(&tm_p, stage, k0, q0 + 64 * wg, b);
    tma_store(&tm_p, stage + kBox, k0 + 64, q0 + 64 * wg, b);
    tma_store_drain();
  }
}

__global__ void __launch_bounds__(kPvThreads, 1)
pv_kernel(const __grid_constant__ CUtensorMap tm_p, const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ part_m,
          const float* __restrict__ part_l, int k_tiles, int nq_pad) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kPvStages * kPvStage;
  const uint32_t empty = full + 8 * kPvStages;
  const int c0 = blockIdx.x * kCols, q0 = blockIdx.y * kTile, b = blockIdx.z;
  const int key_stages = k_tiles * (kTile / kDepth);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPvStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerWarps && lane == 0) {
      for (int i = 0; i < key_stages; ++i) {
        const int s = i % kPvStages;
        if (i >= kPvStages) mbar_wait(empty + 8 * s, (i / kPvStages - 1) & 1);
        const uint32_t dst = ring + s * kPvStage;
        mbar_expect_tx(full + 8 * s, kPvStage);
        tma_load(dst, &tm_p, full + 8 * s, i * kDepth, q0, b);
        tma_load(dst + kBox, &tm_p, full + 8 * s, i * kDepth, q0 + 64, b);
#pragma unroll
        for (int c = 0; c < kCols / kVBox; ++c)
          tma_load(dst + 2 * kBox + c * kVTile, &tm_v, full + 8 * s, c0 + kVBox * c, i * kDepth, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, ww = warp & 3, g = lane >> 2, t = lane & 3;
  const int row = 16 * ww + g;  // and row + 8, within the warpgroup's 64 rows
  const size_t r0 = (size_t)b * k_tiles * nq_pad + q0 + 64 * wg + row;
  // The row's softmax max and sum over all key tiles; lanes t = 0..3 share
  // the two rows and split the tiles between them.
  float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.f, 0.f};
  for (int k = t; k < k_tiles; k += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = r0 + (size_t)k * nq_pad + 8 * h;
      const float mt = part_m[at], mn = fmaxf(m[h], mt);
      l[h] = l[h] * exp2f(m[h] - mn) + part_l[at] * exp2f(mt - mn);
      m[h] = mn;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mn = fmaxf(m[h], mo);
      l[h] = l[h] * exp2f(m[h] - mn) + lo * exp2f(mo - mn);
      m[h] = mn;
    }
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  float acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  // ldmatrix.x4 lanes address rows lrow (+8 for lanes 8-15, 24-31), chunk + 1 for lanes 16-31
  const int lrow = 16 * ww + (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = lane >> 4;
  // Key stage i: load and scale its P fragments while stage i - 1's products
  // run, issue its products, then release stage i - 1 once they are done.
  auto step = [&](int i, uint32_t (&a)[kDepth / 16][4]) {
    const int s = i % kPvStages;
    const int k = i / (kTile / kDepth);  // the score tile these keys came from
    const float f0 = exp2f(part_m[r0 + (size_t)k * nq_pad] - m[0]) * inv_l[0];
    const float f1 = exp2f(part_m[r0 + (size_t)k * nq_pad + 8] - m[1]) * inv_l[1];
    mbar_wait(full + 8 * s, (i / kPvStages) & 1);
    const uint32_t pa = ring + s * kPvStage + wg * kBox;
    const uint32_t vb = ring + s * kPvStage + 2 * kBox;
#pragma unroll
    for (int j = 0; j < kDepth / 16; ++j) {
      ldmatrix_x4(a[j], pa + swizzled(lrow, 2 * j + lchunk));
      a[j][0] = scale_bf16x2(a[j][0], f0);  // row g
      a[j][1] = scale_bf16x2(a[j][1], f1);  // row g + 8
      a[j][2] = scale_bf16x2(a[j][2], f0);
      a[j][3] = scale_bf16x2(a[j][3], f1);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kDepth / 16; ++j)  // 16 keys = 16 rows of 64 bytes of each V tile
      wgmma_m64n160k16_rs(acc, a[j], wgmma_desc(vb + 16 * 64 * j, kVTile, 512, 2),
                          i > 0 || j > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kPvStages));
    }
  };
  // two sets of fragments, alternating (key_stages is even: two per score tile)
  uint32_t a0[kDepth / 16][4], a1[kDepth / 16][4];
  for (int i = 0; i < key_stages; i += 2) {
    step(i, a0);
    step(i + 1, a1);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Output tile: acc[4 n + e] is row (+8 for e >= 2), column 8 n + 2 t + (e & 1);
  // it goes out as [64 rows][32 columns] tiles with the 64-byte swizzle.
  named_barrier(1, kConsumerWarps * 32);
  constexpr int kOutBoxes = kCols / kOutBox;
  const uint32_t stage = ring + wg * kOutBoxes * kOutStage;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    const uint32_t at = stage + (n / (kOutBox / 8)) * kOutStage +
                        swizzled64(row, n % (kOutBox / 8)) + 4 * t;
    st_shared(at, pack_bf16(acc[4 * n], acc[4 * n + 1]));
    st_shared(at + 8 * 64, pack_bf16(acc[4 * n + 2], acc[4 * n + 3]));
  }
  fence_async_smem();
  named_barrier(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < kOutBoxes; ++c)
      tma_store(&tm_o, stage + c * kOutStage, c0 + kOutBox * c, q0 + 64 * wg, b);
    tma_store_drain();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [n2][n1][n0] bf16 tensor read or written in [box1][box0] tiles with the
// given swizzle; out-of-range elements load as zeros. 0 or a CUresult.
int make_map(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1, uint64_t n2,
             uint32_t box0, uint32_t box1,
             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                void* p, float* part_m, float* part_l, int B, int Nq, int Nk, int D, float scale,
                int device, cudaStream_t st) {
  if (B <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D % 8 != 0 || B > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(p)) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (Nq + kTile - 1) / kTile, k_tiles = (Nk + kTile - 1) / kTile;
  const int score_q_tiles = (Nq + kScoreRows - 1) / kScoreRows;
  const int nq_pad = score_q_tiles * kScoreRows, nk_pad = k_tiles * kTile;
  CUtensorMap tm_q, tm_k, tm_v, tm_p, tm_o;
  int res;
  if ((res = make_map(&tm_q, q, D, Nq, B, kDepth, kScoreRows)) ||
      (res = make_map(&tm_k, k, D, Nk, B, kDepth, kTile)) ||
      (res = make_map(&tm_v, v, D, Nk, B, kVBox, kDepth, CU_TENSOR_MAP_SWIZZLE_64B)) ||
      (res = make_map(&tm_p, p, nk_pad, Nq, B, kDepth, 64)) ||
      (res = make_map(&tm_o, out, D, Nq, B, kOutBox, 64, CU_TENSOR_MAP_SWIZZLE_64B)))
    return kTensorMapError + res;

  // once per device and process (a race only sets them twice)
  static bool attributes_set[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!attributes_set[device]) {
    err = cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kScoreSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kPvSmem);
    if (err != cudaSuccess) return (int)err;
    attributes_set[device] = true;
  }
  const float scale_log2 = scale * kLog2e;
  score_kernel<<<dim3(k_tiles, score_q_tiles, B), kScoreThreads, kScoreSmem, st>>>(
      tm_q, tm_k, tm_p, bias, part_m, part_l, Nk, nq_pad, (D + kDepth - 1) / kDepth, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  pv_kernel<<<dim3((D + kCols - 1) / kCols, q_tiles, B), kPvThreads, kPvSmem, st>>>(
      tm_p, tm_v, tm_o, part_m, part_l, k_tiles, nq_pad);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 route: stats_kernel + output_kernel (plain FMAs, unchanged design)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: tx walks keys / columns, ty rows
constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per tile (== kRows: shared staging code)
constexpr int kF32Depth = 32;  // depth chunk of q.k staged in shared memory
constexpr int kF32Cols = 256;   // output columns of D per block (output pass)
constexpr int kPad = kRows + 1;  // row stride of transposed tiles: no bank conflicts
constexpr int kColsPerThread = kF32Cols / 16;
constexpr int kStage = kF32Depth * kPad;
static_assert(kRows == kKeys, "score_tile stages q and k rows with one index");
static_assert((kRows * kF32Depth) % kThreads == 0, "staging loop");
static_assert((kKeys * kF32Cols) % kThreads == 0, "staging loop");

// s[i][j] = q[q0 + ty + 16 i] . k[k0 + tx + 16 j] over the whole depth D
// (unscaled, zero for rows or keys out of range). q, k point at batch b.
__device__ __forceinline__ void score_tile(const float* __restrict__ q, const float* __restrict__ k,
                                           int Nq, int Nk, int D, int q0, int k0,
                                           float* __restrict__ qs, float* __restrict__ ks,
                                           float s[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kF32Depth) {
#pragma unroll
    for (int it = 0; it < kRows * kF32Depth / kThreads; ++it) {
      const int e = it * kThreads + tid;
      const int r = e / kF32Depth, c = e % kF32Depth, d = d0 + c;
      const int qr = q0 + r, kr = k0 + r;
      qs[c * kPad + r] = (qr < Nq && d < D) ? q[(size_t)qr * D + d] : 0.f;
      ks[c * kPad + r] = (kr < Nk && d < D) ? k[(size_t)kr * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kF32Depth; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[c * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();
  }
}

// Scales the score tile and adds the key bias; keys past Nk become -inf.
__device__ __forceinline__ void bias_tile(const float* __restrict__ bias, int Nk, int k0,
                                          float scale, float s[4][4]) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tx + 16 * j;
    const float bj = key < Nk ? (bias ? bias[key] : 0.f) : -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][j] = fmaf(s[i][j], scale, bj);
  }
}

// Reductions over the 16 threads (tx) that share a row: lanes 0-15 and
// 16-31 of a warp are two rows, and xor offsets below 16 stay inside each.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ bias,
             float* __restrict__ row_max, float* __restrict__ row_sum,
             int Nq, int Nk, int D, int split_keys, float scale) {
  __shared__ float qs[kStage];
  __shared__ float ks[kStage];
  const int b = blockIdx.z, split = blockIdx.y, q0 = blockIdx.x * kRows;
  const int B = gridDim.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  q += (size_t)b * Nq * D;
  k += (size_t)b * Nk * D;
  if (bias) bias += (size_t)b * Nk;
  const int k_end = min(Nk, (split + 1) * split_keys);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -1e30f; l[i] = 0.f; }
  for (int k0 = split * split_keys; k0 < k_end; k0 += kKeys) {
    float s[4][4];
    score_tile(q, k, Nq, Nk, D, q0, k0, qs, ks, s);
    bias_tile(bias, Nk, k0, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max16(t));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(e);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < Nq) {
        row_max[((size_t)split * B + b) * Nq + row] = m[i];
        row_sum[((size_t)split * B + b) * Nq + row] = l[i];
      }
    }
  }
}

// The thread's rows' softmax max and 1 / sum, merged over the key splits.
__device__ __forceinline__ void merge_stats(const float* __restrict__ row_max,
                                            const float* __restrict__ row_sum, int splits,
                                            int Nq, int q0, float m[4], float inv_l[4]) {
  const int b = blockIdx.z, B = gridDim.z, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m[i] = 0.f;
    inv_l[i] = 0.f;
    if (row >= Nq) continue;
    float mx = -1e30f, l = 0.f;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, row_max[((size_t)sp * B + b) * Nq + row]);
    for (int sp = 0; sp < splits; ++sp) {
      const size_t at = ((size_t)sp * B + b) * Nq + row;
      l += row_sum[at] * expf(row_max[at] - mx);
    }
    m[i] = mx;
    inv_l[i] = 1.f / l;
  }
}

constexpr size_t kOutputSmemBytes = sizeof(float) * (2 * kStage + kKeys * kPad + kKeys * kF32Cols);

// One block per (256-column slice of D, 64-query tile, b): recomputes each
// score tile, forms p = exp(s - m) / l and accumulates p v with FMAs.
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ row_max, const float* __restrict__ row_sum,
              float* __restrict__ out, int Nq, int Nk, int D, int splits, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kF32Depth][kPad]  q chunk, transposed
  float* ks = qs + kStage;          // [kF32Depth][kPad]  k chunk, transposed
  float* ps = ks + kStage;          // [kKeys][kPad]      final weights, transposed
  float* vs = ps + kKeys * kPad;    // [kKeys][kF32Cols]     V tile, one column slice
  const int b = blockIdx.z, q0 = blockIdx.y * kRows, c0 = blockIdx.x * kF32Cols;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  q += (size_t)b * Nq * D;
  k += (size_t)b * Nk * D;
  v += (size_t)b * Nk * D;
  out += (size_t)b * Nq * D;
  if (bias) bias += (size_t)b * Nk;

  float m[4], inv_l[4];
  merge_stats(row_max, row_sum, splits, Nq, q0, m, inv_l);
  float acc[4][kColsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kKeys) {
    float s[4][4];
    score_tile(q, k, Nq, Nk, D, q0, k0, qs, ks, s);  // ends with a barrier
    bias_tile(bias, Nk, k0, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(tx + 16 * j) * kPad + ty + 16 * i] = expf(s[i][j] - m[i]) * inv_l[i];
#pragma unroll 4
    for (int it = 0; it < kKeys * kF32Cols / kThreads; ++it) {
      const int e = it * kThreads + tid;
      const int r = e / kF32Cols, c = e % kF32Cols;
      const int key = k0 + r, col = c0 + c;
      vs[r * kF32Cols + c] = (key < Nk && col < D) ? v[(size_t)key * D + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[kk * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float x = vs[kk * kF32Cols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Nq) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < D) out[(size_t)row * D + col] = acc[i][j];
    }
  }
}

int launch_f32(const float* q, const float* k, const float* v, const float* bias, float* out,
               float* row_max, float* row_sum, int B, int Nq, int Nk, int D, int splits,
               float scale, int device, cudaStream_t st) {
  const int k_tiles = (Nk + kKeys - 1) / kKeys;
  if (B <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || B > 65535 || splits <= 0 || splits > k_tiles ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (Nq + kRows - 1) / kRows;
  const int split_keys = (k_tiles + splits - 1) / splits * kKeys;
  stats_kernel<<<dim3(q_tiles, splits, B), kThreads, 0, st>>>(q, k, bias, row_max, row_sum, Nq,
                                                              Nk, D, split_keys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kOutputSmemBytes);
  if (err != cudaSuccess) return (int)err;
  output_kernel<<<dim3((D + kF32Cols - 1) / kF32Cols, q_tiles, B), kThreads, kOutputSmemBytes, st>>>(
      q, k, v, bias, row_max, row_sum, out, Nq, Nk, D, splits, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Tiles of the bf16 route's scratch: the caller sizes P as
// [B, Nq, ceil(Nk / keys) * keys] bf16 and the partials as
// [2, B, ceil(Nk / keys), ceil(Nq / rows) * rows] fp32.
extern "C" void token_attention_tiles(int* rows, int* keys) {
  *rows = kScoreRows;
  *keys = kTile;
}

// Number of key splits of the fp32 stats pass: enough (b, split, query tile)
// blocks for two per SM, at most one split per 64-key tile. The caller sizes
// row_max and row_sum as [splits, B, Nq]. Negative: -cudaError_t.
extern "C" int token_attention_splits(int B, int Nq, int Nk, int device) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  const long blocks = (long)((Nq + kRows - 1) / kRows) * B;
  const int k_tiles = (Nk + kKeys - 1) / kKeys;
  const long want = (2L * sms + blocks - 1) / blocks;
  const int splits = (int)(want < 1 ? 1 : (want > k_tiles ? k_tiles : want));
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  return (k_tiles + tiles_per_split - 1) / tiles_per_split;  // no empty split
}

extern "C" int token_attention_f32(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, void* row_max, void* row_sum, int B, int Nq, int Nk,
                                   int D, int splits, float scale, int device, void* stream) {
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const float*>(bias),
                    static_cast<float*>(out), static_cast<float*>(row_max),
                    static_cast<float*>(row_sum), B, Nq, Nk, D, splits, scale, device,
                    static_cast<cudaStream_t>(stream));
}

// q, k, v, out and p 16-byte aligned and D % 8 == 0 (TMA); p and the
// partials sized as token_attention_tile says.
extern "C" int token_attention_bf16(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, void* p, void* part_m, void* part_l, int B, int Nq,
                                    int Nk, int D, float scale, int device, void* stream) {
  return launch_bf16(q, k, v, static_cast<const float*>(bias), out, p,
                     static_cast<float*>(part_m), static_cast<float*>(part_l), B, Nq, Nk, D,
                     scale, device, static_cast<cudaStream_t>(stream));
}
