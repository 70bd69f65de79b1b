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
// the next batch's; they need D % 8 == 0 (bf16) or D % 4 == 0 (fp32) and
// 16-byte aligned bases (the wrapper copies other inputs into an aligned,
// zero-padded buffer).
//
// fp32 inputs (compute_dtype="float32", and every fp32 check) take the same
// two-kernel split with fp32-accurate products on the tensor cores, 3xTF32:
// each operand x is split as hi = tf32(x), lo = tf32(x - hi), both rounded
// to nearest, and a product is lo hi + hi lo + hi hi in fp32 accumulators,
// which leaves out only lo lo (2^-22 of the product). TF32 runs at half the
// bf16 rate and every product is three, so the bound is 3 x 4 N^2 D over
// 495 TFLOP/s, six times the bf16 route's: 0.61 ms at (5,3), 0.18 ms at
// (10,5). The route is arithmetic-bound even more than bf16, and its design
// is about keeping the tensor cores fed:
//
//  0. split_kernel writes k's hi and lo parts, and those of v^T ([B, D,
//     Nk_pad], keys contiguous), once per call: wgmma takes a tf32 B operand
//     K-major only (its transpose flag is for 16-bit types), so p v reads
//     v^T. That is 24 N D bytes, a few percent of the call.
//  1. score_f32_kernel, one block per (128-key tile, 128-query tile, b):
//     streams raw Q and K's splits in 32-deep slices of D (one 128-byte
//     swizzled row of fp32) through a 4-stage TMA ring; each warpgroup loads
//     its Q fragments with ldmatrix, splits them in registers (A from
//     registers) and runs three m64n128k8 tf32 wgmmas a k8 step. The
//     epilogue is the bf16 route's, with p stored in fp32.
//  2. pv_f32_kernel, one block per (160 columns of D, 128-query tile, b):
//     merges the partials, streams 32-key stages of P and of v^T's splits,
//     splits each raw P fragment in registers and runs three m64n160k8 tf32
//     wgmmas a k8 step; the fp32 output goes out by TMA.
// The tensor cores sum their products into the fp32 accumulators with
// truncation, not rounding, so over the 360-1200 k8 steps of a call's sums
// the error builds up one way, to ~1e-4 of the scores: one accumulator for
// a whole sum misses the 2e-5 fp32 limit on the card at D = 3200
// (scripts/tf32_sum_model.py models it). So each 32-deep stage (12 wgmmas)
// starts a fresh accumulator, and its sum is added to the total in
// registers with rounded fp32 adds (in p v scaled there by the key tile's
// 2^(m_t - m) / l). Within a stage two sets of split fragments
// alternate, so k8 step j + 1 is split while step j's products run; the
// other warpgroup's products fill the tensor cores while one adds. 128-row
// tiles (two consumer warpgroups; in p v a producer warpgroup hands them
// its registers, setmaxnreg, as the bf16 p v kernel does) leave room for
// the two sets of 64 or 80 accumulators without spills, and bring
// operands at ~32 bytes per tensor-core clock of an SM, half what the bf16
// route's tiles need. P is 4 Nq Nk_pad bytes, written once and read once
// per column tile, mostly from L2.
//
// Plain C entry points (bound with ctypes), each returning 0 or a
// cudaError_t (tensor-map failures: kTensorMapError + CUresult):
// token_attention_tiles, token_attention_f32, token_attention_bf16.

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

// A [n2][n1][n0] bf16 (or fp32) tensor read or written in [box1][box0] tiles
// with the given swizzle; out-of-range elements load as zeros. 0 or a
// CUresult.
int make_map(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1, uint64_t n2,
             uint32_t box0, uint32_t box1,
             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
             CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const uint64_t elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * elem_bytes, n0 * n1 * elem_bytes};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Makes `device` current for one launch and gives the calling thread its own
// current device back on every return path: a launch for a tensor on another
// card must not move where the caller's later allocations land.
struct DeviceScope {
  int previous = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&previous);
    if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                void* p, float* part_m, float* part_l, int B, int Nq, int Nk, int D, float scale,
                int device, cudaStream_t st) {
  if (B <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D % 8 != 0 || B > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(p)) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
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
// fp32 route: split_kernel + score_f32_kernel + pv_f32_kernel (3xTF32, wgmma)
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 128;    // query rows per score and p v block: two warpgroups of 64
constexpr int kF32Depth = 32;    // one ring stage: 32 fp32 (128 bytes) of D (score) or of keys (p v)
constexpr int kF32Warps = 8;     // consumer warps, both kernels
constexpr int kF32Threads = kF32Warps * 32 + 32;  // score: + one producer warp
// p v: a whole producer warpgroup (one warp of it works), so that its
// registers can go to the consumers' two sets of accumulators (setmaxnreg)
constexpr int kF32PvThreads = kF32Warps * 32 + 128;
constexpr int kF32Stages = 4;
constexpr int kSplitTile = 32;   // split_kernel: one [32 keys][32 columns] tile a block
constexpr uint32_t kF32Box = 64 * 128;       // bytes of one [64 rows][32 fp32] swizzled tile
constexpr uint32_t kF32VTile = kCols * 128;  // one [160 columns][32 keys] tile of v^T
// Q [128][32] (raw fp32), K hi and K lo [128][32]
constexpr uint32_t kF32ScoreStage = 3 * 2 * kF32Box;
// P [128][32] (raw fp32), v^T hi and v^T lo [160][32]
constexpr uint32_t kF32PvStage = 2 * kF32Box + 2 * kF32VTile;
constexpr size_t kF32ScoreSmem = 1024 + kF32Stages * kF32ScoreStage + 16 * kF32Stages;
constexpr size_t kF32PvSmem = 1024 + kF32Stages * kF32PvStage + 16 * kF32Stages;
constexpr int kF32Steps = kF32Depth / 8;  // k8 steps of wgmma a stage
static_assert(kF32PvSmem <= 232448, "p v ring fits in a block's shared memory");
static_assert(2 * (kTile / kF32Depth) * kF32Box <= kF32Stages * kF32ScoreStage,
              "P staging fits in the score ring");
static_assert(2 * (kCols / kF32Depth) * kF32Box <= kF32Stages * kF32PvStage,
              "output staging fits in the p v ring");
static_assert(kF32VTile % 1024 == 0 && kF32PvStage % 1024 == 0,
              "p v tiles keep the 128-byte swizzle's alignment");
static_assert(kCols % kF32Depth == 0 && kTile % kF32Depth == 0, "fp32 tiling");

// tf32 of x, rounded to nearest (ties away from zero) on its 13 low mantissa
// bits. wgmma reads the top 19 bits of a tf32 operand and drops the rest, so
// the splits below round here rather than let it truncate.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ |x| 2^-22 at most): two tf32 values; x - hi is exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// d (+)= a b^T for a 64x8 tf32 A tile in registers (the m16n8k8 A fragment
// of each warp's 16 rows) and a 128x8 tf32 B tile, K-major in shared memory
// (128-byte swizzle). tf32 takes no transpose flag: B is K-major only.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same with a 160x8 B tile.
__device__ __forceinline__ void wgmma_m64n160k8_tf32(float (&d)[80], const uint32_t (&a)[4],
                                                     uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  if constexpr (N == 64)
    wgmma_m64n128k8_tf32(d, a, b, accumulate);
  else
    wgmma_m64n160k8_tf32(d, a, b, accumulate);
}

// One ring stage's products, from zero into d: for each k8 step, the A
// fragments of this warp's 16 rows of a [64 rows][32 fp32] swizzled tile are
// split in registers and lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) issued
// against the stage's B splits (K-major, 128-byte swizzle). ldmatrix moves
// each fp32 as two b16 halves, so its x4 form hands out the tf32 m16n8k8
// fragment: r[0] (g, k), r[1] (g + 8, k), r[2] (g, k + 4), r[3] (g + 8, k + 4).
// Two sets of fragments alternate, so step j + 1 is split while step j's
// products run. Returns with every product done.
template <int N>
__device__ __forceinline__ void stage_products(float (&d)[N], uint32_t a_tile, uint32_t b_hi,
                                               uint32_t b_lo, int lrow, int lchunk) {
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int j = 0; j < kF32Steps; ++j) {
    if (j >= 2) wgmma_wait<1>();  // step j - 2 is done: its fragments are free
    uint32_t r[4];
    ldmatrix_x4(r, a_tile + swizzled(lrow, 2 * j + lchunk));
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), hi[j & 1][e], lo[j & 1][e]);
    wgmma_fence();
    wgmma_tf32(d, lo[j & 1], wgmma_desc(b_hi + 32 * j, 16, 1024), j > 0);
    wgmma_tf32(d, hi[j & 1], wgmma_desc(b_lo + 32 * j, 16, 1024), 1);
    wgmma_tf32(d, hi[j & 1], wgmma_desc(b_hi + 32 * j, 16, 1024), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(d);
}

// k -> its tf32 hi and lo parts, [B, Nk, D] each; v -> those of v^T,
// [B, D, nk_pad] each, zero for keys past Nk. One block per [32 keys][32
// columns] tile; the transpose goes through shared memory.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ k_hi,
             float* __restrict__ k_lo, float* __restrict__ vt_hi, float* __restrict__ vt_lo,
             int Nk, int D, int nk_pad) {
  __shared__ float tile[kSplitTile][kSplitTile + 1];
  const int key0 = blockIdx.x * kSplitTile, d0 = blockIdx.y * kSplitTile, b = blockIdx.z;
  const int tx = threadIdx.x % kSplitTile, ty = threadIdx.x / kSplitTile;
  constexpr int kRowStep = 256 / kSplitTile;
  uint32_t hi, lo;
  for (int r = ty; r < kSplitTile; r += kRowStep) {
    const int key = key0 + r, d = d0 + tx;
    float x = 0.f;
    if (key < Nk && d < D) {
      const size_t at = ((size_t)b * Nk + key) * D + d;
      split_tf32(k[at], hi, lo);
      k_hi[at] = __uint_as_float(hi);
      k_lo[at] = __uint_as_float(lo);
      x = v[at];
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  for (int r = ty; r < kSplitTile; r += kRowStep) {
    const int d = d0 + r;
    if (d >= D) continue;
    const size_t at = ((size_t)b * D + d) * nk_pad + key0 + tx;
    split_tf32(tile[tx][r], hi, lo);
    vt_hi[at] = __uint_as_float(hi);
    vt_lo[at] = __uint_as_float(lo);
  }
}

// One block per (128-key tile, 128-query tile, b). Q arrives raw and is
// split in registers; K's splits come from split_kernel. Each 32-deep stage
// is summed on the tensor cores and added to the fp32 total in registers.
// Rows and keys past the tensors' ends read as zeros (TMA); rows past Nq
// are computed and not stored, keys past Nk get -inf.
__global__ void __launch_bounds__(kF32Threads, 1)
score_f32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_khi,
                 const __grid_constant__ CUtensorMap tm_klo, const __grid_constant__ CUtensorMap tm_p,
                 const float* __restrict__ bias, float* __restrict__ part_m,
                 float* __restrict__ part_l, int Nk, int nq_pad, int depth_stages,
                 float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kF32Stages * kF32ScoreStage;  // one 8-byte mbarrier a stage
  const uint32_t empty = full + 8 * kF32Stages;
  const int kt = blockIdx.x, q0 = blockIdx.y * kF32Rows, b = blockIdx.z, k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kF32Warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kF32Warps) {  // producer
    if (lane == 0) {
      for (int i = 0; i < depth_stages; ++i) {
        const int s = i % kF32Stages;
        if (i >= kF32Stages) mbar_wait(empty + 8 * s, (i / kF32Stages - 1) & 1);
        const uint32_t dst = ring + s * kF32ScoreStage;
        mbar_expect_tx(full + 8 * s, kF32ScoreStage);
        tma_load(dst, &tm_q, full + 8 * s, i * kF32Depth, q0, b);
        tma_load(dst + 2 * kF32Box, &tm_khi, full + 8 * s, i * kF32Depth, k0, b);
        tma_load(dst + 4 * kF32Box, &tm_klo, full + 8 * s, i * kF32Depth, k0, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, ww = warp & 3, g = lane >> 2, t = lane & 3;
  const int lrow = 16 * ww + (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = lane >> 4;
  // acc: the fp32 sum over depth stages, by rounded adds; part: one stage's
  // products, summed by the tensor cores, which truncate (see the header)
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < depth_stages; ++i) {
    const int s = i % kF32Stages;
    mbar_wait(full + 8 * s, (i / kF32Stages) & 1);
    const uint32_t at = ring + s * kF32ScoreStage;
    stage_products(part, at + wg * kF32Box, at + 2 * kF32Box, at + 4 * kF32Box, lrow, lchunk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] += part[r];
  }

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

  // P tile out in fp32: all warpgroups are done reading the ring, so each
  // stages its 64 rows as four swizzled [64][32] tiles there and stores
  // them by TMA. Key 8 n + 2 t sits in tile n / 4, chunk 2 (n % 4) + t / 2.
  named_barrier(1, kF32Warps * 32);
  const uint32_t stage = ring + wg * (kTile / kF32Depth) * kF32Box;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const uint32_t at = stage + (n >> 2) * kF32Box + swizzled(row, 2 * (n & 3) + (t >> 1)) +
                        8 * (t & 1);
    st_shared_v2(at, acc[4 * n], acc[4 * n + 1]);
    st_shared_v2(at + 8 * 128, acc[4 * n + 2], acc[4 * n + 3]);
  }
  fence_async_smem();
  named_barrier(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < kTile / kF32Depth; ++c)
      tma_store(&tm_p, stage + c * kF32Box, k0 + kF32Depth * c, q0 + 64 * wg, b);
    tma_store_drain();
  }
}

// One block per (160 columns of D, 128-query tile, b): merges the row's
// partials, streams 32-key stages of P and of v^T's splits by TMA, runs
// each stage's 3xTF32 products from raw p, and adds them to the fp32 total
// scaled by 2^(m_t - m) / l of the stage's key tile.
__global__ void __launch_bounds__(kF32PvThreads, 1)
pv_f32_kernel(const __grid_constant__ CUtensorMap tm_p, const __grid_constant__ CUtensorMap tm_vhi,
              const __grid_constant__ CUtensorMap tm_vlo, const __grid_constant__ CUtensorMap tm_o,
              const float* __restrict__ part_m, const float* __restrict__ part_l, int k_tiles,
              int nq_pad) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kF32Stages * kF32PvStage;
  const uint32_t empty = full + 8 * kF32Stages;
  const int c0 = blockIdx.x * kCols, q0 = blockIdx.y * kF32Rows, b = blockIdx.z;
  constexpr int kStagesPerTile = kTile / kF32Depth;
  const int key_stages = k_tiles * kStagesPerTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kF32Warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kF32Warps) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kF32Warps && lane == 0) {
      for (int i = 0; i < key_stages; ++i) {
        const int s = i % kF32Stages;
        if (i >= kF32Stages) mbar_wait(empty + 8 * s, (i / kF32Stages - 1) & 1);
        const uint32_t dst = ring + s * kF32PvStage;
        mbar_expect_tx(full + 8 * s, kF32PvStage);
        tma_load(dst, &tm_p, full + 8 * s, i * kF32Depth, q0, b);
        tma_load(dst + kF32Box, &tm_p, full + 8 * s, i * kF32Depth, q0 + 64, b);
        tma_load(dst + 2 * kF32Box, &tm_vhi, full + 8 * s, i * kF32Depth, c0, b);
        tma_load(dst + 2 * kF32Box + kF32VTile, &tm_vlo, full + 8 * s, i * kF32Depth, c0, b);
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
  float mx[2] = {-3.0e38f, -3.0e38f}, sum[2] = {0.f, 0.f};
  for (int tile = t; tile < k_tiles; tile += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = r0 + (size_t)tile * nq_pad + 8 * h;
      const float mt = part_m[at], mn = fmaxf(mx[h], mt);
      sum[h] = sum[h] * exp2f(mx[h] - mn) + part_l[at] * exp2f(mt - mn);
      mx[h] = mn;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, mx[h], off);
      const float so = __shfl_xor_sync(0xffffffffu, sum[h], off);
      const float mn = fmaxf(mx[h], mo);
      sum[h] = sum[h] * exp2f(mx[h] - mn) + so * exp2f(mo - mn);
      mx[h] = mn;
    }
  }
  const float inv_sum[2] = {1.f / sum[0], 1.f / sum[1]};

  // acc: the fp32 sum over key stages, each stage's products (part, summed
  // by the tensor cores from raw p) scaled by 2^(m_t - m) / l of its key tile
  float acc[kCols / 2], part[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  const int lrow = 16 * ww + (lane & 7) + 8 * ((lane >> 3) & 1), lchunk = lane >> 4;
  for (int i = 0; i < key_stages; ++i) {
    const int s = i % kF32Stages;
    const size_t tile_at = r0 + (size_t)(i / kStagesPerTile) * nq_pad;
    const float f0 = exp2f(part_m[tile_at] - mx[0]) * inv_sum[0];
    const float f1 = exp2f(part_m[tile_at + 8] - mx[1]) * inv_sum[1];
    mbar_wait(full + 8 * s, (i / kF32Stages) & 1);
    const uint32_t at = ring + s * kF32PvStage;
    stage_products(part, at + wg * kF32Box, at + 2 * kF32Box, at + 2 * kF32Box + kF32VTile,
                   lrow, lchunk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      acc[4 * n] = fmaf(part[4 * n], f0, acc[4 * n]);
      acc[4 * n + 1] = fmaf(part[4 * n + 1], f0, acc[4 * n + 1]);
      acc[4 * n + 2] = fmaf(part[4 * n + 2], f1, acc[4 * n + 2]);
      acc[4 * n + 3] = fmaf(part[4 * n + 3], f1, acc[4 * n + 3]);
    }
  }

  // Output tile: acc[4 n + e] is row (+8 for e >= 2), column 8 n + 2 t + (e & 1);
  // it goes out as five [64 rows][32 columns] fp32 tiles, 128-byte swizzle.
  named_barrier(1, kF32Warps * 32);
  constexpr int kOutTiles = kCols / kF32Depth;
  const uint32_t stage = ring + wg * kOutTiles * kF32Box;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    const uint32_t at = stage + (n >> 2) * kF32Box + swizzled(row, 2 * (n & 3) + (t >> 1)) +
                        8 * (t & 1);
    st_shared_v2(at, acc[4 * n], acc[4 * n + 1]);
    st_shared_v2(at + 8 * 128, acc[4 * n + 2], acc[4 * n + 3]);
  }
  fence_async_smem();
  named_barrier(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < kOutTiles; ++c)
      tma_store(&tm_o, stage + c * kF32Box, c0 + kF32Depth * c, q0 + 64 * wg, b);
    tma_store_drain();
  }
}

int launch_f32(const float* q, const float* k, const float* v, const float* bias, float* out,
               float* p, float* part_m, float* part_l, float* k_split, float* vt_split, int B,
               int Nq, int Nk, int D, float scale, int device, cudaStream_t st) {
  if (B <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D % 4 != 0 || B > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(k_split) |
        reinterpret_cast<uintptr_t>(vt_split)) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (Nq + kF32Rows - 1) / kF32Rows, k_tiles = (Nk + kTile - 1) / kTile;
  const int nq_pad = q_tiles * kF32Rows, nk_pad = k_tiles * kTile;
  float* k_hi = k_split;
  float* k_lo = k_split + (size_t)B * Nk * D;
  float* vt_hi = vt_split;
  float* vt_lo = vt_split + (size_t)B * D * nk_pad;
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm_q, tm_khi, tm_klo, tm_p, tm_vhi, tm_vlo, tm_o;
  int res;
  if ((res = make_map(&tm_q, q, D, Nq, B, kF32Depth, kF32Rows, sw, f32)) ||
      (res = make_map(&tm_khi, k_hi, D, Nk, B, kF32Depth, kTile, sw, f32)) ||
      (res = make_map(&tm_klo, k_lo, D, Nk, B, kF32Depth, kTile, sw, f32)) ||
      (res = make_map(&tm_p, p, nk_pad, Nq, B, kF32Depth, 64, sw, f32)) ||
      (res = make_map(&tm_vhi, vt_hi, nk_pad, D, B, kF32Depth, kCols, sw, f32)) ||
      (res = make_map(&tm_vlo, vt_lo, nk_pad, D, B, kF32Depth, kCols, sw, f32)) ||
      (res = make_map(&tm_o, out, D, Nq, B, kF32Depth, 64, sw, f32)))
    return kTensorMapError + res;

  // once per device and process (a race only sets them twice)
  static bool attributes_set[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!attributes_set[device]) {
    err = cudaFuncSetAttribute(score_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kF32ScoreSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kF32PvSmem);
    if (err != cudaSuccess) return (int)err;
    attributes_set[device] = true;
  }
  split_kernel<<<dim3(nk_pad / kSplitTile, (D + kSplitTile - 1) / kSplitTile, B), 256, 0, st>>>(
      k, v, k_hi, k_lo, vt_hi, vt_lo, Nk, D, nk_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_f32_kernel<<<dim3(k_tiles, q_tiles, B), kF32Threads, kF32ScoreSmem, st>>>(
      tm_q, tm_khi, tm_klo, tm_p, bias, part_m, part_l, Nk, nq_pad,
      (D + kF32Depth - 1) / kF32Depth, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pv_f32_kernel<<<dim3((D + kCols - 1) / kCols, q_tiles, B), kF32PvThreads, kF32PvSmem, st>>>(
      tm_p, tm_vhi, tm_vlo, tm_o, part_m, part_l, k_tiles, nq_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// Tiles of a route's scratch (fp32 != 0: the fp32 route): the caller sizes
// P as [B, Nq, ceil(Nk / keys) * keys] (bf16 or fp32) and the partials as
// [2, B, ceil(Nk / keys), ceil(Nq / rows) * rows] fp32.
extern "C" void token_attention_tiles(int fp32, int* rows, int* keys) {
  *rows = fp32 ? kF32Rows : kScoreRows;
  *keys = kTile;
}

// q, k, v, out, p and the splits 16-byte aligned and D % 4 == 0 (TMA); p and
// the partials sized as token_attention_tiles says, k_split [2, B, Nk, D],
// vt_split [2, B, D, ceil(Nk / keys) * keys], all fp32.
extern "C" int token_attention_f32(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, void* p, void* part_m, void* part_l, void* k_split,
                                   void* vt_split, int B, int Nq, int Nk, int D, float scale,
                                   int device, void* stream) {
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const float*>(bias),
                    static_cast<float*>(out), static_cast<float*>(p),
                    static_cast<float*>(part_m), static_cast<float*>(part_l),
                    static_cast<float*>(k_split), static_cast<float*>(vt_split), B, Nq, Nk, D,
                    scale, device, static_cast<cudaStream_t>(stream));
}

// q, k, v, out and p 16-byte aligned and D % 8 == 0 (TMA); p and the
// partials sized as token_attention_tiles says.
extern "C" int token_attention_bf16(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, void* p, void* part_m, void* part_l, int B, int Nq,
                                    int Nk, int D, float scale, int device, void* stream) {
  return launch_bf16(q, k, v, static_cast<const float*>(bias), out, p,
                     static_cast<float*>(part_m), static_cast<float*>(part_l), B, Nq, Nk, D,
                     scale, device, static_cast<cudaStream_t>(stream));
}
