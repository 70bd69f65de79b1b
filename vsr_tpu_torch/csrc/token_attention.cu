// Token attention for Hopper (sm_90a): out = softmax(q k^T * scale + key_bias) v
// over pre-tokenized patch tokens q [B, Nq, D], k/v [B, Nk, D], bias [B, Nk].
//
// Replaces the Pallas TPU kernel vsr_tpu/ops/pallas_token_attention.py
// (flash_token_attention, body _flash_kernel). Same contract: scores, softmax
// statistics and the output accumulator are fp32 whatever the input type; the
// additive key bias is applied in fp32; the output is written in q's type.
// Keys past Nk and queries past Nq are masked here, so the caller pads
// nothing: a padded key gets -inf and so carries no weight, which keeps the
// Pallas kernel's all-keys-masked behaviour (a row whose real keys all carry
// the -1e9 bias spreads its weight over the real keys only).
//
// What bounds it on this card: the width. The STTN small-patch scales have
// D = 960 (N = 5120 at L = 16) and D = 3200 (N = 1536). A flash-attention
// block keeps an fp32 [q_rows, D] accumulator on chip; at D = 3200 that is
// 800 KB for 64 rows, far over the 227 KB of shared memory and the register
// file of one SM (the TPU kernel keeps it in VMEM, which has room).
//
// Design: two passes, neither of which writes the [N, N] scores to memory.
//  1. stats_kernel, one block per (b, key split, 64-query tile): streams the
//     split's 64-key tiles, staging q and k through shared memory in 32-wide
//     (fp32) or 64-wide (bf16) depth chunks, and keeps the online row max m
//     and row sum l of its keys ([splits, B, Nq] fp32 each). Keys are split
//     so that the few query tiles still fill the card (24 tiles at
//     N = 1536); the output kernels merge the splits' (m, l) when they start.
//  2. output kernel, one block per (b, 64-query tile, 256-column slice of D):
//     recomputes each score tile, forms p = exp(s - m) / l (final weights,
//     so no rescaling of the accumulator is needed), stages p and the
//     V[:, slice] tile in shared memory and accumulates p V into a
//     64 x 256 fp32 register tile (64 accumulators a thread).
// The price is q k^T computed 1 + ceil(D / 256) times (5x at D = 960, 14x at
// D = 3200), so the score tile carries most of the arithmetic.
// bf16 inputs run both products on the tensor cores (mma.sync m16n8k16, fp32
// accumulate) from bf16 tiles in shared memory, with p rounded to bf16 for
// the second product. fp32 inputs use plain fp32 FMAs throughout, which keep
// fp32 accuracy. wgmma, TMA pipelining and sharing p across a cluster
// instead of recomputing it are left for later work.
//
// Plain C entry points (bound with ctypes): token_attention_splits sizes the
// stats scratch; token_attention_f32 and token_attention_bf16 return the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx walks keys / columns, ty rows
constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per tile (== kRows: shared staging code)
constexpr int kDepth = 32;     // depth chunk of q.k staged in shared memory (fp32)
constexpr int kBfDepth = 64;   // the same for bf16
constexpr int kCols = 256;     // output columns of D per block (output pass)
constexpr int kPad = kRows + 1;  // row stride of transposed tiles: no bank conflicts
constexpr int kColsPerThread = kCols / 16;
constexpr int kBfStride = kBfDepth + 8;  // bf16 staged row: 144 bytes, conflict-free fragment loads
constexpr int kPStride = kKeys + 8;    // bf16 p tile row: 144 bytes
constexpr int kVStride = kCols + 8;    // bf16 V tile row: 528 bytes, conflict-free ldmatrix rows
static_assert(kRows == kKeys, "score_tile stages q and k rows with one index");
static_assert((kRows * kDepth) % kThreads == 0, "staging loop");
static_assert((kKeys * kCols) % kThreads == 0, "staging loop");
// floats in each of the q and k staging buffers (fp32 transposed or bf16 tile)
constexpr int kStage = kDepth * kPad > kRows * kBfStride / 2 ? kDepth * kPad : kRows * kBfStride / 2;
static_assert(kStage % 4 == 0, "16-byte aligned staging buffers");
static_assert(kRows * kBfDepth / 8 == 2 * kThreads, "two 16-byte vectors a thread per bf16 tile");

// s[i][j] = q[q0 + ty + 16 i] . k[k0 + tx + 16 j] over the whole depth D
// (unscaled, zero for rows or keys out of range). q, k point at batch b.
// fp32 inputs: plain FMAs from transposed fp32 tiles (ss and vec unused).
__device__ __forceinline__ void score_tile(const float* __restrict__ q, const float* __restrict__ k,
                                           int Nq, int Nk, int D, int q0, int k0,
                                           float* __restrict__ qs, float* __restrict__ ks,
                                           float* __restrict__ ss, bool vec, float s[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDepth) {
#pragma unroll
    for (int it = 0; it < kRows * kDepth / kThreads; ++it) {
      const int e = it * kThreads + tid;
      const int r = e / kDepth, c = e % kDepth, d = d0 + c;
      const int qr = q0 + r, kr = k0 + r;
      qs[c * kPad + r] = (qr < Nq && d < D) ? q[(size_t)qr * D + d] : 0.f;
      ks[c * kPad + r] = (kr < Nk && d < D) ? k[(size_t)kr * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDepth; ++c) {
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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for one 16x8 tile: a 16x16 row-major, b 16x8 column-major, bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// src[row][d .. d + 8) as one 16-byte vector, zero out of range (D % 8 == 0).
__device__ __forceinline__ uint4 load_vec(const __nv_bfloat16* __restrict__ src, int n_rows,
                                          int D, int row, int d) {
  if (row < n_rows && d < D) return *reinterpret_cast<const uint4*>(src + (size_t)row * D + d);
  return make_uint4(0u, 0u, 0u, 0u);
}

// dst[r][c] = src[r0 + r][d0 + c] for 64 rows x kBfDepth columns (zero out of
// range), row stride kBfStride, element by element (rows not 16-byte aligned).
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int n_rows,
                                           int D, int r0, int d0,
                                           __nv_bfloat16* __restrict__ dst) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < kRows * kBfDepth / kThreads; ++it) {
    const int e = it * kThreads + tid;
    const int r = e / kBfDepth, c = e % kBfDepth;
    dst[r * kBfStride + c] = (r0 + r < n_rows && d0 + c < D)
                                 ? src[(size_t)(r0 + r) * D + d0 + c]
                                 : __float2bfloat16(0.f);
  }
}

// bf16 inputs: the same score tile on the tensor cores. Warp w computes rows
// 16 (w % 4) .. +16 against keys 32 (w / 4) .. +32 (four m16n8k16 tiles per
// 16-deep step); the fragments then go through ss ([64][kPad] fp32) into the
// (ty + 16 i, tx + 16 j) layout of the fp32 path. ss may alias the caller's
// p tile: it is free again when this returns. vec (D % 8 == 0, 16-byte
// aligned rows): each thread stages two 16-byte vectors of q and two of k
// per 64-deep chunk (rows r and r + 32), loading the next chunk's while the
// tensor cores work on this one.
__device__ __forceinline__ void score_tile(const __nv_bfloat16* __restrict__ q,
                                           const __nv_bfloat16* __restrict__ k,
                                           int Nq, int Nk, int D, int q0, int k0,
                                           float* __restrict__ qs_raw, float* __restrict__ ks_raw,
                                           float* __restrict__ ss, bool vec, float s[4][4]) {
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(qs_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ks_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float c[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  const int vr = threadIdx.x / (kBfDepth / 8), vc = (threadIdx.x % (kBfDepth / 8)) * 8;
  constexpr int kHalf = kRows / 2;  // second vector's row offset
  uint4 nq[2], nk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    nq[h] = vec ? load_vec(q, Nq, D, q0 + vr + h * kHalf, vc) : make_uint4(0u, 0u, 0u, 0u);
    nk[h] = vec ? load_vec(k, Nk, D, k0 + vr + h * kHalf, vc) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int d0 = 0; d0 < D; d0 += kBfDepth) {
    if (vec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<uint4*>(qs + (vr + h * kHalf) * kBfStride + vc) = nq[h];
        *reinterpret_cast<uint4*>(ks + (vr + h * kHalf) * kBfStride + vc) = nk[h];
      }
    } else {
      stage_bf16(q, Nq, D, q0, d0, qs);
      stage_bf16(k, Nk, D, k0, d0, ks);
    }
    __syncthreads();
    if (vec && d0 + kBfDepth < D) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        nq[h] = load_vec(q, Nq, D, q0 + vr + h * kHalf, d0 + kBfDepth + vc);
        nk[h] = load_vec(k, Nk, D, k0 + vr + h * kHalf, d0 + kBfDepth + vc);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBfDepth; kk += 16) {
      const __nv_bfloat16* qa = qs + (m0 + g) * kBfStride + kk + 2 * t;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * kBfStride), ld_pair(qa + 8),
                             ld_pair(qa + 8 * kBfStride + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* kb = ks + (n0 + 8 * nt + g) * kBfStride + kk + 2 * t;
        const uint32_t b[2] = {ld_pair(kb), ld_pair(kb + 8)};
        mma_bf16(c[nt], a, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    ss[(m0 + g) * kPad + col] = c[nt][0];
    ss[(m0 + g) * kPad + col + 1] = c[nt][1];
    ss[(m0 + g + 8) * kPad + col] = c[nt][2];
    ss[(m0 + g + 8) * kPad + col + 1] = c[nt][3];
  }
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = ss[(ty + 16 * i) * kPad + tx + 16 * j];
  __syncthreads();
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ bias,
             float* __restrict__ row_max, float* __restrict__ row_sum,
             int Nq, int Nk, int D, int split_keys, float scale, bool vec) {
  __shared__ __align__(16) float qs[kStage];  // 16-byte aligned: bf16 vector staging
  __shared__ __align__(16) float ks[kStage];
  __shared__ float ss[kRows * kPad];
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
    score_tile(q, k, Nq, Nk, D, q0, k0, qs, ks, ss, vec, s);
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

constexpr size_t kOutputSmemBytes =
    sizeof(float) * (2 * kStage + kKeys * kPad + kKeys * kCols);

// fp32 inputs: p v as fp32 FMAs from shared memory.
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ row_max, const float* __restrict__ row_sum,
              float* __restrict__ out, int Nq, int Nk, int D, int splits, float scale,
              bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kDepth][kPad]  q chunk, transposed
  float* ks = qs + kStage;          // [kDepth][kPad]  k chunk, transposed
  float* ps = ks + kStage;          // [kKeys][kPad]   final weights, transposed
  float* vs = ps + kKeys * kPad;    // [kKeys][kCols]  V tile, one column slice
  const int b = blockIdx.z, q0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
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
    score_tile(q, k, Nq, Nk, D, q0, k0, qs, ks, ps, vec, s);  // ends with a barrier
    bias_tile(bias, Nk, k0, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(tx + 16 * j) * kPad + ty + 16 * i] = expf(s[i][j] - m[i]) * inv_l[i];
#pragma unroll 4
    for (int it = 0; it < kKeys * kCols / kThreads; ++it) {
      const int e = it * kThreads + tid;
      const int r = e / kCols, c = e % kCols;
      const int key = k0 + r, col = c0 + c;
      vs[r * kCols + c] = (key < Nk && col < D) ? v[(size_t)key * D + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[kk * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float x = vs[kk * kCols + tx + 16 * j];
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// dst[r][c] = v[k0 + r][c0 + c] for 64 keys x kCols columns (zero out of
// range), row stride kVStride; 16-byte vectors when vec.
__device__ __forceinline__ void stage_v_bf16(const __nv_bfloat16* __restrict__ v, int Nk, int D,
                                             int k0, int c0, bool vec,
                                             __nv_bfloat16* __restrict__ dst) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int it = 0; it < kKeys * kCols / 8 / kThreads; ++it) {
      const int e = it * kThreads + tid;
      const int r = e / (kCols / 8), c = (e % (kCols / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk && c0 + c < D)
        x = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + r) * D + c0 + c);
      *reinterpret_cast<uint4*>(dst + r * kVStride + c) = x;
    }
    return;
  }
#pragma unroll 4
  for (int it = 0; it < kKeys * kCols / kThreads; ++it) {
    const int e = it * kThreads + tid;
    const int r = e / kCols, c = e % kCols;
    dst[r * kVStride + c] = (k0 + r < Nk && c0 + c < D) ? v[(size_t)(k0 + r) * D + c0 + c]
                                                        : __float2bfloat16(0.f);
  }
}

constexpr size_t kOutputSmemBytesBf16 =
    sizeof(float) * (2 * kStage + kRows * kPad) +
    sizeof(__nv_bfloat16) * (kRows * kPStride + kKeys * kVStride);

// bf16 inputs: p (rounded to bf16) v on the tensor cores. Warp w owns output
// rows 16 (w % 4) .. +16 and columns (kCols / 2) (w / 4) .. + kCols / 2, as
// 16 m16n8 accumulator tiles; p comes from shared memory as A fragments and
// V through ldmatrix.trans as B fragments.
__global__ void __launch_bounds__(kThreads)
output_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ row_max, const float* __restrict__ row_sum,
                   __nv_bfloat16* __restrict__ out, int Nq, int Nk, int D, int splits,
                   float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // bf16 q chunk (score_tile)
  float* ks = qs + kStage;           // bf16 k chunk
  float* ss = ks + kStage;           // [kRows][kPad] fp32 score exchange
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(ss + kRows * kPad);  // [kRows][kPStride]
  __nv_bfloat16* vb = pb + kRows * kPStride;                                  // [kKeys][kVStride]
  const int b = blockIdx.z, q0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = (kCols / 2) * (warp >> 2);
  constexpr int kTiles = kCols / 2 / 8;
  q += (size_t)b * Nq * D;
  k += (size_t)b * Nk * D;
  v += (size_t)b * Nk * D;
  out += (size_t)b * Nq * D;
  if (bias) bias += (size_t)b * Nk;

  float m[4], inv_l[4];
  merge_stats(row_max, row_sum, splits, Nq, q0, m, inv_l);
  float acc[kTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kKeys) {
    float s[4][4];
    score_tile(q, k, Nq, Nk, D, q0, k0, qs, ks, ss, vec, s);  // ends with a barrier
    bias_tile(bias, Nk, k0, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pb[(ty + 16 * i) * kPStride + tx + 16 * j] =
            __float2bfloat16(expf(s[i][j] - m[i]) * inv_l[i]);
    stage_v_bf16(v, Nk, D, k0, c0, vec, vb);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 16) {
      const __nv_bfloat16* pa = pb + (m0 + g) * kPStride + kk + 2 * t;
      const uint32_t a[4] = {ld_pair(pa), ld_pair(pa + 8 * kPStride), ld_pair(pa + 8),
                             ld_pair(pa + 8 * kPStride + 8)};
      // lanes 8i..8i+7 address the rows of 8x8 matrix i: keys kk + 8 (i % 2) + lane % 8,
      // columns + 8 (i / 2); .trans hands out the B fragments of two n-tiles
      const __nv_bfloat16* vrow =
          vb + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kVStride + n0 + 8 * (lane >> 4);
#pragma unroll
      for (int nt = 0; nt < kTiles; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + 8 * nt);
        const uint32_t b0[2] = {r[0], r[1]};
        const uint32_t b1[2] = {r[2], r[3]};
        mma_bf16(acc[nt], a, b0);
        mma_bf16(acc[nt + 1], a, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int col = c0 + n0 + 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + m0 + g + 8 * h;
      if (row >= Nq) continue;
      __nv_bfloat16* o = out + (size_t)row * D + col;
      if (col < D) o[0] = __float2bfloat16(acc[nt][2 * h]);
      if (col + 1 < D) o[1] = __float2bfloat16(acc[nt][2 * h + 1]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           void* row_max, void* row_sum, int B, int Nq, int Nk, int D, int splits,
           float scale, int device, void* stream) {
  const int k_tiles = (Nk + kKeys - 1) / kKeys;
  if (B <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || B > 65535 || splits <= 0 || splits > k_tiles ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* bt = static_cast<const float*>(bias);
  float* mt = static_cast<float*>(row_max);
  float* lt = static_cast<float*>(row_sum);
  const int q_tiles = (Nq + kRows - 1) / kRows;
  const bool vec = D % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) % 16) == 0;

  const int split_keys = (k_tiles + splits - 1) / splits * kKeys;
  stats_kernel<T><<<dim3(q_tiles, splits, B), kThreads, 0, st>>>(qt, kt, bt, mt, lt, Nq, Nk, D,
                                                                  split_keys, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((D + kCols - 1) / kCols, q_tiles, B);
  if constexpr (std::is_same<T, float>::value) {
    err = cudaFuncSetAttribute(output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kOutputSmemBytes);
    if (err != cudaSuccess) return (int)err;
    output_kernel<<<grid, kThreads, kOutputSmemBytes, st>>>(
        qt, kt, vt, bt, mt, lt, static_cast<T*>(out), Nq, Nk, D, splits, scale, vec);
  } else {
    err = cudaFuncSetAttribute(output_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kOutputSmemBytesBf16);
    if (err != cudaSuccess) return (int)err;
    output_kernel_bf16<<<grid, kThreads, kOutputSmemBytesBf16, st>>>(
        qt, kt, vt, bt, mt, lt, static_cast<T*>(out), Nq, Nk, D, splits, scale, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Number of key splits of the stats pass: enough (b, split, query tile)
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

extern "C" int token_attention_f32(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* row_max,
                                   void* row_sum, int B, int Nq, int Nk, int D, int splits,
                                   float scale, int device, void* stream) {
  return launch<float>(q, k, v, bias, out, row_max, row_sum, B, Nq, Nk, D, splits, scale,
                       device, stream);
}

extern "C" int token_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, void* row_max,
                                    void* row_sum, int B, int Nq, int Nk, int D, int splits,
                                    float scale, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, out, row_max, row_sum, B, Nq, Nk, D, splits,
                               scale, device, stream);
}
