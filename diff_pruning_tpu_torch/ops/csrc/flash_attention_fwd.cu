// Flash-attention forward (non-causal) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_flash_fwd_call` / `_fwd_kernel` of
// diff_pruning_tpu/ops/attention.py: online-softmax attention with a running
// max, denominator and f32 accumulator, never forming the Nq x Nkv matrix,
// and optionally the per-row logsumexp for the backward.
//
// What bounds it on the H100: at the UNet's shapes (N = 256 tokens, one head
// of D = 256) the op does 4*N*D flops per query row against 4*D elements
// moved for it, far above the card's balance point, so it is bound by
// arithmetic: the f32 CUDA-core rate (67 TFLOP/s) for f32 inputs, the tensor
// cores (989 TFLOP/s) for bf16/f16. What keeps a kernel from that rate is
// feeding the arithmetic units: shared-memory loads per FMA, and copies that
// do not overlap the math. The design answers both, per input type:
//
// f32 (`flash_fwd_kernel_f32`, exact f32 on the CUDA cores, no TF32):
// - 256 threads per (batch*head, 64-row query tile), 64-row K/V tiles. Each
//   thread owns a 4 x 4 register micro-tile of S (rows ty + 16i, kv columns
//   tx + 16j) and 4 rows x 16 columns of the O accumulator (columns
//   tx*4 + 64c .. +3);
// - QK^T: per 4 steps of d, 4 float4 loads of Q and 4 of K feed 64 FMAs;
//   Q and K stay row-major (d contiguous) so that cp.async can copy them
//   as they lie in device memory, and a float4 along d gives the same 8
//   FMAs per load as a d-major layout would;
// - P goes through shared memory in a layout where a thread's 4 rows are
//   one float4: PV is 1 float4 of P and 4 of V per 64 FMAs;
// - row statistics combine across the 16 lanes of a row with shuffles.
//
// bf16/f16 (`flash_fwd_kernel_mma`, tensor cores):
// - 128 threads (4 warps) per (batch*head, 64-row query tile); each warp owns
//   16 query rows; `mma.sync.aligned.m16n8k16` with f32 accumulators,
//   operands from shared memory through `ldmatrix` (V with `.trans`;
//   tensor_core.cuh, shared with the backward), in the
//   FA2 register layout: S, the running max and sum stay in registers, and
//   P is rounded to the input type in registers, where its accumulator
//   layout is already the A operand of the PV product;
// - rows of 2*(D_pad + 8) bytes put the 8 rows of an ldmatrix on distinct
//   banks.
//
// f32 with 256 < D <= 1024 (`flash_fwd_kernel_f32_wide`, the LDM's one-head
// transformers and its first stage): 64-row query tiles (32 above D_pad =
// 512), Q resident, K and V in head-dim chunks through one two-slot ring, S
// accumulated over the chunks in registers; see its note below.
//
// bf16/f16 with 256 < D <= 1024 (`flash_fwd_kernel_wgmma_wide`, the same
// heads under bf16 training): 64-row query tiles on two warpgroups with
// Hopper's `wgmma`, O's columns split between them (and, above D_pad = 512,
// between two blocks); see its note below.
//
// The 64-row kernels (D <= 256): K and V tiles stream through a two-slot
// cp.async ring in the order K0, V0, K1, V1, ...: while S = Q K_t^T is
// computed, V_t is in flight; once K_t is consumed, K_{t+1} is issued and
// overlaps the softmax and P V_t.
//
// All paths:
// - the head dim is zero-filled in shared memory up to the kernel's padded
//   width (cp.async's src-size), never in device memory; no per-element
//   predicate in the inner products; rows at or beyond Nq/Nkv are
//   zero-filled, scores of kv columns at or beyond Nkv are set to -inf;
//   columns at or beyond D are not written;
// - 16-byte cp.async where the head-split views allow it (base and strides
//   16-byte aligned), else narrower copies (4-byte cp.async for f32; for
//   16-bit types plain loads in the 64-row kernel, and 8- or 4-byte
//   cp.async or plain loads in the wide one, e.g. D = 179 or 268 views of a
//   fused projection);
// - no atomics: every output element is written by one thread, so results
//   are bit-reproducible run to run;
// - `lse` may be null (inference: the launch writes only o). Otherwise it is
//   a contiguous (B*H, Nq) f32 array and each row's logsumexp of its scaled
//   scores, m + log(l) (the TPU kernel's `_finish`), is written there for the
//   backward kernels (flash_attention_bwd.cu).
//
// Shared memory at D = 256: f32 3 * 64 * 260 * 4 + 64 * 68 * 4 = 217,088
// bytes (one block per SM, 8 warps); bf16/f16 3 * 64 * 264 * 2 = 101,376
// bytes (two blocks per SM, 8 warps). The launcher raises the limit.
//
// q, k, v, o are addressed as [b][h][n][d] through element strides (d
// contiguous), so the caller passes head-split views without copying.
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxD = 256;       // the 64-row kernels (every input type)
constexpr int kMaxDWide = 1024;  // flash_fwd_kernel_f32_wide, flash_fwd_kernel_wgmma_wide
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, n;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// cp.async with zero-fill: bytes of the copy beyond src_bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Copies rows [row0, row0 + 64) x columns [0, DP) of one head into shared
// memory (row stride ld elements), zero-filling rows >= nvalid and columns
// >= D. vec: base and row stride are 16-byte aligned.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long sn, int row0,
                                          int nvalid, int D, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T);
    constexpr int kPerRow = DP / kChunk;
    for (int idx = tid; idx < 64 * kPerRow; idx += NT) {
      const int r = idx / kPerRow;
      const int c = (idx - r * kPerRow) * kChunk;
      const int row = row0 + r;
      int bytes = 0;
      const T* from = src;
      if (row < nvalid && c < D) {
        bytes = (D - c >= kChunk ? kChunk : D - c) * int(sizeof(T));
        from = src + row * sn + c;
      }
      cp_async16(dst + r * ld + c, from, bytes);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int idx = tid; idx < 64 * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int row = row0 + r;
      const bool ok = row < nvalid && c < D;
      cp_async4(dst + r * ld + c, ok ? src + row * sn + c : src, ok ? 4 : 0);
    }
  } else {
    // no cp.async below 4 bytes: 8 loads in flight per thread, then stores
    constexpr int U = 8;  // 64 * DP is a multiple of NT * U
    for (int base = tid; base < 64 * DP; base += NT * U) {
      T vals[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * NT;
        const int r = idx / DP;
        const int c = idx - r * DP;
        vals[u] = row0 + r < nvalid && c < D ? src[(row0 + r) * sn + c] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * NT;
        dst[(idx / DP) * ld + idx % DP] = vals[u];
      }
    }
  }
}

// ---------------------------------------------------------------- f32 path

template <int NC>  // head dim padded to 64 * NC
__global__ void __launch_bounds__(256, 1)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Nq, int Nkv, int D, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale, int vec,
                     int vec_out) {
  constexpr int DP = 64 * NC;
  constexpr int LD = DP + 4;        // 16-byte rows, 4 banks apart
  constexpr int LDP = kBlockQ + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [64][LD]  query rows
  float* ks = qs + kBlockQ * LD;    // [64][LD]  kv rows
  float* vs = ks + kBlockK * LD;    // [64][LD]  kv rows
  float* ps = vs + kBlockK * LD;    // [64 kv][LDP]: P[ty + 16i][j] at [j][ty * 4 + i]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<float, DP, 256>(qs, LD, qb, sq.n, q0, Nq, D, vec);
  load_tile<float, DP, 256>(ks, LD, kb, sk.n, 0, Nkv, D, vec);
  cp_async_commit();
  load_tile<float, DP, 256>(vs, LD, vb, sv.n, 0, Nkv, D, vec);
  cp_async_commit();

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const int dk = (D + 3) & ~3;  // columns beyond D are zeros

  for (int kv0 = 0; kv0 < Nkv; kv0 += kBlockK) {
    cp_async_wait_1();  // Q and K_t have landed (V_t may be in flight)
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dk; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qf[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
        kf[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread is done with K_t: its slot takes K_{t+1}
    if (kv0 + kBlockK < Nkv)
      load_tile<float, DP, 256>(ks, LD, kb, sk.n, kv0 + kBlockK, Nkv, D, vec);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kv0 + tx + 16 * j < Nkv ? s[i][j] * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // the first tile always holds a valid column, so m_new is finite
      const float m_new = fmaxf(m_run[i], tile_max);
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    cp_async_wait_1();  // V_t has landed (K_{t+1} may be in flight)
    __syncthreads();    // ... and P is visible to every thread
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * LDP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + 64 * c + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // every thread is done with V_t and P
    if (kv0 + kBlockK < Nkv)
      load_tile<float, DP, 256>(vs, LD, vb, sv.n, kv0 + kBlockK, Nkv, D, vec);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Nq) continue;
    float* orow = o + b * so.b + h * so.h + qr * so.n;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 64 * c + tx * 4;
      if (vec_out && col < D) {  // D % 4 == 0: the whole float4 is in range
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                        acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) orow[col + e] = acc[i][4 * c + e] * inv;
      }
    }
    if (lse != nullptr && tx == 0) lse[size_t(bh) * Nq + qr] = m_run[i] + logf(l_run[i]);
  }
}

// ------------------------------------------------- f32 path, 256 < D <= 1024

// Replaces, for f32 at 256 < D <= 1024, the TPU kernel `_flash_fwd_call` /
// `_fwd_kernel` (diff_pruning_tpu/ops/attention.py:97), lse included: the
// LDM's one-head transformers (D = 384, 576, 960 and the pruned 268, 404,
// 672) and its first stage (D = 512 at 4096 tokens), exact f32 on the CUDA
// cores.
//
// What bounds it on the H100: the CUDA-core f32 rate. At (1024, 1024, 384)
// the op does 4 * 1024 * 384 flops per query row against 16 * 384 bytes
// moved for it, ~250 flops a byte, above the card's f32 balance point (67
// TFLOP/s over 3.35 TB/s: 20). What keeps a kernel from that rate is how
// often a K/V row is fetched again from L2 (once per query tile) and how many
// shared-memory loads feed each FMA.
//
// The design: 256 threads per (batch*head, query tile), the tile as large as
// the registers allow. O stays in registers: 128 f32 a thread, so BQ = 64
// query rows at D_pad <= 512 and 32 above (BQ * D_pad = 32,768). Q is
// resident in shared memory (BQ x D_pad, zero-filled past D, <= 132 KB); K
// and V stream through one cp.async ring of ~34 KB stages, in the order of
// use, with as many slots as shared memory holds (2, or 3 at D_pad = 384 and
// 640-768) and one barrier a stage:
// - S = Q K_t^T over BK = 4096 / BQ kv rows (64, or 128 at BQ = 32): the
//   stages are K_t's head-dim chunks of DC = 8192 / BK columns (128 or 64),
//   and S (BQ x BK, 16 a thread) accumulates over them in registers, as a
//   GEMM's K loop does: no partial S is summed across threads. Thread (ty =
//   t / TX, tx = t % TX, TX = BK / 4) owns rows ty + TY i and kv columns
//   tx + TX j (i, j < 4); per 4 head-dim columns 4 float4 loads of Q (one
//   address, or two, across the warp: broadcast) and 4 of K feed 64 FMAs;
// - the online softmax on that micro-tile (row max and sum across the TX
//   lanes of a row by shuffles); P goes to shared memory ([kv][row]) and
//   each row's rescale factor with it;
// - O += P V_t: the stages are V_t's 128-column chunks of 64 kv rows. Thread
//   (py = t / 32, cx = t % 32) owns rows py * BQ / 8 .. + BQ / 8 and columns
//   4 cx + 128 c of O: per kv row, BQ / 32 broadcast float4 loads of P and
//   one float4 of V feed 4 * BQ / 8 FMAs (32 at BQ = 64, 16 at 32).
// While one stage is consumed the next one or two are in flight. K/V bytes
// fetched from L2 per query row: 2 * Nkv * D * 4 / BQ, against 2 * Nkv * D *
// 4 / 16 with the 16-row tiles this replaces (4x less at BQ = 64, 2x at 32),
// plus Q's D * 4 once: 50,688 against 198,144 at (1024, 1024, 384),
// 264,192 against 1,050,624 at (4096, 4096, 512). Head-dim chunks and V
// chunks past D, and kv rows past Nkv in a V stage, are skipped; S takes
// every micro-tile column (the registers leave no room for a second loop
// shape), so a short tile (Nkv = 1) costs the S of a full one. The FMA
// loops, not the copies, bound it: without its products it takes a fifth
// of its time (fwd_breakdown.py).
//
// Shared memory: (BQ (D_pad + 4) + slots + BK (BQ + 4) + BQ) * 4 bytes,
// 217,344-219,776; one block per SM.
template <int BQ>
__host__ __device__ constexpr int f32_wide_stage_floats() {
  // max(a K stage BK x (DC + 4), a V stage 64 x (128 + 4))
  return (4096 / BQ) * (8192 / (4096 / BQ) + 4) > 64 * 132
             ? (4096 / BQ) * (8192 / (4096 / BQ) + 4) : 64 * 132;
}

// floats besides the ring: Q [BQ][D_pad + 4], P [BK][BQ + 4], the row factors
template <int BQ, int NCV>
__host__ __device__ constexpr int f32_wide_fixed_floats() {
  return BQ * (128 * NCV + 4) + (4096 / BQ) * (BQ + 4) + BQ;
}

// the ring's slots: as many as a block's 227 KB hold
template <int BQ, int NCV>
__host__ __device__ constexpr int f32_wide_slots() {
  return (232448 / 4 - f32_wide_fixed_floats<BQ, NCV>()) / f32_wide_stage_floats<BQ>();
}

template <int BQ, int NCV>
__host__ __device__ constexpr int f32_wide_smem_bytes() {
  return (f32_wide_fixed_floats<BQ, NCV>() +
          f32_wide_slots<BQ, NCV>() * f32_wide_stage_floats<BQ>()) * 4;
}

// Copies rows [row0, row0 + R) x columns [col0, col0 + C) of one head (row
// stride sn elements) into a shared [R][ld] tile, zero-filling rows >= nvalid
// and columns >= D. vec: base and row stride are 16-byte aligned (col0 % 4 == 0).
template <int R, int C>
__device__ __forceinline__ void load_block_f32(float* dst, int ld, const float* src, long long sn,
                                               int row0, int nvalid, int col0, int D, bool vec) {
  if (vec) {
    constexpr int PER_ROW = C / 4;
    for (int idx = threadIdx.x; idx < R * PER_ROW; idx += 256) {
      const int r = idx / PER_ROW;
      const int c = (idx - r * PER_ROW) * 4;
      const int row = row0 + r, col = col0 + c;
      int bytes = 0;
      const float* from = src;
      if (row < nvalid && col < D) {
        bytes = (D - col >= 4 ? 4 : D - col) * 4;
        from = src + row * sn + col;
      }
      cp_async16(dst + r * ld + c, from, bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += 256) {
      const int r = idx / C;
      const int c = idx - r * C;
      const int row = row0 + r, col = col0 + c;
      const bool ok = row < nvalid && col < D;
      cp_async4(dst + r * ld + c, ok ? src + row * sn + col : src, ok ? 4 : 0);
    }
  }
}

template <int BQ, int NCV>  // query rows a block; head dim padded to 128 * NCV
__global__ void __launch_bounds__(256, 1)
flash_fwd_kernel_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Nq, int Nkv, int D, Strides sq,
                          Strides sk, Strides sv, Strides so, float scale, int vec,
                          int vec_out) {
  static_assert(BQ * 128 * NCV <= 32768, "O: 128 f32 registers a thread");
  constexpr int DP = 128 * NCV;
  constexpr int BK = 4096 / BQ;         // kv rows a tile
  constexpr int DC = 8192 / BK;         // head-dim columns of a K stage
  constexpr int NSUB = BK / 64;         // V stages of 64 kv rows per column chunk
  constexpr int LDQ = DP + 4, LDK = DC + 4, LDV = 128 + 4, LDP = BQ + 4;
  constexpr int STAGE = f32_wide_stage_floats<BQ>();
  constexpr int NS = f32_wide_slots<BQ, NCV>();
  static_assert(NS >= 2, "a ring of two slots at least");
  constexpr int TX = BK / 4, TY = 256 / TX;  // S: lanes a row, row groups
  constexpr int RP = BQ / 8;                 // O: rows a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [BQ][LDQ]
  float* ring = qs + BQ * LDQ;       // NS x [STAGE]: K [BK][LDK] or V [64][LDV]
  float* ps = ring + NS * STAGE;     // [BK][LDP]: P[row][kv] at [kv][row]
  float* rowf = ps + BK * LDP;       // [BQ]: each row's rescale factor, at the end its sum

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;  // S micro-tile
  const int cx = tid & 31, py = tid >> 5;  // O rows and columns

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int ns = (D + DC - 1) / DC;     // K stages a kv tile
  const int nvc = (D + 127) / 128;      // V column chunks
  auto nsub_of = [&](int t) { return min(NSUB, (Nkv - t + 63) / 64); };
  // the stage the ring takes next: kv tile pt, stage pi (< ns: K chunk pi;
  // then V column chunk (pi - ns) / nsub, kv rows 64 ((pi - ns) % nsub) on)
  int pt = 0, pi = 0;
  auto issue = [&](int slot) {
    if (pt < Nkv) {
      float* dst = ring + slot * STAGE;
      if (pi < ns) {
        load_block_f32<BK, DC>(dst, LDK, kb, sk.n, pt, Nkv, pi * DC, D, vec);
      } else {
        const int nsub = nsub_of(pt);
        const int c = (pi - ns) / nsub, sub = (pi - ns) - c * nsub;
        load_block_f32<64, 128>(dst, LDV, vb, sv.n, pt + 64 * sub, Nkv, 128 * c, D, vec);
      }
      if (++pi == ns + nvc * nsub_of(pt)) {
        pt += BK;
        pi = 0;
      }
    }
    cp_async_commit();
  };
  // one barrier a stage: once every thread is past it, the slot of the
  // stage before is free and takes the stage NS - 1 ahead
  int slot = 0;
  auto next_stage = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));  // this stage has landed
    __syncthreads();
    issue(slot == 0 ? NS - 1 : slot - 1);
    const float* at = ring + slot * STAGE;
    slot = slot == NS - 1 ? 0 : slot + 1;
    return at;
  };

  load_block_f32<BQ, DP>(qs, LDQ, q + b * sq.b + h * sq.h, sq.n, q0, Nq, 0, D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);  // (Q with the first)

  float acc[NCV][RP][4];
#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][r][e] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int t = 0; t < Nkv; t += BK) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kc = 0; kc < ns; ++kc) {
      const float* ks = next_stage();
      const float* qc = qs + kc * DC;
      const int dl = min(DC, (D - kc * DC + 3) & ~3);  // columns past D are zeros
#pragma unroll 4
      for (int d = 0; d < dl; d += 4) {
        float4 qf[4], kf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qf[i] = *reinterpret_cast<const float4*>(qc + (ty + TY * i) * LDQ + d);
          kf[i] = *reinterpret_cast<const float4*>(ks + (tx + TX * i) * LDK + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = t + tx + TX * j < Nkv ? s[i][j] * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // the first tile always holds a valid column, so m_new is finite
      const float m_new = fmaxf(m_run[i], tile_max);
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(tx + TX * j) * LDP + ty + TY * i] = s[i][j];
      if (tx == 0) rowf[ty + TY * i] = alpha;
    }

    const int nsub = nsub_of(t);
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      if (c >= nvc) break;
      for (int sub = 0; sub < nsub; ++sub) {
        const float* vs = next_stage();  // ... and P and the rescale factors are visible
        if (c == 0 && sub == 0) {
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float a = rowf[py * RP + r];
#pragma unroll
            for (int cc = 0; cc < NCV; ++cc)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[cc][r][e] *= a;
          }
        }
        const float* pp = ps + 64 * sub * LDP + py * RP;
        const float* vp = vs + 4 * cx;
        const int jl = min(64, Nkv - t - 64 * sub);
#pragma unroll 4
        for (int j = 0; j < jl; ++j) {
          float pr[RP];
#pragma unroll
          for (int r = 0; r < RP; r += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pp + j * LDP + r);
            pr[r] = p4.x;
            pr[r + 1] = p4.y;
            pr[r + 2] = p4.z;
            pr[r + 3] = p4.w;
          }
          const float4 vv = *reinterpret_cast<const float4*>(vp + j * LDV);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            acc[c][r][0] = fmaf(pr[r], vv.x, acc[c][r][0]);
            acc[c][r][1] = fmaf(pr[r], vv.y, acc[c][r][1]);
            acc[c][r][2] = fmaf(pr[r], vv.z, acc[c][r][2]);
            acc[c][r][3] = fmaf(pr[r], vv.w, acc[c][r][3]);
          }
        }
      }
    }
  }

  __syncthreads();  // every thread has read the last rescale factors
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + TY * i;
    if (tx == 0) {
      rowf[row] = l_run[i];
      if (lse != nullptr && q0 + row < Nq) lse[size_t(bh) * Nq + q0 + row] = m_run[i] + logf(l_run[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int qr = q0 + py * RP + r;
    if (qr >= Nq) continue;
    float* orow = o + b * so.b + h * so.h + qr * so.n;
    const float inv = 1.f / rowf[py * RP + r];
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      const int col = 128 * c + 4 * cx;
      if (vec_out && col < D) {  // D % 4 == 0: the whole float4 is in range
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[c][r][0] * inv, acc[c][r][1] * inv, acc[c][r][2] * inv,
                        acc[c][r][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) orow[col + e] = acc[c][r][e] * inv;
      }
    }
  }
}

// ----------------------------------------------------------- bf16/f16 path

template <typename T, int NC>  // head dim padded to 64 * NC
__global__ void __launch_bounds__(128, 2)
flash_fwd_kernel_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                     Strides so, float scale, int vec, int vec_out) {
  constexpr int DP = 64 * NC;
  constexpr int LD = DP + 8;  // rows 16 bytes apart modulo 128: ldmatrix conflict-free
  constexpr int NT = DP / 8;  // n-tiles of the O accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][LD]
  T* ks = qs + kBlockQ * LD;                // [64][LD]
  T* vs = ks + kBlockK * LD;                // [64][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = q0 + warp * 16 < Nq;  // warps past Nq only help copy

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile<T, DP, 128>(qs, LD, qb, sq.n, q0, Nq, D, vec);
  load_tile<T, DP, 128>(ks, LD, kb, sk.n, 0, Nkv, D, vec);
  cp_async_commit();
  load_tile<T, DP, 128>(vs, LD, vb, sv.n, 0, Nkv, D, vec);
  cp_async_commit();

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // rows lane/4 and lane/4 + 8 of the warp's 16; scores in log2 units
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row sums
  const float scale2 = scale * kLog2e;
  const int ksteps = (D + 15) >> 4;
  // ldmatrix addresses: A (Q) rows lane%16, column half lane/16; B (K) rows
  // lane%8 + 8*(lane/16) of a pair of n-tiles, column half (lane/8)%2; V
  // (trans) rows lane%8 + 8*((lane/8)%2), column half lane/16
  const T* qa = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const T* kbase = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const T* vbase = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  for (int kv0 = 0; kv0 < Nkv; kv0 += kBlockK) {
    cp_async_wait_1();  // Q and K_t have landed (V_t may be in flight)
    __syncthreads();
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
    if (active) {
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, kbase + np * 16 * LD + kk * 16);
          mma16816(sacc[2 * np], a, bf[0], bf[1], static_cast<T*>(nullptr));
          mma16816(sacc[2 * np + 1], a, bf[2], bf[3], static_cast<T*>(nullptr));
        }
      }
    }
    __syncthreads();  // every warp is done with K_t: its slot takes K_{t+1}
    if (kv0 + kBlockK < Nkv)
      load_tile<T, DP, 128>(ks, LD, kb, sk.n, kv0 + kBlockK, Nkv, D, vec);
    cp_async_commit();

    uint32_t pa[4][4];  // P as the A operand of 4 k-steps of 16 kv columns
    if (active) {
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + n * 8 + (lane & 3) * 2 + (e & 1);
          sacc[n][e] = col < Nkv ? sacc[n][e] * scale2 : -INFINITY;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sacc[n][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        // the first tile always holds a valid column, so m_new is finite
        const float m_new = fmaxf(m_run[r], tile_max[r]);
        const float alpha = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_part[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          oacc[n][2 * r] *= alpha;
          oacc[n][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[n][e] = exp2f(sacc[n][e] - m_run[e >> 1]);
          l_part[e >> 1] += sacc[n][e];
        }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        pa[t][0] = pack2(sacc[2 * t][0], sacc[2 * t][1], static_cast<T*>(nullptr));
        pa[t][1] = pack2(sacc[2 * t][2], sacc[2 * t][3], static_cast<T*>(nullptr));
        pa[t][2] = pack2(sacc[2 * t + 1][0], sacc[2 * t + 1][1], static_cast<T*>(nullptr));
        pa[t][3] = pack2(sacc[2 * t + 1][2], sacc[2 * t + 1][3], static_cast<T*>(nullptr));
      }
    }

    cp_async_wait_1();  // V_t has landed (K_{t+1} may be in flight)
    __syncthreads();
    if (active) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        // all DP columns, zeros past D included: a branch here would keep
        // ptxas from issuing the next ldmatrix ahead of this mma
        for (int dc = 0; dc < DP / 16; ++dc) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vbase + t * 16 * LD + dc * 16);
          mma16816(oacc[2 * dc], pa[t], bf[0], bf[1], static_cast<T*>(nullptr));
          mma16816(oacc[2 * dc + 1], pa[t], bf[2], bf[3], static_cast<T*>(nullptr));
        }
      }
    }
    __syncthreads();  // every warp is done with V_t
    if (kv0 + kBlockK < Nkv)
      load_tile<T, DP, 128>(vs, LD, vb, sv.n, kv0 + kBlockK, Nkv, D, vec);
    cp_async_commit();
  }

  // O goes through the Q tile (free now) so that rows leave in 16-byte stores
  __syncthreads();
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = warp * 16 + (lane >> 2) + 8 * r;
      const float inv = 1.f / l;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(qs + row * LD + n * 8 + (lane & 3) * 2) =
            pack2(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv, static_cast<T*>(nullptr));
      if (lse != nullptr && (lane & 3) == 0 && q0 + row < Nq)
        lse[size_t(bh) * Nq + q0 + row] = (m_run[r] + log2f(l)) * kLn2;
    }
  }
  __syncthreads();
  T* ob = o + b * so.b + h * so.h;
  if (vec_out) {  // D is a multiple of 8: whole chunks
    const int per_row = D / 8;
    for (int idx = threadIdx.x; idx < kBlockQ * per_row; idx += 128) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 8;
      if (q0 + r < Nq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * so.n + c) =
            *reinterpret_cast<const uint4*>(qs + r * LD + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBlockQ * D; idx += 128) {
      const int r = idx / D;
      const int c = idx - r * D;
      if (q0 + r < Nq) ob[(q0 + r) * so.n + c] = qs[r * LD + c];
    }
  }
}

// ------------------------------------------- bf16/f16 path, 256 < D <= 1024

// Replaces, for bf16/f16 at 256 < D <= 1024, the TPU kernel
// `_flash_fwd_call` / `_fwd_kernel` (diff_pruning_tpu/ops/attention.py:97),
// lse included: the LDM's one-head transformers under bf16 training (D =
// 384, 576, 960 and the pruned 268, 404, 672) and its first stage's encode
// (D = 512 at 4096 tokens), on the tensor cores with Hopper's warpgroup
// products.
//
// What bounds it on the H100: the tensor cores (989 TFLOP/s) by the count of
// operations, ~500 flops a byte at (1024, 1024, 384); what keeps a kernel
// from that rate is feeding them: how often a K/V row is fetched again from
// L2 (once per query tile) and how many shared-memory bytes each product
// reads.
//
// The design: 64-row query tiles, one m64 row of `wgmma` (m64nNk16, f32
// accumulators), 256 threads = two warpgroups a block:
// - O (64 x D) is split by columns: each warpgroup owns DW = 64 NW columns
//   (NW = 3 or 4: 96 or 128 f32 registers a thread), a block DO = 2 DW;
//   above DO = 512 a cluster of Z = 2 blocks (grid.z) splits the head dim:
//   each block holds its DO columns of Q, K, V and O;
// - Q (64 x DO) is resident in shared memory; the block's columns of K and
//   V tiles (64 kv rows) stream through one cp.async ring (K_0, V_0, K_1,
//   ...) of as many slots as shared memory holds (2 or 3), one barrier a
//   stage: each stage's copy overlaps the products of the stages before it;
// - S = Q K_t^T (64 x 64) from shared memory (A = Q, B = K, both K-major):
//   each warpgroup forms the block's whole partial S, so the two compute
//   the same bits; in a cluster the two blocks' partials are added through
//   distributed shared memory (both add the same two numbers: the same
//   bits in both, no atomics). The online softmax runs on the accumulator
//   registers (row max and sum across the 4 lanes of a quad, log2 units),
//   and P, rounded to the input type once, is the A operand of the PV
//   product straight from registers (its accumulator layout is already the
//   A fragment layout);
// - O += P V_t: A = P from registers, B = V_t from shared memory (MN-major,
//   the head dim contiguous: transposed B), in n64 column chunks.
// Each K/V row is fetched from L2 once per 64 query rows (each block of a
// cluster fetching its half of the columns), against once per 16 rows by
// the tiling this replaces: bytes per query row 2 D (Q, once) + 2 * 2 Nkv D
// / 64 (K and V), against 2 D + 2 * 2 Nkv D / 16: 4x less for K and V;
// 25,344 against 99,072 at (1024, 1024, 384), 132,096 against 525,312 at
// (4096, 4096, 512).
// The copies, issued by the same warps as the products, bound it at the
// main shapes (fwd_breakdown.py), so they are made cheap to issue: a warp's
// cp.async run along 512 contiguous bytes of a row, the 128-byte swizzle
// puts their 16-byte chunks on distinct banks, and tiles wholly in range
// take a path without per-chunk checks. Otherwise copies take the widest
// chunk the views allow (16, 8 or 4 bytes by cp.async, or 2-byte loads; the
// pruned widths' rows are 8- or 4-byte aligned), zero-filling rows past
// Nq/Nkv and columns past D.
// Shared memory: Q + NS K/V slots (+ 32 KB of partials in a cluster) + 1 KB
// of alignment: 197,632 bytes at DO = 384 (3 slots) and 512 (2 slots),
// 230,400 in a cluster; one block per SM.

// the ring's slots, each a K or V tile [64][2 DW] of 16-bit values: as many
// as a block's 227 KB hold beside Q [64][2 DW], 1 KB of alignment and, in a
// cluster, the S partials (2 x 64 x 64 f32)
template <int NW, int Z>
__host__ __device__ constexpr int wide16_slots() {
  return (232448 - 1024 - 16384 * NW - (Z > 1 ? 32768 : 0)) / (16384 * NW);
}

template <int NW, int Z>
__host__ __device__ constexpr int wide16_smem_bytes() {
  // (+ 1024: the tiles start 1024-byte aligned)
  return (1 + wide16_slots<NW, Z>()) * 16384 * NW + (Z > 1 ? 32768 : 0) + 1024;
}

template <typename T, int NW, int Z>  // n64 chunks of O a warpgroup; blocks (a cluster) a tile
__global__ void __launch_bounds__(256, 1)
flash_fwd_kernel_wgmma_wide(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                            int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                            Strides so, float scale, int granule, int vec_out) {
  constexpr int DW = 64 * NW;    // O columns a warpgroup
  constexpr int DO = 2 * DW;     // head-dim columns a block (Q, K, V and O)
  constexpr int BK = 64;         // kv rows a tile
  constexpr int NB = BK / 8;     // n8 blocks of S
  constexpr int NS = wide16_slots<NW, Z>();
  static_assert(NS >= 2, "a ring of two slots at least");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  // qs: Q [64][DO], at the end O
  T* ring = qs + 64 * DO;                  // NS x [BK][DO]: K_t, V_t, K_t+1, ...
  float* red = reinterpret_cast<float*>(ring + NS * BK * DO);  // Z > 1: 2 x [32][128]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * 64;
  const uint32_t rank = Z > 1 ? cluster_rank() : 0;  // = blockIdx.z
  const int c0 = rank * DO;  // the block's first head-dim column
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int row_a = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows: row_a, +8

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  // stage s of the ring: the block's columns of K (s even) or V (odd) of kv
  // tile s / 2
  int next = 0;
  auto issue = [&](int slot) {
    const int t = (next >> 1) * BK;
    if (t < Nkv)
      copy_sw128<BK, DO>(ring + slot * BK * DO, next & 1 ? vb : kb, next & 1 ? sv.n : sk.n, t,
                         Nkv, c0, D, granule);
    cp_async_commit();
    ++next;
  };
  // one barrier a stage: once both warpgroups are past it, the slot of the
  // stage before (its products waited for) is free and takes the stage NS - 1
  // ahead
  int slot = 0;
  auto next_stage = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));  // this stage has landed
    fence_proxy_async();
    __syncthreads();
    issue(slot == 0 ? NS - 1 : slot - 1);
    T* at = ring + slot * BK * DO;
    slot = slot == NS - 1 ? 0 : slot + 1;
    return at;
  };
  copy_sw128<64, DO>(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, c0, D, granule);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);  // (Q with the first)

  float oacc[NW][32];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // scores in log2 units
  float l_part[2] = {0.f, 0.f};             // this lane's share of the row sums
  const float scale2 = scale * kLog2e;
  const int ksteps = min(DO, D - c0 + 15) >> 4;  // the block's k-steps holding columns < D
  // Q and K (K-major) and V (MN-major) in 64-column slabs of 128-byte rows
  // (copy_sw128): the next 8 rows 1024 bytes on, the next slab 64 rows (8192
  // bytes) on; k-step kk of S starts in slab kk / 4, 32 (kk % 4) bytes in
  const uint64_t qdesc = gmma_desc(qs, 16, 1024);

  for (int t = 0, it = 0; t < Nkv; t += BK, ++it) {
    const T* ks = next_stage();  // Q and K_t have landed
    float sacc[NB * 4];
#pragma unroll
    for (int e = 0; e < NB * 4; ++e) sacc[e] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
    const uint64_t kdesc = gmma_desc(ks, 16, 1024);
    for (int kk = 0; kk < ksteps; ++kk) {
      const int step = ((kk >> 2) * 8192 + (kk & 3) * 32) >> 4;  // the start address, >> 4
      Gmma<T>::ss64(sacc, qdesc + step, kdesc + step);
    }
    wgmma_commit_wait();
    fence_regs(sacc);
    if constexpr (Z > 1) {
      // S = this block's partial + the other's: the same sum, in the same
      // bits, in both (a + b == b + a); the partials alternate between two
      // buffers, so one cluster barrier a tile keeps a buffer from being
      // written again before the other block has read it
      float* mine = red + (it & 1) * 32 * 128;
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < NB * 4; ++e) mine[e * 128 + tid] = sacc[e];
      }
      cluster_sync();
      const uint32_t theirs = cluster_map(mine + (tid & 127), rank ^ 1);
#pragma unroll
      for (int e = 0; e < NB * 4; ++e) sacc[e] += ld_cluster(theirs + e * 128 * 4);
    }

    // online softmax on rows row_a (e % 4 < 2) and row_a + 8; the
    // accumulator holds S[row][8 j + 2 (lane % 4) + e % 2] at sacc[4 j + e]
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t + 8 * j + 2 * (lane & 3) + (e & 1);
        sacc[4 * j + e] = col < Nkv ? sacc[4 * j + e] * scale2 : -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sacc[4 * j + e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      // the first tile always holds a valid column, so m_new is finite
      const float m_new = fmaxf(m_run[r], tile_max[r]);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oacc[n][4 * j + 2 * r] *= alpha;
          oacc[n][4 * j + 2 * r + 1] *= alpha;
        }
    }
    uint32_t pa[BK / 16][4];  // P as the A operand of the k-steps of 16 kv rows
#pragma unroll
    for (int e = 0; e < NB * 4; ++e) {
      sacc[e] = exp2f(sacc[e] - m_run[(e >> 1) & 1]);
      l_part[(e >> 1) & 1] += sacc[e];
    }
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kt][e] = pack2(sacc[8 * kt + 2 * e], sacc[8 * kt + 2 * e + 1], static_cast<T*>(nullptr));

    const T* vs = next_stage();  // V_t has landed
#pragma unroll
    for (int n = 0; n < NW; ++n) fence_regs(oacc[n]);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        // all the block's columns, zeros past D included: a branch here
        // would keep ptxas from pipelining the products
        const int col = wg * DW + 64 * n;
        Gmma<T>::rs64(oacc[n], pa[kt], gmma_desc(vs + (col / 64) * BK * 64 + kt * 16 * 64,
                                                 BK * 128, 1024));
      }
    wgmma_commit_wait();
#pragma unroll
    for (int n = 0; n < NW; ++n) fence_regs(oacc[n]);
  }
  // the other block may still read this one's partials
  if constexpr (Z > 1) cluster_sync();

  // O / l rounded once into the Q tile (free: both warpgroups passed the
  // last stage's barrier after their last S), laid out as copy_sw128 lays
  // out Q, then out along the rows in 16-byte chunks
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    const int row = row_a + 8 * r;
    if (lse != nullptr && wg == 0 && rank == 0 && (lane & 3) == 0 && q0 + row < Nq)
      lse[size_t(bh) * Nq + q0 + row] = (m_run[r] + log2f(l)) * kLn2;
  }
  uint16_t* ot = reinterpret_cast<uint16_t*>(qs);
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        const int c = (wg * DW + 64 * n) / 8 + j;  // the 16-byte chunk of the row
        *reinterpret_cast<uint32_t*>(ot + (c >> 3) * 64 * 64 + row * 64 +
                                     (((c & 7) ^ (row & 7)) << 3) + 2 * (lane & 3)) =
            pack2(oacc[n][4 * j + 2 * r] * inv[r], oacc[n][4 * j + 2 * r + 1] * inv[r],
                  static_cast<T*>(nullptr));
      }
  __syncthreads();
  store_sw128<64, DO>(o + b * so.b + h * so.h, so.n, ot, q0, Nq, c0, D, vec_out);
}

// ------------------------------------------------------------------ launch

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       dim3 grid, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                       Strides sv, Strides so, float scale, int vec, int vec_out,
                       cudaStream_t stream) {
  constexpr int LD = 64 * NC + 4;
  const size_t smem = (size_t(kBlockQ + 2 * kBlockK) * LD + size_t(kBlockK) * (kBlockQ + 4)) *
                      sizeof(float);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = set_smem(flash_fwd_kernel_f32<NC>, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  flash_fwd_kernel_f32<NC><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Nq, Nkv, D, sq, sk, sv,
      so, scale, vec, vec_out);
  return cudaGetLastError();
}

template <int BQ, int NCV>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                            dim3 grid, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                            Strides sv, Strides so, float scale, int vec, int vec_out,
                            cudaStream_t stream) {
  constexpr int smem = f32_wide_smem_bytes<BQ, NCV>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_smem(flash_fwd_kernel_f32_wide<BQ, NCV>, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  grid.y = (Nq + BQ - 1) / BQ;
  flash_fwd_kernel_f32_wide<BQ, NCV><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Nq, Nkv, D, sq, sk, sv,
      so, scale, vec, vec_out);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       dim3 grid, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                       Strides sv, Strides so, float scale, int vec, int vec_out,
                       cudaStream_t stream) {
  constexpr int LD = 64 * NC + 8;
  const size_t smem = size_t(kBlockQ + 2 * kBlockK) * LD * sizeof(T);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_smem(flash_fwd_kernel_mma<T, NC>, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  flash_fwd_kernel_mma<T, NC><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Nq, Nkv, D, sq, sk, sv, so, scale, vec, vec_out);
  return cudaGetLastError();
}

template <typename T, int NW, int Z>
cudaError_t launch_wgmma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                              dim3 grid, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                              Strides sv, Strides so, float scale, int granule, int vec_out,
                              cudaStream_t stream) {
  constexpr int smem = wide16_smem_bytes<NW, Z>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_smem(flash_fwd_kernel_wgmma_wide<T, NW, Z>, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  grid.y = (Nq + 63) / 64;
  grid.z = Z;
  if constexpr (Z == 1) {
    flash_fwd_kernel_wgmma_wide<T, NW, Z><<<grid, 256, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, H, Nq, Nkv, D, sq, sk, sv, so, scale, granule, vec_out);
  } else {  // the Z blocks of a query tile form a cluster
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = Z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, flash_fwd_kernel_wgmma_wide<T, NW, Z>, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, H, Nq, Nkv,
        D, sq, sk, sv, so, scale, granule, vec_out);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned bases and row/head/batch strides
  const long long es = sizeof(T);
  auto aligned = [es](const void* p, Strides s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * es) % 16 == 0 &&
           (s.h * es) % 16 == 0 && (s.n * es) % 16 == 0;
  };
  const int vec = aligned(q, sq) && aligned(k, sk) && aligned(v, sv);
  const int vec_out = aligned(o, so) && (D * es) % 16 == 0;
  dim3 grid(B * H, (Nq + kBlockQ - 1) / kBlockQ);
  const int nc = (D + 63) / 64;
#define FA_ARGS q, k, v, o, lse, grid, H, Nq, Nkv, D, sq, sk, sv, so, scale, vec, vec_out, stream
  if constexpr (sizeof(T) == 4) {
    if (D > kMaxD) {  // 64-row query tiles to D_pad = 512, 32 above
      switch ((D + 127) / 128) {
        case 3: return launch_f32_wide<64, 3>(FA_ARGS);
        case 4: return launch_f32_wide<64, 4>(FA_ARGS);
        case 5: return launch_f32_wide<32, 5>(FA_ARGS);
        case 6: return launch_f32_wide<32, 6>(FA_ARGS);
        case 7: return launch_f32_wide<32, 7>(FA_ARGS);
        default: return launch_f32_wide<32, 8>(FA_ARGS);
      }
    }
    switch (nc) {
      case 1: return launch_f32<1>(FA_ARGS);
      case 2: return launch_f32<2>(FA_ARGS);
      case 3: return launch_f32<3>(FA_ARGS);
      default: return launch_f32<4>(FA_ARGS);
    }
  } else {
    if (D > kMaxD) {  // 64-row query tiles on two warpgroups, the O columns split
      const int g = copy_granule(view_bits(q, sq.b, sq.h, sq.n) |
                                 view_bits(k, sk.b, sk.h, sk.n) | view_bits(v, sv.b, sv.h, sv.n));
#define FA_WIDE_ARGS q, k, v, o, lse, grid, H, Nq, Nkv, D, sq, sk, sv, so, scale, g, vec_out, stream
      if (D <= 384) return launch_wgmma_wide<T, 3, 1>(FA_WIDE_ARGS);
      if (D <= 512) return launch_wgmma_wide<T, 4, 1>(FA_WIDE_ARGS);
      if (D <= 768) return launch_wgmma_wide<T, 3, 2>(FA_WIDE_ARGS);
      return launch_wgmma_wide<T, 4, 2>(FA_WIDE_ARGS);
#undef FA_WIDE_ARGS
    }
    switch (nc) {
      case 1: return launch_mma<T, 1>(FA_ARGS);
      case 2: return launch_mma<T, 2>(FA_ARGS);
      case 3: return launch_mma<T, 3>(FA_ARGS);
      default: return launch_mma<T, 4>(FA_ARGS);
    }
  }
#undef FA_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in elements.
// lse: null, or (B*H, Nq) f32 contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int B, int H, int Nq, int Nkv, int D,
                                   long long sqb, long long sqh, long long sqn,
                                   long long skb, long long skh, long long skn,
                                   long long svb, long long svh, long long svn,
                                   long long sob, long long soh, long long son,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nkv < 1 || D < 1 || D > kMaxDWide)
    return int(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqn}, sk{skb, skh, skn}, sv{svb, svh, svn}, so{sob, soh, son};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return int(launch<float>(q, k, v, o, l, B, H, Nq, Nkv, D, sq, sk, sv, so, scale, s));
    case 1:
      return int(launch<__nv_bfloat16>(q, k, v, o, l, B, H, Nq, Nkv, D, sq, sk, sv, so, scale,
                                       s));
    case 2:
      return int(launch<__half>(q, k, v, o, l, B, H, Nq, Nkv, D, sq, sk, sv, so, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
