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
// transformers and its first stage): 16-row query and kv tiles of the whole
// head dim; see its note below.
//
// bf16/f16 with 256 < D <= 1024 (`flash_fwd_kernel_mma_wide`, the same heads
// under bf16 training): 16 query rows and 32 kv rows a block on the tensor
// cores, the head dim split over the 8 warps; see its note below.
//
// All paths:
// - K and V tiles stream through a two-slot cp.async ring in the order
//   K0, V0, K1, V1, ...: while S = Q K_t^T is computed, V_t is in flight; once
//   K_t is consumed, K_{t+1} is issued and overlaps the softmax and P V_t;
// - the head dim is zero-filled in shared memory up to a multiple of 64
//   (cp.async's src-size), never in device memory; no per-element predicate
//   in the inner products; rows at or beyond Nq/Nkv are zero-filled, scores
//   of kv columns at or beyond Nkv are set to -inf; columns at or beyond D
//   are not written;
// - 16-byte cp.async where the head-split views allow it (base and strides
//   16-byte aligned), else element copies (4-byte cp.async for f32; plain
//   loads for 16-bit types, e.g. D = 179 views of a (B, N, 179) projection);
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
constexpr int kMaxDWide = 1024;  // flash_fwd_kernel_f32_wide, flash_fwd_kernel_mma_wide
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Copies rows [row0, row0 + ROWS) x columns [0, DP) of one head into shared
// memory (row stride ld elements), zero-filling rows >= nvalid and columns
// >= D. vec: base and row stride are 16-byte aligned.
template <typename T, int DP, int NT, int ROWS = 64>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long sn, int row0,
                                          int nvalid, int D, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T);
    constexpr int kPerRow = DP / kChunk;
    for (int idx = tid; idx < ROWS * kPerRow; idx += NT) {
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
    for (int idx = tid; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int row = row0 + r;
      const bool ok = row < nvalid && c < D;
      cp_async4(dst + r * ld + c, ok ? src + row * sn + c : src, ok ? 4 : 0);
    }
  } else {
    // no cp.async below 4 bytes: 8 loads in flight per thread, then stores
    static_assert(ROWS == 64, "the 16-bit element copy takes 64-row tiles");
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

// Wide head dims (the LDM's one-head transformers: D = 384, 576, 960, and
// the first stage's D = 512 at 4096 tokens). A 64-row f32 tile of D = 960
// alone is 245,760 bytes, more than a block's shared memory, so the tiles
// shrink instead: 16 query rows and 16 kv rows a block, each a whole row of
// the head dim (padded to DP = 128 * NC2, zero-filled), Q resident, K and V
// streamed through the same two-slot cp.async ring as above. At D = 1024:
// 3 * 16 * 1028 * 4 + 16 * 260 * 4 + 16 * 17 * 4 + 64 = 215,040 bytes.
// 16-row query tiles also give (64 tokens, B = 16, 2 CFG halves) 128 blocks
// for the 132 SMs, where splitting D across blocks would recompute QK^T.
//
// - S = Q K^T (16 x 16): thread t owns a 4 x 4 micro-tile (t / 16) of S and
//   one of 16 slices of the head dim (t % 16: float4 columns 4 (t % 16) +
//   64 k), so each step of 4 columns is 8 float4 loads for 64 FMAs; the 16
//   partial tiles are summed through shared memory (red, rows 260 floats
//   apart so the 16 slices' float4 stores land on distinct banks), in a
//   fixed order: no atomics;
// - softmax: thread t then owns S[t / 16][t % 16]; row max and sum combine
//   across the row's 16 lanes with shuffles; the row's rescale factor goes
//   to shared memory and P to ps ([kv][row], rows 17 floats apart);
// - O += P V: thread (ty = t / 32, tx = t % 32) owns rows ty and ty + 8 and
//   columns 4 tx + 128 c (c < NC2): per kv row, 2 broadcast loads of P and
//   NC2 float4 loads of V for 8 NC2 FMAs; at most 64 accumulators.
template <int NC2>  // head dim padded to 128 * NC2
__global__ void __launch_bounds__(256, 1)
flash_fwd_kernel_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Nq, int Nkv, int D, Strides sq,
                          Strides sk, Strides sv, Strides so, float scale, int vec,
                          int vec_out) {
  constexpr int BQ = 16, BK = 16;
  constexpr int DP = 128 * NC2;
  constexpr int LD = DP + 4;     // 16-byte rows, 4 banks apart
  constexpr int LDR = 256 + 4;   // one slice's partial S
  constexpr int LDP = BQ + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [16][LD] query rows
  float* ks = qs + BQ * LD;      // [16][LD] kv rows
  float* vs = ks + BK * LD;      // [16][LD] kv rows
  float* red = vs + BK * LD;     // [16 slices][LDR]: partial S, [row * 16 + kv]
  float* ps = red + 16 * LDR;    // [16 kv][LDP]: P[row][kv] at [kv][row]
  float* alpha_s = ps + BK * LDP;  // [16] each row's rescale factor, then its sum

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<float, DP, 256, BQ>(qs, LD, qb, sq.n, q0, Nq, D, vec);
  load_tile<float, DP, 256, BK>(ks, LD, kb, sk.n, 0, Nkv, D, vec);
  cp_async_commit();
  load_tile<float, DP, 256, BK>(vs, LD, vb, sv.n, 0, Nkv, D, vec);
  cp_async_commit();

  // S micro-tile and head-dim slice
  const int tile = tid >> 4;
  const int slice = tid & 15;
  const int tr = (tile >> 2) * 4;  // first query row of the micro-tile
  const int tc = (tile & 3) * 4;   // first kv row of the micro-tile
  // softmax element
  const int srow = tid >> 4;
  const int scol = tid & 15;
  float m_run = -INFINITY, l_run = 0.f;
  // O rows and columns
  const int ty = tid >> 5;
  const int tx = tid & 31;
  float acc[2][4 * NC2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC2; ++c) acc[i][c] = 0.f;

  for (int kv0 = 0; kv0 < Nkv; kv0 += BK) {
    cp_async_wait_1();  // Q and K_t have landed (V_t may be in flight)
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 4 * slice; d < DP; d += 64) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qf[i] = *reinterpret_cast<const float4*>(qs + (tr + i) * LD + d);
        kf[i] = *reinterpret_cast<const float4*>(ks + (tc + i) * LD + d);
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red + slice * LDR + (tr + i) * 16 + tc) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();  // every thread is done with K_t, and the partials are visible
    if (kv0 + BK < Nkv) load_tile<float, DP, 256, BK>(ks, LD, kb, sk.n, kv0 + BK, Nkv, D, vec);
    cp_async_commit();

    {
      float x = 0.f;
#pragma unroll
      for (int sl = 0; sl < 16; ++sl) x += red[sl * LDR + srow * 16 + scol];
      x = kv0 + scol < Nkv ? x * scale : -INFINITY;
      float tile_max = x;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // the first tile always holds a valid column, so m_new is finite
      const float m_new = fmaxf(m_run, tile_max);
      const float alpha = expf(m_run - m_new);
      const float p = expf(x - m_new);
      float psum = p;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      ps[scol * LDP + srow] = p;
      if (scol == 0) alpha_s[srow] = alpha;
    }

    cp_async_wait_1();  // V_t has landed (K_{t+1} may be in flight)
    __syncthreads();    // ... and P and the rescale factors are visible
    const float a0 = alpha_s[ty], a1 = alpha_s[ty + 8];
#pragma unroll
    for (int c = 0; c < 4 * NC2; ++c) {
      acc[0][c] *= a0;
      acc[1][c] *= a1;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p0 = ps[j * LDP + ty], p1 = ps[j * LDP + ty + 8];
#pragma unroll
      for (int c = 0; c < NC2; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + 128 * c + tx * 4);
        acc[0][4 * c + 0] = fmaf(p0, vv.x, acc[0][4 * c + 0]);
        acc[0][4 * c + 1] = fmaf(p0, vv.y, acc[0][4 * c + 1]);
        acc[0][4 * c + 2] = fmaf(p0, vv.z, acc[0][4 * c + 2]);
        acc[0][4 * c + 3] = fmaf(p0, vv.w, acc[0][4 * c + 3]);
        acc[1][4 * c + 0] = fmaf(p1, vv.x, acc[1][4 * c + 0]);
        acc[1][4 * c + 1] = fmaf(p1, vv.y, acc[1][4 * c + 1]);
        acc[1][4 * c + 2] = fmaf(p1, vv.z, acc[1][4 * c + 2]);
        acc[1][4 * c + 3] = fmaf(p1, vv.w, acc[1][4 * c + 3]);
      }
    }
    __syncthreads();  // every thread is done with V_t, P and the rescale factors
    if (kv0 + BK < Nkv) load_tile<float, DP, 256, BK>(vs, LD, vb, sv.n, kv0 + BK, Nkv, D, vec);
    cp_async_commit();
  }

  if (scol == 0) {
    alpha_s[srow] = l_run;
    if (lse != nullptr && q0 + srow < Nq) lse[size_t(bh) * Nq + q0 + srow] = m_run + logf(l_run);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + ty + 8 * i;
    if (qr >= Nq) continue;
    float* orow = o + b * so.b + h * so.h + qr * so.n;
    const float inv = 1.f / alpha_s[ty + 8 * i];
#pragma unroll
    for (int c = 0; c < NC2; ++c) {
      const int col = 128 * c + tx * 4;
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

// Wide 16-bit heads (the LDM's one-head transformers under bf16 training,
// D = 384, 576, 960 and the pruned 268, 404, 672; the first stage's D = 512
// at 4096 tokens). The 64-row kernel above keeps Q and a K and a V tile of
// 64 rows: (64 + 2 * 64) * (D_pad + 8) * 2 bytes passes a block's 227 KB near
// D = 600. This tiling takes 16 query rows (one m16 tile) and 32 kv rows a
// block, each a whole row of the head dim (padded to DP = 128 * NC2,
// zero-filled), 256 threads (8 warps):
// - each warp owns one eighth of the head dim (16 NC2 columns): Q's
//   fragments of its slice stay in registers for the whole kernel (4 NC2
//   registers), and it owns those columns of the O accumulator (8 NC2
//   floats a thread, at most 64), so no warp holds a whole 16 x 1024 row;
// - S = Q K_t^T: each warp forms the partial S of its slice (16 x 32, B
//   from K_t by ldmatrix), the 8 partials meet in shared memory (over the Q
//   tile, free once the fragments are in registers) and are summed in a
//   fixed order, no atomics; thread t then owns row t / 16, columns 2 (t %
//   16) .. +1 of S for the online softmax (log2 units; row max and sum by
//   shuffles across the row's 16 lanes), rounds p to the input type once and
//   writes it to a 16 x 32 tile with the row's rescale factor;
// - O += P V_t: A = P from that tile (ldmatrix), B = V_t (.trans), each warp
//   its own columns;
// - K and V stream through one slot each, as in the 64-row kernel: K_{t+1}
//   is issued once the partials are formed and overlaps the softmax and P
//   V_t; V_{t+1} once P V_t is done. What it gives up against the 64-row
//   kernel: a two-slot ring at 64 kv rows (264 KB at D = 1024), and Q's
//   reuse across 4 warps of query rows: every kv row is read from shared
//   memory once per 16 query rows;
// - copies in the widest chunk the views allow (copy_wide16 in
//   tensor_core.cuh): 16-byte cp.async for aligned views, 8 or 4 bytes for
//   the pruned widths' rows, 2-byte loads otherwise.
// Shared memory at D = 1024 in bf16: 16 * 1032 * 2 (Q, then the partials,
// then O) + 2 * 32 * 1032 * 2 (K, V) + 16 * 40 * 2 (P) + 32 * 4 = 166,528
// bytes, one block (8 warps) per SM; at D_pad = 384, 70,016 bytes.
constexpr int kWideQ16 = 16;   // query rows a block (wide 16-bit kernel)
constexpr int kWideKv16 = 32;  // kv rows a tile

template <typename T>
__host__ __device__ constexpr int wide16_front_bytes(int dp) {  // Q, or the partial S
  const int q = kWideQ16 * (dp + 8) * int(sizeof(T));
  const int red = 8 * kWideQ16 * (kWideKv16 + 4) * 4;
  return q > red ? q : red;
}

template <typename T, int NC2>  // head dim padded to 128 * NC2
__global__ void __launch_bounds__(256, 1)
flash_fwd_kernel_mma_wide(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                          Strides so, float scale, int granule, int vec_out) {
  constexpr int BQ = kWideQ16, BK = kWideKv16;
  constexpr int DP = 128 * NC2;
  constexpr int LD = DP + 8;    // rows 16 bytes apart modulo 128: ldmatrix conflict-free
  constexpr int WC = DP / 8;    // the warp's head-dim columns
  constexpr int KS = WC / 16;   // its k-steps of S (= NC2)
  constexpr int NT = WC / 8;    // its n-tiles of O (= 2 NC2)
  constexpr int LDS = BK + 4;   // partial S rows (f32)
  constexpr int LDP = BK + 8;   // P rows (16-bit)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // [16][LD] Q, at the end O
  float* red = reinterpret_cast<float*>(smem_raw);  // [8 warps][16][LDS] partial S
  T* ks = reinterpret_cast<T*>(smem_raw + wide16_front_bytes<T>(DP));  // [32][LD]
  T* vs = ks + BK * LD;                          // [32][LD]
  T* ps = vs + BK * LD;                          // [16][LDP] P of the kv tile
  float* rowf = reinterpret_cast<float*>(ps + BQ * LDP);  // [16] rescale, [16] row sums

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = warp * WC;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  copy_wide16<T, DP, BQ, 256>(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, D, granule);
  copy_wide16<T, DP, BK, 256>(ks, kb, sk.n, 0, Nkv, D, granule);
  cp_async_commit();
  copy_wide16<T, DP, BK, 256>(vs, vb, sv.n, 0, Nkv, D, granule);
  cp_async_commit();

  uint32_t qf[KS][4];  // Q's A fragments of the warp's slice
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // softmax: row rr, columns rc, rc + 1 of the tile; scores in log2 units
  const int rr = tid >> 4, rc = (tid & 15) * 2;
  float m_run = -INFINITY, l_run = 0.f;
  const float scale2 = scale * kLog2e;
  // ldmatrix addresses (as the 64-row kernel's): A rows lane % 16, column
  // half lane / 16; K rows lane % 8 + 8 (lane / 16) of a pair of n-tiles,
  // column half (lane / 8) % 2; V (.trans) rows lane % 8 + 8 ((lane / 8) %
  // 2), column half lane / 16
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8 + c0;
  const T* kl = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8 + c0;
  const T* vl = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8 + c0;
  const T* pl = ps + (lane & 15) * LDP + (lane >> 4) * 8;

  for (int kv0 = 0; kv0 < Nkv; kv0 += BK) {
    cp_async_wait_1();  // Q and K_t have landed (V_t may be in flight)
    __syncthreads();
    if (kv0 == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], qs + a_off + kk * 16);
      __syncthreads();  // every warp holds its fragments: the Q tile takes the partials
    }
    float sacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kl + np * 16 * LD + kk * 16);
        mma16816(sacc[2 * np], qf[kk], bf[0], bf[1], static_cast<T*>(nullptr));
        mma16816(sacc[2 * np + 1], qf[kk], bf[2], bf[3], static_cast<T*>(nullptr));
      }
    float* rw = red + warp * BQ * LDS + (lane >> 2) * LDS + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(rw + n * 8) = make_float2(sacc[n][0], sacc[n][1]);
      *reinterpret_cast<float2*>(rw + 8 * LDS + n * 8) = make_float2(sacc[n][2], sacc[n][3]);
    }
    __syncthreads();  // the partials are visible; every warp is done with K_t
    if (kv0 + BK < Nkv) copy_wide16<T, DP, BK, 256>(ks, kb, sk.n, kv0 + BK, Nkv, D, granule);
    cp_async_commit();

    {
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 8; ++w) {  // in a fixed order
        const float2 x = *reinterpret_cast<const float2*>(red + w * BQ * LDS + rr * LDS + rc);
        s.x += x.x;
        s.y += x.y;
      }
      s.x = kv0 + rc < Nkv ? s.x * scale2 : -INFINITY;
      s.y = kv0 + rc + 1 < Nkv ? s.y * scale2 : -INFINITY;
      float tile_max = fmaxf(s.x, s.y);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // the first tile always holds a valid column, so m_new is finite
      const float m_new = fmaxf(m_run, tile_max);
      const float alpha = exp2f(m_run - m_new);
      const float p0 = exp2f(s.x - m_new), p1 = exp2f(s.y - m_new);
      float psum = p0 + p1;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      *reinterpret_cast<uint32_t*>(ps + rr * LDP + rc) = pack2(p0, p1, static_cast<T*>(nullptr));
      if ((tid & 15) == 0) rowf[rr] = alpha;
    }

    cp_async_wait_1();  // V_t has landed (K_{t+1} may be in flight)
    __syncthreads();    // ... and P and the rescale factors are visible
    const float a0 = rowf[lane >> 2], a1 = rowf[(lane >> 2) + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, pl + kk * 16);
#pragma unroll
      for (int dc = 0; dc < NT / 2; ++dc) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vl + kk * 16 * LD + dc * 16);
        mma16816(oacc[2 * dc], pa, bf[0], bf[1], static_cast<T*>(nullptr));
        mma16816(oacc[2 * dc + 1], pa, bf[2], bf[3], static_cast<T*>(nullptr));
      }
    }
    __syncthreads();  // every warp is done with V_t, P and the rescale factors
    if (kv0 + BK < Nkv) copy_wide16<T, DP, BK, 256>(vs, vb, sv.n, kv0 + BK, Nkv, D, granule);
    cp_async_commit();
  }

  if ((tid & 15) == 0) {
    rowf[BQ + rr] = l_run;
    if (lse != nullptr && q0 + rr < Nq)
      lse[size_t(bh) * Nq + q0 + rr] = (m_run + log2f(l_run)) * kLn2;
  }
  __syncthreads();
  // O / l rounded once, through the Q tile (the partials are done with)
  const float i0 = 1.f / rowf[BQ + (lane >> 2)], i1 = 1.f / rowf[BQ + (lane >> 2) + 8];
  T* orow = qs + (lane >> 2) * LD + c0 + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(orow + n * 8) =
        pack2(oacc[n][0] * i0, oacc[n][1] * i0, static_cast<T*>(nullptr));
    *reinterpret_cast<uint32_t*>(orow + 8 * LD + n * 8) =
        pack2(oacc[n][2] * i1, oacc[n][3] * i1, static_cast<T*>(nullptr));
  }
  __syncthreads();
  store_wide16<BQ, LD, 256>(o + b * so.b + h * so.h, so.n, qs, q0, Nq, D, vec_out);
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

template <int NC2>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                            dim3 grid, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                            Strides sv, Strides so, float scale, int vec, int vec_out,
                            cudaStream_t stream) {
  constexpr int LD = 128 * NC2 + 4;
  const size_t smem = (size_t(3 * 16) * LD + 16 * (256 + 4) + 16 * 17 + 16) * sizeof(float);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_smem(flash_fwd_kernel_f32_wide<NC2>, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  flash_fwd_kernel_f32_wide<NC2><<<grid, 256, smem, stream>>>(
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

template <typename T, int NC2>
cudaError_t launch_mma_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                            dim3 grid, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                            Strides sv, Strides so, float scale, int granule, int vec_out,
                            cudaStream_t stream) {
  constexpr int LD = 128 * NC2 + 8;
  const size_t smem = wide16_front_bytes<T>(128 * NC2) +
                      size_t(2 * kWideKv16 * LD + kWideQ16 * (kWideKv16 + 8)) * sizeof(T) +
                      2 * kWideQ16 * sizeof(float);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_smem(flash_fwd_kernel_mma_wide<T, NC2>, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  flash_fwd_kernel_mma_wide<T, NC2><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Nq, Nkv, D, sq, sk, sv, so, scale, granule, vec_out);
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
    if (D > kMaxD) {  // 16-row tiles of the whole head dim
      grid.y = (Nq + 15) / 16;
      switch ((D + 127) / 128) {
        case 3: return launch_f32_wide<3>(FA_ARGS);
        case 4: return launch_f32_wide<4>(FA_ARGS);
        case 5: return launch_f32_wide<5>(FA_ARGS);
        case 6: return launch_f32_wide<6>(FA_ARGS);
        case 7: return launch_f32_wide<7>(FA_ARGS);
        default: return launch_f32_wide<8>(FA_ARGS);
      }
    }
    switch (nc) {
      case 1: return launch_f32<1>(FA_ARGS);
      case 2: return launch_f32<2>(FA_ARGS);
      case 3: return launch_f32<3>(FA_ARGS);
      default: return launch_f32<4>(FA_ARGS);
    }
  } else {
    if (D > kMaxD) {  // 16-row query tiles of the whole head dim
      grid.y = (Nq + kWideQ16 - 1) / kWideQ16;
      const int g = copy_granule(view_bits(q, sq.b, sq.h, sq.n) |
                                 view_bits(k, sk.b, sk.h, sk.n) | view_bits(v, sv.b, sv.h, sv.n));
#define FA_WIDE_ARGS q, k, v, o, lse, grid, H, Nq, Nkv, D, sq, sk, sv, so, scale, g, vec_out, stream
      switch ((D + 127) / 128) {
        case 3: return launch_mma_wide<T, 3>(FA_WIDE_ARGS);
        case 4: return launch_mma_wide<T, 4>(FA_WIDE_ARGS);
        case 5: return launch_mma_wide<T, 5>(FA_WIDE_ARGS);
        case 6: return launch_mma_wide<T, 6>(FA_WIDE_ARGS);
        case 7: return launch_mma_wide<T, 7>(FA_WIDE_ARGS);
        default: return launch_mma_wide<T, 8>(FA_WIDE_ARGS);
      }
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
