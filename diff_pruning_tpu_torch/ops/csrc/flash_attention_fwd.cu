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
//   operands from shared memory through `ldmatrix` (V with `.trans`), in the
//   FA2 register layout: S, the running max and sum stay in registers, and
//   P is rounded to the input type in registers, where its accumulator
//   layout is already the A operand of the PV product;
// - rows of 2*(D_pad + 8) bytes put the 8 rows of an ldmatrix on distinct
//   banks.
//
// Both paths:
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

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMaxD = 256;
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

// two f32 values as one 32-bit register of the input type, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// ----------------------------------------------------------- bf16/f16 path

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, __nv_bfloat16*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
  const dim3 grid(B * H, (Nq + kBlockQ - 1) / kBlockQ);
  const int nc = (D + 63) / 64;
#define FA_ARGS q, k, v, o, lse, grid, H, Nq, Nkv, D, sq, sk, sv, so, scale, vec, vec_out, stream
  if constexpr (sizeof(T) == 4) {
    switch (nc) {
      case 1: return launch_f32<1>(FA_ARGS);
      case 2: return launch_f32<2>(FA_ARGS);
      case 3: return launch_f32<3>(FA_ARGS);
      default: return launch_f32<4>(FA_ARGS);
    }
  } else {
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
  if (B < 1 || H < 1 || Nq < 1 || Nkv < 1 || D < 1 || D > kMaxD)
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
