// Flash-attention backward (non-causal) for Hopper, sm_90a: two kernels.
//
// Replaces the TPU kernels of `_flash_bwd_call` in
// diff_pruning_tpu/ops/attention.py: `_bwd_dq_kernel` (dq part) and
// `_bwd_dkv_kernel` (dk/dv part). With the forward's per-row logsumexp lse
// and D = rowsum(dO * O):
//   p  = exp(s * scale - lse),  s = q k^T
//   ds = p * (dO v^T - D) * scale
//   dq = ds k,   dk = ds^T q,   dv = p^T dO
// never forming the Nq x Nkv matrices in device memory.
//
// What bounds it on the H100: at the UNet's shapes (N = 256 tokens, one head
// of D = 256) the dq kernel does 6*Nq*Nkv*D flops and the dk/dv kernel
// 8*Nq*Nkv*D against a few D-wide rows of bytes per token, so both are
// bound by arithmetic: the f32 CUDA-core rate (67 TFLOP/s). What keeps a
// kernel from it is feeding the FMA units: shared-memory loads per FMA, and
// copies that do not overlap the math. Both directions are split as the JAX
// package splits them, with no atomics anywhere, so every gradient is
// bit-reproducible from run to run.
//
// f32 (`flash_bwd_dkv_kernel_f32`, `flash_bwd_dq_kernel_f32`): exact f32 on
// the CUDA cores (no TF32, no tensor cores), on the forward's f32 design
// (flash_attention_fwd.cu): rows of D_pad + 4 floats (the head dim
// zero-filled in shared memory), float4 loads along d into register
// micro-tiles, cp.async copies, no per-column predicate in any inner
// product. A warp's 16-byte shared load delivers 512 bytes at 128 bytes a
// cycle, so each phase is sized for FMAs per float loaded:
// - scores (S = Q K^T and dP = dO V^T, 64 q x 32 kv per tile, both
//   kernels, `score_tile`): warp w owns q rows w + 8i, lane l kv rows
//   (l & 7) + 8j, an 8 x 4 micro-tile (12 float4 loads feed 128 FMAs); the
//   4 lanes l >> 3 split d and two xor shuffles reduce-scatter their
//   partials in a fixed order, leaving each lane 2 x 4 finished scores;
// - dk/dv: one block of 256 threads per (batch*head, 32-row kv tile); K and
//   V resident, Q and dO streamed in 64-row tiles, one slot each. P and dS
//   pass through shared memory so that a thread's 4 kv rows (w + 8r) are one
//   float4; it owns 4 kv rows x 8 columns (l*4 + 128c) of dK and of dV (64
//   accumulators; the head dim padded to a multiple of 128): 3 float4 loads
//   per 32 FMAs. Order within a q tile: S = Q_t K^T (dO_t in flight), dP =
//   dO_t V^T, P and dS, dK += dS^T Q_t, then Q_{t+1} is issued and overlaps
//   dV += P^T dO_t, then dO_{t+1} overlaps the next S;
// - dq: one block per (batch*head, 64-row q tile); Q and dO resident, K and
//   V streamed in 32-row tiles, one slot each. A thread owns 4 rows x 16
//   columns of dq (the forward's O layout), its 4 rows of dS one float4 (5
//   float4 loads per 64 FMAs). The prologue forms D = rowsum(dO * O) from
//   the resident dO (16 lanes a row, shuffles) and writes `dsum`. Order per
//   kv tile: dP = dO V_t^T, then V_{t+1} is issued; S = Q K_t^T; dS; dq +=
//   dS K_t, then K_{t+1} is issued and overlaps the next dP;
// - 16-byte cp.async where the head-split views allow it (base and strides
//   16-byte aligned), else 4-byte cp.async (D = 179 views of a (B, N, 179)
//   projection); rows at or beyond Nq/Nkv are zero-filled and their p set
//   to exactly 0; columns at or beyond D are not written.
// Shared memory at D = 256: dk/dv (2 * 32 + 2 * 64) * 260 * 4 + 2 * 64 * 36
// * 4 + 2 * 64 * 4 = 218,624 bytes, dq (2 * 64 + 2 * 32) * 260 * 4 + 32 * 68
// * 4 + 2 * 64 * 4 = 208,896: one block (8 warps) per SM; the launcher
// raises the limit.
//
// bf16/f16 (`flash_bwd_dq_kernel<T>`, `flash_bwd_dkv_kernel<T>`), the first
// design, kept for the 16-bit inputs until their tensor-core version, all
// math in f32 on the CUDA cores from f32 copies in shared memory:
// - dq: one block of 256 threads per (batch*head, 32-row q tile), looping
//   over 32-row kv tiles. Each q row belongs to 8 neighbouring lanes of one
//   warp; a lane scores its row against kv columns e + 8j and owns dq
//   columns e + 8i (32 f32 accumulators, any D <= 256 masked to the loaded
//   width). Its prologue forms D = rowsum(dO * O) for its rows (a shuffle
//   over the 8 lanes) and writes it to `dsum` for the dk/dv kernel.
// - dk/dv: one block of 256 threads per (batch*head, 32-row kv tile),
//   looping over 32-row q tiles. Each kv row belongs to 8 lanes; a lane
//   scores its kv row against q rows e + 8m and owns dk and dv columns
//   e + 8t: 2 x 32 f32 accumulators, where 4 lanes per row (64 columns
//   each, as the forward) would need 128 and spill at D = 256.
// - Q, dO, K, V tiles live in shared memory as f32 with an odd row stride
//   (no bank conflicts); p and ds tiles (32 x 33) pass a row's values
//   between its own 8 lanes (__syncwarp).
// - q rows at or beyond Nq and kv rows at or beyond Nkv are loaded as zeros
//   and their p is set to 0, so they contribute exactly zero to every
//   gradient (the TPU kernels' padding rule); they are not written.
// Shared memory at D = 256: 4 * 32 * 257 * 4 + (p, ds) tiles + 2 * 32 * 4
// = 140,288 bytes (dk/dv), 135,808 (dq); the launcher raises the limit.
//
// q, k, v, o, dO and the outputs are addressed as [b][h][n][d] through
// element strides (d contiguous); lse and dsum are contiguous (B*H, Nq) f32.
// The C entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // q rows and kv rows per tile
constexpr int kLanes = 8;                 // lanes per row
constexpr int kThreads = kTile * kLanes;  // 256
constexpr int kMaxD = 256;
constexpr int kColsPerLane = kMaxD / kLanes;  // 32
constexpr int kPerLane = kTile / kLanes;      // 4 scores per lane per tile
constexpr int kLdp = kTile + 1;               // p / ds tile row stride

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct Strides {
  long long b, h, n;
};

// rows [r0, r0 + kTile) of a [n][d] slab -> f32 shared tile, zeros past n_valid
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride_n,
                                         int r0, int n_valid, int D, int ld, int tid) {
  for (int idx = tid; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int gr = r0 + r;
    dst[r * ld + c] = gr < n_valid ? to_f32(src[gr * stride_n + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dsum, T* __restrict__ dq,
                    int H, int Nq, int Nkv, int D, int ld,
                    Strides sq, Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;             // kTile x ld
  float* dos = qs + kTile * ld;  // kTile x ld
  float* ks = dos + kTile * ld;  // kTile x ld
  float* vs = ks + kTile * ld;   // kTile x ld
  float* dss = vs + kTile * ld;  // kTile x kLdp

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;  // this lane's q row in the tile
  const int e = tid % kLanes;
  const int qr = q0 + row;
  const bool valid = qr < Nq;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  load_tile(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, D, ld, tid);
  load_tile(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, Nq, D, ld, tid);
  __syncthreads();

  // D = rowsum(dO * O) for this row, over the 8 lanes
  float drow = 0.f;
  if (valid) {
    const T* orow = o + b * so.b + h * so.h + qr * so.n;
    for (int c = e; c < D; c += kLanes) drow = fmaf(dos[row * ld + c], to_f32(orow[c]), drow);
  }
  drow += __shfl_xor_sync(0xffffffffu, drow, 1);
  drow += __shfl_xor_sync(0xffffffffu, drow, 2);
  drow += __shfl_xor_sync(0xffffffffu, drow, 4);
  const size_t lrow = size_t(bh) * Nq + qr;
  if (valid && e == 0) dsum[lrow] = drow;
  const float lse_row = valid ? lse[lrow] : 0.f;

  float acc[kColsPerLane];
#pragma unroll
  for (int i = 0; i < kColsPerLane; ++i) acc[i] = 0.f;
  const float* qrow = qs + row * ld;
  const float* dorow = dos + row * ld;
  float* dsrow = dss + row * kLdp;

  for (int kv0 = 0; kv0 < Nkv; kv0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile(ks, kb, sk.n, kv0, Nkv, D, ld, tid);
    load_tile(vs, vb, sv.n, kv0, Nkv, D, ld, tid);
    __syncthreads();

    // s and dO v^T of this row against kv columns e + 8j
    float s[kPerLane], dp[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = qrow[c];
      const float dov = dorow[c];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        s[j] = fmaf(qv, ks[(e + kLanes * j) * ld + c], s[j]);
        dp[j] = fmaf(dov, vs[(e + kLanes * j) * ld + c], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int col = kv0 + e + kLanes * j;
      const float p = (valid && col < Nkv) ? expf(s[j] * scale - lse_row) : 0.f;
      dsrow[e + kLanes * j] = p * (dp[j] - drow) * scale;
    }
    __syncwarp();  // a row's ds values are written and read by its own 8 lanes

    for (int j = 0; j < kTile; ++j) {
      const float ds = dsrow[j];
      const float* krow = ks + j * ld;
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const int c = e + kLanes * i;
        if (c < D) acc[i] = fmaf(ds, krow[c], acc[i]);
      }
    }
  }

  if (valid) {
    T* out = dq + b * sdq.b + h * sdq.h + qr * sdq.n;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = e + kLanes * i;
      if (c < D) out[c] = from_f32<T>(acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Nq, int Nkv, int D, int ld,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     float scale) {
  extern __shared__ float smem[];
  float* ks = smem;              // kTile x ld
  float* vs = ks + kTile * ld;   // kTile x ld
  float* qs = vs + kTile * ld;   // kTile x ld
  float* dos = qs + kTile * ld;  // kTile x ld
  float* ps = dos + kTile * ld;  // kTile x kLdp
  float* dss = ps + kTile * kLdp;  // kTile x kLdp
  float* lses = dss + kTile * kLdp;  // kTile
  float* dsums = lses + kTile;       // kTile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;  // this lane's kv row in the tile
  const int e = tid % kLanes;
  const int kr = kv0 + row;
  const bool valid = kr < Nkv;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  load_tile(ks, k + b * sk.b + h * sk.h, sk.n, kv0, Nkv, D, ld, tid);
  load_tile(vs, v + b * sv.b + h * sv.h, sv.n, kv0, Nkv, D, ld, tid);

  float acc_k[kColsPerLane], acc_v[kColsPerLane];
#pragma unroll
  for (int i = 0; i < kColsPerLane; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float* krow = ks + row * ld;
  const float* vrow = vs + row * ld;
  float* prow = ps + row * kLdp;
  float* dsrow = dss + row * kLdp;

  for (int q0 = 0; q0 < Nq; q0 += kTile) {
    __syncthreads();  // K/V are loaded; the previous Q/dO tile is consumed
    load_tile(qs, qb, sq.n, q0, Nq, D, ld, tid);
    load_tile(dos, dob, sdo.n, q0, Nq, D, ld, tid);
    if (tid < kTile) {
      const int qi = q0 + tid;
      lses[tid] = qi < Nq ? lse[size_t(bh) * Nq + qi] : 0.f;
      dsums[tid] = qi < Nq ? dsum[size_t(bh) * Nq + qi] : 0.f;
    }
    __syncthreads();

    // s and dO v^T of q rows e + 8m against this kv row
    float s[kPerLane], dp[kPerLane];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) s[m] = dp[m] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kv = krow[c];
      const float vv = vrow[c];
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        s[m] = fmaf(qs[(e + kLanes * m) * ld + c], kv, s[m]);
        dp[m] = fmaf(dos[(e + kLanes * m) * ld + c], vv, dp[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int i = e + kLanes * m;
      const float p = (valid && q0 + i < Nq) ? expf(s[m] * scale - lses[i]) : 0.f;
      prow[i] = p;
      dsrow[i] = p * (dp[m] - dsums[i]) * scale;
    }
    __syncwarp();  // a row's p and ds values are written and read by its own 8 lanes

    for (int i = 0; i < kTile; ++i) {
      const float p = prow[i];
      const float ds = dsrow[i];
      const float* qrow = qs + i * ld;
      const float* dorow = dos + i * ld;
#pragma unroll
      for (int t = 0; t < kColsPerLane; ++t) {
        const int c = e + kLanes * t;
        if (c < D) {
          acc_v[t] = fmaf(p, dorow[c], acc_v[t]);
          acc_k[t] = fmaf(ds, qrow[c], acc_k[t]);
        }
      }
    }
  }

  if (valid) {
    T* dkrow = dk + b * sdk.b + h * sdk.h + kr * sdk.n;
    T* dvrow = dv + b * sdv.b + h * sdv.h + kr * sdv.n;
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int c = e + kLanes * t;
      if (c < D) {
        dkrow[c] = from_f32<T>(acc_k[t]);
        dvrow[c] = from_f32<T>(acc_v[t]);
      }
    }
  }
}

// ---------------------------------------------------------------- f32 path

constexpr int kQRows = 64;   // q rows per tile (f32 kernels)
constexpr int kKvRows = 32;  // kv rows per tile (f32 kernels)
constexpr int kLdt = 68;     // row stride of dq's dS exchange tile: 64 + 4
constexpr int kLdk = 36;     // row stride of dk/dv's P and dS exchange tiles: 32 + 4

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
// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copy of rows [row0, row0 + ROWS) x columns [0, DP) of one head
// into shared memory (row stride LD floats), zero-filling rows >= nvalid and
// columns >= D. vec: base and row stride are 16-byte aligned.
template <int DP, int ROWS>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, long long sn, int row0,
                                          int nvalid, int D, bool vec) {
  constexpr int LD = DP + 4;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kPerRow = DP / 4;
    for (int idx = tid; idx < ROWS * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow;
      const int c = (idx - r * kPerRow) * 4;
      const int row = row0 + r;
      int bytes = 0;
      const float* from = src;
      if (row < nvalid && c < D) {
        bytes = (D - c >= 4 ? 4 : D - c) * 4;
        from = src + row * sn + c;
      }
      cp_async16(dst + r * LD + c, from, bytes);
    }
  } else {
    for (int idx = tid; idx < ROWS * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int row = row0 + r;
      const bool ok = row < nvalid && c < D;
      cp_async4(dst + r * LD + c, ok ? src + row * sn + c : src, ok ? 4 : 0);
    }
  }
}

// 64 values of a contiguous (B*H, Nq) f32 row array from q row q0, zeros past Nq
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int q0, int Nq) {
  const int t = threadIdx.x;
  if (t < kQRows) {
    const bool ok = q0 + t < Nq;
    cp_async4(dst + t, ok ? src + q0 + t : src, ok ? 4 : 0);
  }
}

// acc[r][4c..4c+3] += a[r] * b[c] for a thread's rows r and float4s c
template <int R, int NC>
__device__ __forceinline__ void fma_rows(float (&acc)[R][4 * NC], const float (&a)[R],
                                         const float4 (&b)[NC]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[r][4 * c + 0] = fmaf(a[r], b[c].x, acc[r][4 * c + 0]);
      acc[r][4 * c + 1] = fmaf(a[r], b[c].y, acc[r][4 * c + 1]);
      acc[r][4 * c + 2] = fmaf(a[r], b[c].z, acc[r][4 * c + 2]);
      acc[r][4 * c + 3] = fmaf(a[r], b[c].w, acc[r][4 * c + 3]);
    }
}

// The 64 x 32 score tile <A row, B row> of 64 rows of A and 32 rows of B
// over the first dk columns (a multiple of 16; zeros beyond D). Warp w,
// lane l: rows w + 8i of A (i < 8) and rows (l & 7) + 8j of B (j < 4), so
// an 8 x 4 register micro-tile feeds 128 FMAs from 12 float4 loads; the 4
// lanes l >> 3 split the columns (d = 4 (l >> 3) + 16 m) and two xor
// shuffles (16, then 8) sum their partials in a fixed order, leaving each
// lane out[ii][j] for A row w + 16 (l >> 3) + 8 ii and B row (l & 7) + 8j.
template <int LD>
__device__ __forceinline__ void score_tile(float (&out)[2][4], const float* a, const float* b,
                                           int dk) {
  const int lane = threadIdx.x & 31;
  const float* ar = a + (threadIdx.x >> 5) * LD;
  const float* br = b + (lane & 7) * LD;
  float s[8][4] = {};
#pragma unroll 2
  for (int d = 4 * (lane >> 3); d < dk; d += 16) {
    float4 af[8], bf[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) af[i] = *reinterpret_cast<const float4*>(ar + 8 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j] = *reinterpret_cast<const float4*>(br + 8 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(af[i].x, bf[j].x, s[i][j]);
        s[i][j] = fmaf(af[i].y, bf[j].y, s[i][j]);
        s[i][j] = fmaf(af[i].z, bf[j].z, s[i][j]);
        s[i][j] = fmaf(af[i].w, bf[j].w, s[i][j]);
      }
  }
  const bool hi2 = lane & 16, hi1 = lane & 8;
  float t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // lanes with bit 4 keep rows i + 4
      const float give = hi2 ? s[i][j] : s[i + 4][j];
      t[i][j] = (hi2 ? s[i + 4][j] : s[i][j]) + __shfl_xor_sync(0xffffffffu, give, 16);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // lanes with bit 3 keep rows i + 2 of those
      const float give = hi1 ? t[i][j] : t[i + 2][j];
      out[i][j] = (hi1 ? t[i + 2][j] : t[i][j]) + __shfl_xor_sync(0xffffffffu, give, 8);
    }
}

// rows row0 + rb + rs*r, columns cb + cs*c .. +3 of a register tile to
// device memory, rows < nvalid and columns < D
template <int R, int NC>
__device__ __forceinline__ void store_tile(float* base, long long sn, int row0, int nvalid,
                                           int D, bool vec_out, const float (&acc)[R][4 * NC],
                                           int rb, int rs, int cb, int cs) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + rb + rs * r;
    if (row >= nvalid) continue;
    float* out = base + row * sn;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cb + cs * c;
      if (vec_out && col < D) {  // D % 4 == 0: the whole float4 is in range
        *reinterpret_cast<float4*>(out + col) =
            make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2], acc[r][4 * c + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) out[col + e] = acc[r][4 * c + e];
      }
    }
  }
}

template <int NC>  // head dim padded to 128 * NC
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Nq, int Nkv,
                         int D, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale, int vec, int vec_out) {
  constexpr int DP = 128 * NC;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [32][LD]  kv rows (resident)
  float* vs = ks + kKvRows * LD;      // [32][LD]
  float* qs = vs + kKvRows * LD;      // [64][LD]  q rows (streamed)
  float* dos = qs + kQRows * LD;      // [64][LD]
  float* ps = dos + kQRows * LD;      // [64 q][kLdk]: P[i][c] at [i][(c & 7) * 4 + c / 8]
  float* dss = ps + kQRows * kLdk;    // [64 q][kLdk]: dS, the same layout
  float* lses = dss + kQRows * kLdk;  // [64]
  float* dsums = lses + kQRows;       // [64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.y * kKvRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + size_t(bh) * Nq;
  const float* db = dsum + size_t(bh) * Nq;

  copy_tile<DP, kKvRows>(ks, k + b * sk.b + h * sk.h, sk.n, kv0, Nkv, D, vec);
  copy_tile<DP, kKvRows>(vs, v + b * sv.b + h * sv.h, sv.n, kv0, Nkv, D, vec);
  copy_tile<DP, kQRows>(qs, qb, sq.n, 0, Nq, D, vec);
  copy_rows(lses, lb, 0, Nq);
  copy_rows(dsums, db, 0, Nq);
  cp_async_commit();
  copy_tile<DP, kQRows>(dos, dob, sdo.n, 0, Nq, D, vec);
  cp_async_commit();

  // dK and dV: kv rows warp + 8r (r < 4), columns lane * 4 + 128c
  float acc_k[4][4 * NC], acc_v[4][4 * NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  const int dk16 = (D + 15) & ~15;  // columns beyond D are zeros

  for (int q0 = 0; q0 < Nq; q0 += kQRows) {
    const bool more = q0 + kQRows < Nq;
    cp_async_wait<1>();  // K, V, Q_t and its lse/dsum have landed (dO_t may be in flight)
    __syncthreads();
    float s[2][4], dp[2][4];
    score_tile<LD>(s, qs, ks, dk16);  // S = Q_t K^T
    cp_async_wait<0>();               // dO_t has landed
    __syncthreads();
    score_tile<LD>(dp, dos, vs, dk16);  // dP = dO_t V^T
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int i = warp + 16 * (lane >> 3) + 8 * ii;  // q row in the tile
      const bool q_ok = q0 + i < Nq;
      const float l = lses[i], dd = dsums[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (lane & 7) + 8 * j;  // kv row in the tile
        const float p = q_ok && kv0 + c < Nkv ? expf(s[ii][j] * scale - l) : 0.f;
        ps[i * kLdk + (lane & 7) * 4 + j] = p;
        dss[i * kLdk + (lane & 7) * 4 + j] = p * (dp[ii][j] - dd) * scale;
      }
    }
    __syncthreads();  // P and dS are visible to every thread

#pragma unroll 4
    for (int i = 0; i < kQRows; ++i) {  // dK += dS^T Q_t
      const float4 d4 = *reinterpret_cast<const float4*>(dss + i * kLdk + warp * 4);
      float4 qf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        qf[c] = *reinterpret_cast<const float4*>(qs + i * LD + 128 * c + lane * 4);
      const float a[4] = {d4.x, d4.y, d4.z, d4.w};
      fma_rows<4, NC>(acc_k, a, qf);
    }
    __syncthreads();  // every thread is done with Q_t and its lse/dsum
    if (more) {
      copy_tile<DP, kQRows>(qs, qb, sq.n, q0 + kQRows, Nq, D, vec);
      copy_rows(lses, lb, q0 + kQRows, Nq);
      copy_rows(dsums, db, q0 + kQRows, Nq);
    }
    cp_async_commit();

#pragma unroll 4
    for (int i = 0; i < kQRows; ++i) {  // dV += P^T dO_t
      const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kLdk + warp * 4);
      float4 df[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        df[c] = *reinterpret_cast<const float4*>(dos + i * LD + 128 * c + lane * 4);
      const float a[4] = {p4.x, p4.y, p4.z, p4.w};
      fma_rows<4, NC>(acc_v, a, df);
    }
    __syncthreads();  // every thread is done with dO_t and P
    if (more) copy_tile<DP, kQRows>(dos, dob, sdo.n, q0 + kQRows, Nq, D, vec);
    cp_async_commit();
  }

  store_tile<4, NC>(dk + b * sdk.b + h * sdk.h, sdk.n, kv0, Nkv, D, vec_out, acc_k, warp, 8,
                    lane * 4, 128);
  store_tile<4, NC>(dv + b * sdv.b + h * sdv.h, sdv.n, kv0, Nkv, D, vec_out, acc_v, warp, 8,
                    lane * 4, 128);
}

template <int NC>  // head dim padded to 64 * NC
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dsum, float* __restrict__ dq, int H, int Nq,
                        int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                        Strides sdo, Strides sdq, float scale, int vec, int vec_out) {
  constexpr int DP = 64 * NC;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [64][LD]  q rows (resident)
  float* dos = qs + kQRows * LD;   // [64][LD]
  float* ks = dos + kQRows * LD;   // [32][LD]  kv rows (streamed)
  float* vs = ks + kKvRows * LD;   // [32][LD]
  float* dss = vs + kKvRows * LD;  // [32 kv][kLdt]: dS[r][j] at [j][(r % 16) * 4 + r / 16]
  float* drows = dss + kKvRows * kLdt;  // [64] D = rowsum(dO * O)
  float* lrows = drows + kQRows;        // [64] lse

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kQRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  copy_tile<DP, kQRows>(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, D, vec);
  copy_tile<DP, kQRows>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, Nq, D, vec);
  copy_tile<DP, kKvRows>(vs, vb, sv.n, 0, Nkv, D, vec);
  cp_async_commit();
  copy_tile<DP, kKvRows>(ks, kb, sk.n, 0, Nkv, D, vec);
  cp_async_commit();

  // D = rowsum(dO * O) and lse of the tile's rows: row r by the 16 lanes
  // (threadIdx.x >> 4) == r % 16 of one warp, combined by shuffles
  cp_async_wait<1>();  // Q, dO and V_0 have landed (K_0 may be in flight)
  __syncthreads();
  const float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 4) + 16 * i;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Nq)
      for (int c = threadIdx.x & 15; c < D; c += 16)
        acc = fmaf(dos[r * LD + c], ob[row * so.n + c], acc);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 15) == 0) {
      drows[r] = acc;
      lrows[r] = row < Nq ? lse[size_t(bh) * Nq + row] : 0.f;
      if (row < Nq) dsum[size_t(bh) * Nq + row] = acc;
    }
  }
  // (the first __syncthreads of the loop makes drows and lrows visible)

  // dq: rows ty + 16i (i < 4), columns tx * 4 + 64c
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  const int dk16 = (D + 15) & ~15;  // columns beyond D are zeros

  for (int kv0 = 0; kv0 < Nkv; kv0 += kKvRows) {
    const bool more = kv0 + kKvRows < Nkv;
    cp_async_wait<1>();  // V_t has landed (K_t may be in flight)
    __syncthreads();
    float dp[2][4], s[2][4];
    score_tile<LD>(dp, dos, vs, dk16);  // dP = dO V_t^T
    __syncthreads();  // every thread is done with V_t: its slot takes V_{t+1}
    if (more) copy_tile<DP, kKvRows>(vs, vb, sv.n, kv0 + kKvRows, Nkv, D, vec);
    cp_async_commit();
    cp_async_wait<1>();  // K_t has landed (V_{t+1} may be in flight)
    __syncthreads();
    score_tile<LD>(s, qs, ks, dk16);  // S = Q K_t^T
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = warp + 16 * (lane >> 3) + 8 * ii;  // q row in the tile
      const bool q_ok = q0 + r < Nq;
      const float l = lrows[r], dd = drows[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (lane & 7) + 8 * j;  // kv row in the tile
        const float p = q_ok && kv0 + c < Nkv ? expf(s[ii][j] * scale - l) : 0.f;
        dss[c * kLdt + (r & 15) * 4 + (r >> 4)] = p * (dp[ii][j] - dd) * scale;
      }
    }
    __syncthreads();  // dS is visible to every thread

#pragma unroll 4
    for (int j = 0; j < kKvRows; ++j) {  // dq += dS K_t
      const float4 d4 = *reinterpret_cast<const float4*>(dss + j * kLdt + ty * 4);
      float4 kf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kf[c] = *reinterpret_cast<const float4*>(ks + j * LD + 64 * c + tx * 4);
      const float a[4] = {d4.x, d4.y, d4.z, d4.w};
      fma_rows<4, NC>(acc, a, kf);
    }
    __syncthreads();  // every thread is done with K_t and dS
    if (more) copy_tile<DP, kKvRows>(ks, kb, sk.n, kv0 + kKvRows, Nkv, D, vec);
    cp_async_commit();
  }

  store_tile<4, NC>(dq + b * sdq.b + h * sdq.h, sdq.n, q0, Nq, D, vec_out, acc, ty, 16, tx * 4,
                    64);
}

size_t dq_smem_f32(int nc) {
  return (size_t(2 * kQRows + 2 * kKvRows) * (64 * nc + 4) + size_t(kKvRows) * kLdt +
          2 * kQRows) * sizeof(float);
}

size_t dkv_smem_f32(int nc) {
  return (size_t(2 * kKvRows + 2 * kQRows) * (128 * nc + 4) + size_t(2 * kQRows) * kLdk +
          2 * kQRows) * sizeof(float);
}

size_t dq_smem(int ld) { return (size_t(4 * kTile) * ld + size_t(kTile) * kLdp) * sizeof(float); }
size_t dkv_smem(int ld) {
  return (size_t(4 * kTile) * ld + size_t(2 * kTile) * kLdp + 2 * kTile) * sizeof(float);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* dsum, void* dq, int B, int H,
                      int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                      Strides sdo, Strides sdq, float scale, cudaStream_t stream) {
  const int ld = D | 1;  // odd row stride: rows fall on distinct banks
  const size_t smem = dq_smem(ld);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Nq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq),
      H, Nq, Nkv, D, ld, sq, sk, sv, so, sdo, sdq, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dsum, void* dk, void* dv, int B, int H,
                       int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdk, Strides sdv, float scale, cudaStream_t stream) {
  const int ld = D | 1;
  const size_t smem = dkv_smem(ld);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Nkv + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Nq, Nkv, D, ld, sq, sk, sv, sdo, sdk, sdv, scale);
  return cudaGetLastError();
}

// 16-byte copies need 16-byte aligned bases and row/head/batch strides
bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * 4) % 16 == 0 &&
         (s.h * 4) % 16 == 0 && (s.n * 4) % 16 == 0;
}

template <int NC>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* dsum, void* dq, int B,
                          int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                          Strides so, Strides sdo, Strides sdq, float scale,
                          cudaStream_t stream) {
  const size_t smem = dq_smem_f32(NC);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel_f32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int vec = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
                  aligned16(dout, sdo);
  const int vec_out = aligned16(dq, sdq) && D % 4 == 0;
  const dim3 grid(B * H, (Nq + kQRows - 1) / kQRows);
  flash_bwd_dq_kernel_f32<NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, dsum,
      static_cast<float*>(dq), H, Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale, vec, vec_out);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dsum, void* dk, void* dv, int B,
                           int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                           Strides sdo, Strides sdk, Strides sdv, float scale,
                           cudaStream_t stream) {
  const size_t smem = dkv_smem_f32(NC);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel_f32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int vec = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
                  aligned16(dout, sdo);
  const int vec_out = aligned16(dk, sdk) && aligned16(dv, sdv) && D % 4 == 0;
  const dim3 grid(B * H, (Nkv + kKvRows - 1) / kKvRows);
  flash_bwd_dkv_kernel_f32<NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Nq, Nkv, D, sq, sk, sv, sdo, sdk, sdv, scale, vec, vec_out);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Nq, int Nkv, int D) {
  return B < 1 || H < 1 || Nq < 1 || Nkv < 1 || D < 1 || D > kMaxD;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in elements.
// Writes dq and dsum = rowsum(dO * O), (B*H, Nq) f32, which
// flash_attention_bwd_dkv reads: launch it after this one on the same stream.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dsum, void* dq, int dtype, int B, int H, int Nq,
                                      int Nkv, int D, long long sqb, long long sqh,
                                      long long sqn, long long skb, long long skh,
                                      long long skn, long long svb, long long svh,
                                      long long svn, long long sob, long long soh,
                                      long long son, long long sdob, long long sdoh,
                                      long long sdon, long long sdqb, long long sdqh,
                                      long long sdqn, float scale, void* stream) {
  if (bad_shape(B, H, Nq, Nkv, D)) return int(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqn}, sk{skb, skh, skn}, sv{svb, svh, svn}, so{sob, soh, son},
      sdo{sdob, sdoh, sdon}, sdq{sdqb, sdqh, sdqn};
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ_ARGS q, k, v, o, dout, l, ds, dq, B, H, Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale, s
  switch (dtype) {
    case 0:
      switch ((D + 63) / 64) {
        case 1: return int(launch_dq_f32<1>(DQ_ARGS));
        case 2: return int(launch_dq_f32<2>(DQ_ARGS));
        case 3: return int(launch_dq_f32<3>(DQ_ARGS));
        default: return int(launch_dq_f32<4>(DQ_ARGS));
      }
    case 1:
      return int(launch_dq<__nv_bfloat16>(q, k, v, o, dout, l, ds, dq, B, H, Nq, Nkv, D, sq,
                                          sk, sv, so, sdo, sdq, scale, s));
    case 2:
      return int(launch_dq<__half>(q, k, v, o, dout, l, ds, dq, B, H, Nq, Nkv, D, sq, sk, sv,
                                   so, sdo, sdq, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
#undef DQ_ARGS
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dsum,
                                       void* dk, void* dv, int dtype, int B, int H, int Nq,
                                       int Nkv, int D, long long sqb, long long sqh,
                                       long long sqn, long long skb, long long skh,
                                       long long skn, long long svb, long long svh,
                                       long long svn, long long sdob, long long sdoh,
                                       long long sdon, long long sdkb, long long sdkh,
                                       long long sdkn, long long sdvb, long long sdvh,
                                       long long sdvn, float scale, void* stream) {
  if (bad_shape(B, H, Nq, Nkv, D)) return int(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqn}, sk{skb, skh, skn}, sv{svb, svh, svn},
      sdo{sdob, sdoh, sdon}, sdk{sdkb, sdkh, sdkn}, sdv{sdvb, sdvh, sdvn};
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV_ARGS q, k, v, dout, l, ds, dk, dv, B, H, Nq, Nkv, D, sq, sk, sv, sdo, sdk, sdv, scale, s
  switch (dtype) {
    case 0:
      if (D <= 128) return int(launch_dkv_f32<1>(DKV_ARGS));
      return int(launch_dkv_f32<2>(DKV_ARGS));
    case 1:
      return int(launch_dkv<__nv_bfloat16>(q, k, v, dout, l, ds, dk, dv, B, H, Nq, Nkv, D, sq,
                                           sk, sv, sdo, sdk, sdv, scale, s));
    case 2:
      return int(launch_dkv<__half>(q, k, v, dout, l, ds, dk, dv, B, H, Nq, Nkv, D, sq, sk, sv,
                                    sdo, sdk, sdv, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
#undef DKV_ARGS
}
