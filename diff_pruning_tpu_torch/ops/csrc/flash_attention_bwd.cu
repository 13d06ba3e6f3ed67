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
// 8*Nq*Nkv*D against 6*N*D elements moved a head. In f32 that is bound by
// arithmetic: the f32 CUDA-core rate (67 TFLOP/s). In bf16/f16 the tensor
// cores (989 TFLOP/s) turn it around: 6*N*D*2 bytes at 3.35 TB/s take
// longer than the products, so the bound is bytes. What keeps a kernel from
// its bound is feeding the arithmetic units from shared memory, and copies
// that do not overlap the math. Both directions are split as the JAX
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
// bf16/f16 (`flash_bwd_dkv_kernel_mma<T, NC>`, `flash_bwd_dq_kernel_mma<T,
// NC>`): the tensor cores, `mma.sync.aligned.m16n8k16` with f32 accumulators,
// operands from shared memory through `ldmatrix` (tensor_core.cuh, shared
// with the forward). One m16n8k16 takes 512 bytes of operands, which one
// `ldmatrix.x4` delivers in 4 cycles at 128 bytes a cycle, so each phase is
// laid out to reuse a loaded fragment across as many products as the
// registers allow. 256 threads (8 warps) per block, 64-row tiles both ways.
// What keeps them above their byte bound: the shared memory of one block
// fills an SM, so its 8 warps alone hide the latency of each ldmatrix ->
// mma chain; and both kernels form S and dP (7 products of N x N x D where
// a backward that sums dq with atomics forms 5), the price of the split.
// - dk/dv, one block per (batch*head, 64-row kv tile): K and V resident; Q
//   and dO, with their lse and D rows, stream in 64-row tiles through a
//   two-slot cp.async ring (tile t+1 is issued as the math on tile t
//   starts). S^T = K Q_t^T and dP^T = V dO_t^T are formed transposed so that
//   a warp's rows are kv rows: warp w takes kv rows 16 (w % 4) .. +15 and q
//   columns 32 (w / 4) .. +31 (16 x 32 tiles). dV += P^T dO_t and dK +=
//   dS^T Q_t need all 64 q columns of a kv row, which two warps hold: P^T
//   and dS^T go through shared memory (two 64 x 72 tiles in the input
//   type), and there warp w owns kv rows 32 (w % 2) .. +31 and head-dim
//   columns (D_pad / 4) (w / 2) .. of dK and of dV: 2 x 64 f32 accumulators
//   a thread at D = 256, where whole rows would take 256 and spill; 32-row
//   warp tiles load 6 ldmatrix per 16 mma where 16-row ones load 9. dO_t
//   and Q_t enter those products through `ldmatrix .trans`.
// - dq, one block per (batch*head, 64-row q tile): Q and dO resident, K and
//   V streamed through the same ring. The prologue copies O's rows into V's
//   second slot, forms D = rowsum(dO * O) there (4 lanes a row, 16-byte
//   shared loads) and writes `dsum`. S = Q K_t^T and dP = dO V_t^T in 16 x
//   32 warp tiles; dS goes through one 64 x 72 tile; dq += dS K_t (K_t
//   .trans) in 32 x (D_pad / 4) warp tiles, 64 f32 accumulators a thread.
// - Rounding: p and ds are rounded to the input type in registers, once,
//   where they become mma operands (the forward rounds P there too); lse, D,
//   the scores and every accumulator stay f32. The outputs are rounded once.
// - The head dim is zero-filled in shared memory up to D_pad = 64 *
//   ceil(D / 64) (179 -> 192), never in device memory; rows of 2 * (D_pad +
//   8) bytes put the 8 rows of an ldmatrix on distinct banks. Every copy is
//   a 16-byte cp.async: where base and strides are 16-byte aligned straight
//   into place, else (D = 179 views have 2-byte aligned rows) as the whole
//   16-byte chunks that hold a row, shifted into place in shared memory
//   once they land (`realign_tile16`). Rows at or beyond Nq/Nkv are
//   zero-filled and their p set to exactly 0; columns at or beyond D are
//   not written. The gradients leave through shared memory, in 16-byte
//   stores where aligned.
// Shared memory at D = 256: dk/dv 6 * 64 * 264 * 2 + 2 * 64 * 72 * 2 + 2 *
// 128 * 4 = 222,208 bytes, dq 6 * 64 * 264 * 2 + 64 * 72 * 2 + 2 * 64 * 4 =
// 212,480: one block (8 warps) per SM; the launcher raises the limit.
//
// f32 with 256 < D <= 1024 (`flash_bwd_dq_kernel_f32_wide<BQ>`,
// `flash_bwd_dkv_kernel_f32_wide<BQ>`: the LDM's one-head transformers, D =
// 384, 576, 960 and their pruned widths, under the Diff-Pruning sweep at 6
// rows). One f32 row of D = 1024 is 4 KB, so a block cannot hold the four
// 64-row tiles of the D <= 256 kernels, nor dK and dV of 32 whole rows in
// registers: the head dim is split over a thread-block cluster of ceil(D /
// 192) blocks of 192 columns each (2 at D <= 384, 3 at 576, 5 at 960), which
// add their partial S and dP in rank order through distributed shared
// memory, once a tile, and otherwise run as the D <= 256 kernels do on their
// own columns. See their notes below.
//
// bf16/f16 with 256 < D <= 1024: the same heads under bf16 training, on the
// tensor cores, in two tilings that the entry points choose by shape. The
// long calls take `flash_bwd_dq_kernel_wgmma_wide<T, NW, Z>` and
// `flash_bwd_dkv_kernel_wgmma_wide<T, NC, Z>`: 64 rows a block on two
// warpgroups with Hopper's `wgmma`, the head dim split over a cluster where
// one block cannot hold it. The short ones (few 64-row tiles and a short
// loop: the class token's Nkv = 1, the 64-token heads) take
// `flash_bwd_dq_kernel_mma_wide<T, NC2>` and
// `flash_bwd_dkv_kernel_mma_wide<T, NC2>`: 16 q rows and 32 (dq) or 8
// (dk/dv) kv rows a block, `mma.sync`, the head dim split over the 8 warps.
// See their notes below.
//
// q, k, v, o, dO and the outputs are addressed as [b][h][n][d] through
// element strides (d contiguous); lse and dsum are contiguous (B*H, Nq) f32.
// The C entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block, all eight kernels
constexpr int kMaxD = 256;       // the 64-row kernels (every input type)
constexpr int kMaxDWide = 1024;  // the wide kernels (every input type)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, n;
};

// ---------------------------------------------------------------- f32 path

constexpr int kQRows = 64;   // q rows per tile (f32 kernels)
constexpr int kKvRows = 32;  // kv rows per tile (f32 kernels)
constexpr int kLdt = 68;     // row stride of dq's dS exchange tile: 64 + 4
constexpr int kLdk = 36;     // row stride of dk/dv's P and dS exchange tiles: 32 + 4

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

// ROWS values of a contiguous (B*H, Nq) f32 row array from q row q0, zeros past Nq
template <int ROWS = kQRows>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int q0, int Nq) {
  const int t = threadIdx.x;
  if (t < ROWS) {
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

// ------------------------------------------------- f32 path, 256 < D <= 1024

// Replaces, for f32 at 256 < D <= 1024, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` of `_flash_bwd_call` (diff_pruning_tpu/ops/attention.py:
// 143, 170, 205): exact f32 on the CUDA cores (no TF32, no tensor cores).
//
// What bounds them on the H100: the f32 FMA rate (67 TFLOP/s): at (1024,
// 1024, 384) dq does 6 and dk/dv 8 flops per (q, kv, d) against a few bytes
// a row. What keeps a kernel from that rate: shared-memory wavefronts per
// FMA (a warp's float4 load of 32 distinct addresses costs 4 wavefronts, a
// broadcast one 1, and an SM serves one wavefront a cycle against 4 warp
// FMA instructions), the bytes each block fetches again from L2, copies,
// barriers and exchanges that do not overlap the math (one block of 8 warps
// an SM), and at the sweep's 6 rows a grid too small for 132 SMs.
//
// The layout: the head dim over a cluster, not a ring of head-dim chunks.
// With chunks a block would hold all of K and V (dk/dv) or Q and dO (dq) of
// its rows over the whole head dim (32 rows x 1024 x 2 x 4 B = 256 KB, over
// the 227 KB), stream Q_t and dO_t twice a tile (once for the scores, once
// for the gradients), and keep dK and dV of whole rows in registers (256 a
// thread at 32 rows); its grid would be B*H x row tiles. Split over a
// cluster of z = ceil(D / 192) blocks, a block holds 192 columns of its
// resident rows, streams each tile once, keeps 48 accumulators a thread, and
// the grid is z times larger: 384 blocks at (1024, 1024, 384) and 6 rows,
// 2.9 waves of one block an SM. The price is one exchange a tile: each
// block's partial S and dP (2 x 32 x 32 f32) are read by the other z - 1
// through distributed shared memory (two float4 loads a thread a block)
// and added in rank order (the same bits in every block; no atomics).
//
// Both kernels, 256 threads, one block an SM, 32 x 32 tiles:
// - scores (score_part): warps 0-3 form S (A = the kv side, K or K_t; B =
//   the q side, Q_t or Q), warps 4-7 dP (V or V_t against dO); a warp's 8 A
//   rows against a lane's 4 B rows, the 4 lanes l / 8 splitting the columns
//   and reduced by two xor shuffles: per 16 columns 24 wavefronts feed 128
//   FMAs a lane. Where the tile holds at most 4 valid A rows (Nkv = 1) a
//   warp forms only its one (score_rows), and warps with none skip theirs;
// - p = exp(s scale - lse) and ds = p (dp - D) scale once per (kv, q) pair
//   of the tile, from the cluster's sums, into shared memory;
// - gradients in 4 x 12 register micro-tiles: per row of the streamed tile
//   one float4 of dS or P (4 rows, broadcast) and 3 float4 of the streamed
//   tile (8 distinct each: one wavefront) feed 48 FMAs; warps whose columns
//   are all past D, or whose rows are all past Nkv, skip theirs;
// - the loop, per tile t: wait for tile t's stage, one barrier, issue tile t
//   + 1's copies (cp.async, a ring of 3 stages: tile t - 1's, t's, t + 1's
//   in flight); form the partial scores of t, write them (two buffers) and
//   arrive on the cluster barrier; form tile t - 1's gradient while the
//   other blocks' partials arrive; wait, sum the cluster's scores and form
//   p and dS of t. The gradient hides the cluster barrier; the copies, the
//   exchange and the barriers still take about half of the time (parts
//   timed by bwd_breakdown.py);
// - copies: 16-byte cp.async where the views allow it, else 4-byte (pruned
//   widths such as 270, fused 3-head views); rows past Nq/Nkv and columns
//   past D zero-filled and their p exactly 0; columns past D never written.
//   (Bulk copies, one TMA instruction a row from one warp, were measured
//   slower: 0.652 against 0.578 ms for dq at (1024, 1024, 384).)
// - dq (`flash_bwd_dq_kernel_f32_wide<32>`): one cluster per (batch*head,
//   32-row q tile); Q and dO resident, K_t and V_t streamed; each half of
//   the block takes 16 kv rows of every tile into its own dq sums (added at
//   the end), so that a thread holds 4 x 12 of dq, not 2 x 12. (64 q rows a
//   block fetch each K_t row half as often, but leave no room for a third
//   stage and give 192 blocks at (1024, 1024, 384), 1.45 waves. Device ms on
//   an H100 (bwd_dispatch.py), before the loop above: 0.710 against 32
//   rows' 0.709 there, 0.102 against 0.133 at (256, 256, 576); the loop
//   above brought the 32-row kernel to 0.578 and 0.111.)
//   The prologue forms this block's part of D = rowsum(dO * O) (O's
//   columns in the ring's last stage) in score_part's summation order
//   (row_dot), adds the cluster's parts in rank order and rank 0 writes
//   `dsum`: where a row's one valid kv row is its O row (Nkv = 1), dp - D is
//   exactly 0 here and in the dk/dv kernel, so dq and dk, zero in exact
//   arithmetic, come out 0.
// - dk/dv (`flash_bwd_dkv_kernel_f32_wide<32>`): one cluster per
//   (batch*head, 32-row kv tile); K and V resident, Q_t and dO_t with their
//   lse and D rows streamed; dK in warps 0-3, dV in 4-7. The split route
//   (launch_dkv_f32_wide): where B*H x kv tiles x z < 132, zq = 2 or 4 more
//   blocks of each head-dim slice split the q loop (a cluster of z x zq <=
//   8, 2 q tiles a part or more; part p takes q tiles p, p + zq, ...), then
//   add their dK and dV in part order through distributed shared memory,
//   each part writing 32 / zq rows: no atomics, no second launch.
// L2 bytes a row at (1024, 1024, 384): dq (3 + 2 x 1024 / 32) x 384 x 4 =
// 102,912 a q row (201,216 with blocks of 16 q rows), dk/dv 2 x 384 x 4 +
// (2 x 384 x 4 + 8) x 1024 / 32 = 101,632 a kv row (397,312 with blocks of
// 8 kv rows).
// Shared memory (floats, LD = 196): dq 2 x 32 LD + 3 stages x 64 LD + 2 x
// 2048 + 2 x 32 x 36 + 96 = 226,688 bytes; dk/dv 64 LD + 2 x 2048 + 2 x 32
// x 36 + 3 stages x (64 LD + 64) = 227,072 bytes.

constexpr int kWideDB = 192;           // head-dim columns a block (the cluster splits D)
constexpr int kWideLD = kWideDB + 4;   // row stride of the wide kernels' tiles (floats)
constexpr int kWideRows = 32;          // rows of every tile: q, kv, streamed
constexpr int kWideLdx = kWideRows + 4;  // row stride of the P^T, dS^T and dS tiles
constexpr int kWidePart = 2 * 2 * 128 * 4;  // a block's partial S and dP: [2][2][128][4] floats
constexpr int kMaxCluster = 8;         // blocks a cluster (the portable limit)

// Issues the copy of rows [row0, row0 + 32) x columns [col0, col0 + kWideDB)
// of one head (row stride sn elements) into a shared [32][kWideLD] tile,
// zero-filling rows >= nvalid and columns >= D. vec: base and strides
// 16-byte aligned (col0 is a multiple of 4).
__device__ __forceinline__ void copy_slab(float* dst, const float* src, long long sn, int row0,
                                          int nvalid, int col0, int D, bool vec) {
  if (vec) {
    constexpr int kPerRow = kWideDB / 4;
    static_assert(kWideRows * kPerRow % kThreads == 0, "whole rounds of copies");
#pragma unroll
    for (int i = 0; i < kWideRows * kPerRow / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kPerRow;
      const int c = (idx - r * kPerRow) * 4;
      const int row = row0 + r, col = col0 + c;
      int bytes = 0;
      const float* from = src;
      if (row < nvalid && col < D) {
        bytes = (D - col >= 4 ? 4 : D - col) * 4;
        from = src + row * sn + col;
      }
      cp_async16(dst + r * kWideLD + c, from, bytes);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kWideRows * kWideDB / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kWideDB;
      const int c = idx - r * kWideDB;
      const int row = row0 + r, col = col0 + c;
      const bool ok = row < nvalid && col < D;
      cp_async4(dst + r * kWideLD + c, ok ? src + row * sn + col : src, ok ? 4 : 0);
    }
  }
}

// One warp's part of a partial score product over the block's columns [0,
// dk) (a multiple of 16; zeros past D; dk = 0: all zeros): out = sum_d
// A[a][d] B[b][d] for the warp's A rows wa + 4 i (i < NA, the kv side) and
// the lane's B rows (l & 7) + 8 j (j < 4, the q side), the 4 lanes l >> 3
// splitting the columns (d = 4 (l >> 3) + 16 m, a chain of fmaf in column
// order each). Per 16 columns a warp loads B's 32 rows (4 float4 loads of 4
// wavefronts) and A's 8 rows (8 broadcast loads of one wavefront each) for
// 128 FMAs a lane. Two xor shuffles (16, then 8) reduce-scatter the four
// parts, as (p0 + p2) + (p1 + p3) in every lane (row_dot's order), leaving
// each lane out[ii][j] for A row wa + 8 (l >> 3) + 4 ii. NA = 1 where the
// tile holds at most 4 valid A rows (Nkv = 1): the warp forms its one row,
// in the same order, into lanes 0-7's out[0] (the others' are 0).
template <int NA>
__device__ __forceinline__ void score_part(float (&out)[2][4], const float* a, const float* b,
                                           int wa, int dk) {
  const int lane = threadIdx.x & 31;
  const float* ar = a + wa * kWideLD;
  const float* br = b + (lane & 7) * kWideLD;
  float s[NA][4];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 4 * (lane >> 3); d < dk; d += 16) {
    float4 bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j] = *reinterpret_cast<const float4*>(br + 8 * j * kWideLD + d);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float4 af = *reinterpret_cast<const float4*>(ar + 4 * i * kWideLD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(af.x, bf[j].x, s[i][j]);
        s[i][j] = fmaf(af.y, bf[j].y, s[i][j]);
        s[i][j] = fmaf(af.z, bf[j].z, s[i][j]);
        s[i][j] = fmaf(af.w, bf[j].w, s[i][j]);
      }
    }
  }
  if constexpr (NA == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[0][j];
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      out[0][j] = lane < 8 ? x : 0.f;
      out[1][j] = 0.f;
    }
  } else {
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
}

// the warp's partial scores: score_part over its 8 A rows, or its one where
// the tile holds at most 4 valid A rows (`rows`: the tile's valid A rows;
// warps with none form zeros)
__device__ __forceinline__ void score_rows(float (&out)[2][4], const float* a, const float* b,
                                           int wa, int dk, int rows) {
  if (rows <= 4) {
    score_part<1>(out, a, b, wa, wa < rows ? dk : 0);
  } else {
    score_part<8>(out, a, b, wa, wa < rows ? dk : 0);
  }
}

// <x, y> over the block's columns [0, dk) for the 8 rows of a warp (lanes l
// and l ^ 8, l ^ 16, l ^ 24 share row l & 7), in score_part's order: where
// O's row equals the one valid V row (Nkv = 1), D = rowsum(dO * O) and dP
// come out in the same bits, so that dq and dk, zero in exact arithmetic,
// come out 0
__device__ __forceinline__ float row_dot(const float* x, const float* y, int dk) {
  float s = 0.f;
  for (int d = 4 * ((threadIdx.x & 31) >> 3); d < dk; d += 16) {
    const float4 a = *reinterpret_cast<const float4*>(x + d);
    const float4 b = *reinterpret_cast<const float4*>(y + d);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s + __shfl_xor_sync(0xffffffffu, s, 8);
}

// Writes a warp's partial scores (score_part's lanes) into this block's
// buffer `part`: [m][ii][t % 128][j] (m = 0 S, 1 dP: the product of warps 4
// m .. 4 m + 3), one float4 per row ii of the lane's, conflict-free
__device__ __forceinline__ void put_scores(float* part, const float (&sc)[2][4]) {
  float* at = part + (threadIdx.x >> 7) * 2 * 128 * 4 + (threadIdx.x & 127) * 4;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
    *reinterpret_cast<float4*>(at + ii * 128 * 4) =
        make_float4(sc[ii][0], sc[ii][1], sc[ii][2], sc[ii][3]);
}

// The cluster's sums of this thread's 4 partial S and dP (row ii = `half`
// of the lanes' at its position, put_scores), over the blocks of ranks
// rank0 + r (r < z) in rank order (the same bits in every block; no
// atomics): two float4 loads a block
__device__ __forceinline__ void sum_scores(float (&s)[4], float (&dp)[4], const float* part,
                                           int half, uint32_t rank, int rank0, int z) {
  const float* at = part + (half * 128 + (threadIdx.x & 127)) * 4;
  constexpr int kDp = 2 * 128 * 4;  // dP's offset from S's
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = dp[j] = 0.f;
  for (int r = 0; r < z; ++r) {
    float4 a, b;
    if (rank0 + r == int(rank)) {
      a = *reinterpret_cast<const float4*>(at);
      b = *reinterpret_cast<const float4*>(at + kDp);
    } else {
      const uint32_t rem = cluster_map(at, rank0 + r);
      a = ld_cluster4(rem);
      b = ld_cluster4(rem + kDp * 4);
    }
    s[0] += a.x, s[1] += a.y, s[2] += a.z, s[3] += a.w;
    dp[0] += b.x, dp[1] += b.y, dp[2] += b.z, dp[3] += b.w;
  }
}

// acc[r][4 m + e] += a[r] * b[m].e: R rows of a thread's tile, 3 float4 columns
template <int R>
__device__ __forceinline__ void fma_slab(float (&acc)[R][12], const float (&a)[R],
                                         const float4 (&b)[3]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      acc[r][4 * m + 0] = fmaf(a[r], b[m].x, acc[r][4 * m + 0]);
      acc[r][4 * m + 1] = fmaf(a[r], b[m].y, acc[r][4 * m + 1]);
      acc[r][4 * m + 2] = fmaf(a[r], b[m].z, acc[r][4 * m + 2]);
      acc[r][4 * m + 3] = fmaf(a[r], b[m].w, acc[r][4 * m + 3]);
    }
}

// acc += X^T G over the tile's first n rows: X a shared [32][kWideLdx] tile
// (this thread's R values of a row at x), G a shared [32][kWideLD] tile (its
// 3 float4 at g, 32 columns apart): per row one load of R values and 3
// float4 loads of one wavefront each feed 12 R FMAs
template <int R>
__device__ __forceinline__ void grad_slab(float (&acc)[R][12], const float* x, const float* g,
                                          int n) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float a[R];
    if constexpr (R == 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(x + j * kWideLdx);
      a[0] = x4.x, a[1] = x4.y, a[2] = x4.z, a[3] = x4.w;
    } else {
      const float2 x2 = *reinterpret_cast<const float2*>(x + j * kWideLdx);
      a[0] = x2.x, a[1] = x2.y;
    }
    const float* gj = g + j * kWideLD;
    const float4 gf[3] = {*reinterpret_cast<const float4*>(gj),
                          *reinterpret_cast<const float4*>(gj + 32),
                          *reinterpret_cast<const float4*>(gj + 64)};
    fma_slab<R>(acc, a, gf);
  }
}

// rows row0 + r (r < R) and columns col0 + 32 m .. + 3 (m < 3) of a
// thread's register tile to device memory, rows < nvalid and columns < D
template <int R>
__device__ __forceinline__ void store_slab(float* base, long long sn, int row0, int nvalid,
                                           int col0, int D, bool vec_out,
                                           const float (&acc)[R][12]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= nvalid) continue;
    float* out = base + (row0 + r) * sn;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int col = col0 + 32 * m;
      if (vec_out && col < D) {  // D % 4 == 0: the whole float4 is in range
        *reinterpret_cast<float4*>(out + col) = make_float4(
            acc[r][4 * m], acc[r][4 * m + 1], acc[r][4 * m + 2], acc[r][4 * m + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) out[col + e] = acc[r][4 * m + e];
      }
    }
  }
}

// The streamed tiles' ring (both kernels): stage x of the loop in slot x %
// NS. Tile t's products run in iteration t and its gradient in t + 1, so at
// iteration t's barrier the slot of tile t - 2 is free and takes tile t + NS
// - 2: 3 stages hold the gradient's tile, the current one and one in
// flight, a whole iteration ahead.
constexpr int kWideStages = 3;

// shared memory of the dq kernel: Q, dO [32][LD]; 3 stages of K_t and V_t
// [32][LD]; two buffers of partials and of dS [32][36]; lse, D and this
// block's part of D
constexpr int kWideDqSmem =
    (2 * kWideRows * kWideLD + kWideStages * 2 * kWideRows * kWideLD + 2 * kWidePart +
     2 * kWideRows * kWideLdx + 3 * kWideRows) * 4;
static_assert(kWideDqSmem <= 232448, "a block's shared memory");

template <int BQ>  // q rows a block
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ o,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ dsum, float* __restrict__ dq, int H, int Nq,
                             int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                             Strides sdo, Strides sdq, float scale, int vec, int vec_out) {
  static_assert(BQ == kWideRows, "the tiles are 32 x 32");
  constexpr int TILE = kWideRows * kWideLD;
  constexpr int NS = kWideStages;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [32][LD] Q (resident)
  float* dos = qs + TILE;                // [32][LD] dO
  float* ring = dos + TILE;              // NS x (K_t [32][LD], V_t [32][LD]); first O in the last
  float* parts = ring + NS * 2 * TILE;   // 2 x [2][8][128] this block's partial S and dP
  float* dss = parts + 2 * kWidePart;    // 2 x [32 kv][36] dS
  float* lrow = dss + 2 * kWideRows * kWideLdx;  // [32] lse
  float* drow = lrow + kWideRows;        // [32] D = rowsum(dO * O)
  float* dpart = drow + kWideRows;       // [32] this block's part of D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int z = gridDim.z;                   // blocks a cluster: head-dim slices
  const uint32_t rank = cluster_rank();      // = blockIdx.z
  const int c0 = int(rank) * kWideDB;        // the block's first head-dim column
  const int dk = min(kWideDB, (D - c0 + 15) & ~15);  // its columns holding columns < D
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2;  // scores: 0 S = Q K_t^T, 1 dP = dO V_t^T
  const int wa = warp & 3;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int tiles = (Nkv + kWideRows - 1) / kWideRows;
  int next = 0;  // the next stage to issue: K and V of kv tile `next`
  auto issue = [&]() {
    const int t = next * kWideRows;
    if (t < Nkv) {
      float* st = ring + (next % NS) * 2 * TILE;
      copy_slab(st, kb, sk.n, t, Nkv, c0, D, vec);
      copy_slab(st + TILE, vb, sv.n, t, Nkv, c0, D, vec);
    }
    cp_async_commit();
    ++next;
  };
  float* os = ring + (NS - 1) * 2 * TILE;  // O [32][LD], in the slot of stage NS - 1
  copy_slab(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, c0, D, vec);
  copy_slab(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, Nq, c0, D, vec);
  copy_slab(os, o + b * so.b + h * so.h, so.n, q0, Nq, c0, D, vec);
  for (int i = 0; i < NS - 2; ++i) issue();  // (Q, dO and O with the first)
  cp_async_wait<NS - 3>();  // Q, dO and O have landed
  __syncthreads();

  // D = rowsum(dO * O): this block's part (row 8 w + l % 8), then the
  // cluster's parts added in rank order; rank 0 writes `dsum`
  if (warp < 4) {
    const int r = 8 * warp + (lane & 7);
    const float x = row_dot(os + r * kWideLD, dos + r * kWideLD, dk);
    if (lane < 8) dpart[r] = x;
  }
  if (tid < BQ) lrow[tid] = q0 + tid < Nq ? lse[size_t(bh) * Nq + q0 + tid] : 0.f;
  cluster_sync();
  if (tid < BQ) {
    float dd = 0.f;
    for (int r = 0; r < z; ++r)
      dd += r == int(rank) ? dpart[tid] : ld_cluster(cluster_map(dpart + tid, r));
    drow[tid] = dd;
    if (rank == 0 && q0 + tid < Nq) dsum[size_t(bh) * Nq + q0 + tid] = dd;
  }
  // (the first stage's barrier makes lrow and drow visible)

  // dq, each half of the block over half of every kv tile (rows 16 h ..):
  // rows 16 (w % 2) + 4 (l % 4) + r, columns 96 (w % 4 / 2) + 4 (l / 4) +
  // 32 m + e of the block's; the halves' sums are added at the end
  const int gr = 16 * (wa & 1) + 4 * (lane & 3);
  const int gc = 96 * (wa >> 1) + 4 * (lane >> 2);
  float acc[4][12];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 12; ++e) acc[r][e] = 0.f;
  const int a_row = wa + 8 * (lane >> 3) + 4 * half;  // the kv row of this thread's scores
  const bool cols_ok = gc < D - c0;  // (warps whose columns are all past D skip dq)
  // dq += dS K over this half's rows of kv tile `it` (n valid rows)
  auto grad = [&](int it, int n) {
    const float* sp = ring + (it % NS) * 2 * TILE + 16 * half * kWideLD;
    grad_slab<4>(acc, dss + (it & 1) * kWideRows * kWideLdx + 16 * half * kWideLdx + gr, sp + gc,
                 max(0, min(16, n - 16 * half)));
  };

  for (int it = 0; it < tiles; ++it) {
    const int t = it * kWideRows;
    cp_async_wait<NS - 3>();  // K_t and V_t have landed
    __syncthreads();          // ... and every thread is done with tile t - 2's stage
    issue();
    const float* st = ring + (it % NS) * 2 * TILE;
    float sc[2][4];
    score_rows(sc, half ? st + TILE : st, half ? dos : qs, wa, dk, Nkv - t);
    float* part = parts + (it & 1) * kWidePart;
    put_scores(part, sc);
    cluster_arrive();  // this block's partials are written
    // while the cluster's partials meet: dq += dS K_{t-1}
    if (it > 0 && cols_ok) grad(it - 1, kWideRows);
    cluster_wait();   // every block's partials of tile t are visible
    float s[4], dp[4];
    sum_scores(s, dp, part, half, rank, 0, z);
    const bool kv_ok = t + a_row < Nkv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (lane & 7) + 8 * j;  // q row in the tile
      const float p = kv_ok && q0 + r < Nq ? expf(s[j] * scale - lrow[r]) : 0.f;
      dss[(it & 1) * kWideRows * kWideLdx + a_row * kWideLdx + r] = p * (dp[j] - drow[r]) * scale;
    }
  }
  __syncthreads();  // dS of the last tile is visible
  if (cols_ok) grad(tiles - 1, Nkv - (tiles - 1) * kWideRows);
  float* red = qs;  // [32][kWideDB]: half 1's dq, in Q's room (Q is done with)
  if (half) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 3; ++m)
        *reinterpret_cast<float4*>(red + (gr + r) * kWideDB + gc + 32 * m) =
            make_float4(acc[r][4 * m], acc[r][4 * m + 1], acc[r][4 * m + 2], acc[r][4 * m + 3]);
  }
  cluster_sync();  // (the other blocks may still read this one's partials until here)
  if (half) return;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float4 x = *reinterpret_cast<const float4*>(red + (gr + r) * kWideDB + gc + 32 * m);
      acc[r][4 * m] += x.x, acc[r][4 * m + 1] += x.y, acc[r][4 * m + 2] += x.z,
          acc[r][4 * m + 3] += x.w;
    }
  store_slab<4>(dq + b * sdq.b + h * sdq.h, sdq.n, q0 + gr, Nq, c0 + gc, D, vec_out, acc);
}

// shared memory of the dk/dv kernel: K, V [32][LD]; two buffers of
// partials; P^T, dS^T [32][36]; 3 stages of Q_t and dO_t [32][LD] with
// their lse and D [32]
constexpr int kWideDkvStage = 2 * kWideRows * kWideLD + 2 * kWideRows;
constexpr int kWideDkvSmem = (2 * kWideRows * kWideLD + 2 * kWidePart +
                              2 * kWideRows * kWideLdx + kWideStages * kWideDkvStage) * 4;
static_assert(kWideDkvSmem <= 232448, "a block's shared memory");

template <int BQ>  // q rows a stage
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dsum,
                              float* __restrict__ dk, float* __restrict__ dv, int H, int Nq,
                              int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                              Strides sdk, Strides sdv, float scale, int zd, int vec,
                              int vec_out) {
  static_assert(BQ == kWideRows, "the tiles are 32 x 32");
  constexpr int TILE = kWideRows * kWideLD;
  constexpr int NS = kWideStages;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [32][LD] K (resident)
  float* vs = ks + TILE;                  // [32][LD] V
  float* parts = vs + TILE;               // 2 x [2][8][128] this block's partial S^T and dP^T
  float* pts = parts + 2 * kWidePart;     // [32 q][36] P^T
  float* dsts = pts + kWideRows * kWideLdx;  // [32 q][36] dS^T
  float* ring = dsts + kWideRows * kWideLdx;  // NS x (Q_t, dO_t [32][LD]; lse, D [32])

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.y * kWideRows;
  // a cluster of zd x zq blocks: zd head-dim slices, each split over zq
  // parts of the q loop (zq > 1 for the short calls)
  const int zq = gridDim.z / zd;
  const uint32_t rank = cluster_rank();  // = blockIdx.z
  const int dsl = int(rank) % zd;        // the block's head-dim slice
  const int qp = int(rank) / zd;         // its part of the q loop: q tiles qp, qp + zq, ...
  const int c0 = dsl * kWideDB;
  const int dkc = min(kWideDB, (D - c0 + 15) & ~15);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2;  // scores: 0 S^T = K Q_t^T, 1 dP^T = V dO_t^T; then dK, dV
  const int wa = warp & 3;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + size_t(bh) * Nq;
  const float* db = dsum + size_t(bh) * Nq;
  int next = 0;  // the next stage to issue: Q, dO, lse and D of the block's q tile `next`
  auto issue = [&]() {
    const int t = (next * zq + qp) * BQ;
    if (t < Nq) {
      float* st = ring + (next % NS) * kWideDkvStage;
      copy_slab(st, qb, sq.n, t, Nq, c0, D, vec);
      copy_slab(st + TILE, dob, sdo.n, t, Nq, c0, D, vec);
      copy_rows<BQ>(st + 2 * TILE, lb, t, Nq);
      copy_rows<BQ>(st + 2 * TILE + BQ, db, t, Nq);
    }
    cp_async_commit();
    ++next;
  };
  copy_slab(ks, k + b * sk.b + h * sk.h, sk.n, kv0, Nkv, c0, D, vec);
  copy_slab(vs, v + b * sv.b + h * sv.h, sv.n, kv0, Nkv, c0, D, vec);
  for (int i = 0; i < NS - 2; ++i) issue();  // (K and V with the first)

  // dK (warps 0-3) or dV (4-7): kv rows 16 (w % 2) + 4 (l % 4) + r, columns
  // 96 (w % 4 / 2) + 4 (l / 4) + 32 m + e of the block's: per q row one
  // float4 of dS^T or P^T (4 kv rows) and 3 float4 of Q_t or dO_t feed 48
  // FMAs; warps whose rows are all past Nkv or whose columns are all past D
  // skip theirs
  const int gr = 16 * (wa & 1) + 4 * (lane & 3);
  const int gc = 96 * (wa >> 1) + 4 * (lane >> 2);
  float acc[4][12];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 12; ++e) acc[r][e] = 0.f;
  const bool grad_ok = kv0 + 16 * (wa & 1) < Nkv && gc < D - c0;
  const float* xs = (half ? pts : dsts) + gr;
  const int a_row = wa + 8 * (lane >> 3) + 4 * half;  // the kv row of this thread's scores
  const bool kv_ok = kv0 + a_row < Nkv;
  const int tiles = ((Nq + BQ - 1) / BQ + zq - 1) / zq;  // q tiles a block (the same in all)
  auto rows_of = [&](int i) { return max(0, min(BQ, Nq - (i * zq + qp) * BQ)); };

  for (int it = 0; it < tiles; ++it) {
    const int t = (it * zq + qp) * BQ;
    cp_async_wait<NS - 3>();  // Q_t, dO_t and their rows have landed
    __syncthreads();          // ... and every thread is done with tile t - 2's stage
    issue();
    const float* st = ring + (it % NS) * kWideDkvStage;
    const float* lrow = st + 2 * TILE;
    const float* drow = lrow + BQ;
    float sc[2][4];  // (t >= Nq: this part's share ran out, the barriers go on)
    score_rows(sc, half ? vs : ks, half ? st + TILE : st, wa, t < Nq ? dkc : 0, Nkv - kv0);
    float* part = parts + (it & 1) * kWidePart;
    put_scores(part, sc);
    cluster_arrive();  // this block's partials are written
    // while the cluster's partials meet: dK += dS^T Q_{t-1}, dV += P^T dO_{t-1}
    if (it > 0 && grad_ok) {
      const float* sp = ring + ((it - 1) % NS) * kWideDkvStage;
      grad_slab<4>(acc, xs, sp + half * TILE + gc, rows_of(it - 1));
    }
    __syncthreads();  // every thread is done with P^T and dS^T of tile t - 1
    cluster_wait();   // every block's partials of tile t are visible
    float s[4], dp[4];
    sum_scores(s, dp, part, half, rank, qp * zd, zd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (lane & 7) + 8 * j;  // q row in the tile
      const float p = kv_ok && t + r < Nq ? expf(s[j] * scale - lrow[r]) : 0.f;
      pts[r * kWideLdx + a_row] = p;
      dsts[r * kWideLdx + a_row] = p * (dp[j] - drow[r]) * scale;
    }
  }
  __syncthreads();  // P^T and dS^T of the last tile are visible
  if (grad_ok) {
    const float* sp = ring + ((tiles - 1) % NS) * kWideDkvStage;
    grad_slab<4>(acc, xs, sp + half * TILE + gc, rows_of(tiles - 1));
  }
  cluster_sync();  // the other blocks may still read this one's partials until here

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
  if (zq == 1) {
    store_slab<4>(half ? dvb : dkb, half ? sdv.n : sdk.n, kv0 + gr, Nkv, c0 + gc, D, vec_out, acc);
    return;
  }
  // the split route: the zq blocks of a head-dim slice add their dK and dV
  // in q-part order through distributed shared memory, each block the kv
  // rows qp * 32 / zq .. of both
  float* red = ks;  // [2][32][kWideDB]: dK, dV, in K's and V's room (K and V are done with)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < 3; ++m)
      *reinterpret_cast<float4*>(red + (half * kWideRows + gr + r) * kWideDB + gc + 32 * m) =
          make_float4(acc[r][4 * m], acc[r][4 * m + 1], acc[r][4 * m + 2], acc[r][4 * m + 3]);
  cluster_sync();
  const int rows = kWideRows / zq;
  for (int idx = tid; idx < 2 * rows * kWideDB; idx += kThreads) {
    const int which = idx / (rows * kWideDB);
    const int rem = idx - which * rows * kWideDB;
    const int row = qp * rows + rem / kWideDB;
    const int col = rem % kWideDB;
    const int off = (which * kWideRows + row) * kWideDB + col;
    float x = 0.f;
    for (int p = 0; p < zq; ++p) {
      const int rk = p * zd + dsl;
      x += rk == int(rank) ? red[off] : ld_cluster(cluster_map(red + off, rk));
    }
    if (kv0 + row < Nkv && c0 + col < D)
      (which ? dvb + (kv0 + row) * sdv.n : dkb + (kv0 + row) * sdk.n)[c0 + col] = x;
  }
  cluster_sync();  // the other blocks may still read this one's dK and dV
}

// ----------------------------------------------------------- bf16/f16 path

constexpr int kTile16 = 64;           // q rows and kv rows per tile (16-bit kernels)
constexpr int kLdx = kTile16 + 8;     // row stride of the P^T, dS^T and dS exchange tiles
static_assert(kTile16 == kQRows, "copy_rows copies the rows of one 64-row tile");

// two 16-bit values (one 32-bit word, lo in the low half) as f32
__device__ __forceinline__ float2 to_f32x2(uint32_t w, __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 to_f32x2(uint32_t w, __half*) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// Issues the copy of rows [row0, row0 + 64) of one head into shared memory
// (row stride LD = DP + 8); rows >= nvalid are zero-filled. vec (base and
// strides 16-byte aligned): columns [0, DP), zero-filled at and past D.
// Otherwise a row starts o = (address % 16) / 2 elements into a 16-byte
// chunk of device memory: the row's chunks are copied whole, o elements
// early (a chunk never crosses a page, so reading all of it is safe), and
// realign_tile16 shifts them into place once they have landed.
template <typename T, int DP>
__device__ __forceinline__ void copy_tile16(T* dst, const T* src, long long sn, int row0,
                                            int nvalid, int D, bool vec) {
  constexpr int LD = DP + 8;
  constexpr int kPerRow = LD / 8;  // a row's 16-byte chunks in shared memory
  for (int idx = threadIdx.x; idx < kTile16 * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 8;
    const int row = row0 + r;
    // (zero-fill: nothing is read, but the address must be 16-byte aligned)
    const T* from = reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
    int bytes = 0;
    if (row < nvalid) {
      const T* first = src + row * sn;
      if (vec) {
        if (c < D) {
          bytes = (D - c >= 8 ? 8 : D - c) * 2;
          from = first + c;
        }
      } else {
        const int o = int((reinterpret_cast<uintptr_t>(first) & 15) >> 1);
        if (c < o + D) {
          bytes = 16;
          from = first - o + c;
        }
      }
    }
    if (!vec || c < DP) cp_async16(dst + r * LD + c, from, bytes);  // (pad columns: never read)
  }
}

// Shifts the rows that copy_tile16 copied as whole chunks (not vec) left by
// their o elements and zero-fills columns [D, DP). Warp w takes rows w, w +
// 8, ...; lane l the 32-bit words l + 32i of a row. A word is read from the
// row's words at or right of it, all lanes read before any writes, and the
// words of one pass are left of the next pass's, so the shift works in place.
template <typename T, int DP>
__device__ __forceinline__ void realign_tile16(T* tile, const T* src, long long sn, int row0,
                                               int D) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kTile16; r += kThreads / 32) {
    const int o = int((reinterpret_cast<uintptr_t>(src + (row0 + r) * sn) & 15) >> 1);
    uint32_t* row = reinterpret_cast<uint32_t*>(tile + r * LD);
#pragma unroll
    for (int w0 = 0; w0 < DP / 2; w0 += 32) {
      const int i = w0 + lane;  // the word of columns 2i, 2i + 1
      const int e = 2 * i + o;  // column 2i's element in the copied chunks
      const uint32_t lo = row[e >> 1];
      uint32_t word = (e & 1) ? __funnelshift_r(lo, row[(e >> 1) + 1], 16) : lo;
      if (2 * i + 1 >= D) word = 2 * i >= D ? 0u : (word & 0xffffu);
      __syncwarp();
      row[i] = word;
      __syncwarp();
    }
  }
}

// rows [row0, row0 + 64) of a shared [64][LD] tile to device memory, rows <
// nvalid and columns < D; vec: base and strides 16-byte aligned, D % 8 == 0
template <typename T, int LD>
__device__ __forceinline__ void store_tile16(T* dst, long long sn, const T* tile, int row0,
                                             int nvalid, int D, bool vec) {
  if (vec) {
    const int per_row = D / 8;
    for (int idx = threadIdx.x; idx < kTile16 * per_row; idx += kThreads) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 8;
      if (row0 + r < nvalid)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * sn + c) =
            *reinterpret_cast<const uint4*>(tile + r * LD + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile16 * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      if (row0 + r < nvalid) dst[(row0 + r) * sn + c] = tile[r * LD + c];
    }
  }
}

// A warp's 16 x 8NT f32 accumulator tile (rows r0 + lane / 4 and + 8,
// columns c0 + 8n + 2 (lane % 4) .. +1), rounded to the input type, into a
// shared [..][LD] tile
template <typename T, int NT, int LD>
__device__ __forceinline__ void stage_tile(T* tile, const float (&acc)[NT][4], int r0, int c0) {
  const int lane = threadIdx.x & 31;
  T* p = tile + (r0 + (lane >> 2)) * LD + c0 + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(p + n * 8) = pack2(acc[n][0], acc[n][1], static_cast<T*>(nullptr));
    *reinterpret_cast<uint32_t*>(p + 8 * LD + n * 8) =
        pack2(acc[n][2], acc[n][3], static_cast<T*>(nullptr));
  }
}

// s = A1 B1^T and dp = A2 B2^T for one warp, over DP columns: a1, a2 point
// at 16 rows, b1, b2 at 32 rows of shared [..][DP + 8] tiles. s[n] holds
// rows lane / 4 (+8) and columns 8n + 2 (lane % 4) (+1).
template <typename T, int DP>
__device__ __forceinline__ void score_pair(float (&s)[4][4], float (&dp)[4][4], const T* a1,
                                           const T* b1, const T* a2, const T* b2) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  // A rows lane % 16, column half lane / 16; B rows lane % 8 + 8 (lane / 16)
  // of a pair of n-tiles, column half (lane / 8) % 2
  const int ao = (lane & 15) * LD + (lane >> 4) * 8;
  const int bo = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t x[4], y[4];
    ldmatrix_x4(x, a1 + ao + kk * 16);
    ldmatrix_x4(y, a2 + ao + kk * 16);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b1 + bo + np * 16 * LD + kk * 16);
      mma16816(s[2 * np], x, b[0], b[1], static_cast<T*>(nullptr));
      mma16816(s[2 * np + 1], x, b[2], b[3], static_cast<T*>(nullptr));
      ldmatrix_x4(b, b2 + bo + np * 16 * LD + kk * 16);
      mma16816(dp[2 * np], y, b[0], b[1], static_cast<T*>(nullptr));
      mma16816(dp[2 * np + 1], y, b[2], b[3], static_cast<T*>(nullptr));
    }
  }
}

// acc += X B for one warp: x points at its 32 rows of a 64-wide exchange
// tile (row stride kLdx; the 64 columns are the product's k), b at column
// c0 of row 0 of a shared [64][LD] tile whose rows are k (read .trans);
// acc[m][n] holds rows 16m + lane / 4 (+8), columns c0 + 8n + 2 (lane % 4)
// (+1).
template <typename T, int LD, int NT>
__device__ __forceinline__ void grad_tile(float (&acc)[2][NT][4], const T* x, const T* b) {
  const int lane = threadIdx.x & 31;
  // A rows lane % 16 (+16), column half lane / 16; B (.trans) k rows lane %
  // 8 + 8 ((lane / 8) % 2), column half lane / 16
  const T* xa = x + (lane & 15) * kLdx + (lane >> 4) * 8;
  const T* bt = b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kTile16 / 16; ++kk) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, xa + kk * 16);
    ldmatrix_x4(a1, xa + 16 * kLdx + kk * 16);
#pragma unroll
    for (int dc = 0; dc < NT / 2; ++dc) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bt + kk * 16 * LD + dc * 16);
      mma16816(acc[0][2 * dc], a0, bf[0], bf[1], static_cast<T*>(nullptr));
      mma16816(acc[0][2 * dc + 1], a0, bf[2], bf[3], static_cast<T*>(nullptr));
      mma16816(acc[1][2 * dc], a1, bf[0], bf[1], static_cast<T*>(nullptr));
      mma16816(acc[1][2 * dc + 1], a1, bf[2], bf[3], static_cast<T*>(nullptr));
    }
  }
}

template <typename T, int NC>  // head dim padded to 64 * NC
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_mma(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int Nq, int Nkv, int D,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale, int vec, int vec_out) {
  constexpr int DP = 64 * NC;
  constexpr int LD = DP + 8;
  constexpr int NQ = DP / 4;  // head-dim columns of dK and dV per warp
  constexpr int NT = NQ / 8;  // their n-tiles
  constexpr int TILE = kTile16 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [64][LD] kv rows (resident)
  T* vs = ks + TILE;                        // [64][LD]
  T* qs = vs + TILE;                        // 2 slots of [64][LD] q rows (streamed)
  T* dos = qs + 2 * TILE;                   // 2 slots of [64][LD]
  T* pts = dos + 2 * TILE;                  // [64 kv][kLdx]: P^T of the q tile
  T* dsts = pts + kTile16 * kLdx;           // [64 kv][kLdx]: dS^T
  float* rows = reinterpret_cast<float*>(dsts + kTile16 * kLdx);  // 2 slots of lse[64], D[64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.y * kTile16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mr = (warp & 3) * 16;  // scores: the warp's kv rows in the tile
  const int nh = warp >> 2;        // ... and its q half
  const int gr = (warp & 1) * 32;  // dK and dV: the warp's kv rows
  const int gc = (warp >> 1) * NQ; // ... and head-dim columns

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + size_t(bh) * Nq;
  const float* db = dsum + size_t(bh) * Nq;

  copy_tile16<T, DP>(ks, k + b * sk.b + h * sk.h, sk.n, kv0, Nkv, D, vec);
  copy_tile16<T, DP>(vs, v + b * sv.b + h * sv.h, sv.n, kv0, Nkv, D, vec);
  copy_tile16<T, DP>(qs, qb, sq.n, 0, Nq, D, vec);
  copy_tile16<T, DP>(dos, dob, sdo.n, 0, Nq, D, vec);
  copy_rows(rows, lb, 0, Nq);
  copy_rows(rows + kTile16, db, 0, Nq);
  cp_async_commit();

  float acc_k[2][NT][4], acc_v[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[m][n][e] = acc_v[m][n][e] = 0.f;
  const float scale2 = scale * kLog2e;
  const bool kv_ok[2] = {kv0 + mr + (lane >> 2) < Nkv, kv0 + mr + (lane >> 2) + 8 < Nkv};
  const int ntiles = (Nq + kTile16 - 1) / kTile16;

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * kTile16;
    const int slot = t & 1;
    T* qt = qs + slot * TILE;
    T* dot = dos + slot * TILE;
    const float* lrow = rows + slot * 2 * kTile16;
    const float* drow = lrow + kTile16;
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // ... for every thread; tile t-1's slot and the exchange tiles are free
    if (!vec) {
      if (t == 0) {
        realign_tile16<T, DP>(ks, k + b * sk.b + h * sk.h, sk.n, kv0, D);
        realign_tile16<T, DP>(vs, v + b * sv.b + h * sv.h, sv.n, kv0, D);
      }
      realign_tile16<T, DP>(qt, qb, sq.n, q0, D);
      realign_tile16<T, DP>(dot, dob, sdo.n, q0, D);
      __syncthreads();
    }
    if (t + 1 < ntiles) {
      const int next = slot ^ 1;
      copy_tile16<T, DP>(qs + next * TILE, qb, sq.n, q0 + kTile16, Nq, D, vec);
      copy_tile16<T, DP>(dos + next * TILE, dob, sdo.n, q0 + kTile16, Nq, D, vec);
      copy_rows(rows + next * 2 * kTile16, lb, q0 + kTile16, Nq);
      copy_rows(rows + next * 2 * kTile16 + kTile16, db, q0 + kTile16, Nq);
    }
    cp_async_commit();

    // S^T = K Q_t^T and dP^T = V dO_t^T: kv rows mr.., q columns 32 nh..
    float s[4][4], dp[4][4];
    score_pair<T, DP>(s, dp, ks + mr * LD, qt + nh * 32 * LD, vs + mr * LD, dot + nh * 32 * LD);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nh * 32 + n * 8 + (lane & 3) * 2 + (e & 1);  // q row in the tile
        const float p = q0 + i < Nq && kv_ok[e >> 1]
                            ? exp2f(s[n][e] * scale2 - lrow[i] * kLog2e) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - drow[i]) * scale;
      }
    stage_tile<T, 4, kLdx>(pts, s, mr, nh * 32);
    stage_tile<T, 4, kLdx>(dsts, dp, mr, nh * 32);
    __syncthreads();  // P^T and dS^T are visible to every warp

    // dV += P^T dO_t and dK += dS^T Q_t: kv rows gr.., head-dim columns gc..
    grad_tile<T, LD, NT>(acc_v, pts + gr * kLdx, dot + gc);
    grad_tile<T, LD, NT>(acc_k, dsts + gr * kLdx, qt + gc);
  }

  __syncthreads();  // every warp is done with the slots: they take dK and dV
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    stage_tile<T, NT, LD>(qs, acc_k[m], gr + 16 * m, gc);
    stage_tile<T, NT, LD>(dos, acc_v[m], gr + 16 * m, gc);
  }
  __syncthreads();
  store_tile16<T, LD>(dk + b * sdk.b + h * sdk.h, sdk.n, qs, kv0, Nkv, D, vec_out);
  store_tile16<T, LD>(dv + b * sdv.b + h * sdv.h, sdv.n, dos, kv0, Nkv, D, vec_out);
}

template <typename T, int NC>  // head dim padded to 64 * NC
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_mma(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dsum, T* __restrict__ dq, int H, int Nq, int Nkv,
                        int D, Strides sq, Strides sk, Strides sv, Strides so, Strides sdo,
                        Strides sdq, float scale, int vec, int vec_o, int vec_out) {
  constexpr int DP = 64 * NC;
  constexpr int LD = DP + 8;
  constexpr int NQ = DP / 4;  // head-dim columns of dq per warp
  constexpr int NT = NQ / 8;
  constexpr int TILE = kTile16 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][LD] q rows (resident)
  T* dos = qs + TILE;                       // [64][LD]
  T* ks = dos + TILE;                       // 2 slots of [64][LD] kv rows (streamed)
  T* vs = ks + 2 * TILE;                    // 2 slots of [64][LD]
  T* dss = vs + 2 * TILE;                   // [64 q][kLdx]: dS of the kv tile
  float* drows = reinterpret_cast<float*>(dss + kTile16 * kLdx);  // [64] D = rowsum(dO * O)
  float* lrows = drows + kTile16;                                 // [64] lse

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kTile16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mr = (warp & 3) * 16;  // scores: the warp's q rows in the tile
  const int nh = warp >> 2;        // ... and its kv half
  const int gr = (warp & 1) * 32;  // dq: the warp's q rows
  const int gc = (warp >> 1) * NQ; // ... and head-dim columns

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const T* ob = o + b * so.b + h * so.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* os = vs + TILE;  // O's rows wait in V's second slot until D is formed
  copy_tile16<T, DP>(qs, qb, sq.n, q0, Nq, D, vec);
  copy_tile16<T, DP>(dos, dob, sdo.n, q0, Nq, D, vec);
  copy_tile16<T, DP>(ks, kb, sk.n, 0, Nkv, D, vec);
  copy_tile16<T, DP>(vs, vb, sv.n, 0, Nkv, D, vec);
  copy_tile16<T, DP>(os, ob, so.n, q0, Nq, D, vec_o);
  copy_rows(lrows, lse + size_t(bh) * Nq, q0, Nq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!vec) {
    realign_tile16<T, DP>(qs, qb, sq.n, q0, D);
    realign_tile16<T, DP>(dos, dob, sdo.n, q0, D);
    realign_tile16<T, DP>(ks, kb, sk.n, 0, D);
    realign_tile16<T, DP>(vs, vb, sv.n, 0, D);
  }
  if (!vec_o) realign_tile16<T, DP>(os, ob, so.n, q0, D);
  __syncthreads();

  // D = rowsum(dO * O), both in shared memory (zeros past D): row
  // threadIdx.x / 4 by 4 lanes, 16-byte loads, combined by shuffles
  {
    const int r = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    float acc = 0.f;
#pragma unroll
    for (int c = part * 8; c < DP; c += 32) {
      const uint4 ov = *reinterpret_cast<const uint4*>(os + r * LD + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dos + r * LD + c);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = to_f32x2(ow[j], static_cast<T*>(nullptr));
        const float2 d = to_f32x2(dw[j], static_cast<T*>(nullptr));
        acc = fmaf(d.x, a.x, acc);
        acc = fmaf(d.y, a.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      drows[r] = acc;
      if (q0 + r < Nq) dsum[size_t(bh) * Nq + q0 + r] = acc;
    }
  }
  __syncthreads();  // drows is visible to every warp

  const float scale2 = scale * kLog2e;
  float l2[2], dd[2];
  bool q_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = mr + (lane >> 2) + 8 * r;  // q row in the tile
    l2[r] = lrows[i] * kLog2e;
    dd[r] = drows[i];
    q_ok[r] = q0 + i < Nq;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const int ntiles = (Nkv + kTile16 - 1) / kTile16;

  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * kTile16;
    const int slot = t & 1;
    T* kt = ks + slot * TILE;
    T* vt = vs + slot * TILE;
    if (t > 0) {  // (tile 0 landed in the prologue)
      cp_async_wait<0>();  // tile t has landed
      __syncthreads();     // ... for every thread; tile t-1's slot and dS are free
      if (!vec) {
        realign_tile16<T, DP>(kt, kb, sk.n, kv0, D);
        realign_tile16<T, DP>(vt, vb, sv.n, kv0, D);
        __syncthreads();
      }
    }
    if (t + 1 < ntiles) {  // (for t = 0: every warp is done with O in slot 1)
      const int next = slot ^ 1;
      copy_tile16<T, DP>(ks + next * TILE, kb, sk.n, kv0 + kTile16, Nkv, D, vec);
      copy_tile16<T, DP>(vs + next * TILE, vb, sv.n, kv0 + kTile16, Nkv, D, vec);
    }
    cp_async_commit();

    // S = Q K_t^T and dP = dO V_t^T: q rows mr.., kv columns 32 nh..
    float s[4][4], dp[4][4];
    score_pair<T, DP>(s, dp, qs + mr * LD, kt + nh * 32 * LD, dos + mr * LD, vt + nh * 32 * LD);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kv0 + nh * 32 + n * 8 + (lane & 3) * 2 + (e & 1);  // kv row
        const int r = e >> 1;
        const float p = q_ok[r] && j < Nkv ? exp2f(s[n][e] * scale2 - l2[r]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dd[r]) * scale;
      }
    stage_tile<T, 4, kLdx>(dss, dp, mr, nh * 32);
    __syncthreads();  // dS is visible to every warp

    // dq += dS K_t: q rows gr.., head-dim columns gc..
    grad_tile<T, LD, NT>(acc, dss + gr * kLdx, kt + gc);
  }

  __syncthreads();  // every warp is done with Q: its tile takes dq
#pragma unroll
  for (int m = 0; m < 2; ++m) stage_tile<T, NT, LD>(qs, acc[m], gr + 16 * m, gc);
  __syncthreads();
  store_tile16<T, LD>(dq + b * sdq.b + h * sdq.h, sdq.n, qs, q0, Nq, D, vec_out);
}

// --------------------------------------- bf16/f16 path, 256 < D <= 1024

// Wide 16-bit heads (the LDM's one-head transformers under bf16 training:
// D = 384, 576, 960 and the pruned 268, 404, 672), the short calls (the
// wgmma kernels below take the rest: launch_dq16, launch_dkv16). Small
// blocks fill the card where the calls are short: Nkv = 1 gives dk/dv B*H
// blocks of 8 kv rows here against B*H clusters of 64. The 64-row kernels above
// keep six 64-row tiles; at D = 1024 one 64-row 16-bit tile alone is 132 KB.
// These keep 16 q rows (one m16 tile) and 32 (dq) or 8 (dk/dv) kv rows of
// the whole head dim (padded to DP = 128 * NC2, zero-filled), 256 threads
// (8 warps), and split the head dim over the warps (16 NC2 columns each) in
// every product, so that no thread holds a whole row:
// - scores (both kernels): each warp forms the partial S = Q K^T and dP =
//   dO V^T of its head-dim slice on the tensor cores; the 8 partials meet in
//   shared memory and are summed in a fixed order (no atomics), p and ds are
//   formed in f32 and rounded to the input type once;
// - dq, one block per (batch*head, 16-row q tile): Q's and dO's fragments of
//   the warp's slice stay in registers (8 NC2 registers), K and V stream in
//   32-row tiles, one slot each (V_{t+1} is issued once the partials are
//   formed, K_{t+1} once dq += dS K_t is done); dq += dS K_t with A = dS
//   (16 x 32, from shared memory) and B = K_t (.trans), the warp's columns:
//   8 NC2 f32 accumulators a thread, at most 64. The prologue forms D =
//   rowsum(dO * O) from shared memory (16 lanes a row) and writes `dsum`;
// - dk/dv, one block per (batch*head, 8-row kv tile): K's and V's B
//   fragments of the warp's slice stay in registers; Q and dO stream in
//   16-row tiles through a two-slot cp.async ring (tile t+1 is issued as the
//   scores of tile t start). The gradients are formed transposed, dK^T +=
//   Q_t^T dS and dV^T += dO_t^T P (M = the head dim, N = the 8 kv rows, K =
//   the 16 q rows): A = Q_t^T and dO_t^T by ldmatrix .trans straight from
//   the streamed tiles, B = dS^T and P^T from two 8 x 16 tiles, and a warp
//   owns NC2 m-tiles of its slice: 8 NC2 accumulators a thread for dK and dV
//   together, where 16 kv rows of the whole head dim would take 128 at D =
//   1024 (an n-tile of 8 kv rows wastes no half of an m16 tile);
// - what they give up: the 64-row kernels' reuse of a loaded kv tile across
//   64 q rows (dq) and of a q tile across 64 kv rows (dk/dv), and, for dq,
//   a ring deeper than one slot (Q, dO, K and V take 200 KB at D = 1024);
// - copies in the widest chunk the views allow (copy_wide16 in
//   tensor_core.cuh): 16-byte cp.async for aligned views, 8 or 4 bytes for
//   the pruned widths' rows (D = 268: 536-byte rows), 2-byte loads else.
// Shared memory at D = 1024 in bf16: dq 2 * 16 * 1032 * 2 (Q, dO; then the
// partials, then dq) + 2 * 32 * 1032 * 2 (K, V) + 16 * 40 * 2 + 2 * 16 * 4 =
// 199,552 bytes; dk/dv 2 * 8 * 1032 * 2 (K, V; then dK, dV) + 2 * 2 * 16 *
// 1032 * 2 (the ring) + 2 * 8 * 16 * 8 * 4 + 2 * 8 * 24 * 2 + 2 * 32 * 4 =
// 174,336 bytes: one block (8 warps) per SM.
constexpr int kWideQ16 = 16;    // q rows a tile (wide 16-bit kernels)
constexpr int kWideKvDq = 32;   // kv rows a streamed tile of the dq kernel
constexpr int kWideKvDkv = 8;   // kv rows a block of the dk/dv kernel
constexpr int kLdRed = kWideKvDq + 4;  // row stride of dq's partial S and dP (f32)
constexpr int kLdx16 = kWideQ16 + 8;   // row stride of dk/dv's P^T and dS^T tiles

template <typename T>
__host__ __device__ constexpr int dq16_front_bytes(int dp) {  // Q and dO, or S and dP partials
  const int tiles = 2 * kWideQ16 * (dp + 8) * int(sizeof(T));
  const int red = 2 * 8 * kWideQ16 * kLdRed * 4;
  return tiles > red ? tiles : red;
}

// The warp's partial 16 x 8N tiles of S = A1 B1^T and dP = A2 B2^T over its
// KS k-steps: A fragments from registers, B from 8N rows of shared [..][LD]
// tiles (b1, b2 point at the warp's first column), into the warp's slots of
// the partial tiles r1, r2 ([16][ldr] f32 each)
template <typename T, int KS, int N2, int LD>
__device__ __forceinline__ void partial_scores(float* r1, float* r2, int ldr,
                                               const uint32_t (&a1)[KS][4],
                                               const uint32_t (&a2)[KS][4], const T* b1,
                                               const T* b2) {
  const int lane = threadIdx.x & 31;
  // B rows lane % 8 + 8 (lane / 16) of a pair of n-tiles, column half (lane / 8) % 2
  const int bo = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  float s[2 * N2][4], dp[2 * N2][4];
#pragma unroll
  for (int n = 0; n < 2 * N2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < N2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b1 + bo + np * 16 * LD + kk * 16);
      mma16816(s[2 * np], a1[kk], b[0], b[1], static_cast<T*>(nullptr));
      mma16816(s[2 * np + 1], a1[kk], b[2], b[3], static_cast<T*>(nullptr));
      ldmatrix_x4(b, b2 + bo + np * 16 * LD + kk * 16);
      mma16816(dp[2 * np], a2[kk], b[0], b[1], static_cast<T*>(nullptr));
      mma16816(dp[2 * np + 1], a2[kk], b[2], b[3], static_cast<T*>(nullptr));
    }
  const int o = (lane >> 2) * ldr + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < 2 * N2; ++n) {
    *reinterpret_cast<float2*>(r1 + o + n * 8) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(r1 + o + 8 * ldr + n * 8) = make_float2(s[n][2], s[n][3]);
    *reinterpret_cast<float2*>(r2 + o + n * 8) = make_float2(dp[n][0], dp[n][1]);
    *reinterpret_cast<float2*>(r2 + o + 8 * ldr + n * 8) = make_float2(dp[n][2], dp[n][3]);
  }
}

template <typename T, int NC2>  // head dim padded to 128 * NC2
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_mma_wide(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ o,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ dsum, T* __restrict__ dq, int H, int Nq,
                             int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                             Strides sdo, Strides sdq, float scale, int granule, int vec_out) {
  constexpr int BQ = kWideQ16, BK = kWideKvDq;
  constexpr int DP = 128 * NC2;
  constexpr int LD = DP + 8;
  constexpr int WC = DP / 8;   // the warp's head-dim columns
  constexpr int KS = WC / 16;  // its k-steps of the scores (= NC2)
  constexpr int NT = WC / 8;   // its n-tiles of dq (= 2 NC2)
  constexpr int LDX = BK + 8;  // dS rows (16-bit)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [16][LD] Q, at the end dq
  T* dos = qs + BQ * LD;                    // [16][LD] dO
  float* red_s = reinterpret_cast<float*>(smem_raw);  // [8 warps][16][kLdRed] partial S
  float* red_dp = red_s + 8 * BQ * kLdRed;            // ... and dP (over Q and dO)
  T* ks = reinterpret_cast<T*>(smem_raw + dq16_front_bytes<T>(DP));  // [32][LD] K_t
  T* vs = ks + BK * LD;                     // [32][LD] V_t (first O's rows)
  T* dss = vs + BK * LD;                    // [16][LDX] dS of the kv tile
  float* drows = reinterpret_cast<float*>(dss + BQ * LDX);  // [16] D = rowsum(dO * O)
  float* lrows = drows + BQ;                                // [16] lse

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
  copy_wide16<T, DP, BQ, kThreads>(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, D, granule);
  copy_wide16<T, DP, BQ, kThreads>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, Nq, D,
                                   granule);
  copy_wide16<T, DP, BQ, kThreads>(vs, o + b * so.b + h * so.h, so.n, q0, Nq, D, granule);
  copy_wide16<T, DP, BK, kThreads>(ks, kb, sk.n, 0, Nkv, D, granule);
  copy_rows<BQ>(lrows, lse + size_t(bh) * Nq, q0, Nq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // D = rowsum(dO * O): row t / 16 by 16 lanes, 16-byte loads (zeros past D)
  const int rr = tid >> 4, rc = (tid & 15) * 2;  // then: row and columns of the scores
  {
    float acc = 0.f;
#pragma unroll
    for (int c = (tid & 15) * 8; c < DP; c += 128) {
      const uint4 ov = *reinterpret_cast<const uint4*>(vs + rr * LD + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dos + rr * LD + c);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = to_f32x2(ow[j], static_cast<T*>(nullptr));
        const float2 d = to_f32x2(dw[j], static_cast<T*>(nullptr));
        acc = fmaf(d.x, a.x, acc);
        acc = fmaf(d.y, a.y, acc);
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((tid & 15) == 0) {
      drows[rr] = acc;
      if (q0 + rr < Nq) dsum[size_t(bh) * Nq + q0 + rr] = acc;
    }
  }
  // Q's and dO's A fragments of the warp's slice
  uint32_t qf[KS][4], df[KS][4];
  {
    const int a_off = (lane & 15) * LD + (lane >> 4) * 8 + c0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(qf[kk], qs + a_off + kk * 16);
      ldmatrix_x4(df[kk], dos + a_off + kk * 16);
    }
  }
  __syncthreads();  // D is visible; Q, dO and O are in registers or done with
  copy_wide16<T, DP, BK, kThreads>(vs, vb, sv.n, 0, Nkv, D, granule);
  cp_async_commit();
  const float l2 = lrows[rr] * kLog2e, dd = drows[rr];
  const bool q_ok = q0 + rr < Nq;
  const float scale2 = scale * kLog2e;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // dS (A, rows lane % 16, column half lane / 16); K_t (.trans) rows lane %
  // 8 + 8 ((lane / 8) % 2), column half lane / 16
  const T* xa = dss + (lane & 15) * LDX + (lane >> 4) * 8;
  const T* kt = ks + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8 + c0;

  for (int kv0 = 0; kv0 < Nkv; kv0 += BK) {
    const bool more = kv0 + BK < Nkv;
    cp_async_wait<0>();  // K_t and V_t have landed
    __syncthreads();     // ... for every thread; the previous tile's dS is done with
    partial_scores<T, KS, BK / 16, LD>(red_s + warp * BQ * kLdRed, red_dp + warp * BQ * kLdRed,
                                       kLdRed, qf, df, ks + c0, vs + c0);
    __syncthreads();  // the partials are visible; every warp is done with V_t
    if (more) copy_wide16<T, DP, BK, kThreads>(vs, vb, sv.n, kv0 + BK, Nkv, D, granule);
    cp_async_commit();
    {
      float2 s = make_float2(0.f, 0.f), dp = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 8; ++w) {  // in a fixed order
        const float2 x = *reinterpret_cast<const float2*>(red_s + (w * BQ + rr) * kLdRed + rc);
        const float2 y = *reinterpret_cast<const float2*>(red_dp + (w * BQ + rr) * kLdRed + rc);
        s.x += x.x;
        s.y += x.y;
        dp.x += y.x;
        dp.y += y.y;
      }
      const float p0 = q_ok && kv0 + rc < Nkv ? exp2f(s.x * scale2 - l2) : 0.f;
      const float p1 = q_ok && kv0 + rc + 1 < Nkv ? exp2f(s.y * scale2 - l2) : 0.f;
      *reinterpret_cast<uint32_t*>(dss + rr * LDX + rc) =
          pack2(p0 * (dp.x - dd) * scale, p1 * (dp.y - dd) * scale, static_cast<T*>(nullptr));
    }
    __syncthreads();  // dS is visible to every warp
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // dq += dS K_t: the warp's columns
      uint32_t a[4];
      ldmatrix_x4(a, xa + kk * 16);
#pragma unroll
      for (int dc = 0; dc < NT / 2; ++dc) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, kt + kk * 16 * LD + dc * 16);
        mma16816(acc[2 * dc], a, bf[0], bf[1], static_cast<T*>(nullptr));
        mma16816(acc[2 * dc + 1], a, bf[2], bf[3], static_cast<T*>(nullptr));
      }
    }
    __syncthreads();  // every warp is done with K_t and dS
    if (more) copy_wide16<T, DP, BK, kThreads>(ks, kb, sk.n, kv0 + BK, Nkv, D, granule);
    cp_async_commit();
  }

  // dq rounded once, through the Q tile (the partials are done with)
  T* row = qs + (lane >> 2) * LD + c0 + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(row + n * 8) =
        pack2(acc[n][0], acc[n][1], static_cast<T*>(nullptr));
    *reinterpret_cast<uint32_t*>(row + 8 * LD + n * 8) =
        pack2(acc[n][2], acc[n][3], static_cast<T*>(nullptr));
  }
  __syncthreads();
  store_wide16<BQ, LD, kThreads>(dq + b * sdq.b + h * sdq.h, sdq.n, qs, q0, Nq, D, vec_out);
}

template <typename T, int NC2>  // head dim padded to 128 * NC2
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_mma_wide(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dsum,
                              T* __restrict__ dk, T* __restrict__ dv, int H, int Nq, int Nkv,
                              int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                              Strides sdk, Strides sdv, float scale, int granule, int vec_out) {
  constexpr int BQ = kWideQ16, BKV = kWideKvDkv;
  constexpr int DP = 128 * NC2;
  constexpr int LD = DP + 8;
  constexpr int WC = DP / 8;   // the warp's head-dim columns
  constexpr int KS = WC / 16;  // its k-steps of the scores, m-tiles of dK^T and dV^T (= NC2)
  constexpr int TILE = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [8][LD] K, at the end dK
  T* vs = ks + BKV * LD;                    // [8][LD] V, at the end dV
  T* qs = vs + BKV * LD;                    // 2 slots of [16][LD] q rows (streamed)
  T* dos = qs + 2 * TILE;                   // 2 slots of [16][LD]
  float* red_s = reinterpret_cast<float*>(dos + 2 * TILE);  // [8 warps][16 q][8 kv]
  float* red_dp = red_s + 8 * BQ * BKV;                     // ... of S and of dP
  T* pts = reinterpret_cast<T*>(red_dp + 8 * BQ * BKV);    // [8 kv][kLdx16] P^T
  T* dsts = pts + BKV * kLdx16;                             // [8 kv][kLdx16] dS^T
  float* rows = reinterpret_cast<float*>(dsts + BKV * kLdx16);  // 2 slots of lse[16], D[16]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.y * BKV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = warp * WC;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + size_t(bh) * Nq;
  const float* db = dsum + size_t(bh) * Nq;
  copy_wide16<T, DP, BKV, kThreads>(ks, k + b * sk.b + h * sk.h, sk.n, kv0, Nkv, D, granule);
  copy_wide16<T, DP, BKV, kThreads>(vs, v + b * sv.b + h * sv.h, sv.n, kv0, Nkv, D, granule);
  copy_wide16<T, DP, BQ, kThreads>(qs, qb, sq.n, 0, Nq, D, granule);
  copy_wide16<T, DP, BQ, kThreads>(dos, dob, sdo.n, 0, Nq, D, granule);
  copy_rows<BQ>(rows, lb, 0, Nq);
  copy_rows<BQ>(rows + BQ, db, 0, Nq);
  cp_async_commit();

  uint32_t kf[KS][2], vf[KS][2];  // K's and V's B fragments of the warp's slice
  float acc_k[KS][4], acc_v[KS][4];  // dK^T and dV^T: m-tiles of the slice x 8 kv
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[m][e] = acc_v[m][e] = 0.f;
  const float scale2 = scale * kLog2e;
  // the scores' pair of thread t < 128: q row t / 8, kv row t % 8 of the tile
  const int pi = tid >> 3, pj = tid & 7;
  const bool kv_ok = kv0 + pj < Nkv;
  // A (Q_t, dO_t): rows lane % 16, column half lane / 16; A^T (.trans):
  // matrix lane / 8 holds q rows 8 (lane / 16) .., head-dim columns 8 ((lane
  // / 8) % 2) ..; B of the gradients: dS^T (matrices 0, 1) and P^T (2, 3),
  // kv rows lane % 8, q columns 8 ((lane / 8) % 2) ..
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8 + c0;
  const int at_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8 + c0;
  const T* bx = ((lane >> 4) ? pts : dsts) + (lane & 7) * kLdx16 + ((lane >> 3) & 1) * 8;
  const int ntiles = (Nq + BQ - 1) / BQ;

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * BQ;
    const int slot = t & 1;
    const T* qt = qs + slot * TILE;
    const T* dot = dos + slot * TILE;
    const float* lrow = rows + slot * 2 * BQ;
    const float* drow = lrow + BQ;
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // ... for every thread; tile t-1's slot, P^T and dS^T are free
    if (t == 0) {
      // B rows lane % 8, column half (lane / 8) % 2; matrices 2, 3 from V
      const T* kv = ((lane >> 4) ? vs : ks) + (lane & 7) * LD + ((lane >> 3) & 1) * 8 + c0;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, kv + kk * 16);
        kf[kk][0] = r[0];
        kf[kk][1] = r[1];
        vf[kk][0] = r[2];
        vf[kk][1] = r[3];
      }
    }
    if (t + 1 < ntiles) {
      const int next = slot ^ 1;
      copy_wide16<T, DP, BQ, kThreads>(qs + next * TILE, qb, sq.n, q0 + BQ, Nq, D, granule);
      copy_wide16<T, DP, BQ, kThreads>(dos + next * TILE, dob, sdo.n, q0 + BQ, Nq, D, granule);
      copy_rows<BQ>(rows + next * 2 * BQ, lb, q0 + BQ, Nq);
      copy_rows<BQ>(rows + next * 2 * BQ + BQ, db, q0 + BQ, Nq);
    }
    cp_async_commit();

    // the warp's partial S = Q_t K^T and dP = dO_t V^T (16 q x 8 kv)
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qt + a_off + kk * 16);
      mma16816(s, a, kf[kk][0], kf[kk][1], static_cast<T*>(nullptr));
      ldmatrix_x4(a, dot + a_off + kk * 16);
      mma16816(dp, a, vf[kk][0], vf[kk][1], static_cast<T*>(nullptr));
    }
    {
      const int o = warp * BQ * BKV + (lane >> 2) * BKV + (lane & 3) * 2;
      *reinterpret_cast<float2*>(red_s + o) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(red_s + o + 8 * BKV) = make_float2(s[2], s[3]);
      *reinterpret_cast<float2*>(red_dp + o) = make_float2(dp[0], dp[1]);
      *reinterpret_cast<float2*>(red_dp + o + 8 * BKV) = make_float2(dp[2], dp[3]);
    }
    __syncthreads();  // the partials are visible
    if (tid < BQ * BKV) {
      float sv_ = 0.f, dpv = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {  // in a fixed order
        sv_ += red_s[w * BQ * BKV + tid];
        dpv += red_dp[w * BQ * BKV + tid];
      }
      const float p = q0 + pi < Nq && kv_ok ? exp2f(sv_ * scale2 - lrow[pi] * kLog2e) : 0.f;
      reinterpret_cast<uint16_t*>(pts)[pj * kLdx16 + pi] = round16(p, static_cast<T*>(nullptr));
      reinterpret_cast<uint16_t*>(dsts)[pj * kLdx16 + pi] =
          round16(p * (dpv - drow[pi]) * scale, static_cast<T*>(nullptr));
    }
    __syncthreads();  // P^T and dS^T are visible to every warp

    // dK^T += Q_t^T dS and dV^T += dO_t^T P: the warp's m-tiles
    uint32_t bfr[4];
    ldmatrix_x4(bfr, bx);
#pragma unroll
    for (int m = 0; m < KS; ++m) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, qt + at_off + m * 16);
      mma16816(acc_k[m], a, bfr[0], bfr[1], static_cast<T*>(nullptr));
      ldmatrix_x4_trans(a, dot + at_off + m * 16);
      mma16816(acc_v[m], a, bfr[2], bfr[3], static_cast<T*>(nullptr));
    }
  }

  __syncthreads();  // K and V are in registers: their tiles take dK and dV
  {
    uint16_t* dks = reinterpret_cast<uint16_t*>(ks);
    uint16_t* dvs = reinterpret_cast<uint16_t*>(vs);
    const int kvr = (lane & 3) * 2;  // kv rows of c0, c1 (c2, c3: the same)
#pragma unroll
    for (int m = 0; m < KS; ++m) {
      const int d = c0 + 16 * m + (lane >> 2);  // head-dim row of c0, c1 (c2, c3: + 8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (kvr + (e & 1)) * LD + d + 8 * (e >> 1);
        dks[at] = round16(acc_k[m][e], static_cast<T*>(nullptr));
        dvs[at] = round16(acc_v[m][e], static_cast<T*>(nullptr));
      }
    }
  }
  __syncthreads();
  store_wide16<BKV, LD, kThreads>(dk + b * sdk.b + h * sdk.h, sdk.n, ks, kv0, Nkv, D, vec_out);
  store_wide16<BKV, LD, kThreads>(dv + b * sdv.b + h * sdv.h, sdv.n, vs, kv0, Nkv, D, vec_out);
}

template <typename T>
size_t dq_smem_mma_wide(int nc2) {
  const int dp = 128 * nc2;
  return dq16_front_bytes<T>(dp) +
         size_t(2 * kWideKvDq * (dp + 8) + kWideQ16 * (kWideKvDq + 8)) * sizeof(T) +
         2 * kWideQ16 * sizeof(float);
}

template <typename T>
size_t dkv_smem_mma_wide(int nc2) {
  const int dp = 128 * nc2;
  return size_t(2 * kWideKvDkv + 4 * kWideQ16) * (dp + 8) * sizeof(T) +
         2 * 8 * kWideQ16 * kWideKvDkv * sizeof(float) +
         2 * kWideKvDkv * kLdx16 * sizeof(T) + 4 * kWideQ16 * sizeof(float);
}

// ------------------------- bf16/f16 path, 256 < D <= 1024, on wgmma (64-row tiles)

// Replaces, for bf16/f16 at 256 < D <= 1024, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` of `_flash_bwd_call` (diff_pruning_tpu/ops/attention.py:
// 143, 170, 205): the LDM's one-head transformers under bf16 training (D =
// 384, 576, 960 and the pruned 268, 404, 672, each also against the class
// token, Nkv = 1).
//
// What bounds them on the H100: the tensor cores (989 TFLOP/s) by the count
// of operations at the main shapes (~500 flops a byte at (1024, 1024, 384));
// what keeps a kernel from that rate is feeding them: how often a streamed
// row is fetched again from L2, and the shared-memory bytes each product
// reads. The 16-row kernels above fetch every K/V row once per 16 q rows
// (dq) and every Q/dO row once per 8 kv rows (dk/dv); these fetch them once
// per 64: bytes from L2 per call 4 B Nq Nkv D / 64 for each kernel, against
// / 16 and / 8.
//
// The design (both kernels; Hopper's warpgroup products, tensor_core.cuh):
// - 64 rows a block on two warpgroups (256 threads), one m64 row of
//   `wgmma` (f32 accumulators). The block holds its 64 rows of two inputs
//   of DB head-dim columns resident in shared memory (dq: Q and dO; dk/dv:
//   K and V) and streams tiles of the other two (dq: 32-row K_t and V_t;
//   dk/dv: Q_t and dO_t, with their lse and D, 64 rows where two such
//   stages fit, DB = 192, else 32) through a cp.async ring of 2-4 stages,
//   one barrier a stage: each stage's copy overlaps the products of the
//   stages before it. Operands lie in the 128-byte swizzle (copy_sw128), so
//   a warp's copies run along the rows and its products read distinct banks.
// - The two score products are split between the warpgroups, m64nNk16
//   from shared memory over the block's head-dim columns: dq forms S = Q
//   K_t^T in warpgroup 0 and dP = dO V_t^T in warpgroup 1; dk/dv forms them
//   transposed, S^T = K Q_t^T and dP^T = V dO_t^T, so that its rows are kv
//   rows. Each warpgroup writes its accumulator to shared memory in its
//   register order (conflict-free), and after one barrier every thread
//   reads the (row, column) pairs it holds of both: the same values in both
//   warpgroups. Where a cluster splits the head dim, the partials of its Z
//   blocks are added in rank order through distributed shared memory (the
//   same sum, in the same bits, in every block; no atomics), and the
//   cluster barrier replaces the block's.
// - p = exp2(s scale log2e - lse log2e) and ds = p (dp - D) scale in f32
//   on the accumulator layout, rounded once to the input type as the
//   register A operand of the gradient products (m64n64k16, B = the streamed
//   tile, MN-major): dq += dS K_t, each warpgroup half of the block's
//   columns; dk/dv: warpgroup 0 dK += dS^T Q_t and warpgroup 1 dV += P^T
//   dO_t over all of the block's columns.
// - Registers bound the block's columns: dq keeps 64 x DB / 2 f32 a
//   warpgroup (DB = 128 NW: 384, or 256 and 384 in clusters), dk/dv 64 x DB
//   (DB = 64 NC: 192 or 256, always in a cluster of Z = 2-4 blocks); Z
//   blocks a tile cover the head dim padded to DB Z.
// - dq forms D = rowsum(dO * O) as the diagonal of dO O^T (O's columns
//   copied into the ring's last slot before the loop), with the products
//   and k-steps that form dP, and both in the column chains in which dk/dv
//   forms dP^T (score_chains): where a row's one valid kv row is its O row
//   (Nkv = 1), dp - D is exactly 0 in both wgmma kernels, so dq and dk,
//   zero in exact arithmetic, come out 0 rather than as f32 noise. The
//   cluster adds the parts in rank order;
//   rank 0 writes `dsum`.
// - Rows past Nq/Nkv and columns past D are zero-filled in shared memory
//   and their p set to exactly 0; copies take the widest chunk the views
//   allow (16, 8 or 4 bytes by cp.async, or 2-byte loads). The gradients
//   leave through the resident tiles, rounded once, in 16-byte stores where
//   aligned.
// - The short calls go to the 16-row kernels above: a grid of few 64-row
//   tiles leaves most SMs idle and a short loop cannot hide the prologue.
//   The wgmma dq takes calls with Nkv >= 256 or at least 256 q tiles, the
//   wgmma dk/dv calls with at least 64 kv tiles. Device ms a call at B =
//   16 (bwd_dispatch.py; NVIDIA H100 80GB HBM3, 700 W), wgmma against
//   16-row: dq (1024, 1024, 384) 0.222 / 0.610, (1024, 1, 384) 0.030 /
//   0.044, (256, 256, 576) 0.054 / 0.060, but (256, 1, 576) 0.018 / 0.012
//   and (64, 64, 960) 0.027 / 0.013; dk/dv (1024, 1024, 384) 0.450 / 0.727,
//   (256, 256, 576) 0.085 / 0.102, but (1024, 1, 384) 0.107 / 0.074 and
//   (64, 64, 960) 0.025 / 0.013.
// Shared memory: the resident pair 256 DB bytes, a stage 4 R DB (R rows),
// the partials 2 x 64 x R f32 (two buffers in a cluster), 2 KB of row
// values and alignment: 215,040 bytes for dq at DB = 384 (2 stages) and
// for dk/dv at DB = 192 (64-row stages, 2), 231,424 at DB = 256 (4
// stages); one block an SM.

constexpr int kDqRows = 32;  // kv rows a stage of the dq kernel

// the S and dP (or S^T and dP^T) partials of a block: two products of 64 x
// R f32 in register order ([2][R / 2][128]), in two buffers in a cluster
__host__ __device__ constexpr int bwd16_red_floats(int r, int z) {
  return (z > 1 ? 2 : 1) * 2 * (r / 2) * 128;
}
// the ring's stages (two R-row tiles of DB columns each): as many as the
// block's 227 KB hold, up to 4, beside the resident pair, the partials and
// 2 KB of row values and alignment
template <int DB, int R, int Z>
__host__ __device__ constexpr int bwd16_stages() {
  return (232448 - 2048 - 4 * bwd16_red_floats(R, Z) - 256 * DB) / (4 * R * DB) < 4
             ? (232448 - 2048 - 4 * bwd16_red_floats(R, Z) - 256 * DB) / (4 * R * DB)
             : 4;
}
template <int DB, int R, int Z>
__host__ __device__ constexpr int bwd16_smem_bytes() {
  return (256 + 4 * R * bwd16_stages<DB, R, Z>()) * DB + 4 * bwd16_red_floats(R, Z) + 2048;
}

// the score products by width: m64n32k16 and m64n64k16 from shared memory
template <typename T>
__device__ __forceinline__ void gmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  Gmma<T>::ss32(d, a, b);
}
template <typename T>
__device__ __forceinline__ void gmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  Gmma<T>::ss64(d, a, b);
}

// NCH n64 accumulators of a warpgroup (columns col0 + 64 n ..) rounded into
// a shared [64][..] tile laid out as copy_sw128 lays it out
template <typename T, int NCH>
__device__ __forceinline__ void acc_to_sw128(T* tile, const float (&acc)[NCH][32], int col0) {
  uint16_t* out = reinterpret_cast<uint16_t*>(tile);
  const int lane = threadIdx.x & 31;
  const int row_a = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NCH; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        const int c = (col0 + 64 * n) / 8 + j;  // the 16-byte chunk of the row
        *reinterpret_cast<uint32_t*>(out + (c >> 3) * 64 * 64 + row * 64 +
                                     (((c & 7) ^ (row & 7)) << 3) + 2 * (lane & 3)) =
            pack2(acc[n][4 * j + 2 * r], acc[n][4 * j + 2 * r + 1], static_cast<T*>(nullptr));
      }
}

// The cluster's scores at this thread's NE accumulator positions: the sum
// over the Z blocks, in rank order, of the partials in `part` (this block's
// [2][NE][128] buffer: warpgroup 0's product, then warpgroup 1's); `both`:
// the second product too, else only the first
template <int Z, int NE>
__device__ __forceinline__ void sum_partials(float (&s)[NE], float (&x)[NE], const float* part,
                                             uint32_t rank, bool both) {
  const int i = threadIdx.x & 127;
#pragma unroll
  for (int e = 0; e < NE; ++e) s[e] = x[e] = 0.f;
#pragma unroll
  for (int r = 0; r < Z; ++r) {
    if (r == int(rank)) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        s[e] += part[e * 128 + i];
        if (both) x[e] += part[(NE + e) * 128 + i];
      }
    } else {
      const uint32_t at = cluster_map(part + i, r);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        s[e] += ld_cluster(at + e * 128 * 4);
        if (both) x[e] += ld_cluster(at + (NE + e) * 128 * 4);
      }
    }
  }
}

// the block's barrier, or the cluster's where Z blocks split the head dim
template <int Z>
__device__ __forceinline__ void tile_sync() {
  if constexpr (Z > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// acc = A B^T (64 x 32) over the block's k-steps, m64n32k16 from shared
// memory (A: a 64-row tile, B: an R-row tile, both K-major in copy_sw128's
// slabs), accumulated as the dk/dv kernel accumulates its S^T and dP^T:
// one chain a 192-column group where the dq block holds 384 columns (NW =
// 3), the chains then added in order; so that dq's D and the dk/dv
// kernel's dP^T come out in the same bits where they are equal in exact
// arithmetic (Nkv = 1)
template <typename T, int NW, int R>
__device__ __forceinline__ void score_chains(float (&acc)[16], uint64_t a, uint64_t b,
                                             int ksteps) {
  auto at = [](int kk, int rows) {  // k-step kk's start in 64-column slabs of `rows` rows
    return uint64_t(((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4);
  };
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  fence_regs(acc);
  wgmma_fence();
  if constexpr (NW == 3) {
    constexpr int KC = 12;  // k-steps of the first chain: 192 columns
    float hi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) hi[e] = 0.f;
    fence_regs(hi);
    for (int kk = 0; kk < min(ksteps, KC); ++kk) Gmma<T>::ss32(acc, a + at(kk, 64), b + at(kk, R));
    for (int kk = KC; kk < ksteps; ++kk) Gmma<T>::ss32(hi, a + at(kk, 64), b + at(kk, R));
    wgmma_commit_wait();
    fence_regs(acc);
    fence_regs(hi);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += hi[e];
  } else {
    for (int kk = 0; kk < ksteps; ++kk) Gmma<T>::ss32(acc, a + at(kk, 64), b + at(kk, R));
    wgmma_commit_wait();
    fence_regs(acc);
  }
}

template <typename T, int NW, int Z>  // n64 chunks of dq a warpgroup; blocks (a cluster) a tile
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_wgmma_wide(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ o,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               float* __restrict__ dsum, T* __restrict__ dq, int H, int Nq,
                               int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                               Strides sdo, Strides sdq, float scale, int granule, int vec_out) {
  constexpr int DB = 128 * NW;  // head-dim columns a block
  constexpr int BK = kDqRows;   // kv rows a stage
  constexpr int TILE = BK * DB;
  constexpr int NS = bwd16_stages<DB, BK, Z>();
  static_assert(NS >= 2, "a ring of two stages at least");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  T* dos = qs + 64 * DB;    // qs: Q [64][DB], at the end dq; dos: dO [64][DB]
  T* ring = dos + 64 * DB;  // NS stages of K_t [32][DB], V_t [32][DB]; first O in the last
  float* red = reinterpret_cast<float*>(ring + NS * 2 * TILE);  // (2 x) [2][16][128] partials
  float* dpart = red + bwd16_red_floats(BK, Z);  // [64] this block's part of rowsum(dO * O)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * 64;
  const uint32_t rank = Z > 1 ? cluster_rank() : 0;  // = blockIdx.z
  const int c0 = rank * DB;  // the block's first head-dim column
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int row_a = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows: row_a, +8

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  int next = 0;  // the next stage to issue: K and V of kv tile `next`
  auto issue = [&](int slot) {
    const int t = next * BK;
    if (t < Nkv) {
      copy_sw128<BK, DB>(ring + slot * 2 * TILE, kb, sk.n, t, Nkv, c0, D, granule);
      copy_sw128<BK, DB>(ring + slot * 2 * TILE + TILE, vb, sv.n, t, Nkv, c0, D, granule);
    }
    cp_async_commit();
    ++next;
  };
  // one barrier a stage: once every thread is past it, the slot of the stage
  // before (its products waited for) is free and takes the stage NS - 1 ahead
  int slot = 0;
  auto next_stage = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));  // this stage has landed
    fence_proxy_async();
    __syncthreads();
    issue(slot == 0 ? NS - 1 : slot - 1);
    T* at = ring + slot * 2 * TILE;
    slot = slot == NS - 1 ? 0 : slot + 1;
    return at;
  };
  copy_sw128<64, DB>(qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq, c0, D, granule);
  copy_sw128<64, DB>(dos, dout + b * sdo.b + h * sdo.h, sdo.n, q0, Nq, c0, D, granule);
  T* os = ring + (NS - 1) * 2 * TILE;  // O [64][DB], in the slot the first stage refills
  copy_sw128<64, DB>(os, o + b * so.b + h * so.h, so.n, q0, Nq, c0, D, granule);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);  // (Q, dO and O with the first)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));  // Q, dO and O have landed
  fence_proxy_async();
  __syncthreads();

  // D = rowsum(dO * O) over the block's columns: the diagonal of dO O^T,
  // formed by the products and k-steps that form dP = dO V_t^T below, so that
  // dp - D is exactly 0 where a row's one valid kv row is its O row (Nkv =
  // 1: dq, zero in exact arithmetic, comes out 0); warpgroup h forms dO
  // against O's rows 32 h .. 32 h + 31
  const int ksteps = min(DB, D - c0 + 15) >> 4;  // the block's k-steps holding columns < D
  const uint64_t dodesc = gmma_desc(dos, 16, 1024);
  {
    float oacc[16];  // (O's rows in 64-row slabs: R = 64)
    score_chains<T, NW, 64>(oacc, dodesc, gmma_desc(os + wg * 32 * 64, 16, 1024), ksteps);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int row = row_a + 8 * ((e >> 1) & 1);
      if (row == 32 * wg + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1)) dpart[row] = oacc[e];
    }
  }
  tile_sync<Z>();
  float dd[2], l2[2];
  bool q_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    dd[r] = 0.f;
#pragma unroll
    for (int z = 0; z < Z; ++z)  // the cluster's parts, in rank order
      dd[r] += z == int(rank) ? dpart[row] : ld_cluster(cluster_map(dpart + row, z));
    q_ok[r] = q0 + row < Nq;
    l2[r] = q_ok[r] ? lse[size_t(bh) * Nq + q0 + row] * kLog2e : 0.f;
    if (rank == 0 && wg == 0 && (lane & 3) == 0 && q_ok[r])
      dsum[size_t(bh) * Nq + q0 + row] = dd[r];
  }

  float dacc[NW][32];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dacc[n][e] = 0.f;
  const float scale2 = scale * kLog2e;
  // warpgroup 0 forms S = Q K_t^T, warpgroup 1 dP = dO V_t^T: A (64 rows) and
  // B (32 rows) K-major in 64-column slabs of 128-byte rows, k-step kk in
  // slab kk / 4, 32 (kk % 4) bytes in
  const uint64_t adesc = wg ? dodesc : gmma_desc(qs, 16, 1024);
  for (int t = 0, it = 0; t < Nkv; t += BK, ++it) {
    const T* st = next_stage();  // K_t and V_t have landed
    float sacc[16];
    score_chains<T, NW, BK>(sacc, adesc, gmma_desc(wg ? st + TILE : st, 16, 1024), ksteps);
    // the partials alternate between two buffers in a cluster, so one
    // cluster barrier a tile keeps a buffer from being written again before
    // the other blocks have read it
    float* part = red + (Z > 1 ? (it & 1) * bwd16_red_floats(BK, 1) : 0);
#pragma unroll
    for (int e = 0; e < 16; ++e) part[(wg * 16 + e) * 128 + (tid & 127)] = sacc[e];
    tile_sync<Z>();
    float s[16], dp[16];
    sum_partials<Z>(s, dp, part, rank, true);
    // dS on rows row_a (e % 4 < 2) and row_a + 8, kv column 8 (e / 4) + 2
    // (lane % 4) + e % 2 of the tile, as the A operand of the 2 k-steps
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = ((e + u) >> 1) & 1;
        const int col = t + 8 * ((e + u) >> 2) + 2 * (lane & 3) + u;
        const float p = q_ok[r] && col < Nkv ? exp2f(s[e + u] * scale2 - l2[r]) : 0.f;
        ds[u] = p * (dp[e + u] - dd[r]) * scale;
      }
      pa[e >> 3][(e & 7) >> 1] = pack2(ds[0], ds[1], static_cast<T*>(nullptr));
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) fence_regs(dacc[n]);
    wgmma_fence();
    // dq += dS K_t: B = K_t MN-major (the head dim contiguous), the
    // warpgroup's n64 chunks of the block's columns
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
      for (int n = 0; n < NW; ++n)
        Gmma<T>::rs64(dacc[n], pa[kt],
                      gmma_desc(st + (wg * NW + n) * BK * 64 + kt * 16 * 64, BK * 128, 1024));
    wgmma_commit_wait();
#pragma unroll
    for (int n = 0; n < NW; ++n) fence_regs(dacc[n]);
  }
  // the other blocks may still read this one's partials and D part
  if constexpr (Z > 1) cluster_sync();
  // dq rounded once into the Q tile (free: every S is formed), then out
  acc_to_sw128<T, NW>(qs, dacc, wg * 64 * NW);
  __syncthreads();
  store_sw128<64, DB>(dq + b * sdq.b + h * sdq.h, sdq.n, qs, q0, Nq, c0, D, vec_out);
}

// q rows a stage of the dk/dv kernel: 64 where the shared memory holds two
// stages of them (a block of 192 columns), else 32
__host__ __device__ constexpr int bwd16_dkv_rows(int nc) { return nc == 3 ? 64 : 32; }

template <typename T, int NC, int Z>  // n64 chunks of dK and dV; blocks (a cluster) a tile
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_wgmma_wide(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ dsum,
                                T* __restrict__ dk, T* __restrict__ dv, int H, int Nq, int Nkv,
                                int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                                Strides sdk, Strides sdv, float scale, int granule,
                                int vec_out) {
  constexpr int DB = 64 * NC;  // head-dim columns a block
  constexpr int BQ = bwd16_dkv_rows(NC);  // q rows a stage
  constexpr int NE = BQ / 2;              // accumulators of a score product
  constexpr int TILE = BQ * DB;
  constexpr int NS = bwd16_stages<DB, BQ, Z>();
  static_assert(NS >= 2, "a ring of two stages at least");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  T* vs = ks + 64 * DB;    // ks: K [64][DB], at the end dK; vs: V, at the end dV
  T* ring = vs + 64 * DB;  // NS stages of Q_t [32][DB], dO_t [32][DB]
  float* red = reinterpret_cast<float*>(ring + NS * 2 * TILE);  // (2 x) [2][16][128] partials
  float* rows = red + bwd16_red_floats(BQ, Z);  // NS x (lse [BQ], D [BQ]) of the stages' rows

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.y * 64;
  const uint32_t rank = Z > 1 ? cluster_rank() : 0;  // = blockIdx.z
  const int c0 = rank * DB;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int row_a = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's kv rows: row_a, +8

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + size_t(bh) * Nq;
  const float* db = dsum + size_t(bh) * Nq;
  int next = 0;  // the next stage to issue: Q, dO, lse and D of q tile `next`
  auto issue = [&](int slot) {
    const int t = next * BQ;
    if (t < Nq) {
      copy_sw128<BQ, DB>(ring + slot * 2 * TILE, qb, sq.n, t, Nq, c0, D, granule);
      copy_sw128<BQ, DB>(ring + slot * 2 * TILE + TILE, dob, sdo.n, t, Nq, c0, D, granule);
      copy_rows<BQ>(rows + slot * 2 * BQ, lb, t, Nq);
      copy_rows<BQ>(rows + slot * 2 * BQ + BQ, db, t, Nq);
    }
    cp_async_commit();
    ++next;
  };
  int slot = 0;
  auto next_stage = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));  // this stage has landed
    fence_proxy_async();
    __syncthreads();
    issue(slot == 0 ? NS - 1 : slot - 1);
    const int at = slot;
    slot = slot == NS - 1 ? 0 : slot + 1;
    return at;
  };
  copy_sw128<64, DB>(ks, k + b * sk.b + h * sk.h, sk.n, kv0, Nkv, c0, D, granule);
  copy_sw128<64, DB>(vs, v + b * sv.b + h * sv.h, sv.n, kv0, Nkv, c0, D, granule);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);  // (K and V with the first)

  // warpgroup 0: dK (64 kv rows x the block's columns), 1: dV
  float gacc[NC][32];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) gacc[n][e] = 0.f;
  bool kv_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kv_ok[r] = kv0 + row_a + 8 * r < Nkv;
  const float scale2 = scale * kLog2e;
  const int ksteps = min(DB, D - c0 + 15) >> 4;
  // warpgroup 0 forms S^T = K Q_t^T, warpgroup 1 dP^T = V dO_t^T (A: 64
  // resident rows, B: 32 streamed rows, both K-major)
  const uint64_t adesc = gmma_desc(wg ? vs : ks, 16, 1024);
  for (int t = 0, it = 0; t < Nq; t += BQ, ++it) {
    const int sl = next_stage();  // Q_t, dO_t and their rows have landed
    const T* st = ring + sl * 2 * TILE + wg * TILE;  // warpgroup 0: Q_t, 1: dO_t
    const float* lrow = rows + sl * 2 * BQ;
    const float* drow = lrow + BQ;
    float sacc[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) sacc[e] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
    const uint64_t bdesc = gmma_desc(st, 16, 1024);
    for (int kk = 0; kk < ksteps; ++kk)
      gmma_ss<T>(sacc, adesc + (((kk >> 2) * 8192 + (kk & 3) * 32) >> 4),
                 bdesc + (((kk >> 2) * BQ * 128 + (kk & 3) * 32) >> 4));
    wgmma_commit_wait();
    fence_regs(sacc);
    float* part = red + (Z > 1 ? (it & 1) * bwd16_red_floats(BQ, 1) : 0);
#pragma unroll
    for (int e = 0; e < NE; ++e) part[(wg * NE + e) * 128 + (tid & 127)] = sacc[e];
    tile_sync<Z>();
    float s[NE], dp[NE];
    sum_partials<Z>(s, dp, part, rank, wg == 0);  // warpgroup 1 needs only S
    // kv rows row_a (e % 4 < 2) and row_a + 8, q column 8 (e / 4) + 2 (lane
    // % 4) + e % 2 of the tile: dS^T (warpgroup 0) or P^T (1) as the A
    // operand of the BQ / 16 k-steps
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int e = 0; e < NE; e += 2) {
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = ((e + u) >> 1) & 1;
        const int col = 8 * ((e + u) >> 2) + 2 * (lane & 3) + u;
        const float p =
            kv_ok[r] && t + col < Nq ? exp2f(s[e + u] * scale2 - lrow[col] * kLog2e) : 0.f;
        x[u] = wg ? p : p * (dp[e + u] - drow[col]) * scale;
      }
      pa[e >> 3][(e & 7) >> 1] = pack2(x[0], x[1], static_cast<T*>(nullptr));
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_regs(gacc[n]);
    wgmma_fence();
    // dK += dS^T Q_t, dV += P^T dO_t: B = the streamed tile MN-major
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        Gmma<T>::rs64(gacc[n], pa[kt], gmma_desc(st + n * BQ * 64 + kt * 16 * 64, BQ * 128, 1024));
    wgmma_commit_wait();
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_regs(gacc[n]);
  }
  if constexpr (Z > 1) cluster_sync();  // the other blocks may still read the partials
  // dK into K's tile, dV into V's (each read only by its own warpgroup's
  // products, all done), rounded once, then out
  acc_to_sw128<T, NC>(wg ? vs : ks, gacc, 0);
  __syncthreads();
  store_sw128<64, DB>(dk + b * sdk.b + h * sdk.h, sdk.n, ks, kv0, Nkv, c0, D, vec_out);
  store_sw128<64, DB>(dv + b * sdv.b + h * sdv.h, sdv.n, vs, kv0, Nkv, c0, D, vec_out);
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

// 16-byte copies of 16-bit values need 16-byte aligned bases and strides
bool aligned16_half(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * 2) % 16 == 0 &&
         (s.h * 2) % 16 == 0 && (s.n * 2) % 16 == 0;
}

template <typename T, int NC>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* dsum, void* dq, int B,
                          int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                          Strides so, Strides sdo, Strides sdq, float scale,
                          cudaStream_t stream) {
  const size_t smem = size_t(6 * kTile16 * (64 * NC + 8) + kTile16 * kLdx) * sizeof(T) +
                      2 * kTile16 * sizeof(float);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel_mma<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int vec = aligned16_half(q, sq) && aligned16_half(k, sk) && aligned16_half(v, sv) &&
                  aligned16_half(dout, sdo);
  const int vec_o = aligned16_half(o, so);
  const int vec_out = aligned16_half(dq, sdq) && D % 8 == 0;
  const dim3 grid(B * H, (Nq + kTile16 - 1) / kTile16);
  flash_bwd_dq_kernel_mma<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), H,
      Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale, vec, vec_o, vec_out);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dsum, void* dk, void* dv, int B,
                           int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                           Strides sdo, Strides sdk, Strides sdv, float scale,
                           cudaStream_t stream) {
  const size_t smem = size_t(6 * kTile16 * (64 * NC + 8) + 2 * kTile16 * kLdx) * sizeof(T) +
                      4 * kTile16 * sizeof(float);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel_mma<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int vec = aligned16_half(q, sq) && aligned16_half(k, sk) && aligned16_half(v, sv) &&
                  aligned16_half(dout, sdo);
  const int vec_out = aligned16_half(dk, sdk) && aligned16_half(dv, sdv) && D % 8 == 0;
  const dim3 grid(B * H, (Nkv + kTile16 - 1) / kTile16);
  flash_bwd_dkv_kernel_mma<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H, Nq,
      Nkv, D, sq, sk, sv, sdo, sdk, sdv, scale, vec, vec_out);
  return cudaGetLastError();
}

template <typename T, int NC2>
cudaError_t launch_dq_mma_wide(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* dsum, void* dq, int B,
                               int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                               Strides so, Strides sdo, Strides sdq, float scale,
                               cudaStream_t stream) {
  const size_t smem = dq_smem_mma_wide<T>(NC2);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel_mma_wide<T, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int granule = copy_granule(
      view_bits(q, sq.b, sq.h, sq.n) | view_bits(k, sk.b, sk.h, sk.n) |
      view_bits(v, sv.b, sv.h, sv.n) | view_bits(o, so.b, so.h, so.n) |
      view_bits(dout, sdo.b, sdo.h, sdo.n));
  const int vec_out = aligned16_half(dq, sdq) && D % 8 == 0;
  const dim3 grid(B * H, (Nq + kWideQ16 - 1) / kWideQ16);
  flash_bwd_dq_kernel_mma_wide<T, NC2><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), H,
      Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale, granule, vec_out);
  return cudaGetLastError();
}

template <typename T, int NC2>
cudaError_t launch_dkv_mma_wide(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* dsum, void* dk, void* dv, int B,
                                int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                                Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
                                cudaStream_t stream) {
  const size_t smem = dkv_smem_mma_wide<T>(NC2);
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel_mma_wide<T, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int granule = copy_granule(
      view_bits(q, sq.b, sq.h, sq.n) | view_bits(k, sk.b, sk.h, sk.n) |
      view_bits(v, sv.b, sv.h, sv.n) | view_bits(dout, sdo.b, sdo.h, sdo.n));
  const int vec_out = aligned16_half(dk, sdk) && aligned16_half(dv, sdv) && D % 8 == 0;
  const dim3 grid(B * H, (Nkv + kWideKvDkv - 1) / kWideKvDkv);
  flash_bwd_dkv_kernel_mma_wide<T, NC2><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H, Nq,
      Nkv, D, sq, sk, sv, sdo, sdk, sdv, scale, granule, vec_out);
  return cudaGetLastError();
}

// launches `kernel` on a grid of (B*H, tiles, z) blocks, the z blocks of a
// tile forming a cluster
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int z, size_t smem,
                            cudaStream_t stream, Args... args) {
  grid.z = z;
  if (z == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(args...);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// the wide f32 kernels' head-dim slices of kWideDB columns: a cluster's blocks
int f32_wide_slices(int D) { return (D + kWideDB - 1) / kWideDB; }

cudaError_t launch_dq_f32_wide(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* dsum, void* dq, int B,
                               int H, int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv,
                               Strides so, Strides sdo, Strides sdq, float scale,
                               cudaStream_t stream) {
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel_f32_wide<kWideRows>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kWideDqSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int vec = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
                  aligned16(o, so) && aligned16(dout, sdo);
  const int vec_out = aligned16(dq, sdq) && D % 4 == 0;
  return launch_clusters(flash_bwd_dq_kernel_f32_wide<kWideRows>,
                         dim3(B * H, (Nq + kWideRows - 1) / kWideRows), f32_wide_slices(D),
                         kWideDqSmem, stream, static_cast<const float*>(q),
                         static_cast<const float*>(k), static_cast<const float*>(v),
                         static_cast<const float*>(o), static_cast<const float*>(dout), lse, dsum,
                         static_cast<float*>(dq), H, Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale,
                         vec, vec_out);
}

cudaError_t launch_dkv_f32_wide(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* dsum, void* dk, void* dv, int B,
                                int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                                Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
                                cudaStream_t stream) {
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_f32_wide<kWideRows>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kWideDkvSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int vec = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
                  aligned16(dout, sdo);
  const int vec_out = aligned16(dk, sdk) && aligned16(dv, sdv) && D % 4 == 0;
  const int zd = f32_wide_slices(D);
  const int kv_tiles = (Nkv + kWideRows - 1) / kWideRows;
  // the split route: where the grid leaves SMs idle, zq = 2 or 4 blocks of
  // each head-dim slice split the q loop (a cluster of zd x zq <= 8), each
  // part 2 q tiles or more. Device ms a call at 6 rows (bwd_dispatch.py, H100
  // 80GB HBM3, 700 W), split against not: (1024, 1, 384) 0.050 / 0.162,
  // (256, 1, 576) 0.035 / 0.045; but (256, 256, 576), 144 blocks, 0.133 /
  // 0.128, and (an earlier build) one q tile a part, (64, 64, 672) 0.023 /
  // 0.020
  int zq = 1;
  if (B * H * kv_tiles * zd < 132) {
    const int q_tiles = (Nq + kWideRows - 1) / kWideRows;
    while (2 * zq * zd <= kMaxCluster && 4 * zq <= q_tiles) zq *= 2;
  }
  return launch_clusters(flash_bwd_dkv_kernel_f32_wide<kWideRows>, dim3(B * H, kv_tiles), zd * zq,
                         kWideDkvSmem, stream, static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
                         static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nkv, D, sq, sk,
                         sv, sdo, sdk, sdv, scale, zd, vec, vec_out);
}

template <typename T, int NW, int Z>
cudaError_t launch_dq_wgmma_wide(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, float* dsum, void* dq,
                                 int B, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                                 Strides sv, Strides so, Strides sdo, Strides sdq, float scale,
                                 cudaStream_t stream) {
  constexpr int smem = bwd16_smem_bytes<128 * NW, kDqRows, Z>();
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel_wgmma_wide<T, NW, Z>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int granule = copy_granule(
      view_bits(q, sq.b, sq.h, sq.n) | view_bits(k, sk.b, sk.h, sk.n) |
      view_bits(v, sv.b, sv.h, sv.n) | view_bits(o, so.b, so.h, so.n) |
      view_bits(dout, sdo.b, sdo.h, sdo.n));
  const int vec_out = aligned16_half(dq, sdq) && D % 8 == 0;
  return launch_clusters(flash_bwd_dq_kernel_wgmma_wide<T, NW, Z>,
                            dim3(B * H, (Nq + 63) / 64), Z, smem, stream, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v),
                            static_cast<const T*>(o), static_cast<const T*>(dout), lse, dsum,
                            static_cast<T*>(dq), H, Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale,
                            granule, vec_out);
}

template <typename T, int NC, int Z>
cudaError_t launch_dkv_wgmma_wide(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dsum, void* dk, void* dv,
                                  int B, int H, int Nq, int Nkv, int D, Strides sq, Strides sk,
                                  Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
                                  cudaStream_t stream) {
  constexpr int smem = bwd16_smem_bytes<64 * NC, bwd16_dkv_rows(NC), Z>();
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel_wgmma_wide<T, NC, Z>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int granule = copy_granule(
      view_bits(q, sq.b, sq.h, sq.n) | view_bits(k, sk.b, sk.h, sk.n) |
      view_bits(v, sv.b, sv.h, sv.n) | view_bits(dout, sdo.b, sdo.h, sdo.n));
  const int vec_out = aligned16_half(dk, sdk) && aligned16_half(dv, sdv) && D % 8 == 0;
  return launch_clusters(flash_bwd_dkv_kernel_wgmma_wide<T, NC, Z>,
                            dim3(B * H, (Nkv + 63) / 64), Z, smem, stream,
                            static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
                            static_cast<T*>(dk), static_cast<T*>(dv), H, Nq, Nkv, D, sq, sk, sv,
                            sdo, sdk, sdv, scale, granule, vec_out);
}

// the 16-bit launchers by head dim: padded to 64 * NC (D <= 256), or the
// wgmma kernels' tilings
template <typename T>
cudaError_t launch_dq16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* dsum, void* dq, int B, int H,
                        int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                        Strides sdo, Strides sdq, float scale, cudaStream_t stream) {
#define DQ16_ARGS q, k, v, o, dout, lse, dsum, dq, B, H, Nq, Nkv, D, sq, sk, sv, so, sdo, sdq, scale, stream
  if (D > kMaxD) {
    // the wgmma kernel (one block of 384 columns, or Z blocks of 384 or 256 a
    // cluster) where its loop or its grid is long; the 16-row kernel for the
    // short calls (both measured: the note above the wgmma kernels)
    if (Nkv >= 256 || B * H * ((Nq + 63) / 64) >= 256) {
      // (the score chains of launch_dkv16's tiling at each head dim)
      if (D <= 384) return launch_dq_wgmma_wide<T, 3, 1>(DQ16_ARGS);
      if (D <= 512) return launch_dq_wgmma_wide<T, 2, 2>(DQ16_ARGS);
      if (D <= 576) return launch_dq_wgmma_wide<T, 3, 2>(DQ16_ARGS);
      if (D <= 768) return launch_dq_wgmma_wide<T, 2, 3>(DQ16_ARGS);
      return launch_dq_wgmma_wide<T, 2, 4>(DQ16_ARGS);
    }
    switch ((D + 127) / 128) {
      case 3: return launch_dq_mma_wide<T, 3>(DQ16_ARGS);
      case 4: return launch_dq_mma_wide<T, 4>(DQ16_ARGS);
      case 5: return launch_dq_mma_wide<T, 5>(DQ16_ARGS);
      case 6: return launch_dq_mma_wide<T, 6>(DQ16_ARGS);
      case 7: return launch_dq_mma_wide<T, 7>(DQ16_ARGS);
      default: return launch_dq_mma_wide<T, 8>(DQ16_ARGS);
    }
  }
  switch ((D + 63) / 64) {
    case 1: return launch_dq_mma<T, 1>(DQ16_ARGS);
    case 2: return launch_dq_mma<T, 2>(DQ16_ARGS);
    case 3: return launch_dq_mma<T, 3>(DQ16_ARGS);
    default: return launch_dq_mma<T, 4>(DQ16_ARGS);
  }
#undef DQ16_ARGS
}

template <typename T>
cudaError_t launch_dkv16(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* dsum, void* dk, void* dv, int B, int H,
                         int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, float scale, cudaStream_t stream) {
#define DKV16_ARGS q, k, v, dout, lse, dsum, dk, dv, B, H, Nq, Nkv, D, sq, sk, sv, sdo, sdk, sdv, scale, stream
  if (D > kMaxD) {
    // the wgmma kernel (Z blocks of 192 or 256 columns a cluster) where its
    // grid holds 64 kv tiles; the 8-row kernel for the short calls
    if (B * H * ((Nkv + 63) / 64) >= 64) {
      if (D <= 384) return launch_dkv_wgmma_wide<T, 3, 2>(DKV16_ARGS);
      if (D <= 512) return launch_dkv_wgmma_wide<T, 4, 2>(DKV16_ARGS);
      if (D <= 576) return launch_dkv_wgmma_wide<T, 3, 3>(DKV16_ARGS);
      if (D <= 768) return launch_dkv_wgmma_wide<T, 4, 3>(DKV16_ARGS);
      return launch_dkv_wgmma_wide<T, 4, 4>(DKV16_ARGS);
    }
    switch ((D + 127) / 128) {
      case 3: return launch_dkv_mma_wide<T, 3>(DKV16_ARGS);
      case 4: return launch_dkv_mma_wide<T, 4>(DKV16_ARGS);
      case 5: return launch_dkv_mma_wide<T, 5>(DKV16_ARGS);
      case 6: return launch_dkv_mma_wide<T, 6>(DKV16_ARGS);
      case 7: return launch_dkv_mma_wide<T, 7>(DKV16_ARGS);
      default: return launch_dkv_mma_wide<T, 8>(DKV16_ARGS);
    }
  }
  switch ((D + 63) / 64) {
    case 1: return launch_dkv_mma<T, 1>(DKV16_ARGS);
    case 2: return launch_dkv_mma<T, 2>(DKV16_ARGS);
    case 3: return launch_dkv_mma<T, 3>(DKV16_ARGS);
    default: return launch_dkv_mma<T, 4>(DKV16_ARGS);
  }
#undef DKV16_ARGS
}

bool bad_shape(int B, int H, int Nq, int Nkv, int D) {
  return B < 1 || H < 1 || Nq < 1 || Nkv < 1 || D < 1 || D > kMaxDWide;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D <= 1024. Strides are in
// elements.
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
        case 4: return int(launch_dq_f32<4>(DQ_ARGS));
        default: break;
      }
      return int(launch_dq_f32_wide(DQ_ARGS));  // 256 < D <= 1024
    case 1: return int(launch_dq16<__nv_bfloat16>(DQ_ARGS));
    case 2: return int(launch_dq16<__half>(DQ_ARGS));
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
      if (D <= kMaxD) return int(launch_dkv_f32<2>(DKV_ARGS));
      return int(launch_dkv_f32_wide(DKV_ARGS));  // 256 < D <= 1024
    case 1: return int(launch_dkv16<__nv_bfloat16>(DKV_ARGS));
    case 2: return int(launch_dkv16<__half>(DKV_ARGS));
    default:
      return int(cudaErrorInvalidValue);
  }
#undef DKV_ARGS
}
