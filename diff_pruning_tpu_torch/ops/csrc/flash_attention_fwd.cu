// Flash-attention forward (non-causal) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_flash_fwd_call` / `_fwd_kernel` of
// diff_pruning_tpu/ops/attention.py: online-softmax attention with a running
// max, denominator and f32 accumulator, never forming the Nq x Nkv matrix,
// and optionally the per-row logsumexp for the backward.
//
// What bounds it on the H100: at the UNet's shapes (N = 256 tokens, one head
// of D = 256) the op does 4*N*D flops per query row against 4*D bytes read
// for it in bf16, far above the memory/compute balance, so it is bound by
// arithmetic. This first version runs that arithmetic in f32 on the CUDA
// cores, fed from shared memory (no wgmma/TMA yet): it is simple and exact
// to f32, and making it fast is later work.
//
// Design:
// - one block of 256 threads per (batch*head, 64-row query tile); each query
//   row belongs to 4 neighbouring lanes of one warp, so the row's softmax
//   statistics stay in registers and combine with two shuffles;
// - Q (64 x D), K and V (32 x D) tiles live in shared memory as f32 with an
//   odd row stride (no bank conflicts); the kv loop streams K/V tiles;
// - each thread keeps 64 f32 accumulators: columns lane4 + 4*i of its row,
//   so any D up to 256 is masked to the loaded width, with no padding;
// - query rows at or beyond Nq are computed on zeros and not written; kv
//   columns at or beyond Nkv are set to -inf before the softmax;
// - `lse` may be null (inference: the launch writes only o). Otherwise it is
//   a contiguous (B*H, Nq) f32 array and each row's logsumexp of its scaled
//   scores, m + log(l) (the TPU kernel's `_finish`), is written there for the
//   backward kernels (flash_attention_bwd.cu).
// Shared memory for D = 256: (64 + 2*32) * 257 * 4 + 64 * 33 * 4 = 140,032
// bytes, above the 48 KB default, so the launcher raises the kernel's limit.
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
constexpr int kBlockK = 32;
constexpr int kThreads = 4 * kBlockQ;
constexpr int kMaxD = 256;
constexpr int kColsPerThread = kMaxD / 4;
constexpr int kScoresPerThread = kBlockK / 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct Strides {
  long long b, h, n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Nq, int Nkv, int D, int ld,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // kBlockQ x ld
  float* ks = qs + kBlockQ * ld;     // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x ld
  float* ps = vs + kBlockK * ld;     // kBlockQ x (kBlockK + 1)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;   // this thread's query row in the tile
  const int quarter = tid & 3;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int qr = q0 + r;
    qs[r * ld + c] = qr < Nq ? to_f32(qb[qr * sq.n + c]) : 0.f;
  }

  float acc[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int kv0 = 0; kv0 < Nkv; kv0 += kBlockK) {
    __syncthreads();  // the Q tile is loaded; the previous K/V tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int kr = kv0 + r;
      const bool ok = kr < Nkv;
      ks[r * ld + c] = ok ? to_f32(kb[kr * sk.n + c]) : 0.f;
      vs[r * ld + c] = ok ? to_f32(vb[kr * sv.n + c]) : 0.f;
    }
    __syncthreads();

    // scores of this row against kv columns quarter + 4*j
    float s[kScoresPerThread];
#pragma unroll
    for (int j = 0; j < kScoresPerThread; ++j) s[j] = 0.f;
    const float* qrow = qs + row * ld;
    for (int c = 0; c < D; ++c) {
      const float qv = qrow[c];
#pragma unroll
      for (int j = 0; j < kScoresPerThread; ++j)
        s[j] = fmaf(qv, ks[(quarter + 4 * j) * ld + c], s[j]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kScoresPerThread; ++j) {
      const int col = kv0 + quarter + 4 * j;
      s[j] = col < Nkv ? s[j] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // the first tile always holds a valid column, so m_new is finite
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
    float* prow = ps + row * (kBlockK + 1);
#pragma unroll
    for (int j = 0; j < kScoresPerThread; ++j) {
      const float p = expf(s[j] - m_new);
      prow[quarter + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // a row's probabilities are written and read by its own 4 lanes

#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = prow[j];
      const float* vrow = vs + j * ld;
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        const int c = quarter + 4 * i;
        if (c < D) acc[i] = fmaf(p, vrow[c], acc[i]);
      }
    }
  }

  const int qr = q0 + row;
  if (qr < Nq) {
    T* orow = o + b * so.b + h * so.h + qr * so.n;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int c = quarter + 4 * i;
      if (c < D) orow[c] = from_f32<T>(acc[i] / l_run);
    }
    if (lse != nullptr && quarter == 0) lse[size_t(bh) * Nq + qr] = m_run + logf(l_run);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H,
                   int Nq, int Nkv, int D, Strides sq, Strides sk, Strides sv, Strides so,
                   float scale, cudaStream_t stream) {
  const int ld = D | 1;  // odd row stride: rows fall on distinct banks
  const size_t smem =
      (size_t(kBlockQ + 2 * kBlockK) * ld + size_t(kBlockQ) * (kBlockK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Nq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Nq, Nkv, D, ld, sq, sk, sv, so, scale);
  return cudaGetLastError();
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
