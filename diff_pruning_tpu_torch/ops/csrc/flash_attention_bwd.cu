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
// bound by arithmetic. This first version runs it in f32 on the CUDA cores,
// fed from shared memory (no wgmma/TMA yet): simple and exact to f32, with
// tensor cores left to later work.
//
// Design (the JAX split; no atomics anywhere, so every gradient is
// bit-reproducible from run to run):
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
// = 140,288 bytes (dk/dv), 135,808 (dq): above the 48 KB default, so the
// launcher raises each kernel's limit.
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
  switch (dtype) {
    case 0:
      return int(launch_dq<float>(q, k, v, o, dout, l, ds, dq, B, H, Nq, Nkv, D, sq, sk, sv,
                                  so, sdo, sdq, scale, s));
    case 1:
      return int(launch_dq<__nv_bfloat16>(q, k, v, o, dout, l, ds, dq, B, H, Nq, Nkv, D, sq,
                                          sk, sv, so, sdo, sdq, scale, s));
    case 2:
      return int(launch_dq<__half>(q, k, v, o, dout, l, ds, dq, B, H, Nq, Nkv, D, sq, sk, sv,
                                   so, sdo, sdq, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
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
  switch (dtype) {
    case 0:
      return int(launch_dkv<float>(q, k, v, dout, l, ds, dk, dv, B, H, Nq, Nkv, D, sq, sk, sv,
                                   sdo, sdk, sdv, scale, s));
    case 1:
      return int(launch_dkv<__nv_bfloat16>(q, k, v, dout, l, ds, dk, dv, B, H, Nq, Nkv, D, sq,
                                           sk, sv, sdo, sdk, sdv, scale, s));
    case 2:
      return int(launch_dkv<__half>(q, k, v, dout, l, ds, dk, dv, B, H, Nq, Nkv, D, sq, sk, sv,
                                    sdo, sdk, sdv, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
