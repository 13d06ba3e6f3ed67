// GroupNorm(+SiLU) forward for Hopper, sm_90a: one launch a call.
//
// Replaces the TPU kernel `_pallas_gn` / `_fwd_kernel` (with `_stats`) of
// diff_pruning_tpu/ops/group_norm.py, which holds one sample's (N, C) slab
// on chip, reads it once and writes it once.
//
// What bounds it on the H100: a few flops per element, so device-memory
// bytes (read x once, write y once); at the UNet's sizes (0.1-17 M elements
// a call) a launch's fixed cost is of the same order, so the design also
// keeps the host path to one ctypes call and one launch.
//
// Design:
// - one block of 256 threads per (sample, run of whole groups); the slab of
//   those channels x N positions is copied from device memory once into
//   shared memory as f32, channel-major ([channel][position], odd row
//   stride), 100 KB at most;
// - x is read through its strides, with a 16-byte vector read along
//   whichever axis is contiguous: channels (the layer's channels-last
//   activations, (B, N, C) contiguous) or positions (the (B, N, C) view of
//   an NCHW-contiguous tensor); any other layout is read element by
//   element. For channels-last input a block takes enough groups for each
//   position's run of channels to fill whole 32-byte sectors: a run that
//   ends inside a sector shares it with the next block's writes of y, which
//   made the UNet's 12-channel groups markedly slower;
// - statistics in f32 exactly as `group_norm_stats_reference`: per-channel
//   sums (one warp per channel, shuffles, fixed order: no atomics, so the
//   result is bit-reproducible), shifted by each channel's first element for
//   f32 inputs, plain one-pass sums for bf16/f16, then combined per group;
// - y = x * a + b (a = scale * rstd, b = bias - mean * a per channel), SiLU
//   if asked, written once to a contiguous (B, N, C) y with 16-byte stores
//   along channels where they line up;
// - `stats` may be null; otherwise it is a contiguous (2, B, G) f32 array
//   and receives each group's mean (row 0) and rstd (row 1), which the
//   backward kernels read;
// - a slab larger than the shared-memory budget (not at CIFAR sizes; the
//   LDM's 64x64 latents) is taken in chunks of positions: the statistics
//   pass streams x through shared memory, the output pass reads it again
//   (from L2). Still one launch.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemFloats = 100 * 1024 / 4;  // the slab budget of one block

// how a chunk of x is read
enum Layout : int {
  kScalar = 0,        // element by element, channel index fastest
  kVecChannels = 1,   // 16-byte vectors along contiguous channels
  kVecPositions = 2,  // 16-byte vectors along contiguous positions
};

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

struct Params {
  int N, C, G, cpg, gpb, rows;  // rows: positions per chunk
  long long sb, sn, sc;         // x's strides in elements
  int layout;
  int vec_out;                  // 16-byte stores of y
  float eps;
};

// x[b][n0 .. n0 + nr)[c0 .. c0 + K) -> xs[c][n - n0], row stride ld
template <typename T>
__device__ __forceinline__ void load_chunk(float* xs, int ld, const T* xb, const Params& p,
                                           int c0, int K, int n0, int nr) {
  constexpr int VW = 16 / sizeof(T);
  const int tid = threadIdx.x;
  switch (p.layout) {
    case kVecChannels: {
      const int kv = K / VW;
      for (int idx = tid; idx < nr * kv; idx += kThreads) {
        const int n = idx / kv;
        const int c = (idx - n * kv) * VW;
        const uint4 u = *reinterpret_cast<const uint4*>(xb + (n0 + n) * p.sn + c0 + c);
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < VW; ++e) xs[(c + e) * ld + n] = to_f32(v[e]);
      }
      break;
    }
    case kVecPositions: {
      const int nv = nr / VW;
      for (int idx = tid; idx < K * nv; idx += kThreads) {
        const int c = idx / nv;
        const int n = (idx - c * nv) * VW;
        const uint4 u = *reinterpret_cast<const uint4*>(xb + (c0 + c) * p.sc + n0 + n);
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < VW; ++e) xs[c * ld + n + e] = to_f32(v[e]);
      }
      break;
    }
    default:
      for (int idx = tid; idx < K * nr; idx += kThreads) {
        const int n = idx / K;
        const int c = idx - n * K;
        xs[c * ld + n] = to_f32(xb[(n0 + n) * p.sn + (c0 + c) * p.sc]);
      }
  }
}

template <typename T, bool SILU>
__device__ __forceinline__ T apply(float x, float a, float b) {
  float y = fmaf(x, a, b);
  if (SILU) y = y / (1.f + expf(-y));
  return from_f32<T>(y);
}

// y[b][n0 .. n0 + nr)[c0 .. c0 + K) from xs and the per-channel a, b
template <typename T, bool SILU>
__device__ __forceinline__ void store_chunk(T* yb, const float* xs, int ld, const float* ca,
                                            const float* cb, const Params& p, int c0, int K,
                                            int n0, int nr) {
  constexpr int VW = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (p.vec_out) {
    const int kv = K / VW;
    for (int idx = tid; idx < nr * kv; idx += kThreads) {
      const int n = idx / kv;
      const int c = (idx - n * kv) * VW;
      uint4 u;
      T* v = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < VW; ++e)
        v[e] = apply<T, SILU>(xs[(c + e) * ld + n], ca[c + e], cb[c + e]);
      *reinterpret_cast<uint4*>(yb + size_t(n0 + n) * p.C + c0 + c) = u;
    }
  } else {
    for (int idx = tid; idx < nr * K; idx += kThreads) {
      const int n = idx / K;
      const int c = idx - n * K;
      yb[size_t(n0 + n) * p.C + c0 + c] = apply<T, SILU>(xs[c * ld + n], ca[c], cb[c]);
    }
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ stats,
              Params p) {
  constexpr bool kShifted = sizeof(T) == 4;  // f32: the shifted variance
  const int K = p.gpb * p.cpg;
  const int c0 = blockIdx.x * K;
  const int b = blockIdx.y;
  const int ld = p.rows + 1;
  extern __shared__ float smem[];
  float* xs = smem;              // [K][ld]
  float* s1 = xs + K * ld;       // [K] per-channel sums of x - m0
  float* s2 = s1 + K;            // [K] per-channel sums of (x - m0)^2
  float* m0 = s2 + K;            // [K] per-channel anchors (0 for 16-bit inputs)
  float* ca = m0 + K;            // [K] y = x * ca + cb
  float* cb = ca + K;
  float* gstat = cb + K;         // [2][gpb] mean, rstd

  const T* xb = x + b * p.sb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = tid; c < K; c += kThreads) {
    s1[c] = 0.f;
    s2[c] = 0.f;
    m0[c] = kShifted ? to_f32(xb[(c0 + c) * p.sc]) : 0.f;
  }

  // statistics pass: per-channel sums, chunk by chunk
  for (int n0 = 0; n0 < p.N; n0 += p.rows) {
    const int nr = min(p.rows, p.N - n0);
    __syncthreads();  // the previous chunk is consumed; m0 is set
    load_chunk<T>(xs, ld, xb, p, c0, K, n0, nr);
    __syncthreads();
    for (int c = warp; c < K; c += kWarps) {
      const float* row = xs + c * ld;
      const float anchor = m0[c];
      float a1 = 0.f, a2 = 0.f;
      for (int n = lane; n < nr; n += 32) {
        const float d = row[n] - anchor;
        a1 += d;
        a2 = fmaf(d, d, a2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) {
        s1[c] += a1;
        s2[c] += a2;
      }
    }
  }
  __syncthreads();

  // per group: mean and rstd, as group_norm_stats_reference forms them
  if (tid < p.gpb) {
    const float n_spatial = float(p.N);
    const float n_per_group = n_spatial * float(p.cpg);
    const int lo = tid * p.cpg;
    float mean, var;
    if (kShifted) {
      float s1g = 0.f, m0g = 0.f;
      for (int c = lo; c < lo + p.cpg; ++c) {
        s1g += s1[c];
        m0g += m0[c];
      }
      mean = (s1g + n_spatial * m0g) / n_per_group;
      float acc = 0.f;
      for (int c = lo; c < lo + p.cpg; ++c) {
        const float delta = m0[c] - mean;
        acc += s2[c] + 2.f * delta * s1[c] + n_spatial * delta * delta;
      }
      var = acc / n_per_group;
    } else {
      float s1g = 0.f, s2g = 0.f;
      for (int c = lo; c < lo + p.cpg; ++c) {
        s1g += s1[c];
        s2g += s2[c];
      }
      mean = s1g / n_per_group;
      var = s2g / n_per_group - mean * mean;
    }
    const float rstd = 1.f / sqrtf(fmaxf(var, 0.f) + p.eps);
    gstat[tid] = mean;
    gstat[p.gpb + tid] = rstd;
    if (stats != nullptr) {
      const int g = blockIdx.x * p.gpb + tid;
      const int B = gridDim.y;
      stats[size_t(b) * p.G + g] = mean;
      stats[size_t(B + b) * p.G + g] = rstd;
    }
  }
  __syncthreads();
  for (int c = tid; c < K; c += kThreads) {
    const int g = c / p.cpg;
    const float a = scale[c0 + c] * gstat[p.gpb + g];
    ca[c] = a;
    cb[c] = bias[c0 + c] - gstat[g] * a;
  }
  __syncthreads();

  // output pass: from the slab on chip, or chunk by chunk again
  T* yb = y + size_t(b) * p.N * p.C;
  if (p.rows >= p.N) {
    store_chunk<T, SILU>(yb, xs, ld, ca, cb, p, c0, K, 0, p.N);
    return;
  }
  for (int n0 = 0; n0 < p.N; n0 += p.rows) {
    const int nr = min(p.rows, p.N - n0);
    load_chunk<T>(xs, ld, xb, p, c0, K, n0, nr);
    __syncthreads();
    store_chunk<T, SILU>(yb, xs, ld, ca, cb, p, c0, K, n0, nr);
    __syncthreads();
  }
}

template <typename T, bool SILU>
cudaError_t launch_kernel(const T* x, const float* scale, const float* bias, T* y,
                          float* stats, int B, const Params& p, size_t smem,
                          cudaStream_t stream) {
  static size_t allowed = 48 * 1024;  // dynamic shared memory without opting in
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_fwd_kernel<T, SILU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(sizeof(float) * kSmemFloats + 1024));
    if (err != cudaSuccess) return err;
    allowed = sizeof(float) * kSmemFloats + 1024;
  }
  const dim3 grid(p.G / p.gpb, B);
  gn_fwd_kernel<T, SILU><<<grid, kThreads, smem, stream>>>(x, scale, bias, y, stats, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const float* scale, const float* bias, void* yv,
                   float* stats, int B, int N, int C, int G, long long sb, long long sn,
                   long long sc, float eps, bool silu, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int es = sizeof(T);
  constexpr int VW = 16 / es;
  Params p;
  p.N = N;
  p.C = C;
  p.G = G;
  p.cpg = C / G;
  p.sb = sb;
  p.sn = sn;
  p.sc = sc;
  p.eps = eps;
  // floats a block needs besides the slab
  auto extra = [&](int gpb) { return 5 * gpb * p.cpg + 2 * gpb; };
  auto fits = [&](int gpb) {
    return (long long)gpb * p.cpg * (N + 1) + extra(gpb) <= kSmemFloats;
  };
  // a block owns whole groups: grow the run while the slab is small, or
  // while a channels-last position's run of channels is not a whole number
  // of 32-byte sectors (up to 128 bytes)
  auto partial_sectors = [&](int gpb) {
    const int run = gpb * p.cpg * es;
    return sc == 1 && (run < 32 || (run % 32 != 0 && run < 128));
  };
  p.gpb = 1;
  while (G % (2 * p.gpb) == 0 && fits(2 * p.gpb) &&
         (partial_sectors(p.gpb) || (long long)p.gpb * p.cpg * N < 2048))
    p.gpb *= 2;
  const int K = p.gpb * p.cpg;
  if (fits(p.gpb)) {
    p.rows = N;
  } else {
    p.rows = ((kSmemFloats - extra(p.gpb)) / K - 1) / 32 * 32;
    if (p.rows < 32) return cudaErrorInvalidValue;
  }
  const bool base_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (sb * es) % 16 == 0;
  if (sc == 1 && base_aligned && K % VW == 0 && (sn * es) % 16 == 0)
    p.layout = kVecChannels;
  else if (sn == 1 && base_aligned && N % VW == 0 && (sc * es) % 16 == 0)
    p.layout = kVecPositions;
  else
    p.layout = kScalar;
  p.vec_out = reinterpret_cast<uintptr_t>(y) % 16 == 0 && K % VW == 0 && C % VW == 0;
  const size_t smem = sizeof(float) * (size_t(K) * (p.rows + 1) + extra(p.gpb));
  return silu ? launch_kernel<T, true>(x, scale, bias, y, stats, B, p, smem, stream)
              : launch_kernel<T, false>(x, scale, bias, y, stats, B, p, smem, stream);
}

}  // namespace

// x: (B, N, C) through element strides; scale, bias: (C,) f32; y: (B, N, C)
// contiguous; stats: null or (2, B, G) f32 contiguous (mean, rstd).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int group_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                              void* stats, int dtype, int B, int N, int C, int G,
                              long long sb, long long sn, long long sc, float eps, int silu,
                              void* stream) {
  if (B < 1 || N < 1 || G < 1 || C < G || C % G != 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  float* st = static_cast<float*>(stats);
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch<float>(x, s, bb, y, st, B, N, C, G, sb, sn, sc, eps, silu, str));
    case 1:
      return int(launch<__nv_bfloat16>(x, s, bb, y, st, B, N, C, G, sb, sn, sc, eps, silu, str));
    case 2:
      return int(launch<__half>(x, s, bb, y, st, B, N, C, G, sb, sn, sc, eps, silu, str));
    default:
      return int(cudaErrorInvalidValue);
  }
}
