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
// Two routes, chosen from the shape alone (`launch`):
//
// The single-block route, for a slab that fits one block (CIFAR's, and
// every slab up to 100 KB as f32):
// - one block of 256 threads per (sample, run of whole groups); the slab of
//   those channels x N positions is copied from device memory once into
//   shared memory as f32, channel-major ([channel][position], odd row
//   stride);
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
//   along channels where they line up.
//
// The cluster route, for every larger slab (the LDMs' 64 x 64 latents at
// C >= 384, LSUN-256's and the codecs' 128-256 px levels: 1-9 MB a group).
// One block alone cannot hold such a slab, and one block walking it in
// chunks serialises copies and sums and reads x twice. Here a
// thread-block cluster of 2-16 blocks on neighbouring SMs takes one
// (sample, run of whole groups) (group_norm_common.cuh, plan_cluster):
// - the N positions are split over the cluster's blocks in equal shares (a
//   multiple of 32); each block (512 threads, up to 225 KB of shared memory,
//   so one an SM) copies its share of x once into its shared memory, in its
//   own type, position-major: with cp.async, 16 bytes a thread, in eight
//   stages issued at once, so that the copies are in flight while the block
//   sums the stages that have landed; each thread sums exactly the chunks it
//   copied (a chunk: 4 f32 or 8 16-bit channels of one position), so no
//   block barrier stands between a stage's arrival and its sums. Other
//   strides (the NCHW view) are read element by element through registers;
// - per-channel partial sums (shifted by the channel's first element for
//   f32, plain for 16-bit, as above) are added within a warp by shuffles,
//   then over the warps; after the cluster barrier each block reads every
//   block's partials through distributed shared memory and adds them in
//   rank order, so all blocks hold the same totals, bit-reproducibly and
//   without atomics; rank 0 writes `stats`;
// - each block writes y for its share from shared memory: x is read from
//   device memory once;
// - the run of channels grows for whole sectors only while the run's slab
//   stays on chip in the largest cluster; the cluster is the smallest that
//   holds the slab. A slab beyond the largest cluster's shared memory (16
//   blocks, 3.5 MB; the 9.4 MB groups of kl-f16's 768 x 768 decode) keeps
//   each block's first positions on chip and streams the rest of its share
//   through registers (16-byte loads), reading only those twice.
//
// `stats` may be null; otherwise it is a contiguous (2, B, G) f32 array
// and receives each group's mean (row 0) and rstd (row 1), which the
// backward kernels read.
//
// The C entry point returns cudaGetLastError() after the launch (a refused
// cluster launch returns its error); `group_norm_fwd_route` reports the
// route a shape takes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_norm_common.cuh"

namespace {

using gn::from_f32;
using gn::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemFloats = 100 * 1024 / 4;  // the slab budget of one block

// how a slab of x is read
enum Layout : int {
  kScalar = 0,        // element by element, channel index fastest
  kVecChannels = 1,   // 16-byte vectors along contiguous channels
  kVecPositions = 2,  // 16-byte vectors along contiguous positions
};

struct Params {
  int N, C, G, cpg, gpb, rows;  // rows: positions a pass (N: the slab fits)
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

// y = x * a + b, SiLU'd if asked, in f32 (the cluster route)
template <bool SILU>
__device__ __forceinline__ float affine(float x, float a, float b) {
  float y = fmaf(x, a, b);
  if (SILU) y = y / (1.f + expf(-y));
  return y;
}

// A group's mean and rstd from its channels' sums (lo .. lo + cpg), as
// group_norm_stats_reference forms them: for f32 (shifted) s1, s2 are the
// sums of x - m0 and (x - m0)^2 with m0 the channel's first element; for
// 16-bit inputs the plain sums of x and x^2.
template <bool kShifted>
__device__ __forceinline__ void group_stats(const float* s1, const float* s2, const float* m0,
                                            int lo, int cpg, int N, float eps, float* mean_out,
                                            float* rstd_out) {
  const float n_spatial = float(N);
  const float n_per_group = n_spatial * float(cpg);
  float mean, var;
  if (kShifted) {
    float s1g = 0.f, m0g = 0.f;
    for (int c = lo; c < lo + cpg; ++c) {
      s1g += s1[c];
      m0g += m0[c];
    }
    mean = (s1g + n_spatial * m0g) / n_per_group;
    float acc = 0.f;
    for (int c = lo; c < lo + cpg; ++c) {
      const float delta = m0[c] - mean;
      acc += s2[c] + 2.f * delta * s1[c] + n_spatial * delta * delta;
    }
    var = acc / n_per_group;
  } else {
    float s1g = 0.f, s2g = 0.f;
    for (int c = lo; c < lo + cpg; ++c) {
      s1g += s1[c];
      s2g += s2[c];
    }
    mean = s1g / n_per_group;
    var = s2g / n_per_group - mean * mean;
  }
  *mean_out = mean;
  *rstd_out = 1.f / sqrtf(fmaxf(var, 0.f) + eps);
}

// ---- the single-block route ----

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

  // statistics pass: per-channel sums (one pass of rows == N positions)
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

  // output pass, from the slab on chip. The pass over chunks below is not
  // taken (a slab beyond the block takes the cluster route); it stays
  // because this kernel compiled without it ran markedly slower in f32 at
  // CIFAR's 1024-position slabs, timed beside it on the H100
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

// ---- the cluster route ----

// A cluster block's shared memory at most: half an SM's, so that two blocks
// (their 512 threads take at most 64 registers) share an SM, one loading
// while the other stores; at least as fast as blocks of the whole 225 KB,
// which stream less, at every shape timed
constexpr int kSmemMaxCluster = 112 * 1024;

// floats a cluster block needs besides its slab: its partial sums [2][K],
// the reduction's [kCWarps][2][K], anchors, a and b [K] each, mean and rstd
// [2][gpb]
inline int cluster_extra_bytes(int K, int gpb) {
  return 4 * (2 * K + gn::kCWarps * 2 * K + 3 * K + 2 * gpb);
}

template <typename T, bool SILU, int VC>
__global__ void __launch_bounds__(gn::kCThreads, 1)
gn_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ stats, gn::Strides xst, gn::CParams p) {
  using gn::kCThreads;
  using gn::kCStages;
  constexpr bool kShifted = sizeof(T) == 4;  // f32: the shifted variance
  const int K = p.K;
  const int rank = blockIdx.x;  // a cluster spans gridDim.x
  const int c0 = blockIdx.y * K;
  const int b = blockIdx.z;
  extern __shared__ __align__(16) unsigned char csmem[];
  T* xs = reinterpret_cast<T*>(csmem);                           // [resident][K]
  float* part = reinterpret_cast<float*>(csmem + p.slab_bytes);  // [2][K] this block's sums
  float* red = part + 2 * K;   // [kCWarps][2][K]; then the cluster's sums [2][K]
  float* m0s = red + gn::kCWarps * 2 * K;  // [K] anchors
  float* ca = m0s + K;         // [K] y = x * ca + cb
  float* cb = ca + K;
  float* gstat = cb + K;       // [2][gpb] mean, rstd

  const int tid = threadIdx.x;
  const int cv = tid & (p.kvp - 1);
  const int r0 = tid / p.kvp;
  const int rp = kCThreads / p.kvp;
  const bool active = cv < p.kv;
  const int cc = cv * VC;  // the chunk's first channel in the run
  const int n_lo = rank * p.share;
  const int n_cnt = max(0, min(p.share, p.N - n_lo));
  const int n_res = min(n_cnt, p.resident);
  const T* x0 = x + b * xst.sb;               // position 0 of the sample
  const T* xb = x0 + n_lo * xst.sn + (c0 + cc) * xst.sc;  // this thread's chunk at n_lo
  const bool vec = VC * sizeof(T) == 16 && p.vec_in;  // cp.async and 16-byte loads

  float m0[VC], a1[VC], a2[VC];
#pragma unroll
  for (int e = 0; e < VC; ++e) {
    a1[e] = a2[e] = 0.f;
    m0[e] = kShifted && active ? to_f32(x0[(c0 + cc + e) * xst.sc]) : 0.f;
  }
  auto add = [&](const T (&t)[VC]) {
#pragma unroll
    for (int e = 0; e < VC; ++e) {
      const float d = to_f32(t[e]) - m0[e];
      a1[e] += d;
      a2[e] = fmaf(d, d, a2[e]);
    }
  };

  // the resident positions: cp.async in stages, all issued before any sum
  const int srows = n_res > 0 ? gn::round_up(gn::ceil_div(n_res, kCStages), rp) : 0;
  if (vec) {
    for (int s = 0; s < kCStages; ++s) {
      if (active)
        for (int r = s * srows + r0; r < min(n_res, (s + 1) * srows); r += rp)
          gn::cp_async16(xs + r * K + cc, xb + r * xst.sn);
      gn::cp_async_commit();
    }
  } else if (active) {  // element by element through the strides
#pragma unroll 4
    for (int r = r0; r < n_res; r += rp) {
      T t[VC];
      gn::load_chunk<T, VC>(t, xb + r * xst.sn, xst.sc, false);
      add(t);
      gn::smem_write<T, VC>(xs + r * K + cc, t);
    }
  }
  // the streamed positions (beyond the shared memory) while those copies fly
  if (active) {
#pragma unroll 4
    for (int r = n_res + r0; r < n_cnt; r += rp) {
      T t[VC];
      gn::load_chunk<T, VC>(t, xb + r * xst.sn, xst.sc, vec);
      add(t);
    }
  }
  // the stages as they land: each thread sums the chunks it copied
  if (vec) {
    for (int s = 0; s < kCStages; ++s) {
      gn::cp_async_wait_pending(kCStages - 1 - s);
      if (active)
        for (int r = s * srows + r0; r < min(n_res, (s + 1) * srows); r += rp) {
          T t[VC];
          gn::smem_read<T, VC>(t, xs + r * K + cc);
          add(t);
        }
    }
  }

  gn::block_sums<VC>(a1, a2, p, red, part);
  for (int j = tid; j < K; j += kCThreads)
    m0s[j] = kShifted ? to_f32(x0[(c0 + j) * xst.sc]) : 0.f;
  gn::cluster_arrive();  // this block's part is written
  gn::cluster_wait();    // ... and every other block's
  gn::cluster_sums(p, part, red);

  // per group: mean and rstd, the same in every block of the cluster
  if (tid < p.gpb) {
    float mean, rstd;
    group_stats<kShifted>(red, red + K, m0s, tid * p.cpg, p.cpg, p.N, p.eps, &mean, &rstd);
    gstat[tid] = mean;
    gstat[p.gpb + tid] = rstd;
    if (stats != nullptr && rank == 0) {
      const int g = blockIdx.y * p.gpb + tid;
      const int B = gridDim.z;
      stats[size_t(b) * p.G + g] = mean;
      stats[size_t(B + b) * p.G + g] = rstd;
    }
  }
  __syncthreads();
  for (int j = tid; j < K; j += kCThreads) {
    const int g = j / p.cpg;
    const float a = scale[c0 + j] * gstat[p.gpb + g];
    ca[j] = a;
    cb[j] = bias[c0 + j] - gstat[g] * a;
  }
  __syncthreads();

  // y: the resident positions from shared memory, the streamed ones read again
  if (active) {
    float ka[VC], kb[VC];
#pragma unroll
    for (int e = 0; e < VC; ++e) {
      ka[e] = ca[cc + e];
      kb[e] = cb[cc + e];
    }
    T* yb = y + (size_t(b) * p.N + n_lo) * p.C + c0 + cc;
#pragma unroll 4
    for (int r = r0; r < n_res; r += rp) {
      T t[VC];
      gn::smem_read<T, VC>(t, xs + r * K + cc);
      float v[VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) v[e] = affine<SILU>(to_f32(t[e]), ka[e], kb[e]);
      gn::store_chunk<T, VC>(yb + size_t(r) * p.C, v, p.vec_out);
    }
#pragma unroll 4
    for (int r = n_res + r0; r < n_cnt; r += rp) {
      T t[VC];
      gn::load_chunk<T, VC>(t, xb + r * xst.sn, xst.sc, vec);
      float v[VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) v[e] = affine<SILU>(to_f32(t[e]), ka[e], kb[e]);
      gn::store_chunk<T, VC>(yb + size_t(r) * p.C, v, p.vec_out);
    }
  }
  gn::cluster_wait();  // no block leaves while another may still read its sums
}

template <typename T, int VC>
const void* cluster_kernel(bool silu) {
  return silu ? reinterpret_cast<const void*>(gn_fwd_cluster_kernel<T, true, VC>)
              : reinterpret_cast<const void*>(gn_fwd_cluster_kernel<T, false, VC>);
}

// The cluster route's plan for this shape (false: none).
template <typename T>
bool cluster_plan(int N, int C, int G, gn::CParams* p) {
  constexpr int VW = 16 / sizeof(T);
  p->N = N;
  p->C = C;
  p->G = G;
  p->cpg = C / G;
  auto kernel = [](int vc) {  // the occupancy of the plain kernels decides
    return vc == VW ? cluster_kernel<T, VW>(false) : cluster_kernel<T, 1>(false);
  };
  return gn::plan_cluster(N, G, p->cpg, int(sizeof(T)), 1, kSmemMaxCluster, 32, 32, kernel,
                          cluster_extra_bytes, p);
}

template <typename T, int VC>
cudaError_t launch_cluster_vc(const T* x, const float* scale, const float* bias, T* y,
                              float* stats, int B, const gn::Strides& xst, const gn::CParams& p,
                              bool silu, cudaStream_t stream) {
  // (the first query also sets the kernel's attributes)
  if (gn::resident_blocks(cluster_kernel<T, VC>(silu), p.cs, p.smem) < 1)
    return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      gn::cluster_config(dim3(p.cs, p.G / p.gpb, B), p.cs, p.smem, stream, attr);
  if (silu)
    return cudaLaunchKernelEx(&cfg, gn_fwd_cluster_kernel<T, true, VC>, x, scale, bias, y,
                              stats, xst, p);
  return cudaLaunchKernelEx(&cfg, gn_fwd_cluster_kernel<T, false, VC>, x, scale, bias, y,
                            stats, xst, p);
}

template <typename T>
cudaError_t launch_cluster(const T* x, const float* scale, const float* bias, T* y,
                           float* stats, int B, int N, int C, int G, const gn::Strides& xst,
                           float eps, bool silu, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int VW = 16 / es;
  gn::CParams p;
  if (!cluster_plan<T>(N, C, G, &p)) return cudaErrorInvalidValue;
  p.eps = eps;
  p.vec_in = p.vc == VW && xst.sc == 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             (xst.sb * es) % 16 == 0 && (xst.sn * es) % 16 == 0;
  p.vec_out = p.vc == VW && reinterpret_cast<uintptr_t>(y) % 16 == 0 && C % VW == 0;
  cudaError_t err =
      p.vc == VW ? launch_cluster_vc<T, VW>(x, scale, bias, y, stats, B, xst, p, silu, stream)
                 : launch_cluster_vc<T, 1>(x, scale, bias, y, stats, B, xst, p, silu, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// the single-block route's run of groups, and whether its slab fits
template <typename T>
bool single_block_plan(int N, int C, int G, long long sc, Params* p) {
  constexpr int es = sizeof(T);
  p->N = N;
  p->C = C;
  p->G = G;
  p->cpg = C / G;
  // floats a block needs besides the slab
  auto extra = [&](int gpb) { return 5 * gpb * p->cpg + 2 * gpb; };
  auto fits = [&](int gpb) {
    return (long long)gpb * p->cpg * (N + 1) + extra(gpb) <= kSmemFloats;
  };
  // a block owns whole groups: grow the run while the slab is small, or
  // while a channels-last position's run of channels is not a whole number
  // of 32-byte sectors (up to 128 bytes)
  auto partial_sectors = [&](int gpb) {
    const int run = gpb * p->cpg * es;
    return sc == 1 && (run < 32 || (run % 32 != 0 && run < 128));
  };
  p->gpb = 1;
  while (G % (2 * p->gpb) == 0 && fits(2 * p->gpb) &&
         (partial_sectors(p->gpb) || (long long)p->gpb * p->cpg * N < 2048))
    p->gpb *= 2;
  return fits(p->gpb);
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
  if (!single_block_plan<T>(N, C, G, sc, &p))
    return launch_cluster<T>(x, scale, bias, y, stats, B, N, C, G, gn::Strides{sb, sn, sc}, eps,
                             silu, stream);
  p.sb = sb;
  p.sn = sn;
  p.sc = sc;
  p.eps = eps;
  p.rows = N;  // the slab fits
  const int K = p.gpb * p.cpg;
  const bool base_aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (sb * es) % 16 == 0;
  if (sc == 1 && base_aligned && K % VW == 0 && (sn * es) % 16 == 0)
    p.layout = kVecChannels;
  else if (sn == 1 && base_aligned && N % VW == 0 && (sc * es) % 16 == 0)
    p.layout = kVecPositions;
  else
    p.layout = kScalar;
  p.vec_out = reinterpret_cast<uintptr_t>(y) % 16 == 0 && K % VW == 0 && C % VW == 0;
  const size_t smem = sizeof(float) * (size_t(K) * (N + 1) + 5 * K + 2 * p.gpb);
  return silu ? launch_kernel<T, true>(x, scale, bias, y, stats, B, p, smem, stream)
              : launch_kernel<T, false>(x, scale, bias, y, stats, B, p, smem, stream);
}

template <typename T>
int route(int N, int C, int G, long long sc, int* out) {
  Params sp;
  if (single_block_plan<T>(N, C, G, sc, &sp)) {
    out[0] = 0;
    out[1] = sp.gpb;
    out[2] = 1;
    out[3] = N;
    out[4] = N;
    out[5] = int(sizeof(float) * (size_t(sp.gpb) * sp.cpg * (N + 1) + 5 * sp.gpb * sp.cpg +
                                  2 * sp.gpb));
    return 0;
  }
  gn::CParams p;
  if (!cluster_plan<T>(N, C, G, &p)) return int(cudaErrorInvalidValue);
  out[0] = 1;
  out[1] = p.gpb;
  out[2] = p.cs;
  out[3] = p.share;
  out[4] = p.resident;
  out[5] = p.smem;
  return 0;
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

// The route group_norm_fwd takes for a shape (x's channel stride sc: 1 for
// channels-last): out[0] 0 = one block per run, 1 = a cluster per run;
// out[1] groups a run, out[2] blocks a cluster (1 on the single-block
// route), out[3] positions a block, out[4] of which held in shared memory,
// out[5] a block's dynamic shared memory in bytes. Returns 0, or a CUDA
// error where no route takes the shape.
extern "C" int group_norm_fwd_route(int dtype, int N, int C, int G, long long sc, int* out) {
  if (N < 1 || G < 1 || C < G || C % G != 0) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return route<float>(N, C, G, sc, out);
    case 1: return route<__nv_bfloat16>(N, C, G, sc, out);
    case 2: return route<__half>(N, C, G, sc, out);
    default: return int(cudaErrorInvalidValue);
  }
}
