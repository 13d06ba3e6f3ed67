// GroupNorm(+SiLU) backward for Hopper, sm_90a: one launch a call.
//
// Replaces the TPU kernel `_pallas_gn_bwd` / `_bwd_kernel` of
// diff_pruning_tpu/ops/group_norm.py, which holds one sample's (N, C) slab
// of x and dy on chip and writes dx and the sample's dscale/dbias partials;
// the batch sum of the partials is an XLA op there.
//
// What bounds it on the H100: about 12 flops per element (28 with SiLU), so
// device-memory bytes: read x and dy once, write dx once. At the UNet's
// sizes (0.1-17 M elements a call) a launch's fixed cost is of the same
// order, so the design also keeps the whole call to one launch: no second
// pass over x and dy, no separate kernel or torch op for the batch sum.
//
// Two routes, chosen from the shape alone (`launch`), with the same math:
// the forward's saved (B, G) mean and rstd are read, not recomputed;
// xhat = (x - mean) * rstd and dy' (dy through the SiLU derivative on the
// recomputed z = xhat * gamma + beta, as `group_norm_backward_reference`
// forms it, the sigmoid with the approximate reciprocal) are formed in
// registers, once for the sums of dy' and dy' * xhat per channel and again
// for dx; per group gm1 = mean(dy' * gamma), gm2 = mean(dy' * gamma * xhat),
// then dx = rstd * (dy' * gamma - gm1 - xhat * gm2), written once to a
// contiguous (B, N, C) dx. No float is summed atomically: every sum has a
// fixed order, so the results are bit-reproducible.
//
// dscale and dbias in the same launch: per (sample, channel run) one block
// writes the run's per-sample partials to an f32 (2, B, C) workspace; after
// a barrier, its thread 0 fences and takes a ticket with atomicInc (which
// wraps the ticket back to 0 for the next call) while the block writes dx.
// The block that takes the last ticket of its channel run sums the B
// partials of its channels in a fixed order (float4 reads, several in
// flight, spread over the block's threads) and writes the (C,) outputs. The
// atomic only orders the blocks.
//
// The single-block route, for x and dy slabs that fit one block's 104 KB
// (CIFAR's and the LDMs' smaller levels):
// - one block of 256 threads per (sample, run of whole groups), grid
//   (G / gpb, B), the runs chosen as the forward chooses them
//   (group_norm_fwd.cu): whole 32-byte sectors per position's run of
//   channels of dx (always channels-last), and a slab of at least 32 KB of
//   x where it fits (a smaller slab leaves the block's fixed latency
//   unspread);
// - the x and dy slabs of those K channels x N positions are copied from
//   device memory once into shared memory, position-major and in their own
//   type, as they lie in a channels-last tensor: with cp.async, 16 bytes a
//   thread, in four stages of positions, so that the per-channel sums of a
//   stage run while the later stages are still in flight (the main path:
//   `PERF.md` found every GroupNorm input and gradient channels-last).
//   Other strides are copied through registers: 16-byte vectors along
//   positions (the (B, N, C) view of an NCHW tensor), otherwise element by
//   element. A 16-bit slab takes half the shared memory of an f32 one, so
//   more blocks fit on an SM;
// - each thread owns one channel and every (256 / K)-th position for the
//   sums, added by shuffles within a warp where K divides 32; dx is written
//   4 channels a thread in and out (16 bytes f32, 8 bytes 16-bit), their
//   coefficients in registers.
//
// The cluster route, for every larger pair of slabs (1-4 MB a group at the
// LSUN-256 UNet's and the vq-f4 codec's 128-256 px levels). One block
// cannot hold them, and one block walking them in chunks serialised copies
// and sums and read x and dy twice. Here a thread-block cluster of 2-16
// blocks takes one (sample, run of whole groups), as in the forward
// (group_norm_common.cuh, plan_cluster):
// - the N positions are split over the cluster's blocks in equal shares (a
//   multiple of 32); each block (512 threads, up to 225 KB of shared
//   memory) copies its share of x and dy once into its shared memory with
//   cp.async, in eight stages issued at once, each thread summing exactly
//   the chunks it copied as they land (other strides: element by element
//   through registers);
// - the sums of dy' and dy' * xhat per channel are added within a warp by
//   shuffles, then over the warps, then, after the cluster barrier, over
//   the cluster's blocks in rank order through distributed shared memory:
//   every block holds the same totals and writes dx for its share from
//   shared memory; rank 0 writes the sample's partials and takes the
//   ticket, which counts clusters, and the last cluster's rank 0 sums the
//   batch;
// - a share beyond one block's shared memory (the f32 pair at LSUN-256's
//   (65,536, 256): 4 MB against a 16-block cluster's 3.5 MB) keeps both x
//   and dy of the share's first positions on chip and streams both of the
//   rest through registers, reading only those twice. Keeping x whole on
//   chip and streaming dy instead would read all of dy twice: 2 MB extra a
//   group against 0.5 MB here.
//
// The C entry point returns cudaGetLastError() after the launch (a refused
// cluster launch returns its error); `group_norm_bwd_route` reports the
// route a shape takes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "group_norm_common.cuh"

namespace {

// The tuning, each value the fastest of those timed (PERF.md's probes of
// this kernel): a block's threads (128 and 512 were slower); its
// shared-memory budget, both slabs and the rest, so that two blocks fit on
// an SM (227 KB); the bytes of x a block takes at least where they fit
// (8 KB was slower), so that its fixed latency (the copy's round trip, the
// barriers, the ticket) is spread over enough work.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 104 * 1024;
constexpr long long kMinSlabBytes = 32768;
constexpr int kStages = 4;  // cp.async groups of positions in the sum pass

// how a slab is copied from device memory
enum Layout : int {
  kScalar = 0,        // element by element, channel index fastest
  kVecChannels = 1,   // 16-byte cp.async along contiguous channels
  kVecPositions = 2,  // 16-byte vectors along contiguous positions
};

using gn::cp_async16;
using gn::cp_async_commit;
using gn::cp_async_wait;
using gn::from_f32;
using gn::to_f32;

// waits until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(kStages == 4, "one case per stage");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// one input's strides (elements) and copy layout
struct Src {
  long long sb, sn, sc;
  int layout;
};

struct Params {
  int N, C, G, cpg, gpb;
  Src x, dy;
  int vec_out;                  // 4-channel shared reads and dx stores
};

// t[b][n0 + r0 .. n0 + r1)[c0 .. c0 + K) -> dst[r][c] (position-major)
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* tb, const Src& s, int c0, int K,
                                          int n0, int r0, int r1) {
  constexpr int VW = 16 / sizeof(T);
  const int tid = threadIdx.x;
  switch (s.layout) {
    case kVecChannels: {
      const int kv = K / VW;
      for (int idx = r0 * kv + tid; idx < r1 * kv; idx += kThreads) {
        const int r = idx / kv;
        const int c = (idx - r * kv) * VW;
        cp_async16(dst + r * K + c, tb + (n0 + r) * s.sn + c0 + c);
      }
      break;
    }
    case kVecPositions: {  // r0, r1 and n0 are multiples of VW
      const int nv = (r1 - r0) / VW;
      for (int idx = tid; idx < K * nv; idx += kThreads) {
        const int c = idx / nv;
        const int r = r0 + (idx - c * nv) * VW;
        const uint4 u = *reinterpret_cast<const uint4*>(tb + (c0 + c) * s.sc + n0 + r);
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < VW; ++e) dst[(r + e) * K + c] = v[e];
      }
      break;
    }
    default:
      for (int idx = r0 * K + tid; idx < r1 * K; idx += kThreads) {
        const int r = idx / K;
        const int c = idx - r * K;
        dst[idx] = tb[(n0 + r) * s.sn + (c0 + c) * s.sc];
      }
  }
}

// stage s of kStages: rows [nr * s / kStages, nr * (s + 1) / kStages)
__device__ __forceinline__ int stage_row(int nr, int s) { return nr * s / kStages; }

// Copies one chunk of x and dy into shared memory: with both channels-last,
// one cp.async group per stage; otherwise everything in one group (the
// register copies are done when the call returns). Returns the groups.
template <typename T>
__device__ __forceinline__ int issue_chunk(T* xs, T* ds, const T* xb, const T* db,
                                           const Params& p, int c0, int K, int n0, int nr) {
  if (p.x.layout == kVecChannels && p.dy.layout == kVecChannels) {
    for (int s = 0; s < kStages; ++s) {
      const int r0 = stage_row(nr, s), r1 = stage_row(nr, s + 1);
      copy_rows<T>(xs, xb, p.x, c0, K, n0, r0, r1);
      copy_rows<T>(ds, db, p.dy, c0, K, n0, r0, r1);
      cp_async_commit();
    }
    return kStages;
  }
  copy_rows<T>(xs, xb, p.x, c0, K, n0, 0, nr);
  copy_rows<T>(ds, db, p.dy, c0, K, n0, 0, nr);
  cp_async_commit();
  return 1;
}

// dy' from dy at xhat. The sigmoid takes the approximate reciprocal (one
// MUFU.RCP and a multiply; __frcp_rn is a longer, rounded sequence): a
// block's time is as much instruction latency as bytes, and this cut the
// f32 step's device time by a tenth, the bf16 one's by a sixth. Its error
// (~2 ulp) is far inside the backward's tolerance.
template <bool SILU>
__device__ __forceinline__ float silu_grad(float d, float xh, float ga, float be) {
  if (!SILU) return d;
  const float z = fmaf(xh, ga, be);
  const float sg = __fdividef(1.f, 1.f + __expf(-z));
  return d * (sg * (1.f + z * (1.f - sg)));
}

// Sums of dy' and dy' * xhat over rows [r0, r1) of a chunk, added to
// red1/red2[j] for each (slice, channel) item j = slice * K + c that this
// thread owns; a slice takes every slices-th row.
template <typename T, bool SILU>
__device__ __forceinline__ void sum_rows(const T* xs, const T* ds, int K, int slices, int r0,
                                         int r1, const float* hm, const float* hr,
                                         const float* ga, const float* be, float* red1,
                                         float* red2) {
  for (int j = threadIdx.x; j < slices * K; j += kThreads) {
    const int sl = j / K;
    const int c = j - sl * K;
    const float mu = hm[c], rs = hr[c], g = ga[c], bb = be[c];
    float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
    for (int r = r0 + sl; r < r1; r += slices) {
      const float xh = (to_f32(xs[r * K + c]) - mu) * rs;
      const float d = silu_grad<SILU>(to_f32(ds[r * K + c]), xh, g, bb);
      a1 += d;
      a2 = fmaf(d, xh, a2);
    }
    red1[j] += a1;
    red2[j] += a2;
  }
}

// dx[b][n0 .. n0 + nr)[c0 .. c0 + K) from the chunk in shared memory:
// dx = dy' * ca + xhat * cb + cc per channel
template <typename T, bool SILU>
__device__ __forceinline__ void store_rows(T* dxb, const T* xs, const T* ds, const float* hm,
                                           const float* hr, const float* ga,
                                           const float* be, const float* ca, const float* cb,
                                           const float* cc, const Params& p, int c0, int K,
                                           int n0, int nr) {
  const int tid = threadIdx.x;
  if (p.vec_out) {
    // a thread keeps one run of 4 channels (their coefficients in
    // registers) and takes every R-th row: 16-byte f32 or 8-byte 16-bit
    // reads and stores
    using V = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;
    const int kv = K / 4;
    const int R = max(1, kThreads / kv);
    for (int j = tid; j < R * kv; j += kThreads) {
      const int r0 = j / kv;
      const int c = (j - r0 * kv) * 4;
      float m[4], s[4], g[4], bb[4], k1[4], k2[4], k3[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e] = hm[c + e];
        s[e] = hr[c + e];
        g[e] = ga[c + e];
        bb[e] = be[c + e];
        k1[e] = ca[c + e];
        k2[e] = cb[c + e];
        k3[e] = cc[c + e];
      }
#pragma unroll 2
      for (int r = r0; r < nr; r += R) {
        const V xu = *reinterpret_cast<const V*>(xs + r * K + c);
        const V du = *reinterpret_cast<const V*>(ds + r * K + c);
        const T* xv = reinterpret_cast<const T*>(&xu);
        const T* dv = reinterpret_cast<const T*>(&du);
        V u;
        T* v = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xh = (to_f32(xv[e]) - m[e]) * s[e];
          const float d = silu_grad<SILU>(to_f32(dv[e]), xh, g[e], bb[e]);
          v[e] = from_f32<T>(fmaf(d, k1[e], fmaf(xh, k2[e], k3[e])));
        }
        *reinterpret_cast<V*>(dxb + size_t(n0 + r) * p.C + c0 + c) = u;
      }
    }
  } else {
    for (int idx = tid; idx < nr * K; idx += kThreads) {
      const int r = idx / K;
      const int c = idx - r * K;
      const float xh = (to_f32(xs[idx]) - hm[c]) * hr[c];
      const float d = silu_grad<SILU>(to_f32(ds[idx]), xh, ga[c], be[c]);
      dxb[size_t(n0 + r) * p.C + c0 + c] = from_f32<T>(fmaf(d, ca[c], fmaf(xh, cb[c], cc[c])));
    }
  }
}

// The last block of a channel run: dscale and dbias of its K channels, each
// the sum of the B per-sample partials in ws, VC channels a thread (float4
// reads where they line up). P contiguous runs of b per column, each
// summed in order with 16 reads in flight, then the runs in order: a fixed
// order for given B and K, so the result is bit-reproducible.
template <int VC, int NT>
__device__ __forceinline__ void batch_sum(const float* ws, float* dscale, float* dbias,
                                          float* red, int B, int C, int c0, int K) {
  const int tid = threadIdx.x;
  const size_t BC = size_t(B) * C;
  const int items = 2 * K / VC;  // VC-channel columns of dscale, then of dbias
  const int P = max(1, NT / items);
  const int seg = (B + P - 1) / P;
  for (int idx = tid; idx < items * P; idx += NT) {
    const int item = idx / P;
    const int part = idx - item * P;
    const int col = item * VC;
    const float* src = ws + (col < K ? size_t(c0 + col) : BC + c0 + col - K);
    float acc[VC];
#pragma unroll
    for (int v = 0; v < VC; ++v) acc[v] = 0.f;
    const int hi = min(B, (part + 1) * seg);
#pragma unroll 16
    for (int bb = part * seg; bb < hi; ++bb) {
      if constexpr (VC == 4) {
        const float4 w = __ldcg(reinterpret_cast<const float4*>(src + size_t(bb) * C));
        acc[0] += w.x;
        acc[1] += w.y;
        acc[2] += w.z;
        acc[3] += w.w;
      } else {
        acc[0] += __ldcg(src + size_t(bb) * C);
      }
    }
#pragma unroll
    for (int v = 0; v < VC; ++v) red[idx * VC + v] = acc[v];
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * K; idx += NT) {  // one output channel each
    const int item = idx / VC;
    const int v = idx - item * VC;
    float acc = 0.f;
    for (int q = 0; q < P; ++q) acc += red[(item * P + q) * VC + v];
    if (idx < K)
      dscale[c0 + idx] = acc;
    else
      dbias[c0 + idx - K] = acc;
  }
}

// bytes of a slab of rows x K elements, rounded up to 16
template <typename T> __host__ __device__ __forceinline__ int slab_bytes(int rows, int K) {
  return (rows * K * int(sizeof(T)) + 15) / 16 * 16;
}

// floats a block needs besides the two slabs
__host__ __device__ __forceinline__ int extra_floats(int K, int gpb) {
  return 9 * K + 2 * gpb + (2 * K > 4 * kThreads ? 2 * K : 4 * kThreads);
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              T* __restrict__ dx, float* __restrict__ dscale, float* __restrict__ dbias,
              float* __restrict__ ws, unsigned int* __restrict__ tickets, Params p) {
  const int K = p.gpb * p.cpg;
  const int c0 = blockIdx.x * K;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                     // [N][K] x
  T* ds = reinterpret_cast<T*>(smem + slab_bytes<T>(p.N, K));  // [N][K] dy
  float* hm = reinterpret_cast<float*>(smem + 2 * slab_bytes<T>(p.N, K));  // [K] mean
  float* hr = hm + K;    // [K] rstd
  float* ga = hr + K;    // [K] scale
  float* be = ga + K;    // [K] bias
  float* s1 = be + K;    // [K] sum of dy'
  float* s2 = s1 + K;    // [K] sum of dy' * xhat
  float* ca = s2 + K;    // [K] dx = dy' * ca + xhat * cb + cc
  float* cb = ca + K;
  float* cc = cb + K;
  float* gm1 = cc + K;   // [gpb] mean(dy' * gamma)
  float* gm2 = gm1 + p.gpb;  // [gpb] mean(dy' * gamma * xhat)
  float* red = gm2 + p.gpb;  // [max(4 kThreads, 2K)] partial sums
  __shared__ bool is_last;

  const int tid = threadIdx.x;
  const T* xb = x + b * p.x.sb;
  const T* db = dy + b * p.dy.sb;
  const int slices = max(1, kThreads / K);  // positions split among a channel's threads
  float* red1 = red;
  float* red2 = red + slices * K;
  // the slabs are on their way while the per-channel constants are read
  const int groups = issue_chunk<T>(xs, ds, xb, db, p, c0, K, 0, p.N);
  for (int c = tid; c < K; c += kThreads) {
    const size_t gi = size_t(b) * p.G + blockIdx.x * p.gpb + c / p.cpg;
    hm[c] = mean[gi];
    hr[c] = rstd[gi];
    ga[c] = scale[c0 + c];
    be[c] = bias[c0 + c];
  }
  for (int j = tid; j < 2 * slices * K; j += kThreads) red[j] = 0.f;

  // sum pass, stage by stage
  for (int s = 0; s < groups; ++s) {
    cp_async_wait_pending(groups - 1 - s);
    __syncthreads();
    const int r0 = groups == 1 ? 0 : stage_row(p.N, s);
    const int r1 = groups == 1 ? p.N : stage_row(p.N, s + 1);
    if (SILU)
      sum_rows<T, true>(xs, ds, K, slices, r0, r1, hm, hr, ga, be, red1, red2);
    else
      sum_rows<T, false>(xs, ds, K, slices, r0, r1, hm, hr, ga, be, red1, red2);
  }
  __syncthreads();
  // the slices of each channel in a fixed order: where K divides 32 a warp
  // holds 32 / K slices of every channel, added by shuffles first
  int parts = slices;
  if (32 % K == 0) {  // then slices * K == kThreads
    const int lane = tid & 31;
    float a1 = red1[tid], a2 = red2[tid];
#pragma unroll
    for (int off = 16; off >= K; off >>= 1) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    __syncthreads();
    if (lane < K) {
      red1[(tid >> 5) * K + lane] = a1;
      red2[(tid >> 5) * K + lane] = a2;
    }
    parts = kWarps;
    __syncthreads();
  }
  for (int c = tid; c < K; c += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int q = 0; q < parts; ++q) {
      a1 += red1[q * K + c];
      a2 += red2[q * K + c];
    }
    s1[c] = a1;
    s2[c] = a2;
  }
  __syncthreads();

  // per group, then per channel: the coefficients of dx and the sample's
  // partials; then thread 0 fences (cumulative over the block's writes
  // after the barrier) and takes the ticket while the others go on
  const float inv_n = 1.f / (float(p.N) * float(p.cpg));
  for (int g = tid; g < p.gpb; g += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int c = g * p.cpg; c < (g + 1) * p.cpg; ++c) {
      a1 = fmaf(ga[c], s1[c], a1);
      a2 = fmaf(ga[c], s2[c], a2);
    }
    gm1[g] = a1 * inv_n;
    gm2[g] = a2 * inv_n;
  }
  __syncthreads();
  const size_t BC = size_t(B) * p.C;
  for (int c = tid; c < K; c += kThreads) {
    const int g = c / p.cpg;
    const float rs = hr[c];
    ca[c] = rs * ga[c];
    cb[c] = -rs * gm2[g];
    cc[c] = -rs * gm1[g];
    ws[size_t(b) * p.C + c0 + c] = s2[c];       // dscale partial
    ws[BC + size_t(b) * p.C + c0 + c] = s1[c];  // dbias partial
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicInc(&tickets[blockIdx.x], unsigned(B - 1)) == unsigned(B - 1);
  }

  // dx pass, from the slabs on chip
  T* dxb = dx + size_t(b) * p.N * p.C;
  if (SILU)
    store_rows<T, true>(dxb, xs, ds, hm, hr, ga, be, ca, cb, cc, p, c0, K, 0, p.N);
  else
    store_rows<T, false>(dxb, xs, ds, hm, hr, ga, be, ca, cb, cc, p, c0, K, 0, p.N);

  // the batch sum: the block with the last ticket of this channel run
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (K % 4 == 0 && p.C % 4 == 0)
    batch_sum<4, kThreads>(ws, dscale, dbias, red, B, p.C, c0, K);
  else
    batch_sum<1, kThreads>(ws, dscale, dbias, red, B, p.C, c0, K);
}

template <typename T, bool SILU>
cudaError_t launch_kernel(const T* x, const T* dy, const float* scale, const float* bias,
                          const float* mean, const float* rstd, T* dx, float* dscale,
                          float* dbias, float* ws, unsigned int* tickets, int B,
                          const Params& p, size_t smem, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;  // dynamic shared memory without opting in
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_bwd_kernel<T, SILU>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed = kSmemBytes;
  }
  const dim3 grid(p.G / p.gpb, B);
  gn_bwd_kernel<T, SILU><<<grid, kThreads, smem, stream>>>(
      x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws, tickets, p);
  return cudaGetLastError();
}

template <typename T>
int copy_layout(const T* t, const Src& s, int K, int N) {
  constexpr int es = sizeof(T);
  constexpr int VW = 16 / es;
  const bool base_aligned = reinterpret_cast<uintptr_t>(t) % 16 == 0 && (s.sb * es) % 16 == 0;
  if (s.sc == 1 && base_aligned && K % VW == 0 && (s.sn * es) % 16 == 0) return kVecChannels;
  if (s.sn == 1 && base_aligned && N % VW == 0 && (s.sc * es) % 16 == 0) return kVecPositions;
  return kScalar;
}

// ---- the cluster route ----

// bytes a cluster block needs besides its slabs: its partial sums [2][K],
// the reduction's [kCWarps][2][K] (reused by the batch sum, which takes
// up to [4 kCThreads]), gm1 and gm2 [2][gpb]
inline int cluster_extra_bytes(int K, int gpb) {
  const int red = gn::kCWarps * 2 * K > 4 * gn::kCThreads ? gn::kCWarps * 2 * K
                                                           : 4 * gn::kCThreads;
  return 4 * (2 * K + red + 2 * gpb);
}

template <typename T, bool SILU, int VC>
__global__ void __launch_bounds__(gn::kCThreads, 1)
gn_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      T* __restrict__ dx, float* __restrict__ dscale, float* __restrict__ dbias,
                      float* __restrict__ ws, unsigned int* __restrict__ tickets,
                      gn::Strides xst, gn::Strides dst, gn::CParams p) {
  using gn::kCThreads;
  using gn::kCStages;
  const int K = p.K;
  const int rank = blockIdx.x;  // a cluster spans gridDim.x
  const int run = blockIdx.y;
  const int c0 = run * K;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                                // [resident][K] x
  T* ds = reinterpret_cast<T*>(smem + p.slab_bytes);                 // [resident][K] dy
  float* part = reinterpret_cast<float*>(smem + 2 * p.slab_bytes);   // [2][K] sums of dy', dy' xhat
  float* red = part + 2 * K;  // the reduction; then the cluster's sums; then the batch sum's
  float* gm = red + (gn::kCWarps * 2 * K > 4 * kCThreads ? gn::kCWarps * 2 * K
                                                         : 4 * kCThreads);  // [2][gpb]
  __shared__ bool is_last;

  const int tid = threadIdx.x;
  const int cv = tid & (p.kvp - 1);
  const int r0 = tid / p.kvp;
  const int rp = kCThreads / p.kvp;
  const bool active = cv < p.kv;
  const int cc = cv * VC;  // the chunk's first channel in the run
  const int n_lo = rank * p.share;
  const int n_cnt = max(0, min(p.share, p.N - n_lo));
  const int n_res = min(n_cnt, p.resident);
  const T* xb = x + b * xst.sb + n_lo * xst.sn + (c0 + cc) * xst.sc;   // the chunk at n_lo
  const T* db = dy + b * dst.sb + n_lo * dst.sn + (c0 + cc) * dst.sc;
  const bool vec = VC * sizeof(T) == 16 && p.vec_in;  // cp.async and 16-byte loads

  float mu[VC], rs[VC], ga[VC], be[VC], a1[VC], a2[VC];
#pragma unroll
  for (int e = 0; e < VC; ++e) {
    a1[e] = a2[e] = 0.f;
    const int c = active ? c0 + cc + e : c0;
    const size_t gi = size_t(b) * p.G + c / p.cpg;
    mu[e] = mean[gi];
    rs[e] = rstd[gi];
    ga[e] = scale[c];
    be[e] = bias[c];
  }
  auto add = [&](const T (&tx)[VC], const T (&td)[VC]) {
#pragma unroll
    for (int e = 0; e < VC; ++e) {
      const float xh = (to_f32(tx[e]) - mu[e]) * rs[e];
      const float d = silu_grad<SILU>(to_f32(td[e]), xh, ga[e], be[e]);
      a1[e] += d;
      a2[e] = fmaf(d, xh, a2[e]);
    }
  };

  // the resident positions: cp.async in stages, all issued before any sum
  const int srows = n_res > 0 ? gn::round_up(gn::ceil_div(n_res, kCStages), rp) : 0;
  if (vec) {
    for (int s = 0; s < kCStages; ++s) {
      if (active)
        for (int r = s * srows + r0; r < min(n_res, (s + 1) * srows); r += rp) {
          cp_async16(xs + r * K + cc, xb + r * xst.sn);
          cp_async16(ds + r * K + cc, db + r * dst.sn);
        }
      cp_async_commit();
    }
  } else if (active) {  // element by element through the strides
#pragma unroll 2
    for (int r = r0; r < n_res; r += rp) {
      T tx[VC], td[VC];
      gn::load_chunk<T, VC>(tx, xb + r * xst.sn, xst.sc, false);
      gn::load_chunk<T, VC>(td, db + r * dst.sn, dst.sc, false);
      add(tx, td);
      gn::smem_write<T, VC>(xs + r * K + cc, tx);
      gn::smem_write<T, VC>(ds + r * K + cc, td);
    }
  }
  // the streamed positions (beyond the shared memory) while those copies fly
  if (active) {
#pragma unroll 2
    for (int r = n_res + r0; r < n_cnt; r += rp) {
      T tx[VC], td[VC];
      gn::load_chunk<T, VC>(tx, xb + r * xst.sn, xst.sc, vec);
      gn::load_chunk<T, VC>(td, db + r * dst.sn, dst.sc, vec);
      add(tx, td);
    }
  }
  // the stages as they land: each thread sums the chunks it copied
  if (vec) {
    for (int s = 0; s < kCStages; ++s) {
      gn::cp_async_wait_pending(kCStages - 1 - s);
      if (active)
        for (int r = s * srows + r0; r < min(n_res, (s + 1) * srows); r += rp) {
          T tx[VC], td[VC];
          gn::smem_read<T, VC>(tx, xs + r * K + cc);
          gn::smem_read<T, VC>(td, ds + r * K + cc);
          add(tx, td);
        }
    }
  }

  gn::block_sums<VC>(a1, a2, p, red, part);
  gn::cluster_arrive();  // this block's part is written
  gn::cluster_wait();    // ... and every other block's
  gn::cluster_sums(p, part, red);  // red[0, K): sums of dy'; red[K, 2K): of dy' * xhat

  // per group the coefficients of dx, the same in every block; rank 0
  // writes the sample's partials, then its thread 0 fences (cumulative over
  // the block's writes after the barrier) and takes the cluster's ticket
  const float inv_n = 1.f / (float(p.N) * float(p.cpg));
  for (int g = tid; g < p.gpb; g += kCThreads) {
    float g1 = 0.f, g2 = 0.f;
    for (int c = g * p.cpg; c < (g + 1) * p.cpg; ++c) {
      g1 = fmaf(scale[c0 + c], red[c], g1);
      g2 = fmaf(scale[c0 + c], red[K + c], g2);
    }
    gm[g] = g1 * inv_n;
    gm[p.gpb + g] = g2 * inv_n;
  }
  if (rank == 0) {
    const size_t BC = size_t(B) * p.C;
    for (int j = tid; j < K; j += kCThreads) {
      ws[size_t(b) * p.C + c0 + j] = red[K + j];   // dscale partial
      ws[BC + size_t(b) * p.C + c0 + j] = red[j];  // dbias partial
    }
  }
  __syncthreads();
  if (rank == 0 && tid == 0) {
    __threadfence();
    is_last = atomicInc(&tickets[run], unsigned(B - 1)) == unsigned(B - 1);
  }

  // dx: the resident positions from shared memory, the streamed ones read again
  if (active) {
    float k1[VC], k2[VC], k3[VC];
#pragma unroll
    for (int e = 0; e < VC; ++e) {
      const int g = (cc + e) / p.cpg;
      k1[e] = rs[e] * ga[e];
      k2[e] = -rs[e] * gm[p.gpb + g];
      k3[e] = -rs[e] * gm[g];
    }
    auto dx_of = [&](const T (&tx)[VC], const T (&td)[VC], float (&v)[VC]) {
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        const float xh = (to_f32(tx[e]) - mu[e]) * rs[e];
        const float d = silu_grad<SILU>(to_f32(td[e]), xh, ga[e], be[e]);
        v[e] = fmaf(d, k1[e], fmaf(xh, k2[e], k3[e]));
      }
    };
    T* dxb = dx + (size_t(b) * p.N + n_lo) * p.C + c0 + cc;
#pragma unroll 2
    for (int r = r0; r < n_res; r += rp) {
      T tx[VC], td[VC];
      gn::smem_read<T, VC>(tx, xs + r * K + cc);
      gn::smem_read<T, VC>(td, ds + r * K + cc);
      float v[VC];
      dx_of(tx, td, v);
      gn::store_chunk<T, VC>(dxb + size_t(r) * p.C, v, p.vec_out);
    }
#pragma unroll 2
    for (int r = n_res + r0; r < n_cnt; r += rp) {
      T tx[VC], td[VC];
      gn::load_chunk<T, VC>(tx, xb + r * xst.sn, xst.sc, vec);
      gn::load_chunk<T, VC>(td, db + r * dst.sn, dst.sc, vec);
      float v[VC];
      dx_of(tx, td, v);
      gn::store_chunk<T, VC>(dxb + size_t(r) * p.C, v, p.vec_out);
    }
  }

  // the batch sum: rank 0 of the cluster with the last ticket of this run
  if (rank == 0) {
    __syncthreads();
    if (is_last) {
      __threadfence();
      if (K % 4 == 0 && p.C % 4 == 0)
        batch_sum<4, kCThreads>(ws, dscale, dbias, red, B, p.C, c0, K);
      else
        batch_sum<1, kCThreads>(ws, dscale, dbias, red, B, p.C, c0, K);
    }
  }
  gn::cluster_wait();  // no block leaves while another may still read its sums
}

template <typename T, int VC>
const void* cluster_kernel(bool silu) {
  return silu ? reinterpret_cast<const void*>(gn_bwd_cluster_kernel<T, true, VC>)
              : reinterpret_cast<const void*>(gn_bwd_cluster_kernel<T, false, VC>);
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
  // f32 slabs beyond the cluster's shared memory stream in 128-byte
  // segments (faster than 32 there; slower for 16-bit inputs)
  return gn::plan_cluster(N, G, p->cpg, int(sizeof(T)), 2, gn::kCSmemMax, 32,
                          sizeof(T) == 4 ? 128 : 32, kernel, cluster_extra_bytes, p);
}

template <typename T, int VC>
cudaError_t launch_cluster_vc(const T* x, const T* dy, const float* scale, const float* bias,
                              const float* mean, const float* rstd, T* dx, float* dscale,
                              float* dbias, float* ws, unsigned int* tickets, int B,
                              const gn::Strides& xst, const gn::Strides& dst,
                              const gn::CParams& p, bool silu, cudaStream_t stream) {
  // (the first query also sets the kernel's attributes)
  if (gn::resident_blocks(cluster_kernel<T, VC>(silu), p.cs, p.smem) < 1)
    return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      gn::cluster_config(dim3(p.cs, p.G / p.gpb, B), p.cs, p.smem, stream, attr);
  if (silu)
    return cudaLaunchKernelEx(&cfg, gn_bwd_cluster_kernel<T, true, VC>, x, dy, scale, bias, mean,
                              rstd, dx, dscale, dbias, ws, tickets, xst, dst, p);
  return cudaLaunchKernelEx(&cfg, gn_bwd_cluster_kernel<T, false, VC>, x, dy, scale, bias, mean,
                            rstd, dx, dscale, dbias, ws, tickets, xst, dst, p);
}

template <typename T>
bool vec_chunks(const T* t, const gn::Strides& s) {
  constexpr int es = sizeof(T);
  return s.sc == 1 && reinterpret_cast<uintptr_t>(t) % 16 == 0 && (s.sb * es) % 16 == 0 &&
         (s.sn * es) % 16 == 0;
}

// floats a single block needs besides the two slabs, and its bytes in all
template <typename T>
long long single_block_bytes(int cpg, int gpb, long long rows) {
  const long long K = (long long)gpb * cpg;
  return 2 * ((rows * K * int(sizeof(T)) + 15) / 16 * 16) + 4LL * extra_floats(int(K), gpb);
}

// the single-block route's run of groups, and whether its slabs fit
template <typename T>
bool single_block_plan(int N, int C, int G, Params* p) {
  constexpr int es = sizeof(T);
  p->N = N;
  p->C = C;
  p->G = G;
  p->cpg = C / G;
  auto fits = [&](int gpb) { return single_block_bytes<T>(p->cpg, gpb, N) <= kSmemBytes; };
  // a block owns whole groups: grow the run while the slab is small, or
  // while a position's run of channels of dx is not a whole number of
  // 32-byte sectors (up to 128 bytes)
  auto partial_sectors = [&](int gpb) {
    const int run = gpb * p->cpg * es;
    return run < 32 || (run % 32 != 0 && run < 128);
  };
  p->gpb = 1;
  while (G % (2 * p->gpb) == 0 && fits(2 * p->gpb) &&
         (partial_sectors(p->gpb) || (long long)p->gpb * p->cpg * N * es < kMinSlabBytes))
    p->gpb *= 2;
  return fits(p->gpb);
}

template <typename T>
cudaError_t launch(const void* xv, const void* dyv, const float* scale, const float* bias,
                   const float* mean, const float* rstd, void* dxv, float* dscale,
                   float* dbias, float* ws, unsigned int* tickets, int B, int N, int C, int G,
                   const long long* strides, bool silu, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  constexpr int VW = 16 / sizeof(T);
  Params p;
  if (!single_block_plan<T>(N, C, G, &p)) {
    gn::CParams cp;
    if (!cluster_plan<T>(N, C, G, &cp)) return cudaErrorInvalidValue;
    const gn::Strides xst{strides[0], strides[1], strides[2]};
    const gn::Strides dst{strides[3], strides[4], strides[5]};
    cp.eps = 0.f;
    cp.vec_in = cp.vc == VW && vec_chunks(x, xst) && vec_chunks(dy, dst);
    cp.vec_out = cp.vc == VW && reinterpret_cast<uintptr_t>(dx) % 16 == 0 && C % VW == 0;
    const cudaError_t err =
        cp.vc == VW
            ? launch_cluster_vc<T, VW>(x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws,
                                       tickets, B, xst, dst, cp, silu, stream)
            : launch_cluster_vc<T, 1>(x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws,
                                      tickets, B, xst, dst, cp, silu, stream);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
  p.x = {strides[0], strides[1], strides[2], kScalar};
  p.dy = {strides[3], strides[4], strides[5], kScalar};
  const int K = p.gpb * p.cpg;
  p.x.layout = copy_layout(x, p.x, K, N);
  p.dy.layout = copy_layout(dy, p.dy, K, N);
  p.vec_out = reinterpret_cast<uintptr_t>(dx) % 16 == 0 && K % 4 == 0 && C % 4 == 0;
  const size_t smem = size_t(single_block_bytes<T>(p.cpg, p.gpb, N));
  return silu ? launch_kernel<T, true>(x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws,
                                       tickets, B, p, smem, stream)
              : launch_kernel<T, false>(x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws,
                                        tickets, B, p, smem, stream);
}

template <typename T>
int route(int N, int C, int G, int* out) {
  Params sp;
  if (single_block_plan<T>(N, C, G, &sp)) {
    out[0] = 0;
    out[1] = sp.gpb;
    out[2] = 1;
    out[3] = N;
    out[4] = N;
    out[5] = int(single_block_bytes<T>(sp.cpg, sp.gpb, N));
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

// x, dy: (B, N, C) through element strides (x's sb, sn, sc, then dy's);
// scale, bias: (C,) f32; mean, rstd: (B, G) f32 contiguous, the forward's;
// dx: (B, N, C) contiguous; dscale, dbias: (C,) f32; workspace: (2, B, C)
// f32, 16-byte aligned, the per-sample partials; tickets: at least G
// unsigned ints, zero before the call and left zero by it, so calls in one
// stream's order may share them. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
extern "C" int group_norm_bwd(const void* x, const void* dy, const void* scale, const void* bias,
                              const void* mean, const void* rstd, void* dx, void* dscale,
                              void* dbias, void* workspace, void* tickets, int dtype, int B,
                              int N, int C, int G, long long sxb, long long sxn, long long sxc,
                              long long sdb, long long sdn, long long sdc, int silu,
                              void* stream) {
  if (B < 1 || N < 1 || G < 1 || C < G || C % G != 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  const long long strides[6] = {sxb, sxn, sxc, sdb, sdn, sdc};
  const float* s = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* dsc = static_cast<float*>(dscale);
  float* dbi = static_cast<float*>(dbias);
  float* w = static_cast<float*>(workspace);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  const cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch<float>(x, dy, s, bb, mu, rs, dx, dsc, dbi, w, tk, B, N, C, G, strides,
                               silu, str));
    case 1:
      return int(launch<__nv_bfloat16>(x, dy, s, bb, mu, rs, dx, dsc, dbi, w, tk, B, N, C, G,
                                       strides, silu, str));
    case 2:
      return int(launch<__half>(x, dy, s, bb, mu, rs, dx, dsc, dbi, w, tk, B, N, C, G, strides,
                                silu, str));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The route group_norm_bwd takes for a shape: out[0] 0 = one block per run,
// 1 = a cluster per run; out[1] groups a run, out[2] blocks a cluster (1 on
// the single-block route), out[3] positions a block, out[4] of which held
// in shared memory, out[5] a block's dynamic shared memory in bytes.
// Returns 0, or a CUDA error where no route takes the shape.
extern "C" int group_norm_bwd_route(int dtype, int N, int C, int G, int* out) {
  if (N < 1 || G < 1 || C < G || C % G != 0) return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return route<float>(N, C, G, out);
    case 1: return route<__nv_bfloat16>(N, C, G, out);
    case 2: return route<__half>(N, C, G, out);
    default: return int(cudaErrorInvalidValue);
  }
}
