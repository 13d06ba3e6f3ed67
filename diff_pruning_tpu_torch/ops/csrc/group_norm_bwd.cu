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
// Design:
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
// - the forward's saved (B, G) mean and rstd are read, not recomputed;
//   xhat = (x - mean) * rstd and dy' (dy through the SiLU derivative on the
//   recomputed z = xhat * gamma + beta, as `group_norm_backward_reference`
//   forms it, the sigmoid with the approximate reciprocal) are formed in
//   registers, once for the sums of dy' and dy' * xhat per channel and
//   again for dx: each thread owns one channel and every (256 / K)-th
//   position, and the partial sums are added in a fixed order, by shuffles
//   within a warp where K divides 32 (no atomics: bit-reproducible);
// - per group gm1 = mean(dy' * gamma), gm2 = mean(dy' * gamma * xhat), then
//   dx = rstd * (dy' * gamma - gm1 - xhat * gm2) from the slab on chip,
//   4 channels a thread in and out (16 bytes f32, 8 bytes 16-bit), their
//   coefficients in registers, written once to a contiguous (B, N, C) dx;
// - dscale and dbias in the same launch: each block writes its channels'
//   per-sample partials to an f32 (2, B, C) workspace; after a barrier,
//   thread 0 fences and takes a ticket with atomicInc (which wraps the
//   ticket back to 0 for the next call) while the block writes dx. The
//   block that takes the last ticket of its channel run sums the B
//   partials of its channels in a fixed order (float4 reads, several in
//   flight, spread over the block's threads) and writes the (C,) outputs.
//   The atomic only orders the blocks; no float is summed atomically;
// - a slab beyond the shared-memory budget (not at CIFAR sizes; the LDM's
//   64x64 latents) is taken in chunks of positions: the sum pass streams x
//   and dy through shared memory, the dx pass reads them again (from L2).
//   Still one launch.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
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
  int N, C, G, cpg, gpb, rows;  // rows: positions per chunk
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
template <int VC>
__device__ __forceinline__ void batch_sum(const float* ws, float* dscale, float* dbias,
                                          float* red, int B, int C, int c0, int K) {
  const int tid = threadIdx.x;
  const size_t BC = size_t(B) * C;
  const int items = 2 * K / VC;  // VC-channel columns of dscale, then of dbias
  const int P = max(1, kThreads / items);
  const int seg = (B + P - 1) / P;
  for (int idx = tid; idx < items * P; idx += kThreads) {
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
  for (int idx = tid; idx < 2 * K; idx += kThreads) {  // one output channel each
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
  T* xs = reinterpret_cast<T*>(smem);                     // [rows][K] x
  T* ds = reinterpret_cast<T*>(smem + slab_bytes<T>(p.rows, K));  // [rows][K] dy
  float* hm = reinterpret_cast<float*>(smem + 2 * slab_bytes<T>(p.rows, K));  // [K] mean
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
  // the first chunk is on its way while the per-channel constants are read
  int groups = issue_chunk<T>(xs, ds, xb, db, p, c0, K, 0, min(p.rows, p.N));
  for (int c = tid; c < K; c += kThreads) {
    const size_t gi = size_t(b) * p.G + blockIdx.x * p.gpb + c / p.cpg;
    hm[c] = mean[gi];
    hr[c] = rstd[gi];
    ga[c] = scale[c0 + c];
    be[c] = bias[c0 + c];
  }
  for (int j = tid; j < 2 * slices * K; j += kThreads) red[j] = 0.f;

  // sum pass, chunk by chunk (one chunk at CIFAR sizes), stage by stage
  for (int n0 = 0; n0 < p.N; n0 += p.rows) {
    const int nr = min(p.rows, p.N - n0);
    if (n0 > 0) {
      __syncthreads();  // the previous chunk is consumed
      groups = issue_chunk<T>(xs, ds, xb, db, p, c0, K, n0, nr);
    }
    for (int s = 0; s < groups; ++s) {
      cp_async_wait_pending(groups - 1 - s);
      __syncthreads();
      const int r0 = groups == 1 ? 0 : stage_row(nr, s);
      const int r1 = groups == 1 ? nr : stage_row(nr, s + 1);
      if (SILU)
        sum_rows<T, true>(xs, ds, K, slices, r0, r1, hm, hr, ga, be, red1, red2);
      else
        sum_rows<T, false>(xs, ds, K, slices, r0, r1, hm, hr, ga, be, red1, red2);
    }
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

  // dx pass: from the slab on chip, or chunk by chunk again
  T* dxb = dx + size_t(b) * p.N * p.C;
  for (int n0 = 0; n0 < p.N; n0 += p.rows) {
    const int nr = min(p.rows, p.N - n0);
    if (p.rows < p.N) {
      __syncthreads();  // the previous chunk is stored
      issue_chunk<T>(xs, ds, xb, db, p, c0, K, n0, nr);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (SILU)
      store_rows<T, true>(dxb, xs, ds, hm, hr, ga, be, ca, cb, cc, p, c0, K, n0, nr);
    else
      store_rows<T, false>(dxb, xs, ds, hm, hr, ga, be, ca, cb, cc, p, c0, K, n0, nr);
  }

  // the batch sum: the block with the last ticket of this channel run
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (K % 4 == 0 && p.C % 4 == 0)
    batch_sum<4>(ws, dscale, dbias, red, B, p.C, c0, K);
  else
    batch_sum<1>(ws, dscale, dbias, red, B, p.C, c0, K);
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

template <typename T>
cudaError_t launch(const void* xv, const void* dyv, const float* scale, const float* bias,
                   const float* mean, const float* rstd, void* dxv, float* dscale,
                   float* dbias, float* ws, unsigned int* tickets, int B, int N, int C, int G,
                   const long long* strides, bool silu, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  constexpr int es = sizeof(T);
  constexpr int VW = 16 / es;
  Params p;
  p.N = N;
  p.C = C;
  p.G = G;
  p.cpg = C / G;
  p.x = {strides[0], strides[1], strides[2], kScalar};
  p.dy = {strides[3], strides[4], strides[5], kScalar};
  auto bytes = [&](int gpb, long long rows) {
    const long long K = (long long)gpb * p.cpg;
    return 2 * ((rows * K * es + 15) / 16 * 16) + 4LL * extra_floats(int(K), gpb);
  };
  auto fits = [&](int gpb) { return bytes(gpb, N) <= kSmemBytes; };
  // a block owns whole groups: grow the run while the slab is small, or
  // while a position's run of channels of dx is not a whole number of
  // 32-byte sectors (up to 128 bytes)
  auto partial_sectors = [&](int gpb) {
    const int run = gpb * p.cpg * es;
    return run < 32 || (run % 32 != 0 && run < 128);
  };
  p.gpb = 1;
  while (G % (2 * p.gpb) == 0 && fits(2 * p.gpb) &&
         (partial_sectors(p.gpb) || (long long)p.gpb * p.cpg * N * es < kMinSlabBytes))
    p.gpb *= 2;
  const int K = p.gpb * p.cpg;
  if (fits(p.gpb)) {
    p.rows = N;
  } else {  // chunks of a multiple of 32 positions
    p.rows = int((kSmemBytes - 4LL * extra_floats(K, p.gpb) - 32) / (2LL * K * es) / 32 * 32);
    if (p.rows < 32) return cudaErrorInvalidValue;
  }
  p.x.layout = copy_layout(x, p.x, K, N);
  p.dy.layout = copy_layout(dy, p.dy, K, N);
  p.vec_out = reinterpret_cast<uintptr_t>(dx) % 16 == 0 && K % 4 == 0 && C % 4 == 0;
  const size_t smem = size_t(bytes(p.gpb, p.rows));
  return silu ? launch_kernel<T, true>(x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws,
                                       tickets, B, p, smem, stream)
              : launch_kernel<T, false>(x, dy, scale, bias, mean, rstd, dx, dscale, dbias, ws,
                                        tickets, B, p, smem, stream);
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
