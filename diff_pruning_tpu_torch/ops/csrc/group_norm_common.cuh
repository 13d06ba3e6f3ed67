// What the two GroupNorm kernels (group_norm_fwd.cu, group_norm_bwd.cu)
// share: type conversions, cp.async, and the cluster route's constants,
// chunk copies, barriers and planner.
//
// The cluster route: a thread-block cluster of 2-16 blocks per (sample, run
// of whole groups); the run's N positions are split over the cluster's
// blocks in equal shares of a multiple of 32 positions, each block holds its
// share in its own shared memory, and the per-channel sums of the blocks are
// added in rank order through distributed shared memory. A share beyond one
// block's shared memory keeps its first `resident` positions on chip and
// streams the rest through registers, reading those twice (see
// plan_cluster).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>

namespace gn {

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

// ---- the cluster route ----

// A block's threads (16 warps; 256 threads were slower at the 1-9 MB groups
// timed, though faster at some smaller ones), the stages of its cp.async
// copies, the dynamic shared memory a block may take (of the H100's 227
// KB), the largest cluster (non-portable above 8).
constexpr int kCThreads = 512;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCStages = 8;
constexpr int kCSmemMax = 225 * 1024;
constexpr int kCMaxCluster = 16;

// waits until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(kCStages == 8, "one case per stage");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// the cluster barrier in two halves: arrive (release: this block's shared
// memory writes are visible to the cluster) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one input's strides (elements)
struct Strides {
  long long sb, sn, sc;
};

// The cluster route's plan, from the shape alone. A thread owns one chunk
// of vc channels (16 bytes where the run's K channels split into them, else
// one) at every rp-th position of its block's share: chunk cv = tid % kvp
// (kvp: kv, the chunks a position, rounded up to a power of 2; threads with
// cv >= kv idle), first position tid / kvp, rp = kCThreads / kvp.
struct CParams {
  int N, C, G, cpg, gpb, K;
  int vc, kv, kvp;
  int cs;           // blocks a cluster
  int share;        // positions a block takes (a multiple of 32; the last blocks may take fewer)
  int resident;     // of which the first `resident` stay in shared memory
  int slab_bytes;   // shared memory of one resident slab (x, or dy), 16-byte aligned
  int smem;         // dynamic shared memory of a block
  int vec_in;       // x (and dy) channels-last, 16-byte aligned chunks: cp.async and
                    // 16-byte loads; otherwise element by element through the strides
  int vec_out;      // 16-byte stores of y (dx)
  float eps;
};

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ __forceinline__ int ceil_div(int v, int m) { return (v + m - 1) / m; }

// Sets a cluster kernel's attributes: the dynamic shared memory and
// clusters above the portable 8 blocks.
inline cudaError_t prepare_cluster_kernel(const void* fn) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kCSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline cudaLaunchConfig_t cluster_config(dim3 grid, int cs, int smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks of cs-block clusters of `smem` bytes each that the device holds at
// once (0: none), from cudaOccupancyMaxActiveClusters, which knows how the
// SMs are grouped (a cluster lives on one GPC): asked once per (kernel, cs,
// smem) and kept. Sets the kernel's attributes on its first query.
inline int resident_blocks(const void* fn, int cs, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> known;
  static std::set<const void*> prepared;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(fn, cs, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  if (prepared.count(fn) == 0) {
    if (prepare_cluster_kernel(fn) != cudaSuccess) {
      cudaGetLastError();  // not sticky: clear it
      return 0;
    }
    prepared.insert(fn);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cs, 1, 1), cs, smem, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  known[key] = n * cs;
  return n * cs;
}

// A run's channels: whole groups, grown (while G allows) until a position's
// run of channels fills whole segments of `run_bytes` (or a multiple of
// them up to four) of the channels-last tensors, so that no 32-byte sector
// is shared by two clusters; where the run's slab still exceeds the largest
// cluster's shared memory, grown on to segments of `stream_run_bytes`,
// which the streamed positions read better. Then, of the clusters whose
// blocks (of at most `smem_max` bytes) hold their shares whole, the one the
// device holds the most blocks of at once (the smallest on a tie: a cluster
// lives on one GPC, and 10 blocks of 16-18 SMs leave 6-8 idle); where none
// holds them, the largest cluster, each block keeping as many positions as
// fit and streaming the rest. `kernel(vc)`: the kernel (for chunks of vc
// channels) whose occupancy decides; `extra(K, gpb)`: the bytes a block
// needs besides its slabs; `copies`: the slabs a position (x; x and dy).
// Returns false where no plan exists (a run too wide for the threads, or no
// cluster the device schedules). Plans are kept per shape: the host path of
// a call is then one lookup.
template <typename Kernel, typename Extra>
inline bool plan_cluster(int N, int G, int cpg, int es, int copies, int smem_max, int run_bytes,
                         int stream_run_bytes, Kernel kernel, Extra extra, CParams* p) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CParams> known;
  const auto key = std::make_tuple(kernel(1), N, G, cpg);
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) {
      *p = it->second;
      return true;
    }
  }
  const int vw = 16 / es;
  auto chunks = [&](int gpb) { return (gpb * cpg) % vw == 0 ? vw : 1; };
  int max_cs = 0;
  for (int cs = kCMaxCluster; cs >= 2 && max_cs == 0; --cs)
    if (resident_blocks(kernel(chunks(1)), cs, smem_max) > 0) max_cs = cs;
  if (max_cs == 0) return false;
  auto on_chip = [&](int gpb) {
    const long long K = (long long)gpb * cpg;
    return copies * K * es * N + (long long)max_cs * extra(int(K), gpb) <=
           (long long)max_cs * smem_max;
  };
  auto partial_runs = [&](int gpb, int bytes) {
    const int run = gpb * cpg * es;
    return run < bytes || (run % bytes != 0 && run < 4 * bytes);
  };
  int gpb = 1;
  while (G % (2 * gpb) == 0 && partial_runs(gpb, run_bytes)) gpb *= 2;
  if (!on_chip(gpb))
    while (G % (2 * gpb) == 0 && partial_runs(gpb, stream_run_bytes)) gpb *= 2;
  const int K = gpb * cpg;
  p->gpb = gpb;
  p->K = K;
  p->vc = chunks(gpb);
  p->kv = K / p->vc;
  p->kvp = 1;
  while (p->kvp < p->kv) p->kvp *= 2;
  if (p->kvp > kCThreads) return false;
  const void* fn = kernel(p->vc);
  const int fixed = extra(K, gpb);
  auto slab = [&](int rows) { return round_up(rows * K * es, 16); };
  p->cs = 0;
  int best = 0;
  for (int cs = 2; cs <= max_cs; ++cs) {
    const int share = round_up(ceil_div(N, cs), 32);
    const int smem = fixed + copies * slab(share);
    if (smem > smem_max) continue;
    const int blocks = resident_blocks(fn, cs, smem);
    if (blocks > best) {
      best = blocks;
      p->cs = cs;
      p->share = share;
      p->resident = share;
    }
  }
  if (p->cs == 0) {
    p->cs = max_cs;
    p->share = round_up(ceil_div(N, max_cs), 32);
    p->resident = (smem_max - fixed - 16 * copies) / (copies * K * es);
    if (p->resident < 32) return false;
  }
  p->slab_bytes = slab(p->resident);
  p->smem = fixed + copies * p->slab_bytes;
  const std::lock_guard<std::mutex> lock(mu);
  known[key] = *p;
  return true;
}

// x[n * sn + (c + e) * sc], e < VC: one 16-byte load where vec, else VC
template <typename T, int VC>
__device__ __forceinline__ void load_chunk(T (&t)[VC], const T* src, long long sc, bool vec) {
  if constexpr (VC * sizeof(T) == 16) {
    if (vec) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < VC; ++e) t[e] = v[e];
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < VC; ++e) t[e] = src[e * sc];
}

// a chunk in shared memory, [position][K], 16-byte aligned where VC fills 16 bytes
template <typename T, int VC>
__device__ __forceinline__ void smem_read(T (&t)[VC], const T* src) {
  if constexpr (VC * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < VC; ++e) t[e] = v[e];
  } else {
#pragma unroll
    for (int e = 0; e < VC; ++e) t[e] = src[e];
  }
}

template <typename T, int VC>
__device__ __forceinline__ void smem_write(T* dst, const T (&t)[VC]) {
  if constexpr (VC * sizeof(T) == 16) {
    uint4 u;
    T* v = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < VC; ++e) v[e] = t[e];
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
#pragma unroll
    for (int e = 0; e < VC; ++e) dst[e] = t[e];
  }
}

// out[e] = v[e], e < VC, into a contiguous channels-last output: one 16-byte
// store where vec
template <typename T, int VC>
__device__ __forceinline__ void store_chunk(T* dst, const float (&v)[VC], bool vec) {
  if constexpr (VC * sizeof(T) == 16) {
    if (vec) {
      uint4 u;
      T* o = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < VC; ++e) o[e] = from_f32<T>(v[e]);
      *reinterpret_cast<uint4*>(dst) = u;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < VC; ++e) dst[e] = from_f32<T>(v[e]);
}

// Adds a thread's per-channel sums a1, a2 (its chunk's VC channels) over the
// block in a fixed order: within a warp by shuffles over the lanes that
// hold the same chunk (kvp < 32), then over the warps (or the positions a
// block row of threads spans, kvp >= 32) through red ([kCWarps][2][K]);
// part ([2][K]) receives the block's sums. Ends with the block's barrier.
template <int VC>
__device__ __forceinline__ void block_sums(float (&a1)[VC], float (&a2)[VC], const CParams& p,
                                           float* red, float* part) {
  const int tid = threadIdx.x;
  const int K = p.K;
  if (p.kvp < 32) {
    for (int off = 16; off >= p.kvp; off >>= 1) {
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        a1[e] += __shfl_xor_sync(0xffffffffu, a1[e], off);
        a2[e] += __shfl_xor_sync(0xffffffffu, a2[e], off);
      }
    }
  }
  const int cv = tid & (p.kvp - 1);
  const int slot = p.kvp < 32 ? tid >> 5 : tid / p.kvp;
  if (cv < p.kv && (p.kvp >= 32 || (tid & 31) < p.kvp)) {
#pragma unroll
    for (int e = 0; e < VC; ++e) {
      red[slot * 2 * K + cv * VC + e] = a1[e];
      red[slot * 2 * K + K + cv * VC + e] = a2[e];
    }
  }
  __syncthreads();
  const int slots = p.kvp < 32 ? kCWarps : kCThreads / p.kvp;
  for (int j = tid; j < 2 * K; j += kCThreads) {
    float s = 0.f;
    for (int q = 0; q < slots; ++q) s += red[q * 2 * K + j];
    part[j] = s;
  }
  __syncthreads();
}

// After every block of the cluster has written part and passed the
// cluster barrier: the cluster's sums, [2][K], added in rank order into out
// (the same order in every block, so every block holds the same totals);
// then this block signals that it is done with the others' shared memory
// (it waits for their signals before it exits).
__device__ __forceinline__ void cluster_sums(const CParams& p, float* part, float* out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  for (int j = threadIdx.x; j < 2 * p.K; j += kCThreads) {
    float s = 0.f;
    for (int q = 0; q < p.cs; ++q) s += cluster.map_shared_rank(part, q)[j];
    out[j] = s;
  }
  cluster_arrive();
  __syncthreads();
}

}  // namespace gn
