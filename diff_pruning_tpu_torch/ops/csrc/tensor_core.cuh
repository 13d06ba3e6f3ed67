// Tensor-core building blocks of the 16-bit attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): `ldmatrix` loads of
// 8 x 8 tiles of 16-bit values from shared memory, the
// `mma.sync.aligned.m16n8k16` product with f32 accumulators, the rounding
// of two f32 values into one operand register, and (below) the copies,
// descriptors, products and cluster helpers of Hopper's warpgroup `wgmma`.
//
// Fragment layouts (lane l, g = l / 4, t = l % 4), as the PTX ISA gives
// them for m16n8k16: A (16 x 16, row) a0 = A[g][2t..2t+1], a1 = A[g+8][..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8, col) b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; C (16 x 8) c0, c1 = C[g][2t..2t+1], c2, c3 =
// C[g+8][2t..2t+1]. ldmatrix .x4 takes the row addresses of its four 8 x 8
// matrices from lanes 8i..8i+7 and gives lane l the values (l / 4, 2 (l % 4)
// .. +1) of matrix i (.trans: (2 (l % 4) .. +1, l / 4)).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

// two f32 values as one 32-bit register of the input type, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
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

// ------------------------------------------------ the wide 16-bit kernels
//
// The copies of the 16-bit kernels for 256 < D <= 1024
// (flash_fwd_kernel_wgmma_wide, flash_bwd_{dq,dkv}_kernel_wgmma_wide;
// copy_sw128 below): head-split views of pruned widths have rows that are
// only 8- or 4-byte aligned (D = 268 and 404 in bf16: 536- and 808-byte
// rows), so a launch copies in the widest chunk that the bases and strides
// of all its inputs allow: 16, 8 or 4 bytes by cp.async, or 2-byte loads
// and stores (`granule`).

// the base and the byte strides of a [b][h][n][d] view of 2-byte values,
// or-ed: a power of two divides all of them if it divides this
inline uintptr_t view_bits(const void* p, long long sb, long long sh, long long sn) {
  return reinterpret_cast<uintptr_t>(p) | uintptr_t(sb * 2) | uintptr_t(sh * 2) |
         uintptr_t(sn * 2);
}
// the widest of 16, 8, 4 and 2 bytes that divides the views' view_bits, or-ed
inline int copy_granule(uintptr_t bits) {
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 2;
}

// cp.async of BYTES (4, 8 or 16) with zero-fill past src_bytes
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(src_bytes));
  }
}

template <int DP, int ROWS, int NT, int BYTES>
__device__ __forceinline__ void copy_wide16_chunks(uint16_t* dst, const uint16_t* src,
                                                   long long sn, int row0, int nvalid, int D) {
  constexpr int LD = DP + 8;
  constexpr int E = BYTES / 2;  // elements a chunk
  constexpr int PER_ROW = DP / E;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx - r * PER_ROW) * E;
    const int row = row0 + r;
    int bytes = 0;
    const uint16_t* from = src;  // (zero-fill: nothing is read, but aligned)
    if (row < nvalid && c < D) {
      bytes = (D - c >= E ? E : D - c) * 2;
      from = src + row * sn + c;
    }
    cp_async_n<BYTES>(dst + r * LD + c, from, bytes);
  }
}

// Issues the copy of rows [row0, row0 + ROWS) x columns [0, DP) of one head
// of 16-bit values into a shared [ROWS][DP + 8] tile, rows >= nvalid and
// columns >= D zero-filled, in chunks of `granule` bytes (copy_granule). At
// 2 bytes the loads and stores are plain: they are visible after the next
// __syncthreads, as the cp.async chunks are after their wait.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void copy_wide16(T* dst, const T* src, long long sn, int row0,
                                            int nvalid, int D, int granule) {
  uint16_t* d = reinterpret_cast<uint16_t*>(dst);
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  if (granule == 16) {
    copy_wide16_chunks<DP, ROWS, NT, 16>(d, s, sn, row0, nvalid, D);
  } else if (granule == 8) {
    copy_wide16_chunks<DP, ROWS, NT, 8>(d, s, sn, row0, nvalid, D);
  } else if (granule == 4) {
    copy_wide16_chunks<DP, ROWS, NT, 4>(d, s, sn, row0, nvalid, D);
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      d[r * (DP + 8) + c] = row0 + r < nvalid && c < D ? s[(row0 + r) * sn + c] : uint16_t(0);
    }
  }
}

// rows [0, ROWS) of a shared [ROWS][LD] tile of 16-bit values to device
// memory rows row0.., those < nvalid and columns < D; vec: base and row
// stride 16-byte aligned and D % 8 == 0 (16-byte stores), else 2-byte stores
template <int ROWS, int LD, int NT>
__device__ __forceinline__ void store_wide16(void* dst, long long sn, const void* tile, int row0,
                                             int nvalid, int D, bool vec) {
  uint16_t* out = static_cast<uint16_t*>(dst);
  const uint16_t* in = static_cast<const uint16_t*>(tile);
  if (vec) {
    const int per_row = D / 8;
    for (int idx = threadIdx.x; idx < ROWS * per_row; idx += NT) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 8;
      if (row0 + r < nvalid)
        *reinterpret_cast<uint4*>(out + (row0 + r) * sn + c) =
            *reinterpret_cast<const uint4*>(in + r * LD + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
      const int r = idx / D;
      const int c = idx - r * D;
      if (row0 + r < nvalid) out[(row0 + r) * sn + c] = in[r * LD + c];
    }
  }
}

// one f32 value as a 16-bit value of the input type, as raw bits
__device__ __forceinline__ uint16_t round16(float x, __nv_bfloat16*) {
  const __nv_bfloat16 v = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&v);
}
__device__ __forceinline__ uint16_t round16(float x, __half*) {
  const __half v = __float2half_rn(x);
  return *reinterpret_cast<const uint16_t*>(&v);
}

// ------------------------------------------ Hopper's warpgroup products
//
// The building blocks of the wgmma kernels (flash_fwd_kernel_wgmma_wide,
// flash_bwd_{dq,dkv}_kernel_wgmma_wide): operands in shared memory in the
// 128-byte swizzle (copy_sw128), their descriptors, the m64nNk16 products
// with f32 accumulators (Gmma), the fences around them, and the helpers of
// a thread-block cluster that splits the head dim. An m64nNk16 accumulator
// gives thread t of the warpgroup (warp w = t / 32, lane l) the elements
// (16 w + l / 4 + 8 (e / 2 % 2), 8 (e / 4) + 2 (l % 4) + e % 2) at d[e],
// which is the A fragment layout of mma.sync m16n8k16 taken per warp: two
// adjacent n8 blocks of an accumulator, rounded pairwise (pack2), are the
// register A operand of one k-step.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle: start
// address, the byte offsets between 8-row groups (sbo) and, for an MN-major
// operand, between 64-element column blocks (lbo; unused K-major)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" :::
                   "memory");
}
// generic-proxy writes to shared memory (cp.async, stores) made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the thread-block cluster (blocks splitting the head dim or a loop): this
// block's rank, a barrier over all of them (release / acquire), and loads
// of another block's shared memory
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
}
// the two halves of cluster_sync, for work between them: arrive once this
// thread's reads and writes are done, wait before what must follow every
// thread's arrival (alternate them, as cluster_sync does)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of `p` (this block's shared memory) in block `rank`'s
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {  // (16-byte aligned)
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <typename T> struct Gmma;
#define GMMA_TYPES(T, S)                                                                          \
  template <> struct Gmma<T> {                                                                    \
    /* d (64 x 64) += A (64 x 16, shared) B^T (64 x 16, shared), both K-major */                  \
    static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a, uint64_t b) {         \
      asm volatile(                                                                               \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                            \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." S "." S " "                               \
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
          "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                         \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
            "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
            "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
            "+f"(d[31])                                                                           \
          : "l"(a), "l"(b), "n"(1));                                                              \
    }                                                                                             \
    /* d (64 x 32) += A (64 x 16, shared) B^T (32 x 16, shared), both K-major */                  \
    static __device__ __forceinline__ void ss32(float (&d)[16], uint64_t a, uint64_t b) {         \
      asm volatile(                                                                               \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                            \
          "wgmma.mma_async.sync.aligned.m64n32k16.f32." S "." S " "                               \
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "              \
          "%16, %17, p, 1, 1, 0, 0;\n}\n"                                                         \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
            "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                                 \
          : "l"(a), "l"(b), "n"(1));                                                              \
    }                                                                                             \
    /* d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major: transposed) */         \
    static __device__ __forceinline__ void rs64(float (&d)[32], const uint32_t (&a)[4],           \
                                                uint64_t b) {                                     \
      asm volatile(                                                                               \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                            \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." S "." S " "                               \
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
          "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                           \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
            "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
            "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
            "+f"(d[31])                                                                           \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));                          \
    }                                                                                             \
  };
GMMA_TYPES(__nv_bfloat16, "bf16")
GMMA_TYPES(__half, "f16")
#undef GMMA_TYPES

// The layout of an R x C tile of 16-bit values (C the contiguous dim) that
// wgmma reads with the 128-byte swizzle: slabs of 64 columns, each R rows of
// 128 bytes, in which 16-byte chunk c of row r lies at chunk c ^ (r % 8);
// slabs and tiles 1024-byte aligned. A warp's copies run along the rows of
// device memory and land on distinct banks.
//
// Issues the copy of rows [row0, row0 + R) x columns [col0, col0 + C) of one
// head (row stride sn elements) into such a tile, rows >= nvalid and columns
// >= D zero-filled, in chunks of `granule` bytes (copy_granule); at 2 bytes
// the loads and stores are plain.
template <int R, int C>
__device__ __forceinline__ void copy_sw128(void* dst, const void* src, long long sn, int row0,
                                           int nvalid, int col0, int D, int granule) {
  constexpr int CH = C / 8;  // chunks a row
  uint16_t* d0 = static_cast<uint16_t*>(dst);
  const uint16_t* s0 = static_cast<const uint16_t*>(src);
  // the whole tile in range: the copies alone, no per-chunk checks (the
  // copies' issue bounds the kernel)
  if (granule == 16 && row0 + R <= nvalid && col0 + C <= D) {
    const uint16_t* s1 = s0 + row0 * sn + col0;
    for (int i = threadIdx.x; i < R * CH; i += 256) {
      const int r = i / CH, c = i - r * CH;
      cp_async_n<16>(d0 + (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3),
                     s1 + r * sn + 8 * c, 16);
    }
    return;
  }
  for (int i = threadIdx.x; i < R * CH; i += 256) {
    const int r = i / CH, c = i - r * CH;
    const int row = row0 + r;
    const int col = col0 + 8 * c;
    uint16_t* d = d0 + (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
    const int n = row < nvalid ? min(8, D - col) : 0;  // elements to read, <= 0: none
    const uint16_t* s = n > 0 ? s0 + row * sn + col : s0;  // (zero-fill: nothing is read)
    if (granule == 16) {
      cp_async_n<16>(d, s, n > 0 ? 2 * n : 0);
    } else if (granule == 8) {
#pragma unroll
      for (int e = 0; e < 8; e += 4)
        cp_async_n<8>(d + e, n > e ? s + e : s0, n > e ? 2 * min(4, n - e) : 0);
    } else if (granule == 4) {
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        cp_async_n<4>(d + e, n > e ? s + e : s0, n > e ? 2 * min(2, n - e) : 0);
    } else {
      uint16_t x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = e < n ? s[e] : uint16_t(0);
      *reinterpret_cast<uint4*>(d) = make_uint4(x[0] | uint32_t(x[1]) << 16,
                                                x[2] | uint32_t(x[3]) << 16,
                                                x[4] | uint32_t(x[5]) << 16,
                                                x[6] | uint32_t(x[7]) << 16);
    }
  }
}


// Stores rows [0, R) x columns [0, C) of such a tile (written by the
// threads of the block) to rows row0.. x columns col0.. of one head (row
// stride sn elements), those < nvalid and < D; vec: base and row stride
// 16-byte aligned and D % 8 == 0 (16-byte stores), else 2-byte stores
template <int R, int C>
__device__ __forceinline__ void store_sw128(void* dst, long long sn, const void* tile, int row0,
                                            int nvalid, int col0, int D, int vec) {
  uint16_t* out = static_cast<uint16_t*>(dst);
  const uint16_t* in = static_cast<const uint16_t*>(tile);
  for (int i = threadIdx.x; i < R * (C / 8); i += 256) {
    const int r = i / (C / 8), c = i - r * (C / 8);
    const int row = row0 + r, col = col0 + 8 * c;
    if (row >= nvalid || col >= D) continue;
    const uint16_t* from = in + (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
    if (vec) {  // the whole chunk is in range
      *reinterpret_cast<uint4*>(out + row * sn + col) = *reinterpret_cast<const uint4*>(from);
    } else {
      for (int e = 0; e < 8 && col + e < D; ++e) out[row * sn + col + e] = from[e];
    }
  }
}

}  // namespace
