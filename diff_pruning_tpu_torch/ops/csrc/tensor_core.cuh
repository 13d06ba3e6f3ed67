// Tensor-core building blocks of the 16-bit attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): `ldmatrix` loads of
// 8 x 8 tiles of 16-bit values from shared memory, the
// `mma.sync.aligned.m16n8k16` product with f32 accumulators, and the
// rounding of two f32 values into one operand register.
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
// Copies of the 16-bit kernels for 256 < D <= 1024
// (flash_fwd_kernel_wgmma_wide, which lays its tiles out for wgmma with its
// own copy_core16, and flash_bwd_{dq,dkv}_kernel_mma_wide): head-split
// views of pruned widths have rows that are only 8- or 4-byte aligned (D =
// 268 and 404 in bf16: 536- and 808-byte rows), so a launch copies in the
// widest chunk that the bases and strides of all its inputs allow: 16, 8 or
// 4 bytes by cp.async, or 2-byte loads and stores (`granule`).

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

}  // namespace
