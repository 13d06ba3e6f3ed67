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

}  // namespace
