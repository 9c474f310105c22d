// The pieces of the port's last mma.sync kernel, int4_matmul.cu's
// int4_mm_kernel (both int4 matmul directions at shapes TMA cannot map):
// warp-level bf16 tensor-core products (mma.sync m16n8k16, f32 accumulate)
// and ldmatrix fragment loads from shared memory. Every other kernel
// (flash, the grouped matmul, tgmm, the SwiGLU kernels and both int4 matmul
// directions at the shapes TMA maps) runs on sm90_common.cuh.
//
// Tiles sit in shared memory row-major with a padded row stride LD (in
// elements), so that the 8 rows one ldmatrix phase reads fall in 8
// distinct bank groups.
//
// m16n8k16 fragments, for lane l, g = l / 4, t = l % 4:
//   A (16x16):  a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)  a2 = (g, 2t+8..)
//               a3 = (g+8, 2t+8..)
//   B (16x8):   b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8.., n g)
//   C (16x8):   c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..2t+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * LD + c0 + (l >> 4) * 8);
}

// B fragments of the two n-tiles n0 and n0+8 at k0..k0+15, from a tile
// stored [n][k] (K for S = Q K^T): {b[0], b[1]} for n0, {b[2], b[3]} for n0+8
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* tile, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (l & 7) + (l >> 4) * 8) * LD + k0 + ((l >> 3) & 1) * 8);
}

// the same from a tile stored [k][n] (V for O = P V), by transposing loads
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * LD + n0 + (l >> 4) * 8);
}

// d += a * b, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Store two neighbouring bf16 values (columns c, c+1) of an output row.
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace flash
