// PTX helpers shared by the port's kernels (sm_80 instructions that Hopper
// keeps): asynchronous 16-byte copies into shared memory, ldmatrix, and the
// bf16 m16n8k16 tensor-core product.  Header only; every kernel source that
// includes it is rebuilt when it changes (kernels/build.py hashes csrc/*.cuh).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), as the PTX
// ISA defines them:
//   A (16 x 16, row-major), four .b32 of two bf16 each:
//     a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, cols 2t, 2t+1),
//     a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, "col": k pairs packed), two .b32:
//     b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8, 2t+9, col g);
//   C/D (16 x 8, float32), four floats:
//     c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, cols 2t, 2t+1).
// ldmatrix.x4 gives lane i row i/4, elements 2(i%4) and 2(i%4)+1 of each of
// four 8 x 8 bf16 matrices whose row addresses lanes 0-7, 8-15, 16-23 and
// 24-31 supply; .trans gives the transpose, so the same call reads a
// row-major operand as the B fragment of its transpose.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wlk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1.  src_bytes < 16 fills the rest
// of the 16 with zeros; with src_bytes = 0 nothing is read from `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: one m16n8k16 product, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even into one .b32 of bf16 (lo in the low
// half, the first element of an A or B fragment pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace wlk
