// Tensor-core building blocks for Hopper (sm_90a) shared by the bf16
// bodies of matmul_threshold.cu and nmg_spmm.cu:
//   - cp.async copies of 16 (cache-global), 8 or 4 bytes (cache-all) from
//     device memory into shared memory, with a source size so a ragged
//     edge reads as zeros, and the commit / wait_group pair that runs a
//     ring of shared-memory stages;
//   - ldmatrix (x4, x2, and x4.trans for an N-major B) into mma fragments;
//   - mma.sync.aligned.m16n8k16 with bf16 operands and f32 accumulators.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and q = lane % 4:
//   A (16 x 16, row): a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..),
//                     a3 (g+8, 2q+8..)
//   B (16 x 8, col):  b0 (k 2q..2q+1, n g), b1 (k 2q+8.., n g)
//   C (16 x 8, f32):  c0, c1 (g, 2q..2q+1), c2, c3 (g+8, 2q..2q+1)
// ldmatrix hands lane l row l / 4, columns 2(l % 4)..+1 of each 8 x 8
// matrix whose eight row addresses come from lanes 8i..8i+7, which is the
// A and B layout above when the rows are M (A) or N (B) and the 16-byte
// row segments run along K; .trans serves a B stored with rows along K.
// Shared rows are padded by 16 bytes past a multiple of 128 in the
// callers, so the eight row segments one ldmatrix reads fall in eight
// different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (<= 16) of the 16 at src into dst, zero-filling the rest;
// both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a @ b for one 16 x 8 x 16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_tile
