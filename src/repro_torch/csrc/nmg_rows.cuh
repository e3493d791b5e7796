// The row loop shared by the decode GEMV (nmg_gemv.cu) and the fused
// gated FFN (nmg_ffn.cu): kRowsPerBlock output rows of one fiber group
// against a decode-shaped B[K, M] (M <= kMaxM), f32 accumulation.
//
// Both kernels run exactly this code for every output row, so a row's
// f32 sum is bitwise the same whichever kernel computes it: the fused FFN
// is bitwise equal to the GEMV followed by the gate.
//
// Per K slab of kSlab stored values each thread first issues its `val`
// loads into registers, then the block gathers the B rows named by `cols`
// (the precomputed plan, never re-derived from blk_idx) into shared memory
// as f32, one column of B per shared-memory row: each thread loads a plan
// entry once and issues its M loads back to back, so the gather costs two
// dependent memory latencies per slab, not 2*M.  The FMAs then run from
// registers and shared memory.  Partial sums combine by a fixed warp
// butterfly and then across the row's two warps in order, so the
// summation order is a function of the row alone.  Stored K rows past the
// real K (padding of the last chunk) read as zero, so B needs no padded
// copy; B is read through strides, so x.T needs no copy either.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nmg {

constexpr int kRowsPerBlock = 4;       // output rows per block
constexpr int kWarpsPerRow = 2;        // warps splitting one row's K range
constexpr int kRowThreads = kWarpsPerRow * 32;
constexpr int kThreads = kRowsPerBlock * kRowThreads;
constexpr int kSlab = 512;             // stored K values per slab
constexpr int kPerThread = kSlab / kRowThreads;
constexpr int kSlabStride = kSlab + 1;  // padded shared-memory row
constexpr int kMaxM = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename O>
__device__ __forceinline__ O from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct RowsSmem {
  float b[kMaxM * kSlabStride];                  // b[c * stride + s]
  float part[kRowsPerBlock][kWarpsPerRow][kMaxM];
};

// Rows row0 .. row0 + kRowsPerBlock - 1 of `val` ([R_pad, KN] compressed
// values), all in the fiber group whose plan row is `cols` ([KN] original
// K row of each value).  Every thread of the block calls it.  Thread
// (rloc, rt) = (threadIdx.x / kRowThreads, threadIdx.x % kRowThreads)
// gets the f32 sum of row row0 + rloc against column rt of B when rt < M
// (0 otherwise).  Ends on a barrier, so the caller may call it again with
// the same shared memory.
template <typename T>
__device__ __forceinline__ float rows_dot(
    const T* __restrict__ val, const int* __restrict__ cols, int row0,
    const T* __restrict__ b, long long ldk, long long ldc, int K, int KN,
    int M, RowsSmem& sm) {
  const int rloc = threadIdx.x / kRowThreads;  // row within the block
  const int rt = threadIdx.x % kRowThreads;    // thread within its row
  const int lane = threadIdx.x & 31;
  const T* __restrict__ vrow = val + (size_t)(row0 + rloc) * KN;

  float acc[kMaxM];
#pragma unroll
  for (int c = 0; c < kMaxM; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < KN; k0 += kSlab) {
    const int tk = min(kSlab, KN - k0);
    float v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = rt + j * kRowThreads;
      v[j] = s < tk ? to_f32(vrow[k0 + s]) : 0.f;
    }
    __syncthreads();  // the previous slab is consumed
    for (int s = threadIdx.x; s < tk; s += kThreads) {
      const int col = cols[k0 + s];
      const T* bp = b + (long long)col * ldk;
#pragma unroll
      for (int c = 0; c < kMaxM; ++c)
        if (c < M)
          sm.b[c * kSlabStride + s] =
              col < K ? to_f32(bp[(long long)c * ldc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = rt + j * kRowThreads;
      if (s < tk) {
#pragma unroll
        for (int c = 0; c < kMaxM; ++c)
          if (c < M) acc[c] = fmaf(v[j], sm.b[c * kSlabStride + s], acc[c]);
      }
    }
  }

  const int warp_in_row = rt >> 5;
#pragma unroll
  for (int c = 0; c < kMaxM; ++c) {
    float x = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0 && c < M) sm.part[rloc][warp_in_row][c] = x;
  }
  __syncthreads();
  float x = 0.f;
  if (rt < M) {
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) x += sm.part[rloc][w][rt];
  }
  __syncthreads();  // sm.part is read; a second call may overwrite it
  return x;
}

}  // namespace nmg
