// n:m:g decode GEMV for Hopper (sm_90a): C = A_canonical[R, K] @ B[K, M],
// M <= 16, f32 accumulation, one cast to the output type in the epilogue.
//
// Replaces the Pallas body repro/kernels/nmg_gemv.py:_kernel (launched by
// gemv_pallas_call) and, over up to three segments in one launch, the fused
// QKV launch repro/kernels/nmg_fused.py:nmg_qkv_pallas.
//
// What bounds it on the H100: device-memory bytes.  At decode M is the slot
// count (<= 16), so every stored value is used for at most 16 multiply-adds
// while the compressed weights are read once per step: about 2 flops per
// byte of bf16 `val`, far below the ~295 flops/byte where the tensor cores
// would become the limit.  For bert-base-sten at 1:4:8 gr64 in bf16 a decode
// step reads ~3.5 MB of `val` per layer, ~12.6 us for 12 layers at
// 3.35 TB/s.
//
// Design: four output rows per block, all inside one fiber group
// (gr % 4 == 0) so they share the group's column plan, and two warps per
// row splitting its K range.  Per K slab of 512 stored values each thread
// first issues its `val` loads into registers, then the block gathers the
// B rows named by `cols` (the precomputed plan, never re-derived from
// blk_idx) into shared memory as f32, one column of B per shared-memory
// row: each thread loads a plan entry once and issues its M loads back to
// back, so the gather costs two dependent memory latencies per slab, not
// 2*M.  The FMAs then run from registers and shared memory.  Partial sums
// combine by a fixed warp butterfly and then across the row's two warps in
// order, so the summation order is a function of the row alone: the fused
// QKV launch (blockIdx.y picks the segment, no concatenated copy of the
// weights) is bitwise equal to three single launches.  Stored K rows past
// the real K (padding of the last chunk) read as zero, so B needs no padded
// copy; B is read through strides, so x.T needs no copy either.
// Still simple: no cp.async/TMA pipelining across slabs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, typename O>
struct Seg {
  const T* val;      // [R_pad, KN] compressed values
  const int* cols;   // [R_pad / gr, KN] original K row of each value
  O* out;            // [R, M] or, transposed, [M, R]
  int R;
  int R_pad;
};

template <typename T, typename O>
struct Segs {
  Seg<T, O> s[3];
};

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
nmg_gemv_kernel(Segs<T, O> segs, const T* __restrict__ b, long long ldk,
                long long ldc, int K, int KN, int M, int gr,
                int transpose_out) {
  const Seg<T, O> seg = segs.s[blockIdx.y];
  const int row0 = blockIdx.x * kRowsPerBlock;
  if (row0 >= seg.R_pad) return;  // uniform across the block
  const int rloc = threadIdx.x / kRowThreads;  // row within the block
  const int rt = threadIdx.x % kRowThreads;    // thread within its row
  const int lane = threadIdx.x & 31;
  const int row = row0 + rloc;
  const int* __restrict__ cols = seg.cols + (size_t)(row0 / gr) * KN;
  const T* __restrict__ vrow = seg.val + (size_t)row * KN;

  __shared__ float sB[kMaxM * kSlabStride];  // sB[c * stride + s]
  __shared__ float sPart[kRowsPerBlock][kWarpsPerRow][kMaxM];

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
          sB[c * kSlabStride + s] =
              col < K ? to_f32(bp[(long long)c * ldc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = rt + j * kRowThreads;
      if (s < tk) {
#pragma unroll
        for (int c = 0; c < kMaxM; ++c)
          if (c < M) acc[c] = fmaf(v[j], sB[c * kSlabStride + s], acc[c]);
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
    if (lane == 0 && c < M) sPart[rloc][warp_in_row][c] = x;
  }
  __syncthreads();
  if (rt < M && row < seg.R) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) x += sPart[rloc][w][rt];
    const size_t o = transpose_out ? (size_t)rt * seg.R + row
                                   : (size_t)row * M + rt;
    seg.out[o] = from_f32<O>(x);
  }
}

template <typename T, typename O>
int launch(int nseg, const void* const* val, const void* const* cols,
           void* const* out, const int* R, const int* R_pad, const void* b,
           long long ldk, long long ldc, int K, int KN, int M, int gr,
           int transpose_out, cudaStream_t stream) {
  Segs<T, O> segs{};
  int max_rows = 0;
  for (int i = 0; i < nseg; ++i) {
    segs.s[i] = Seg<T, O>{static_cast<const T*>(val[i]),
                          static_cast<const int*>(cols[i]),
                          static_cast<O*>(out[i]), R[i], R_pad[i]};
    max_rows = R_pad[i] > max_rows ? R_pad[i] : max_rows;
  }
  dim3 grid((max_rows + kRowsPerBlock - 1) / kRowsPerBlock, nseg);
  nmg_gemv_kernel<T, O><<<grid, kThreads, 0, stream>>>(
      segs, static_cast<const T*>(b), ldk, ldc, K, KN, M, gr, transpose_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (val and B share it); out_f32: 1 when
// the output is float32, 0 when it has the input type.  Up to three
// segments (val_i, cols_i, out_i, R_i, R_pad_i); unused ones pass null/0.
// Returns cudaGetLastError() after the launch (0 = success, -1 = bad args).
extern "C" int nmg_gemv_launch(
    int dtype, int out_f32, int nseg,
    const void* val0, const void* cols0, void* out0, int R0, int R_pad0,
    const void* val1, const void* cols1, void* out1, int R1, int R_pad1,
    const void* val2, const void* cols2, void* out2, int R2, int R_pad2,
    const void* b, long long ldk, long long ldc, int K, int KN, int M, int gr,
    int transpose_out, void* stream) {
  if (nseg < 1 || nseg > 3 || M < 1 || M > kMaxM ||
      gr % kRowsPerBlock != 0)
    return -1;
  const void* val[3] = {val0, val1, val2};
  const void* cols[3] = {cols0, cols1, cols2};
  void* out[3] = {out0, out1, out2};
  const int R[3] = {R0, R1, R2};
  const int R_pad[3] = {R_pad0, R_pad1, R_pad2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(nseg, val, cols, out, R, R_pad, b, ldk, ldc,
                                K, KN, M, gr, transpose_out, s);
  if (dtype == 1 && out_f32)
    return launch<__nv_bfloat16, float>(nseg, val, cols, out, R, R_pad, b,
                                         ldk, ldc, K, KN, M, gr,
                                         transpose_out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(nseg, val, cols, out, R,
                                                 R_pad, b, ldk, ldc, K, KN, M,
                                                 gr, transpose_out, s);
  return -1;
}
