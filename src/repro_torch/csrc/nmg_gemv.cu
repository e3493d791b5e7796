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
// row splitting its K range; the row loop and its fixed reduction are
// nmg_rows.cuh's `rows_dot`, shared with the fused FFN kernel.  The fused
// QKV launch (blockIdx.y picks the segment, no concatenated copy of the
// weights) is bitwise equal to three single launches, since a row's
// summation order depends on the row alone.
// Still simple: no cp.async/TMA pipelining across slabs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nmg_rows.cuh"

namespace {

using namespace nmg;

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
  __shared__ RowsSmem sm;
  const float x = rows_dot(seg.val, seg.cols + (size_t)(row0 / gr) * KN,
                           row0, b, ldk, ldc, K, KN, M, sm);
  const int rt = threadIdx.x % kRowThreads;
  const int row = row0 + threadIdx.x / kRowThreads;
  if (rt < M && row < seg.R) {
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
