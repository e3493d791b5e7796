// n:m:g fused gated FFN for Hopper (sm_90a), decode-shaped: the packed
// gated-MLP weight A_canonical[2F, K] (rows < F: u, rows >= F: the gate v)
// against B[K, M], M <= 16, written as out = act(u) * v, [F, M] or,
// transposed, [M, F].
//
// Replaces the Pallas body repro/kernels/nmg_fused.py:_ffn_kernel
// (launched by nmg_ffn_pallas).  On the decode path one launch replaces
// the GEMV over the packed weight plus the separate activation and
// multiply launches.
//
// What bounds it on the H100: device-memory bytes, as for the GEMV: every
// stored value is used for at most 16 multiply-adds.  For qwen1.5-4b at
// 1:4:8 gr64 in bf16 one call reads 17.7 MB of `val` and 0.55 MB of
// `plan.cols`: 5.47 us at 3.35 TB/s for M = 4.
//
// Design: a block owns four u rows of one fiber group and their four v
// partners at +F (F % gr == 0, so they are four rows of the group F / gr
// further on, with their own column plan).  It runs nmg_rows.cuh's
// `rows_dot` on the u rows and then on the v rows, so each row's f32 sum
// is bitwise the one the GEMV would produce.  The epilogue replays the
// sequential path's roundings in registers: u and v are cast to the
// output type, the activation runs in f32 on the rounded u (silu as
// PyTorch's CUDA kernel computes it, x / (1 + expf(-x)), and no fast
// math), its result is cast, and the product of the two rounded values is
// cast once more.  So for silu the launch is bitwise equal to the GEMV
// followed by PyTorch's silu and multiply.  The TPU kernel shares one
// gathered B slab between u and v; here the two groups' plans differ, so
// each gathers its own (the decode B, K x M bf16, stays in L2).
// Still simple: no cp.async/TMA pipelining across slabs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nmg_rows.cuh"

namespace {

using namespace nmg;

constexpr int kSilu = 0;
constexpr int kGeluTanh = 1;

template <int ACT>
__device__ __forceinline__ float activation(float x);

// PyTorch's CUDA silu in its opmath type
template <>
__device__ __forceinline__ float activation<kSilu>(float x) {
  return x / (1.0f + expf(-x));
}

// PyTorch's CUDA gelu, approximate="tanh"
template <>
__device__ __forceinline__ float activation<kGeluTanh>(float x) {
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

template <typename T, typename O, int ACT>
__global__ void __launch_bounds__(kThreads)
nmg_ffn_kernel(const T* __restrict__ val, const int* __restrict__ cols,
               O* __restrict__ out, int F, const T* __restrict__ b,
               long long ldk, long long ldc, int K, int KN, int M, int gr,
               int transpose_out) {
  const int row0 = blockIdx.x * kRowsPerBlock;  // u rows; grid = F / 4
  __shared__ RowsSmem sm;
  const float u = rows_dot(val, cols + (size_t)(row0 / gr) * KN, row0, b,
                           ldk, ldc, K, KN, M, sm);
  const float v = rows_dot(val, cols + (size_t)((row0 + F) / gr) * KN,
                           row0 + F, b, ldk, ldc, K, KN, M, sm);
  const int rt = threadIdx.x % kRowThreads;
  const int row = row0 + threadIdx.x / kRowThreads;
  if (rt < M) {
    const O u_o = from_f32<O>(u);
    const O v_o = from_f32<O>(v);
    const O s = from_f32<O>(activation<ACT>(to_f32(u_o)));
    const size_t o = transpose_out ? (size_t)rt * F + row
                                   : (size_t)row * M + rt;
    out[o] = from_f32<O>(to_f32(s) * to_f32(v_o));
  }
}

template <typename T, typename O>
int launch(int act, const void* val, const void* cols, void* out, int F,
           const void* b, long long ldk, long long ldc, int K, int KN, int M,
           int gr, int transpose_out, cudaStream_t stream) {
  const dim3 grid(F / kRowsPerBlock);
  const T* v = static_cast<const T*>(val);
  const int* c = static_cast<const int*>(cols);
  O* o = static_cast<O*>(out);
  const T* bb = static_cast<const T*>(b);
  if (act == kSilu)
    nmg_ffn_kernel<T, O, kSilu><<<grid, kThreads, 0, stream>>>(
        v, c, o, F, bb, ldk, ldc, K, KN, M, gr, transpose_out);
  else
    nmg_ffn_kernel<T, O, kGeluTanh><<<grid, kThreads, 0, stream>>>(
        v, c, o, F, bb, ldk, ldc, K, KN, M, gr, transpose_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (val and B share it); out_f32: 1 when
// the output is float32, 0 when it has the input type; act: 0 = silu,
// 1 = gelu (tanh approximation).  val [2F, KN] and cols [2F / gr, KN] are
// one layer's packed weight with no padded rows; F % gr == 0, gr % 4 == 0.
// Returns cudaGetLastError() after the launch (0 = success, -1 = bad args).
extern "C" int nmg_ffn_launch(int dtype, int out_f32, int act,
                              const void* val, const void* cols, void* out,
                              int F, const void* b, long long ldk,
                              long long ldc, int K, int KN, int M, int gr,
                              int transpose_out, void* stream) {
  if (M < 1 || M > kMaxM || gr <= 0 || gr % kRowsPerBlock != 0 || F <= 0 ||
      F % gr != 0 || (act != kSilu && act != kGeluTanh))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(act, val, cols, out, F, b, ldk, ldc, K, KN,
                                M, gr, transpose_out, s);
  if (dtype == 1 && out_f32)
    return launch<__nv_bfloat16, float>(act, val, cols, out, F, b, ldk, ldc,
                                        K, KN, M, gr, transpose_out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(act, val, cols, out, F, b,
                                                ldk, ldc, K, KN, M, gr,
                                                transpose_out, s);
  return -1;
}
