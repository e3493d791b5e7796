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
// Design: the GEMV's bodies (nmg_rows.cuh), with the same plan at the same
// (gr, M, KN, dtype), so each u and v row's f32 sum is bitwise the one the
// GEMV over the packed weight produces.  A block (or, in the `tc` body, a
// cluster of blocks splitting K) owns u rows of one fiber group and their
// v partners at +F (F % gr == 0, so they are rows of the group F / gr
// further on, with their own column plan).  Running the u rows and then
// the v rows would make two passes of latency-bound blocks; in the `tc`
// body the u and v slabs share each ring slot, so the two weight streams
// are in flight together, and the window of B rows the part covers is
// staged once for both (their plans differ, their chunks cover the same
// rows of B).  In `rows` and `general` the u rows run and then
// the v rows.  The epilogue replays the sequential path's roundings in
// registers: u and v are cast to the output type, the activation runs in
// f32 on the rounded u (silu as PyTorch's CUDA kernel computes it,
// x / (1 + expf(-x)), and no fast math), its result is cast, and the
// product of the two rounded values is cast once more.  So for silu the
// launch is bitwise equal to the GEMV followed by PyTorch's silu and
// multiply.

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

template <typename O, int ACT>
__device__ __forceinline__ void gate_store(O* out, int F, int M, int row,
                                           int c, int transpose_out, float u,
                                           float v) {
  const O u_o = from_f32<O>(u);
  const O v_o = from_f32<O>(v);
  const O s = from_f32<O>(activation<ACT>(to_f32(u_o)));
  const size_t o = transpose_out ? (size_t)c * F + row : (size_t)row * M + c;
  out[o] = from_f32<O>(to_f32(s) * to_f32(v_o));
}

// rows / general bodies: four u rows a block (grid = F / 4, F % 4 == 0
// under `rows`; ceil(F / 4) under `general`) and their partners at +F
template <typename T, typename O, int ACT, bool GENERAL>
__global__ void __launch_bounds__(kThreads)
nmg_ffn_kernel(const T* __restrict__ val, const int* __restrict__ cols,
               O* __restrict__ out, int F, const T* __restrict__ b,
               long long ldk, long long ldc, int K, int KN, int M, int gr,
               int transpose_out) {
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row = row0 + threadIdx.x / kRowThreads;
  float u, v;
  if constexpr (GENERAL) {
    __shared__ float part[kRowsPerBlock][kWarpsPerRow][kMaxM];
    // rows past F read as absent (R_pad = F for u, 2F for v)
    u = rows_dot_general(val, cols, row, F, gr, b, ldk, ldc, K, KN, M, part);
    v = rows_dot_general(val, cols, row < F ? row + F : 2 * F, 2 * F, gr, b,
                         ldk, ldc, K, KN, M, part);
  } else {
    __shared__ RowsSmem sm;
    u = rows_dot(val, cols + (size_t)(row0 / gr) * KN, row0, b, ldk, ldc, K,
                 KN, M, sm);
    v = rows_dot(val, cols + (size_t)((row0 + F) / gr) * KN, row0 + F, b,
                 ldk, ldc, K, KN, M, sm);
  }
  const int rt = threadIdx.x % kRowThreads;
  if (rt < M && row < F)
    gate_store<O, ACT>(out, F, M, row, rt, transpose_out, u, v);
}

// tc body: blockIdx.x = u row tile * parts + part (one cluster a tile)
template <int NT8, int RW, typename O, int ACT>
__global__ void __launch_bounds__(RW * 32)
nmg_ffn_tc_kernel(const __nv_bfloat16* __restrict__ val,
                  const int* __restrict__ cols, O* __restrict__ out, int F,
                  const __nv_bfloat16* __restrict__ b, long long ldk,
                  long long ldc, int K, int KN, int M, int gr, int per,
                  int vec, int cs, int cx, int wp, int transpose_out) {
  constexpr int ROWS = 16 * RW;
  const int parts =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int row0 = blockIdx.x / parts * ROWS;
  tc::tc_rows<NT8, RW, 2>(
      val + (size_t)row0 * KN, val + (size_t)(row0 + F) * KN,
      cols + (size_t)(row0 / gr) * KN, cols + (size_t)((row0 + F) / gr) * KN,
      b, ldk, ldc, K, KN, M, per, vec, cs, cx, wp,
      [&](int r, int c, const float* x) {
        gate_store<O, ACT>(out, F, M, row0 + r, c, transpose_out, x[0],
                           x[1]);
      });
}

template <typename T, typename O, int ACT>
int launch_rows(const Plan& p, const T* val, const int* cols, O* out, int F,
                const T* b, long long ldk, long long ldc, int K, int KN,
                int M, int gr, int transpose_out, cudaStream_t stream) {
  const dim3 grid((F + kRowsPerBlock - 1) / kRowsPerBlock);
  if (p.body == kBodyGeneral)
    nmg_ffn_kernel<T, O, ACT, true><<<grid, kThreads, 0, stream>>>(
        val, cols, out, F, b, ldk, ldc, K, KN, M, gr, transpose_out);
  else
    nmg_ffn_kernel<T, O, ACT, false><<<grid, kThreads, 0, stream>>>(
        val, cols, out, F, b, ldk, ldc, K, KN, M, gr, transpose_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NT8, int RW, typename O, int ACT>
int launch_tc(const Plan& p, const __nv_bfloat16* val, const int* cols,
              O* out, int F, const __nv_bfloat16* b, long long ldk,
              long long ldc, int K, int KN, int M, int gr, int vec, int cs,
              int cx, int transpose_out, cudaStream_t stream) {
  auto kernel = nmg_ffn_tc_kernel<NT8, RW, O, ACT>;
  const int wp = tc::b_stageable(b, ldk, ldc)
                     ? tc::window_pitch(p.per, cs, cx) : 0;
  const int smem = tc::smem_bytes(16 * RW, 2, NT8, p.per, p.parts, wp,
                                   M);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(F / (16 * RW) * p.parts);
  if (p.parts == 1) {   // one part: no cluster
    kernel<<<grid, RW * 32, smem, stream>>>(val, cols, out, F, b, ldk, ldc,
                                            K, KN, M, gr, p.per, vec, cs, cx,
                                            wp, transpose_out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(RW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, val, cols, out, F,
                                           b, ldk, ldc, K, KN, M, gr, p.per,
                                           vec, cs, cx, wp, transpose_out);
  return e != cudaSuccess ? static_cast<int>(e)
                          : static_cast<int>(cudaGetLastError());
}

template <typename O, int ACT>
int launch_tc_shape(const Plan& p, const __nv_bfloat16* val, const int* cols,
                    O* out, int F, const __nv_bfloat16* b, long long ldk,
                    long long ldc, int K, int KN, int M, int gr, int vec,
                    int cs, int cx, int transpose_out, cudaStream_t s) {
#define NMG_TC(NT, RWS)                                                      \
  if (p.nt8 == NT && p.rows == 16 * RWS)                                     \
    return launch_tc<NT, RWS, O, ACT>(p, val, cols, out, F, b, ldk, ldc, K, \
                                      KN, M, gr, vec, cs, cx, transpose_out, \
                                      s);
  NMG_TC(1, 1) NMG_TC(1, 2) NMG_TC(1, 4)
  NMG_TC(2, 1) NMG_TC(2, 2) NMG_TC(2, 4)
#undef NMG_TC
  return -1;
}

template <typename T, typename O, int ACT>
int launch(const Plan& p, const void* val, const void* cols, void* out,
           int F, const void* b, long long ldk, long long ldc, int K, int KN,
           int M, int gr, int cs, int cx, int transpose_out,
           cudaStream_t stream) {
  const T* v = static_cast<const T*>(val);
  const int* c = static_cast<const int*>(cols);
  O* o = static_cast<O*>(out);
  const T* bb = static_cast<const T*>(b);
  if constexpr (sizeof(T) == 2) {
    if (p.body == kBodyTc) {
      const void* vals[1] = {val};
      return launch_tc_shape<O, ACT>(p, v, c, o, F, bb, ldk, ldc, K, KN, M,
                                     gr, copy_bytes(vals, 1, KN), cs, cx,
                                     transpose_out, stream);
    }
  }
  return launch_rows<T, O, ACT>(p, v, c, o, F, bb, ldk, ldc, K, KN, M, gr,
                                transpose_out, stream);
}

template <typename T, typename O>
int launch_act(const Plan& p, int act, const void* val, const void* cols,
               void* out, int F, const void* b, long long ldk, long long ldc,
               int K, int KN, int M, int gr, int cs, int cx,
               int transpose_out, cudaStream_t s) {
  if (act == kSilu)
    return launch<T, O, kSilu>(p, val, cols, out, F, b, ldk, ldc, K, KN, M,
                               gr, cs, cx, transpose_out, s);
  return launch<T, O, kGeluTanh>(p, val, cols, out, F, b, ldk, ldc, K, KN,
                                 M, gr, cs, cx, transpose_out, s);
}

}  // namespace

// body, rows, nt8, per, parts: the decode bodies' plan (nmg_gemv.cu);
// dtype: 0 = float32, 1 = bfloat16 (val and B share it); out_f32: 1 when
// the output is float32, 0 when it has the input type; act: 0 = silu,
// 1 = gelu (tanh approximation).  val [2F, KN] and cols [2F / gr, KN] are
// one layer's packed weight with no padded rows; F % gr == 0; cs and cx
// are the format's chunk geometry (nmg_gemv.cu).  Returns
// cudaGetLastError() after the launch (0 = success, -1 = bad arguments).
extern "C" int nmg_ffn_launch(int body, int rows, int nt8, int per,
                              int parts, int dtype, int out_f32, int act,
                              const void* val, const void* cols, void* out,
                              int F, const void* b, long long ldk,
                              long long ldc, int K, int KN, int M, int gr,
                              int cs, int cx, int transpose_out,
                              void* stream) {
  const Plan p{body, rows, nt8, per, parts};
  if (M < 1 || M > kMaxM || gr <= 0 || F <= 0 || F % gr != 0 || KN < 1 ||
      cs < 1 || cx < 1 ||
      (act != kSilu && act != kGeluTanh) ||
      check_plan(p, dtype, KN, M, gr) != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_act<float, float>(p, act, val, cols, out, F, b, ldk, ldc,
                                    K, KN, M, gr, cs, cx, transpose_out, s);
  if (dtype == 1 && out_f32)
    return launch_act<__nv_bfloat16, float>(p, act, val, cols, out, F, b,
                                            ldk, ldc, K, KN, M, gr, cs, cx,
                                            transpose_out, s);
  if (dtype == 1)
    return launch_act<__nv_bfloat16, __nv_bfloat16>(p, act, val, cols, out,
                                                    F, b, ldk, ldc, K, KN, M,
                                                    gr, cs, cx, transpose_out,
                                                    s);
  return -1;
}
