// n:m:g prefill SpMM for Hopper (sm_90a): C[R, N] = A_canonical[R, K] @
// B[K, N] in f32, for right operands wider than the decode GEMV takes.
//
// Replaces the Pallas bodies repro/kernels/nmg_spmm.py:_stream_kernel
// (stream=True, the default) and :_kernel (stream=False).  The two differ
// only in how the TPU moves `val` through VMEM (double-buffered DMA versus
// the pipelined grid); they compute the same function with the same
// per-output accumulation order, and so does this kernel.  The schedule
// split has no Hopper counterpart: one kernel replaces both.
//
// What bounds it on the H100: at this slice's prefill widths (N = 17..128
// prompt tokens) each stored value feeds N multiply-adds and B is small, so
// the product is still bytes-bound on `val` (about N flops per byte of bf16
// weights, well under the ~295 flops/byte tensor-core line until N reaches
// the hundreds).  The gathered B rows are the other traffic: each 64-row
// output tile gathers its fiber group's rows once per K slab.
//
// Design: grid (R_pad / 64, ceil(N / 64), splits); a 64 x 64 output tile
// lies in one fiber group (gr % 64 == 0), so the whole tile shares one
// `cols` plan (precomputed, never re-derived from blk_idx).  Per K slab of
// 32 stored values the block stages the `val` tile [64, 32] and the
// gathered B tile [32, 64] into shared memory as f32; each of 256 threads
// keeps a 4 x 4 register tile of f32 accumulators.  The next slab's loads
// are issued into registers before the current slab's FMAs, so memory
// latency overlaps compute (the TPU kernel's double buffer, in registers).
// When the output tiles alone cannot fill the card (a long K, few rows or
// columns), the K range is split across `splits` blocks that write f32
// partials to a workspace, and a second kernel sums them in split order.
// Every output's summation order is fixed by the shape, so results are
// deterministic.  Padded K rows read as zero (no padded copy of B), B is
// read through strides (x.T needs no copy).  Still simple: CUDA-core FMAs,
// no wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;      // output rows per block
constexpr int kTN = 64;      // output columns per block
constexpr int kTK = 32;      // stored K values per slab
constexpr int kThreads = 256;
constexpr int kLoads = kTM * kTK / kThreads;  // A (and B) elements a thread
                                              // stages per slab: 8
constexpr int kSMs = 132;    // H100 SXM streaming multiprocessors

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

int splits_for(int R_pad, int N, int KN) {
  const int tiles = (R_pad / kTM) * ((N + kTN - 1) / kTN);
  const int nslab = (KN + kTK - 1) / kTK;
  int s = (2 * kSMs + tiles - 1) / tiles;  // about two blocks per SM
  if (s > nslab / 2) s = nslab / 2;        // at least two slabs per split
  return s < 1 ? 1 : s;
}

template <typename T>
__device__ __forceinline__ void load_slab(
    const T* __restrict__ val, const int* __restrict__ gcols,
    const T* __restrict__ b, long long ldk, long long ldc, int row0, int n0,
    int k0, int k_end, int K, int KN, int N, float (&a)[kLoads],
    float (&bb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kTK, s = e % kTK;
    a[i] = k0 + s < k_end ? to_f32(val[(size_t)(row0 + r) * KN + k0 + s])
                          : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / kTN, c = e % kTN;
    float x = 0.f;
    if (k0 + s < k_end && n0 + c < N) {
      const int col = gcols[k0 + s];
      if (col < K)
        x = to_f32(b[(long long)col * ldk + (long long)(n0 + c) * ldc]);
    }
    bb[i] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nmg_spmm_kernel(const T* __restrict__ val, const int* __restrict__ cols,
                const T* __restrict__ b, long long ldk, long long ldc,
                float* __restrict__ out, int R, int K, int KN, int N, int gr,
                int slabs_per_split) {
  const int row0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int k_begin = blockIdx.z * slabs_per_split * kTK;
  const int k_end = min(KN, k_begin + slabs_per_split * kTK);
  const int* __restrict__ gcols = cols + (size_t)(row0 / gr) * KN;
  __shared__ float sA[kTM][kTK + 1];
  __shared__ float sB[kTK][kTN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float a[kLoads], bb[kLoads];
  if (k_begin < k_end)
    load_slab(val, gcols, b, ldk, ldc, row0, n0, k_begin, k_end, K, KN, N,
              a, bb);
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      sA[e / kTK][e % kTK] = a[i];
      sB[e / kTN][e % kTN] = bb[i];
    }
    __syncthreads();
    if (k0 + kTK < k_end)  // next slab in flight during this one's FMAs
      load_slab(val, gcols, b, ldk, ldc, row0, n0, k0 + kTK, k_end, K, KN,
                N, a, bb);
    const int tk = min(kTK, k_end - k0);
#pragma unroll 8
    for (int s = 0; s < tk; ++s) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[ty + 16 * i][s];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[s][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* __restrict__ dst = out + (size_t)blockIdx.z * R * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) dst[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// out[i] = sum over splits of ws[split][i], in split order
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, long long n,
                                  int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = ws[i];
  for (int z = 1; z < splits; ++z) x += ws[(long long)z * n + i];
  out[i] = x;
}

}  // namespace

// The number of K splits the launch below uses for this shape; the
// caller sizes the workspace [splits, R, N] f32 from it (none when 1).
extern "C" int nmg_spmm_splits(int R_pad, int N, int KN) {
  return splits_for(R_pad, N, KN);
}

// dtype: 0 = float32, 1 = bfloat16 (val and B share it).  out is f32
// [R, N], row-major; ws is the f32 workspace of [splits, R, N] when
// nmg_spmm_splits() > 1, else unused.  Returns cudaGetLastError() after
// the launches (0 = success, -1 = bad arguments).
extern "C" int nmg_spmm_launch(int dtype, const void* val, const void* cols,
                               const void* b, long long ldk, long long ldc,
                               void* out, void* ws, int R, int R_pad, int K,
                               int KN, int N, int gr, void* stream) {
  if (gr % kTM != 0 || R_pad % kTM != 0 || N < 1 || KN < 1) return -1;
  const int splits = splits_for(R_pad, N, KN);
  if (splits > 1 && ws == nullptr) return -1;
  const int nslab = (KN + kTK - 1) / kTK;
  const int per = (nslab + splits - 1) / splits;
  dim3 grid(R_pad / kTM, (N + kTN - 1) / kTN, splits);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    nmg_spmm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(val), static_cast<const int*>(cols),
        static_cast<const float*>(b), ldk, ldc, dst, R, K, KN, N, gr, per);
  else if (dtype == 1)
    nmg_spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(val), static_cast<const int*>(cols),
        static_cast<const __nv_bfloat16*>(b), ldk, ldc, dst, R, K, KN, N, gr,
        per);
  else
    return -1;
  if (splits > 1) {
    const long long n = (long long)R * N;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
