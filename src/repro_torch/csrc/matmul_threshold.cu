// Dense matmul with a fused scalar-threshold epilogue, for Hopper
// (sm_90a): y = A[M, K] @ B[K, N] accumulated in f32, then
//   mask = |y| >= t,   val = y * mask,
// both written in one pass; the unmasked y never reaches device memory.
//
// Replaces the Pallas body repro/kernels/fused_sparse_matmul.py:_kernel
// (launched by matmul_threshold_pallas), the paper's inline streaming
// sparsifier (§3.3).  The TPU kernel carries the f32 accumulator across
// its sequential K grid axis in the output block and thresholds it on the
// last K step; here a block owns its whole output tile, loops over K
// itself, and thresholds the registers after the last K slab.  val is
// `y * (mask ? 1 : 0)` in f32, so a masked negative y gives -0.0, as the
// reference's `y * mask` does.
//
// What bounds it on the H100: at the training path's shape (M = 1024
// tokens, K = 768, N = 3072, bf16) the card's floor is bytes (22 MB of
// operands and outputs, 6.6 us) just above operations (4.8 GFLOP, 4.9 us
// at the bf16 tensor-core rate).  This kernel runs its multiply-adds on
// the CUDA cores in f32, whose rate (67 TFLOP/s) puts its own floor near
// 72 us: it is right and simple first; a wgmma/TMA pipeline is later
// work.
//
// Design: grid (ceil(N / 128), ceil(M / 128)); 256 threads, each holding
// an 8 x 8 register tile of f32 accumulators (two 4 x 4 quadrants 64
// apart, so shared-memory reads are float4 and conflict-free).  Per K
// slab of 16 the block stages A^T [16, 128] and B [16, 128] into shared
// memory as f32 (exact for bf16; A^T rows padded against bank
// conflicts); the next slab's global loads are issued
// into registers before the current slab's multiply-adds.  Every output
// accumulates over k in ascending order in one fmaf chain, so results are
// deterministic.  Operands are read through strides (no copies); edges
// are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output rows per block
constexpr int kBN = 128;     // output columns per block
constexpr int kBK = 16;      // K values per slab
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kBK / kThreads;  // elements of A (and of B)
                                              // a thread stages per slab: 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void load_slab(
    const T* __restrict__ a, const T* __restrict__ b, long long lda_m,
    long long lda_k, long long ldb_k, long long ldb_n, int m0, int n0,
    int k0, int M, int N, int K, float (&ra)[kLoads], float (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kBK, s = e % kBK;   // A: consecutive threads along k
    const int gm = m0 + r, gk = k0 + s;
    ra[i] = (gm < M && gk < K) ? to_f32(a[gm * lda_m + gk * lda_k]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / kBN, c = e % kBN;   // B: consecutive threads along n
    const int gk = k0 + s, gn = n0 + c;
    rb[i] = (gk < K && gn < N) ? to_f32(b[gk * ldb_k + gn * ldb_n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_threshold_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        long long lda_m, long long lda_k, long long ldb_k,
                        long long ldb_n, float* __restrict__ val,
                        uint8_t* __restrict__ mask, int M, int N, int K,
                        float threshold) {
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // A^T slab, rows padded by 4 floats: the transposing stores hit 16
  // banks instead of 2, and rows stay 16-byte aligned for float4 reads
  __shared__ __align__(16) float sA[kBK][kBM + 4];
  __shared__ __align__(16) float sB[kBK][kBN];
  const int tx = threadIdx.x & 15;   // columns tx*4 + {0..3}, +64
  const int ty = threadIdx.x >> 4;   // rows    ty*4 + {0..3}, +64

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[kLoads], rb[kLoads];
  load_slab(a, b, lda_m, lda_k, ldb_k, ldb_n, m0, n0, 0, M, N, K, ra, rb);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      sA[e % kBK][e / kBK] = ra[i];
      sB[e / kBN][e % kBN] = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < K)  // next slab in flight during this one's FMAs
      load_slab(a, b, lda_m, lda_k, ldb_k, ldb_n, m0, n0, k0 + kBK, M, N, K,
                ra, rb);
#pragma unroll
    for (int s = 0; s < kBK; ++s) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[s][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sA[s][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[s][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sB[s][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: threshold in registers, write the masked values and mask
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= N) continue;
      const float y = acc[i][j];
      const bool keep = fabsf(y) >= threshold;
      val[(size_t)r * N + c] = y * (keep ? 1.f : 0.f);
      mask[(size_t)r * N + c] = keep;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A and B share it).  A is read as
// a[m * lda_m + k * lda_k], B as b[k * ldb_k + n * ldb_n].  val is f32
// [M, N] and mask uint8 [M, N] (read as bool), both row-major.  Returns
// cudaGetLastError() after the launch (0 = success, -1 = bad arguments).
extern "C" int matmul_threshold_launch(int dtype, const void* a,
                                       const void* b, long long lda_m,
                                       long long lda_k, long long ldb_k,
                                       long long ldb_n, void* val,
                                       void* mask, int M, int N, int K,
                                       float threshold, void* stream) {
  if (M < 0 || N < 0 || K < 0) return -1;
  if (M == 0 || N == 0) return 0;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(val);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  if (dtype == 0)
    matmul_threshold_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), lda_m,
        lda_k, ldb_k, ldb_n, v, mk, M, N, K, threshold);
  else if (dtype == 1)
    matmul_threshold_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), lda_m, lda_k, ldb_k, ldb_n, v,
        mk, M, N, K, threshold);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
