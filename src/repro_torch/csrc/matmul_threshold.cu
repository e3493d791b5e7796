// Dense matmul with a fused scalar-threshold epilogue, for Hopper
// (sm_90a): y = A[M, K] @ B[K, N] accumulated in f32, then
//   mask = |y| >= t,   val = y * mask,
// both written in one pass; the unmasked y never reaches device memory.
//
// Replaces the Pallas body repro/kernels/fused_sparse_matmul.py:_kernel
// (launched by matmul_threshold_pallas), the paper's inline streaming
// sparsifier (§3.3).  The TPU kernel feeds bf16 tiles to the MXU with f32
// accumulation, carries the accumulator across its sequential K grid axis
// in the output block and thresholds it on the last K step; here a block
// owns its whole output tile, loops over K itself, and thresholds the
// registers after the last K slab.  val is `y * (mask ? 1 : 0)` in f32, so
// a masked negative y gives -0.0, as the reference's `y * mask` does.
//
// What bounds it on the H100: at the training path's shape (M = 1024
// tokens, K = 768, N = 3072, bf16) the card's floor is bytes (22 MB of
// operands and outputs, 6.6 us) just above operations (4.8 GFLOP, 4.9 us
// at the bf16 tensor-core rate); the f32 val and the mask are 72% of the
// bytes.
//
// bf16 body (dtype 1), the training path's: the product runs on the
// tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by
// ldmatrix from a 4-stage ring of shared-memory slabs that cp.async fills
// in 16-byte copies (mma_tile.cuh).  mma.sync and not wgmma/TMA: at this
// shape the kernel is bound by bytes, so the warp-level product with a
// deep copy ring suffices, and it needs no tensor maps or mbarriers.
// Block tile 128 x 192 (1024 x 3072 makes 8 x 16 = 128 blocks, one wave
// on 132 SMs, where 128 x 128 made 1.45 waves), 8 warps of 64 x 48, K
// slabs of 32.  A is read K-major and B N-major (ldmatrix.trans) straight
// from the row-major operands; shared rows are padded by 16 bytes so
// ldmatrix is free of bank conflicts.  The epilogue thresholds the
// accumulators in registers, stages val and the mask bytes through shared
// memory and writes them coalesced, val as 16-byte float4 stores and the
// mask in 16-byte chunks.  Operand rows must be 16-byte aligned (row
// stride a multiple of 8 elements, unit column stride); the wrapper hands
// any other operand over as a padded copy.  Ragged M, N and K edges read
// as zeros (cp.async's source size) and are not written.  Every output's
// summation order is fixed by the shape, so two launches agree bitwise.
//
// f32 body (dtype 0): CUDA-core FMAs, because a tensor-core f32 product
// would be TF32, another function.  Grid
// (ceil(N / 128), ceil(M / 128)); 256 threads, each holding an 8 x 8
// register tile of f32 accumulators; per K slab of 16 the block stages
// A^T and B into shared memory as f32, the next slab's global loads
// issued into registers before the current slab's multiply-adds; every
// output accumulates over k in ascending order in one fmaf chain.
// Operands are read through strides (no copies); edges are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int kBM = 128;     // output rows per block
constexpr int kBN = 128;     // output columns per block
constexpr int kBK = 16;      // K values per slab
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kBK / kThreads;  // elements of A (and of B)
                                              // a thread stages per slab: 8

__device__ __forceinline__ float to_f32(float x) { return x; }

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


// ---------------------------------------------------------------------------
// bf16 body: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int tBM = 128;     // output rows per block
constexpr int tBN = 192;     // output columns per block
constexpr int tBK = 32;      // K values per slab
constexpr int tStages = 4;   // slabs in the ring
constexpr int tThreads = 256;
constexpr int tPA = tBK + 8;   // A row pitch (elements): 80 bytes
constexpr int tPB = tBN + 8;   // B row pitch: 400 bytes
constexpr int tPV = tBN + 4;   // staged val row pitch (floats)
constexpr int tStageElems = tBM * tPA + tBK * tPB;
constexpr int tRingBytes = tStages * tStageElems * 2;
constexpr int tEpiBytes = tBM * tPV * 4 + tBM * tBN;
constexpr int tSmemBytes = tRingBytes > tEpiBytes ? tRingBytes : tEpiBytes;

__device__ __forceinline__ int clamp16(long long bytes) {
  return bytes <= 0 ? 0 : (bytes >= 16 ? 16 : static_cast<int>(bytes));
}

// one K slab of A [128, 32] and B [32, 192] into a ring slot
__device__ __forceinline__ void load_tc_slab(
    __nv_bfloat16* sa, __nv_bfloat16* sb, const __nv_bfloat16* __restrict__ a,
    const __nv_bfloat16* __restrict__ b, long long lda, long long ldb, int m0,
    int n0, int k0, int M, int N, int K) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < tBM * tBK / 8 / tThreads; ++i) {    // 2 chunks
    const int c = tid + i * tThreads;
    const int r = c >> 2, ch = c & 3;
    const int gm = m0 + r, gk = k0 + ch * 8;
    const int bytes = gm < M ? clamp16(2LL * (K - gk)) : 0;
    mma_tile::cp_async_16(sa + r * tPA + ch * 8,
                          bytes ? a + gm * lda + gk : a, bytes);
  }
#pragma unroll
  for (int i = 0; i < tBK * tBN / 8 / tThreads; ++i) {    // 3 chunks
    const int c = tid + i * tThreads;
    const int r = c / (tBN / 8), ch = c % (tBN / 8);
    const int gk = k0 + r, gn = n0 + ch * 8;
    const int bytes = gk < K ? clamp16(2LL * (N - gn)) : 0;
    mma_tile::cp_async_16(sb + r * tPB + ch * 8,
                          bytes ? b + gk * ldb + gn : b, bytes);
  }
}

__global__ void __launch_bounds__(tThreads, 1)
matmul_threshold_tc_kernel(const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ b,
                           long long lda, long long ldb,
                           float* __restrict__ val,
                           uint8_t* __restrict__ mask, int M, int N, int K,
                           float threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int m0 = blockIdx.y * tBM, n0 = blockIdx.x * tBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;   // warp tile: rows wm.., 64 of them
  const int wn = (warp & 3) * 48;    //            cols wn.., 48 of them
  const int nk = (K + tBK - 1) / tBK;

  float acc[4][6][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < tStages - 1; ++s) {
    if (s < nk) {
      __nv_bfloat16* st = ring + s * tStageElems;
      load_tc_slab(st, st + tBM * tPA, a, b, lda, ldb, m0, n0, s * tBK, M, N,
                   K);
    }
    mma_tile::cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    mma_tile::cp_async_wait<tStages - 2>();   // slab kt has landed
    __syncthreads();                          // ... for every thread, and
                                              // slab kt-1's slot is free
    const int nxt = kt + tStages - 1;
    if (nxt < nk) {
      __nv_bfloat16* st = ring + (nxt % tStages) * tStageElems;
      load_tc_slab(st, st + tBM * tPA, a, b, lda, ldb, m0, n0, nxt * tBK, M,
                   N, K);
    }
    mma_tile::cp_async_commit();
    const __nv_bfloat16* sa = ring + (kt % tStages) * tStageElems;
    const __nv_bfloat16* sb = sa + tBM * tPA;
#pragma unroll
    for (int kk = 0; kk < tBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_tile::ldmatrix_x4(
            af[i], sa + (wm + i * 16 + (lane & 15)) * tPA + kk
                       + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 3; ++jp) {
        uint32_t bf[4];
        mma_tile::ldmatrix_x4_trans(
            bf, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * tPB + wn
                    + jp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_tile::mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_tile::mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  mma_tile::cp_async_wait<0>();
  __syncthreads();   // the ring's memory becomes the epilogue's

  // threshold in registers; stage val (f32) and the mask bytes
  float* sv = reinterpret_cast<float*>(smem);
  uint8_t* sm = smem + tBM * tPV * 4;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + i * 16 + g + 8 * h, c = wn + j * 8 + 2 * q;
        const float y0 = acc[i][j][2 * h], y1 = acc[i][j][2 * h + 1];
        const bool k0 = fabsf(y0) >= threshold, k1 = fabsf(y1) >= threshold;
        *reinterpret_cast<float2*>(sv + r * tPV + c) =
            make_float2(y0 * (k0 ? 1.f : 0.f), y1 * (k1 ? 1.f : 0.f));
        *reinterpret_cast<uint16_t*>(sm + r * tBN + c) =
            static_cast<uint16_t>(k0) | (static_cast<uint16_t>(k1) << 8);
      }
  __syncthreads();

  // coalesced stores: val as float4, the mask as 16-byte chunks, element
  // by element where a row's alignment or the ragged edge forbids
  const bool v4 = (N & 3) == 0, m16 = (N & 15) == 0;
  for (int idx = threadIdx.x; idx < tBM * tBN / 4; idx += tThreads) {
    const int r = idx / (tBN / 4), c = (idx % (tBN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float* dst = val + (size_t)gm * N + gn;
    const float* src = sv + r * tPV + c;
    if (v4 && gn + 4 <= N)
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(src);
    else
      for (int e = 0; e < 4 && gn + e < N; ++e) dst[e] = src[e];
  }
  for (int idx = threadIdx.x; idx < tBM * tBN / 16; idx += tThreads) {
    const int r = idx / (tBN / 16), c = (idx % (tBN / 16)) * 16;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    uint8_t* dst = mask + (size_t)gm * N + gn;
    const uint8_t* src = sm + r * tBN + c;
    if (m16 && gn + 16 <= N)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      for (int e = 0; e < 16 && gn + e < N; ++e) dst[e] = src[e];
  }
}

}  // namespace

// The bf16 body's dynamic shared memory per block, for reports.
extern "C" int matmul_threshold_tc_smem_bytes() { return tSmemBytes; }

// dtype: 0 = float32, 1 = bfloat16 (A and B share it).  A is read as
// a[m * lda_m + k * lda_k], B as b[k * ldb_k + n * ldb_n]; the bf16 body
// takes only lda_k == ldb_n == 1 with lda_m, ldb_k multiples of 8 and
// 16-byte aligned bases.  val is f32 [M, N] and mask uint8 [M, N] (read
// as bool), both row-major.  Returns cudaGetLastError() after the launch
// (0 = success, -1 = bad arguments).
extern "C" int matmul_threshold_launch(int dtype, const void* a,
                                       const void* b, long long lda_m,
                                       long long lda_k, long long ldb_k,
                                       long long ldb_n, void* val,
                                       void* mask, int M, int N, int K,
                                       float threshold, void* stream) {
  if (M < 0 || N < 0 || K < 0) return -1;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(val);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  if (dtype == 0) {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    if (grid.y > 65535) return -1;
    matmul_threshold_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), lda_m,
        lda_k, ldb_k, ldb_n, v, mk, M, N, K, threshold);
  } else if (dtype == 1) {
    if (lda_k != 1 || ldb_n != 1 || lda_m % 8 || ldb_k % 8 ||
        reinterpret_cast<uintptr_t>(a) % 16 ||
        reinterpret_cast<uintptr_t>(b) % 16)
      return -1;
    dim3 grid((N + tBN - 1) / tBN, (M + tBM - 1) / tBM);
    if (grid.y > 65535) return -1;
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          matmul_threshold_tc_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, tSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = true;
    }
    matmul_threshold_tc_kernel<<<grid, tThreads, tSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), lda_m, ldb_k, v, mk, M, N, K,
        threshold);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
