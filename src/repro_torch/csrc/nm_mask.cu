// Per-m-block top-n keep mask along the last axis, for Hopper (sm_90a):
// mask[r, k] = 1 iff x[r, k] is among the n largest |x| of its m-block.
//
// Replaces the Pallas body repro/kernels/nm_mask.py:_kernel (launched by
// nm_mask_pallas).  Same rank rule, so the same bits:
//   keep i  iff  #{j : |x_j| > |x_i|  or  (|x_j| == |x_i| and j < i)} < n,
// which is jax.lax.top_k's lowest-index tie-break.  A ragged last block
// (K % m != 0) reads its missing entries as 0 at the higher indices, as
// the reference's zero padding does; they can win slots but are never
// written.
//
// What bounds it on the H100: bytes.  Each element is read once (2 or 4
// bytes) and one byte of mask is written; the rank network costs m
// compares per element (m <= 16), far below the card's integer and float
// rate.  At the training path's shapes ([L * D, F] stacked weights, tens
// of MB) the floor is HBM bandwidth.
//
// Design: one thread per (row, m-block).  For m <= 16 it loads the
// block's m values into registers as f32 (exact for bf16), computes the
// O(m^2) rank and writes m bytes.  For wider blocks (any m, as the
// reference takes) the register array gives way to a loop over the block
// that reads each comparand from memory (L1 serves the repeats); the same
// rule, so the same bits.  Neighbouring threads own neighbouring blocks,
// so a warp's loads cover 32 * m contiguous elements of a row.  Still
// simple: no vector loads or shared-memory staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_mask_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
               long long R, int K, int nb, int n, int m) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= R * nb) return;
  const long long r = t / nb;
  const int k0 = (int)(t % nb) * m;
  const T* __restrict__ row = x + r * K;
  float a[kMaxM];
#pragma unroll
  for (int i = 0; i < kMaxM; ++i)
    a[i] = (i < m && k0 + i < K) ? fabsf(to_f32(row[k0 + i])) : 0.f;
  uint8_t* __restrict__ dst = out + r * K;
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) {
    if (i >= m || k0 + i >= K) break;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j >= m) break;
      rank += (a[j] > a[i]) || (a[j] == a[i] && j < i);
    }
    dst[k0 + i] = rank < n;
  }
}

// m > kMaxM: the rank of each element by a loop over its block, the
// values re-read from memory
template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_mask_wide_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                    long long R, int K, int nb, int n, int m) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= R * nb) return;
  const long long r = t / nb;
  const int k0 = (int)(t % nb) * m;
  const T* __restrict__ row = x + r * K;
  uint8_t* __restrict__ dst = out + r * K;
  const int end = min(m, K - k0);     // past it the block reads zeros
  for (int i = 0; i < end; ++i) {
    const float ai = fabsf(to_f32(row[k0 + i]));
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const float aj = j < end ? fabsf(to_f32(row[k0 + j])) : 0.f;
      rank += (aj > ai) || (aj == ai && j < i);
    }
    dst[k0 + i] = rank < n;
  }
}

template <typename T>
void launch(const T* x, uint8_t* o, long long R, int K, int nb, int n, int m,
            unsigned grid, cudaStream_t s) {
  if (m <= kMaxM)
    nm_mask_kernel<T><<<grid, kThreads, 0, s>>>(x, o, R, K, nb, n, m);
  else
    nm_mask_wide_kernel<T><<<grid, kThreads, 0, s>>>(x, o, R, K, nb, n, m);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is [R, K] row-major, out is uint8
// [R, K] (read as bool).  Returns cudaGetLastError() after the launch
// (0 = success, -1 = bad arguments).
extern "C" int nm_mask_launch(int dtype, const void* x, void* out,
                              long long R, int K, int n, int m,
                              void* stream) {
  if (m < 1 || n < 0 || n > m || R < 0 || K < 0) return -1;
  const int nb = (K + m - 1) / m;
  const long long total = R * nb;
  if (total == 0) return 0;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (dtype == 0)
    launch(static_cast<const float*>(x), o, R, K, nb, n, m, (unsigned)grid,
           s);
  else if (dtype == 1)
    launch(static_cast<const __nv_bfloat16*>(x), o, R, K, nb, n, m,
           (unsigned)grid, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
