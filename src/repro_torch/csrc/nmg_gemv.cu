// n:m:g decode GEMV for Hopper (sm_90a): C = A_canonical[R, K] @ B[K, M],
// M <= 16, f32 accumulation, one cast to the output type in the epilogue.
//
// Replaces the Pallas body repro/kernels/nmg_gemv.py:_kernel (launched by
// gemv_pallas_call) and, over up to three segments in one launch, the fused
// QKV launch repro/kernels/nmg_fused.py:nmg_qkv_pallas.  Over 16-column
// chunks of a wider B (blockIdx.z) it is also the SpMM's route for weights
// whose gr is not a multiple of the SpMM's 64-row tile.
//
// What bounds it on the H100: device-memory bytes.  At decode M is the slot
// count (<= 16), so every stored value is used for at most 16 multiply-adds
// while the compressed weights are read once per step: about 2 flops per
// byte of bf16 `val`, far below the ~295 flops/byte where the tensor cores
// would become the limit.  At qwen1.5-4b's `mlp.wo` (1:4:8 gr64) one call
// reads 8.8 MB of `val` and 0.28 MB of `plan.cols`: 2.7 us at 3.35 TB/s.
// At bert-base-sten's widths (1.2 MB) the bound is latency: a launch, the
// plan's and B's dependent loads, and one pass of `val`.
//
// Design (nmg_rows.cuh has the three bodies; the wrapper picks one from
// (gr, M, KN, dtype) and passes its plan):
//   - bf16 at gr a multiple of 16, the serving format: the `tc` body.  A
//     block of a few rows would repeat its group's B gather (M scattered
//     2-byte loads per plan entry, after a dependent load of the plan)
//     once per block, and pay those round trips slab after slab.  So a
//     block owns up to 64 rows of one group (one warp per 16) and one
//     part of the K range.  It issues its `val` slabs as 16-byte cp.async
//     copies into a ring, and with the first of them the part's plan
//     entries and the window of B rows its chunks cover, so the group's B
//     is gathered into shared memory once, after one round trip.  The
//     products run on mma.sync m16n8k16.  K is cut into parts of about
//     two slabs, so even bert-base-sten's 48 groups give 96 blocks; the
//     parts of a tile are one thread-block cluster and sum through
//     distributed shared memory in part order, one launch, no atomics.
//   - f32 at gr a multiple of 4: the `rows` body, four rows of one group
//     per block.
//   - any other gr: the `general` body, where each row reads its own
//     group's plan.
// The fused QKV launch (blockIdx.y picks the segment, no concatenated copy
// of the weights) is bitwise equal to three single launches, since a
// row's summation order depends on the row and the body's plan alone.

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
  O* out;            // [R, N] or, transposed, [N, R]
  int R;
  int R_pad;
};

template <typename T, typename O>
struct Segs {
  Seg<T, O> s[3];
};

template <typename O>
__device__ __forceinline__ void store(O* out, int R, int N, int row, int c,
                                      int transpose_out, float x) {
  const size_t o = transpose_out ? (size_t)c * R + row : (size_t)row * N + c;
  out[o] = from_f32<O>(x);
}

// rows / general bodies: four rows a block, columns [n0, n0 + 16) of B
template <typename T, typename O, bool GENERAL>
__global__ void __launch_bounds__(kThreads)
nmg_gemv_kernel(Segs<T, O> segs, const T* __restrict__ b, long long ldk,
                long long ldc, int K, int KN, int N, int gr,
                int transpose_out) {
  const Seg<T, O> seg = segs.s[blockIdx.y];
  const int row0 = blockIdx.x * kRowsPerBlock;
  if (row0 >= seg.R_pad) return;  // uniform across the block
  const int n0 = blockIdx.z * kMaxM;
  const int M = min(kMaxM, N - n0);
  const T* bb = b + (long long)n0 * ldc;
  const int row = row0 + threadIdx.x / kRowThreads;
  float x;
  if constexpr (GENERAL) {
    __shared__ float part[kRowsPerBlock][kWarpsPerRow][kMaxM];
    x = rows_dot_general(seg.val, seg.cols, row, seg.R_pad, gr, bb, ldk,
                         ldc, K, KN, M, part);
  } else {
    __shared__ RowsSmem sm;
    x = rows_dot(seg.val, seg.cols + (size_t)(row0 / gr) * KN, row0, bb,
                 ldk, ldc, K, KN, M, sm);
  }
  const int rt = threadIdx.x % kRowThreads;
  if (rt < M && row < seg.R)
    store(seg.out, seg.R, N, row, n0 + rt, transpose_out, x);
}

// tc body: blockIdx.x = row tile * parts + part (one cluster a row tile)
template <int NT8, int RW, typename O>
__global__ void __launch_bounds__(RW * 32)
nmg_gemv_tc_kernel(Segs<__nv_bfloat16, O> segs,
                   const __nv_bfloat16* __restrict__ b, long long ldk,
                   long long ldc, int K, int KN, int N, int gr, int per,
                   int vec, int cs, int cx, int wp, int transpose_out) {
  constexpr int ROWS = 16 * RW;
  const Seg<__nv_bfloat16, O> seg = segs.s[blockIdx.y];
  const int parts =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int row0 = blockIdx.x / parts * ROWS;
  if (row0 >= seg.R_pad) return;  // uniform across the cluster
  const int n0 = blockIdx.z * kMaxM;
  const int M = min(kMaxM, N - n0);
  tc::tc_rows<NT8, RW, 1>(
      seg.val + (size_t)row0 * KN, nullptr,
      seg.cols + (size_t)(row0 / gr) * KN, nullptr,
      b + (long long)n0 * ldc, ldk, ldc, K, KN, M, per, vec, cs, cx, wp,
      [&](int r, int c, const float* x) {
        if (row0 + r < seg.R)
          store(seg.out, seg.R, N, row0 + r, n0 + c, transpose_out, x[0]);
      });
}

template <typename T, typename O>
int launch_rows(const Plan& p, const Segs<T, O>& segs, int max_rows,
                int nseg, int nchunks, const T* b, long long ldk,
                long long ldc, int K, int KN, int N, int gr,
                int transpose_out, cudaStream_t stream) {
  const dim3 grid((max_rows + kRowsPerBlock - 1) / kRowsPerBlock,
                  nseg, nchunks);
  if (p.body == kBodyGeneral)
    nmg_gemv_kernel<T, O, true><<<grid, kThreads, 0, stream>>>(
        segs, b, ldk, ldc, K, KN, N, gr, transpose_out);
  else
    nmg_gemv_kernel<T, O, false><<<grid, kThreads, 0, stream>>>(
        segs, b, ldk, ldc, K, KN, N, gr, transpose_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NT8, int RW, typename O>
int launch_tc(const Plan& p, const Segs<__nv_bfloat16, O>& segs, int nseg,
              int max_rows, int nchunks, const __nv_bfloat16* b,
              long long ldk, long long ldc, int K, int KN, int N, int gr,
              int vec, int cs, int cx, int transpose_out,
              cudaStream_t stream) {
  auto kernel = nmg_gemv_tc_kernel<NT8, RW, O>;
  const int wp = tc::b_stageable(b, ldk, ldc)
                     ? tc::window_pitch(p.per, cs, cx) : 0;
  const int smem = tc::smem_bytes(16 * RW, 1, NT8, p.per, p.parts, wp,
                                   N < kMaxM ? N : kMaxM);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((max_rows + 16 * RW - 1) / (16 * RW) * p.parts, nseg,
                  nchunks);
  if (p.parts == 1) {   // one part: no cluster
    kernel<<<grid, RW * 32, smem, stream>>>(segs, b, ldk, ldc, K, KN, N, gr,
                                            p.per, vec, cs, cx, wp,
                                            transpose_out);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, segs, b, ldk, ldc,
                                           K, KN, N, gr, p.per, vec, cs, cx,
                                           wp, transpose_out);
  return e != cudaSuccess ? static_cast<int>(e)
                          : static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_tc_shape(const Plan& p, const Segs<__nv_bfloat16, O>& segs,
                    int nseg, int max_rows, int nchunks,
                    const __nv_bfloat16* b, long long ldk, long long ldc,
                    int K, int KN, int N, int gr, int vec, int cs, int cx,
                    int transpose_out, cudaStream_t s) {
#define NMG_TC(NT, RWS)                                                     \
  if (p.nt8 == NT && p.rows == 16 * RWS)                                    \
    return launch_tc<NT, RWS, O>(p, segs, nseg, max_rows, nchunks, b, ldk, \
                                 ldc, K, KN, N, gr, vec, cs, cx,           \
                                 transpose_out, s);
  NMG_TC(1, 1) NMG_TC(1, 2) NMG_TC(1, 4)
  NMG_TC(2, 1) NMG_TC(2, 2) NMG_TC(2, 4)
#undef NMG_TC
  return -1;
}

}  // namespace

// Dynamic shared memory of one block of the tc body (for reports): B
// staged when b, ldk, ldc allow it, with the chunk geometry cs, cx, for
// m columns of B.
extern "C" int nmg_rows_tc_smem_bytes(int rows, int nw, int nt8, int per,
                                      int parts, const void* b,
                                      long long ldk, long long ldc, int cs,
                                      int cx, int m) {
  return tc::smem_bytes(rows, nw, nt8, per, parts,
                        tc::b_stageable(b, ldk, ldc)
                            ? tc::window_pitch(per, cs, cx) : 0, m);
}

// body: 0 = rows, 1 = general, 2 = tc, with the tc body's plan (rows per
// block, n8 tiles, slabs per K part, parts); dtype: 0 = float32, 1 =
// bfloat16 (val and B share it); out_f32: 1 when the output is float32, 0
// when it has the input type.  Up to three segments (val_i, cols_i,
// out_i, R_i, R_pad_i); unused ones pass null/0.  B has N columns, taken
// 16 at a time (blockIdx.z); the output is [R, N], or [N, R] transposed.
// cs and cx are the format's chunk geometry: cs stored values of a row
// cover the cx rows of B [c * cx, (c + 1) * cx) for chunk c (n * C(m, n)
// * g and m * C(m, n) * g).  Returns cudaGetLastError() after the launch
// (0 = success, -1 = bad arguments).
extern "C" int nmg_gemv_launch(
    int body, int rows, int nt8, int per, int parts, int dtype, int out_f32,
    int nseg,
    const void* val0, const void* cols0, void* out0, int R0, int R_pad0,
    const void* val1, const void* cols1, void* out1, int R1, int R_pad1,
    const void* val2, const void* cols2, void* out2, int R2, int R_pad2,
    const void* b, long long ldk, long long ldc, int K, int KN, int N, int gr,
    int cs, int cx, int transpose_out, void* stream) {
  const Plan p{body, rows, nt8, per, parts};
  if (nseg < 1 || nseg > 3 || N < 1 || gr < 1 || KN < 1 || cs < 1 ||
      cx < 1 ||
      check_plan(p, dtype, KN, N, gr) != 0)
    return -1;
  const void* val[3] = {val0, val1, val2};
  const void* cols[3] = {cols0, cols1, cols2};
  void* out[3] = {out0, out1, out2};
  const int R[3] = {R0, R1, R2};
  const int R_pad[3] = {R_pad0, R_pad1, R_pad2};
  int max_rows = 0;
  for (int i = 0; i < nseg; ++i)
    max_rows = R_pad[i] > max_rows ? R_pad[i] : max_rows;
  const int nchunks = (N + kMaxM - 1) / kMaxM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

#define NMG_SEGS(T, O)                                                   \
  Segs<T, O> segs{};                                                     \
  for (int i = 0; i < nseg; ++i)                                         \
    segs.s[i] = Seg<T, O>{static_cast<const T*>(val[i]),                 \
                          static_cast<const int*>(cols[i]),              \
                          static_cast<O*>(out[i]), R[i], R_pad[i]};
  if (dtype == 0) {
    NMG_SEGS(float, float)
    return launch_rows<float, float>(p, segs, max_rows, nseg, nchunks,
                                     static_cast<const float*>(b), ldk, ldc,
                                     K, KN, N, gr, transpose_out, s);
  }
  if (dtype != 1) return -1;
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
  if (out_f32) {
    NMG_SEGS(__nv_bfloat16, float)
    if (body == kBodyTc)
      return launch_tc_shape<float>(p, segs, nseg, max_rows, nchunks, bb,
                                    ldk, ldc, K, KN, N, gr,
                                    copy_bytes(val, nseg, KN), cs, cx,
                                    transpose_out, s);
    return launch_rows<__nv_bfloat16, float>(p, segs, max_rows, nseg,
                                             nchunks, bb, ldk, ldc, K, KN, N,
                                             gr, transpose_out, s);
  }
  NMG_SEGS(__nv_bfloat16, __nv_bfloat16)
  if (body == kBodyTc)
    return launch_tc_shape<__nv_bfloat16>(p, segs, nseg, max_rows, nchunks,
                                          bb, ldk, ldc, K, KN, N, gr,
                                          copy_bytes(val, nseg, KN), cs, cx,
                                          transpose_out, s);
  return launch_rows<__nv_bfloat16, __nv_bfloat16>(
      p, segs, max_rows, nseg, nchunks, bb, ldk, ldc, K, KN, N, gr,
      transpose_out, s);
#undef NMG_SEGS
}
