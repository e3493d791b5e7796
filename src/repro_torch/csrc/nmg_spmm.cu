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
// What bounds it on the H100: at the prefill widths of the serving path
// (N = 16..128 prompt tokens) each stored value feeds N multiply-adds and
// B is small, so the product is bytes-bound on `val` (about N flops per
// byte of bf16 weights, far under the ~295 flops/byte tensor-core line).
// The gathered B rows are the other traffic; B itself stays in L2.
//
// bf16 body (dtype 1), the serving path's: the TPU kernel feeds bf16 val
// and gathered B rows to the MXU with f32 accumulation, and so does this
// one, on the tensor cores (mma.sync m16n8k16 through mma_tile.cuh; not
// wgmma, because the kernel is bound by bytes and mma.sync needs no tensor
// maps or mbarriers).  A block owns 64 rows (128 where gr is a multiple of
// 128), so all of them share one fiber group's `cols` plan, across one
// column tile of the N tokens: N is cut into tiles of equal width, each
// padded only up to a multiple of 8 (the mma's n8).  A ring of 4 stages in
// shared memory, filled by cp.async, holds per 64-deep K slab: the `val`
// slab [rows][64] (16-byte copies; 8, 4 or 2 bytes where KN or the base
// does not allow 16), its 64 `cols`, and, in staged mode, each token's
// window of B rows that the slab's chunks cover (n:m:g keeps a chunk's
// stored values inside cx consecutive rows of B: 256 rows for two 1:4:8
// chunks).  Staged mode is B = x.T of a token-major x with 16-byte aligned
// rows, the serving path's prefill, so the window of a token is one
// contiguous 512-byte piece of its row, copied in 16-byte pieces with the
// slab and three slabs ahead of the products; tiles are then at most 32
// columns wide.  Per slab the block gathers B from the landed window into
// [N][k-slab] (the `.col` operand mma wants; a col outside the window is
// read from device memory, so any plan is served right), then runs the
// products: ldmatrix for `val` and B, each warp 16 rows and every column
// of the tile.  Other B layouts (gathered mode, tiles up to 64 columns)
// read B from device memory by lanes along k.  When the tiles alone
// cannot fill the card (few fiber groups, a long K), the K range is split
// across blocks that write f32 partials to a workspace, and a second
// kernel sums them in split order.  Every output's summation order is
// fixed by the shape, so two launches agree bitwise.  A ragged last slab
// and padded K rows (col >= K) read as zero.  The epilogue writes f32
// [R, N], or [N, R], optionally cast once to bf16 (round to nearest even),
// the orientation and type the model's prefill projection wants.
//
// f32 body (dtype 0): CUDA-core FMAs (64 x 64 tiles of f32 register
// accumulators, `val` and gathered B staged per 32-deep K slab with
// register prefetch), because a tensor-core f32 product would be TF32,
// another function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int kTM = 64;      // output rows per block
constexpr int kTN = 64;      // output columns per block
constexpr int kTK = 32;      // stored K values per slab
constexpr int kThreads = 256;
constexpr int kLoads = kTM * kTK / kThreads;  // A (and B) elements a thread
                                              // stages per slab: 8
constexpr int kSMs = 132;    // H100 SXM streaming multiprocessors

__device__ __forceinline__ float to_f32(float x) { return x; }

int f32_splits(int R_pad, int N, int KN) {
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
                int slabs_per_split, int transpose) {
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
      if (c < N) dst[transpose ? (size_t)c * R + r : (size_t)r * N + c] =
          acc[i][j];
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 body: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int tBK = 64;            // stored K values per slab
constexpr int tStages = 4;         // slabs in the ring
constexpr int tPK = tBK + 8;       // val / gathered-B row pitch: 144 bytes
constexpr int tXW = 256;           // staged window of each B row (elements)
constexpr int tPX = tXW;           // its pitch: 512 bytes
constexpr int tMaxCols = 64;       // widest column tile, gathered mode
constexpr int tMaxStagedCols = 32; // widest column tile, staged mode

// output modes: bit 0 writes [N, R] instead of [R, N], bit 1 writes bf16
__device__ __forceinline__ void store_out(void* out, int mode, int R, int N,
                                          int r, int c, float x) {
  const size_t i = (mode & 1) ? (size_t)c * R + r : (size_t)r * N + c;
  if (mode & 2)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

// Shared memory of one block: a ring of stages, each holding a val slab
// [rows][tPK], its 64 cols and, in staged mode, the window of every
// token's B row [NP][tPX]; then two gathered B slabs [NP][tPK].
__host__ __device__ constexpr int tc_stage_bytes(int row_warps, int nt8,
                                                 bool staged) {
  return 16 * row_warps * tPK * 2 + tBK * 4
         + (staged ? 8 * nt8 * tPX * 2 : 0);
}

__host__ __device__ constexpr int tc_smem_bytes(int row_warps, int nt8,
                                                bool staged) {
  return tStages * tc_stage_bytes(row_warps, nt8, staged)
         + 2 * 8 * nt8 * tPK * 2;
}

// Issue the copies of slab j (stored K values [k0, k0 + 64) of the
// block's range) into ring slot `st`: val in copies of `vec` bytes, the
// 64 cols, and in staged mode each token's B row window [xb, xb + tXW).
// Anything past k_end, past K or past the column tile reads as zeros.
template <int ROWS, int THREADS, int NP>
__device__ __forceinline__ void issue_stage(
    unsigned char* st, const __nv_bfloat16* __restrict__ val,
    const int* __restrict__ gcols, const __nv_bfloat16* __restrict__ b,
    long long ldc, int KN, int K, int row0, int n0, int ncols, int k0,
    int k_end, int vec, bool staged, int xb) {
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(st);
  int* sc = reinterpret_cast<int*>(st + ROWS * tPK * 2);
  const int per = vec / 2;               // elements per val copy
  const int cpr = tBK / per;             // copies per row
  for (int c = threadIdx.x; c < ROWS * cpr; c += THREADS) {
    const int r = c / cpr, k = (c % cpr) * per;
    const bool ok = k0 + k < k_end;
    const __nv_bfloat16* src = val + (size_t)(row0 + r) * KN + k0 + k;
    __nv_bfloat16* dst = sa + r * tPK + k;
    if (vec == 16)
      mma_tile::cp_async_16(dst, ok ? src : val, ok ? 16 : 0);
    else if (vec == 8)
      mma_tile::cp_async_8(dst, ok ? src : val, ok ? 8 : 0);
    else if (vec == 4)
      mma_tile::cp_async_4(dst, ok ? src : val, ok ? 4 : 0);
    else
      *dst = ok ? *src : __float2bfloat16_rn(0.f);
  }
  const int tk = threadIdx.x;
  if (tk < tBK) {
    const bool ok = k0 + tk < k_end;
    mma_tile::cp_async_4(sc + tk, ok ? gcols + k0 + tk : gcols, ok ? 4 : 0);
  }
  if (staged) {
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(
        st + ROWS * tPK * 2 + tBK * 4);
    for (int c = threadIdx.x; c < NP * (tXW / 8); c += THREADS) {
      const int t = c / (tXW / 8), x = (c % (tXW / 8)) * 8;
      if (t >= ncols) continue;
      const long long rem = 2LL * (K - (xb + x));
      const int bytes = rem <= 0 ? 0 : (rem >= 16 ? 16 : (int)rem);
      mma_tile::cp_async_16(sx + t * tPX + x,
                            bytes ? b + (long long)(n0 + t) * ldc + xb + x
                                  : b, bytes);
    }
  }
}

// The gathered B slab sb[t][k] = b[cols[k], n0 + t] of a landed stage:
// from the staged row window where cols[k] falls in it, else (gathered
// mode, or a column outside the window) from device memory, lanes along
// k within one token row; zero past k_end, for padded K rows (col >= K)
// and past the column tile.
template <int ROWS, int THREADS, int NP>
__device__ __forceinline__ void build_b(
    __nv_bfloat16* sb, const unsigned char* st,
    const __nv_bfloat16* __restrict__ b, long long ldk, long long ldc, int K,
    int n0, int ncols, int k0, int k_end, bool staged, int xb) {
  const int* sc = reinterpret_cast<const int*>(st + ROWS * tPK * 2);
  const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(
      st + ROWS * tPK * 2 + tBK * 4);
  const int k = threadIdx.x % tBK;
  const int col = k0 + k < k_end ? sc[k] : K;
  const int off = col - xb;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  __nv_bfloat16* dst = sb + k;
  const int t0 = threadIdx.x / tBK;
  constexpr int step = THREADS / tBK;
  // three loops rather than one with a select, so that no global load is
  // issued (or waited for) where the window serves the whole column
  if (col >= K) {
#pragma unroll 8
    for (int t = t0; t < NP; t += step) dst[t * tPK] = zero;
  } else if (staged && off >= 0 && off < tXW) {
    const __nv_bfloat16* src = sx + off;
#pragma unroll 8
    for (int t = t0; t < NP; t += step)
      dst[t * tPK] = t < ncols ? src[t * tPX] : zero;
  } else {
    const __nv_bfloat16* src = b + (long long)col * ldk + (long long)n0 * ldc;
#pragma unroll 8
    for (int t = t0; t < NP; t += step)
      dst[t * tPK] = t < ncols ? src[(long long)t * ldc] : zero;
  }
}

// grid (column tiles, R_pad / (16 * RW), splits); NT8 = n8 tiles per
// column tile, RW warps along the block's 16 * RW rows, times two: warps
// [0, RW) take the first 32 of each slab's 64 K values, warps [RW, 2 RW)
// the last 32, and the two partial sums are added in that order at the
// end.  mode as store_out; with splits > 1 the block writes f32 [R, N]
// partials into out + z * R * N instead.  Staged mode (B = x.T of a
// token-major x with 16-byte aligned rows) copies each token's window of
// B, [chunk base of the slab, + tXW), through the ring by cp.async and
// gathers from shared memory; the chunk geometry (cs stored values, cx B
// rows per chunk) places the window, and any cols entry outside it is
// read from device memory instead, so every plan is served right.
template <int NT8, int RW>
__global__ void __launch_bounds__(RW * 64)
nmg_spmm_tc_kernel(const __nv_bfloat16* __restrict__ val,
                   const int* __restrict__ cols,
                   const __nv_bfloat16* __restrict__ b, long long ldk,
                   long long ldc, void* __restrict__ out, int R, int K,
                   int KN, int N, int gr, int tile_cols, int slabs_per_split,
                   int vec, int mode, int staged_in, int cs, int cx) {
  constexpr int ROWS = 16 * RW, THREADS = 64 * RW, NP = 8 * NT8;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool staged = staged_in != 0;
  const int stage_bytes = tc_stage_bytes(RW, NT8, staged);
  __nv_bfloat16* sb0 =
      reinterpret_cast<__nv_bfloat16*>(smem + tStages * stage_bytes);
  const int n0 = blockIdx.x * tile_cols;
  const int row0 = blockIdx.y * ROWS;
  const int ncols = min(tile_cols, N - n0);
  const int k_begin = blockIdx.z * slabs_per_split * tBK;
  const int k_end = min(KN, k_begin + slabs_per_split * tBK);
  const int nk = k_begin < k_end ? (k_end - k_begin + tBK - 1) / tBK : 0;
  const int* __restrict__ gcols = cols + (size_t)(row0 / gr) * KN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp % RW, kh = warp / RW;
  auto stage = [&](int j) { return smem + (j % tStages) * stage_bytes; };
  auto gathered = [&](int j) { return sb0 + (j & 1) * NP * tPK; };
  auto slab = [&](int j) { return k_begin + j * tBK; };
  // the B window of a slab starts at its first chunk, 16-byte aligned
  auto window = [&](int j) { return slab(j) / cs * cx / 8 * 8; };

  float acc[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // slabs 0..2 in flight, slab 0's B gathered
#pragma unroll
  for (int j = 0; j < tStages - 1; ++j) {
    if (j < nk)
      issue_stage<ROWS, THREADS, NP>(stage(j), val, gcols, b, ldc, KN, K,
                                     row0, n0, ncols, slab(j), k_end, vec,
                                     staged, window(j));
    mma_tile::cp_async_commit();
  }
  if (nk > 0) {
    mma_tile::cp_async_wait<tStages - 2>();
    __syncthreads();
    build_b<ROWS, THREADS, NP>(gathered(0), stage(0), b, ldk, ldc, K, n0,
                               ncols, slab(0), k_end, staged, window(0));
  }

  // one barrier a slab: the products of slab kt and the gather of slab
  // kt + 1 run between the same two barriers
  for (int kt = 0; kt < nk; ++kt) {
    mma_tile::cp_async_wait<tStages - 3>();   // slab kt + 1 has landed
    __syncthreads();   // ... for every thread; slab kt's B is gathered;
                       // slab kt-1's ring slot and B buffer are free
    const int nxt = kt + tStages - 1;
    if (nxt < nk)
      issue_stage<ROWS, THREADS, NP>(stage(nxt), val, gcols, b, ldc, KN, K,
                                     row0, n0, ncols, slab(nxt), k_end, vec,
                                     staged, window(nxt));
    mma_tile::cp_async_commit();
    const __nv_bfloat16* sa =
        reinterpret_cast<const __nv_bfloat16*>(stage(kt));
    const __nv_bfloat16* sb = gathered(kt);
#pragma unroll
    for (int kq = 0; kq < tBK / 2; kq += 16) {
      const int kk = kh * (tBK / 2) + kq;
      uint32_t af[4];
      mma_tile::ldmatrix_x4(
          af, sa + (rw * 16 + (lane & 15)) * tPK + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NT8 / 2; ++jp) {
        uint32_t bf[4];
        mma_tile::ldmatrix_x4(
            bf, sb + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * tPK + kk
                    + ((lane >> 3) & 1) * 8);
        mma_tile::mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
        mma_tile::mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
      }
      if (NT8 & 1) {
        uint32_t bf[2];
        mma_tile::ldmatrix_x2(
            bf, sb + ((NT8 - 1) * 8 + (lane & 7)) * tPK + kk
                    + ((lane >> 3) & 1) * 8);
        mma_tile::mma_bf16(acc[NT8 - 1], af, bf[0], bf[1]);
      }
    }
    if (kt + 1 < nk)
      build_b<ROWS, THREADS, NP>(gathered(kt + 1), stage(kt + 1), b, ldk,
                                 ldc, K, n0, ncols, slab(kt + 1), k_end,
                                 staged, window(kt + 1));
  }
  mma_tile::cp_async_wait<0>();
  __syncthreads();   // the ring's memory becomes the reduction's

  // the second K half's sums join the first's, in that order
  float* red = reinterpret_cast<float*>(smem);
  if (kh == 1)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((rw * NT8 + j) * 4 + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] += red[((rw * NT8 + j) * 4 + e) * 32 + lane];

  void* dst = out;
  if (gridDim.z > 1) {
    dst = static_cast<float*>(out) + (size_t)blockIdx.z * R * N;
    mode = 0;
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + rw * 16 + g + (e >> 1) * 8;
      const int t = j * 8 + 2 * q + (e & 1);
      if (r < R && t < ncols) store_out(dst, mode, R, N, r, n0 + t, acc[j][e]);
    }
}

// out (mode as store_out) = sum over splits of ws[split] ([R, N] f32), in
// split order
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  void* __restrict__ out, int R, int N,
                                  int splits, int mode) {
  const long long n = (long long)R * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = ws[i];
  for (int z = 1; z < splits; ++z) x += ws[(long long)z * n + i];
  store_out(out, mode, R, N, static_cast<int>(i / N), static_cast<int>(i % N),
            x);
}

struct TcShape {
  int row_warps, tile_cols, nt8, col_tiles, splits, per, staged, smem;
};

// staged: whether B's rows can be copied in 16-byte pieces (B = x.T of a
// token-major x whose rows are 16-byte aligned)
TcShape tc_shape(int R_pad, int N, int KN, int gr, bool staged) {
  TcShape s;
  s.row_warps = gr % 128 == 0 ? 8 : 4;
  s.staged = staged;
  const int widest = staged ? tMaxStagedCols : tMaxCols;
  const int ntiles = (N + widest - 1) / widest;
  s.tile_cols = ((N + ntiles - 1) / ntiles + 7) / 8 * 8;
  s.nt8 = s.tile_cols / 8;
  s.col_tiles = (N + s.tile_cols - 1) / s.tile_cols;
  const int tiles = R_pad / (16 * s.row_warps) * s.col_tiles;
  const int nslab = (KN + tBK - 1) / tBK;
  int z = 1;
  if (tiles < kSMs) {                  // the card is not full: split K
    z = (2 * kSMs + tiles - 1) / tiles;
    if (z > nslab / 2) z = nslab / 2;  // at least two slabs per split
    if (z < 1) z = 1;
  }
  s.per = (nslab + z - 1) / z;
  s.splits = (nslab + s.per - 1) / s.per;   // no empty split
  s.smem = tc_smem_bytes(s.row_warps, s.nt8, staged);
  return s;
}

bool b_staged(const void* b, long long ldk, long long ldc) {
  return ldk == 1 && ldc % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <int NT8, int RW>
int launch_tc(const TcShape& sh, const void* val, const void* cols,
              const void* b, long long ldk, long long ldc, void* dst, int R,
              int R_pad, int K, int KN, int N, int gr, int vec, int mode,
              int cs, int cx, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {   // staged mode's (larger) need where it can be taken
    const cudaError_t e = cudaFuncSetAttribute(
        nmg_spmm_tc_kernel<NT8, RW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_smem_bytes(RW, NT8, 8 * NT8 <= tMaxStagedCols));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  dim3 grid(sh.col_tiles, R_pad / (16 * RW), sh.splits);
  nmg_spmm_tc_kernel<NT8, RW><<<grid, 64 * RW, sh.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(val), static_cast<const int*>(cols),
      static_cast<const __nv_bfloat16*>(b), ldk, ldc, dst, R, K, KN, N, gr,
      sh.tile_cols, sh.per, vec, mode, sh.staged, cs, cx);
  return 0;
}

template <int RW>
int launch_tc_w(const TcShape& sh, const void* val, const void* cols,
                const void* b, long long ldk, long long ldc, void* dst, int R,
                int R_pad, int K, int KN, int N, int gr, int vec, int mode,
                int cs, int cx, cudaStream_t stream) {
#define NMG_SPMM_CASE(n)                                                     \
  case n:                                                                    \
    return launch_tc<n, RW>(sh, val, cols, b, ldk, ldc, dst, R, R_pad, K, \
                               KN, N, gr, vec, mode, cs, cx, stream);
  switch (sh.nt8) {
    NMG_SPMM_CASE(1) NMG_SPMM_CASE(2) NMG_SPMM_CASE(3) NMG_SPMM_CASE(4)
    NMG_SPMM_CASE(5) NMG_SPMM_CASE(6) NMG_SPMM_CASE(7) NMG_SPMM_CASE(8)
    default:
      return -1;
  }
#undef NMG_SPMM_CASE
}

}  // namespace

// The number of K splits the launch below uses for this shape; the
// caller sizes the workspace [splits, R, N] f32 from it (none when 1).
extern "C" int nmg_spmm_splits(int dtype, int R_pad, int N, int KN, int gr,
                               const void* b, long long ldk, long long ldc) {
  if (dtype == 1)
    return tc_shape(R_pad, N, KN, gr, b_staged(b, ldk, ldc)).splits;
  return f32_splits(R_pad, N, KN);
}

// The bf16 body's launch for this shape, for reports: plan[0..5] = warps
// per block (two per 16 rows), n8 tiles per column tile, column tiles, K
// splits, dynamic shared memory bytes per block, staged mode.
extern "C" void nmg_spmm_tc_plan(int R_pad, int N, int KN, int gr,
                                 const void* b, long long ldk, long long ldc,
                                 int* plan) {
  const TcShape sh = tc_shape(R_pad, N, KN, gr, b_staged(b, ldk, ldc));
  plan[0] = 2 * sh.row_warps;
  plan[1] = sh.nt8;
  plan[2] = sh.col_tiles;
  plan[3] = sh.splits;
  plan[4] = sh.smem;
  plan[5] = sh.staged;
}

// dtype: 0 = float32, 1 = bfloat16 (val and B share it).  B is read as
// b[k * ldk + n * ldc].  cs and cx are the format's chunk geometry: cs
// stored values of a row cover the cx rows of B [c * cx, (c + 1) * cx)
// for chunk c (n * C(m, n) * g and m * C(m, n) * g).  out is [R, N]
// row-major, or [N, R] with transpose_out, in f32, or in bf16 with
// out_bf16 (bf16 inputs only); ws is the f32 workspace of [splits, R, N]
// when nmg_spmm_splits() > 1, else unused.  Returns cudaGetLastError()
// after the launches (0 = success, -1 = bad arguments).
extern "C" int nmg_spmm_launch(int dtype, const void* val, const void* cols,
                               const void* b, long long ldk, long long ldc,
                               void* out, void* ws, int R, int R_pad, int K,
                               int KN, int N, int gr, int cs, int cx,
                               int out_bf16, int transpose_out,
                               void* stream) {
  if (gr % kTM != 0 || R_pad % kTM != 0 || N < 1 || KN < 1 || cs < 1 ||
      cx < 1)
    return -1;
  if (out_bf16 && dtype != 1) return -1;
  const int mode = (transpose_out ? 1 : 0) | (out_bf16 ? 2 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int splits;
  if (dtype == 1) {
    const TcShape sh = tc_shape(R_pad, N, KN, gr, b_staged(b, ldk, ldc));
    splits = sh.splits;
    if (splits > 1 && ws == nullptr) return -1;
    int vec = 16;   // the widest copy both KN and val's base allow
    while (vec > 2 && ((2 * KN) % vec ||
                       reinterpret_cast<uintptr_t>(val) % vec))
      vec /= 2;
    void* dst = splits > 1 ? ws : out;
    const int err =
        sh.row_warps == 8
            ? launch_tc_w<8>(sh, val, cols, b, ldk, ldc, dst, R, R_pad, K,
                             KN, N, gr, vec, mode, cs, cx, s)
            : launch_tc_w<4>(sh, val, cols, b, ldk, ldc, dst, R, R_pad, K,
                             KN, N, gr, vec, mode, cs, cx, s);
    if (err != 0) return err;
  } else if (dtype == 0) {
    splits = f32_splits(R_pad, N, KN);
    if (splits > 1 && ws == nullptr) return -1;
    const int nslab = (KN + kTK - 1) / kTK;
    const int per = (nslab + splits - 1) / splits;
    dim3 grid(R_pad / kTM, (N + kTN - 1) / kTN, splits);
    nmg_spmm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(val), static_cast<const int*>(cols),
        static_cast<const float*>(b), ldk, ldc,
        static_cast<float*>(splits > 1 ? ws : out), R, K, KN, N, gr, per,
        splits > 1 ? 0 : transpose_out);
  } else {
    return -1;
  }
  if (splits > 1) {
    const long long n = (long long)R * N;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(ws), out, R, N, splits, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
