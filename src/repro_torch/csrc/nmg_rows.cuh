// The decode row loops shared by the n:m:g GEMV (nmg_gemv.cu, also the
// fused QKV launch and the SpMM's route for gr not a multiple of 64) and
// the fused gated FFN (nmg_ffn.cu): output rows of A_canonical[R, K]
// against a decode-shaped B[K, M] (M <= kMaxM), f32 accumulation.
//
// Three bodies; the wrapper picks one from (gr, M, KN, dtype) alone
// (kernels/nmg_gemv.py:row_plan), never from R, so the GEMV, the fused
// QKV launch and the FFN run the same body at the same gr, and each row's
// f32 sum is a function of the row and that shape alone.  Fused QKV is
// then bitwise three GEMV launches, the FFN bitwise the GEMV followed by
// the gate, and a relaunch bitwise the first launch.
//
//   rows     (f32, gr % 4 == 0) `rows_dot`: four rows of one fiber group
//            per block, two warps per row splitting K, the group's B
//            slab gathered into shared memory as f32.
//   general  (any dtype, any gr) `rows_dot_general`: the same thread
//            layout and summation order as `rows`, but each row reads its
//            own fiber group's plan (cols + (row / gr) * KN) and gathers
//            its B values itself, so a block's rows may span groups.
//   tc       (bf16, gr a multiple of the 16-row tile) `tc_rows`: see
//            below.
//
// Stored K rows past the real K (padding of the last chunk) read as zero,
// so B needs no padded copy; B is read through strides, so x.T needs no
// copy either.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace nmg {

constexpr int kRowsPerBlock = 4;       // output rows per block (rows, general)
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

struct RowsSmem {
  float b[kMaxM * kSlabStride];                  // b[c * stride + s]
  float part[kRowsPerBlock][kWarpsPerRow][kMaxM];
};

// The fixed reduction of `rows` and `general`: a warp butterfly, then the
// row's two warps in order.  Thread rt < M of each row gets column rt.
__device__ __forceinline__ float rows_reduce(
    const float (&acc)[kMaxM], int M,
    float (&part)[kRowsPerBlock][kWarpsPerRow][kMaxM]) {
  const int rloc = threadIdx.x / kRowThreads;
  const int rt = threadIdx.x % kRowThreads;
  const int lane = threadIdx.x & 31;
  const int warp_in_row = rt >> 5;
#pragma unroll
  for (int c = 0; c < kMaxM; ++c) {
    float x = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0 && c < M) part[rloc][warp_in_row][c] = x;
  }
  __syncthreads();
  float x = 0.f;
  if (rt < M) {
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) x += part[rloc][w][rt];
  }
  __syncthreads();  // part is read; a second call may overwrite it
  return x;
}

// `rows` body.  Rows row0 .. row0 + kRowsPerBlock - 1 of `val` ([R_pad,
// KN] compressed values), all in the fiber group whose plan row is `cols`
// ([KN] original K row of each value).  Every thread of the block calls
// it.  Thread (rloc, rt) = (threadIdx.x / kRowThreads, threadIdx.x %
// kRowThreads) gets the f32 sum of row row0 + rloc against column rt of B
// when rt < M (0 otherwise).  Per K slab of kSlab stored values each
// thread issues its `val` loads into registers, then the block gathers
// the B rows named by `cols` into shared memory as f32, one column of B
// per shared-memory row; the FMAs then run from registers and shared
// memory.  Ends on a barrier, so the caller may call it again.
template <typename T>
__device__ __forceinline__ float rows_dot(
    const T* __restrict__ val, const int* __restrict__ cols, int row0,
    const T* __restrict__ b, long long ldk, long long ldc, int K, int KN,
    int M, RowsSmem& sm) {
  const int rloc = threadIdx.x / kRowThreads;  // row within the block
  const int rt = threadIdx.x % kRowThreads;    // thread within its row
  const T* __restrict__ vrow = val + (size_t)(row0 + rloc) * KN;

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
          sm.b[c * kSlabStride + s] =
              col < K ? to_f32(bp[(long long)c * ldc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = rt + j * kRowThreads;
      if (s < tk) {
#pragma unroll
        for (int c = 0; c < kMaxM; ++c)
          if (c < M) acc[c] = fmaf(v[j], sm.b[c * kSlabStride + s], acc[c]);
      }
    }
  }
  return rows_reduce(acc, M, sm.part);
}

// `general` body: row `row` of `val` (skipped, but still at the barriers,
// when row >= R_pad) against B, with the plan row of its own fiber group.
// The thread layout, the FMA order (stored value s = rt, rt + 64, ...)
// and the reduction are those of `rows_dot`, so a row's sum does not
// depend on which rows share its block.
template <typename T>
__device__ __forceinline__ float rows_dot_general(
    const T* __restrict__ val, const int* __restrict__ cols, int row,
    int R_pad, int gr, const T* __restrict__ b, long long ldk,
    long long ldc, int K, int KN, int M,
    float (&part)[kRowsPerBlock][kWarpsPerRow][kMaxM]) {
  const int rt = threadIdx.x % kRowThreads;
  float acc[kMaxM];
#pragma unroll
  for (int c = 0; c < kMaxM; ++c) acc[c] = 0.f;
  if (row < R_pad) {
    const T* __restrict__ vrow = val + (size_t)row * KN;
    const int* __restrict__ crow = cols + (size_t)(row / gr) * KN;
    for (int s = rt; s < KN; s += kRowThreads) {
      const float v = to_f32(vrow[s]);
      const int col = crow[s];
      const T* bp = b + (long long)col * ldk;
#pragma unroll
      for (int c = 0; c < kMaxM; ++c)
        if (c < M)
          acc[c] = fmaf(v, col < K ? to_f32(bp[(long long)c * ldc]) : 0.f,
                        acc[c]);
    }
  }
  return rows_reduce(acc, M, part);
}

// ---------------------------------------------------------------------------
// tc body: bf16, tensor cores, one gather per group tile, cp.async ring
// ---------------------------------------------------------------------------
//
// A block owns ROWS = 16 * RW consecutive rows of one fiber group (gr is
// a multiple of ROWS) for each of its NW row sets (1 for the GEMV; 2 for
// the FFN: the u rows and their gate partners at +F) and one part of the
// K range: `per` slabs of 64 stored values.  The `parts` blocks that share
// a row tile form one thread-block cluster (Hopper), so the K split is
// summed through distributed shared memory in one launch, in part order,
// with no atomics and no second kernel.  One warp per 16 rows.
//
//   1. The first kStages - 1 slabs of `val` (ROWS rows x 64 values a row
//      set) are issued as 16-byte cp.async copies into a ring of kStages
//      slots (8-, 4- or 2-byte copies where KN or the base forbids 16).
//   2. The block gathers its group's B rows for the whole part once, into
//      shared memory as bf16 sb[c][s] (c < 8 * NT8, columns past M zero).
//      Where B = x.T with 16-byte aligned rows (the decode path), the
//      part's plan entries and the window of B rows its chunks cover
//      (n:m:g keeps a chunk's values in cx consecutive rows of B) ride in
//      the first cp.async group with slab 0, and the gather reads shared
//      memory: one round trip.  Otherwise each thread loads two plan
//      entries and then their 2 M values of B.
//   3. Per slab, one barrier: slab kt + kStages - 1 is issued into the
//      slot slab kt - 1 left, while each warp multiplies slab kt for its
//      16 rows: for each of the slab's four 16-value positions w,
//      `ldmatrix` for both operands and `mma.sync` m16n8k16 into an f32
//      accumulator of its own (one per row set, position and n8 tile).
//   4. A row's sum is fixed by the shape: per part, the four positions'
//      accumulators are added as ((w0 + w1) + w2) + w3; the parts then in
//      order 0, 1, ..., parts - 1.  The block of part z finishes rows r
//      with r % parts == z: every block stores its sums of those rows into
//      that block's shared memory (distributed shared memory), one cluster
//      barrier, and the block adds them and hands each (row, column) to
//      the caller's epilogue with one f32 sum per row set.
namespace tc {

constexpr int kSlabV = 64;              // stored values per slab
constexpr int kPitch = kSlabV;          // val slot row: 128 bytes, its
                                        // 16-byte pieces swizzled
constexpr int kStages = 4;              // slots in the ring
constexpr int kPos = kSlabV / 16;       // 16-value positions of a slab
constexpr int kMaxParts = 8;            // portable cluster size

__host__ __device__ constexpr int b_pitch(int per) {
  return per * kSlabV + 8;              // 16 bytes past a multiple of 128
}

// Ring slots a part of `per` slabs uses: slab j goes to slot j % kStages.
__host__ __device__ constexpr int ring_slots(int per) {
  return per < kStages ? per : kStages;
}

// Row pitch (elements) of the staged B window of a part of `per` slabs:
// its values lie in whole chunks of cs stored values that cover cx rows of
// B each (one more chunk where a part starts inside a chunk), and the
// window starts on a multiple of 8.
__host__ __device__ constexpr int window_pitch(int per, int cs, int cx) {
  return (((per * kSlabV + cs - 1) / cs + (per * kSlabV % cs != 0)) * cx
          + (cx % 8 != 0 ? 7 : 0) + 7) / 8 * 8;
}

// Rows of a tile whose sum the block of one part finishes.
__host__ __device__ constexpr int owned_rows(int rows, int parts) {
  return (rows + parts - 1) / parts;
}

// Floats of the part sums a block receives, rounded to 16 bytes.
__host__ __device__ constexpr int recv_floats(int rows, int nw, int parts,
                                              int m) {
  return (parts * nw * owned_rows(rows, parts) * m + 3) / 4 * 4;
}

// The ring, sb, the part sums each block receives [parts][NW][owned
// rows][M] f32 and, when B is staged (wp > 0), the window [M][wp] and the
// part's plan entries [NW][per * 64].
__host__ __device__ constexpr int smem_bytes(int rows, int nw, int nt8,
                                             int per, int parts, int wp,
                                             int m) {
  return ring_slots(per) * nw * rows * kPitch * 2
         + nw * 8 * nt8 * b_pitch(per) * 2
         + recv_floats(rows, nw, parts, m) * 4
         + (wp > 0 ? m * wp * 2 + nw * per * kSlabV * 4 : 0);
}

// The cluster barrier in its two halves (PTX barrier.cluster): arrive,
// with release semantics or none, and wait, with acquire semantics.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Element offset of (row, k) in a ring slot: the row's eight 16-byte
// pieces are permuted by the row's low three bits, so the eight rows one
// ldmatrix reads at one k land in eight different bank groups.
__device__ __forceinline__ int slot_offset(int row, int k) {
  return row * kPitch + ((((k >> 3) ^ row) & 7) << 3) + (k & 7);
}

// Whether B's rows along K can be copied in 16-byte pieces: B = x.T of a
// token-major x with 16-byte aligned rows (the decode path's operand).
inline bool b_stageable(const void* b, long long ldk, long long ldc) {
  return ldk == 1 && ldc % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <int NT8, int RW, int NW, typename Epi>
__device__ __forceinline__ void tc_rows(
    const __nv_bfloat16* __restrict__ val0,
    const __nv_bfloat16* __restrict__ val1, const int* __restrict__ cols0,
    const int* __restrict__ cols1, const __nv_bfloat16* __restrict__ b,
    long long ldk, long long ldc, int K, int KN, int M, int per, int vec,
    int cs, int cx, int wp, Epi epi) {
  namespace cg = cooperative_groups;
  constexpr int ROWS = 16 * RW, THREADS = 32 * RW, NP = 8 * NT8;
  constexpr int kStageElems = NW * ROWS * kPitch;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];
  const int PB = b_pitch(per);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = ring + ring_slots(per) * kStageElems;
  const int RO = owned_rows(ROWS, parts);
  float* recv = reinterpret_cast<float*>(sb + NW * NP * PB);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(  // staged window
      recv + recv_floats(ROWS, NW, parts, M));
  int* sc = reinterpret_cast<int*>(sx + M * wp);   // staged plan entries
  // every block of the cluster has started before any writes to a peer's
  // shared memory (the wait is just before the first such write)
  if (parts > 1) cluster_arrive_relaxed();

  const int k_begin = z * per * kSlabV;
  const int k_end = min(KN, k_begin + per * kSlabV);
  const int nk = (k_end - k_begin + kSlabV - 1) / kSlabV;

  // slab j of the part into its ring slot: copies of `vec` bytes, zeros
  // past k_end
  auto issue = [&](int j) {
    __nv_bfloat16* st = ring + (j % kStages) * kStageElems;
    const int k0 = k_begin + j * kSlabV;
    const int pc = vec / 2;               // elements per copy
    const int cpr = kSlabV / pc;          // copies per row
    for (int i = threadIdx.x; i < NW * ROWS * cpr; i += THREADS) {
      const int rr = i / cpr, k = (i % cpr) * pc;
      const int rs = rr / ROWS, r = rr % ROWS;
      const bool ok = k0 + k < k_end;
      const __nv_bfloat16* base = rs ? val1 : val0;
      const __nv_bfloat16* src = base + (size_t)r * KN + k0 + k;
      __nv_bfloat16* dst = st + slot_offset(rr, k);
      if (vec == 16)
        mma_tile::cp_async_16(dst, ok ? src : base, ok ? 16 : 0);
      else if (vec == 8)
        mma_tile::cp_async_8(dst, ok ? src : base, ok ? 8 : 0);
      else if (vec == 4)
        mma_tile::cp_async_4(dst, ok ? src : base, ok ? 4 : 0);
      else
        *dst = ok ? *src : __float2bfloat16_rn(0.f);
    }
  };

  // Staged B (wp > 0): the part's plan entries and the window of B rows
  // [xs, xe) that its chunks cover ride in the first group with slab 0, so
  // the gather below reads shared memory after one round trip, not a
  // round trip for the plan and then one for B.
  const int ns = nk * kSlabV;
  const int xs = k_begin / cs * cx / 8 * 8;
  const int xe = min(K, (k_end + cs - 1) / cs * cx);
  if (wp > 0) {
    for (int i = threadIdx.x; i < NW * ns; i += THREADS) {
      const int rs = i / ns, s = i % ns;
      const int* gc = (rs ? cols1 : cols0) + k_begin;
      const bool ok = k_begin + s < k_end;
      mma_tile::cp_async_4(sc + rs * per * kSlabV + s, ok ? gc + s : gc,
                           ok ? 4 : 0);
    }
    const int xw = (xe - xs + 7) / 8;     // 16-byte pieces a row
    for (int i = threadIdx.x; i < M * xw; i += THREADS) {
      const int c = i / xw, x = xs + (i % xw) * 8;
      const int left = 2 * (K - x);
      const int bytes = left >= 16 ? 16 : (left > 0 ? left : 0);
      mma_tile::cp_async_16(sx + c * wp + (x - xs),
                            bytes ? b + (long long)c * ldc + x : b, bytes);
    }
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nk) issue(j);
    mma_tile::cp_async_commit();
  }

  // the group's B rows for the whole part, once: sb[c][s], zero past M,
  // past k_end (a ragged last slab) and for padded K rows
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  if (wp > 0) {
    mma_tile::cp_async_wait<kStages - 2>();   // the plan and window landed
    __syncthreads();
    for (int i = threadIdx.x; i < NW * ns; i += THREADS) {
      const int rs = i / ns, s = i % ns;
      const int col = k_begin + s < k_end ? sc[rs * per * kSlabV + s] : K;
      const int off = col - xs;
      __nv_bfloat16* dst = sb + rs * NP * PB + s;
      if (col >= K) {
#pragma unroll
        for (int c = 0; c < NP; ++c) dst[c * PB] = zero;
      } else if (off >= 0 && off < xe - xs) {
#pragma unroll
        for (int c = 0; c < NP; ++c)
          dst[c * PB] = c < M ? sx[c * wp + off] : zero;
      } else {   // outside the window: any plan is served right
        const __nv_bfloat16* bp = b + col;
#pragma unroll
        for (int c = 0; c < NP; ++c)
          dst[c * PB] = c < M ? bp[(long long)c * ldc] : zero;
      }
    }
  } else {
    // from device memory: two plan entries a thread per pass, their loads
    // issued together
#pragma unroll
    for (int rs = 0; rs < NW; ++rs) {
      const int* __restrict__ gc = (rs ? cols1 : cols0) + k_begin;
      __nv_bfloat16* sbr = sb + rs * NP * PB;
      for (int s = threadIdx.x; s < ns; s += 2 * THREADS) {
        const int s2 = s + THREADS;
        const int ca = k_begin + s < k_end ? gc[s] : K;
        const int cb = k_begin + s2 < k_end ? gc[s2] : K;
        const __nv_bfloat16* pa = b + (long long)ca * ldk;
        const __nv_bfloat16* pb = b + (long long)cb * ldk;
        __nv_bfloat16 xa[NP], xb[NP];
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          xa[c] = (c < M && ca < K) ? pa[(long long)c * ldc] : zero;
          xb[c] = (c < M && cb < K) ? pb[(long long)c * ldc] : zero;
        }
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          sbr[c * PB + s] = xa[c];
          if (s2 < ns) sbr[c * PB + s2] = xb[c];
        }
      }
    }
  }

  const int lane = threadIdx.x & 31, t = threadIdx.x >> 5;
  float acc[NW][kPos][NT8][4];
#pragma unroll
  for (int rs = 0; rs < NW; ++rs)
#pragma unroll
    for (int w = 0; w < kPos; ++w)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rs][w][j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    mma_tile::cp_async_wait<kStages - 2>();   // slab kt has landed
    __syncthreads();   // ... for every thread; the gather is visible; the
                       // slot of slab kt - 1 is free
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    mma_tile::cp_async_commit();
    const __nv_bfloat16* st = ring + (kt % kStages) * kStageElems;
#pragma unroll
    for (int rs = 0; rs < NW; ++rs) {
#pragma unroll
      for (int w = 0; w < kPos; ++w) {
        uint32_t af[4];
        mma_tile::ldmatrix_x4(af, st + slot_offset(rs * ROWS + t * 16
                                                       + (lane & 15),
                                                   w * 16 + (lane >> 4) * 8));
        const __nv_bfloat16* sbr =
            sb + rs * NP * PB + kt * kSlabV + w * 16;
        if constexpr (NT8 == 2) {
          uint32_t bf[4];
          mma_tile::ldmatrix_x4(bf, sbr + ((lane & 7) + (lane >> 4) * 8)
                                              * PB
                                        + ((lane >> 3) & 1) * 8);
          mma_tile::mma_bf16(acc[rs][w][0], af, bf[0], bf[1]);
          mma_tile::mma_bf16(acc[rs][w][1], af, bf[2], bf[3]);
        } else {
          uint32_t bf[2];
          mma_tile::ldmatrix_x2(bf, sbr + (lane & 7) * PB
                                        + ((lane >> 3) & 1) * 8);
          mma_tile::mma_bf16(acc[rs][w][0], af, bf[0], bf[1]);
        }
      }
    }
  }
  mma_tile::cp_async_wait<0>();

  // each block's sum of a row goes to the block that finishes the row
  // (part r % parts), into its slot [z][rs][r / parts][c] there (c < M)
  if (parts > 1) cluster_wait();
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int rs = 0; rs < NW; ++rs)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = t * 16 + g + (e >> 1) * 8;
        const int c = j * 8 + 2 * q + (e & 1);
        const float v =
            ((acc[rs][0][j][e] + acc[rs][1][j][e]) + acc[rs][2][j][e])
            + acc[rs][3][j][e];
        float* dst = recv + ((z * NW + rs) * RO + r / parts) * M + c;
        const int owner = r % parts;
        if (c >= M)
          continue;
        if (owner == z)
          *dst = v;
        else
          *cluster.map_shared_rank(dst, owner) = v;
      }
  if (parts > 1) {   // every part's sums have arrived
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // rows z, z + parts, ... of the tile: the parts' sums in part order
  for (int i = threadIdx.x; i < owned_rows(ROWS - z, parts) * M;
       i += THREADS) {
    const int ro = i / M, c = i % M;
    float x[NW];
#pragma unroll
    for (int rs = 0; rs < NW; ++rs) {
      float s = recv[(rs * RO + ro) * M + c];
      for (int p = 1; p < parts; ++p)
        s += recv[((p * NW + rs) * RO + ro) * M + c];
      x[rs] = s;
    }
    epi(z + ro * parts, c, x);
  }
}

}  // namespace tc

// The decode bodies' plan, chosen by the wrapper from (gr, M, KN, dtype)
// (kernels/nmg_gemv.py:row_plan): the body and, for `tc`, rows per block,
// n8 tiles, slabs of 64 stored values per K part, and the parts.
constexpr int kBodyRows = 0, kBodyGeneral = 1, kBodyTc = 2;

struct Plan {
  int body, rows, nt8, per, parts;
};

// 0 when the kernels take plan p for this shape (N columns of B, taken 16
// at a time), -1 otherwise.
inline int check_plan(const Plan& p, int dtype, int KN, int N, int gr) {
  if (p.body == kBodyRows) return gr % kRowsPerBlock == 0 ? 0 : -1;
  if (p.body == kBodyGeneral) return 0;
  if (p.body != kBodyTc || dtype != 1) return -1;
  if (p.rows != 16 && p.rows != 32 && p.rows != 64) return -1;
  if (gr % p.rows != 0 || (p.nt8 != 1 && p.nt8 != 2)) return -1;
  if (8 * p.nt8 < (N < kMaxM ? N : kMaxM)) return -1;
  const int nslab = (KN + tc::kSlabV - 1) / tc::kSlabV;
  if (p.per < 1 || p.parts < 1 || p.parts > tc::kMaxParts ||
      (nslab + p.per - 1) / p.per != p.parts)
    return -1;
  return 0;
}

// The widest cp.async copy (16, 8, 4 or 2 bytes) that every row of each
// bf16 `val` allows: KN values a row, each base address as it is.
inline int copy_bytes(const void* const* val, int nseg, int KN) {
  int vec = 16;
  for (int i = 0; i < nseg; ++i)
    while (vec > 2 && ((2 * KN) % vec ||
                       reinterpret_cast<uintptr_t>(val[i]) % vec))
      vec /= 2;
  return vec;
}

}  // namespace nmg
