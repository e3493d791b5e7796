// Per-m-block top-n keep mask along the last axis, for Hopper (sm_90a):
// mask[r, k] = 1 iff x[r, k] is among the n largest |x| of its m-block.
//
// Replaces the Pallas body repro/kernels/nm_mask.py:_kernel (launched by
// nm_mask_pallas).  Same rank rule, so the same bits:
//   keep i  iff  #{j : a_j > a_i  or  (a_j == a_i and j < i)} < n,
// on the flushed magnitudes a = |x|, where a magnitude below the smallest
// normal f32 (FLT_MIN, also bf16's smallest normal) reads 0, as on the TPU
// and in the reference's CPU runs.  The flush is written out here, not
// left to -ftz.  A NaN compares false both ways: it is never counted
// against another element and its own rank is 0, so it is kept whenever
// n > 0 (a block may then keep more than n).  Ties go to the lowest index,
// as jax.lax.top_k breaks them.  A ragged last block (K % m != 0) reads its
// missing entries as 0 at the higher indices, as the reference's zero
// padding does; they can win slots but are never written.
//
// What bounds it on the H100: bytes for small m (each element read once,
// 2 or 4 bytes, and one mask byte written); for wider blocks the integer
// pipe (64 lanes a clock an SM, half the float rate), which every
// comparison and selection uses.  Counting the rank costs m compare-and-
// add pairs an element; a sorting network costs ~log^2(m) / 2 compare-
// exchanges (two min/max) an element, then one compare against the n-th
// key.  Three bodies, chosen by nm_mask_plan from the shape alone (dtype,
// m, K % m, alignment), never as a fallback on failure:
//
// vector  m in {2, 4, 8, 16, 32}, K % m == 0, x and its row pitch 16-byte
//         aligned.  Rows are whole blocks, so the tensor is read as flat
//         chunks of lcm(m, 8 bf16 / 4 f32) elements: each thread loads a
//         chunk as 16-byte vectors, ranks its blocks in registers, and
//         stores the chunk's mask bytes as one 4-, 8-, 16- or two 16-byte
//         words.  m <= 8 (and f32) count the rank with the network unrolled
//         on constant indices (j < i beats on >=, j > i on >: the float
//         rule itself, NaN included); bf16 m = 16 and 32 sort keys.  A
//         grid-stride loop sized to the resident blocks keeps up to four
//         chunks' loads in flight a thread; offsets are 64-bit, with no
//         division.
// staged  any other m up to 64 (f32: 32): 5:20, 2:17, 1:33, 16:64, ragged
//         K, a misaligned view.  A thread block takes a tile of consecutive
//         m-blocks of the [R, nb] block grid (256, or up to 1024 of small
//         blocks).  Their elements are one contiguous run of x, loaded with
//         coalesced 16-byte vectors (scalar at the two ends) and put in
//         shared memory, each element in its block's row; a row is an odd
//         number of 16-byte units, so when a thread then reads its block's
//         row as 16-byte words no two lanes of a phase share a bank.  The
//         thread sorts its block's keys in registers; the mask bytes are
//         staged in shared memory and written out as coalesced 4-byte
//         words.  The next tile's loads are issued into registers before
//         this tile is ranked, so they arrive while it is.  No comparand
//         is read from global memory after the load.
// long    m past that: a thread block per m-block ranks 2048 of its
//         elements at a time by counting, against chunks of up to 2048 keys
//         of the block staged in shared memory.
//
// Rank keys: v = 0 for NaN, else the bits of the flushed magnitude + 1
// (bf16: its 15 magnitude bits + 1), so v orders the values as the floats
// do and puts NaN strictly lowest; the key is v above the inverted index
// (2^w - 1 - j), which makes every key of a block distinct.  key_j > key_i
// iff v_j > v_i or (v_j == v_i and j < i), which for a non-NaN i is the
// float rule (a NaN j has v_j = 0 < v_i).  So a non-NaN i is kept iff its
// key is among the n largest of the block, i.e. at least the n-th largest;
// a NaN i is kept iff n > 0, as the float rule's rank 0 gives.  bf16 keys
// are 32-bit (16 value bits, 16 index bits), f32 keys 64-bit.  The zero
// padding of a ragged block is the value 0 (v = 1) at its index; slots past
// m hold key 0, below every real key, so they never reach the n largest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kMinNormal = 0x00800000u;    // FLT_MIN's bits
constexpr int kStagedRowBytes = 32 * 1024;      // a staged tile's rows
constexpr int kLongChunk = 2048;                // long body: keys a pass

enum Body { kVector = 0, kStaged = 1, kLong = 2 };

__host__ __device__ constexpr int gcd_c(int a, int b) {
  return b == 0 ? a : gcd_c(b, a % b);
}
__host__ __device__ constexpr int lcm_c(int a, int b) {
  return a / gcd_c(a, b) * b;
}
__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// ---------------------------------------------------------------------------
// values and keys
// ---------------------------------------------------------------------------

// |x| from its f32 bits, a subnormal magnitude flushed to +0; NaN stays NaN
__device__ __forceinline__ float flushed_abs(uint32_t bits) {
  const uint32_t u = bits & 0x7fffffffu;
  return __uint_as_float(u < kMinNormal ? 0u : u);
}

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;                 // elements a 16-byte vector
  static constexpr int kMaxStagedM = 32;         // 64-bit keys: registers
  using Bits = uint32_t;
  using Key = unsigned long long;
  static constexpr int kIdxBits = 32;
  static __device__ __forceinline__ uint32_t bits(const float* p,
                                                  long long i) {
    return __float_as_uint(p[i]);
  }
  // the key's value part: 0 for NaN, else flushed magnitude bits + 1
  static __device__ __forceinline__ uint32_t value(uint32_t b) {
    const uint32_t u = b & 0x7fffffffu;
    return u > 0x7f800000u ? 0u : (u < kMinNormal ? 0u : u) + 1u;
  }
  // the kVec flushed magnitudes of one vector
  static __device__ __forceinline__ void magnitudes(const uint4 v, float* a) {
    a[0] = flushed_abs(v.x);
    a[1] = flushed_abs(v.y);
    a[2] = flushed_abs(v.z);
    a[3] = flushed_abs(v.w);
  }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kMaxStagedM = 64;
  using Bits = uint16_t;
  using Key = uint32_t;
  static constexpr int kIdxBits = 16;
  static __device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p,
                                                  long long i) {
    return reinterpret_cast<const uint16_t*>(p)[i];
  }
  // 15 magnitude bits: exponent field 0 is zero or subnormal, past 0x7f80
  // is NaN
  static __device__ __forceinline__ uint32_t value(uint32_t b) {
    const uint32_t u = b & 0x7fffu;
    return u > 0x7f80u ? 0u : (u < 0x0080u ? 0u : u) + 1u;
  }
  static __device__ __forceinline__ void magnitudes(const uint4 v, float* a) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // element 2i is the low half
      a[2 * i] = flushed_abs(w[i] << 16);
      a[2 * i + 1] = flushed_abs(w[i] & 0xffff0000u);
    }
  }
};

template <typename Key, int kIdxBits>
__device__ __forceinline__ Key make_key(uint32_t v, int j) {
  constexpr Key kIdxMask = (Key(1) << kIdxBits) - 1;
  return (Key(v) << kIdxBits) | (kIdxMask - Key(j));
}

// the elements of 16-byte words, in memory order
template <typename Bits>
__device__ __forceinline__ uint32_t element(const uint4* w, int i) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(w);
  if constexpr (sizeof(Bits) == 4) return u[i];
  else return (u[i / 2] >> (16 * (i % 2))) & 0xffffu;
}

// ---------------------------------------------------------------------------
// ranking a block in registers
// ---------------------------------------------------------------------------

// Batcher's odd-even merge sort into descending order on the slots
// [LO, HI] of a power-of-two network, keeping only the comparators inside
// the first MB slots: slots past MB would hold the least key, and a
// comparator only moves the larger key to the lower slot, so they never
// move and their comparators do nothing.
template <int MB, typename Key>
__device__ __forceinline__ void exchange(Key* k, int x, int y) {
  if (y < MB) {
    const Key a = k[x], b = k[y];
    k[x] = a > b ? a : b;
    k[y] = a > b ? b : a;
  }
}

template <int MB, int LO, int HI, int R, typename Key>
__device__ __forceinline__ void oe_merge(Key* k) {
  constexpr int kStep = 2 * R;
  if constexpr (kStep < HI - LO) {
    oe_merge<MB, LO, HI, kStep>(k);
    oe_merge<MB, LO + R, HI, kStep>(k);
#pragma unroll
    for (int i = LO + R; i < HI - R; i += kStep) exchange<MB>(k, i, i + R);
  } else {
    exchange<MB>(k, LO, LO + R);
  }
}

template <int MB, int LO, int HI, typename Key>
__device__ __forceinline__ void oe_sort(Key* k) {
  if constexpr (HI - LO >= 1) {
    constexpr int kMid = LO + (HI - LO) / 2;
    oe_sort<MB, LO, kMid>(k);
    oe_sort<MB, kMid + 1, HI>(k);
    oe_merge<MB, LO, HI, 1>(k);
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// The n-th largest key (1 <= n <= m) of a block whose key values are
// v[0..MB): slots [valid, m) are the zero padding, slots [m, MB) hold the
// least key.
template <typename Key, int kIdxBits, int MB>
__device__ __forceinline__ Key nth_key(const uint32_t* v, int valid, int m,
                                       int n) {
  Key k[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i)
    k[i] = i < valid ? make_key<Key, kIdxBits>(v[i], i)
           : i < m   ? make_key<Key, kIdxBits>(1u, i)
                     : Key(0);
  oe_sort<MB, 0, pow2_at_least(MB) - 1>(k);
  // k[n - 1]: the compiler turns this chain of selects into one indexed
  // load from local memory (the sorted keys stored there, in L1), which
  // reads faster than a tree of selects on the bits of n - 1
  // (scripts/nm_mask_ablation.py, variant kth_tree)
  Key kth = k[0];
#pragma unroll
  for (int r = 1; r < MB; ++r)
    if (r == n - 1) kth = k[r];
  return kth;
}

// ---------------------------------------------------------------------------
// vector body
// ---------------------------------------------------------------------------

template <int W>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t* w) {
  if constexpr (W == 1) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < W; k += 4)
      reinterpret_cast<uint4*>(p)[k / 4] =
          make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
nm_mask_vec_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                   long long nchunks, int n) {
  using Tr = Traits<T>;
  using Key = typename Tr::Key;
  constexpr int V = Tr::kVec;
  constexpr int E = lcm_c(M, V);         // elements a chunk: whole vectors,
  constexpr int NV = E / V;              // whole blocks, E / 4 mask words
  constexpr int U = NV >= 4 ? 1 : 4 / NV;   // chunks in flight a thread
  constexpr bool kSort = M >= 16 && sizeof(Key) == 4;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long c0 = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
       c0 < nchunks; c0 += stride * U) {
    uint4 v[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = c0 + u * stride;
      if (c < nchunks) {
#pragma unroll
        for (int k = 0; k < NV; ++k) v[u][k] = xv[c * NV + k];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = c0 + u * stride;
      if (c >= nchunks) break;
      uint32_t w[E / 4];
#pragma unroll
      for (int k = 0; k < E / 4; ++k) w[k] = 0;
      if constexpr (kSort) {
#pragma unroll
        for (int b = 0; b < E; b += M) {
          uint32_t val[M];
#pragma unroll
          for (int i = 0; i < M; ++i)
            val[i] = Tr::value(element<typename Tr::Bits>(v[u], b + i));
          if (n > 0) {
            const Key kth = nth_key<Key, Tr::kIdxBits, M>(val, M, M, n);
#pragma unroll
            for (int i = 0; i < M; ++i) {
              const bool keep = make_key<Key, Tr::kIdxBits>(val[i], i) >= kth
                                || val[i] == 0;
              w[(b + i) / 4] |= static_cast<uint32_t>(keep)
                                << (8 * ((b + i) % 4));
            }
          }
        }
      } else {
        float a[E];
#pragma unroll
        for (int k = 0; k < NV; ++k) Tr::magnitudes(v[u][k], a + k * V);
#pragma unroll
        for (int b = 0; b < E; b += M) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            int r = 0;
#pragma unroll
            for (int j = 0; j < M; ++j) {
              if (j < i) r += a[b + j] >= a[b + i];
              else if (j > i) r += a[b + j] > a[b + i];
            }
            w[(b + i) / 4] |= static_cast<uint32_t>(r < n)
                              << (8 * ((b + i) % 4));
          }
        }
      }
      store_words<E / 4>(out + c * E, w);
    }
  }
}

// ---------------------------------------------------------------------------
// staged body
// ---------------------------------------------------------------------------

// n / d for 0 <= n, d < 2^31 by a multiply-high and a shift
struct FastDiv {
  uint32_t mul, shift;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t magic = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<uint32_t>(magic), s};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return static_cast<int>((__umulhi(static_cast<uint32_t>(n), f.mul)
                           + static_cast<uint32_t>(n)) >> f.shift);
}

struct StagedArgs {
  long long pairs;      // m-blocks in all: R * nb
  long long tiles;      // ceil(pairs / bpt)
  int K, m, n, nb;
  FastDiv by_m, by_nb, by_K;
};

// a staged tile's layout for blocks of at most MB (a compile-time bound on
// m): each block a row of kMp slots, an odd number of 16-byte units; kBpt
// blocks a tile, one a thread for MB >= 16 and several for smaller blocks,
// as far as 32 KB of rows hold; the run's mask bytes after the rows; and
// the 16-byte vectors of a tile's run a thread loads
template <typename T, int MB>
struct StagedShape {
  using Bits = typename Traits<T>::Bits;
  static constexpr int kUnits =
      (MB * static_cast<int>(sizeof(Bits)) + 15) / 16;
  static constexpr int kRowWords = kUnits % 2 == 0 ? kUnits + 1 : kUnits;
  static constexpr int kMp = kRowWords * 16 / static_cast<int>(sizeof(Bits));
  static constexpr int kWant = MB >= 16 ? kThreads : kThreads * (16 / MB);
  static constexpr int kBpt = kWant < kStagedRowBytes / (kRowWords * 16)
                              ? kWant : kStagedRowBytes / (kRowWords * 16);
  static constexpr int kObuf = kBpt * kRowWords * 16;  // offset of obuf
  static constexpr int kSmem = kObuf + round16(kBpt * MB + 8);
  static constexpr int kVecs =
      (kBpt * MB / Traits<T>::kVec + kThreads - 1) / kThreads + 1;
};

// where a tile's run lies: its first block (row0, blk0), its blocks, and
// the run x[g0, g0 + L) split into head scalars, whole 16-byte vectors
// and tail scalars
struct Run {
  long long row0, g0;
  int blk0, np, L, head, nvec, tail;
};

template <typename T>
__device__ __forceinline__ Run run_of(const T* x, long long row0, int blk0,
                                      long long p0, int bpt,
                                      const StagedArgs& g) {
  Run r;
  r.row0 = row0;
  r.blk0 = blk0;
  r.np = static_cast<int>(min(static_cast<long long>(bpt), g.pairs - p0));
  const int last = blk0 + r.np - 1;
  const int lrow = fdiv(last, g.by_nb);
  const int lcol = (last - lrow * g.nb) * g.m;
  r.g0 = row0 * g.K + static_cast<long long>(blk0) * g.m;
  r.L = static_cast<int>((row0 + lrow) * g.K + min(lcol + g.m, g.K) - r.g0);
  constexpr int V = Traits<T>::kVec;
  r.head = min(r.L, static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(x + r.g0) & 15u)) & 15u)
      / sizeof(T)));
  r.nvec = (r.L - r.head) / V;
  r.tail = r.L - r.head - r.nvec * V;
  return r;
}

template <typename T, int MB>
__global__ void __launch_bounds__(kThreads)
nm_mask_staged_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                      StagedArgs g) {
  using Tr = Traits<T>;
  using Bits = typename Tr::Bits;
  using Key = typename Tr::Key;
  using Sh = StagedShape<T, MB>;
  constexpr int V = Tr::kVec;
  constexpr int kMp = Sh::kMp;
  constexpr int kBpt = Sh::kBpt;
  extern __shared__ __align__(16) unsigned char smem[];
  Bits* rows = reinterpret_cast<Bits*>(smem);          // [kBpt][kMp]
  uint8_t* obuf = smem + Sh::kObuf;                    // the run's mask
  const int tid = threadIdx.x;

  long long t = blockIdx.x;
  if (t >= g.tiles) return;
  // tiles advance by gridDim.x: (row0, blk0) by a fixed step, no division
  const int step = static_cast<int>(gridDim.x) * kBpt;
  const int step_rows = step / g.nb, step_blks = step - step_rows * g.nb;
  const int first = static_cast<int>(blockIdx.x) * kBpt;
  Run cur = run_of(x, first / g.nb, first % g.nb, t * kBpt, kBpt, g);

  // the run's elements a thread loads, held in registers from the load to
  // their place in shared memory
  uint4 pre[Sh::kVecs];
  uint32_t pre_head = 0, pre_tail = 0;
  auto fetch = [&](const Run& r) {
    const T* src = x + r.g0;
    const uint4* srcv = reinterpret_cast<const uint4*>(src + r.head);
#pragma unroll
    for (int j = 0; j < Sh::kVecs; ++j) {
      const int v = tid + j * kThreads;
      if (v < r.nvec) pre[j] = srcv[v];
    }
    if (tid < r.head) pre_head = Tr::bits(src, tid);
    if (tid < r.tail) pre_tail = Tr::bits(src, r.head + r.nvec * V + tid);
  };
  // put `cnt` consecutive run elements from e on into their blocks' rows;
  // run element e sits at column blk0 * m + e counted from row0's start
  auto place = [&](const Run& r, const uint32_t* b, int cnt, int e) {
    int col = r.blk0 * g.m + e;
    const int ro = fdiv(col, g.by_K);
    col -= ro * g.K;
    const int bq = fdiv(col, g.by_m);
    int i = col - bq * g.m;
    int q = ro * g.nb + bq - r.blk0;
    for (int u = 0; u < cnt; ++u) {
      rows[q * kMp + i] = static_cast<Bits>(b[u]);
      ++i;
      ++col;
      if (col == g.K || i == g.m) {      // the next block, or the next row
        ++q;
        i = 0;
        if (col == g.K) col = 0;
      }
    }
  };

  fetch(cur);
  for (;;) {
#pragma unroll
    for (int j = 0; j < Sh::kVecs; ++j) {
      const int v = tid + j * kThreads;
      if (v < cur.nvec) {
        uint32_t b[V];
#pragma unroll
        for (int k = 0; k < V; ++k) b[k] = element<Bits>(&pre[j], k);
        place(cur, b, V, cur.head + v * V);
      }
    }
    if (tid < cur.head) place(cur, &pre_head, 1, tid);
    if (tid < cur.tail)
      place(cur, &pre_tail, 1, cur.head + cur.nvec * V + tid);
    __syncthreads();

    // the next tile's loads are in flight while this tile is ranked
    const long long tn = t + gridDim.x;
    Run nxt = cur;
    if (tn < g.tiles) {
      long long row0 = cur.row0 + step_rows;
      int blk0 = cur.blk0 + step_blks;
      if (blk0 >= g.nb) {
        blk0 -= g.nb;
        ++row0;
      }
      nxt = run_of(x, row0, blk0, tn * kBpt, kBpt, g);
      fetch(nxt);
    }

    // out[g0 + e] is staged at obuf[o2 + e]; obuf[o2 + h2] starts a word
    uint8_t* dst = out + cur.g0;
    const int h2 = min(cur.L, static_cast<int>(
        (4u - (reinterpret_cast<uintptr_t>(dst) & 3u)) & 3u));
    const int o2 = (4 - h2 % 4) % 4;
    for (int q = tid; q < cur.np; q += kThreads) {   // a thread a block
      const int b = cur.blk0 + q;
      const int ro = fdiv(b, g.by_nb);
      const int col = (b - ro * g.nb) * g.m;
      const int start = ro * g.K + col - cur.blk0 * g.m;
      const int valid = min(g.m, g.K - col);
      uint4 w[Sh::kRowWords];
      const uint4* row = reinterpret_cast<const uint4*>(rows + q * kMp);
#pragma unroll
      for (int k = 0; k < Sh::kRowWords; ++k) w[k] = row[k];
      uint32_t val[MB];
#pragma unroll
      for (int i = 0; i < MB; ++i) val[i] = Tr::value(element<Bits>(w, i));
      uint8_t* o = obuf + o2 + start;
      if (g.n > 0) {
        const Key kth = nth_key<Key, Tr::kIdxBits, MB>(val, valid, g.m, g.n);
#pragma unroll
        for (int i = 0; i < MB; ++i)
          if (i < valid)
            o[i] = make_key<Key, Tr::kIdxBits>(val[i], i) >= kth
                   || val[i] == 0;
      } else {
        for (int i = 0; i < valid; ++i) o[i] = 0;
      }
    }
    __syncthreads();

    const int nw = (cur.L - h2) / 4;
    for (int w = tid; w < nw; w += kThreads)
      *reinterpret_cast<uint32_t*>(dst + h2 + 4 * w) =
          *reinterpret_cast<const uint32_t*>(obuf + o2 + h2 + 4 * w);
    for (int e = tid; e < h2; e += kThreads) dst[e] = obuf[o2 + e];
    for (int e = h2 + 4 * nw + tid; e < cur.L; e += kThreads)
      dst[e] = obuf[o2 + e];
    if (tn >= g.tiles) break;
    __syncthreads();                     // rows and obuf are free again
    t = tn;
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// long body
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_mask_long_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                    long long pairs, int K, int m, int n, int nb) {
  using Tr = Traits<T>;
  using Key = unsigned long long;        // index part 32 bits: any m
  constexpr int kOwn = kLongChunk / kThreads;
  __shared__ __align__(16) Key cmp[kLongChunk];
  for (long long p = blockIdx.x; p < pairs; p += gridDim.x) {
    const long long row = p / nb;        // one division per m > 64 block
    const int col0 = static_cast<int>(p - row * nb) * m;
    const int valid = min(m, K - col0);
    const T* src = x + row * K + col0;
    uint8_t* dst = out + row * K + col0;
    for (int i0 = 0; i0 < valid; i0 += kLongChunk) {
      Key mine[kOwn];
      int r[kOwn];
#pragma unroll
      for (int e = 0; e < kOwn; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        mine[e] = i < valid ? make_key<Key, 32>(Tr::value(Tr::bits(src, i)), i)
                            : ~0ull;
        r[e] = 0;
      }
      for (int j0 = 0; j0 < m; j0 += kLongChunk) {
        const int cnt = min(kLongChunk, (m - j0 + 1) / 2 * 2);
        __syncthreads();                 // the last chunk has been read
        for (int e = threadIdx.x; e < cnt; e += kThreads) {
          const int j = j0 + e;
          const uint32_t v = j < valid ? Tr::value(Tr::bits(src, j)) : 1u;
          cmp[e] = j < m ? make_key<Key, 32>(v, j) : 0ull;
        }
        __syncthreads();
        for (int k = 0; k < cnt; k += 2) {
          const ulonglong2 c = *reinterpret_cast<const ulonglong2*>(cmp + k);
#pragma unroll
          for (int e = 0; e < kOwn; ++e)
            r[e] += (c.x > mine[e]) + (c.y > mine[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kOwn; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        if (i < valid)
          dst[i] = (mine[e] >> 32) == 0 ? (n > 0) : (r[e] < n);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// plan and launch
// ---------------------------------------------------------------------------

// resident thread blocks of `fn` on the current device at `smem` bytes of
// dynamic shared memory, cached: the grid-stride grids are one full wave
int resident_blocks(const void* fn, int smem) {
  struct Entry { const void* fn; int dev, smem, blocks; };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev && cache[i].smem == smem)
      return cache[i].blocks;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (used < 64) cache[used++] = {fn, dev, smem, blocks};
  return blocks;
}

struct Plan {
  int body, grid, smem;
  int mb;               // staged: the network's block size, at least m
  long long nchunks;    // vector
  StagedArgs st;        // staged, long (pairs, K, m, n, nb)
};

// the staged networks' block sizes; m takes the first that holds it
constexpr int kStagedMB[] = {4, 8, 12, 16, 20, 24, 32, 48, 64};

// f(std::integral_constant<int, MB>) for a staged block size
template <typename T, typename F>
void with_mb(int mb, F&& f) {
  switch (mb) {
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 12: f(std::integral_constant<int, 12>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    case 20: f(std::integral_constant<int, 20>{}); break;
    case 24: f(std::integral_constant<int, 24>{}); break;
    case 32: f(std::integral_constant<int, 32>{}); break;
    default:
      if constexpr (Traits<T>::kMaxStagedM > 32) {
        if (mb == 48) f(std::integral_constant<int, 48>{});
        else f(std::integral_constant<int, 64>{});
      }
  }
}

// f(std::integral_constant<int, M>) for a vector body's m
template <typename F>
void with_m(int m, F&& f) {
  switch (m) {
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    default: f(std::integral_constant<int, 32>{}); break;
  }
}

// the body and grid for x [R, K] (rows contiguous) by shape and alignment
template <typename T>
int plan_of(const T* x, long long R, int K, int n, int m, Plan* p) {
  if (m < 1 || n < 0 || n > m || R < 0 || K < 0) return -1;
  const int nb = (K + m - 1) / m;
  p->st.pairs = R * nb;
  p->st.K = K;
  p->st.m = m;
  p->st.n = n;
  p->st.nb = nb;
  p->grid = 0;
  p->smem = 0;
  p->mb = 0;
  p->nchunks = 0;
  const bool vector_m = m == 2 || m == 4 || m == 8 || m == 16 || m == 32;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15u) == 0
                       && (static_cast<long long>(K) * sizeof(T)) % 16 == 0;
  if (vector_m && K % m == 0 && aligned) {
    p->body = kVector;
    p->nchunks = R * K / lcm_c(m, Traits<T>::kVec);
    const void* fn = nullptr;
    with_m(m, [&](auto M) {
      fn = reinterpret_cast<const void*>(&nm_mask_vec_kernel<T, M()>);
    });
    const long long want = (p->nchunks + kThreads - 1) / kThreads;
    const long long wave = resident_blocks(fn, 0);
    p->grid = static_cast<int>(want < wave ? want : wave);
    return 0;
  }
  if (m <= Traits<T>::kMaxStagedM) {
    p->body = kStaged;
    int mb = 64;
    for (int s : kStagedMB)
      if (s >= m) { mb = s; break; }
    p->mb = mb;
    p->st.by_m = make_fastdiv(m);
    p->st.by_nb = make_fastdiv(nb > 0 ? nb : 1);
    p->st.by_K = make_fastdiv(K > 0 ? K : 1);
    const void* fn = nullptr;
    int bpt = 1;
    with_mb<T>(mb, [&](auto MB) {
      using Sh = StagedShape<T, MB()>;
      fn = reinterpret_cast<const void*>(&nm_mask_staged_kernel<T, MB()>);
      bpt = Sh::kBpt;
      p->smem = Sh::kSmem;
    });
    p->st.tiles = (p->st.pairs + bpt - 1) / bpt;
    const long long wave = resident_blocks(fn, p->smem);
    p->grid = static_cast<int>(p->st.tiles < wave ? p->st.tiles : wave);
    return 0;
  }
  p->body = kLong;
  const long long wave = resident_blocks(
      reinterpret_cast<const void*>(&nm_mask_long_kernel<T>), 0);
  p->grid = static_cast<int>(p->st.pairs < wave ? p->st.pairs : wave);
  return 0;
}

template <typename T>
void launch(const T* x, uint8_t* o, const Plan& p, cudaStream_t s) {
  if (p.body == kVector) {
    with_m(p.st.m, [&](auto M) {
      nm_mask_vec_kernel<T, M()><<<p.grid, kThreads, 0, s>>>(
          x, o, p.nchunks, p.st.n);
    });
  } else if (p.body == kStaged) {
    with_mb<T>(p.mb, [&](auto MB) {
      nm_mask_staged_kernel<T, MB()><<<p.grid, kThreads, p.smem, s>>>(
          x, o, p.st);
    });
  } else {
    nm_mask_long_kernel<T><<<p.grid, kThreads, 0, s>>>(
        x, o, p.st.pairs, p.st.K, p.st.m, p.st.n, p.st.nb);
  }
}

int plan_any(int dtype, const void* x, long long R, int K, int n, int m,
             Plan* p) {
  if (dtype == 0)
    return plan_of(static_cast<const float*>(x), R, K, n, m, p);
  if (dtype == 1)
    return plan_of(static_cast<const __nv_bfloat16*>(x), R, K, n, m, p);
  return -1;
}

}  // namespace

// The plan nm_mask_launch takes for these arguments, without launching:
// plan[0] = body (0 vector, 1 staged, 2 long), plan[1] = grid, plan[2] =
// threads a block, plan[3] = dynamic shared memory bytes a block, plan[4] =
// the staged body's network size (slots a block, at least m; else 0).
// Returns 0, or -1 for bad arguments.
extern "C" int nm_mask_plan(int dtype, const void* x, long long R, int K,
                            int n, int m, int* plan) {
  Plan p;
  const int err = plan_any(dtype, x, R, K, n, m, &p);
  if (err != 0) return err;
  plan[0] = p.body;
  plan[1] = p.grid;
  plan[2] = kThreads;
  plan[3] = p.smem;
  plan[4] = p.mb;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  x is [R, K] row-major, out is uint8
// [R, K] (read as bool).  Returns cudaGetLastError() after the launch
// (0 = success, -1 = bad arguments; the vector body also needs out 16-byte
// aligned, as a fresh allocation is).
extern "C" int nm_mask_launch(int dtype, const void* x, void* out,
                              long long R, int K, int n, int m,
                              void* stream) {
  Plan p;
  const int err = plan_any(dtype, x, R, K, n, m, &p);
  if (err != 0) return err;
  if (p.grid == 0) return 0;             // nothing to compute
  if (p.body == kVector && (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return -1;                           // the vector body's word stores
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (dtype == 0)
    launch(static_cast<const float*>(x), o, p, s);
  else
    launch(static_cast<const __nv_bfloat16*>(x), o, p, s);
  return static_cast<int>(cudaGetLastError());
}
