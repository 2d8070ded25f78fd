// The partitioned match's compaction tails for Hopper (sm_90a).
//
// What they replace. Two XLA device programs of the JAX package, which run
// after the match-words kernel on every batch of the main path:
//   - launch_fused_compact_decode replaces rmqtt_tpu/ops/partitioned.py:1356
//     fused_compact_decode_impl: match words [B, W] (W = NC*4 uint32 words a
//     topic) -> the int32 wire [budget + B]: the fids of the first `budget`
//     routes in flat (topic, word, bit) order, each topic's sorted by signed
//     fid, then zeros, then the per-topic route counts.
//   - launch_compact_global replaces rmqtt_tpu/ops/partitioned.py:1251
//     compact_global_impl: the same words -> [budget + B] of the first
//     `budget` routes as word*32 + bit in flat order, zeros, then the counts;
//     16-bit values while W*32 < 0x10000, else 32-bit.
// Route r of topic t is bit b of word j: the row
// chunk_ids[t, j/4]*128 + (j%4)*32 + b of the table, and its fid is
// fid_rows[row] (-1 for a cleared row, which sorts first). Topic t's routes
// start at off_t, the exclusive scan of the counts, and it keeps
// k_t = clamp(budget - off_t, 0, cnt_t) of them: a topic cut by the budget
// keeps its first k_t routes in (word, bit) order, then sorts those. The
// plain PyTorch twins are rmqtt_tpu_torch/ops/compact_tail.py
// fused_compact_decode_plain and compact_global_plain; the wires are equal
// bit for bit, every slot included.
//
// What bounds them on the H100. A call must read the words once (8 MiB at
// B=16,384, NC=32), the chunk ids (2 MiB) and one fid a kept route, and
// write the wire (~1.1 MB at a budget of 262,144): ~11 MB, ~3.5 us at
// 3.35 TB/s. The work is a popcount a word, a scan of B counts and a sort of
// each topic's few fids (at most 17 at cfg3's shapes): far below the
// integer rate. At the broker's batches (1-4 topics, budget 256) there is no
// work to speak of: a call costs its launch and a chain of dependent memory
// round trips (the words, a chunk id, a fid, the store). What the time goes
// to instead: launches (~2 us each), the scan's dependence of every topic
// on all topics before it, and the latency of each block's chain.
//
// What the design does about it. The launcher picks one of two paths.
//   1. Small batches (B <= 64, budget <= 16,384): one launch of
//      ceil(B / 8) blocks of 256 threads, which never wait on each other:
//      each block counts all B rows (eight a warp, 16-byte loads, __popc, a
//      warp sum) and scans the counts itself (warp 0, 64 bits), then places
//      its own eight topics, a warp each, and zero-fills its share of
//      [min(n, budget), budget). A topic of more than 1,024 kept routes is
//      gathered by its block into the shared-memory stage at its own
//      offset (the budget bounds it: 64 KB) and sorted there by a bitonic
//      network. (A draft that gave all 64 topics to one block put every
//      place on one SM: 0.0176 ms at B = 64 against 0.0049 at B = 1 on an
//      H100, bench/tail_kernels.py.)
//   2. Larger batches: one memset, then a single pass over the words: eight
//      warps a block, a topic a warp, or four where the one-topic grid would
//      not fit on the card at once (the occupancy API times the SMs, asked
//      once a device): then the whole grid runs in one wave, where more
//      blocks would each run their chain of dependent round trips in turn
//      (bench/tail_variants.py on an H100, fused: at cfg3 0.0153 ms against
//      0.0173 with one topic a warp; at 4,096 topics, which fit, 0.0076
//      against 0.0116 with four). A warp reads its rows
//      once (one uint4 a lane at W = 128; wider rows re-read their later
//      spans from L1/L2) and counts them; the block scans its counts, gets
//      its exclusive prefix from the blocks before it, then places its
//      topics from the rows still in registers.
//      - Blocks take a logical id from an atomic ticket, not blockIdx, so a
//        block only ever waits on blocks that are already running (there
//        are far more blocks than fit on the card at B = 16,384).
//      - The look-back: a block publishes its aggregate twice, as its own
//        64-bit flag (a set top bit over the value) and as an atomic
//        addition to its group's sum (32 blocks; the count of blocks added
//        in the top byte). Warp 0 then waits on and adds the complete sums
//        of the groups before its own and the flags of its group's blocks
//        before it: one round trip, with no chain of inclusive prefixes to
//        wait for. (An inclusive-prefix look-back 32 flags a round trip
//        made the ~1,000 blocks that arrive at once walk back window after
//        window until a prefix reached them, and 1,024 flags a round trip
//        piled them onto the few L2 lines that hold the flags: drafts so
//        built took 0.0258 and 0.0503 ms a fused call at cfg3 on an H100,
//        bench/tail_kernels.py.) Offsets and sums stay 64-bit. Each word is stored with
//        release order; it carries its value and its status together and
//        the block reads nothing else that another block wrote, so the
//        reads are relaxed. Each group sum has a 128-byte line of its own
//        (compact_global at cfg3: 0.0120 ms against 0.0127-0.0130 with the
//        sums packed; bench/tail_variants.py on an H100).
//      - Between publishing and reading the prefix, each warp gathers and
//        sorts its topics of at most 32 routes as if the budget kept them
//        whole (their fids depend on no offset), so that latency overlaps
//        the wait; only the one topic the budget cuts is gathered again
//        (the fused tail at cfg3: 0.0153 ms against 0.0203-0.0208 without).
//      - The memset zeroes the wire's [0, budget) together with the ticket,
//        the flags and the sums, which follow the wire in the same
//        allocation: one operation ahead of the pass, in stream order, so a
//        CUDA graph's replay and a call on another stream (which gets memory
//        of its own from the caching allocator) start clean, and no block
//        has to learn the total to zero-fill.
//      - A topic of more than 1,024 kept routes is gathered and sorted by
//        its own block after the warps' places: in the block's 32 KB stage,
//        or, past 8,192 routes, straight in its place in the wire (tiles of
//        8,192 in shared memory, then the merge steps of strides >= 8,192
//        in global memory and the smaller ones tile by tile in shared
//        memory again).
//      So a call is a memset and one kernel.
// The place step, a warp a topic:
//   - k <= 32 kept routes: route i lands in lane i. The lane finds the lane
//     that holds it by a binary search over the warp's inclusive scan of
//     the lanes' popcounts (shuffles), takes that lane's four words, and
//     finds its bit by an nth-set-bit search; all lanes gather their fids
//     through chunk_ids and fid_rows at once, and a bitonic network of
//     __shfl_xor_sync sorts them in registers (lanes past k hold INT_MAX);
//   - 33-1,024: each lane writes its routes' fids at their index into the
//     warp's 4 KB of shared memory, and the bitonic network sorts them
//     there (the minimum at the lower index of every pair, over a virtual
//     power of two: a pair whose upper index is past k is skipped);
//   - more: the block, as above.
//   compact_global's lanes write word*32 + bit straight to the wire.
// A set bit under a chunk id outside the fid map reads the nearest row of
// the map (the words kernels give such ids no bits). Words off a 16-byte
// boundary (or W % 4 != 0) are read with 4-byte loads.
//
// Memory a call takes: the wire, then, on the single pass only, at the next
// 16-byte boundary, compact_tail_scratch_bytes(b, budget): the uint32
// ticket, padding, a 64-bit flag a block and a padded sum a group.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // rows per tile (ops/partitioned.py CHUNK)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpan = 128;      // words a warp holds at once: four a lane
constexpr int kWarpCap = 1024;  // kept routes a warp sorts (4 KB a warp)
constexpr int kSmallThreads = 256;  // the small path: eight warps a block
constexpr int kSmallWarps = kSmallThreads / 32;  // topics a block places
constexpr int kSmallB = 64;                      // topics the path takes
constexpr int kSmallRows = kSmallB / kSmallWarps;  // rows a warp counts
constexpr int kSmallBudget = 16384;  // slots a block may stage (64 KB)
constexpr int kPassWarps = 8;        // the single pass: eight warps a block
constexpr int kPassThreads = kPassWarps * 32;
constexpr int kPassRowsMax = 4;      // topics a warp, when the grid is large
constexpr int kBlockCap = kPassWarps * kWarpCap;  // fids a pass block sorts in
                                                  // its stage (32 KB)
constexpr int kGroup = 32;     // blocks a group sum covers
constexpr int kGroupPad = 16;  // words a group sum takes: a 128-byte line each
static_assert(kPassWarps * kPassRowsMax <= 32, "warp 0 scans a block's counts");

// A block's flag: a set top bit over its aggregate. A group's sum: the
// count of its blocks that have added theirs in the top byte, the sum below.
constexpr unsigned long long kPublished = 1ull << 63;
constexpr unsigned long long kValue = (1ull << 62) - 1;
constexpr unsigned long long kOne = 1ull << 56;
constexpr unsigned long long kSum = kOne - 1;

// The rows and, for the fused tail, what resolves a route to its fid.
struct Rows {
  const unsigned* words;
  int w;
  bool vec;  // 16-byte loads: w % 4 == 0 and 16-byte aligned rows
  const int* fid_rows;
  long long nrows;
  const int* chunk_ids;
  int nc;
};

inline bool small_path(int b, int budget) {
  return b <= kSmallB && budget <= kSmallBudget;
}

// blocks of the pass at `rows` topics a warp
inline int pass_blocks(int b, int rows = 1) {
  return (b + kPassWarps * rows - 1) / (kPassWarps * rows);
}

inline int pass_groups(int nb) { return (nb + kGroup - 1) / kGroup; }

// the ticket, padding to 16 bytes, a flag a block, a sum a group of blocks
// (sized for one topic a warp, the most blocks)
inline size_t scratch_bytes(int b) {
  const int nb = pass_blocks(b);
  return 16 + (size_t)(nb + (size_t)pass_groups(nb) * kGroupPad) * 8;
}

// where the scratch starts: the wire's end, rounded up to 16 bytes
inline size_t scratch_at(int b, int budget, size_t elem) {
  return ((size_t)(budget + b) * elem + 15) & ~(size_t)15;
}

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ long long warp_incl_scan64(long long x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int kept(long long budget, long long off, int cnt) {
  long long k = budget - off;
  return k <= 0 ? 0 : (k < cnt ? (int)k : cnt);
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

__device__ __forceinline__ int pow2ceil(int k) {
  return k <= 1 ? 1 : 1 << (32 - __clz(k - 1));
}

// The fid of a set bit: row chunk_ids[j/4]*128 + (j%4)*32 + bit, clamped
// into the map.
__device__ __forceinline__ int fid_of(const int* fid_rows, long long nrows,
                                      long long rowbase, int bit) {
  long long r = rowbase + bit;
  r = r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
  return __ldg(fid_rows + r);
}

__device__ __forceinline__ int fid_at(const Rows& in, const int* cid, int j,
                                      int bit) {
  return fid_of(in.fid_rows, in.nrows,
                (long long)__ldg(cid + (j >> 2)) * kChunk + (j & 3) * 32, bit);
}

// ------------------------------------------------------------ rows
// Words [j, j + 4) of a row; words past w read 0.
__device__ __forceinline__ uint4 load4(const unsigned* __restrict__ row, int w,
                                       int j, bool vec) {
  if (vec) {
    return j < w ? __ldg(reinterpret_cast<const uint4*>(row + j))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  return make_uint4(j < w ? __ldg(row + j) : 0u, j + 1 < w ? __ldg(row + j + 1) : 0u,
                    j + 2 < w ? __ldg(row + j + 2) : 0u,
                    j + 3 < w ? __ldg(row + j + 3) : 0u);
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ unsigned word_of(uint4 v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// A warp counts a row's set bits; v0 keeps the lane's words of the first span.
__device__ __forceinline__ int count_row(const unsigned* row, int w, bool vec,
                                         int lane, uint4& v0) {
  v0 = load4(row, w, 4 * lane, vec);
  int c = popc4(v0);
  for (int j = kSpan + 4 * lane; j < w; j += kSpan) c += popc4(load4(row, w, j, vec));
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  return c;
}

// emit(idx, j, bit) for each of the lane's routes of index < k, the index
// counted in flat (word, bit) order over the warp's row.
template <typename Emit>
__device__ __forceinline__ void walk_routes(const unsigned* row, int w, bool vec,
                                            uint4 v0, int k, int lane, Emit emit) {
  int run = 0;  // routes of the spans before this one
  for (int c0 = 0; c0 < w && run < k; c0 += kSpan) {
    const uint4 v = c0 == 0 ? v0 : load4(row, w, c0 + 4 * lane, vec);
    const int pc = popc4(v);
    const int x = warp_incl_scan(pc, lane);
    int idx = run + x - pc;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned m = word_of(v, q);
      const int j = c0 + 4 * lane + q;
      while (m != 0u && idx < k) {
        emit(idx++, j, __ffs(m) - 1);
        m &= m - 1;
      }
    }
    run += __shfl_sync(kFull, x, 31);
  }
}

// Position of the n-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const int c = __popc(m & ((1u << h) - 1u));
    if (n >= c) {
      n -= c;
      m >>= h;
      pos += h;
    }
  }
  return pos;
}

// Route `lane` (k <= 32) of the warp's row: its word j and bit; j = -1 for
// lanes >= k.
__device__ __forceinline__ void route_of_lane(const unsigned* row, int w, bool vec,
                                              uint4 v0, int k, int lane, int& j,
                                              int& bit) {
  j = -1;
  bit = 0;
  int run = 0;
  for (int c0 = 0; c0 < w && run < k; c0 += kSpan) {
    const uint4 v = c0 == 0 ? v0 : load4(row, w, c0 + 4 * lane, vec);
    const int pc = popc4(v);
    const int x = warp_incl_scan(pc, lane);
    const int tot = __shfl_sync(kFull, x, 31);
    const int r = lane - run;  // the lane's route within this span
    int s = 0;                 // the first lane whose inclusive scan passes r
    for (int st = 16; st > 0; st >>= 1) {
      if (__shfl_sync(kFull, x, s + st - 1) <= r) s += st;
    }
    const int before = __shfl_sync(kFull, x - pc, s);
    const unsigned wx = __shfl_sync(kFull, v.x, s), wy = __shfl_sync(kFull, v.y, s);
    const unsigned wz = __shfl_sync(kFull, v.z, s), ww = __shfl_sync(kFull, v.w, s);
    if (r >= 0 && r < tot && lane < k) {
      int n = r - before, q = 0;
      unsigned m = wx;
      int c = __popc(wx);
      if (n >= c) {
        n -= c;
        m = wy;
        q = 1;
        c = __popc(wy);
        if (n >= c) {
          n -= c;
          m = wz;
          q = 2;
          c = __popc(wz);
          if (n >= c) {
            n -= c;
            m = ww;
            q = 3;
          }
        }
      }
      j = c0 + 4 * s + q;
      bit = nth_bit(m, n);
    }
    run += tot;
  }
}

// ------------------------------------------------------------ sorting
// Ascending bitonic sort of one value a lane over lanes [0, pow2ceil(k)).
__device__ __forceinline__ int warp_sort(int v, int k, int lane) {
  const int p = pow2ceil(k);
  for (int size = 2; size <= p; size <<= 1) {
    for (int st = size >> 1; st > 0; st >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, st);
      v = (((lane & st) == 0) == ((lane & size) == 0)) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// The bitonic network in the form that puts the minimum at the lower index
// of every pair, over a virtual power-of-two array [0, p) whose elements
// at and past k are +infinity: a pair whose upper index is >= k is skipped.
// Each step is done by threads tid, tid + nt, ... and followed by sync().
template <bool kBlock>
__device__ __forceinline__ void group_sync() {
  if (kBlock) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

__device__ __forceinline__ void cx(int* s, int i, int j) {
  int a = s[i], c = s[j];
  if (a > c) {
    s[i] = c;
    s[j] = a;
  }
}

// compare i with its mirror in each block of `size`
__device__ __forceinline__ void step_mirror(int* s, int k, int p, int size,
                                            int tid, int nt) {
  int half = size >> 1, lh = ilog2(half);
  for (int t = tid; t < (p >> 1); t += nt) {
    int base = (t >> lh) * size, pos = t & (half - 1);
    int j = base + size - 1 - pos;
    if (j < k) cx(s, base + pos, j);
  }
}

// compare i with i + st in each block of 2*st
__device__ __forceinline__ void step_stride(int* s, int k, int p, int st,
                                            int tid, int nt) {
  int ls = ilog2(st);
  for (int t = tid; t < (p >> 1); t += nt) {
    int i = ((t >> ls) << (ls + 1)) + (t & (st - 1));
    if (i + st < k) cx(s, i, i + st);
  }
}

template <bool kBlock>
__device__ __forceinline__ void sort_net(int* s, int k, int tid, int nt) {
  int p = pow2ceil(k);
  for (int size = 2; size <= p; size <<= 1) {
    step_mirror(s, k, p, size, tid, nt);
    group_sync<kBlock>();
    for (int st = size >> 2; st > 0; st >>= 1) {
      step_stride(s, k, p, st, tid, nt);
      group_sync<kBlock>();
    }
  }
}

// g[tb, tb + kt) <-> shared memory, a block's threads
__device__ __forceinline__ void tile_load(int* sm, const int* g, int kt) {
  for (int i = threadIdx.x; i < kt; i += blockDim.x) sm[i] = g[i];
  __syncthreads();
}

__device__ __forceinline__ void tile_store(int* g, const int* sm, int kt) {
  for (int i = threadIdx.x; i < kt; i += blockDim.x) g[i] = sm[i];
  __syncthreads();
}

// Sort g[0, k), k > cap, in place by one block: tiles of `cap` in shared
// memory, then each merge: its strides >= cap over g, its smaller ones tile
// by tile in shared memory.
__device__ __forceinline__ void sort_global(int* g, int k, int* sm, int cap) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p = pow2ceil(k);
  for (int tb = 0; tb < k; tb += cap) {
    int kt = min(cap, k - tb);
    tile_load(sm, g + tb, kt);
    sort_net<true>(sm, kt, tid, nt);
    tile_store(g + tb, sm, kt);
  }
  for (int size = cap << 1; size <= p; size <<= 1) {
    step_mirror(g, k, p, size, tid, nt);
    __syncthreads();
    for (int st = size >> 2; st >= cap; st >>= 1) {
      step_stride(g, k, p, st, tid, nt);
      __syncthreads();
    }
    for (int tb = 0; tb < k; tb += cap) {
      int kt = min(cap, k - tb);
      tile_load(sm, g + tb, kt);
      for (int st = cap >> 1; st > 0; st >>= 1) {
        step_stride(sm, kt, cap, st, tid, nt);
        __syncthreads();
      }
      tile_store(g + tb, sm, kt);
    }
  }
}

// ------------------------------------------------------------ placing
// Zero out[lo, hi) by threads tid, tid + nt, ...: 16-byte stores between
// the unaligned ends.
template <typename T>
__device__ __forceinline__ void zero_range(T* out, long long lo, long long hi,
                                           int tid, int nt) {
  if (lo >= hi) return;
  constexpr int per = 16 / sizeof(T);
  const int mis = (int)((reinterpret_cast<uintptr_t>(out + lo) & 15) / sizeof(T));
  long long head = mis ? per - mis : 0;
  if (head > hi - lo) head = hi - lo;
  for (long long i = tid; i < head; i += nt) out[lo + i] = 0;
  const long long a = lo + head, nv = (hi - a) / per;
  int4* v = reinterpret_cast<int4*>(out + a);
  for (long long i = tid; i < nv; i += nt) v[i] = make_int4(0, 0, 0, 0);
  for (long long i = a + nv * per + tid; i < hi; i += nt) out[i] = 0;
}

// Topic t's first k <= 32 routes' fids, sorted: the i-th in lane i
// (INT_MAX in lanes >= k).
__device__ __forceinline__ int sorted_fid(const Rows& in, int t, uint4 v0, int k,
                                          int lane) {
  int j, bit;
  route_of_lane(in.words + (size_t)t * in.w, in.w, in.vec, v0, k, lane, j, bit);
  const int f = j >= 0 ? fid_at(in, in.chunk_ids + (size_t)t * in.nc, j, bit) : INT_MAX;
  return warp_sort(f, k, lane);
}

// A warp places topic t's k (1 <= k <= kWarpCap) kept routes' sorted fids
// at out[off, off + k); s is 4 KB of shared memory for k > 32.
__device__ __forceinline__ void place_fused_warp(const Rows& in, int t, uint4 v0,
                                                 int k, long long off, int* s,
                                                 int lane, int* __restrict__ out) {
  const unsigned* row = in.words + (size_t)t * in.w;
  const int* cid = in.chunk_ids + (size_t)t * in.nc;
  if (k <= 32) {
    const int f = sorted_fid(in, t, v0, k, lane);
    if (lane < k) out[off + lane] = f;
    return;
  }
  walk_routes(row, in.w, in.vec, v0, k, lane,
              [&](int idx, int j, int bit) { s[idx] = fid_at(in, cid, j, bit); });
  __syncwarp();
  sort_net<false>(s, k, lane, 32);
  for (int i = lane; i < k; i += 32) out[off + i] = s[i];
}

// A warp places topic t's k kept routes as word*32 + bit at out[off, off + k).
template <typename T>
__device__ __forceinline__ void place_global_warp(const Rows& in, int t, uint4 v0,
                                                  int k, long long off, int lane,
                                                  T* __restrict__ out) {
  T* dst = out + off;
  walk_routes(in.words + (size_t)t * in.w, in.w, in.vec, v0, k, lane,
              [&](int idx, int j, int bit) { dst[idx] = static_cast<T>(j * 32 + bit); });
}

// The block gathers topic t's first k routes' fids, in order, into
// buf[0, k): a window of blockDim words at a time, a block scan of their
// popcounts.
__device__ __forceinline__ void gather_block(const Rows& in, int t, int k, int* buf,
                                             int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned* row = in.words + (size_t)t * in.w;
  const int* cid = in.chunk_ids + (size_t)t * in.nc;
  int run = 0;
  for (int base = 0; base < in.w; base += blockDim.x) {
    const int j = base + tid;
    const unsigned v = j < in.w ? __ldg(row + j) : 0u;
    const int pc = __popc(v);
    const int x = warp_incl_scan(pc, lane);
    if (lane == 31) wsum[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int s = lane < nw ? wsum[lane] : 0;
      wsum[lane] = warp_incl_scan(s, lane);
    }
    __syncthreads();
    int idx = run + (wid ? wsum[wid - 1] : 0) + x - pc;
    const int tot = wsum[nw - 1];
    __syncthreads();  // wsum is rewritten by the next window
    unsigned m = v;
    while (m != 0u && idx < k) {
      buf[idx++] = fid_at(in, cid, j, __ffs(m) - 1);
      m &= m - 1;
    }
    run += tot;
    if (run >= k) break;  // uniform: every thread holds the same run
  }
  __syncthreads();
}

// The block places topic t's k > kWarpCap kept routes' sorted fids at
// out[off, off + k): through the stage (cap fids) or, past it, in place.
__device__ __forceinline__ void place_fused_block(const Rows& in, int t, int k,
                                                  long long off, int* stage, int cap,
                                                  int* wsum, int* __restrict__ out) {
  int* dst = out + off;
  if (k <= cap) {
    gather_block(in, t, k, stage, wsum);
    sort_net<true>(stage, k, threadIdx.x, blockDim.x);
    tile_store(dst, stage, k);
  } else {
    gather_block(in, t, k, dst, wsum);
    sort_global(dst, k, stage, cap);
  }
}

// Warp 0: the exclusive scan of cnt[0, b), b <= 64, into off and the total.
__device__ __forceinline__ void scan_small(const int* cnt, int b, long long* off,
                                           long long* total, int lane) {
  const long long a = lane < b ? cnt[lane] : 0;
  const long long c = lane + 32 < b ? cnt[lane + 32] : 0;
  const long long xa = warp_incl_scan64(a, lane);
  const long long xc = warp_incl_scan64(c, lane) + __shfl_sync(kFull, xa, 31);
  if (lane < b) off[lane] = xa - a;
  if (lane + 32 < b) off[lane + 32] = xc - c;
  if (lane == 31) *total = xc;
}

// Lane 0 of the block of logical id `bid`: publish the block's aggregate,
// as its flag and as an addition to its group's sum.
__device__ __forceinline__ void publish(unsigned long long* flags,
                                        unsigned long long* groups, unsigned bid,
                                        long long agg) {
  using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
  Word(flags[bid]).store(kPublished | agg, cuda::std::memory_order_release);
  Word(groups[(size_t)(bid / kGroup) * kGroupPad])
      .fetch_add(kOne + agg, cuda::std::memory_order_release);
}

// The word at p once ready(word).
template <typename Ready>
__device__ __forceinline__ unsigned long long wait_for(unsigned long long* p,
                                                       Ready ready) {
  using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
  unsigned long long v = Word(*p).load(cuda::std::memory_order_relaxed);
  while (!ready(v)) v = Word(*p).load(cuda::std::memory_order_relaxed);
  return v;
}

// Warp 0 of the block of logical id `bid`: the complete group sums before
// its group and the flags of its group's blocks before it, each waited on
// until it is published, added up → the block's exclusive prefix.
__device__ __forceinline__ long long prefix(unsigned long long* flags,
                                            unsigned long long* groups, unsigned bid,
                                            int lane) {
  const unsigned g = bid / kGroup, first = g * kGroup;
  long long sum = 0;
  for (unsigned q = lane; q < g; q += 32) {
    sum += (long long)(wait_for(groups + (size_t)q * kGroupPad, [](unsigned long long v) {
                         return (v >> 56) >= (unsigned long long)kGroup;
                       }) & kSum);
  }
  if (first + lane < bid) {
    sum += (long long)(wait_for(flags + first + lane,
                                [](unsigned long long v) { return v != 0; }) & kValue);
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  return sum;
}

// ------------------------------------------------------------ kernels
// The small path: block g counts and scans all B topics, places topics
// [8g, 8g + 8) and zero-fills its share of the unfilled slots.
template <bool kFused, typename T>
__global__ void __launch_bounds__(kSmallThreads)
    tail_small_kernel(Rows in, int b, int budget, T* __restrict__ out) {
  extern __shared__ int4 smem_raw[];
  int* stage = reinterpret_cast<int*>(smem_raw);  // [budget]: wire slot i
  __shared__ int cnt_s[kSmallB];
  __shared__ long long off_s[kSmallB];
  __shared__ long long total_s;
  __shared__ int wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = blockIdx.x;
  uint4 v0 = make_uint4(0u, 0u, 0u, 0u);  // the row of the topic this warp places
#pragma unroll
  for (int i = 0; i < kSmallRows; ++i) {
    const int t = wid + kSmallWarps * i;
    if (t < b) {
      uint4 v;
      const int c = count_row(in.words + (size_t)t * in.w, in.w, in.vec, lane, v);
      if (i == g) v0 = v;
      if (lane == 0) {
        cnt_s[t] = c;
        if (g == 0) out[budget + t] = static_cast<T>(c);
      }
    }
  }
  __syncthreads();
  if (wid == 0) scan_small(cnt_s, b, off_s, &total_s, lane);
  __syncthreads();
  const long long n = total_s, lo = n < budget ? n : (long long)budget;
  const long long share = (budget - lo + gridDim.x - 1) / gridDim.x;
  const long long zlo = lo + share * g;
  zero_range(out, zlo, zlo + share < budget ? zlo + share : (long long)budget, tid,
             blockDim.x);
  const int t = g * kSmallWarps + wid;
  if (t < b) {
    const long long off = off_s[t];
    const int k = kept(budget, off, cnt_s[t]);
    if constexpr (kFused) {
      if (k > 0 && k <= kWarpCap) place_fused_warp(in, t, v0, k, off, stage + off, lane, out);
    } else if (k > 0) {
      place_global_warp(in, t, v0, k, off, lane, out);
    }
  }
  if constexpr (kFused) {
    __syncthreads();
    for (int q = 0; q < kSmallWarps && g * kSmallWarps + q < b; ++q) {  // uniform
      const int tq = g * kSmallWarps + q;
      const long long off = off_s[tq];
      const int k = kept(budget, off, cnt_s[tq]);
      if (k > kWarpCap) {
        place_fused_block(in, tq, k, off, stage + off, k, wsum, out);
      }
    }
  }
}

// The single pass: kRows topics a warp, kPassWarps * kRows a block, the
// block's offset by the look-back. The wire's [0, budget), the ticket, the
// flags and the group sums were zeroed.
template <bool kFused, typename T, int kRows>
__global__ void __launch_bounds__(kPassThreads)
    tail_pass_kernel(Rows in, int b, int budget, unsigned* ticket,
                     unsigned long long* flags, unsigned long long* groups,
                     T* __restrict__ out) {
  constexpr int kTopics = kPassWarps * kRows;
  __shared__ int stage[kFused ? kBlockCap : 1];
  __shared__ int cnt_s[kTopics];
  __shared__ long long off_s[kTopics];
  __shared__ int wsum[32];
  __shared__ unsigned bid_s;
  __shared__ int nbig_s;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (tid == 0) {
    bid_s = atomicAdd(ticket, 1u);
    nbig_s = 0;
  }
  __syncthreads();
  const unsigned bid = bid_s;
  const int t0 = (int)bid * kTopics + wid;  // row r: topic t0 + r*kPassWarps
  uint4 v0[kRows];
  int cnt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r * kPassWarps;
    v0[r] = make_uint4(0u, 0u, 0u, 0u);
    cnt[r] = 0;
    if (t < b) {
      cnt[r] = count_row(in.words + (size_t)t * in.w, in.w, in.vec, lane, v0[r]);
      if (lane == 0) out[budget + t] = static_cast<T>(cnt[r]);
    }
    if (lane == 0) cnt_s[wid + r * kPassWarps] = cnt[r];
  }
  __syncthreads();
  long long c = 0, x = 0;  // warp 0: a topic's count and inclusive scan
  if (wid == 0) {
    c = lane < kTopics ? cnt_s[lane] : 0;
    x = warp_incl_scan64(c, lane);
    const long long agg = __shfl_sync(kFull, x, 31);
    if (lane == 0) publish(flags, groups, bid, agg);
  }
  // While the blocks before this one publish: each warp's topics of at most
  // 32 routes gathered and sorted as if the budget kept them whole.
  int spec[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r * kPassWarps;
    spec[r] = INT_MAX;
    if constexpr (kFused) {
      if (t < b && cnt[r] > 0 && cnt[r] <= 32) spec[r] = sorted_fid(in, t, v0[r], cnt[r], lane);
    }
  }
  if (wid == 0) {
    const long long base = prefix(flags, groups, bid, lane);
    if (lane < kTopics) off_s[lane] = base + x - c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r * kPassWarps;
    if (t < b) {
      const long long off = off_s[wid + r * kPassWarps];
      const int k = kept(budget, off, cnt[r]);
      if constexpr (kFused) {
        if (k > 0 && k == cnt[r] && k <= 32) {
          if (lane < k) out[off + lane] = spec[r];
        } else if (k > kWarpCap) {
          if (lane == 0) atomicAdd(&nbig_s, 1);
        } else if (k > 0) {
          place_fused_warp(in, t, v0[r], k, off, stage + wid * kWarpCap, lane, out);
        }
      } else if (k > 0) {
        place_global_warp(in, t, v0[r], k, off, lane, out);
      }
    }
  }
  if constexpr (kFused) {
    __syncthreads();
    if (nbig_s) {  // uniform: the block takes its big topics in turn
      for (int q = 0; q < kTopics; ++q) {
        const int tq = (int)bid * kTopics + q;
        if (tq >= b) break;
        const int k = kept(budget, off_s[q], cnt_s[q]);
        if (k > kWarpCap) place_fused_block(in, tq, k, off_s[q], stage, kBlockCap, wsum, out);
      }
    }
  }
}

// The small path's fused kernel may stage up to 64 KB a block: allowed
// once a device.
int allow_small_stage() {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(tail_small_kernel<true, int>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmallBudget * 4);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

// Blocks of the one-topic pass the card holds at once (its occupancy times
// the SMs), once a device. A grid of more blocks would run in waves, each a
// full chain of dependent memory round trips: there the pass takes
// kPassRowsMax topics a warp, so that the whole grid runs in one.
template <bool kFused, typename T>
int one_wave(int* blocks) {
  static int wave[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (wave[dev] == 0) {
    int per = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, tail_pass_kernel<kFused, T, 1>,
                                                      kPassThreads, 0);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    wave[dev] = per * sms > 0 ? per * sms : 1;
  }
  *blocks = wave[dev];
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The launch of either tail on either path; `smem` is the small path's stage.
template <bool kFused, typename T>
int launch(const Rows& in, int b, int budget, T* out, size_t smem, cudaStream_t st) {
  if (small_path(b, budget)) {
    const int blocks = (b + kSmallWarps - 1) / kSmallWarps;
    tail_small_kernel<kFused, T><<<blocks, kSmallThreads, smem, st>>>(in, b, budget, out);
    return (int)cudaGetLastError();
  }
  int wave = 0;
  int err = one_wave<kFused, T>(&wave);
  if (err) return err;
  char* scratch = reinterpret_cast<char*>(out) + scratch_at(b, budget, sizeof(T));
  const size_t zeroed = scratch + scratch_bytes(b) - reinterpret_cast<char*>(out);
  cudaError_t e = cudaMemsetAsync(out, 0, zeroed, st);
  if (e != cudaSuccess) return (int)e;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* flags = reinterpret_cast<unsigned long long*>(scratch + 16);
  unsigned long long* groups = flags + pass_blocks(b);
  if (pass_blocks(b) <= wave) {
    tail_pass_kernel<kFused, T, 1><<<pass_blocks(b), kPassThreads, 0, st>>>(
        in, b, budget, ticket, flags, groups, out);
  } else {
    tail_pass_kernel<kFused, T, kPassRowsMax>
        <<<pass_blocks(b, kPassRowsMax), kPassThreads, 0, st>>>(in, b, budget, ticket,
                                                                 flags, groups, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes a call needs past its wire, from the wire's end rounded up to 16
// bytes: 0 on the small path.
extern "C" int compact_tail_scratch_bytes(int b, int budget) {
  if (b < 0 || budget < 0) return -1;
  if (small_path(b, budget)) return 0;
  const size_t n = scratch_bytes(b);
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// out: the wire [budget + b] int32, then compact_tail_scratch_bytes(b, budget)
// bytes at the next 16-byte boundary.
extern "C" int launch_fused_compact_decode(const int* words, int w,
                                           const int* fid_rows, int fid_chunks,
                                           const int* chunk_ids, int nc, int b,
                                           int budget, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 0 || w < 0 || nc < 0 || budget < 0 || fid_chunks <= 0 ||
      w != nc * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) {
    return budget ? (int)cudaMemsetAsync(out, 0, (size_t)budget * 4, st) : 0;
  }
  if (small_path(b, budget)) {
    const int err = allow_small_stage();
    if (err) return err;
  }
  const unsigned* w32 = reinterpret_cast<const unsigned*>(words);
  const Rows in{w32, w, (w & 3) == 0 && aligned16(w32), fid_rows,
                (long long)fid_chunks * kChunk, chunk_ids, nc};
  return launch<true>(in, b, budget, out, (size_t)budget * 4, st);
}

// out: the wire [budget + b] of 16-bit (wide = 0) or 32-bit values, then
// compact_tail_scratch_bytes(b, budget) bytes at the next 16-byte boundary.
extern "C" int launch_compact_global(const int* words, int w, int b,
                                     int budget, void* out, int wide,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 0 || w < 0 || budget < 0 || wide != ((long long)w * 32 >= 0x10000)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elem = wide ? 4 : 2;
  if (b == 0) {
    return budget ? (int)cudaMemsetAsync(out, 0, (size_t)budget * elem, st) : 0;
  }
  const unsigned* w32 = reinterpret_cast<const unsigned*>(words);
  const Rows in{w32, w, (w & 3) == 0 && aligned16(w32), nullptr, 0, nullptr, 0};
  if (wide) return launch<false>(in, b, budget, static_cast<int*>(out), 0, st);
  return launch<false>(in, b, budget, static_cast<unsigned short*>(out), 0, st);
}
