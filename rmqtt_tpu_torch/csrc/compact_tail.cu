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
// each topic's few fids (~8-16 a topic at cfg3): far below the integer rate.
// What the twins paid was launches (~70 a batch: a SWAR popcount, two
// 64-bit cumsums, four scatters, [budget, 32] int64 expansions, a 64-bit
// sort), not bytes.
//
// What the design does about it. Four launches (three for compact_global),
// each a pass the data needs:
//   1. count: a warp a topic, 16-byte loads of its words, __popc, a warp sum
//      -> the counts, written to the scratch and to the wire's tail;
//   2. scan: one block of 1024 threads scans the B counts (eight a thread,
//      a warp scan, a scan of the warp sums, a carry between rounds) into
//      64-bit offsets and the total; it lists the topics too big for a warp;
//   3. place: a warp a topic walks its words 32 at a time, a warp scan of
//      their popcounts gives each set bit its route index, and the first k_t
//      routes go (as fids, after the gather through the chunk ids and the
//      fid map) into the warp's 4 KB of shared memory, which a bitonic
//      network sorts; the warp writes them to [off_t, off_t + k_t). The same
//      grid zero-fills [min(n, budget), budget). compact_global's place has
//      no gather and no sort: its lanes write word*32 + bit straight to the
//      wire;
//   4. big: there is no upper bound on a topic's routes (NC grows as a
//      sticky power of two, so a topic can match NC*128 rows). A topic of
//      more than kWarpCap kept routes gets a block of 1024 threads of a
//      persistent grid: a block scan over 1024 words at a time gathers its
//      fids into 128 KB of dynamic shared memory and a bitonic network sorts
//      them there; past 32,768 routes the fids go straight to their place in
//      the wire and the block sorts them there: tiles of 32,768 in shared
//      memory, then the merge steps of strides >= 32,768 in global memory
//      and the smaller ones tile by tile in shared memory again. The
//      network puts the minimum at the lower index in every compare, so
//      the padding to a power of two is virtual (a pair whose upper index
//      is past the end is skipped).
// A set bit under a chunk id outside the fid map reads the nearest row of
// the map (the words kernels give such ids no bits).
//
// Scratch, laid out by the launchers ([B] each): int64 offsets, int32
// counts, int32 big-topic list, then the int64 total and the int32 count of
// big topics: compact_tail_scratch_bytes(B) bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // rows per tile (ops/partitioned.py CHUNK)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountWarps = 8;     // count: 256 threads, a warp a topic
constexpr int kPlaceWarps = 4;     // place: 128 threads, a warp a topic
constexpr int kWarpCap = 1024;     // kept routes a warp sorts (4 KB a warp)
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;      // counts a scan thread takes a round
constexpr int kBigThreads = 1024;
constexpr int kBigCap = 32768;     // fids a block sorts in shared memory
constexpr int kBigSmem = kBigCap * 4;

struct Scratch {
  long long* offs;
  int* cnts;
  int* big;
  long long* total;
  int* nbig;
};

__host__ __device__ inline size_t scratch_bytes(int b) {
  return (size_t)b * 16 + 16;
}

inline Scratch scratch_of(void* base, int b) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.offs = reinterpret_cast<long long*>(p);
  s.cnts = reinterpret_cast<int*>(p + (size_t)b * 8);
  s.big = reinterpret_cast<int*>(p + (size_t)b * 12);
  s.total = reinterpret_cast<long long*>(p + (size_t)b * 16);
  s.nbig = reinterpret_cast<int*>(p + (size_t)b * 16 + 8);
  return s;
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

// ------------------------------------------------------------ sorting
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
__device__ void sort_net(int* s, int k, int tid, int nt) {
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
__device__ void sort_global(int* g, int k, int* sm, int cap) {
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

// ------------------------------------------------------------ kernels
template <typename T>
__global__ void __launch_bounds__(kCountWarps * 32)
    count_kernel(const unsigned* __restrict__ words, int w, int b, bool vec,
                 int* __restrict__ cnts, T* __restrict__ out_cnts) {
  const int t = blockIdx.x * kCountWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= b) return;  // the whole warp
  const unsigned* row = words + (size_t)t * w;
  int c = 0;
  if (vec) {  // w % 4 == 0 and 16-byte aligned rows
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int i = lane; i < (w >> 2); i += 32) {
      uint4 v = __ldg(r4 + i);
      c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
  } else {
    for (int i = lane; i < w; i += 32) c += __popc(__ldg(row + i));
  }
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if (lane == 0) {
    cnts[t] = c;
    out_cnts[t] = static_cast<T>(c);
  }
}

// One block: offsets = the exclusive scan of the counts, the total, and
// (big_cap >= 0) the list of topics that keep more than big_cap routes.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ cnts, int b, long long budget,
                int big_cap, long long* __restrict__ offs,
                long long* __restrict__ total, int* __restrict__ big,
                int* __restrict__ nbig) {
  __shared__ long long wsum[32];
  __shared__ long long carry;
  __shared__ int nbig_s;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  if (tid == 0) {
    carry = 0;
    nbig_s = 0;
  }
  __syncthreads();
  const int per_round = blockDim.x * kScanItems;
  for (int base = 0; base < b; base += per_round) {
    const int first = base + tid * kScanItems;
    int c[kScanItems];
    long long mine = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      c[q] = first + q < b ? cnts[first + q] : 0;
      mine += c[q];
    }
    long long x = warp_incl_scan64(mine, lane);
    if (lane == 31) wsum[wid] = x;
    __syncthreads();
    if (wid == 0) {
      long long s = lane < nw ? wsum[lane] : 0;
      wsum[lane] = warp_incl_scan64(s, lane);
    }
    __syncthreads();
    long long off = carry + (wid ? wsum[wid - 1] : 0) + x - mine;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      if (first + q < b) {
        offs[first + q] = off;
        if (big_cap >= 0 && kept(budget, off, c[q]) > big_cap) {
          big[atomicAdd(&nbig_s, 1)] = first + q;
        }
      }
      off += c[q];
    }
    __syncthreads();
    if (tid == 0) carry += wsum[nw - 1];
    __syncthreads();
  }
  if (tid == 0) {
    *total = carry;
    if (nbig) *nbig = nbig_s;
  }
}

// The whole grid zero-fills the wire's slots [min(n, budget), budget).
template <typename T>
__device__ __forceinline__ void zero_tail(T* out, long long budget,
                                          const long long* total) {
  long long n = *total;
  long long lo = n < budget ? n : budget;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < budget; i += step) {
    out[i] = 0;
  }
}

__global__ void __launch_bounds__(kPlaceWarps * 32)
    place_fused_kernel(const unsigned* __restrict__ words, int w,
                       const int* __restrict__ fid_rows, long long nrows,
                       const int* __restrict__ chunk_ids, int nc, int b,
                       long long budget, Scratch sc, int* __restrict__ out) {
  __shared__ int buf[kPlaceWarps][kWarpCap];
  zero_tail(out, budget, sc.total);
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kPlaceWarps + wib;
  if (t >= b) return;  // the whole warp
  const long long off = sc.offs[t];
  const int k = kept(budget, off, sc.cnts[t]);
  if (k == 0 || k > kWarpCap) return;  // the big kernel takes k > kWarpCap
  const unsigned* row = words + (size_t)t * w;
  const int* cid = chunk_ids + (size_t)t * nc;
  int* s = buf[wib];
  int run = 0;  // routes of the words before this window
  for (int base = 0; base < w && run < k; base += 32) {
    const int j = base + lane;
    const unsigned v = j < w ? __ldg(row + j) : 0u;
    const int pc = __popc(v);
    const int x = warp_incl_scan(pc, lane);
    int idx = run + x - pc;
    if (v != 0u && idx < k) {
      const long long rowbase =
          (long long)__ldg(cid + (j >> 2)) * kChunk + (j & 3) * 32;
      unsigned m = v;
      while (m != 0u && idx < k) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        s[idx++] = fid_of(fid_rows, nrows, rowbase, bit);
      }
    }
    run += __shfl_sync(kFull, x, 31);
  }
  __syncwarp();
  sort_net<false>(s, k, lane, 32);
  for (int i = lane; i < k; i += 32) out[off + i] = s[i];
}

// A persistent grid over the listed big topics, a block each.
__global__ void __launch_bounds__(kBigThreads)
    place_fused_big_kernel(const unsigned* __restrict__ words, int w,
                           const int* __restrict__ fid_rows, long long nrows,
                           const int* __restrict__ chunk_ids, int nc,
                           long long budget, Scratch sc, int* __restrict__ out) {
  extern __shared__ int4 smem_raw[];
  int* sm = reinterpret_cast<int*>(smem_raw);
  __shared__ int wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int nbig = *sc.nbig;
  for (int q = blockIdx.x; q < nbig; q += gridDim.x) {
    const int t = sc.big[q];
    const long long off = sc.offs[t];
    const int k = kept(budget, off, sc.cnts[t]);
    const unsigned* row = words + (size_t)t * w;
    const int* cid = chunk_ids + (size_t)t * nc;
    int* dst = out + off;
    int* buf = k <= kBigCap ? sm : dst;
    int run = 0;
    for (int base = 0; base < w; base += blockDim.x) {
      const int j = base + tid;
      const unsigned v = j < w ? __ldg(row + j) : 0u;
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
      if (v != 0u && idx < k) {
        const long long rowbase =
            (long long)__ldg(cid + (j >> 2)) * kChunk + (j & 3) * 32;
        unsigned m = v;
        while (m != 0u && idx < k) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          buf[idx++] = fid_of(fid_rows, nrows, rowbase, bit);
        }
      }
      run += tot;
      if (run >= k) break;  // uniform: every thread holds the same run
    }
    __syncthreads();
    if (k <= kBigCap) {
      sort_net<true>(sm, k, tid, blockDim.x);
      tile_store(dst, sm, k);
    } else {
      sort_global(dst, k, sm, kBigCap);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kPlaceWarps * 32)
    place_global_kernel(const unsigned* __restrict__ words, int w, int b,
                        long long budget, Scratch sc, T* __restrict__ out) {
  zero_tail(out, budget, sc.total);
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kPlaceWarps + (threadIdx.x >> 5);
  if (t >= b) return;  // the whole warp
  const long long off = sc.offs[t];
  const int k = kept(budget, off, sc.cnts[t]);
  const unsigned* row = words + (size_t)t * w;
  T* dst = out + off;
  int run = 0;
  for (int base = 0; base < w && run < k; base += 32) {
    const int j = base + lane;
    const unsigned v = j < w ? __ldg(row + j) : 0u;
    const int pc = __popc(v);
    const int x = warp_incl_scan(pc, lane);
    int idx = run + x - pc;
    unsigned m = v;
    while (m != 0u && idx < k) {
      const int bit = __ffs(m) - 1;
      m &= m - 1;
      dst[idx++] = static_cast<T>(j * 32 + bit);
    }
    run += __shfl_sync(kFull, x, 31);
  }
}

int blocks_for(long long items, int per_block) {
  return (int)((items + per_block - 1) / per_block);
}

// The place grid: a warp a topic, and at least enough threads to zero-fill
// the unfilled slots in a few strides.
int place_grid(int b, long long budget) {
  long long g = blocks_for(b, kPlaceWarps);
  long long z = blocks_for(budget, kPlaceWarps * 32 * 8);
  if (z > 1024) z = 1024;
  return (int)(g > z ? g : (z > 0 ? z : 1));
}

template <typename T>
int count_and_scan(const unsigned* w32, int w, int b, long long budget,
                   int big_cap, T* out, const Scratch& sc,
                   cudaStream_t st) {
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(w32) & 15) == 0;
  count_kernel<T><<<blocks_for(b, kCountWarps), kCountWarps * 32, 0, st>>>(
      w32, w, b, vec, sc.cnts, out + budget);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, st>>>(sc.cnts, b, budget, big_cap, sc.offs,
                                          sc.total, sc.big,
                                          big_cap >= 0 ? sc.nbig : nullptr);
  return (int)cudaGetLastError();
}

// Per device: the big kernel's 128 KB of dynamic shared memory allowed, and
// the SM count its persistent grid covers.
int big_setup(int* nsm) {
  static int sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(place_fused_big_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBigSmem);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = n > 0 ? n : 1;
  }
  *nsm = sms[dev];
  return 0;
}

}  // namespace

extern "C" int compact_tail_scratch_bytes(int b) {
  return b < 0 ? -1 : (int)scratch_bytes(b);
}

extern "C" int launch_fused_compact_decode(const int* words, int w,
                                           const int* fid_rows, int fid_chunks,
                                           const int* chunk_ids, int nc, int b,
                                           int budget, int* out, void* scratch,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 0 || w < 0 || nc < 0 || budget < 0 || fid_chunks <= 0 ||
      w != nc * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) {
    return budget ? (int)cudaMemsetAsync(out, 0, (size_t)budget * 4, st) : 0;
  }
  int nsm = 0;
  int err = big_setup(&nsm);
  if (err) return err;
  const Scratch sc = scratch_of(scratch, b);
  const unsigned* w32 = reinterpret_cast<const unsigned*>(words);
  err = count_and_scan<int>(w32, w, b, budget, kWarpCap, out, sc, st);
  if (err) return err;
  const long long nrows = (long long)fid_chunks * kChunk;
  place_fused_kernel<<<place_grid(b, budget), kPlaceWarps * 32, 0, st>>>(
      w32, w, fid_rows, nrows, chunk_ids, nc, b, budget, sc, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  place_fused_big_kernel<<<b < nsm ? b : nsm, kBigThreads, kBigSmem, st>>>(
      w32, w, fid_rows, nrows, chunk_ids, nc, budget, sc, out);
  return (int)cudaGetLastError();
}

extern "C" int launch_compact_global(const int* words, int w, int b,
                                     int budget, void* out, int wide,
                                     void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 0 || w < 0 || budget < 0 || wide != ((long long)w * 32 >= 0x10000)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elem = wide ? 4 : 2;
  if (b == 0) {
    return budget ? (int)cudaMemsetAsync(out, 0, (size_t)budget * elem, st) : 0;
  }
  const Scratch sc = scratch_of(scratch, b);
  const unsigned* w32 = reinterpret_cast<const unsigned*>(words);
  const int grid = place_grid(b, budget);
  if (wide) {
    int* o = static_cast<int*>(out);
    int err = count_and_scan<int>(w32, w, b, budget, -1, o, sc, st);
    if (err) return err;
    place_global_kernel<int><<<grid, kPlaceWarps * 32, 0, st>>>(w32, w, b,
                                                                budget, sc, o);
  } else {
    unsigned short* o = static_cast<unsigned short*>(out);
    int err = count_and_scan<unsigned short>(w32, w, b, budget, -1, o, sc, st);
    if (err) return err;
    place_global_kernel<unsigned short><<<grid, kPlaceWarps * 32, 0, st>>>(
        w32, w, b, budget, sc, o);
  }
  return (int)cudaGetLastError();
}
