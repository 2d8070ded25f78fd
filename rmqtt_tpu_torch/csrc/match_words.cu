// Partitioned-match words kernels for Hopper (sm_90a).
//
// What they replace. Two Pallas TPU kernels of the JAX package:
//   - launch_match_words_packed replaces rmqtt_tpu/ops/pallas_match.py:288
//     match_words_pallas_packed (body _kernel_packed): bit-packed tiles
//     [up_chunks, groups*128] int32, four byte planes per int32 lane, row r
//     of group g in lane g*128 + r.
//   - launch_match_words_legacy replaces rmqtt_tpu/ops/pallas_match.py:141
//     match_words_pallas (body _kernel): field-major tiles
//     [up_chunks, L+3, 128] int16 or int32 (L token rows, flen, prefix_len,
//     flags bit0 has_hash / bit1 first_wild).
// Both compute, for every topic b and candidate slot k, the 128-row match
// mask of tile chunk_ids[b, k] and pack it into four uint32 words:
// out[b, k*4 + w] bit i = row w*32 + i (the JAX bit order). Ids < 0 or
// >= nchunks give zero words. The plain PyTorch twins are
// rmqtt_tpu_torch/ops/match_words.py match_words_{packed,legacy}_plain.
//
// What bounds them on the H100. A call must read the tiles its candidates
// name (at most the resident table, which fits the 50 MB L2: 8.4 MB packed
// at 1M filters), chunk_ids [B, NC] int32 and the topic tokens, and write
// [B, NC*4] int32 words: at B=16384, NC=32, two packed groups, about
// 19 MB, or ~6 us at 3.35 TB/s. The integer work is ~(2*nlvl+6) operations
// per row of a real slot (chunk id != 0; ~12 of 32 at cfg3), ~5e8 at
// cfg3: ~8 us at the card's 67 T/s FP32 rate, which counts an FMA as two
// operations, but ~30 us at the integer pipe's 64 operations per clock per
// SM (132 SMs at 1.98 GHz, 16.7 T/s). Tiles named by many topics are read
// from L2 many times (~200 MB of L2-to-SM traffic per call at cfg3).
//
// What the design does about each limit.
//   - A warp per topic, not a block per (topic, slot): lane k loads
//     chunk_ids[b, k] in one coalesced load and lane i the topic's token i,
//     broadcast with __shfl_sync; tlen and tdollar once per topic. No
//     shared memory and no __syncthreads. A warp takes at most 32 slots;
//     small batches (the NC split's buckets of 256 topics) spread a topic's
//     slots over up to NC/4 warps so that the grid still fills the card.
//   - Four rows per lane: lane l reads rows 4l..4l+3 of every group (packed)
//     or field (legacy) as one 16-byte (8-byte for int16 fields) load
//     through the read-only path. All of a slot's loads are issued at once:
//     the metadata no longer gates the level loads.
//   - Loads in flight across slots: the next tested slot's loads are issued
//     before the current one is tested, into the other half of a register
//     double buffer.
//   - Padding computed once: a slot's words depend only on the topic and
//     its tile, so a warp tests the first slot that names chunk 0 (the
//     empty chunk that pads every candidate list) and no other: the warp
//     walks a ballot mask of the slots to test, and the copies (and the
//     zero words of out-of-range ids) are filled in when the words are
//     stored.
//   - Fewer integer operations per row (the integer pipe, not memory, is
//     the limit: PERF.md): the packed test runs on byte slices, four rows
//     per 32-bit operation, after a 4x4 byte transpose (__byte_perm) of each
//     group; each level costs ~14 operations for four rows. The legacy test
//     stays one row per operation, branch-free.
//   - The bits gather without a ballot per word or a matmul: each lane
//     shifts its 4 row bits by 4*(lane&7) and three __shfl_xor_sync OR
//     steps leave word w in lanes 8w..8w+7; eight slots' words go out as
//     one coalesced 128-byte store.
//   - Every layout: packed kernels are instances for up to 1, 2, 4, 8 and
//     16 groups (nlvl <= 30); legacy ones for L <= 8 and L <= 16 with the
//     fields in registers, and a general instance for any L that loads the
//     level fields as it tests them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // rows per tile (ops/partitioned.py CHUNK)
constexpr int kWordsPerChunk = kChunk / 32;
constexpr int kPlusTok = 1;  // ops/encode.py PLUS_TOK
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSlotsPerWarp = 32;
constexpr int kMinSlotsPerWarp = 4;
static_assert(kMaxSlotsPerWarp == 32, "WarpWords holds four groups of eight slots");

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The topic as a warp holds it.
struct Topic {
  int tok;          // lane i: level i's token (i < 32)
  const int* row;   // the topic's tokens in global memory
  int tlen;
  int tdollar;       // 0 or 1
};

// Element j (0..3) of a lane's four rows.
__device__ __forceinline__ int elem(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ int elem(const int2& v, int j) {
  const int w = j < 2 ? v.x : v.y;
  return (j & 1) ? (w >> 16) : static_cast<int>(static_cast<int16_t>(w & 0xFFFF));
}

// 0x80 in every byte of x that is zero, 0 in the others (exact: no borrow
// crosses a byte).
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// b (0..255) in every byte.
__device__ __forceinline__ unsigned splat(unsigned b) { return b * 0x01010101u; }

template <typename T> struct Vec4;
template <> struct Vec4<int16_t> { using type = int2; };
template <> struct Vec4<int32_t> { using type = int4; };

// One level of the row test: the filter token equals the topic's, is '+',
// or the level lies beyond the filter's prefix.
__device__ __forceinline__ bool level_ok(int f, int t, int plen, int level) {
  return (f == t) | (f == kPlusTok) | (plen <= level);
}

// The level-independent rest of the row test: the length rule ('#' filters
// need tlen >= prefix, others tlen == flen) and $-topic isolation from
// wildcard-first filters.
__device__ __forceinline__ bool row_accept(bool levels_ok, int flen, int plen,
                                           int hh, int fw, const Topic& t) {
  const bool len_ok = hh ? (t.tlen >= plen) : (t.tlen == flen);
  return levels_ok & len_ok & !(t.tdollar & fw);
}

// ------------------------------------------------------------ packed rows
struct PackedParams {
  const int* tiles;
  int groups;
  int meta_plane;               // planes - 1: the metadata byte plane
  unsigned long long himask;    // bit p: plane p is a 2-byte level's high byte
};

template <int MAXG>
struct PackedRows {
  using Params = PackedParams;
  int4 v[MAXG];  // group g's lanes 4l..4l+3
  // The last group again, which holds the metadata plane: picking it out
  // of v[] by the runtime group count would index v[] dynamically and put
  // it in local memory. This second load hits the same L1 line.
  int4 last;

  __device__ __forceinline__ void load(const Params& p, int cid) {
    const int4* base = reinterpret_cast<const int4*>(
        p.tiles + (size_t)cid * p.groups * kChunk) + lane_id();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < p.groups) v[g] = __ldg(base + g * (kChunk / 4));
    }
    last = __ldg(base + (p.groups - 1) * (kChunk / 4));
  }

  // → the four row results of this lane, bit j = row 4*lane + j. The test
  // runs on byte slices: a 4x4 byte transpose turns each group's int4
  // (row j in component j, plane 4g+k in byte k) into four words, word k
  // holding plane 4g+k of the four rows (row j in byte j), and each level
  // then tests four rows at once. Lengths are kept offset by 3 so that
  // every byte stays in 0..63 (flen >= -1, prefix >= -2).
  __device__ __forceinline__ unsigned test(const Params& p, const Topic& t) const {
    unsigned pt[4 * MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < p.groups) {
        const unsigned a = __byte_perm(v[g].x, v[g].y, 0x5140);
        const unsigned b = __byte_perm(v[g].x, v[g].y, 0x7362);
        const unsigned c = __byte_perm(v[g].z, v[g].w, 0x5140);
        const unsigned d = __byte_perm(v[g].z, v[g].w, 0x7362);
        pt[4 * g] = __byte_perm(a, c, 0x5410);
        pt[4 * g + 1] = __byte_perm(a, c, 0x7632);
        pt[4 * g + 2] = __byte_perm(b, d, 0x5410);
        pt[4 * g + 3] = __byte_perm(b, d, 0x7632);
      } else {
        pt[4 * g] = pt[4 * g + 1] = pt[4 * g + 2] = pt[4 * g + 3] = 0;
      }
    }
    // the metadata byte of the four rows: flen+1 | has_hash<<5 | first_wild<<6
    const unsigned mb = p.meta_plane & 3;
    const unsigned sel = mb | ((mb + 4) << 4);
    const unsigned meta = __byte_perm(__byte_perm(last.x, last.y, sel),
                                      __byte_perm(last.z, last.w, sel), 0x5410);
    const unsigned flen1 = meta & 0x1F1F1F1Fu;
    const unsigned hh = (meta >> 5) & 0x01010101u;
    const unsigned fw = (meta >> 6) & 0x01010101u;
    const unsigned plen3 = flen1 + 0x02020202u - hh;
    // walk the level planes in order; every branch here is warp-uniform
    unsigned fail = 0;  // 0x80 in byte j: a level within row j's prefix failed
    int lvl = 0;
#pragma unroll
    for (int q = 0; q < 4 * MAXG; ++q) {
      if (q < p.meta_plane && !((p.himask >> q) & 1ull)) {
        const int qh = q + 1 < 4 * MAXG ? q + 1 : q;
        const bool wide = qh != q && ((p.himask >> qh) & 1ull);
        const unsigned tk = static_cast<unsigned>(__shfl_sync(kFull, t.tok, lvl));
        const unsigned lo = pt[q];
        unsigned eq_t, eq_plus;
        if (wide) {
          const unsigned hi = pt[qh];
          eq_t = (tk >> 16) ? 0u
                            : zero_bytes(lo ^ splat(tk & 0xFF)) &
                                  zero_bytes(hi ^ splat(tk >> 8));
          eq_plus = zero_bytes(lo ^ splat(kPlusTok)) & zero_bytes(hi);
        } else {
          eq_t = (tk >> 8) ? 0u : zero_bytes(lo ^ splat(tk));
          eq_plus = zero_bytes(lo ^ splat(kPlusTok));
        }
        // bytes whose prefix covers this level: prefix + 3 >= lvl + 4
        const unsigned within = ((plen3 | 0x80808080u) - splat(lvl + 4)) & 0x80808080u;
        fail |= within & ~(eq_t | eq_plus);
        ++lvl;
      }
    }
    // the length rule and $-topic isolation, also four rows at once
    const unsigned tl3 = splat(static_cast<unsigned>(min(max(t.tlen, -3), 60) + 3));
    const unsigned ge = ((tl3 | 0x80808080u) - plen3) & 0x80808080u;  // tlen >= prefix
    const unsigned eq = zero_bytes((flen1 + 0x02020202u) ^ tl3);      // tlen == flen
    const unsigned hash = hh << 7;
    const unsigned len_ok = (ge & hash) | (eq & ~hash);
    const unsigned ok = len_ok & ~fail & ~(t.tdollar ? fw << 7 : 0u);
    return ((ok >> 7) * 0x10204080u) >> 28;  // byte j's 0x80 -> bit j
  }
};

// ------------------------------------------------------------ legacy rows
template <typename T>
struct LegacyParams {
  const T* tiles;
  int lvl;
};

// MAXL > 0: the L <= MAXL level fields sit in registers. MAXL == 0: any L;
// only flen / prefix_len / flags are prefetched, the level fields are
// loaded as they are tested.
template <typename T, int MAXL>
struct LegacyRows {
  using Params = LegacyParams<T>;
  using Vec = typename Vec4<T>::type;
  const Vec* base;
  Vec meta[3];  // flen, prefix_len, flags
  Vec lv[MAXL > 0 ? MAXL : 1];

  __device__ __forceinline__ void load(const Params& p, int cid) {
    base = reinterpret_cast<const Vec*>(
        p.tiles + (size_t)cid * (p.lvl + 3) * kChunk) + lane_id();
#pragma unroll
    for (int f = 0; f < 3; ++f) meta[f] = __ldg(base + (p.lvl + f) * (kChunk / 4));
    if constexpr (MAXL > 0) {
#pragma unroll
      for (int i = 0; i < MAXL; ++i) {
        if (i < p.lvl) lv[i] = __ldg(base + i * (kChunk / 4));
      }
    }
  }

  __device__ __forceinline__ unsigned test(const Params& p, const Topic& t) const {
    int plen[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      plen[j] = elem(meta[1], j);
      ok[j] = true;
    }
    if constexpr (MAXL > 0) {
#pragma unroll
      for (int i = 0; i < MAXL; ++i) {
        if (i < p.lvl) {
          const int tk = __shfl_sync(kFull, t.tok, i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ok[j] &= level_ok(elem(lv[i], j), tk, plen[j], i);
          }
        }
      }
    } else {
      for (int i = 0; i < p.lvl; ++i) {
        const Vec x = __ldg(base + i * (kChunk / 4));
        const int tk = __ldg(t.row + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ok[j] &= level_ok(elem(x, j), tk, plen[j], i);
        }
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int flags = elem(meta[2], j);
      bits |= static_cast<unsigned>(row_accept(ok[j], elem(meta[0], j), plen[j],
                                               flags & 1, (flags & 2) != 0, t))
              << j;
    }
    return bits;
  }
};

// --------------------------------------------------------------- the warp
// Four row bits per lane → word w in lanes 8w..8w+7 (bit i = row 32w + i).
__device__ __forceinline__ int gather_word(unsigned bits4) {
  unsigned x = bits4 << (4 * (lane_id() & 7));
  x |= __shfl_xor_sync(kFull, x, 1);
  x |= __shfl_xor_sync(kFull, x, 2);
  x |= __shfl_xor_sync(kFull, x, 4);
  return static_cast<int>(x);
}

// A warp's words: lane L holds word L&3 of slot 8k + (L>>2) in acc k.
// Four named registers, not an array: a store into an array at a
// runtime slot index would put the array in local memory.
struct WarpWords {
  int acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  int zword = 0;  // lane L: word L&3 of chunk 0, once a slot has computed it

  __device__ __forceinline__ int acc(int k) const {
    return k == 0 ? acc0 : k == 1 ? acc1 : k == 2 ? acc2 : acc3;
  }

  // File slot s's word (word w in lanes 8w..8w+7) where it belongs.
  __device__ __forceinline__ void put(int s, int cid, int word) {
    const int lane = lane_id();
    const int v = __shfl_sync(kFull, word, (lane & 3) * 8);
    if ((lane >> 2) == (s & 7)) {
      const int k = s >> 3;
      acc0 = k == 0 ? v : acc0;
      acc1 = k == 1 ? v : acc1;
      acc2 = k == 2 ? v : acc2;
      acc3 = k == 3 ? v : acc3;
    }
    if (cid == 0) zword = v;
  }
};

// Test slot s, whose tile is in `cur`, after issuing the loads of the next
// slot to test (taken from `todo`) into `next`. → that next slot, or -1.
template <class Rows>
__device__ __forceinline__ int step(const typename Rows::Params& prm,
                                    const Topic& t, int my_cid, int s,
                                    unsigned& todo, Rows& cur, Rows& next,
                                    WarpWords& ww) {
  const int s2 = todo ? __ffs(todo) - 1 : -1;
  todo &= todo - 1;
  if (s2 >= 0) next.load(prm, __shfl_sync(kFull, my_cid, s2));
  ww.put(s, __shfl_sync(kFull, my_cid, s), gather_word(cur.test(prm, t)));
  return s2;
}

// Warp w serves topic w / split, slots [part*per, part*per + per). It tests
// only the slots whose id is in range and is not a repeat of chunk 0, with
// the next slot's loads in flight, then stores all its slots' words: eight
// slots (32 words) per 128-byte store.
template <class Rows>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
match_words_kernel(typename Rows::Params prm, int nchunks,
                   const int* __restrict__ ttok, int nlvl,
                   const int* __restrict__ tlen,
                   const int* __restrict__ tdollar,
                   const int* __restrict__ chunk_ids, int nb, int nc,
                   int split, int per, int* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)nb * split) return;  // the whole warp leaves together
  const int lane = lane_id();
  const int b = warp / split;
  const int k0 = (warp - b * split) * per;
  const int n = min(nc - k0, per);
  if (n <= 0) return;
  Topic t;
  t.row = ttok + (size_t)b * nlvl;
  t.tok = lane < nlvl ? __ldg(t.row + lane) : 0;
  t.tlen = __ldg(tlen + b);
  t.tdollar = __ldg(tdollar + b) != 0;
  const int my_cid = lane < n ? __ldg(chunk_ids + (size_t)b * nc + k0 + lane) : -1;
  const unsigned zeros = __ballot_sync(kFull, my_cid == 0);
  const int first0 = zeros ? __ffs(zeros) - 1 : -1;
  const bool in_range = my_cid >= 0 && my_cid < nchunks;
  const unsigned tested = __ballot_sync(kFull, in_range && (my_cid != 0 || lane == first0));

  WarpWords ww;
  Rows r0, r1;
  unsigned todo = tested;
  int s = todo ? __ffs(todo) - 1 : -1;
  todo &= todo - 1;
  if (s >= 0) r0.load(prm, __shfl_sync(kFull, my_cid, s));
  while (s >= 0) {
    s = step(prm, t, my_cid, s, todo, r0, r1, ww);
    if (s < 0) break;
    s = step(prm, t, my_cid, s, todo, r1, r0, ww);
  }
  // copies of chunk 0 take its words; out-of-range ids give zeros
  int* orow = out + ((size_t)b * nc + k0) * kWordsPerChunk;
#pragma unroll
  for (int k = 0; k < kMaxSlotsPerWarp / 8; ++k) {
    const int slot = 8 * k + (lane >> 2);
    const int cid = __shfl_sync(kFull, my_cid, slot);
    if (8 * k < n) {
      const int w = ((tested >> slot) & 1) ? ww.acc(k)
                    : (cid == 0 && nchunks > 0) ? ww.zword : 0;
      if (slot < n) orow[8 * k * kWordsPerChunk + lane] = w;
    }
  }
}

// Slots per warp for a (B, NC) call: at most 32; fewer (down to 4) while
// the grid would hold less than 32 warps per SM.
int slots_per_warp(int b, int nc) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long target = 32LL * sms;
  int per = nc < kMaxSlotsPerWarp ? nc : kMaxSlotsPerWarp;
  while (per > kMinSlotsPerWarp &&
         (long long)b * ((nc + per - 1) / per) < target) {
    per = (per + 1) / 2;
  }
  return per;
}

template <class Rows>
int launch(const typename Rows::Params& prm, int nchunks, const int* ttok,
           int nlvl, const int* tlen, const int* tdollar, const int* chunk_ids,
           int b, int nc, int* out, void* stream) {
  const int per = slots_per_warp(b, nc);
  const int split = (nc + per - 1) / per;
  const long long warps = (long long)b * split;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  match_words_kernel<Rows><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      prm, nchunks, ttok, nlvl, tlen, tdollar, chunk_ids, b, nc, split, per, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_legacy(const T* tiles, int nchunks, int lvl, const int* ttok,
                  const int* tlen, const int* tdollar, const int* chunk_ids,
                  int b, int nc, int* out, void* stream) {
  const LegacyParams<T> prm{tiles, lvl};
  if (lvl <= 8)
    return launch<LegacyRows<T, 8>>(prm, nchunks, ttok, lvl, tlen, tdollar,
                                    chunk_ids, b, nc, out, stream);
  if (lvl <= 16)
    return launch<LegacyRows<T, 16>>(prm, nchunks, ttok, lvl, tlen, tdollar,
                                     chunk_ids, b, nc, out, stream);
  return launch<LegacyRows<T, 0>>(prm, nchunks, ttok, lvl, tlen, tdollar,
                                  chunk_ids, b, nc, out, stream);
}

}  // namespace

// Launchers: plain C interface for ctypes. Every pointer is a device
// pointer; the caller allocates out [b, nc*4] int32. Each returns
// cudaGetLastError() after the launch (0 = launched).

extern "C" int launch_match_words_packed(const int* tiles, int nchunks,
                                         int groups, const int* ttok,
                                         int nlvl, int wide_mask,
                                         int meta_plane, const int* tlen,
                                         const int* tdollar,
                                         const int* chunk_ids, int b, int nc,
                                         int* out, void* stream) {
  if (b <= 0 || nc <= 0) return 0;
  // the high-byte planes of the 2-byte levels; planes then meta_plane + 1
  unsigned long long himask = 0;
  int q = 0;
  for (int i = 0; i < nlvl; ++i) {
    ++q;
    if ((wide_mask >> i) & 1) himask |= 1ull << q++;
  }
  if (nlvl < 0 || nlvl > 30 || q != meta_plane || groups != (q + 4) / 4 ||
      groups > 16) {
    return (int)cudaErrorInvalidValue;
  }
  const PackedParams prm{tiles, groups, meta_plane, himask};
#define RMQTT_PACKED_LAUNCH(G)                                              \
  return launch<PackedRows<G>>(prm, nchunks, ttok, nlvl, tlen, tdollar,    \
                               chunk_ids, b, nc, out, stream)
  if (groups <= 1) RMQTT_PACKED_LAUNCH(1);
  if (groups <= 2) RMQTT_PACKED_LAUNCH(2);
  if (groups <= 4) RMQTT_PACKED_LAUNCH(4);
  if (groups <= 8) RMQTT_PACKED_LAUNCH(8);
  RMQTT_PACKED_LAUNCH(16);
#undef RMQTT_PACKED_LAUNCH
}

extern "C" int launch_match_words_legacy(const void* tiles, int tile_bytes,
                                         int nchunks, int lvl,
                                         const int* ttok, const int* tlen,
                                         const int* tdollar,
                                         const int* chunk_ids, int b, int nc,
                                         int* out, void* stream) {
  if (b <= 0 || nc <= 0) return 0;
  if (tile_bytes == 2) {
    return launch_legacy(static_cast<const int16_t*>(tiles), nchunks, lvl, ttok,
                         tlen, tdollar, chunk_ids, b, nc, out, stream);
  }
  if (tile_bytes == 4) {
    return launch_legacy(static_cast<const int32_t*>(tiles), nchunks, lvl, ttok,
                         tlen, tdollar, chunk_ids, b, nc, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
