// Retained-scan words kernels for Hopper (sm_90a): SUBSCRIBE's inverse match.
//
// What they replace. Two XLA device programs of the JAX package (it wrote
// no Pallas kernel for this path):
//   - launch_retained_scan_gather replaces
//     rmqtt_tpu/ops/retained_part.py:181 retained_scan_words_impl, the
//     narrow tier: for every filter b and candidate slot k, the 128 rows of
//     tile chunk_ids[b, k];
//   - launch_retained_scan_full replaces rmqtt_tpu/ops/retained_part.py:234
//     retained_scan_full_impl, the broad tier: every filter against every
//     tile of the table, word index = global row word.
// The rows are stored retained TOPICS in the legacy field-major tiles
// [up_chunks, L+3, 128] int16 or int32 (pack_device_rows): L token rows,
// rlen (the topic's level count; padding and cleared rows have <= 0),
// prefix_len (unused here) and flags (bit 1: a $-topic). The query is a
// wildcard FILTER: ftok [B, L] ('+' = PLUS_TOK, levels past the filter
// PAD_TOK), flen, fprefix (levels before a trailing '#'), fhash, fwild
// (its first level is '+' or '#'), all int32. Row r matches filter b iff
//   every level i < min(L, fprefix): rtok == ftok or ftok == '+',
//   fhash ? rlen >= fprefix : rlen == flen,
//   !(row is a $-topic and the filter starts with a wildcard),
//   rlen >= 1 (a bare '#' has fprefix 0 and must not match empty rows).
// Words: bit i of word w = row 32w + i, the JAX bit order. Gather: out
// [B, NC*4], word k*4 + w for slot k; ids < 0 or >= nchunks give zero
// words. Full: out [B, up_chunks*4], word c*4 + w for tile c. The plain
// PyTorch twins are rmqtt_tpu_torch/ops/retained_part.py
// retained_scan_words_plain and retained_scan_full_plain.
//
// What bounds them on the H100 at the real shapes. cfg5's retained side
// holds 1M topics in 8,192 int16 tiles (7,307 live, L = 8). A broad scan
// must read, of every live tile, the rows its filters test (rlen, flags
// for a wildcard-first filter, the token rows of literal levels; the
// broad filters compare at most level 0: 3 of the 11 rows) and write
// B x 128 KB of words: ~7.3 MB, 2.2 us at 3.35 TB/s, for the 13 broad
// filters of a 64-filter batch; counted at ~6 + 2 per literal level
// integer operations a (filter, 32-bit word) test, a word holding two
// int16 rows, 2.7 us at the integer pipe's 16.7 T/s: bytes and integer
// issue bound the batch about alike. One broad filter alone (a
// SUBSCRIBE's scan) is 1.2 us of bytes. The gather tier reads a few
// distinct tiles per filter (the rest of each list is chunk 0): well
// under a microsecond of bytes, so launch, the chain of dependent loads
// and the grid's fill bound it.
//
// What the design does about each limit.
//   - 16-byte row loads through the read-only path, a lane's rows
//     consecutive. Full: four loads of a field row a lane, 32 int16 rows
//     (one word; a warp covers 8 tiles) or 16 int32 rows (two lanes a
//     word; 4 tiles). Gather: one load, 8 int16 rows (4 int32), so a warp
//     tests two int16 slots (one int32) a step.
//   - Two int16 rows per 32-bit operation: a (filter, row) test XORs the
//     tile's rlen and literal token rows with the filter's values packed
//     into both halves, ORs the differences and finds the zero halves once
//     (bit 15 of each half, no carry crosses a half); '#' filters add one
//     subtraction for rlen >= fprefix. Values that do not fit in 16 bits
//     are settled before any row is read: a literal token outside int16,
//     flen outside 1..32767 or fprefix past 32767 match no row (the
//     filter's words are zero), never a truncated value. int32 tiles stay
//     one row per operation.
//   - Filter-independent work once per tile: live (rlen >= 1) and live and
//     not a $-topic, shared by every filter the warp tests on the tile.
//   - Per-filter work once: a full block stages its filters in shared
//     memory once (tokens and a descriptor: the length compare, the mode,
//     the literal levels), with no atomics. A gather warp loads its filter
//     once (lane i level i, broadcast with __shfl_sync) for all its slots.
//   - Only the rows a test needs: rlen; flags for a wildcard-first filter;
//     the token rows of literal levels. The full kernel reads flags always:
//     issued with rlen before the filters are known, one more row in
//     parallel rather than a round trip after them.
//   - Loads in flight. Full: a warp issues its tiles' rlen and flags loads
//     first and stages the filters while they fly; a test reads the token
//     rows it compares (the first from memory, the rest from L1). Gather:
//     the literal token rows are loaded with rlen and flags into
//     registers, every load of a step at once. A step's loads do not
//     overlap the last step's test: a register double buffer that did
//     took more registers and measured slower at both real shapes.
//   - The grid fills the card at any batch. Full: a block serves a split
//     of the filters over 8 warps' tiles; the filters are split over more
//     blocks while the grid holds less than 16 warps per SM, so one
//     filter's scan spans the card (1,024 warps over 8,192 tiles). Gather:
//     a warp takes up to 32 slots of one filter, halved while the grid
//     still fits one wave, so one filter's list spreads over many warps.
//   - Chunk 0 tested once: a slot's words depend only on its filter and
//     tile, so a gather warp tests the first slot naming chunk 0 (the
//     empty chunk that pads every list) and copies its words to the rest.
//   - No ballot per word: each lane packs its row bits, shifts them into
//     place and __shfl_xor_sync ORs the lanes of a word (none for a full
//     int16 lane, which holds a whole word). A full warp stores a filter's
//     words of its tiles as one 128-byte store (int32: 64 bytes); a gather
//     step stores each tested slot's 16 bytes of words, and the warp then
//     stores the copies of chunk 0 and the zero words, 8 slots a store.
//   - One row test for both kernels (lane_word), over the loads a lane
//     makes of a field row; no atomics; every word has one writer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // rows per tile (ops/partitioned.py CHUNK)
constexpr int kWordsPerChunk = kChunk / 32;
constexpr int kPlusTok = 1;  // ops/encode.py PLUS_TOK
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherWarps = 4;  // warps per gather block
constexpr int kFullWarps = 8;    // warps per full block
constexpr int kWarpsPerSm = 16;  // the grid both kernels aim for
constexpr int kMaxStageBytes = 48 * 1024;  // static shared-memory limit

// Filter modes.
constexpr int kHash = 1;   // trailing '#': rlen >= fprefix, else rlen == flen
constexpr int kWild = 2;   // starts with a wildcard: $-topics never match
constexpr int kNever = 4;  // matches no row of these tiles

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// How a warp covers tiles: a lane reads VECS 16-byte loads of a field
// row, consecutive rows. Full (VECS 4): 32 int16 rows, one word (a warp
// covers 8 tiles), or 16 int32 rows, two lanes a word (4 tiles). Gather
// (VECS 1): 8 int16 rows, four lanes a word (2 tiles), or 4 int32 rows,
// eight lanes a word (1 tile).
template <typename T, int VECS>
struct Geo {
  static constexpr int kVecs = VECS;
  static constexpr int kWords = 4 * VECS;                               // 32-bit words a lane holds
  static constexpr int kRowsPerLane = kWords * 4 / (int)sizeof(T);      // 8*VECS or 4*VECS
  static constexpr int kLanesPerWord = 32 / kRowsPerLane;
  static constexpr int kLanesPerTile = kWordsPerChunk * kLanesPerWord;
  static constexpr int kTilesPerWarp = 32 / kLanesPerTile;
  static constexpr int kRowVec = kChunk * (int)sizeof(T) / 16;          // uint4s a field row
};
constexpr int kFullVecs = 4;
constexpr int kGatherVecs = 1;

__device__ __forceinline__ unsigned comp(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The low 16 bits of t in both halves.
__device__ __forceinline__ unsigned pack16(int t) {
  return __byte_perm(static_cast<unsigned>(t), 0u, 0x1010);
}

template <typename T>
__device__ __forceinline__ bool fits(int t) {
  return sizeof(T) == 4 || (t >= -32768 && t <= 32767);
}

// A filter's token as a tile word holds it (int16: in both halves).
template <typename T>
__device__ __forceinline__ unsigned tok_word(int t) {
  return sizeof(T) == 2 ? pack16(t) : static_cast<unsigned>(t);
}

// Bit 15 of each half set iff the half is nonzero (no carry crosses it).
__device__ __forceinline__ unsigned halves_nonzero(unsigned d) {
  return ((d & 0x7FFF7FFFu) + 0x7FFF7FFFu) | d;
}

// What a row test of one filter needs, computed once per filter.
struct Desc {
  unsigned cmp;  // rlen's compare value: fprefix ('#') or flen (int16: both halves)
  int mode;      // kHash | kWild | kNever
  unsigned lit;  // bit i (< 32): level i is a literal within the prefix
  int np;        // levels within the prefix: min(L, fprefix)
};
static_assert(sizeof(Desc) == 16, "a descriptor is one 16-byte shared load");

// ``bad_tok``: a literal level's token does not fit the tiles' type.
template <typename T>
__device__ __forceinline__ Desc make_desc(int flen, int fprefix, int fhash, int fwild,
                                          int np, unsigned lit, bool bad_tok) {
  Desc d{0u, (fhash ? kHash : 0) | (fwild ? kWild : 0), lit, np};
  // live rows have rlen >= 1, so rlen == flen < 1 matches none
  bool never = bad_tok || (!fhash && flen < 1);
  if (sizeof(T) == 2) {
    // live int16 rows have rlen in 1..32767: compare values outside that
    // range are settled here, not truncated
    never |= fhash ? fprefix > 0x7FFF : flen > 0x7FFF;
    d.cmp = pack16(fhash ? max(fprefix, 0) : flen);
  } else {
    d.cmp = static_cast<unsigned>(fhash ? fprefix : flen);
  }
  if (never) d.mode |= kNever;
  return d;
}

// A lane's rows of one tile: rlen and flags as loaded, and its token rows.
// KEEP > 0: the token rows of the literal levels below KEEP are loaded
// with rlen and flags and kept in registers; KEEP == 0: a test reads them
// from memory. ``valid`` false: no rows (rlen 0), reading tile 0 for an
// address.
template <typename T, int VECS, int KEEP>
struct LaneRows {
  const uint4* base;  // the lane's first uint4 of the tile's field row 0
  uint4 vr[VECS], vf[VECS];
  uint4 tok[KEEP > 0 ? KEEP : 1][VECS];

  __device__ __forceinline__ void load(const T* tiles, int cid, bool valid, int lvl,
                                       bool flags, unsigned lit) {
    using G = Geo<T, VECS>;
    base = reinterpret_cast<const uint4*>(tiles + (size_t)(valid ? cid : 0) * (lvl + 3) * kChunk)
           + (lane_id() % G::kLanesPerTile) * G::kVecs;
#pragma unroll
    for (int k = 0; k < G::kVecs; ++k) {
      vr[k] = valid ? __ldg(base + lvl * G::kRowVec + k) : make_uint4(0u, 0u, 0u, 0u);
      vf[k] = flags ? __ldg(base + (lvl + 2) * G::kRowVec + k) : make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (KEEP > 0) {
#pragma unroll
      for (int i = 0; i < KEEP; ++i) {
        if ((lit >> i) & 1u) {
#pragma unroll
          for (int k = 0; k < G::kVecs; ++k) tok[i][k] = __ldg(base + i * G::kRowVec + k);
        }
      }
    }
  }

  // uint4 k of the lane's part of token row i
  __device__ __forceinline__ uint4 level(int i, int k) const {
    if constexpr (KEEP > 0) {
      return tok[i][k];
    } else {
      return __ldg(base + i * Geo<T, VECS>::kRowVec + k);
    }
  }
};

// The filter-independent part of a row test, once per tile: rlen, live
// (rlen >= 1) and live and not a $-topic; int16: bit 15/31 of word m
// (rows 2m, 2m+1), int32: all bits of word m (row m).
template <int VECS>
struct Tile {
  unsigned rl[4 * VECS], live[4 * VECS], lnd[4 * VECS];
};

template <typename T, int VECS, int KEEP>
__device__ __forceinline__ Tile<VECS> tile_of(const LaneRows<T, VECS, KEEP>& r) {
  Tile<VECS> t;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = 4 * k + q;
      const unsigned x = comp(r.vr[k], q);
      const unsigned f = comp(r.vf[k], q);
      t.rl[m] = x;
      if (sizeof(T) == 2) {
        // (x | 0x8000) - 1 keeps bit 15 iff x >= 1 as signed, once ~x
        // says x is not negative
        t.live[m] = ((x | 0x80008000u) - 0x00010001u) & ~x & 0x80008000u;
        t.lnd[m] = t.live[m] & ~(f << 14);  // flag bit 1 -> bit 15, 17 -> 31
      } else {
        t.live[m] = static_cast<int>(x) >= 1 ? kFull : 0u;
        t.lnd[m] = (f & 2u) ? 0u : t.live[m];
      }
    }
  }
  return t;
}

// Row 2m at bit 15 of a..d's word m, row 2m+1 at bit 31 → 8 row bits.
__device__ __forceinline__ unsigned bits8(unsigned a, unsigned b, unsigned c, unsigned d) {
  const unsigned y = (a >> 15) | (b >> 13) | (c >> 11) | (d >> 9);
  return (y | (y >> 15)) & 0xFFu;
}

// One filter against a lane's rows, ``diff`` holding the OR of the
// differences of its equality tests (rlen == flen, the literal levels).
// → the lane's row bits, bit j = its row j.
template <typename T, int VECS, bool WILD, bool HASH>
__device__ __forceinline__ unsigned finish(const unsigned (&diff)[4 * VECS],
                                           const Tile<VECS>& t, unsigned cmp) {
  constexpr int kWords = 4 * VECS;
  if (sizeof(T) == 2) {
    unsigned ok[kWords];
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      unsigned o = (WILD ? t.lnd[m] : t.live[m]) & ~halves_nonzero(diff[m]);
      if (HASH) o &= (t.rl[m] | 0x80008000u) - cmp;  // rlen >= fprefix
      ok[m] = o;
    }
    unsigned bits = 0;
#pragma unroll
    for (int g = 0; g < VECS; ++g) {
      bits |= bits8(ok[4 * g], ok[4 * g + 1], ok[4 * g + 2], ok[4 * g + 3]) << (8 * g);
    }
    return bits;
  } else {
    unsigned bits = 0;
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      const bool len_ok = !HASH || static_cast<int>(t.rl[m]) >= static_cast<int>(cmp);
      bits |= static_cast<unsigned>(((WILD ? t.lnd[m] : t.live[m]) != 0u) & (diff[m] == 0u)
                                    & len_ok)
              << m;
    }
    return bits;
  }
}

// → the word a lane's rows fall in, for one filter: each lane's row bits
// shifted into place and ORed over the lanes of the word. ``tok(i)``: the
// filter's token at level i (warp-uniform). Every lane of the warp calls
// it together.
template <typename T, int MAXL, int VECS, int KEEP, class TokFn>
__device__ __forceinline__ unsigned lane_word(const LaneRows<T, VECS, KEEP>& r,
                                              const Tile<VECS>& t, const Desc& d, TokFn tok) {
  using G = Geo<T, VECS>;
  unsigned w = 0u;
  if (!(d.mode & kNever)) {
    const bool hash = (d.mode & kHash) != 0;
    unsigned diff[G::kWords];
#pragma unroll
    for (int m = 0; m < G::kWords; ++m) diff[m] = hash ? 0u : t.rl[m] ^ d.cmp;
    auto level = [&](int i, int ft) {
      const unsigned tw = tok_word<T>(ft);
      uint4 x[G::kVecs];
#pragma unroll
      for (int k = 0; k < G::kVecs; ++k) x[k] = r.level(i, k);
#pragma unroll
      for (int k = 0; k < G::kVecs; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) diff[4 * k + q] |= comp(x[k], q) ^ tw;
      }
    };
    if constexpr (MAXL > 0) {
#pragma unroll
      for (int i = 0; i < MAXL; ++i) {
        if ((d.lit >> i) & 1u) level(i, tok(i));
      }
    } else {
      for (int i = 0; i < d.np; ++i) {
        const int ft = tok(i);
        if (ft != kPlusTok) level(i, ft);
      }
    }
    if (d.mode & kWild) {
      w = hash ? finish<T, VECS, true, true>(diff, t, d.cmp)
               : finish<T, VECS, true, false>(diff, t, d.cmp);
    } else {
      w = hash ? finish<T, VECS, false, true>(diff, t, d.cmp)
               : finish<T, VECS, false, false>(diff, t, d.cmp);
    }
  }
  if (G::kLanesPerWord > 1) {
    w <<= G::kRowsPerLane * (lane_id() & (G::kLanesPerWord - 1));
#pragma unroll
    for (int s = 1; s < G::kLanesPerWord; s <<= 1) w |= __shfl_xor_sync(kFull, w, s);
  }
  return w;
}

// ---------------------------------------------------------------- full
// Block k serves filters [s*per_split, s*per_split + per_split) with s =
// k / ublocks, and one warp's tiles per warp: unit (k % ublocks) * 8 + its
// warp. The block stages its filters once: s_desc [per_split], then s_tok
// [per_split][lvl].
template <typename T, int MAXL>
__global__ void __launch_bounds__(kFullWarps * 32, 2)
retained_full_kernel(const T* __restrict__ tiles, int nchunks, int lvl,
                     const int* __restrict__ ftok,
                     const int* __restrict__ flen,
                     const int* __restrict__ fprefix,
                     const int* __restrict__ fhash,
                     const int* __restrict__ fwild, int nb, int per_split,
                     int ublocks, int* __restrict__ out) {
  using G = Geo<T, kFullVecs>;
  extern __shared__ int4 smem[];
  Desc* s_desc = reinterpret_cast<Desc*>(smem);
  int* s_tok = reinterpret_cast<int*>(s_desc + per_split);
  const int lane = lane_id();
  const int split = blockIdx.x / ublocks;
  const int f0 = split * per_split;
  const int gn = min(per_split, nb - f0);
  const int unit = (blockIdx.x - split * ublocks) * kFullWarps + (threadIdx.x >> 5);
  const int c = unit * G::kTilesPerWarp + lane / G::kLanesPerTile;
  const bool valid = c < nchunks;

  // the rows every test reads, loaded before the filters are known: rlen
  // and flags (also where no filter starts with a wildcard: one more row
  // read in parallel, not a round trip after the filters)
  LaneRows<T, kFullVecs, 0> r;
  r.load(tiles, c, valid, lvl, true, 0u);

  // stage the block's filters: every load at once, then the descriptors
  int4* s_raw = reinterpret_cast<int4*>(s_desc);
  for (int k = threadIdx.x; k < gn * lvl; k += blockDim.x) {
    s_tok[k] = __ldg(ftok + (size_t)f0 * lvl + k);
  }
  for (int k = threadIdx.x; k < gn; k += blockDim.x) {
    s_raw[k] = make_int4(__ldg(flen + f0 + k), __ldg(fprefix + f0 + k),
                         __ldg(fhash + f0 + k), __ldg(fwild + f0 + k));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < gn; k += blockDim.x) {
    const int4 raw = s_raw[k];  // flen, fprefix, fhash, fwild
    const int np = min(lvl, raw.y);
    unsigned lit = 0;
    bool bad = false;
    for (int i = 0; i < np; ++i) {
      const int t = s_tok[k * lvl + i];
      if (t != kPlusTok) {
        if (i < 32) lit |= 1u << i;
        bad |= !fits<T>(t);
      }
    }
    s_desc[k] = make_desc<T>(raw.x, raw.y, raw.z, raw.w, np, lit, bad);
  }
  __syncthreads();
  if (unit * G::kTilesPerWarp >= nchunks) return;  // the whole warp leaves together

  const Tile<kFullVecs> t = tile_of(r);
  unsigned any = 0;
#pragma unroll
  for (int m = 0; m < G::kWords; ++m) any |= t.live[m];
  const size_t row_words = (size_t)nchunks * kWordsPerChunk;
  int* o = out + (size_t)f0 * row_words + (size_t)c * kWordsPerChunk
           + (lane % G::kLanesPerTile) / G::kLanesPerWord;
  const bool st = valid && lane % G::kLanesPerWord == 0;
  // no live row (the padding tiles past nchunks, ~11% of cfg5's 8,192):
  // every word is zero, no filter tested
  if (!__any_sync(kFull, any != 0u)) {
    for (int j = 0; j < gn; ++j) {
      if (st) o[(size_t)j * row_words] = 0;
    }
    return;
  }
  for (int j = 0; j < gn; ++j) {
    const int* ft = s_tok + j * lvl;
    const unsigned w =
        lane_word<T, MAXL>(r, t, s_desc[j], [&](int i) { return ft[i]; });
    if (st) o[(size_t)j * row_words] = static_cast<int>(w);
  }
}

// -------------------------------------------------------------- gather
// Warp w serves filter w / split, slots [part*per, part*per + per), per <=
// 32. It tests only the slots whose id is in range and is not a repeat of
// chunk 0, a slot per tile group of the warp a step, and stores each
// slot's words as it goes; the copies of chunk 0 and the out-of-range
// slots are stored after.
template <typename T, int MAXL>
__global__ void __launch_bounds__(kGatherWarps * 32)
retained_gather_kernel(const T* __restrict__ tiles, int nchunks, int lvl,
                       const int* __restrict__ ftok,
                       const int* __restrict__ flen,
                       const int* __restrict__ fprefix,
                       const int* __restrict__ fhash,
                       const int* __restrict__ fwild,
                       const int* __restrict__ chunk_ids, int nb, int nc,
                       int split, int per, int* __restrict__ out) {
  using G = Geo<T, kGatherVecs>;
  const long long warp = (long long)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (warp >= (long long)nb * split) return;  // the whole warp leaves together
  const int lane = lane_id();
  const int b = static_cast<int>(warp / split);
  const int k0 = static_cast<int>(warp - (long long)b * split) * per;
  const int n = min(nc - k0, per);
  const int half = lane / G::kLanesPerTile;  // the lane's tile group
  const int my_cid = lane < n ? __ldg(chunk_ids + (size_t)b * nc + k0 + lane) : -1;

  // the filter, once per warp: lane i loads level i's token (every level
  // at once, masked by the prefix after), the fields are broadcast loads
  const int* frow = ftok + (size_t)b * lvl;
  const int fp = __ldg(fprefix + b);
  const int fl = __ldg(flen + b);
  const int fh = __ldg(fhash + b);
  const int fw = __ldg(fwild + b);
  const int np = min(lvl, fp);
  int tok = kPlusTok;
  unsigned lit = 0;
  bool bad = false;
  for (int i0 = 0; i0 < lvl; i0 += 32) {  // one pass for MAXL > 0 (L <= 16)
    const int i = i0 + lane;
    const int t = i < lvl ? __ldg(frow + i) : kPlusTok;
    const bool literal = i < np && t != kPlusTok;
    bad |= literal && !fits<T>(t);
    if (i0 == 0) {
      tok = t;
      lit = __ballot_sync(kFull, literal);
    }
  }
  const Desc d = make_desc<T>(fl, fp, fh, fw, np, lit, __any_sync(kFull, bad));

  const unsigned zeros = __ballot_sync(kFull, my_cid == 0);
  const int first0 = zeros ? __ffs(zeros) - 1 : -1;
  const bool in_range = my_cid >= 0 && my_cid < nchunks;
  unsigned tested = __ballot_sync(kFull, in_range && (my_cid != 0 || lane == first0));
  if (d.mode & kNever) tested = 0u;  // every word zero

  int* orow = out + ((size_t)b * nc + k0) * kWordsPerChunk;
  const int wi = (lane % G::kLanesPerTile) / G::kLanesPerWord;  // the word the lane holds
  int zword = 0;  // lane L: word L&3 of chunk 0, once its slot is tested
  for (unsigned todo = tested; todo;) {
    int s = -1;  // the lane's tile group's slot this step
#pragma unroll
    for (int h = 0; h < G::kTilesPerWarp; ++h) {
      const int sh = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      s = h == half ? sh : s;
    }
    LaneRows<T, kGatherVecs, MAXL> r;
    r.load(tiles, __shfl_sync(kFull, my_cid, s < 0 ? 0 : s), s >= 0, lvl,
           (d.mode & kWild) != 0, d.lit);
    const Tile<kGatherVecs> t = tile_of(r);
    unsigned w;
    if constexpr (MAXL > 0) {
      w = lane_word<T, MAXL>(r, t, d, [&](int i) { return __shfl_sync(kFull, tok, i); });
    } else {
      w = lane_word<T, MAXL>(r, t, d, [&](int i) { return __ldg(frow + i); });
    }
    if (s >= 0 && lane % G::kLanesPerWord == 0) orow[s * kWordsPerChunk + wi] = static_cast<int>(w);
    const unsigned zg = __ballot_sync(kFull, s >= 0 && s == first0);
    if (zg) {
      zword = static_cast<int>(
          __shfl_sync(kFull, w, (__ffs(zg) - 1) + (lane & 3) * G::kLanesPerWord));
    }
  }
  // copies of chunk 0 take its words; out-of-range ids give zeros
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int slot = 8 * k + (lane >> 2);
    const int cid = __shfl_sync(kFull, my_cid, slot);
    if (slot < n && !((tested >> slot) & 1u)) {
      orow[8 * k * kWordsPerChunk + lane] = cid == 0 ? zword : 0;
    }
  }
}

// ------------------------------------------------------------- launches
int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Slots per gather warp for a (B, NC) call: at most 32; halved, down to one
// step's worth, while the grid still fits kWarpsPerSm warps per SM (one
// wave at the L <= 8 instances' registers: a second wave cost more
// than the longer chain of a warp that tests more slots).
template <typename T>
int slots_per_warp(int b, int nc) {
  const int min_per = Geo<T, kGatherVecs>::kTilesPerWarp;
  const long long target = (long long)kWarpsPerSm * sm_count();
  int per = nc < 32 ? nc : 32;
  while (per > min_per) {
    const int half = (per + 1) / 2;
    if ((long long)b * ((nc + half - 1) / half) > target) break;
    per = half;
  }
  return per;
}

template <typename T, int MAXL>
int launch_gather(const T* tiles, int nchunks, int lvl, const int* ftok,
                  const int* flen, const int* fprefix, const int* fhash,
                  const int* fwild, const int* chunk_ids, int b, int nc,
                  int* out, cudaStream_t stream) {
  const int per = slots_per_warp<T>(b, nc);
  const int split = (nc + per - 1) / per;
  const long long warps = (long long)b * split;
  const unsigned blocks = (unsigned)((warps + kGatherWarps - 1) / kGatherWarps);
  retained_gather_kernel<T, MAXL><<<blocks, kGatherWarps * 32, 0, stream>>>(
      tiles, nchunks, lvl, ftok, flen, fprefix, fhash, fwild, chunk_ids, b, nc, split,
      per, out);
  return (int)cudaGetLastError();
}

template <typename T, int MAXL>
int launch_full(const T* tiles, int nchunks, int lvl, const int* ftok,
                const int* flen, const int* fprefix, const int* fhash,
                const int* fwild, int b, int* out, cudaStream_t stream) {
  const int per_filter = (int)sizeof(Desc) + lvl * (int)sizeof(int);
  const int cap = kMaxStageBytes / per_filter;  // filters a block stages
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const long long units = (nchunks + Geo<T, kFullVecs>::kTilesPerWarp - 1)
                             / Geo<T, kFullVecs>::kTilesPerWarp;
  const long long ublocks = (units + kFullWarps - 1) / kFullWarps;
  // split the filters over more blocks while the grid holds less than
  // kWarpsPerSm warps per SM; at least as many splits as shared memory needs
  long long splits = (long long)kWarpsPerSm * sm_count() / (ublocks * kFullWarps);
  splits = splits < 1 ? 1 : splits;
  const long long need = (b + cap - 1) / cap;
  splits = splits < need ? need : splits > b ? b : splits;
  const int per_split = (int)((b + splits - 1) / splits);
  splits = (b + per_split - 1) / per_split;
  retained_full_kernel<T, MAXL><<<(unsigned)(splits * ublocks), kFullWarps * 32,
                                  (size_t)per_split * per_filter, stream>>>(
      tiles, nchunks, lvl, ftok, flen, fprefix, fhash, fwild, b, per_split, (int)ublocks, out);
  return (int)cudaGetLastError();
}

template <typename T>
int gather_by_levels(const T* tiles, int nchunks, int lvl, const int* ftok,
                     const int* flen, const int* fprefix, const int* fhash,
                     const int* fwild, const int* chunk_ids, int b, int nc,
                     int* out, cudaStream_t stream) {
  if (lvl <= 8)
    return launch_gather<T, 8>(tiles, nchunks, lvl, ftok, flen, fprefix, fhash,
                               fwild, chunk_ids, b, nc, out, stream);
  if (lvl <= 16)
    return launch_gather<T, 16>(tiles, nchunks, lvl, ftok, flen, fprefix, fhash,
                                fwild, chunk_ids, b, nc, out, stream);
  return launch_gather<T, 0>(tiles, nchunks, lvl, ftok, flen, fprefix, fhash,
                             fwild, chunk_ids, b, nc, out, stream);
}

template <typename T>
int full_by_levels(const T* tiles, int nchunks, int lvl, const int* ftok,
                   const int* flen, const int* fprefix, const int* fhash,
                   const int* fwild, int b, int* out, cudaStream_t stream) {
  if (lvl <= 8)
    return launch_full<T, 8>(tiles, nchunks, lvl, ftok, flen, fprefix, fhash,
                             fwild, b, out, stream);
  if (lvl <= 16)
    return launch_full<T, 16>(tiles, nchunks, lvl, ftok, flen, fprefix, fhash,
                              fwild, b, out, stream);
  return launch_full<T, 0>(tiles, nchunks, lvl, ftok, flen, fprefix, fhash,
                           fwild, b, out, stream);
}

}  // namespace

// Launchers: plain C interface for ctypes. Every pointer is a device
// pointer; tiles are int16 (tile_bytes 2) or int32 (4), 16-byte aligned,
// every other input int32; the caller allocates out. Each returns
// cudaGetLastError() after the launch (0 = launched).

extern "C" int launch_retained_scan_gather(const void* tiles, int tile_bytes,
                                           int nchunks, int lvl,
                                           const int* ftok, const int* flen,
                                           const int* fprefix,
                                           const int* fhash, const int* fwild,
                                           const int* chunk_ids, int b, int nc,
                                           int* out, void* stream) {
  if (b <= 0 || nc <= 0) return 0;
  if (lvl < 1 || (reinterpret_cast<uintptr_t>(tiles) & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bytes == 2)
    return gather_by_levels(static_cast<const int16_t*>(tiles), nchunks, lvl,
                            ftok, flen, fprefix, fhash, fwild, chunk_ids, b, nc,
                            out, s);
  if (tile_bytes == 4)
    return gather_by_levels(static_cast<const int32_t*>(tiles), nchunks, lvl,
                            ftok, flen, fprefix, fhash, fwild, chunk_ids, b, nc,
                            out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int launch_retained_scan_full(const void* tiles, int tile_bytes,
                                         int nchunks, int lvl, const int* ftok,
                                         const int* flen, const int* fprefix,
                                         const int* fhash, const int* fwild,
                                         int b, int* out, void* stream) {
  if (b <= 0 || nchunks <= 0) return 0;
  if (lvl < 1 || (reinterpret_cast<uintptr_t>(tiles) & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bytes == 2)
    return full_by_levels(static_cast<const int16_t*>(tiles), nchunks, lvl,
                          ftok, flen, fprefix, fhash, fwild, b, out, s);
  if (tile_bytes == 4)
    return full_by_levels(static_cast<const int32_t*>(tiles), nchunks, lvl,
                          ftok, flen, fprefix, fhash, fwild, b, out, s);
  return (int)cudaErrorInvalidValue;
}
