// Dense full-scan match kernels for Hopper (sm_90a): every topic of a batch
// against every row of a FilterTable (the dense backend), the inverse,
// every wildcard filter of a batch against every stored retained topic,
// and the compaction of a words array to each topic's first nonzero words
// (the dense words path's bitmap, the partitioned topk mode's match words).
//
// What they replace. Four XLA device programs of the JAX package (it wrote
// no Pallas kernel for them):
//   - launch_dense_match_packed replaces rmqtt_tpu/ops/match.py:82
//     match_packed_impl, whose row test is _chunk_match (:55-68);
//   - launch_dense_match_retained replaces rmqtt_tpu/ops/match.py:176
//     match_retained_impl;
//   - launch_dense_match_words replaces the popcount and lax.top_k of
//     rmqtt_tpu/ops/match.py:151 match_words_impl, and
//     rmqtt_tpu/ops/partitioned.py:1492 compact_words_impl (the same
//     function: its top_k over w - index on nonzero words puts the zero
//     words after them, lowest index first).
// Forward: rows are filters, ftok [F, L] int32 ('+' = PLUS_TOK, levels past
// the filter PAD_TOK), flen, fprefix (levels before a trailing '#') int32,
// fhash, fwild (first level '+' or '#') bool; the batch is topics, ttok
// [B, L], tlen (true level count; padded topics -2) int32, tdollar bool.
// Row f matches topic b iff
//   every level i < L: i >= fprefix[f] or ftok[f,i] == ttok[b,i] or
//     ftok[f,i] == '+',
//   fhash[f] ? tlen[b] >= fprefix[f] : tlen[b] == flen[f],
//   !(tdollar[b] and fwild[f]).
// (The forward kernel takes the lengths as level counts: tlen - fprefix
// must not overflow int32, which holds for |lengths| < 2^30.)
// Inverse: rows are topic names, rtok [F, L], rlen, rdollar; the batch is
// filters, ftok [B, L], flen (padded -2), fprefix (padded L+1), fhash,
// fwild; the same test with the wildcard side swapped (the '+' and the
// prefix come from the batch, the $-flag from the row). Free rows have
// flen/rlen -1 and match nothing through the length rule alone.
// Output: out [B, F/32] int32, bit k of word w = row 32w + k, the JAX bit
// order (np.unpackbits(..., bitorder="little") reads it).
// Words: from a bitmap [B, W] int32, counts[b] = its set bits, word_idx[b,
// :K] its first min(K, nnz) nonzero word indices ascending, then its
// lowest-index zero words ascending (lax.top_k's order: the lower index
// first among equal keys), word_bits[b, :K] those words.
// The plain PyTorch twins are rmqtt_tpu_torch/ops/match.py
// match_packed_plain and match_retained_plain, and
// rmqtt_tpu_torch/ops/compact_tail.py match_words_plain (the words kernel's,
// for the dense words path and the topk mode's compact_words alike).
//
// What bounds them on the H100. cfg3's dense table has F = 2^20 rows of
// L = 8 levels (32 MiB of tokens, ~42 MiB with the metadata) and the batch
// B = 16,384 topics: 1.7e10 row tests. At ~(2L+6) = 22 integer operations
// a row test that is 3.8e11 operations, 22.6 ms at the integer pipe's
// 16.7 T/s; the bitmap written is B * F/8 = 2 GiB, 0.64 ms at 3.35 TB/s,
// and the table is read once. So the forward kernel is bound by issue.
// The words kernel reads that 2 GiB bitmap once and writes B * (2K + 1)
// ints: bound by bytes, 0.646 ms. The inverse at cfg5's retained side
// (2^20 rows of 8 levels, 64 filters) reads ~39 MB, writes 8 MiB (0.0141 ms) and is
// 6.7e7 row tests, each filter comparing its few literal levels (~1-3 in
// the subscriber mix): bound by bytes, or by issue near it. The topk
// mode's compaction reads [16,384, 128] words (8 MiB) and writes 4.3 MB:
// bound by bytes, 0.0038 ms. (bench/roofline_model.py holds the bounds:
// the bytes, cold or warm in the L2, and the instructions issued.)
//
// What the forward design does about it (dense_packed_kernel):
//   - a thread holds a register tile of T topics (T = 8 at up to 8 levels,
//     4 at up to 16, 2 past them; for a smaller batch the least power of
//     two >= ceil(B / 32), so few of its tests are of clamped topics), each
//     with its LR tokens (LR in {8, 16, 32} chosen by L at launch); a warp is 32
//     T topics on one word of 32 rows, so every lane reads the same staged
//     row (a broadcast) and each 16-byte load of two levels serves 2 T
//     level tests;
//   - a block stages 256 rows once, at a compile-time stride of LR levels,
//     and walks up to 16 tiles of 32 T topics over them;
//   - a level is staged as {multiplier, addend}: {1, -token} where it must
//     compare, {0, 0} where it always passes ('+', past the prefix, past
//     L), so d = t * multiplier + addend is zero iff the level passes; a
//     level costs one IMAD (the FMA pipe), and one 3-input LOP3 (the ALU
//     pipe) ORs two levels' d into acc. The multiplier is data the compiler
//     cannot fold, so the subtraction stays an IMAD;
//   - the length rule is one add and one LOP3: a row's lo = fhash ?
//     fprefix : flen and mask = fhash ? 0x80000000 (tl - lo < 0 fails) : ~0
//     (tl != lo fails);
//   - the 32 rows of a word are walked from row 31 down, each test
//     shifting its fail bit in (fails = fails << 1 | acc != 0), so the
//     word is built without a shift by a variable; the $ rule is applied
//     once a word: hits = ~(fails | (wildcard-first rows & topic is $));
//   - levels past 32 (a deep filter grows L) are read from global memory
//     only for the rows whose prefix reaches them (a branch uniform over
//     the warp: the warp tests one row);
//   - a tile's 32 T x 8 words go out through shared memory, each topic's
//     8 words as one 32-byte segment.
// The inverse (dense_inverse_kernel) has few filters (1 to 64) and many
// rows, so rows go on lanes: a lane holds R rows' LR tokens in registers
// (R = 4 at up to 8 levels, 2 at 16, 1 past), loaded straight from global
// memory in 16-byte loads, no staging, four warps a block (512 rows at up
// to 8 levels); the block's filters go into shared
// memory once as the forward's {multiplier, addend} pairs, two levels a
// broadcast 16-byte load that serves 2 R tests; a filter's loop stops after
// its last compared level (uniform over the block); one __ballot_sync a
// filter and a row group is that filter's output word, and one lane
// stores a warp's R words of a filter at once; the words of a block's
// filters go out through shared memory, each filter's as one contiguous
// segment, with the $ rule applied there, one LOP3 a word.
// The words kernel (dense_words_kernel): a warp a topic, four 16-byte
// loads a lane in flight (so W must be a multiple of 4 and the bitmap
// 16-byte aligned, as the matcher's [B, capacity / 32] bitmap is); a stretch of all-zero words costs one vote; where
// a word is nonzero, four ballots give each word its rank among the
// nonzero words, and a word of rank below K is written at that slot. Its
// popcounts make counts. When the row has fewer than K nonzero words, a
// second pass over the row's first words (at most K + nnz of them, from
// L2) ranks the zero words and writes the first K - nnz after them. A row
// of at most 128 words (the topk mode's W = 4 NC) takes
// dense_words_small_kernel instead: the least power of two >= W / 4 lanes
// a topic, one 16-byte load a lane, and the zero words placed from the
// same registers and ranks, with no second pass.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PLUS_TOK = 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WORDS = 8;          // words a block covers, one warp each
constexpr int ROWS = WORDS * 32;  // rows a block stages
constexpr int THREADS = WORDS * 32;
constexpr int INV_WARPS = 4;      // warps an inverse block (bench/dense_variants.py)
constexpr int INV_THREADS = INV_WARPS * 32;
constexpr int INV_FILTERS = 128;  // filters an inverse block walks (grid.y over more)
constexpr int OUT_STRIDE = WORDS + 1;
constexpr int TILES = 16;         // topic tiles a forward block walks at most

// Forward. Shared memory: s_meta [ROWS] {-lo, length mask}; s_lv [ROWS]
// [LR / 2] {addend, multiplier, addend, multiplier}; s_pre [ROWS] fprefix
// (levels past LR); s_wild [WORDS] the wildcard-first rows of each word;
// s_out [32 T][OUT_STRIDE].
template <int LR, int T>
__global__ void __launch_bounds__(THREADS)
dense_packed_kernel(const int* __restrict__ ftok, const int* __restrict__ flen,
                    const int* __restrict__ fprefix,
                    const unsigned char* __restrict__ fhash,
                    const unsigned char* __restrict__ fwild, int nrows, int lvl,
                    const int* __restrict__ ttok, const int* __restrict__ tlen,
                    const unsigned char* __restrict__ tdollar, int b, int tiles,
                    int* __restrict__ out) {
  extern __shared__ int4 smem[];
  int4* s_lv = smem;
  int2* s_meta = reinterpret_cast<int2*>(s_lv + ROWS * (LR / 2));
  int* s_pre = reinterpret_cast<int*>(s_meta + ROWS);
  unsigned* s_wild = reinterpret_cast<unsigned*>(s_pre + ROWS);
  unsigned* s_out = s_wild + WORDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int rows_here = min(ROWS, nrows - row0);  // a multiple of 32
  const int nw = nrows >> 5;
  const int w0 = blockIdx.x * WORDS;
  int2* s_lv2 = reinterpret_cast<int2*>(s_lv);
  for (int idx = threadIdx.x; idx < rows_here * LR; idx += THREADS) {
    const int r = idx / LR, i = idx % LR;
    unsigned neg = 0;
    int mul = 0;
    if (i < lvl) {
      const int f = __ldg(ftok + (size_t)(row0 + r) * lvl + i);
      if (i < __ldg(fprefix + row0 + r) && f != PLUS_TOK) {
        neg = 0u - (unsigned)f;
        mul = 1;
      }
    }
    s_lv2[idx] = make_int2((int)neg, mul);
  }
  for (int r = threadIdx.x; r < rows_here; r += THREADS) {
    const bool hh = __ldg(fhash + row0 + r) != 0;
    const int p = __ldg(fprefix + row0 + r);
    const int lo = hh ? p : __ldg(flen + row0 + r);
    s_meta[r] = make_int2((int)(0u - (unsigned)lo), hh ? INT_MIN : -1);
    s_pre[r] = p;
  }
  const bool word_here = warp * 32 < rows_here;  // uniform over the warp
  if (word_here) {
    const unsigned wild = __ballot_sync(FULL, __ldg(fwild + row0 + warp * 32 + lane) != 0);
    if (lane == 0) s_wild[warp] = wild;
  }
  __syncthreads();
  const unsigned wild = word_here ? s_wild[warp] : 0u;
  for (int g = 0; g < tiles; ++g) {
    const int b0 = (blockIdx.y * tiles + g) * 32 * T;
    if (b0 >= b) break;  // uniform over the block
    unsigned hits[T];
#pragma unroll
    for (int j = 0; j < T; ++j) hits[j] = 0;
    if (word_here && b0 + lane < b) {
      int tb[T];
      unsigned t[T][LR], tl[T], tdm[T], fails[T];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        tb[j] = min(b0 + lane + 32 * j, b - 1);  // a topic past b is computed, not kept
        const int* tt = ttok + (size_t)tb[j] * lvl;
#pragma unroll
        for (int i = 0; i < LR; ++i) t[j][i] = i < lvl ? (unsigned)__ldg(tt + i) : 0u;
        tl[j] = (unsigned)__ldg(tlen + tb[j]);
        tdm[j] = __ldg(tdollar + tb[j]) ? FULL : 0u;
        fails[j] = 0;
      }
#pragma unroll 2
      for (int k = 31; k >= 0; --k) {  // row 31 first: its fail bit ends at bit 31
        const int r = warp * 32 + k;
        const int2 m = s_meta[r];
        unsigned acc[T];
#pragma unroll
        for (int j = 0; j < T; ++j) acc[j] = (tl[j] + (unsigned)m.x) & (unsigned)m.y;
        const int4* lv = s_lv + r * (LR / 2);
#pragma unroll
        for (int q = 0; q < LR / 2; ++q) {
          const int4 v = lv[q];
#pragma unroll
          for (int j = 0; j < T; ++j) {
            acc[j] |= (t[j][2 * q] * (unsigned)v.y + (unsigned)v.x) |
                      (t[j][2 * q + 1] * (unsigned)v.w + (unsigned)v.z);
          }
        }
        if (LR == 32 && lvl > LR) {
          const int p = s_pre[r];
          if (p > LR) {  // uniform over the warp: one row
            const int* fr = ftok + (size_t)(row0 + r) * lvl;
            for (int i = LR; i < min(lvl, p); ++i) {
              const int f = __ldg(fr + i);
              if (f == PLUS_TOK) continue;
#pragma unroll
              for (int j = 0; j < T; ++j)
                acc[j] |= (unsigned)(__ldg(ttok + (size_t)tb[j] * lvl + i) ^ f);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < T; ++j) fails[j] = (fails[j] << 1) | (acc[j] != 0u ? 1u : 0u);
      }
#pragma unroll
      for (int j = 0; j < T; ++j) hits[j] = ~(fails[j] | (wild & tdm[j]));
    }
#pragma unroll
    for (int j = 0; j < T; ++j) s_out[(lane + 32 * j) * OUT_STRIDE + warp] = hits[j];
    __syncthreads();
    for (int idx = threadIdx.x; idx < 32 * T * WORDS; idx += THREADS) {
      const int ot = idx / WORDS, ow = idx % WORDS;
      if (b0 + ot < b && w0 + ow < nw)
        out[(size_t)(b0 + ot) * nw + w0 + ow] = (int)s_out[ot * OUT_STRIDE + ow];
    }
    __syncthreads();
  }
}

// Inverse: rows on lanes. Lane l of warp v holds rows 32 (v R + j) + l,
// j < R, each with its LR tokens in registers (one word j of the output a
// lane's j-th row), loaded from global memory in 16-byte loads where the
// table allows it. The block's filters (INV_FILTERS at most, grid.y over
// more) sit in shared memory: s_lv [F][LR / 2] {multiplier, addend} for
// two levels, {1, -token} where the level compares and {0, 0} where it
// passes ('+', past the prefix, past L); s_meta [F] {level pairs up to the
// last compared level, -lo, length mask, wildcard-first ? ~0 : 0}; s_out
// [F][WPB] the words before the $ rule; s_pre [F] fprefix (levels past
// LR); s_dol [WPB] the block's $-topic rows, a word each.
// A warp's R words of one filter, by one lane, in 16- or 8-byte stores.
template <int R>
__device__ __forceinline__ void store_words(unsigned* p, const unsigned (&w)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 4)
      *reinterpret_cast<uint4*>(p + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) p[k] = w[k];
  }
}

template <int LR, int R>
__global__ void __launch_bounds__(INV_THREADS)
dense_inverse_kernel(const int* __restrict__ rtok, const int* __restrict__ rlen,
                     const unsigned char* __restrict__ rdollar, int nrows, int lvl,
                     int vec, const int* __restrict__ ftok, const int* __restrict__ flen,
                     const int* __restrict__ fprefix,
                     const unsigned char* __restrict__ fhash,
                     const unsigned char* __restrict__ fwild, int b,
                     int* __restrict__ out) {
  constexpr int WPB = INV_WARPS * R;  // words (of 32 rows) a block covers
  extern __shared__ int4 smem[];
  const int cap = min(INV_FILTERS, b);
  int4* s_lv = smem;
  int4* s_meta = s_lv + cap * (LR / 2);
  unsigned* s_out = reinterpret_cast<unsigned*>(s_meta + cap);  // 16-byte aligned
  int* s_pre = reinterpret_cast<int*>(s_out + cap * WPB);
  unsigned* s_dol = reinterpret_cast<unsigned*>(s_pre + cap);
  const int b0 = blockIdx.y * INV_FILTERS;
  const int nf = min(INV_FILTERS, b - b0);
  for (int f = threadIdx.x; f < nf; f += INV_THREADS) {
    const int fb = b0 + f;
    const int fp = __ldg(fprefix + fb);
    const bool hh = __ldg(fhash + fb) != 0;
    const int lo = hh ? fp : __ldg(flen + fb);
    const int* ft = ftok + (size_t)fb * lvl;
    int last = 0;  // levels up to the last one that compares
    const auto level = [&](int i, int& mul, int& add) {
      mul = add = 0;
      if (i < lvl && i < fp) {
        const int t = __ldg(ft + i);
        if (t != PLUS_TOK) {
          mul = 1;
          add = (int)(0u - (unsigned)t);
          last = i + 1;
        }
      }
    };
    for (int q = 0; q < LR / 2; ++q) {
      int4 v;
      level(2 * q, v.x, v.y);
      level(2 * q + 1, v.z, v.w);
      s_lv[f * (LR / 2) + q] = v;
    }
    s_meta[f] = make_int4((last + 1) / 2, (int)(0u - (unsigned)lo), hh ? INT_MIN : -1,
                          __ldg(fwild + fb) ? -1 : 0);
    s_pre[f] = fp;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = nrows >> 5;
  const int w0 = blockIdx.x * WPB + warp * R;  // this warp's first word
  unsigned t[R][LR], rl[R];
  bool dollar[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {  // every load is in flight before one is used
    const bool here = w0 + j < nw;  // uniform over the warp
    const size_t r = (size_t)(w0 + j) * 32 + lane;
#pragma unroll
    for (int i = 0; i < LR; ++i) t[j][i] = 0;
    rl[j] = 0xffffffffu;  // a free row's length: matches nothing
    dollar[j] = false;
    if (here) {
      const int* rr = rtok + r * lvl;
      if (vec) {  // lvl % 4 == 0 and rtok 16-byte aligned
#pragma unroll
        for (int q = 0; q < LR / 4; ++q) {
          if (4 * q < lvl) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(rr) + q);
            t[j][4 * q] = (unsigned)v.x;
            t[j][4 * q + 1] = (unsigned)v.y;
            t[j][4 * q + 2] = (unsigned)v.z;
            t[j][4 * q + 3] = (unsigned)v.w;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < LR; ++i)
          if (i < lvl) t[j][i] = (unsigned)__ldg(rr + i);
      }
      rl[j] = (unsigned)__ldg(rlen + r);
      dollar[j] = __ldg(rdollar + r) != 0;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const unsigned dol = __ballot_sync(FULL, dollar[j]);
    if (lane == 0) s_dol[warp * R + j] = dol;
  }
  __syncthreads();
  for (int f = 0; f < nf; ++f) {
    const int4 m = s_meta[f];  // a broadcast: one filter for the whole block
    unsigned acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = (rl[j] + (unsigned)m.y) & (unsigned)m.z;
    const int4* lv = s_lv + f * (LR / 2);
#pragma unroll
    for (int q = 0; q < LR / 2; ++q) {
      if (q >= m.x) break;  // uniform: the levels after the last compared one pass
      const int4 v = lv[q];
#pragma unroll
      for (int j = 0; j < R; ++j)
        acc[j] |= (t[j][2 * q] * (unsigned)v.x + (unsigned)v.y) |
                  (t[j][2 * q + 1] * (unsigned)v.z + (unsigned)v.w);
    }
    if (LR == 32 && lvl > LR) {
      const int p = s_pre[f];
      if (p > LR) {  // uniform: only a filter whose prefix reaches past LR
        const int* ft = ftok + (size_t)(b0 + f) * lvl;
        for (int i = LR; i < min(lvl, p); ++i) {
          const int tok = __ldg(ft + i);
          if (tok == PLUS_TOK) continue;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (w0 + j < nw)
              acc[j] |= (unsigned)(__ldg(rtok + ((size_t)(w0 + j) * 32 + lane) * lvl + i) ^ tok);
          }
        }
      }
    }
    unsigned word[R];
#pragma unroll
    for (int j = 0; j < R; ++j) word[j] = __ballot_sync(FULL, acc[j] == 0u);
    if (lane == 0) store_words<R>(s_out + f * WPB + warp * R, word);
  }
  __syncthreads();
  const int wb = blockIdx.x * WPB;
  for (int idx = threadIdx.x; idx < nf * WPB; idx += INV_THREADS) {
    const int f = idx / WPB, k = idx % WPB;  // the $ rule: a $ row fails a wildcard-first filter
    if (wb + k < nw)
      out[(size_t)(b0 + f) * nw + wb + k] = (int)(s_out[idx] & ~(s_dol[k] & s_meta[f].w));
  }
}

template <typename Kernel, typename... Args>
int launch_grid(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
                Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// The inverse at LR levels in registers and R rows a lane: a block of
// INV_WARPS warps covers 32 INV_WARPS R rows and INV_FILTERS filters.
template <int LR, int R>
int launch_inverse(const int* rtok, const int* rlen, const unsigned char* rdollar,
                   int nrows, int lvl, const int* ftok, const int* flen, const int* fprefix,
                   const unsigned char* fhash, const unsigned char* fwild, int b, int* out,
                   cudaStream_t s) {
  const int rows = 32 * INV_WARPS * R;
  const dim3 grid((nrows + rows - 1) / rows, (b + INV_FILTERS - 1) / INV_FILTERS);
  const int cap = b < INV_FILTERS ? b : INV_FILTERS;
  const size_t smem = (size_t)cap * ((LR / 2) * sizeof(int4) + sizeof(int4) + sizeof(int) +
                                     INV_WARPS * R * sizeof(unsigned)) +
                      INV_WARPS * R * sizeof(unsigned);
  const int vec = lvl % 4 == 0 && reinterpret_cast<uintptr_t>(rtok) % 16 == 0;
  return launch_grid(dense_inverse_kernel<LR, R>, grid, INV_THREADS, smem, s, rtok, rlen,
                     rdollar, nrows, lvl, vec, ftok, flen, fprefix, fhash, fwild, b, out);
}

// Words. A warp a topic; WW_UNROLL 16-byte loads (4 words each) a lane in
// flight, lane l holding words 4l..4l+3 of each 128-word stretch.
constexpr int WW_WARPS = 8;   // topics a block
constexpr int WW_UNROLL = 4;

// Words i0..i0+3 of a row (W a multiple of 4, the row 16-byte aligned);
// zeros past W.
__device__ __forceinline__ void load4(const unsigned* row, int w, int i0, unsigned (&v)[4]) {
  if (i0 < w) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(row + i0));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0;
  }
}

// Bit j of the result: word j of this lane's four is nonzero.
__device__ __forceinline__ unsigned nonzero4(const unsigned (&v)[4]) {
  return (unsigned)(v[0] != 0) | (unsigned)(v[1] != 0) << 1 | (unsigned)(v[2] != 0) << 2 |
         (unsigned)(v[3] != 0) << 3;
}

// The warp's nonzero words in these four-word groups → their count; in
// before, the nonzero words of the lanes below this one.
__device__ __forceinline__ int rank4(unsigned nz, unsigned below, int& before) {
  int total = 0;
  before = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned bj = __ballot_sync(FULL, (nz >> j) & 1u);
    before += __popc(bj & below);
    total += __popc(bj);
  }
  return total;
}

__global__ void __launch_bounds__(WW_WARPS * 32)
dense_words_kernel(const unsigned* __restrict__ packed, int w, int b, int k,
                   int* __restrict__ word_idx, int* __restrict__ word_bits,
                   int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int tb = blockIdx.x * WW_WARPS + (threadIdx.x >> 5);
  if (tb >= b) return;  // uniform over the warp
  const unsigned* row = packed + (size_t)tb * w;
  int* oi = word_idx + (size_t)tb * k;
  int* ob = word_bits + (size_t)tb * k;
  const unsigned below = (1u << lane) - 1u;
  int nnz = 0;  // nonzero words before this stretch, uniform over the warp
  unsigned bits = 0;
  for (int base = 0; base < w; base += 128 * WW_UNROLL) {
    unsigned v[WW_UNROLL][4];
    unsigned any = 0;
#pragma unroll
    for (int u = 0; u < WW_UNROLL; ++u) {
      load4(row, w, base + 128 * u + 4 * lane, v[u]);
      any |= v[u][0] | v[u][1] | v[u][2] | v[u][3];
    }
    if (!__any_sync(FULL, any != 0)) continue;
#pragma unroll
    for (int u = 0; u < WW_UNROLL; ++u) {
      const unsigned nz = nonzero4(v[u]);
      if (!__any_sync(FULL, nz != 0)) continue;
      int before;
      const int total = rank4(nz, below, before);
      const int i0 = base + 128 * u + 4 * lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((nz >> j) & 1u) {
          const int r = nnz + before + __popc(nz & ((1u << j) - 1u));
          bits += __popc(v[u][j]);
          if (r < k) {
            oi[r] = i0 + j;
            ob[r] = (int)v[u][j];
          }
        }
      }
      nnz += total;
    }
  }
  const unsigned cnt = __reduce_add_sync(FULL, bits);
  if (lane == 0) counts[tb] = (int)cnt;
  // The zero words after the nonzero ones: the zero word of zero-rank z
  // (zero words before it) goes to slot nnz + z while z < k - nnz. The
  // words at or past w (padding of the last stretch) have ranks of at
  // least w - nnz >= k - nnz, so none is written.
  const int need = k - nnz;
  int seen = 0;  // nonzero words before base
  for (int base = 0; base - seen < need; base += 128) {
    unsigned v[4];
    load4(row, w, base + 4 * lane, v);
    const unsigned nz = nonzero4(v);
    int before = 0, total = 0;
    if (__any_sync(FULL, nz != 0)) total = rank4(nz, below, before);
    const int i0 = base + 4 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!((nz >> j) & 1u)) {
        const int z = i0 + j - (seen + before + __popc(nz & ((1u << j) - 1u)));
        if (z < need) {
          oi[nnz + z] = i0 + j;
          ob[nnz + z] = 0;
        }
      }
    }
    seen += total;
  }
}

// Words of a row of at most 128 (the partitioned matcher's topk mode, W =
// 4 NC): 2^glog lanes a topic (the least power of two >= W / 4), 32 >> glog
// topics a warp, each lane's four words in one 16-byte load. The ballots
// rank the nonzero words within each topic's lanes, and the same ranks
// place the zero words: the whole row is in registers, so there is no
// second pass.
__global__ void __launch_bounds__(WW_WARPS * 32)
dense_words_small_kernel(const unsigned* __restrict__ packed, int w, int b, int k,
                         int glog, int* __restrict__ word_idx, int* __restrict__ word_bits,
                         int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int g = 1 << glog;
  const int gl = lane & (g - 1);  // this lane's place among its topic's lanes
  const unsigned group = (g == 32 ? FULL : (1u << g) - 1u) << (lane - gl);
  const unsigned below = (1u << lane) - 1u;
  const int tb = (blockIdx.x * WW_WARPS * 32 + threadIdx.x) >> glog;
  const bool here = tb < b;  // every lane takes part in the votes
  unsigned v[4];
  const int i0 = 4 * gl;
  load4(packed + (size_t)(here ? tb : 0) * w, here ? w : 0, i0, v);
  const unsigned nz = nonzero4(v);
  int before = 0, nnz = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned bj = __ballot_sync(FULL, (nz >> j) & 1u) & group;
    before += __popc(bj & below);
    nnz += __popc(bj);
  }
  unsigned bits = __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
  for (int o = g >> 1; o > 0; o >>= 1) bits += __shfl_xor_sync(FULL, bits, o);
  if (!here) return;
  if (gl == 0) counts[tb] = (int)bits;
  if (i0 >= w) return;
  int* oi = word_idx + (size_t)tb * k;
  int* ob = word_bits + (size_t)tb * k;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = before + __popc(nz & ((1u << j) - 1u));  // nonzero words before word i0 + j
    // a nonzero word goes to its rank; the zero word with z zero words
    // before it goes to nnz + z
    const int slot = (nz >> j) & 1u ? r : nnz + (i0 + j - r);
    if (slot < k) {
      oi[slot] = i0 + j;
      ob[slot] = (int)v[j];
    }
  }
}

template <int LR, int T>
int launch_forward(const int* ftok, const int* flen, const int* fprefix,
                   const unsigned char* fhash, const unsigned char* fwild, int nrows,
                   int lvl, const int* ttok, const int* tlen,
                   const unsigned char* tdollar, int b, int* out, cudaStream_t s) {
  const int ntiles = (b + 32 * T - 1) / (32 * T);
  const int tiles = ntiles < TILES ? ntiles : TILES;
  const dim3 grid((nrows + ROWS - 1) / ROWS, (ntiles + tiles - 1) / tiles);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ROWS * (LR / 2) * sizeof(int4) + ROWS * sizeof(int2) +
                      ROWS * sizeof(int) + WORDS * sizeof(unsigned) +
                      32 * T * OUT_STRIDE * sizeof(unsigned);
  return launch_grid(dense_packed_kernel<LR, T>, grid, THREADS, smem, s, ftok, flen,
                     fprefix, fhash, fwild, nrows, lvl, ttok, tlen, tdollar, b, tiles,
                     out);
}

// The forward with the smallest tile of at most T topics a lane that covers
// the batch: T halves while ceil(b / 32) <= T / 2.
template <int LR, int T>
int launch_fit(const int* ftok, const int* flen, const int* fprefix,
               const unsigned char* fhash, const unsigned char* fwild, int nrows, int lvl,
               const int* ttok, const int* tlen, const unsigned char* tdollar, int b,
               int* out, cudaStream_t s) {
  if constexpr (T > 1) {
    if (b <= 16 * T)
      return launch_fit<LR, T / 2>(ftok, flen, fprefix, fhash, fwild, nrows, lvl, ttok,
                                   tlen, tdollar, b, out, s);
  }
  return launch_forward<LR, T>(ftok, flen, fprefix, fhash, fwild, nrows, lvl, ttok, tlen,
                               tdollar, b, out, s);
}

}  // namespace

extern "C" int launch_dense_match_packed(const int* ftok, const int* flen,
                                         const int* fprefix,
                                         const unsigned char* fhash,
                                         const unsigned char* fwild, int nrows,
                                         int lvl, const int* ttok,
                                         const int* tlen,
                                         const unsigned char* tdollar, int b,
                                         int* out, void* stream) {
  if (nrows <= 0 || b <= 0) return 0;  // nothing to do
  if (lvl < 1 || nrows % 32 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DENSE_PACKED_ARGS ftok, flen, fprefix, fhash, fwild, nrows, lvl, ttok, tlen, tdollar, b, out, s
  if (lvl <= 8) return launch_fit<8, 8>(DENSE_PACKED_ARGS);
  if (lvl <= 16) return launch_fit<16, 4>(DENSE_PACKED_ARGS);
  return launch_fit<32, 2>(DENSE_PACKED_ARGS);
#undef DENSE_PACKED_ARGS
}

extern "C" int launch_dense_match_retained(const int* rtok, const int* rlen,
                                           const unsigned char* rdollar,
                                           int nrows, int lvl, const int* ftok,
                                           const int* flen, const int* fprefix,
                                           const unsigned char* fhash,
                                           const unsigned char* fwild, int b,
                                           int* out, void* stream) {
  if (nrows <= 0 || b <= 0) return 0;  // nothing to do
  if (lvl < 1 || nrows % 32 != 0 || (b + INV_FILTERS - 1) / INV_FILTERS > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DENSE_RETAINED_ARGS rtok, rlen, rdollar, nrows, lvl, ftok, flen, fprefix, fhash, fwild, b, out, s
  if (lvl <= 8) return launch_inverse<8, 4>(DENSE_RETAINED_ARGS);
  if (lvl <= 16) return launch_inverse<16, 2>(DENSE_RETAINED_ARGS);
  return launch_inverse<32, 1>(DENSE_RETAINED_ARGS);
#undef DENSE_RETAINED_ARGS
}

extern "C" int launch_dense_match_words(const int* packed, int w, int b, int k,
                                        int* word_idx, int* word_bits, int* counts,
                                        void* stream) {
  if (b <= 0) return 0;  // nothing to do
  if (w < 0 || w % 4 != 0 || reinterpret_cast<uintptr_t>(packed) % 16 != 0 || k < 0 ||
      k > w)
    return (int)cudaErrorInvalidValue;  // the kernel reads 16-byte aligned words
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* words = reinterpret_cast<const unsigned*>(packed);
  if (w <= 128) {  // one 16-byte load a lane holds the row
    int glog = 0;
    while ((4 << glog) < w) ++glog;
    const long long threads = (long long)b << glog;
    const dim3 grid((unsigned)((threads + WW_WARPS * 32 - 1) / (WW_WARPS * 32)));
    return launch_grid(dense_words_small_kernel, grid, WW_WARPS * 32, 0, s, words, w, b, k,
                       glog, word_idx, word_bits, counts);
  }
  const dim3 grid((b + WW_WARPS - 1) / WW_WARPS);
  return launch_grid(dense_words_kernel, grid, WW_WARPS * 32, 0, s, words, w, b, k, word_idx,
                     word_bits, counts);
}
