// Dense full-scan match kernels for Hopper (sm_90a): every topic of a batch
// against every row of a FilterTable (the dense backend), the inverse,
// every wildcard filter of a batch against every stored retained topic,
// and the words path's compaction of the forward bitmap.
//
// What they replace. Three XLA device programs of the JAX package (it wrote
// no Pallas kernel for the dense backend):
//   - launch_dense_match_packed replaces rmqtt_tpu/ops/match.py:82
//     match_packed_impl, whose row test is _chunk_match (:55-68);
//   - launch_dense_match_retained replaces rmqtt_tpu/ops/match.py:176
//     match_retained_impl;
//   - launch_dense_match_words replaces the popcount and lax.top_k of
//     rmqtt_tpu/ops/match.py:151 match_words_impl.
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
// match_packed_plain, match_retained_plain and match_words_plain.
//
// What bounds them on the H100. cfg3's dense table has F = 2^20 rows of
// L = 8 levels (32 MiB of tokens, ~42 MiB with the metadata) and the batch
// B = 16,384 topics: 1.7e10 row tests. At ~(2L+6) = 22 integer operations
// a row test that is 3.8e11 operations, 22.6 ms at the integer pipe's
// 16.7 T/s; the bitmap written is B * F/8 = 2 GiB, 0.64 ms at 3.35 TB/s,
// and the table is read once. So the forward kernel is bound by issue.
// The words kernel reads that 2 GiB bitmap once and writes B * (2K + 1)
// ints: bound by bytes, 0.646 ms. The inverse at cfg5's retained side
// (2^20 rows, 64 filters) is 6.7e7 row tests, 1.5e9 operations, ~0.09 ms,
// and writes 8 MiB.
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
// The words kernel (dense_words_kernel): a warp a topic, four 16-byte
// loads a lane in flight (so W must be a multiple of 4 and the bitmap
// 16-byte aligned, as the matcher's [B, capacity / 32] bitmap is); a stretch of all-zero words costs one vote; where
// a word is nonzero, four ballots give each word its rank among the
// nonzero words, and a word of rank below K is written at that slot. Its
// popcounts make counts. When the row has fewer than K nonzero words, a
// second pass over the row's first words (at most K + nnz of them, from
// L2) ranks the zero words and writes the first K - nnz after them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PLUS_TOK = 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WORDS = 8;          // words a block covers, one warp each
constexpr int ROWS = WORDS * 32;  // rows a block stages
constexpr int THREADS = WORDS * 32;
constexpr int GROUPS = 4;         // groups of 32 filters the inverse block walks
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

// Inverse: staged row tokens, metadata {rlen, rdollar}; the filter's
// tokens and masks in registers.
template <int LR>
__global__ void __launch_bounds__(THREADS)
dense_retained_kernel(const int* __restrict__ rtok, const int* __restrict__ rlen,
                      const unsigned char* __restrict__ rdollar, int nrows,
                      int lvl, const int* __restrict__ ftok,
                      const int* __restrict__ flen,
                      const int* __restrict__ fprefix,
                      const unsigned char* __restrict__ fhash,
                      const unsigned char* __restrict__ fwild, int b,
                      int* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int ls = lvl < LR ? lvl : LR;
  int2* s_meta = reinterpret_cast<int2*>(smem);                // [ROWS]
  int* s_tok = reinterpret_cast<int*>(s_meta + ROWS);          // [ROWS][ls]
  unsigned* s_out = reinterpret_cast<unsigned*>(s_tok + ROWS * ls);  // [32][9]
  const int row0 = blockIdx.x * ROWS;
  const int rows_here = min(ROWS, nrows - row0);
  const int nw = nrows >> 5;
  const int w0 = blockIdx.x * WORDS;
  for (int idx = threadIdx.x; idx < rows_here * ls; idx += THREADS) {
    const int r = idx / ls, i = idx - r * ls;
    s_tok[r * ls + i] = __ldg(rtok + (size_t)(row0 + r) * lvl + i);
  }
  for (int r = threadIdx.x; r < rows_here; r += THREADS)
    s_meta[r] = make_int2(__ldg(rlen + row0 + r), (int)__ldg(rdollar + row0 + r));
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = 0; g < GROUPS; ++g) {
    const int b0 = (blockIdx.y * GROUPS + g) * 32;
    if (b0 >= b) break;  // uniform over the block
    const int fb = b0 + lane;
    unsigned word = 0;
    if (fb < b && warp * 32 < rows_here) {
      const int* ft = ftok + (size_t)fb * lvl;
      const int fp = __ldg(fprefix + fb);
      const int fl = __ldg(flen + fb);
      const bool hh = __ldg(fhash + fb) != 0;
      const bool fw = __ldg(fwild + fb) != 0;
      int t[LR], msk[LR];
#pragma unroll
      for (int i = 0; i < LR; ++i) {
        t[i] = i < ls ? __ldg(ft + i) : 0;
        msk[i] = (i >= fp || t[i] == PLUS_TOK) ? 0 : -1;
      }
      for (int k = 0; k < 32; ++k) {
        const int r = warp * 32 + k;
        const int* rt = s_tok + r * ls;
        unsigned acc = 0;
#pragma unroll
        for (int i = 0; i < LR; ++i) {
          if (i < ls) acc |= (unsigned)((rt[i] ^ t[i]) & msk[i]);
        }
        for (int i = LR; i < lvl; ++i) {  // levels past the staged ones
          const int f = __ldg(ft + i);
          if (i < fp && f != PLUS_TOK)
            acc |= (unsigned)(f ^ __ldg(rtok + (size_t)(row0 + r) * lvl + i));
        }
        const int2 m = s_meta[r];
        const bool len_ok = hh ? m.x >= fp : m.x == fl;
        const bool hit = acc == 0 && len_ok && !(m.y && fw);
        word |= (unsigned)hit << k;
      }
    }
    s_out[lane * OUT_STRIDE + warp] = word;
    __syncthreads();
    const int ot = threadIdx.x / WORDS, ow = threadIdx.x % WORDS;
    if (b0 + ot < b && w0 + ow < nw)
      out[(size_t)(b0 + ot) * nw + w0 + ow] = (int)s_out[ot * OUT_STRIDE + ow];
    __syncthreads();
  }
}

// Levels staged in shared memory: all of them up to 32 (LR >= L), else 32.
inline int staged_levels(int lvl) { return lvl < 32 ? lvl : 32; }

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

// The inverse kernel's grid: a block for each 256 rows and 128 filters.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int nrows, int b, cudaStream_t s,
           Args... args) {
  const dim3 grid((nrows + ROWS - 1) / ROWS, (b + 32 * GROUPS - 1) / (32 * GROUPS));
  return launch_grid(kernel, grid, THREADS, smem, s, args...);
}

int check(int nrows, int lvl, int b) {
  if (nrows <= 0 || b <= 0) return -1;  // nothing to do
  if (lvl < 1 || nrows % 32 != 0 || (b + 32 * GROUPS - 1) / (32 * GROUPS) > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
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
  const int c = check(nrows, lvl, b);
  if (c) return c < 0 ? 0 : c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ls = staged_levels(lvl);
  const size_t smem = ROWS * sizeof(int2) + (size_t)ROWS * ls * sizeof(int) +
                      32 * OUT_STRIDE * sizeof(unsigned);
#define DENSE_RETAINED_ARGS rtok, rlen, rdollar, nrows, lvl, ftok, flen, fprefix, fhash, fwild, b, out
  if (lvl <= 8) return launch(dense_retained_kernel<8>, smem, nrows, b, s, DENSE_RETAINED_ARGS);
  if (lvl <= 16) return launch(dense_retained_kernel<16>, smem, nrows, b, s, DENSE_RETAINED_ARGS);
  return launch(dense_retained_kernel<32>, smem, nrows, b, s, DENSE_RETAINED_ARGS);
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
  const dim3 grid((b + WW_WARPS - 1) / WW_WARPS);
  return launch_grid(dense_words_kernel, grid, WW_WARPS * 32, 0, s,
                     reinterpret_cast<const unsigned*>(packed), w, b, k, word_idx, word_bits,
                     counts);
}
