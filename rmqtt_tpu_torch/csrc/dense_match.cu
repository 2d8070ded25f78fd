// Dense full-scan match kernels for Hopper (sm_90a): every topic of a batch
// against every row of a FilterTable (the dense backend), and the inverse,
// every wildcard filter of a batch against every stored retained topic.
//
// What they replace. Two XLA device programs of the JAX package (it wrote
// no Pallas kernel for the dense backend):
//   - launch_dense_match_packed replaces rmqtt_tpu/ops/match.py:82
//     match_packed_impl, whose row test is _chunk_match (:55-68);
//   - launch_dense_match_retained replaces rmqtt_tpu/ops/match.py:176
//     match_retained_impl.
// Forward: rows are filters, ftok [F, L] int32 ('+' = PLUS_TOK, levels past
// the filter PAD_TOK), flen, fprefix (levels before a trailing '#') int32,
// fhash, fwild (first level '+' or '#') bool; the batch is topics, ttok
// [B, L], tlen (true level count; padded topics -2) int32, tdollar bool.
// Row f matches topic b iff
//   every level i < L: i >= fprefix[f] or ftok[f,i] == ttok[b,i] or
//     ftok[f,i] == '+',
//   fhash[f] ? tlen[b] >= fprefix[f] : tlen[b] == flen[f],
//   !(tdollar[b] and fwild[f]).
// Inverse: rows are topic names, rtok [F, L], rlen, rdollar; the batch is
// filters, ftok [B, L], flen (padded -2), fprefix (padded L+1), fhash,
// fwild; the same test with the wildcard side swapped (the '+' and the
// prefix come from the batch, the $-flag from the row). Free rows have
// flen/rlen -1 and match nothing through the length rule alone.
// Output: out [B, F/32] int32, bit k of word w = row 32w + k, the JAX bit
// order (np.unpackbits(..., bitorder="little") reads it). The plain
// PyTorch twins are rmqtt_tpu_torch/ops/match.py match_packed_plain and
// match_retained_plain.
//
// What bounds them on the H100. cfg3's dense table has F = 2^20 rows of
// L = 8 levels (32 MiB of tokens, ~42 MiB with the metadata) and the batch
// B = 16,384 topics: 1.7e10 row tests. At ~(2L+6) = 22 integer operations
// a row test that is 3.8e11 operations, 22.6 ms at the integer pipe's
// 16.7 T/s; the bitmap written is B * F/8 = 2 GiB, 0.64 ms at 3.35 TB/s,
// and the table is read once. So the forward kernel is bound by integer
// issue. The inverse at cfg5's retained side (2^20 rows, 64 filters) is
// 6.7e7 row tests, 1.5e9 operations, ~0.09 ms, and writes 8 MiB.
//
// What the design does about it. A first design that is right and simple:
//   - one thread computes one output word: its topic (filter) against 32
//     consecutive rows. A warp is 32 consecutive topics on one word, so
//     every lane reads the same row from shared memory (a broadcast, no
//     bank conflict), and a block of 8 warps covers 256 rows;
//   - the block stages its 256 rows once in shared memory and walks 4
//     groups of 32 topics over them, so the table is read from L2 once a
//     128 topics, not once a topic;
//   - forward, each staged level is a pair {token, mask} with mask 0 where
//     the level always passes ('+' or past the prefix) and ~0 elsewhere,
//     so a level costs one shared load and two LOP3s:
//     acc |= (token ^ topic_token) & mask; inverse, the mask belongs to
//     the filter and sits in registers beside its tokens;
//   - a topic's (filter's) first LR tokens sit in registers, LR in {8, 16,
//     32} chosen by L at launch, the row levels below LR in shared memory
//     (dynamic, sized by L); levels past 32 (a deep filter grows L) are
//     read from global memory inside the kernel;
//   - the block's 32 x 8 words go out through shared memory, each topic's
//     8 words as one 32-byte segment, instead of 32 scattered 4-byte stores
//     a warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PLUS_TOK = 1;
constexpr int WORDS = 8;          // words a block covers, one warp each
constexpr int ROWS = WORDS * 32;  // rows a block stages
constexpr int THREADS = WORDS * 32;
constexpr int GROUPS = 4;         // groups of 32 topics a block walks
constexpr int OUT_STRIDE = WORDS + 1;

// Forward: staged levels {token, mask}, metadata {flen, fprefix, flags}.
template <int LR>
__global__ void __launch_bounds__(THREADS)
dense_packed_kernel(const int* __restrict__ ftok, const int* __restrict__ flen,
                    const int* __restrict__ fprefix,
                    const unsigned char* __restrict__ fhash,
                    const unsigned char* __restrict__ fwild, int nrows, int lvl,
                    const int* __restrict__ ttok, const int* __restrict__ tlen,
                    const unsigned char* __restrict__ tdollar, int b,
                    int* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int ls = lvl < LR ? lvl : LR;
  int4* s_meta = smem;                                        // [ROWS]
  int2* s_lv = reinterpret_cast<int2*>(s_meta + ROWS);        // [ROWS][ls]
  unsigned* s_out = reinterpret_cast<unsigned*>(s_lv + ROWS * ls);  // [32][9]
  const int row0 = blockIdx.x * ROWS;
  const int rows_here = min(ROWS, nrows - row0);
  const int nw = nrows >> 5;
  const int w0 = blockIdx.x * WORDS;
  for (int idx = threadIdx.x; idx < rows_here * ls; idx += THREADS) {
    const int r = idx / ls, i = idx - r * ls;
    const int f = __ldg(ftok + (size_t)(row0 + r) * lvl + i);
    const bool pass = i >= __ldg(fprefix + row0 + r) || f == PLUS_TOK;
    s_lv[r * ls + i] = make_int2(f, pass ? 0 : -1);
  }
  for (int r = threadIdx.x; r < rows_here; r += THREADS) {
    s_meta[r] = make_int4(__ldg(flen + row0 + r), __ldg(fprefix + row0 + r),
                          (int)__ldg(fhash + row0 + r) |
                              ((int)__ldg(fwild + row0 + r) << 1),
                          0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = 0; g < GROUPS; ++g) {
    const int b0 = (blockIdx.y * GROUPS + g) * 32;
    if (b0 >= b) break;  // uniform over the block
    const int tb = b0 + lane;
    unsigned word = 0;
    if (tb < b && warp * 32 < rows_here) {
      const int* tt = ttok + (size_t)tb * lvl;
      int t[LR];
#pragma unroll
      for (int i = 0; i < LR; ++i) t[i] = i < ls ? __ldg(tt + i) : 0;
      const int tl = __ldg(tlen + tb);
      const bool td = __ldg(tdollar + tb) != 0;
      for (int k = 0; k < 32; ++k) {
        const int r = warp * 32 + k;
        const int2* lv = s_lv + r * ls;
        unsigned acc = 0;
#pragma unroll
        for (int i = 0; i < LR; ++i) {
          if (i < ls) {
            const int2 v = lv[i];
            acc |= (unsigned)((v.x ^ t[i]) & v.y);
          }
        }
        const int4 m = s_meta[r];
        for (int i = LR; i < lvl; ++i) {  // levels past the staged ones
          const int f = __ldg(ftok + (size_t)(row0 + r) * lvl + i);
          if (i < m.y && f != PLUS_TOK) acc |= (unsigned)(f ^ __ldg(tt + i));
        }
        const bool len_ok = (m.z & 1) ? tl >= m.y : tl == m.x;
        const bool hit = acc == 0 && len_ok && !(td && (m.z & 2));
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
int launch(Kernel kernel, size_t smem, int nrows, int b, cudaStream_t s,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((nrows + ROWS - 1) / ROWS, (b + 32 * GROUPS - 1) / (32 * GROUPS));
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

int check(int nrows, int lvl, int b) {
  if (nrows <= 0 || b <= 0) return -1;  // nothing to do
  if (lvl < 1 || nrows % 32 != 0 || (b + 32 * GROUPS - 1) / (32 * GROUPS) > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
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
  const int c = check(nrows, lvl, b);
  if (c) return c < 0 ? 0 : c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ls = staged_levels(lvl);
  const size_t smem = ROWS * sizeof(int4) + (size_t)ROWS * ls * sizeof(int2) +
                      32 * OUT_STRIDE * sizeof(unsigned);
#define DENSE_PACKED_ARGS ftok, flen, fprefix, fhash, fwild, nrows, lvl, ttok, tlen, tdollar, b, out
  if (lvl <= 8) return launch(dense_packed_kernel<8>, smem, nrows, b, s, DENSE_PACKED_ARGS);
  if (lvl <= 16) return launch(dense_packed_kernel<16>, smem, nrows, b, s, DENSE_PACKED_ARGS);
  return launch(dense_packed_kernel<32>, smem, nrows, b, s, DENSE_PACKED_ARGS);
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
