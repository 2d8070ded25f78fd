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
// What bounds them on the H100. At cfg5's retained side (1M topics, ~7,800
// chunks padded to 8,192, int16 tiles, L = 8) a broad scan must read, of
// every live tile, the rows its filters test: rlen, flags and the token
// rows of their literal levels. The broad filters (#, +/#, v0_x/+/+/#, ...)
// compare at most level 0, so that is 3 of the L+3 rows, ~5.6 MB, plus
// 2 MB of words written: ~2.3 us at 3.35 TB/s. Each row test costs ~6
// integer operations plus 2 per literal level. The gather tier reads only
// the tiles its candidates name (often a few per filter, the rest chunk
// 0), so a small batch is bound by launch and latency, not by either rate.
//
// What the design does about it (a simple design that is right first).
//   - Lane k tests rows k, k+32, k+64, k+96 of its tile: each field load
//     is one coalesced 64- or 128-byte warp access, and __ballot_sync
//     gives the four words directly, lane k as bit k.
//   - A test reads only the rows it needs: rlen; flags only for a filter
//     that starts with a wildcard; the token rows down to the deepest
//     literal (non-'+') level within the filter's prefix (the full tier:
//     of any filter in the staged group). Levels past the prefix are not
//     loaded or tested, and the level loop is warp-uniform (one filter per
//     warp at a time).
//   - Gather: a warp per (filter, slot); the filter's fields are read by
//     every lane from one address (a broadcast).
//   - Full: a block per run of tiles. The broad filters' encodings are
//     staged in shared memory once per block; each warp loads a tile's
//     needed rows into registers once (L <= 8 or 16; any L reads the
//     level fields from L1 as it tests them) and loops over the filters,
//     so the table is read from device memory once per call, not once per
//     filter.
//   - No atomics and no shared state between warps: every word has one
//     writer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // rows per tile (ops/partitioned.py CHUNK)
constexpr int kWordsPerChunk = kChunk / 32;
constexpr int kPlusTok = 1;  // ops/encode.py PLUS_TOK
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxStageBytes = 48 * 1024;  // static shared-memory limit
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// One filter's scalar fields.
struct Filter {
  int flen;
  int fprefix;
  int fhash;
  int fwild;
};

// The rows lane k tests, k + 32q for q = 0..3, of one tile. MAXL > 0: the
// L <= MAXL level fields sit in registers. MAXL == 0: any L; the level
// fields are loaded as they are tested.
template <typename T, int MAXL>
struct Rows {
  const T* tile;
  int rlen[4];
  bool dollar[4];
  int tok[MAXL > 0 ? MAXL : 1][4];

  // Loads rlen, the flags row when ``flags`` (a filter to test starts
  // with a wildcard) and, into registers, the token rows below ``nload``
  // (the deepest literal level the filters to test compare, plus one).
  __device__ __forceinline__ void load(const T* t, int lvl, int nload, bool flags) {
    tile = t;
    const int lane = lane_id();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rlen[q] = __ldg(t + lvl * kChunk + q * 32 + lane);
      dollar[q] = flags && (__ldg(t + (lvl + 2) * kChunk + q * 32 + lane) & 2) != 0;
    }
    if constexpr (MAXL > 0) {
#pragma unroll
      for (int i = 0; i < MAXL; ++i) {
        if (i < nload) {
#pragma unroll
          for (int q = 0; q < 4; ++q) tok[i][q] = __ldg(t + i * kChunk + q * 32 + lane);
        }
      }
    }
  }

  // → bit q set iff row lane + 32q matches the filter. ``ftok`` points at
  // the filter's L tokens (device or shared memory, the same address for
  // every lane).
  __device__ __forceinline__ unsigned test(const int* ftok, int lvl,
                                           const Filter& f) const {
    unsigned ok = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool len_ok = f.fhash ? rlen[q] >= f.fprefix : rlen[q] == f.flen;
      ok |= static_cast<unsigned>((rlen[q] >= 1) & len_ok & !(dollar[q] & (f.fwild != 0)))
            << q;
    }
    const int np = min(lvl, f.fprefix);  // levels within the filter's prefix
    if constexpr (MAXL > 0) {
#pragma unroll
      for (int i = 0; i < MAXL; ++i) {
        if (i < np) {
          const int ft = ftok[i];
          if (ft != kPlusTok) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (tok[i][q] != ft) ok &= ~(1u << q);
            }
          }
        }
      }
    } else {
      const int lane = lane_id();
      for (int i = 0; i < np; ++i) {
        const int ft = ftok[i];
        if (ft == kPlusTok) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (__ldg(tile + i * kChunk + q * 32 + lane) != ft) ok &= ~(1u << q);
        }
      }
    }
    return ok;
  }
};

// The deepest literal (non-'+') level a filter compares, plus one: the
// token rows a test of it reads.
__device__ __forceinline__ int literal_depth(const int* ftok, int lvl, int fprefix) {
  int d = 0;
  const int np = min(lvl, fprefix);
  for (int i = 0; i < np; ++i) {
    if (ftok[i] != kPlusTok) d = i + 1;
  }
  return d;
}

// Four row bits per lane → the tile's four words (ballots), stored by lanes
// 0..3 at o[0..3].
__device__ __forceinline__ void store_words(int* o, unsigned bits) {
  const unsigned w0 = __ballot_sync(kFull, bits & 1u);
  const unsigned w1 = __ballot_sync(kFull, bits & 2u);
  const unsigned w2 = __ballot_sync(kFull, bits & 4u);
  const unsigned w3 = __ballot_sync(kFull, bits & 8u);
  const int lane = lane_id();
  if (lane < kWordsPerChunk) {
    const unsigned w = lane == 0 ? w0 : lane == 1 ? w1 : lane == 2 ? w2 : w3;
    o[lane] = static_cast<int>(w);
  }
}

// Warp w serves filter w / nc, slot w % nc.
template <typename T, int MAXL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
retained_gather_kernel(const T* __restrict__ tiles, int nchunks, int lvl,
                       const int* __restrict__ ftok,
                       const int* __restrict__ flen,
                       const int* __restrict__ fprefix,
                       const int* __restrict__ fhash,
                       const int* __restrict__ fwild,
                       const int* __restrict__ chunk_ids, int nb, int nc,
                       int* __restrict__ out) {
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)nb * nc) return;  // the whole warp leaves together
  const int b = static_cast<int>(warp / nc);
  const int cid = __ldg(chunk_ids + warp);
  unsigned bits = 0;
  if (cid >= 0 && cid < nchunks) {  // warp-uniform
    const Filter f{__ldg(flen + b), __ldg(fprefix + b), __ldg(fhash + b),
                   __ldg(fwild + b)};
    const int* ft = ftok + (size_t)b * lvl;
    Rows<T, MAXL> r;
    r.load(tiles + (size_t)cid * (lvl + 3) * kChunk, lvl,
           literal_depth(ft, lvl, f.fprefix), f.fwild != 0);
    bits = r.test(ft, lvl, f);
  }
  store_words(out + warp * kWordsPerChunk, bits);
}

// Block k serves tiles [k*run, k*run + run), a warp per tile at a time.
// The filters are staged ``group`` at a time: s_tok [group][lvl], then
// s_meta [group][4] (flen, fprefix, fhash, fwild).
template <typename T, int MAXL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
retained_full_kernel(const T* __restrict__ tiles, int nchunks, int lvl,
                     const int* __restrict__ ftok,
                     const int* __restrict__ flen,
                     const int* __restrict__ fprefix,
                     const int* __restrict__ fhash,
                     const int* __restrict__ fwild, int nb, int group,
                     int run, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* s_tok = smem;
  int* s_meta = smem + group * lvl;
  __shared__ int s_nload;  // the group's deepest literal level, plus one
  __shared__ int s_flags;  // a filter of the group starts with a wildcard
  const int c0 = blockIdx.x * run;
  const int c1 = min(c0 + run, nchunks);
  const size_t row_words = (size_t)nchunks * kWordsPerChunk;
  for (int g0 = 0; g0 < nb; g0 += group) {
    const int gn = min(group, nb - g0);
    __syncthreads();  // the previous group's filters are no longer read
    for (int k = threadIdx.x; k < gn * lvl; k += blockDim.x) {
      s_tok[k] = __ldg(ftok + (size_t)g0 * lvl + k);
    }
    for (int k = threadIdx.x; k < gn; k += blockDim.x) {
      s_meta[4 * k] = __ldg(flen + g0 + k);
      s_meta[4 * k + 1] = __ldg(fprefix + g0 + k);
      s_meta[4 * k + 2] = __ldg(fhash + g0 + k);
      s_meta[4 * k + 3] = __ldg(fwild + g0 + k);
    }
    if (threadIdx.x == 0) {
      s_nload = 0;
      s_flags = 0;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < gn; k += blockDim.x) {
      atomicMax(&s_nload, literal_depth(s_tok + k * lvl, lvl, s_meta[4 * k + 1]));
      if (s_meta[4 * k + 3] != 0) atomicOr(&s_flags, 1);
    }
    __syncthreads();
    const int nload = s_nload;
    const bool flags = s_flags != 0;
    for (int c = c0 + (threadIdx.x >> 5); c < c1; c += kWarpsPerBlock) {
      Rows<T, MAXL> r;
      r.load(tiles + (size_t)c * (lvl + 3) * kChunk, lvl, nload, flags);
      int* o = out + (size_t)g0 * row_words + (size_t)c * kWordsPerChunk;
      for (int j = 0; j < gn; ++j) {
        const Filter f{s_meta[4 * j], s_meta[4 * j + 1], s_meta[4 * j + 2],
                       s_meta[4 * j + 3]};
        store_words(o + (size_t)j * row_words, r.test(s_tok + j * lvl, lvl, f));
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T, int MAXL>
int launch_gather(const T* tiles, int nchunks, int lvl, const int* ftok,
                  const int* flen, const int* fprefix, const int* fhash,
                  const int* fwild, const int* chunk_ids, int b, int nc,
                  int* out, cudaStream_t stream) {
  const long long warps = (long long)b * nc;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  retained_gather_kernel<T, MAXL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      tiles, nchunks, lvl, ftok, flen, fprefix, fhash, fwild, chunk_ids, b, nc, out);
  return (int)cudaGetLastError();
}

template <typename T, int MAXL>
int launch_full(const T* tiles, int nchunks, int lvl, const int* ftok,
                const int* flen, const int* fprefix, const int* fhash,
                const int* fwild, int b, int* out, cudaStream_t stream) {
  const int per_filter = (lvl + 4) * (int)sizeof(int);
  int group = kMaxStageBytes / per_filter;
  if (group < 1) return (int)cudaErrorInvalidValue;
  if (group > b) group = b;
  // runs of whole warps' worth of tiles, about kBlocksPerSm blocks per SM
  const long long target = (long long)sm_count() * kBlocksPerSm;
  int run = (int)((nchunks + target - 1) / target);
  run = ((run + kWarpsPerBlock - 1) / kWarpsPerBlock) * kWarpsPerBlock;
  const unsigned blocks = (unsigned)((nchunks + run - 1) / run);
  retained_full_kernel<T, MAXL><<<blocks, kWarpsPerBlock * 32,
                                  (size_t)group * per_filter, stream>>>(
      tiles, nchunks, lvl, ftok, flen, fprefix, fhash, fwild, b, group, run, out);
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
// pointer; tiles are int16 (tile_bytes 2) or int32 (4), every other input
// int32; the caller allocates out. Each returns cudaGetLastError() after
// the launch (0 = launched).

extern "C" int launch_retained_scan_gather(const void* tiles, int tile_bytes,
                                           int nchunks, int lvl,
                                           const int* ftok, const int* flen,
                                           const int* fprefix,
                                           const int* fhash, const int* fwild,
                                           const int* chunk_ids, int b, int nc,
                                           int* out, void* stream) {
  if (b <= 0 || nc <= 0) return 0;
  if (lvl < 1) return (int)cudaErrorInvalidValue;
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
  if (lvl < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_bytes == 2)
    return full_by_levels(static_cast<const int16_t*>(tiles), nchunks, lvl,
                          ftok, flen, fprefix, fhash, fwild, b, out, s);
  if (tile_bytes == 4)
    return full_by_levels(static_cast<const int32_t*>(tiles), nchunks, lvl,
                          ftok, flen, fprefix, fhash, fwild, b, out, s);
  return (int)cudaErrorInvalidValue;
}
