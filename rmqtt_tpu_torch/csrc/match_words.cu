// Partitioned-match words kernels for Hopper (sm_90a).
//
// What they replace. Two Pallas TPU kernels of the JAX package:
//   - launch_match_words_packed replaces rmqtt_tpu/ops/pallas_match.py
//     match_words_pallas_packed (body _kernel_packed): bit-packed tiles
//     [up_chunks, groups*128] int32, four byte planes per int32 lane.
//   - launch_match_words_legacy replaces rmqtt_tpu/ops/pallas_match.py
//     match_words_pallas (body _kernel): field-major tiles
//     [up_chunks, L+3, 128] int16 or int32 (L token rows, flen, prefix_len,
//     flags bit0 has_hash / bit1 first_wild).
// Both compute, for every topic b and candidate slot k, the 128-row match
// mask of tile chunk_ids[b, k] and pack it into four uint32 words:
// out[b, k*4 + w] bit i = row w*32 + i (the JAX bit order). The plain
// PyTorch twins are rmqtt_tpu_torch/ops/match_words.py
// match_words_{packed,legacy}_plain.
//
// What bounds them on the H100. Per call the function must read the tiles
// its candidates name (at most the resident table, which fits the 50 MB
// L2: 8.4 MB packed at 1M filters), chunk_ids [B, NC] int32, the topic
// tokens [B, nlvl] and write [B, NC*4] int32 words. At B=16384, NC=32,
// groups=2, nlvl=6 that is about 8.4 + 2.1 + 0.5 + 8.4 MB, or ~5.8 us at
// 3.35 TB/s. The integer work is about B*NC*128*(2*nlvl+6) operations
// (~1.2e9), or ~18 us at the card's 67 T/s non-tensor rate: the function
// is bound by operations, not bytes.
//
// What this simple design does about it. One block of 128 threads per
// (topic, candidate slot); thread r tests row r, each warp folds its 32
// row results into one word with __ballot_sync (ballot bit i = lane i, the
// JAX bit order). Neighbouring threads read neighbouring lanes of the tile
// (coalesced 512-byte rows), the topic tokens come through shared memory
// once per block, and there is no BT batch constraint. Topics that share a
// candidate tile each reload it (from L2); reusing a tile across the
// topics that name it (shared memory or TMA staging, one warp per topic
// group) and skipping the padding slots are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // rows per tile (ops/partitioned.py CHUNK)
constexpr int kWordsPerChunk = kChunk / 32;
constexpr int kPlusTok = 1;  // ops/encode.py PLUS_TOK

// One level of the row test: the filter token equals the topic's, is '+',
// or the level lies beyond the filter's prefix.
__device__ __forceinline__ bool level_ok(int f, int t, int plen, int level) {
  return f == t || f == kPlusTok || plen <= level;
}

// The level-independent rest of the row test: the length rule ('#' filters
// need tlen >= prefix, others tlen == flen) and $-topic isolation from
// wildcard-first filters.
__device__ __forceinline__ bool row_accept(bool levels_ok, int flen, int plen,
                                           int hh, int fw, int tlen,
                                           int tdollar) {
  bool len_ok = hh ? (tlen >= plen) : (tlen == flen);
  return levels_ok && len_ok && !(tdollar && fw);
}

// Pack this warp's row results into one word and store it.
__device__ __forceinline__ void store_word(bool m, int* out_slot) {
  unsigned word = __ballot_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) {
    out_slot[threadIdx.x >> 5] = static_cast<int>(word);
  }
}

__global__ void __launch_bounds__(kChunk)
match_words_packed_kernel(const int* __restrict__ tiles, int nchunks,
                          int groups, const int* __restrict__ ttok, int nlvl,
                          unsigned wide_mask, int meta_plane,
                          const int* __restrict__ tlen,
                          const int* __restrict__ tdollar,
                          const int* __restrict__ chunk_ids, int nc,
                          int* __restrict__ out) {
  extern __shared__ int s_tok[];
  const int b = blockIdx.x / nc;
  const int k = blockIdx.x - b * nc;
  const int r = threadIdx.x;
  for (int i = r; i < nlvl; i += blockDim.x) s_tok[i] = ttok[(size_t)b * nlvl + i];
  __syncthreads();
  int* out_slot = out + ((size_t)b * nc + k) * kWordsPerChunk;
  const int cid = __ldg(chunk_ids + (size_t)b * nc + k);
  if (cid < 0 || cid >= nchunks) {  // never produced by the encoder
    store_word(false, out_slot);
    return;
  }
  const int* tile = tiles + (size_t)cid * groups * kChunk + r;
  const int meta_lane = __ldg(tile + (meta_plane >> 2) * kChunk);
  const int meta = (meta_lane >> ((meta_plane & 3) * 8)) & 0xFF;
  const int flen = (meta & 31) - 1;  // empty rows encode flen+1 = 0
  const int hh = (meta >> 5) & 1;
  const int fw = (meta >> 6) & 1;
  const int plen = flen - hh;
  bool ok = true;
  int plane = 0;
  int cur_group = -1;
  int lane = 0;
  for (int i = 0; i < nlvl; ++i) {
    // planes are visited in increasing order: each lane loads once
    int g = plane >> 2;
    if (g != cur_group) {
      lane = __ldg(tile + g * kChunk);
      cur_group = g;
    }
    int f = (lane >> ((plane & 3) * 8)) & 0xFF;
    ++plane;
    if ((wide_mask >> i) & 1u) {
      g = plane >> 2;
      if (g != cur_group) {
        lane = __ldg(tile + g * kChunk);
        cur_group = g;
      }
      f |= ((lane >> ((plane & 3) * 8)) & 0xFF) << 8;
      ++plane;
    }
    ok = ok && level_ok(f, s_tok[i], plen, i);
  }
  const bool m = row_accept(ok, flen, plen, hh, fw, __ldg(tlen + b),
                            __ldg(tdollar + b));
  store_word(m, out_slot);
}

template <typename T>
__global__ void __launch_bounds__(kChunk)
match_words_legacy_kernel(const T* __restrict__ tiles, int nchunks, int lvl,
                          const int* __restrict__ ttok,
                          const int* __restrict__ tlen,
                          const int* __restrict__ tdollar,
                          const int* __restrict__ chunk_ids, int nc,
                          int* __restrict__ out) {
  extern __shared__ int s_tok[];
  const int b = blockIdx.x / nc;
  const int k = blockIdx.x - b * nc;
  const int r = threadIdx.x;
  for (int i = r; i < lvl; i += blockDim.x) s_tok[i] = ttok[(size_t)b * lvl + i];
  __syncthreads();
  int* out_slot = out + ((size_t)b * nc + k) * kWordsPerChunk;
  const int cid = __ldg(chunk_ids + (size_t)b * nc + k);
  if (cid < 0 || cid >= nchunks) {  // never produced by the encoder
    store_word(false, out_slot);
    return;
  }
  const T* tile = tiles + (size_t)cid * (lvl + 3) * kChunk + r;
  const int flen = static_cast<int>(tile[lvl * kChunk]);
  const int plen = static_cast<int>(tile[(lvl + 1) * kChunk]);
  const int flags = static_cast<int>(tile[(lvl + 2) * kChunk]);
  bool ok = true;
  for (int i = 0; i < lvl; ++i) {
    ok = ok && level_ok(static_cast<int>(tile[i * kChunk]), s_tok[i], plen, i);
  }
  const bool m = row_accept(ok, flen, plen, flags & 1, (flags & 2) != 0,
                            __ldg(tlen + b), __ldg(tdollar + b));
  store_word(m, out_slot);
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
  dim3 grid((unsigned)b * (unsigned)nc);
  size_t smem = (size_t)(nlvl > 0 ? nlvl : 1) * sizeof(int);
  match_words_packed_kernel<<<grid, kChunk, smem, (cudaStream_t)stream>>>(
      tiles, nchunks, groups, ttok, nlvl, (unsigned)wide_mask, meta_plane,
      tlen, tdollar, chunk_ids, nc, out);
  return (int)cudaGetLastError();
}

extern "C" int launch_match_words_legacy(const void* tiles, int tile_bytes,
                                         int nchunks, int lvl,
                                         const int* ttok, const int* tlen,
                                         const int* tdollar,
                                         const int* chunk_ids, int b, int nc,
                                         int* out, void* stream) {
  if (b <= 0 || nc <= 0) return 0;
  dim3 grid((unsigned)b * (unsigned)nc);
  size_t smem = (size_t)(lvl > 0 ? lvl : 1) * sizeof(int);
  if (tile_bytes == 2) {
    match_words_legacy_kernel<int16_t><<<grid, kChunk, smem, (cudaStream_t)stream>>>(
        static_cast<const int16_t*>(tiles), nchunks, lvl, ttok, tlen, tdollar,
        chunk_ids, nc, out);
  } else if (tile_bytes == 4) {
    match_words_legacy_kernel<int32_t><<<grid, kChunk, smem, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(tiles), nchunks, lvl, ttok, tlen, tdollar,
        chunk_ids, nc, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
