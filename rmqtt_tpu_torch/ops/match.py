"""The dense backend: batched wildcard matching by a full scan, in PyTorch.

The port of the JAX package's ``ops/match.py``. It replaces the
reference's per-publish trie DFS (`rmqtt/src/trie.rs:288-408`, the hot loop
of `Router::matches`, `rmqtt/src/router.rs:174-265`) with one full scan of
the flattened automaton (``FilterTable``). For a batch of B encoded topics
against F filter rows padded to L levels::

    level_ok[b,f,i] = (i >= prefix_len[f]) | (ftok[f,i] == ttok[b,i])
                      | (ftok[f,i] == PLUS)
    prefix_ok[b,f]  = AND_i level_ok[b,f,i]
    len_ok[b,f]     = has_hash[f] ? tlen[b] >= prefix_len[f]
                                  : tlen[b] == flen[f]
    dollar_ok[b,f]  = !(tdollar[b] & first_wild[f])
    match[b,f]      = prefix_ok & len_ok & dollar_ok

``+`` matches any single level (blank included), ``#`` matches the rest
including zero levels (``tlen >= prefix_len``: the parent match of
trie.rs:330-338), ``$``-first topics are isolated from wildcard-first
filters (trie.rs:342-347). The result is a packed bitmap ``[B, F/32]``:
bit k of word w is row ``32w + k``, held in int32 tensors (the JAX
package's uint32 words, bit for bit).

- :func:`match_packed` — the bitmap. Kernel: ``csrc/dense_match.cu``
  ``launch_dense_match_packed``, replacing the XLA ``match_packed_impl``.
  Plain twin: :func:`match_packed_plain`.
- :func:`match_retained` — the inverse, wildcard filters against stored
  retained topic names (the SUBSCRIBE-side scan). Kernel:
  ``launch_dense_match_retained``, replacing ``match_retained_impl``.
  Plain twin: :func:`match_retained_plain`.
- :func:`match_words` — the words path's compaction of the bitmap: each
  topic's first nonzero words, their bits and its match count. Kernel:
  ``launch_dense_match_words``, replacing ``match_words_impl``'s popcount
  and ``lax.top_k``; :func:`match_words_wire` gives the three as one wire.
  Plain twin: :func:`match_words_plain`.
- :func:`match_compact` — torch ops over the kernel's bitmap
  (``match_compact_impl``), on no main path.

A wrapper given CPU tensors runs its plain twin; given CUDA tensors it
launches its kernel or raises — it never falls back. Each wrapper counts
its launches in ``<wrapper>.launches``. :class:`DenseMatcher` keeps the
device mirror of a table and serves ``match``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rmqtt_tpu_torch.ops._build import KernelError
from rmqtt_tpu_torch.ops.compact_tail import (match_words_plain, split_topk_wire,
                                              topk_wire_plain, words_wire)
from rmqtt_tpu_torch.ops.encode import PLUS_TOK, FilterTable
from rmqtt_tpu_torch.ops.partitioned import _FP_UPLOAD, resolve_device, to_device
from rmqtt_tpu_torch.utils.devfetch import fetch

# Filters a compact-mode step unpacks (the JAX scan's chunk).
DEFAULT_CHUNK = 1 << 16
# Per-topic matched-fid capacity of the compact and words outputs. Fan-out
# beyond this falls back to a per-row bitmap fetch (rare in routing
# workloads); keeping it small keeps the device→host transfer small.
DEFAULT_MAX_MATCHES = 128
# Elements of the [B, rows, L] comparison a plain-twin step materialises.
_PLAIN_ELEMS = 1 << 26


# ------------------------------------------------------------ plain twins
def _pack_rows(m: torch.Tensor) -> torch.Tensor:
    """``[B, n]`` bool (n a multiple of 32) → ``[B, n/32]`` int32, bit k of
    word w = column ``32w + k`` (two's-complement view of the uint32)."""
    b, n = m.shape
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    v = (m.reshape(b, n // 32, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _plain_step(b: int, f: int, lvl: int) -> int:
    """Rows a plain-twin step compares, a multiple of 32, so that the
    ``[B, rows, L]`` comparison stays near ``_PLAIN_ELEMS`` elements."""
    rows = _PLAIN_ELEMS // max(1, b * lvl) // 32 * 32
    return max(32, min(f, rows))


def match_packed_plain(ftok, flen, prefix_len, has_hash, first_wild, ttok, tlen,
                       tdollar) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel (and of the JAX package's
    ``match_packed_impl``): the row formula on ``[B, rows, L]`` steps, bits
    packed per 32 rows. → ``[B, F/32]`` int32."""
    f, lvl = ftok.shape
    b = ttok.shape[0]
    dev = ftok.device
    ttok = ttok.to(torch.int32)
    tlen = tlen.to(torch.int32)[:, None]
    tdollar = tdollar.to(torch.bool)[:, None]
    lvl_idx = torch.arange(lvl, dtype=torch.int32, device=dev)
    out = torch.empty((b, f // 32), dtype=torch.int32, device=dev)
    step = _plain_step(b, f, lvl)
    for s in range(0, f, step):
        fc = ftok[s:s + step].to(torch.int32)
        pl = prefix_len[s:s + step].to(torch.int32)
        fl = flen[s:s + step].to(torch.int32)
        hh = has_hash[s:s + step].to(torch.bool)
        fw = first_wild[s:s + step].to(torch.bool)
        level_ok = ((fc[None] == ttok[:, None]) | (fc == PLUS_TOK)[None]
                    | (lvl_idx[None, None] >= pl[None, :, None]))
        len_ok = torch.where(hh[None], tlen >= pl[None], tlen == fl[None])
        m = level_ok.all(-1) & len_ok & ~(tdollar & fw[None])
        out[:, s // 32:(s + fc.shape[0]) // 32] = _pack_rows(m)
    return out


def match_retained_plain(rtok, rlen, rdollar, ftok, flen, fprefix, fhash,
                         fwild) -> torch.Tensor:
    """Plain PyTorch twin of the inverse kernel (and of the JAX package's
    ``match_retained_impl``): B wildcard filters against F stored topic
    rows. → ``[B, F/32]`` int32."""
    f, lvl = rtok.shape
    b = ftok.shape[0]
    dev = rtok.device
    ftok = ftok.to(torch.int32)
    lvl_idx = torch.arange(lvl, dtype=torch.int32, device=dev)
    plus = (ftok == PLUS_TOK)[:, None, :]
    beyond = lvl_idx[None, None, :] >= fprefix.to(torch.int32)[:, None, None]
    fprefix = fprefix.to(torch.int32)[:, None]
    flen = flen.to(torch.int32)[:, None]
    fhash = fhash.to(torch.bool)[:, None]
    fwild = fwild.to(torch.bool)[:, None]
    out = torch.empty((b, f // 32), dtype=torch.int32, device=dev)
    step = _plain_step(b, f, lvl)
    for s in range(0, f, step):
        rc = rtok[s:s + step].to(torch.int32)
        rl = rlen[s:s + step].to(torch.int32)[None]
        rd = rdollar[s:s + step].to(torch.bool)[None]
        prefix_ok = ((rc[None] == ftok[:, None]) | plus | beyond).all(-1)
        len_ok = torch.where(fhash, rl >= fprefix, rl == flen)
        m = prefix_ok & len_ok & ~(rd & fwild)
        out[:, s // 32:(s + rc.shape[0]) // 32] = _pack_rows(m)
    return out


# --------------------------------------------------------------- wrappers
def _check_cuda(name: str, tensors, b: int, f: int, lvl: int) -> None:
    """Device, dtype, contiguity and shape checks of a dense launch:
    ``tensors`` maps argument name → (tensor, dtype, shape)."""
    dev = next(iter(tensors.values()))[0].device
    for arg, (t, dtype, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if f % 32:
        raise ValueError(f"{name}: {f} rows are not a multiple of 32")
    if lvl < 1:
        raise ValueError(f"{name}: {lvl} levels")
    if b > 65535 * 128:
        raise ValueError(f"{name}: a batch of {b} exceeds the grid ({65535 * 128})")


def _launch(name: str, fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err:
        raise KernelError(f"{name}: CUDA launch failed with error {err} "
                          f"({torch.cuda.get_device_name(dev)})")


def match_packed(ftok, flen, prefix_len, has_hash, first_wild, ttok, tlen,
                 tdollar) -> torch.Tensor:
    """Forward bitmap ``[B, F/32]`` int32. CUDA tensors (int32 tokens and
    lengths, bool flags, contiguous, one device) launch the kernel; CPU
    tensors run the plain twin."""
    dev = ftok.device
    if dev.type == "cpu":
        return match_packed_plain(ftok, flen, prefix_len, has_hash, first_wild,
                                  ttok, tlen, tdollar)
    if dev.type != "cuda":
        raise ValueError(f"match_packed: unsupported device {dev}")
    if ftok.dim() != 2 or ttok.dim() != 2:
        raise ValueError(f"match_packed: ftok {tuple(ftok.shape)} / ttok "
                         f"{tuple(ttok.shape)} are not [F, L] / [B, L]")
    f, lvl = ftok.shape
    b = ttok.shape[0]
    i32, bl = torch.int32, torch.bool
    _check_cuda("match_packed", {
        "ftok": (ftok, i32, (f, lvl)), "flen": (flen, i32, (f,)),
        "prefix_len": (prefix_len, i32, (f,)), "has_hash": (has_hash, bl, (f,)),
        "first_wild": (first_wild, bl, (f,)), "ttok": (ttok, i32, (b, lvl)),
        "tlen": (tlen, i32, (b,)), "tdollar": (tdollar, bl, (b,))}, b, f, lvl)
    out = torch.empty((b, f // 32), dtype=torch.int32, device=dev)
    if b == 0 or f == 0:
        return out
    from rmqtt_tpu_torch.ops._build import kernel_library

    _launch("match_packed", kernel_library().lib.launch_dense_match_packed, dev,
            ftok.data_ptr(), flen.data_ptr(), prefix_len.data_ptr(),
            has_hash.data_ptr(), first_wild.data_ptr(), f, lvl, ttok.data_ptr(),
            tlen.data_ptr(), tdollar.data_ptr(), b, out.data_ptr())
    match_packed.launches += 1
    return out


match_packed.launches = 0


def match_retained(rtok, rlen, rdollar, ftok, flen, fprefix, fhash,
                   fwild) -> torch.Tensor:
    """Inverse bitmap ``[B, F/32]`` int32 over the retained-topic rows.
    CUDA tensors launch the kernel; CPU tensors run the plain twin."""
    dev = rtok.device
    if dev.type == "cpu":
        return match_retained_plain(rtok, rlen, rdollar, ftok, flen, fprefix,
                                    fhash, fwild)
    if dev.type != "cuda":
        raise ValueError(f"match_retained: unsupported device {dev}")
    if rtok.dim() != 2 or ftok.dim() != 2:
        raise ValueError(f"match_retained: rtok {tuple(rtok.shape)} / ftok "
                         f"{tuple(ftok.shape)} are not [F, L] / [B, L]")
    f, lvl = rtok.shape
    b = ftok.shape[0]
    i32, bl = torch.int32, torch.bool
    _check_cuda("match_retained", {
        "rtok": (rtok, i32, (f, lvl)), "rlen": (rlen, i32, (f,)),
        "rdollar": (rdollar, bl, (f,)), "ftok": (ftok, i32, (b, lvl)),
        "flen": (flen, i32, (b,)), "fprefix": (fprefix, i32, (b,)),
        "fhash": (fhash, bl, (b,)), "fwild": (fwild, bl, (b,))}, b, f, lvl)
    out = torch.empty((b, f // 32), dtype=torch.int32, device=dev)
    if b == 0 or f == 0:
        return out
    from rmqtt_tpu_torch.ops._build import kernel_library

    _launch("match_retained", kernel_library().lib.launch_dense_match_retained, dev,
            rtok.data_ptr(), rlen.data_ptr(), rdollar.data_ptr(), f, lvl,
            ftok.data_ptr(), flen.data_ptr(), fprefix.data_ptr(), fhash.data_ptr(),
            fwild.data_ptr(), b, out.data_ptr())
    match_retained.launches += 1
    return out


match_retained.launches = 0


# ------------------------------------------------- torch ops over bitmaps
def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """``[B, W]`` int32 words → ``[B, W*32]`` bool, column ``32w + k`` = bit
    k of word w."""
    b, w = words.shape
    lanes = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> lanes) & 1).to(torch.bool).reshape(b, w * 32)


def match_compact(packed: torch.Tensor, chunk: int, max_matches: int):
    """Compacted matched filter ids from a bitmap (twin of the JAX
    ``match_compact_impl``): ``([B, max_matches] int32 (-1 padded), [B]
    int32 counts)``. Chunk by chunk of ``chunk`` rows, the matched columns
    are position-encoded (an earlier column a larger value) and the first
    ``min(max_matches, chunk)`` taken by ``torch.topk``, then appended to
    each topic's buffer; slots past ``max_matches`` go to a dump slot that
    is sliced off. ``counts`` is exact, so ``counts > max_matches`` marks
    the topics that overflowed. The nonzero values are unique, so
    ``torch.topk``'s order among ties (zeros) never reaches a valid slot."""
    b, w = packed.shape
    f = w * 32
    dev = packed.device
    chunk = min(chunk, f)
    kc = min(max_matches, chunk)
    out = torch.full((b, max_matches + 1), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    rank = chunk - torch.arange(chunk, dtype=torch.int32, device=dev)
    for off in range(0, f, chunk):
        m = _unpack_bits(packed[:, off // 32:(off + chunk) // 32])
        val = torch.where(m, rank[:m.shape[1]], 0)
        vals, idxs = torch.topk(val, kc, dim=1)
        hit = vals > 0
        dest = counts[:, None] + torch.cumsum(hit.to(torch.int32), dim=1) - 1
        dest = torch.where(hit & (dest < max_matches), dest, max_matches)
        out[rows, dest.to(torch.int64)] = torch.where(hit, off + idxs.to(torch.int32),
                                                      -1)
        counts = counts + m.sum(dim=1, dtype=torch.int32)
    return out[:, :max_matches], counts


def match_words(packed: torch.Tensor, max_words: int):
    """:func:`match_words_plain`'s output from a ``[B, W]`` int32 bitmap.
    A contiguous CUDA tensor launches the words kernel
    (``launch_dense_match_words``: one pass over each topic's row, in
    16-byte loads, so W must be a multiple of 4 and the tensor 16-byte
    aligned, as :class:`DenseMatcher`'s bitmap is), whose three outputs are
    views of one wire (``compact_tail.words_wire``); a CPU tensor runs the
    plain twin."""
    if packed.device.type == "cpu":
        return match_words_plain(packed, max_words)
    wire = match_words_wire(packed, max_words)
    b, w = packed.shape
    return split_topk_wire(wire, b, min(max_words, w))


def match_words_wire(packed: torch.Tensor, max_words: int) -> torch.Tensor:
    """:func:`match_words`'s three outputs as the one int32 wire
    ``[word_idx..., word_bits..., counts...]`` that the words path fetches:
    on the card the kernel writes it in place (a launch of
    :func:`match_words`); a CPU tensor runs the twin's ``topk_wire_plain``."""
    if packed.device.type == "cpu":
        return topk_wire_plain(packed, max_words)
    return words_wire(match_words, packed, max_words)


match_words.launches = 0


# ----------------------------------------------------------- host decode
def decode_words(word_idx: np.ndarray, word_bits: np.ndarray, counts: np.ndarray,
                 max_words: int):
    """Host-side decode of :func:`match_words` output → per-topic fid
    arrays. Returns (rows, overflow_rows): overflow rows (counts >
    max_words) come back as None and must be re-resolved via the bitmap
    path."""
    out: List[Optional[np.ndarray]] = []
    overflow: List[int] = []
    word_bits = np.ascontiguousarray(word_bits).view(np.uint32)
    for j in range(word_idx.shape[0]):
        if counts[j] > max_words:
            out.append(None)
            overflow.append(j)
            continue
        if counts[j] == 0:
            out.append(np.empty(0, dtype=np.int64))
            continue
        bits_j = word_bits[j]
        nz = bits_j != 0
        widx = word_idx[j][nz]
        words = bits_j[nz]
        # unpack each selected uint32 word to bit positions
        bitpos = np.unpackbits(words.view(np.uint8).reshape(-1, 4), axis=1,
                               bitorder="little")
        rows_w, cols = np.nonzero(bitpos)
        fids = widx[rows_w].astype(np.int64) * 32 + cols
        out.append(np.sort(fids))
    return out, overflow


def unpack_bitmap(packed: np.ndarray, nrows: Optional[int] = None) -> List[np.ndarray]:
    """Packed [B, W] 32-bit bitmaps → per-topic arrays of matched fids."""
    bits = np.unpackbits(np.ascontiguousarray(packed).view(np.uint8), axis=1,
                         bitorder="little")
    if nrows is not None:
        bits = bits[:, :nrows]
    return [np.nonzero(row)[0] for row in bits]


# `match()` switches from the bitmap to the words output when the bitmap
# fetch for the batch would exceed this many bytes — the device→host
# transfer otherwise dominates (0.5 GB per 4,096-topic batch at 1M rows).
COMPACT_BITMAP_BYTES = 8 << 20


class DenseArrays(NamedTuple):
    """The device mirror of a ``FilterTable``: the five match arrays."""

    tok: torch.Tensor
    flen: torch.Tensor
    prefix_len: torch.Tensor
    has_hash: torch.Tensor
    first_wild: torch.Tensor


class DenseMatcher:
    """Device-side mirror of a ``FilterTable`` and the batched match entry
    point: the counterpart of the JAX package's ``TpuMatcher``
    (``rmqtt_tpu/ops/match.py:277``), named for what it does rather than
    for a TPU.

    Re-uploads the table only when its version changed (subscription churn
    is orders of magnitude rarer than publishes); when no more than half
    the rows are dirty it scatters only the dirty rows into the resident
    arrays, in place (``RMQTT_DELTA_UPLOADS=0`` restores full uploads).
    Entry points run on CUDA unless the caller passes ``device="cpu"``;
    with no device given and no CUDA device they raise."""

    def __init__(self, table: FilterTable, chunk: int = DEFAULT_CHUNK, device=None,
                 max_matches: int = DEFAULT_MAX_MATCHES) -> None:
        self.table = table
        self.chunk = chunk
        self.device = resolve_device(device)
        self.max_matches = max_matches
        self._dev_version = -1
        self._dev_arrays: Optional[DenseArrays] = None
        self.delta_enabled = os.environ.get("RMQTT_DELTA_UPLOADS", "1") != "0"
        self._dev_capacity = -1
        self._dev_lvl = -1
        self.uploads = 0
        self.full_uploads = 0
        self.delta_uploads = 0
        self.upload_bytes = 0

    def _refresh(self) -> DenseArrays:
        t = self.table
        if self._dev_version == t.version and self._dev_arrays is not None:
            return self._dev_arrays
        # chaos seam (utils/failpoints.py): an injected upload fault fires
        # only when a real refresh (delta scatter or full put) is due
        if _FP_UPLOAD.action is not None:
            _FP_UPLOAD.fire_sync()
        # capture the version BEFORE reading journal/rows: a mutation
        # landing mid-refresh stays pending for the next refresh
        version = t.version
        # one shape-consistent snapshot of the five arrays (a _grow racing
        # the reads leaves mixed row counts: read again); both branches
        # read only this snapshot
        while True:
            host = (t.tok, t.flen, t.prefix_len, t.has_hash, t.first_wild)
            if all(a.shape[0] == host[0].shape[0] for a in host[1:]):
                break
        cap, lvl = host[0].shape
        if (self.delta_enabled and self._dev_arrays is not None
                and self._dev_capacity == cap and self._dev_lvl == lvl):
            rows = t.delta.since(self._dev_version)
            # a fid >= cap means a _grow reset the journal mid-refresh: full
            # upload of the snapshot; the grow's version bump heals it
            if (rows is not None and len(rows) <= cap // 2
                    and (not rows or max(rows) < cap)):
                if rows:
                    idx = np.asarray(rows, dtype=np.int64)
                    vals = tuple(a[idx] for a in host)
                    self.upload_bytes += sum(v.nbytes for v in vals)
                    didx = to_device(idx, self.device)
                    for dst, v in zip(self._dev_arrays, vals):
                        dst.index_copy_(0, didx, to_device(v, self.device))
                    self.uploads += 1
                    self.delta_uploads += 1
                self._dev_version = version
                return self._dev_arrays
        self._dev_arrays = DenseArrays(*(to_device(a, self.device) for a in host))
        self._dev_version = version
        self._dev_capacity = cap
        self._dev_lvl = lvl
        self.uploads += 1
        self.full_uploads += 1
        self.upload_bytes += sum(a.nbytes for a in host)
        return self._dev_arrays

    def _put(self, ttok, tlen, tdollar):
        return (to_device(np.asarray(ttok, dtype=np.int32), self.device),
                to_device(np.asarray(tlen, dtype=np.int32), self.device),
                to_device(np.asarray(tdollar, dtype=bool), self.device))

    def match_encoded(self, ttok: np.ndarray, tlen: np.ndarray,
                      tdollar: np.ndarray) -> torch.Tensor:
        """Match pre-encoded topics → device bitmap ``[B, capacity // 32]``."""
        dev = self._refresh()
        return match_packed(*dev, *self._put(ttok, tlen, tdollar))

    def match_encoded_compact(self, ttok: np.ndarray, tlen: np.ndarray,
                              tdollar: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compact match → (ids ``[B, max_matches]``, counts ``[B]``), on the
        device."""
        return match_compact(self.match_encoded(ttok, tlen, tdollar), self.chunk,
                             self.max_matches)

    def match(self, topics: Sequence[str], pad_to_pow2: bool = True) -> List[np.ndarray]:
        """Match topic strings → per-topic numpy arrays of matched fids: the
        bitmap path while the batch's bitmap fits ``COMPACT_BITMAP_BYTES``,
        else the words path, whose overflowing topics (more than
        ``max_matches`` matches) go back through the bitmap path."""
        b = len(topics)
        padded = 1 << (b - 1).bit_length() if (pad_to_pow2 and b > 1) else b
        ttok, tlen, tdollar = self.table.encode_topics(topics, pad_batch_to=padded)
        if padded * (self.table.capacity // 8) <= COMPACT_BITMAP_BYTES:
            packed = fetch(self.match_encoded(ttok, tlen, tdollar), "dense bitmap fetch")
            return unpack_bitmap(packed[:b], nrows=self.table.capacity)
        wire = match_words_wire(self.match_encoded(ttok, tlen, tdollar), self.max_matches)
        arr = fetch(wire, "dense words fetch")
        k = (arr.size - padded) // (2 * padded)
        word_idx = arr[:padded * k].reshape(padded, k)
        word_bits = arr[padded * k:2 * padded * k].reshape(padded, k)
        rows, overflow = decode_words(word_idx, word_bits, arr[2 * padded * k:],
                                      self.max_matches)
        rows = rows[:b]
        overflow = [j for j in overflow if j < b]
        if overflow:
            # rare fan-out overflow: re-resolve those topics via the bitmap
            otok, olen, odollar = self.table.encode_topics([topics[j] for j in overflow])
            packed = fetch(self.match_encoded(otok, olen, odollar),
                           "overflow bitmap fetch")
            full = unpack_bitmap(packed, nrows=self.table.capacity)
            for i, j in enumerate(overflow):
                rows[j] = full[i]
        return rows  # type: ignore[return-value]

    def hbm_breakdown(self) -> dict:
        """Device-memory model of the mirror: the five arrays' bytes."""
        st = self._dev_arrays
        nb = sum(a.numel() * a.element_size() for a in st) if st is not None else 0
        return {"layout": "dense", "tiles_bytes": nb, "fid_map_bytes": 0,
                "segments": 0, "total_bytes": nb}
