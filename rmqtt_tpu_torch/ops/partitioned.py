"""Partitioned automaton and the PUBLISH-routing matcher, in PyTorch.

The port of the JAX package's ``ops/partitioned.py``. Its host half is a
numpy copy: filters are bucketed by their first levels into *partitions*
(``partition_key``); each partition owns row *chunks* of ``CHUNK`` rows in
a flat table (``PartitionedTable``), and a publish topic only has to be
tested against the chunks of the ≤15 partitions it can match
(``topic_partitions``) — the reference trie's pruning (`rmqtt/src/trie.rs`
DFS) flattened into regular tiles.

Its device half runs on torch tensors:

1. the words producer — the hand-written CUDA kernels of
   ``ops/match_words.py`` (packed or legacy tiles) — tests every topic's
   candidate chunks and packs 32 row results per word;
2. a compaction of the words, by mode — hand-written CUDA kernels behind
   the wrappers of ``ops/compact_tail.py``: ``fused_compact_decode``
   (the default) compacts the nonzero words and set bits of the whole batch
   into one slot budget, resolves each matched row to its filter id
   through the device-resident row→fid map and sorts by (topic, fid), so
   the host's whole decode is one ``np.split``; ``compact_global`` (the
   unfused global path) ships one ``widx*32 + bit`` route a match, and
   ``compact_words`` (the topk mode) each topic's first nonzero words,
   both decoded on the host (``_decode_routes``, ``_decode_batch``: the
   native decoders of ``runtime/encode.cc``, numpy without g++).

``PartitionedMatcher`` keeps the device mirror of a table (one array or
segments; full upload or dirty-chunk delta) and runs batches through
(1)+(2): one device→host fetch per batch. Entry points run on CUDA unless
the caller passes ``device="cpu"``; with no device given and no CUDA
device they raise.
"""

from __future__ import annotations

import bisect
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from rmqtt_tpu_torch.broker.devprof import DEVPROF as _DEVPROF
from rmqtt_tpu_torch.core.topic import HASH, PLUS, is_metadata, split_levels
from rmqtt_tpu_torch.ops.encode import (
    _FIRST_TOK,
    HASH_TOK,
    PACKED_MAX_LEVELS,
    PACKED_W1_MAX,
    PACKED_W2_MAX,
    PAD_TOK,
    PLUS_TOK,
    DeltaLog,
    PackedLayout,
    TokenDict,
    UNK_TOK,
    group_byte_planes,
)
from rmqtt_tpu_torch.ops.compact_tail import (_popcount32, compact_global,
                                              compact_global_plain, compact_words,
                                              fused_compact_decode,
                                              fused_compact_decode_plain, topk_wire_plain)
# CHUNK = 128 rows per tile (4 words): the JAX package's constant; some of
# its docstrings say 256, which is wrong
from rmqtt_tpu_torch.ops.match_words import CHUNK, WORDS_PER_CHUNK, words_any
from rmqtt_tpu_torch.utils.devfetch import fetch
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS

_LOG = logging.getLogger("rmqtt_tpu_torch.ops")

#: chaos seam of the device-table mirror (utils/failpoints.py): fires when
#: a refresh — delta scatter or full pack + upload — is about to run
_FP_UPLOAD = FAILPOINTS.register("device.upload")

# partition key kinds
_K_HASH = ("#",)


def _pj(kernel: str, fn, *args, _key: Optional[Tuple] = None, **kwargs):
    """One PROFILED launch seam, reached only with the device profiler on
    (broker/devprof.py; sites call ``_pj(...) if _DEVPROF.enabled else
    fn(...)``, so off it costs one attribute check). The shape key is the
    arguments' shapes and dtypes plus the static ones, or ``_key`` when the
    caller buckets it: a never-seen key is a new signature, the first
    launch of a shape, or the kernel library's build on the very first
    launch, and the timed wall of that call brackets its cost."""
    t0 = time.perf_counter_ns()
    out = fn(*args, **kwargs)
    key = _DEVPROF.key_of(args, kwargs) if _key is None else _key
    _DEVPROF.note_jit(kernel, key, time.perf_counter_ns() - t0)
    return out


def _refuse_unported_knobs() -> None:
    """``RMQTT_PALLAS=0`` raises instead of being ignored: the JAX knob
    turns its verified Pallas kernel off, and the port has no
    verify-and-fall-back — on CUDA it always runs its hand-written words
    kernels."""
    if os.environ.get("RMQTT_PALLAS") == "0":
        raise NotImplementedError(
            "RMQTT_PALLAS=0: the port has no verify-and-fall-back; on CUDA it "
            "always runs its hand-written words kernels (ROADMAP ground rules)")


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """The delta scatter: ``rows`` into ``dst``'s chunks ``idx``, in place."""
    return dst.index_copy_(0, idx, rows)


class _CompactState:
    """A fully-built compacted physical layout, ready to swap in."""

    __slots__ = ("arrays", "fid_of_row", "row_of_fid", "cap_chunks", "nchunks",
                 "excl_chunks", "excl_free", "shared_chunks_of",
                 "shared_rows_of", "shared_free", "open_shared")


def _build_compact_state(
    key_of: Dict[int, Tuple], row_of: Dict[int, int], arrays, max_lvl: int,
) -> _CompactState:
    """Gather a snapshot of live rows into a fresh compacted layout.

    Runs WITHOUT the table lock: ``key_of``/``row_of`` are point-in-time
    copies and ``arrays`` are references to the then-current host arrays.
    Rows of fids mutated after the snapshot may be read torn here — the
    install step re-writes exactly those fids from journal data."""
    tok_a, flen_a, pl_a, hh_a, fw_a = arrays
    by_key: Dict[Tuple, List[int]] = {}
    for fid, key in key_of.items():
        by_key.setdefault(key, []).append(fid)
    keys_sorted = sorted(by_key, key=repr)
    src_rows: List[int] = []
    fids_ordered: List[int] = []
    for key in keys_sorted:
        for fid in by_key[key]:
            fids_ordered.append(fid)
            src_rows.append(row_of[fid])
    src = np.asarray(src_rows, dtype=np.int64)
    n = len(src)
    need_chunks = 1 + (n + CHUNK - 1) // CHUNK + 1
    cap = 64
    while cap < need_chunks:
        cap *= 2
    st = _CompactState()
    st.cap_chunks = cap
    rows = cap * CHUNK
    tok = np.zeros((rows, max_lvl), dtype=np.int32)
    flen = np.full((rows,), -1, dtype=np.int32)
    pl = np.zeros((rows,), dtype=np.int32)
    hh = np.zeros((rows,), dtype=bool)
    fw = np.zeros((rows,), dtype=bool)
    dst = np.arange(CHUNK, CHUNK + n, dtype=np.int64)  # chunk 0 stays empty
    tok[dst] = tok_a[src, :max_lvl]
    flen[dst] = flen_a[src]
    pl[dst] = pl_a[src]
    hh[dst] = hh_a[src]
    fw[dst] = fw_a[src]
    st.arrays = (tok, flen, pl, hh, fw)
    fid_arr = np.asarray(fids_ordered, dtype=np.int64)
    fid_of_row = np.full(rows, -1, dtype=np.int64)
    fid_of_row[dst] = fid_arr
    st.fid_of_row = fid_of_row
    st.row_of_fid = {int(f): int(r) for f, r in zip(fid_arr, dst)}
    # partition structures: spanned chunks per key. Partitions below one
    # chunk stay classified as SHARED-resident so later adds keep packing
    # instead of each claiming a fresh exclusive chunk (which would
    # re-create the sparse layout the compaction just removed).
    st.excl_chunks = {}
    st.excl_free = {}
    st.shared_chunks_of = {}
    st.shared_rows_of = {}
    st.shared_free = {}
    st.open_shared = []
    pos = CHUNK
    for key in keys_sorted:
        k = len(by_key[key])
        first_chunk = pos // CHUNK
        last_chunk = (pos + k - 1) // CHUNK
        if k < CHUNK:
            krows = list(range(pos, pos + k))
            st.shared_rows_of[key] = krows
            occ: Dict[int, int] = {}
            for r in krows:
                occ[r // CHUNK] = occ.get(r // CHUNK, 0) + 1
            st.shared_chunks_of[key] = occ
        else:
            st.excl_chunks[key] = list(range(first_chunk, last_chunk + 1))
        pos += k
    st.nchunks = (pos + CHUNK - 1) // CHUNK
    # the tail of the last chunk is unowned free space: future adds for
    # any key fall through _alloc_row's shared path
    tail_start = pos
    tail_end = st.nchunks * CHUNK
    if tail_end > tail_start:
        st.shared_free[st.nchunks - 1] = list(range(tail_end - 1, tail_start - 1, -1))
        st.open_shared.append(st.nchunks - 1)
    return st


def partition_key(levels: Sequence[str]) -> Tuple:
    """Partition of a (stripped, validated) filter.

    Depth-3 keys: measurement showed the depth-2 wildcard-wildcard bucket
    dominates candidate counts (NOTES.md), so filters deep enough are split
    by their third level too:

    - ``("#",)``            bare ``#``
    - ``("1", k0)``         single-level filters
    - ``("2", k0)``         ``k0/#``
    - ``("2E", k0, k1)``    exactly two levels, no ``#``
    - ``("H3", k0, k1)``    ``k0/k1/#``
    - ``("4", k0, k1, k2)`` three or more levels (k2 = third level)

    with every ``k`` ∈ {token, ``+``}.
    """
    f0 = levels[0]
    if f0 == HASH:
        return _K_HASH
    k0 = PLUS if f0 == PLUS else f0
    if len(levels) == 1:
        return ("1", k0)
    if levels[1] == HASH:
        return ("2", k0)
    k1 = PLUS if levels[1] == PLUS else levels[1]
    if len(levels) == 2:
        return ("2E", k0, k1)
    if levels[2] == HASH:
        return ("H3", k0, k1)
    k2 = PLUS if levels[2] == PLUS else levels[2]
    return ("4", k0, k1, k2)


def topic_partitions(levels: Sequence[str]) -> List[Tuple]:
    """Candidate partitions for a publish topic (≤15, most tiny)."""
    t0 = levels[0]
    n = len(levels)
    out: List[Tuple] = [_K_HASH, ("2", t0), ("2", PLUS)]
    if n == 1:
        out += [("1", t0), ("1", PLUS)]
        return out
    t1 = levels[1]
    pairs = ((t0, t1), (t0, PLUS), (PLUS, t1), (PLUS, PLUS))
    for a, b in pairs:
        out.append(("H3", a, b))
    if n == 2:
        for a, b in pairs:
            out.append(("2E", a, b))
        return out
    t2 = levels[2]
    for a, b in pairs:
        out.append(("4", a, b, t2))
        out.append(("4", a, b, PLUS))
    return out


class PartitionedTable:
    """Flat filter-row arrays with partition-chunked allocation.

    Chunk 0 is reserved empty (the padding target for per-topic chunk lists).

    Small partitions PACK INTO SHARED CHUNKS: with depth-3 keys most
    partitions hold a handful of rows, and giving each its own chunk
    collapsed occupancy to ~2% at 1M filters (NOTES.md). A partition starts
    inside shared chunks (foreign rows in a candidate chunk cost a little
    compute — the match formula simply rejects them — not memory); once it
    accumulates a full chunk's worth of rows it migrates to exclusive
    chunks. Filter ids are therefore STABLE HANDLES decoupled from row
    positions (`fid ↔ row` maps), so migration never breaks the router.
    """

    def __init__(self, max_levels: int = 8) -> None:
        self.max_levels = max_levels
        self.nchunks = 1  # chunk 0 = reserved empty
        self._cap_chunks = 64
        self._alloc(self._cap_chunks, max_levels)
        self.tokens = TokenDict()
        # partition key → exclusive chunk ids / shared chunk ids it occupies
        self._excl_chunks: Dict[Tuple, List[int]] = {}
        self._shared_chunks_of: Dict[Tuple, Dict[int, int]] = {}  # cid → row count
        # free row slots inside partition-exclusive chunks
        self._excl_free: Dict[Tuple, List[int]] = {}
        # shared-chunk pool: cid → free row slots; _open_shared lists chunk
        # ids that still have free slots (O(1) allocation)
        self._shared_free: Dict[int, List[int]] = {}
        self._open_shared: List[int] = []
        self._key_of_fid: Dict[int, Tuple] = {}
        # stable fid ↔ physical row
        self._row_of_fid: Dict[int, int] = {}
        self._fid_of_row: np.ndarray = np.full(self._cap_chunks * CHUNK, -1, dtype=np.int64)
        self._next_fid = 0
        # rows of a partition currently living in shared chunks
        self._shared_rows_of: Dict[Tuple, List[int]] = {}
        self.size = 0
        self.version = 0
        self.dirty_ops = 0  # mutations since the last compact()
        # --- churn resilience (delta uploads / double buffer / bg compact)
        # one lock covers mutations, encode's layout walks, delta packing
        # and the compaction *install*; the compaction *build* runs outside
        # it so the dispatch path never waits on a table rebuild
        self._mu = threading.RLock()
        # bumped whenever the physical chunk layout changes wholesale
        # (compact): chunk ids encoded under one epoch must never meet a
        # device table from another
        self.layout_epoch = 0
        # dirty-CHUNK journal: matchers scatter-write only these chunks
        self.delta = DeltaLog()
        # fid-map undo journal for in-flight match handles: (version,
        # epoch, row, old_fid) — a handle submitted at version V decodes
        # rows through the fid map AS OF V by patching back newer writes
        self._fid_undo_v: List[int] = []
        self._fid_undo_e: List[int] = []
        self._fid_undo_row: List[int] = []
        self._fid_undo_old: List[int] = []
        self._fid_undo_max = 65536
        self._fid_undo_floor = 0
        # background-compaction machinery
        self.compact_async = True  # matcher-triggered compaction off-thread
        self.compact_min_ops = 1024
        self.compact_ratio = 5  # trigger above max(min_ops, size // ratio)
        self.compactions = 0
        self.compact_ms = 0.0
        self.compact_aborts = 0
        self._compacting = False
        self._compact_thread: Optional[threading.Thread] = None
        # serializes whole compactions (a sync compact() racing an async
        # one must run after it, not interleave journal/install phases)
        self._compact_lock = threading.Lock()
        # mutation journal recorded while a compaction build is in flight:
        # ('a', fid, key, levels) / ('r', fid, key) / ('m', fid) — replayed
        # against the freshly built layout at install time
        self._compact_journal: Optional[List[Tuple]] = None
        # transient per-mutation dirty set (chunks touched by the op)
        self._txn: Optional[List[int]] = None
        self._undo_pending: List[Tuple[int, int]] = []
        # per-(t0[,t1[,t2]]) candidate caches: key -> (chunk ids, gid);
        # invalidated SELECTIVELY: partition key -> cache keys consulting
        # it, so a mutation only drops the entries it could affect
        self._cand_cache: Dict[Tuple, Tuple[np.ndarray, int]] = {}
        self._cand_keys_of: Dict[Tuple, Set] = {}
        self._gid_seq = 0
        self.cand_cache_invalidations = 0
        # size bound: selective invalidation means entries for never-mutated
        # partitions would otherwise accumulate forever under high-
        # cardinality publish streams; past the cap the caches (and the
        # key registry, which also holds invalidated-entry tombstones)
        # clear wholesale — cheap and rare
        self.cand_cache_max = 65536
        # the native (C++) encoder: None = not tried yet, False = unavailable
        # (no g++ here: _encode_py serves); _nenc_entries counts its live
        # cache entries for the cap
        self._nenc = None
        self._nenc_entries = 0
        self._nc_cap = 32
        # narrow dtypes while ids fit (the JAX package's upload narrowing;
        # kept so the encode output and legacy tiles stay identical to it —
        # pack_device_rows shares _tok_wide, so the bound is int16's, not
        # uint16's); STICKY once widened
        self._tok_wide = False
        self._cand_wide = False
        # --- bit-packed tile support (level-local token id spaces).
        # Every (level, global id) pair a filter row uses is assigned a
        # LOCAL id at write time; per-level LUT arrays translate global →
        # local for both tile packing and topic encode. Widths are sticky
        # grow-only (1 byte while a level's vocab fits 252 tokens, then 2);
        # a level past 65532 tokens disables the packed format for good.
        self.packed_ok = True
        self._lvl_counts: List[int] = [0] * max_levels
        self._lvl_widths: List[int] = [1] * max_levels
        self._lvl_luts: List[np.ndarray] = [
            self._new_lut() for _ in range(max_levels)
        ]
        # grow-only count of levels that carry token information (max
        # prefix_len over live rows); compaction recomputes the true max
        self._eff_levels = 1

    @staticmethod
    def _new_lut(cap: int = 1024) -> np.ndarray:
        lut = np.full((cap,), UNK_TOK, dtype=np.int32)
        lut[:_FIRST_TOK] = np.arange(_FIRST_TOK)  # reserved ids map to selves
        return lut

    def _register_level(self, level: int, gid: int) -> None:
        """Assign (level, global id) its local id on first use. Caller holds
        the table lock (all row writes do)."""
        if gid < _FIRST_TOK:
            return
        lut = self._lvl_luts[level]
        if gid >= len(lut):
            cap = len(lut)
            while cap <= gid:
                cap *= 2
            grown = np.full((cap,), UNK_TOK, dtype=np.int32)
            grown[: len(lut)] = lut
            self._lvl_luts[level] = lut = grown
        if lut[gid] != UNK_TOK:
            return
        n = self._lvl_counts[level] + 1
        self._lvl_counts[level] = n
        lut[gid] = _FIRST_TOK - 1 + n
        if n > PACKED_W1_MAX:
            self._lvl_widths[level] = 2
        if n > PACKED_W2_MAX:
            self.packed_ok = False

    def packed_layout(self) -> Optional[PackedLayout]:
        """Static descriptor of the current bit-packed tile layout, or None
        when the table is not packable (too-deep filters / a level's vocab
        past two bytes). Compared by VALUE: any width/depth change yields a
        different layout, which the delta-upload gate treats as a wholesale
        relayout (full re-upload)."""
        if not self.packed_ok or self.max_levels > PACKED_MAX_LEVELS:
            return None
        eff = min(max(self._eff_levels, 1), self.max_levels)
        return PackedLayout(tuple(self._lvl_widths[:eff]))

    def translate_packed(self, ttok: np.ndarray):
        """→ ``(layout, ttok_local [B, layout.nlvl] int32)`` — topic tokens
        re-keyed into the per-level local id spaces (unknown-at-level →
        ``UNK_TOK``, which is exactly right: no filter row carries that
        token at that level, so only wildcards can match it). Returns
        ``(None, None)`` when the table is not packable. Runs under the
        table lock so the layout and LUT contents are captured together."""
        with self._mu:
            layout = self.packed_layout()
            if layout is None:
                return None, None
            nlvl = layout.nlvl
            out = np.empty((ttok.shape[0], nlvl), dtype=np.int32)
            for i in range(nlvl):
                lut = self._lvl_luts[i]
                g = ttok[:, i].astype(np.int64, copy=False)
                out[:, i] = np.where(
                    g < len(lut), lut[np.minimum(g, len(lut) - 1)], UNK_TOK
                )
            return layout, out

    def _tok_dtype(self):
        if not self._tok_wide and _FIRST_TOK + len(self.tokens) >= 0x7FFF:
            self._tok_wide = True
        return np.int32 if self._tok_wide else np.int16

    def _cand_dtype(self):
        if not self._cand_wide and self.nchunks >= 0x10000:
            self._cand_wide = True
        return np.int32 if self._cand_wide else np.uint16

    # ------------------------------------------------------------- storage
    def _alloc(self, cap_chunks: int, lvl: int) -> None:
        rows = cap_chunks * CHUNK
        self.tok = np.zeros((rows, lvl), dtype=np.int32)
        self.flen = np.full((rows,), -1, dtype=np.int32)
        self.prefix_len = np.zeros((rows,), dtype=np.int32)
        self.has_hash = np.zeros((rows,), dtype=bool)
        self.first_wild = np.zeros((rows,), dtype=bool)

    def _grow(self, need_chunks: int, need_levels: int) -> None:
        new_cap = self._cap_chunks
        while new_cap < need_chunks:
            new_cap *= 2
        new_lvl = max(need_levels, self.max_levels)
        if new_cap == self._cap_chunks and new_lvl == self.max_levels:
            return
        old = (self.tok, self.flen, self.prefix_len, self.has_hash, self.first_wild,
               self._fid_of_row)
        old_rows, old_lvl = self._cap_chunks * CHUNK, self.max_levels
        self._cap_chunks, self.max_levels = new_cap, new_lvl
        for _ in range(old_lvl, new_lvl):
            self._lvl_counts.append(0)
            self._lvl_widths.append(1)
            self._lvl_luts.append(self._new_lut())
        self._alloc(new_cap, new_lvl)
        self._fid_of_row = np.full(new_cap * CHUNK, -1, dtype=np.int64)
        self.tok[:old_rows, :old_lvl] = old[0]
        self.flen[:old_rows] = old[1]
        self.prefix_len[:old_rows] = old[2]
        self.has_hash[:old_rows] = old[3]
        self.first_wild[:old_rows] = old[4]
        self._fid_of_row[:old_rows] = old[5]

    def _new_chunk(self) -> int:
        cid = self.nchunks
        self.nchunks += 1
        if self.nchunks > self._cap_chunks:
            self._grow(self.nchunks, self.max_levels)
        return cid

    def _alloc_row(self, key: Tuple) -> int:
        """Pick a physical row for a new filter of this partition."""
        # 1) free slot in one of the partition's exclusive chunks
        free = self._excl_free.get(key)
        if free:
            return free.pop()
        shared_rows = self._shared_rows_of.setdefault(key, [])
        excl = self._excl_chunks.get(key)
        if excl or len(shared_rows) + 1 >= CHUNK:
            # partition is (or becomes) big: use exclusive chunks; migrate
            # any shared-resident rows into the new chunk first
            cid = self._new_chunk()
            base = cid * CHUNK
            self._excl_chunks.setdefault(key, []).append(cid)
            slots = list(range(base, base + CHUNK))
            for src in shared_rows:
                dst = slots.pop(0)
                self._move_row(src, dst)
            shared_rows.clear()
            self._shared_chunks_of.pop(key, None)
            self._excl_free[key] = slots[1:][::-1]
            return slots[0]
        # 2) small partition: take a slot in a shared chunk, preferring
        # chunks this partition already occupies (keeps its candidate
        # chunk-set small)
        row = None
        occ = self._shared_chunks_of.setdefault(key, {})
        for cid in occ:
            free_slots = self._shared_free.get(cid)
            if free_slots:
                row = free_slots.pop()
                break
        if row is None:
            while self._open_shared:
                cid = self._open_shared[-1]
                free_slots = self._shared_free.get(cid)
                if free_slots:
                    row = free_slots.pop()
                    break
                self._open_shared.pop()  # exhausted chunk
            else:
                cid = self._new_chunk()
                base = cid * CHUNK
                self._shared_free[cid] = list(range(base + CHUNK - 1, base, -1))
                self._open_shared.append(cid)
                row = base
        shared_rows.append(row)
        occ[row // CHUNK] = occ.get(row // CHUNK, 0) + 1
        return row

    def _free_shared_slot(self, row: int) -> None:
        cid = row // CHUNK
        slots = self._shared_free.setdefault(cid, [])
        if not slots:
            self._open_shared.append(cid)
        slots.append(row)

    def _move_row(self, src: int, dst: int) -> None:
        self.tok[dst] = self.tok[src]
        self.flen[dst] = self.flen[src]
        self.prefix_len[dst] = self.prefix_len[src]
        self.has_hash[dst] = self.has_hash[src]
        self.first_wild[dst] = self.first_wild[src]
        fid = int(self._fid_of_row[src])
        if self._txn is not None:
            # migration inside a mutation: both chunks changed on device,
            # and both fid-map cells need undo entries for in-flight handles
            self._txn.append(src // CHUNK)
            self._txn.append(dst // CHUNK)
            self._undo_pending.append((dst, int(self._fid_of_row[dst])))
            self._undo_pending.append((src, fid))
            if self._compact_journal is not None:
                self._compact_journal.append(("m", fid))
        self._fid_of_row[dst] = fid
        self._row_of_fid[fid] = dst
        self._clear_row(src)
        self._free_shared_slot(src)

    def _clear_row(self, row: int) -> None:
        self.tok[row, :] = PAD_TOK
        self.flen[row] = -1
        self.prefix_len[row] = 0
        self.has_hash[row] = False
        self.first_wild[row] = False
        self._fid_of_row[row] = -1

    # ------------------------------------------------ mutation bookkeeping
    def _begin_txn(self) -> None:
        self._txn = []
        self._undo_pending: List[Tuple[int, int]] = []

    def _finish_txn(self, key: Tuple) -> None:
        """Flush one mutation's tracking: version bump, dirty-chunk marks,
        fid-map undo entries, and selective candidate-cache invalidation."""
        self.version += 1
        self.dirty_ops += 1
        v, e = self.version, self.layout_epoch
        for cid in set(self._txn):
            self.delta.mark(v, cid)
        for row, old_fid in self._undo_pending:
            self._fid_undo_v.append(v)
            self._fid_undo_e.append(e)
            self._fid_undo_row.append(row)
            self._fid_undo_old.append(old_fid)
        if len(self._fid_undo_v) > self._fid_undo_max:
            half = self._fid_undo_max // 2
            self._fid_undo_floor = self._fid_undo_v[half - 1]
            del self._fid_undo_v[:half]
            del self._fid_undo_e[:half]
            del self._fid_undo_row[:half]
            del self._fid_undo_old[:half]
        self._txn = None
        self._undo_pending = []
        self._invalidate_cand(key)

    def _invalidate_cand(self, key: Tuple) -> None:
        """Drop only the candidate-cache entries whose partition key set
        includes the mutated key (everything else stays warm). Cache keys
        are tagged by the cache that holds them: ``("p", tuple key)`` for
        ``_encode_py``'s, ``("n", prefix bytes)`` for the native one's."""
        cache_keys = self._cand_keys_of.pop(key, None)
        if not cache_keys:
            return
        n = 0
        cache = self._cand_cache
        enc = self._nenc
        for kind, ck in cache_keys:
            if kind == "p":
                n += cache.pop(ck, None) is not None
            elif enc:
                d = enc.cache_del(ck)
                n += d
                # keep the live-entry count honest or steady churn would
                # trip the size cap with a near-empty cache
                self._nenc_entries = max(0, self._nenc_entries - d)
        self.cand_cache_invalidations += n

    def _register_cand(self, levels: Sequence[str], cache_key: Tuple) -> None:
        """Record which partition keys a cached candidate set consulted."""
        for key in topic_partitions(levels):
            self._cand_keys_of.setdefault(key, set()).add(cache_key)

    def fid_overlay(self, version: int, epoch: int):
        """→ ``(overlay, ok)`` for a match handle submitted at (version,
        epoch): ``overlay`` maps physical row → the fid it held AT that
        version (undone past the newer in-place writes). ``ok=False`` means
        the undo journal no longer reaches back that far — the caller must
        decode best-effort against the live map (dropping cleared rows)."""
        with self._mu:
            if version >= self.version:
                return {}, True
            if version < self._fid_undo_floor:
                return {}, False
            i = bisect.bisect_right(self._fid_undo_v, version)
            ov: Dict[int, int] = {}
            for j in range(i, len(self._fid_undo_v)):
                if self._fid_undo_e[j] != epoch:
                    continue
                row = self._fid_undo_row[j]
                if row not in ov:  # first write after `version` wins
                    ov[row] = self._fid_undo_old[j]
            return ov, True

    # ----------------------------------------------------------------- API
    def add(self, topic_filter: str | Sequence[str]) -> int:
        levels = split_levels(topic_filter) if isinstance(topic_filter, str) else list(topic_filter)
        with self._mu:
            nlev = len(levels)
            if nlev > self.max_levels:
                self._grow(self._cap_chunks, nlev)
            key = partition_key(levels)
            self._begin_txn()
            row = self._alloc_row(key)
            self._write_row(row, levels)
            fid = self._next_fid
            self._next_fid += 1
            self._key_of_fid[fid] = key
            self._row_of_fid[fid] = row
            self._txn.append(row // CHUNK)
            self._undo_pending.append((row, int(self._fid_of_row[row])))
            self._fid_of_row[row] = fid
            self.size += 1
            if self._compact_journal is not None:
                self._compact_journal.append(("a", fid, key, list(levels)))
            self._finish_txn(key)
            return fid

    def _write_row(self, row: int, levels: Sequence[str]) -> None:
        """Fill one physical row's data from filter levels."""
        tok_row = self.tok[row]
        tok_row[:] = PAD_TOK
        for i, lev in enumerate(levels):
            if lev == PLUS:
                tok_row[i] = PLUS_TOK
            elif lev == HASH:
                tok_row[i] = HASH_TOK
            else:
                gid = self.tokens.intern(lev)
                tok_row[i] = gid
                self._register_level(i, gid)
        nlev = len(levels)
        hh = levels[-1] == HASH
        self.flen[row] = nlev
        self.prefix_len[row] = nlev - 1 if hh else nlev
        self.has_hash[row] = hh
        self.first_wild[row] = levels[0] in (PLUS, HASH)
        prefix = nlev - 1 if hh else nlev
        if prefix > self._eff_levels:
            self._eff_levels = prefix

    def remove(self, fid: int) -> None:
        with self._mu:
            key = self._key_of_fid.pop(fid, None)
            if key is None:
                raise KeyError(f"fid {fid} not active")
            self._begin_txn()
            row = self._row_of_fid.pop(fid)
            self._txn.append(row // CHUNK)
            self._undo_pending.append((row, fid))
            self._release_row(key, row)
            self.size -= 1
            if self._compact_journal is not None:
                self._compact_journal.append(("r", fid, key))
            self._finish_txn(key)

    def _release_row(self, key: Tuple, row: int) -> None:
        """Clear a physical row and return its slot to the right free list."""
        self._clear_row(row)
        cid = row // CHUNK
        occ = self._shared_chunks_of.get(key)
        if occ is not None and cid in occ:
            # row lived in a shared chunk
            occ[cid] -= 1
            if occ[cid] == 0:
                del occ[cid]
            self._shared_rows_of[key].remove(row)
            self._free_shared_slot(row)
        else:
            self._excl_free.setdefault(key, []).append(row)

    def needs_compact(self) -> bool:
        """Churn threshold at which the fragmented layout is worth a
        rebuild (the former ``encode_topics`` inline trigger)."""
        return self.dirty_ops > max(self.compact_min_ops, self.size // self.compact_ratio)

    def force_full_refresh(self) -> None:
        """Invalidate every device mirror's delta state: the next refresh
        must re-pack and re-upload the WHOLE table (after a device fault
        the resident copy may be gone or torn, so no earlier delta may ever
        be scattered into it). The layout itself is unchanged — rows stay
        put — so the epoch bump only closes the delta gate."""
        with self._mu:
            self.version += 1
            self.layout_epoch += 1
            self.delta.reset(self.version)

    def compact(self) -> None:
        """Synchronous rebuild (build + install). In the broker this never
        runs on the dispatch path: ``PartitionedMatcher.match_submit``
        triggers ``maybe_compact_async()`` instead, which runs the build on
        a background thread while matching continues against the old
        layout, then installs atomically."""
        th = self._compact_thread
        if th is not None and th.is_alive() and th is not threading.current_thread():
            th.join()  # background rebuild already in flight: let it land
            return
        self._compact()

    def maybe_compact_async(self) -> bool:
        """Kick off a background compaction if churn warrants one."""
        if not self.needs_compact():
            return False
        with self._mu:
            if self._compacting:
                return False
            self._compacting = True
        try:
            th = threading.Thread(
                target=self._compact_bg, name="rmqtt-table-compact", daemon=True
            )
            self._compact_thread = th
            th.start()
        except Exception as e:
            # thread exhaustion must not latch _compacting (disabling
            # compaction forever) nor fail the dispatch that triggered it;
            # the next trigger retries
            self._compacting = False
            _LOG.warning("background compaction thread failed to start: %s", e)
            return False
        return True

    def _compact_bg(self) -> None:
        try:
            self._compact()
        except Exception:  # pragma: no cover - defensive
            _LOG.exception("background table compaction failed")
        finally:
            self._compacting = False

    def _compact(self) -> None:
        """Rebuild the physical layout: each partition's rows contiguous,
        partitions packed back-to-back (boundary chunks shared between
        neighbors). Restores ~100% occupancy and minimal candidate chunk
        sets after bulk loads/churn; filter ids are stable across the move.

        Two phases: the BUILD gathers a snapshot of every live row into a
        fresh set of arrays without holding the table lock (mutations that
        land meanwhile are journaled), then the INSTALL swaps the new
        layout in under the lock and replays the journal. The old
        ``_fid_of_row`` array object is left untouched, so match handles
        submitted against the old layout keep decoding correctly."""
        t0 = time.perf_counter()
        with self._compact_lock:
            with self._mu:
                key_of = dict(self._key_of_fid)
                row_of = dict(self._row_of_fid)
                arrays = (self.tok, self.flen, self.prefix_len, self.has_hash,
                          self.first_wild)
                max_lvl = self.max_levels
                self._compact_journal = []
            try:
                state = _build_compact_state(key_of, row_of, arrays, max_lvl)
            except Exception:
                with self._mu:
                    self._compact_journal = None
                raise
            with self._mu:
                journal = self._compact_journal or []
                self._compact_journal = None
                if self.max_levels != max_lvl:
                    # a deeper filter landed mid-build: the built rows are
                    # too narrow — abort; the next trigger rebuilds at the
                    # new width
                    self.compact_aborts += 1
                    return
                self._install_compact(state, journal)
            self.compactions += 1
            self.compact_ms += (time.perf_counter() - t0) * 1e3

    def _install_compact(self, state: "_CompactState", journal: List[Tuple]) -> None:
        """Swap the built layout in and replay the build-window journal.
        Caller holds ``self._mu``."""
        # net journal effects + row data captured from the still-live old
        # layout (always consistent under the lock; the build-phase copies
        # of journal-touched fids may be torn)
        adds: Dict[int, Tuple[Tuple, List[str]]] = {}
        removed: Dict[int, Tuple] = {}
        moved: Dict[int, Optional[Tuple[Tuple, List[str]]]] = {}
        for op in journal:
            if op[0] == "a":
                adds[op[1]] = (op[2], op[3])
            elif op[0] == "r":
                removed[op[1]] = op[2]
                adds.pop(op[1], None)
                moved.pop(op[1], None)
            else:  # 'm': migrated by a concurrent add — data may be torn
                if op[1] not in adds:
                    moved[op[1]] = None
        for fid in list(moved):
            moved[fid] = (self._key_of_fid[fid], self._filter_of_fid(fid))
        # atomic swap: arrays + partition maps + fid maps change together
        (self.tok, self.flen, self.prefix_len, self.has_hash,
         self.first_wild) = state.arrays
        self._fid_of_row = state.fid_of_row
        self._row_of_fid = state.row_of_fid
        self._cap_chunks = state.cap_chunks
        self.nchunks = state.nchunks
        self._excl_chunks = state.excl_chunks
        self._excl_free = state.excl_free
        self._shared_chunks_of = state.shared_chunks_of
        self._shared_rows_of = state.shared_rows_of
        self._shared_free = state.shared_free
        self._open_shared = state.open_shared
        # replay: mutations that landed during the build
        for fid, key in removed.items():
            row = self._row_of_fid.pop(fid, None)
            if row is not None:
                self._release_row(key, row)
        for fid, (key, levels) in adds.items():
            row = self._alloc_row(key)
            self._write_row(row, levels)
            self._row_of_fid[fid] = row
            self._fid_of_row[row] = fid
        for fid, kl in moved.items():
            row = self._row_of_fid.get(fid)
            if row is not None and kl is not None:
                self._write_row(row, kl[1])  # heal a possibly-torn copy
        # compaction is the one point where _eff_levels may legally SHRINK
        # (it is grow-only between compactions): the install already forces
        # every mirror down the full-upload path, so a narrower packed
        # layout costs nothing extra here
        rows = self.nchunks * CHUNK
        live = self.prefix_len[:rows][self._fid_of_row[:rows] >= 0]
        self._eff_levels = max(1, int(live.max())) if live.size else 1
        # epoch bump + invalidations land in the same locked region, so
        # matchers can never pair stale chunk ids with the new device table
        self.dirty_ops = len(journal)
        self.layout_epoch += 1
        self.version += 1
        self.delta.reset(self.version)
        self._cand_cache.clear()
        self._cand_keys_of.clear()
        if self._nenc:
            self._nenc.cache_clear()
            self._nenc_entries = 0

    def _filter_of_fid(self, fid: int) -> List[str]:
        """Decode a live fid's filter levels back from the row data."""
        row = self._row_of_fid[fid]
        strs = self.tokens._strs
        out: List[str] = []
        for tok in self.tok[row, : int(self.flen[row])].tolist():
            if tok == PLUS_TOK:
                out.append(PLUS)
            elif tok == HASH_TOK:
                out.append(HASH)
            else:
                out.append(strs[tok - _FIRST_TOK])
        return out

    # -------------------------------------------------------- topic encode
    def _candidates_for(self, levels: Sequence[str]) -> np.ndarray:
        """Candidate chunk ids for a topic prefix (partition-map walk)."""
        chunks: List[int] = []
        seen: set = set()  # partitions share boundary/shared chunks
        for key in topic_partitions(levels):
            for cid in self._excl_chunks.get(key, ()):
                if cid not in seen:
                    seen.add(cid)
                    chunks.append(cid)
            occ = self._shared_chunks_of.get(key)
            if occ:
                for cid in occ:
                    if cid not in seen:
                        seen.add(cid)
                        chunks.append(cid)
        return np.asarray(chunks, dtype=np.int32)

    def encode_topics(
        self, topics: Sequence[str | Sequence[str]], pad_batch_to: Optional[int] = None,
        with_groups: bool = False,
    ):
        """→ (ttok, tlen, tdollar, chunk_ids [B, NC], nc)
        (+ ``groups`` [B] int32 when ``with_groups``).

        ``chunk_ids`` lists each topic's candidate chunks padded with the
        reserved empty chunk 0; NC is the batch max (padded to a power of
        two to keep batch shapes few). ``groups`` assigns topics sharing one
        candidate-cache entry the same positive id (0 = padded row): the
        matcher can then upload each distinct candidate row once (zipf
        publish streams share a few hot prefixes across the whole batch).
        """
        # no inline compact() here: compaction runs in the background
        # (maybe_compact_async, triggered from PartitionedMatcher.match_submit)
        # and swaps in atomically
        return self.encode_topics_versioned(topics, pad_batch_to, with_groups)[0]

    def encode_topics_versioned(
        self, topics: Sequence[str | Sequence[str]],
        pad_batch_to: Optional[int] = None, with_groups: bool = False,
    ):
        """``(encode tuple, layout_epoch)`` captured atomically — matchers
        compare this epoch with their device snapshot's to detect a
        compaction installing between encode and refresh. Returned (not
        stashed on the table) so two matchers sharing one table can't
        clobber each other's epoch reads. The C++ encoder
        (``runtime.NativeEncoder``) serves whenever the native runtime
        builds; ``_encode_py`` where it cannot (no g++)."""
        if self._nenc is None:
            from rmqtt_tpu_torch.runtime import NativeEncoder

            try:
                self._nenc = NativeEncoder()
            except (RuntimeError, OSError):
                self._nenc = False
        with self._mu:
            epoch = self.layout_epoch
            if self._nenc:
                return self._encode_native(topics, pad_batch_to, with_groups), epoch
            return self._encode_py(topics, pad_batch_to, with_groups), epoch

    def _encode_py(
        self, topics: Sequence[str | Sequence[str]], pad_batch_to: Optional[int],
        with_groups: bool = False,
    ):
        batch = len(topics)
        b = pad_batch_to or batch
        lvl = self.max_levels
        tlen = np.full((b,), -2, dtype=np.int16)
        tdollar = np.zeros((b,), dtype=bool)
        tok_rows: List[List[int]] = []
        per_topic_chunks: List[np.ndarray] = []
        lookup = self.tokens.lookup
        # the cache is invalidated SELECTIVELY at mutation time
        # (_invalidate_cand): entries whose partition keys a mutation never
        # touched survive version bumps
        if len(self._cand_cache) >= self.cand_cache_max:
            self._cand_cache.clear()
            self._cand_keys_of.clear()
        cache = self._cand_cache
        groups = np.full((b,), -1, dtype=np.int32)
        for j, topic in enumerate(topics):
            levels = split_levels(topic) if isinstance(topic, str) else list(topic)
            # clamp: every stored flen/prefix_len is <= max_levels, so any
            # deeper topic compares identically at lvl+1 — and the clamp
            # keeps int16 safe for arbitrarily deep (hostile) topics
            tlen[j] = min(len(levels), lvl + 1)
            tdollar[j] = bool(levels[0]) and is_metadata(levels[0])
            row = [lookup(lev) for lev in levels[:lvl]]
            row += [PAD_TOK] * (lvl - len(row))
            tok_rows.append(row)
            # candidate chunks: cached per effective prefix — topics share
            # these heavily (the wildcard partitions are common to all).
            # The key must cover every level the partition scheme inspects
            # (1, 2 or 3 depending on topic depth).
            ckey = tuple(levels[:3]) if len(levels) >= 3 else tuple(levels)
            ckey = (len(ckey),) + ckey
            ent = cache.get(ckey)
            if ent is None:
                # monotonic gid (NOT len(cache)): selective invalidation
                # means ids of evicted entries must never be reissued to a
                # different candidate set while survivors still carry them
                ent = (self._candidates_for(levels), self._gid_seq)
                self._gid_seq += 1
                cache[ckey] = ent
                self._register_cand(levels, ("p", ckey))
            cand, gid = ent
            groups[j] = gid
            per_topic_chunks.append(cand)
        ttok = np.zeros((b, lvl), dtype=self._tok_dtype())
        if batch:
            ttok[:batch] = np.asarray(tok_rows, dtype=np.int64).astype(ttok.dtype)
        mx = max((len(c) for c in per_topic_chunks), default=1)
        # sticky pow2 NC (grow-only per table): a light batch after a heavy
        # one must not flip the kernel signature back and forth
        self._nc_cap = max(self._nc_cap, 1 << (max(1, mx) - 1).bit_length())
        nc = self._nc_cap
        chunk_ids = np.zeros((b, nc), dtype=self._cand_dtype())  # 0 = empty chunk
        for j, chunks in enumerate(per_topic_chunks):
            chunk_ids[j, : len(chunks)] = chunks
        if with_groups:
            return ttok, tlen, tdollar, chunk_ids, nc, groups + 1  # padded -> 0
        return ttok, tlen, tdollar, chunk_ids, nc

    def _encode_native(
        self, topics: Sequence[str | Sequence[str]], pad_batch_to: Optional[int],
        with_groups: bool = False,
    ):
        """C++ hot path for ``encode_topics`` (runtime/encode.cc): tokenize +
        candidate-cache lookup natively; only distinct-prefix cache misses
        walk the Python partition maps. The same tuple as ``_encode_py``;
        only the group ids differ (the native side numbers its entries
        itself), so groups agree with it as partitions of the batch."""
        enc = self._nenc
        batch = len(topics)
        b = pad_batch_to or batch
        lvl = self.max_levels
        toks = self.tokens._strs
        for i in range(enc.tokens_synced, len(toks)):
            enc.add_token(toks[i], _FIRST_TOK + i)
        enc.tokens_synced = len(toks)
        # mutations drop native entries selectively (_invalidate_cand →
        # cache_del); only a new layout (compaction install) clears it all
        if enc.cache_epoch != self.layout_epoch:
            enc.cache_clear()
            self._nenc_entries = 0
            enc.cache_epoch = self.layout_epoch
        if self._nenc_entries >= self.cand_cache_max:
            # size cap, applied BETWEEN batches only: cache_clear resets the
            # native gid counter, so clearing mid-batch would let fresh gids
            # collide with ones already issued to earlier topics of the same
            # encode (aliasing the grouped upload)
            enc.cache_clear()
            self._nenc_entries = 0
            self._cand_keys_of.clear()
        if batch and any(not isinstance(t, str) for t in topics):
            topics = [t if isinstance(t, str) else "/".join(t) for t in topics]
        blob = ("\x00".join(topics) + "\x00").encode() if batch else b"\x00"
        while True:
            nc_cap = self._nc_cap
            ttok = np.zeros((b, lvl), dtype=np.int32)
            tlen = np.full((b,), -2, dtype=np.int32)
            tdollar = np.zeros((b,), dtype=np.uint8)
            cand = np.zeros((b, nc_cap), dtype=np.int32)
            counts = np.zeros((b,), dtype=np.int32)
            group = np.full((b,), -1, dtype=np.int32)  # padded rows stay -1
            if batch:
                miss = enc.encode(blob, batch, lvl, ttok, tlen, tdollar, nc_cap,
                                  cand, counts, group)
                # dedupe misses by prefix key: a cold cache must not hand
                # every repeated hot topic its own gid — that would disable
                # the grouped upload exactly when it pays most
                put: Dict[bytes, Tuple[int, np.ndarray]] = {}
                for j in miss:
                    levels = split_levels(topics[j])
                    key = "/".join(levels[:3]).encode()
                    hit = put.get(key)
                    if hit is None:
                        chunks = self._candidates_for(levels)
                        hit = (enc.cache_put(key, chunks), chunks)
                        self._nenc_entries += 1
                        put[key] = hit
                        self._register_cand(levels, ("n", key))
                    group[j], chunks = hit
                    counts[j] = len(chunks)
                    cand[j, : min(len(chunks), nc_cap)] = chunks[:nc_cap]
            mx = int(counts.max(initial=1))
            nc = max(1, 1 << (max(1, mx) - 1).bit_length())  # pow2 bucket
            if nc > nc_cap:
                self._nc_cap = nc  # sticky: grows, never shrinks
                continue
            # the C ABI fills int32: narrow to the upload dtypes; tlen clamps
            # like the Python path (comparisons are invariant beyond lvl+1,
            # and hostile topic depths must not wrap int16)
            out = (ttok.astype(self._tok_dtype(), copy=False),
                   np.minimum(tlen, lvl + 1).astype(np.int16, copy=False),
                   tdollar.view(bool),
                   cand.astype(self._cand_dtype(), copy=False), nc_cap)
            return out + (group + 1,) if with_groups else out  # padded -> 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device. Never falls back to the CPU on its own: with no
    device given and no CUDA device this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → an owned tensor on ``device`` (the H2D copy runs from
    pinned memory on the current stream, so it does not block the host)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


# ------------------------------------------------- fused device pipeline
class Fused(NamedTuple):
    """One fused dispatch: the ``[budget + B]`` wire plus the words and the
    per-topic chunk ids it was decoded from, so a budget regrow re-runs
    only the tail (``fused_compact_decode``) on the same words."""

    wire: torch.Tensor
    words: torch.Tensor
    chunk_ids: torch.Tensor


def match_fused(tiles, fid_rows, ttok, tlen, tdollar, chunk_ids, budget: int,
                layout: Optional[PackedLayout] = None,
                use_kernel: bool = True) -> Fused:
    """Words (kernel) → global compaction → fid decode + sort (twin of the
    JAX ``match_fused_impl``); ``use_kernel`` False runs both plain twins."""
    tail = fused_compact_decode if use_kernel else fused_compact_decode_plain
    if not _DEVPROF.enabled:
        words = words_any(tiles, ttok, tlen, tdollar, chunk_ids, layout=layout,
                          use_kernel=use_kernel)
        return Fused(tail(words, fid_rows, chunk_ids, budget), words, chunk_ids)
    name = "match_words_packed" if layout is not None else "match_words_legacy"
    words = _pj(name if use_kernel else name + "_plain", words_any, tiles, ttok,
                tlen, tdollar, chunk_ids, layout=layout, use_kernel=use_kernel)
    return Fused(_pj(tail.__name__, tail, words, fid_rows, chunk_ids, budget),
                 words, chunk_ids)


def match_fused_grouped(tiles, fid_rows, ttok, tlen, tdollar, uniq_cand, inv,
                        budget: int, layout: Optional[PackedLayout] = None,
                        use_kernel: bool = True) -> Fused:
    """Fused dispatch over the deduplicated candidate upload: ``[U, NC]``
    distinct rows plus a ``[B]`` inverse, expanded by one device gather
    (twin of ``match_fused_grouped_impl``)."""
    chunk_ids = uniq_cand[inv.to(torch.int64)].contiguous()
    return match_fused(tiles, fid_rows, ttok, tlen, tdollar, chunk_ids, budget,
                       layout, use_kernel)


def match_fused_split(tiles, fid_rows, parts, budgets, layout=None,
                      use_kernel: bool = True):
    """Fused NC split-dispatch (twin of ``match_fused_split_impl``): every
    bucket ``(ttok, tlen, tdollar, chunk_ids)`` runs the fused path with its
    own budget and the wires concatenate, so the batch still costs one
    fetch. Unlike the JAX split form, each bucket launches the kernel: the
    CUDA kernel has no batch-multiple constraint.
    → ``(wire, [Fused per bucket])``."""
    outs = [match_fused(tiles, fid_rows, *p, budget=g, layout=layout,
                        use_kernel=use_kernel)
            for p, g in zip(parts, budgets)]
    return torch.cat([o.wire for o in outs]), outs


def split_buckets(tt, tlen, tdollar, chunk_ids, split):
    """The NC split's buckets on the host, from a ``_split_plan`` result:
    for each non-empty tier, its topics' ``(ttok, tlen, tdollar,
    chunk_ids[:, :tier])`` padded to a power of two (padded topics have
    tlen -2 and match nothing) → ``[(arrays, (topics, padded, tier))]``."""
    order, sizes, tiers = split
    out = []
    pos = 0
    for tier, s in zip(tiers, sizes):
        s = int(s)
        if not s:
            continue
        idx = order[pos : pos + s]
        pos += s
        pb = 1 << (s - 1).bit_length() if s > 1 else 1
        pt = np.zeros((pb, tt.shape[1]), dtype=tt.dtype)
        pt[:s] = tt[idx]
        pl = np.full((pb,), -2, dtype=tlen.dtype)
        pl[:s] = tlen[idx]
        pd = np.zeros((pb,), dtype=bool)
        pd[:s] = tdollar[idx]
        # candidate lists are stored front-packed, so a count ≤ tier
        # topic's chunks all live in the first `tier` columns
        pc = np.zeros((pb, tier), dtype=chunk_ids.dtype)
        pc[:s] = chunk_ids[idx, :tier]
        out.append(((pt, pl, pd, pc), (s, pb, tier)))
    return out


# ------------------------------------------------- unfused device programs
def _unsigned(arr: np.ndarray) -> np.ndarray:
    """A fetched ``compact_global`` wire as the JAX package's unsigned
    array: int16 read as uint16, int32 as uint32 (same values)."""
    return arr.view(np.uint16 if arr.dtype == np.int16 else np.uint32)


class Unfused(NamedTuple):
    """One unfused dispatch: the wire plus the words it compacts, so a
    regrow re-runs only the compaction on the same words."""

    wire: torch.Tensor
    words: torch.Tensor


def match_global(tiles, ttok, tlen, tdollar, chunk_ids, budget: int,
                 layout: Optional[PackedLayout] = None,
                 use_kernel: bool = True) -> Unfused:
    """Words (kernel) → global route compaction (twin of the JAX
    ``match_global_impl``); ``use_kernel`` False runs both plain twins."""
    words = words_any(tiles, ttok, tlen, tdollar, chunk_ids, layout=layout,
                      use_kernel=use_kernel)
    tail = compact_global if use_kernel else compact_global_plain
    return Unfused(tail(words, budget), words)


def match_global_grouped(tiles, ttok, tlen, tdollar, uniq_cand, inv, budget: int,
                         layout: Optional[PackedLayout] = None,
                         use_kernel: bool = True) -> Unfused:
    """``match_global`` over the deduplicated candidate upload: ``[U, NC]``
    distinct rows plus a ``[B]`` inverse, expanded by one device gather
    (twin of ``match_global_grouped_impl``)."""
    chunk_ids = uniq_cand[inv.to(torch.int64)].contiguous()
    return match_global(tiles, ttok, tlen, tdollar, chunk_ids, budget, layout,
                        use_kernel)


def _cat_wires(wires: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bucket wires end to end, all widened to 32 bits when any bucket's
    is (an int16 wire holds uint16 values: widen without the sign)."""
    if all(w.dtype == torch.int16 for w in wires):
        return torch.cat(list(wires))
    return torch.cat([(w.to(torch.int32) & 0xFFFF) if w.dtype == torch.int16 else w
                      for w in wires])


def match_global_split(tiles, parts, budgets, layout=None, use_kernel: bool = True):
    """Unfused NC split-dispatch (twin of ``match_global_split_impl``):
    every bucket ``(ttok, tlen, tdollar, chunk_ids)`` runs ``match_global``
    with its own budget and the wires concatenate, so the batch still
    costs one fetch; each bucket launches the words kernel.
    → ``(wire, [Unfused per bucket])``."""
    outs = [match_global(tiles, *p, budget=g, layout=layout, use_kernel=use_kernel)
            for p, g in zip(parts, budgets)]
    return _cat_wires([o.wire for o in outs]), outs


def _topk_wire(words: torch.Tensor, max_words: int, use_kernel: bool = True) -> torch.Tensor:
    """``compact_words`` as one int32 wire ``[word_idx..., word_bits...,
    counts...]``, so a topk batch costs one fetch (JAX fetches three): on
    the card one kernel launch writes the three slices in place;
    ``use_kernel`` False runs the plain twin."""
    return (compact_words if use_kernel else topk_wire_plain)(words, max_words)


def match_partitioned(tiles, ttok, tlen, tdollar, chunk_ids, max_words: int,
                      layout: Optional[PackedLayout] = None,
                      use_kernel: bool = True) -> Unfused:
    """Words (kernel) → topk compaction (twin of the JAX
    ``match_partitioned_impl``), as one wire (``_topk_wire``)."""
    words = words_any(tiles, ttok, tlen, tdollar, chunk_ids, layout=layout,
                      use_kernel=use_kernel)
    return Unfused(_topk_wire(words, max_words, use_kernel), words)


def pack_device_rows(t: PartitionedTable) -> np.ndarray:
    """The device mirror of a table: chunk-tiled ``[up_chunks, L+3, CHUNK]``
    FIELD-MAJOR rows (tokens + flen + prefix_len + hash|wild flags), active
    prefix padded to ``_pad_chunk_count`` chunks so table growth does not
    change the array shape on every new chunk. Padding rows are zeros
    (flen=0), rejected for every topic.

    Field-major keeps each field's 128 rows contiguous, so the kernel's
    threads (one per row) read neighbouring words. Tiles ship as int16
    while the token vocabulary fits (the table's ``_tok_wide``), else
    int32; flen/prefix_len (≤ L+1) and the 2-bit flags always fit.
    """
    up_chunks = _pad_chunk_count(t.nchunks)
    rows = t.nchunks * CHUNK
    lvl = t.max_levels
    dt = np.int32 if t._tok_wide else np.int16
    packed = np.zeros((up_chunks * CHUNK, lvl + 3), dtype=dt)
    packed[:rows, :lvl] = t.tok[:rows].astype(dt)
    packed[:rows, lvl] = t.flen[:rows]
    packed[:rows, lvl + 1] = t.prefix_len[:rows]
    packed[:rows, lvl + 2] = t.has_hash[:rows].astype(dt) | (
        t.first_wild[:rows].astype(dt) << 1
    )
    return np.ascontiguousarray(
        packed.reshape(-1, CHUNK, lvl + 3).transpose(0, 2, 1)
    )


def _pad_chunk_count(nchunks: int) -> int:
    """Padded device chunk count: pow2 (floor 64) up to 16K chunks so table
    growth reallocates the resident arrays at most once per bucket; above
    that pow2 padding wastes up to half the array exactly where tables are
    huge (10M subs ≈ 83K chunks → a 131072 pad = 200MB of zero tiles), so
    pad to a multiple of 4096 instead."""
    if nchunks <= 16384:
        return max(64, 1 << (nchunks - 1).bit_length())
    return (nchunks + 4095) // 4096 * 4096


def _byte_planes_for_rows(t: PartitionedTable, layout: PackedLayout, rows):
    """→ ``[n, layout.planes] uint8`` byte planes for the given physical
    rows (slice or index array): per-level LOCAL token ids (low byte, then
    the optional high byte) followed by the metadata byte
    ``flen+1 | has_hash<<5 | first_wild<<6`` (empty rows encode flen+1 = 0;
    ``prefix_len`` is derivable as ``flen - has_hash`` and not stored)."""
    tok = t.tok[rows]
    flen = t.flen[rows]
    hh = t.has_hash[rows]
    fw = t.first_wild[rows]
    planes = np.zeros((len(flen), layout.planes), dtype=np.uint8)
    p = 0
    for i, w in enumerate(layout.widths):
        lut = t._lvl_luts[i]
        g = tok[:, i].astype(np.int64, copy=False)
        loc = np.where(g < len(lut), lut[np.minimum(g, len(lut) - 1)], UNK_TOK)
        planes[:, p] = loc & 0xFF
        p += 1
        if w == 2:
            planes[:, p] = (loc >> 8) & 0xFF
            p += 1
    meta = np.where(flen < 0, 0, flen + 1).astype(np.int64)
    meta = meta | (hh.astype(np.int64) << 5) | (fw.astype(np.int64) << 6)
    planes[:, p] = meta
    return planes


def pack_device_rows_packed(t: PartitionedTable, layout: PackedLayout) -> np.ndarray:
    """Bit-packed device mirror: flat ``[up_chunks, groups*CHUNK]`` int32 —
    four byte planes per int32 lane (encode.group_byte_planes), chunk c's
    plane g occupying lanes ``[g*CHUNK, (g+1)*CHUNK)`` of row c. Per-chunk
    tile bytes drop from ``(L+3)*CHUNK*2`` (legacy int16 field-major) to
    ``groups*CHUNK*4`` — 2816 → 1024 B at the bench's mixed-wildcard shape
    (L=8, five 1-byte levels + one 2-byte). Padding chunks are zeros
    (flen+1 = 0 ⇒ empty), rejected for every topic."""
    up_chunks = _pad_chunk_count(t.nchunks)
    rows = t.nchunks * CHUNK
    planes = _byte_planes_for_rows(t, layout, slice(0, rows))
    arr32 = group_byte_planes(planes, layout.groups)
    full = np.zeros((up_chunks * CHUNK, layout.groups), dtype=np.int32)
    full[:rows] = arr32
    return np.ascontiguousarray(
        full.reshape(up_chunks, CHUNK, layout.groups)
        .transpose(0, 2, 1)
        .reshape(up_chunks, layout.groups * CHUNK)
    )


def pack_chunk_tiles_packed(
    t: PartitionedTable, cids: Sequence[int], layout: PackedLayout
) -> np.ndarray:
    """Delta-upload payload for the packed format: only the given chunks,
    same flat int32 lane layout as ``pack_device_rows_packed`` so tiles
    scatter straight into the resident array by leading-axis index."""
    k = len(cids)
    cid_arr = np.asarray(cids, dtype=np.int64)
    rows = (cid_arr[:, None] * CHUNK + np.arange(CHUNK, dtype=np.int64)).reshape(-1)
    planes = _byte_planes_for_rows(t, layout, rows)
    arr32 = group_byte_planes(planes, layout.groups)
    return np.ascontiguousarray(
        arr32.reshape(k, CHUNK, layout.groups)
        .transpose(0, 2, 1)
        .reshape(k, layout.groups * CHUNK)
    )


def pack_fid_rows(t: PartitionedTable) -> np.ndarray:
    """Device-resident row→fid map ``[up_chunks, CHUNK]`` int32 (the fused
    pipeline resolves matched rows to filter ids ON DEVICE, so only final
    fids cross to the host). -1 marks empty rows; a -1 escaping through the
    fused output means a cleared row matched — a device bug the host fails
    loudly on. int32 bounds fids at 2^31 ``add()`` calls."""
    up_chunks = _pad_chunk_count(t.nchunks)
    rows = t.nchunks * CHUNK
    out = np.full((up_chunks * CHUNK,), -1, dtype=np.int32)
    out[:rows] = t._fid_of_row[:rows]
    return out.reshape(up_chunks, CHUNK)


def pack_fid_chunk_tiles(t: PartitionedTable, cids: Sequence[int]) -> np.ndarray:
    """Dirty-chunk slices of the device fid map (delta refresh payload)."""
    cid_arr = np.asarray(cids, dtype=np.int64)
    rows = (cid_arr[:, None] * CHUNK + np.arange(CHUNK, dtype=np.int64)).reshape(-1)
    return t._fid_of_row[rows].astype(np.int32).reshape(len(cids), CHUNK)


def pack_chunk_tiles(t: PartitionedTable, cids: Sequence[int], dt) -> np.ndarray:
    """Pack ONLY the given chunks into device tiles ``[K, L+3, CHUNK]`` —
    the delta-upload payload (same field-major layout as
    ``pack_device_rows``, so tiles scatter straight into the resident
    array by leading-axis index)."""
    lvl = t.max_levels
    k = len(cids)
    cid_arr = np.asarray(cids, dtype=np.int64)
    rows = (cid_arr[:, None] * CHUNK + np.arange(CHUNK, dtype=np.int64)).reshape(-1)
    packed = np.zeros((k * CHUNK, lvl + 3), dtype=dt)
    packed[:, :lvl] = t.tok[rows].astype(dt)
    packed[:, lvl] = t.flen[rows]
    packed[:, lvl + 1] = t.prefix_len[rows]
    packed[:, lvl + 2] = t.has_hash[rows].astype(dt) | (
        t.first_wild[rows].astype(dt) << 1
    )
    return np.ascontiguousarray(
        packed.reshape(k, CHUNK, lvl + 3).transpose(0, 2, 1)
    )


def delta_chunk_plan(t: PartitionedTable, *, enabled: bool, dev_version: int,
                     has_resident: bool, dev_epoch: int, dev_lvl: int,
                     dev_dtype, dt, dev_up_chunks: int,
                     dev_layout=None, layout=None):
    """The delta-refresh validity gate: → dirty chunk ids (possibly empty) when a
    scatter refresh is sound, else None (caller full-uploads). The gate is
    correctness-critical — a condition added here must hold for all
    consumers, which is why it lives in one place. ``dev_layout``/``layout``
    compare the resident vs current bit-packed tile layout (both None for
    legacy tiles): any width/depth/format change is a wholesale relayout."""
    if (
        not enabled
        or dev_version < 0
        or not has_resident
        or dev_epoch != t.layout_epoch
        or dev_lvl != t.max_levels
        or dev_dtype != dt
        or dev_layout != layout
        or t.nchunks > dev_up_chunks
    ):
        return None
    cids = t.delta.since(dev_version)
    if cids is None or len(cids) > max(64, t.nchunks // 2):
        return None  # journal too old / delta no cheaper than a repack
    return cids


class _Snap:
    """A resident device snapshot's identity: the table (version, layout
    epoch) it mirrors plus the host row→fid map array AS OF that version."""

    __slots__ = ("version", "epoch", "fid_map")

    def __init__(self, version: int, epoch: int, fid_map: np.ndarray) -> None:
        self.version = version
        self.epoch = epoch
        self.fid_map = fid_map


class Segment(NamedTuple):
    """One array of a segmented device table: global chunks ``[base, end)``
    (``end`` advances as the table grows into the padding), their tiles and
    row→fid rows (GLOBAL fids, -1 padded; None while the fused pipeline is
    ruled out). Segment 0 keeps the global numbering; a later segment has
    one zero chunk in front, so global chunk ``cid`` is local
    ``cid - base + 1`` and a local row maps back by ``(base - 1) * CHUNK``."""

    base: int
    end: int
    tiles: torch.Tensor
    fids: Optional[torch.Tensor]


class DeviceState:
    """The resident device mirror of a table: tiles (packed or legacy), the
    row→fid map (None while the fused pipeline is ruled out), and the table
    state they mirror (``snap``). A segmented table holds ``segments``
    (``seg_cap`` chunks each) instead of one ``tiles``/``fids`` pair, which
    are then None. ``lvl`` and ``dtype`` are what the delta gate compares
    (the table's ``max_levels`` and the tile dtype at pack time)."""

    __slots__ = ("tiles", "fids", "layout", "snap", "lvl", "dtype", "segments",
                 "seg_cap")

    def __init__(self, tiles, fids, layout, snap, lvl, dtype,
                 segments: Optional[List[Segment]] = None, seg_cap: int = 0):
        self.tiles = tiles
        self.fids = fids
        self.layout = layout
        self.snap = snap
        self.lvl = lvl
        self.dtype = dtype
        self.segments = segments
        self.seg_cap = seg_cap

    @property
    def up_chunks(self) -> int:
        """Resident chunk capacity (the delta gate's growth bound)."""
        if self.segments is None:
            return self.tiles.shape[0]
        return self.seg_cap * len(self.segments)

    def has_fids(self) -> bool:
        if self.segments is None:
            return self.fids is not None
        return all(s.fids is not None for s in self.segments)

    def drop_fids(self) -> None:
        self.fids = None
        if self.segments is not None:
            self.segments = [s._replace(fids=None) for s in self.segments]


def device_state_from_numpy(tiles: np.ndarray, fid_rows: np.ndarray, widths,
                            version: int, epoch: int, fid_map: np.ndarray,
                            device=None, lvl: Optional[int] = None) -> DeviceState:
    """Install host arrays as a resident device snapshot: ``tiles`` as
    ``pack_device_rows_packed`` (``widths`` = its layout's widths) or
    ``pack_device_rows`` (``widths`` = None) return them, ``fid_rows`` as
    ``pack_fid_rows`` does — from this package or from the JAX package,
    whose arrays are identical. ``version``/``epoch``/``fid_map`` name the
    table state they mirror; ``lvl`` is the table's ``max_levels`` at pack
    time (legacy tiles imply it; unknown for packed tiles means the first
    refresh re-uploads rather than trusting a delta)."""
    dev = resolve_device(device)
    tiles = np.asarray(tiles)
    fid_rows = np.asarray(fid_rows, dtype=np.int32)
    layout = PackedLayout(tuple(int(w) for w in widths)) if widths is not None else None
    if layout is not None:
        if tiles.ndim != 2 or tiles.shape[1] != layout.groups * CHUNK \
                or tiles.dtype != np.int32:
            raise ValueError(f"packed tiles {tiles.shape} {tiles.dtype} do not "
                             f"fit layout {layout}")
    elif tiles.ndim != 3 or tiles.shape[2] != CHUNK \
            or tiles.dtype not in (np.int16, np.int32):
        raise ValueError(f"legacy tiles {tiles.shape} {tiles.dtype} are not "
                         f"[n, L+3, {CHUNK}] int16/int32")
    if fid_rows.shape != (tiles.shape[0], CHUNK):
        raise ValueError(f"fid rows {fid_rows.shape} do not fit {tiles.shape[0]} tiles")
    if lvl is None:
        lvl = tiles.shape[1] - 3 if layout is None else -1
    return DeviceState(
        to_device(tiles, dev), to_device(fid_rows, dev), layout,
        _Snap(version, epoch, fid_map), lvl, tiles.dtype.type)


class PartitionedMatcher:
    """Device mirror + batched match over a ``PartitionedTable``.

    The JAX matcher's modes, as its constructor selects them:

    - ``compact="global"`` (``RMQTT_COMPACT``, the default) with the fused
      pipeline: the words kernel and the fused tail, one fetch of final
      fids. ``_fused`` (the knob registry's ``fused``): None or True run
      it — the port has no verify race, so None does not wait for one —
      and False (``RMQTT_FUSED=0``, or any compact mode but ``global``)
      turns it off;
    - the unfused global path: the words kernel and ``compact_global``
      (one wire of ``widx*32 + bit`` routes and counts), decoded on the
      host through the submit-time fid map. A fused matcher whose fid rows
      are not resident (the knob turned it back on since the last full
      upload) takes it until the next full refresh;
    - ``compact`` other than ``global``: the topk mode, the words kernel
      and ``compact_words`` (``max_words`` nonzero words a topic, regrown
      when a topic needs more), decoded on the host;
    - segmented tables: tiles past ``RMQTT_SEG_BYTES`` (256 MiB by default)
      in the global mode live in several arrays, each scanned for the
      candidates that fall in it, fused or unfused, and merged per topic.
      The topk mode cannot merge segments and keeps one array. When the
      whole-table upload runs out of device memory the global mode retries
      as segments of ``max(64 MiB, min(RMQTT_SEG_BYTES, nbytes // 4))`` and
      the topk mode raises a sizing ``RuntimeError``. Unlike the JAX
      matcher, which retries on any exception, only
      ``torch.OutOfMemoryError`` is caught: a wider catch on CUDA would
      swallow a broken device.

    Every mode's words, and the global modes' compactions
    (``fused_compact_decode``, ``compact_global``), come from the
    hand-written kernels on a CUDA device (no verify-and-race, no
    fallback); ``use_kernel = False`` runs their plain twins instead, which
    the on-card reference check of ``chip_smoke.py`` uses. The topk
    compaction and the segment scatters are torch ops. A handle carries its own budget (global) or ``max_words``
    (topk), so a sticky widening by a later handle never masks its
    truncation.

    Env knobs (as in the JAX package): ``RMQTT_PACKED=0`` keeps legacy
    tiles, ``RMQTT_NC_SPLIT=0`` disables the NC split, ``RMQTT_DELTA_UPLOADS=0``
    forces full uploads, ``RMQTT_PAD_FLOOR`` seeds and pins the pad floor,
    ``RMQTT_COMPACT``, ``RMQTT_FUSED`` and ``RMQTT_SEG_BYTES`` as above.
    ``RMQTT_PALLAS=0`` raises ``NotImplementedError``; the port has no
    ``_pallas``, so the knob registry lists no ``pallas`` row.

    With the device profiler on (broker/devprof.py) the matcher feeds it as
    the JAX matcher does: a shape-key note per launch seam, the uploads,
    one flight record per dispatch (opened by ``match_submit``, closed by
    ``match_complete``) and the pad floor's moves. The JAX matcher's
    ``auto_dump("fused_verify_disagreement")`` belongs to its verify race,
    which the port does not have.
    """

    SPLIT_MIN_BATCH = 1024  # small batches are dispatch-bound, not compute

    def __init__(self, table: PartitionedTable, device=None, max_words: int = 32,
                 compact: Optional[str] = None) -> None:
        _refuse_unported_knobs()
        self.table = table
        self.device = resolve_device(device)
        self.max_words = max_words
        # 'global' = batch-global compaction into one shared slot budget;
        # anything else = per-topic fixed-width (topk) slots
        self.compact_mode = compact or os.environ.get("RMQTT_COMPACT", "global")
        env_fused = os.environ.get("RMQTT_FUSED", "")
        self._fused: Optional[bool] = (
            False if env_fused == "0" or self.compact_mode != "global"
            else (True if env_fused == "1" else None))
        # sticky pow2 slot budgets PER (padded batch, NC) shape: one shared
        # budget would let a 16K-topic batch inflate every later 1-topic
        # match's fetch
        self._budgets: Dict[Tuple[int, int], int] = {}
        self._split = os.environ.get("RMQTT_NC_SPLIT", "1") != "0"
        self._packed_pref = os.environ.get("RMQTT_PACKED", "1") != "0"
        self.delta_enabled = os.environ.get("RMQTT_DELTA_UPLOADS", "1") != "0"
        self._pad_floor_pinned = os.environ.get("RMQTT_PAD_FLOOR", "") != ""
        self._pad_floor = max(1, int(os.environ.get("RMQTT_PAD_FLOOR", "1")))
        # segmented tables: tiles above this byte budget split into arrays
        # scanned per segment; _seg_nc is each segment's sticky NC
        self._seg_bytes = int(os.environ.get("RMQTT_SEG_BYTES", str(256 << 20)))
        self._seg_nc: Dict[int, int] = {}
        self.use_kernel = True
        self._u_cap = 1  # sticky pow2 row count of the grouped upload
        self._dev: Optional[DeviceState] = None
        self.fused_batches = 0
        self.uploads = 0  # refresh events that shipped bytes (full + delta)
        self.full_uploads = 0
        self.delta_uploads = 0
        self.upload_bytes = 0
        # per-stage wall-clock attribution (host clocks; fetch includes the
        # wait for the device): zero-overhead when off
        self.stage_timing = False
        self.stage_ns = {"encode": 0, "dispatch": 0, "fetch": 0, "decode": 0}
        # device-profiler flight records awaiting their complete half,
        # matched by handle IDENTITY (a segmented handle's sub-handles
        # never own one); bounded (an abandoned handle flushes oldest).
        # The lock covers append vs scan: pipelined submits and completes
        # run on different executor threads (RoutingService)
        self._prof_pending: deque = deque()
        self._prof_lock = threading.Lock()

    # ------------------------------------------------------ device mirror
    def install(self, state: DeviceState) -> None:
        """Make ``state`` the resident snapshot (``device_state_from_numpy``)."""
        if state.tiles.device != self.device:
            raise ValueError(f"state on {state.tiles.device}, matcher on {self.device}")
        self._dev = state

    def _want_fids(self) -> bool:
        """Device fid rows are packed and uploaded only while the fused
        pipeline can serve batches (global mode, not ruled out)."""
        return self._fused is not False and self.compact_mode == "global"

    def _refresh(self) -> DeviceState:
        t = self.table
        st = self._dev
        if st is not None and st.snap.version == t.version:
            return st
        # injected upload faults fire before the table lock, so a `hang`
        # wedges only this refresh, never subscribes
        if _FP_UPLOAD.action is not None:
            _FP_UPLOAD.fire_sync()
        with t._mu:
            st = self._dev
            if st is not None and st.snap.version == t.version:
                return st
            # bit-packed tiles while the table is packable (and not opted
            # out); the layout token — not the dtype — is what the delta
            # gate compares for relayout detection
            layout = t.packed_layout() if self._packed_pref else None
            dt = np.int32 if layout is not None or t._tok_wide else np.int16
            if self._try_delta_refresh(t, dt, layout):
                return self._dev
            # full path: only the host-side PACK runs under the lock; the
            # upload below must not stall subscribes. Mutations that land
            # during the upload stay pending: the version installed is the
            # one captured here.
            packed = (pack_device_rows_packed(t, layout) if layout is not None
                      else pack_device_rows(t))
            fids2d = pack_fid_rows(t) if self._want_fids() else None
            snap = _Snap(t.version, t.layout_epoch, t._fid_of_row)
            lvl = t.max_levels
        self._dev = self._upload(packed, fids2d, layout, snap, lvl)
        self.uploads += 1
        self.full_uploads += 1
        nb = packed.nbytes + (fids2d.nbytes if fids2d is not None else 0)
        self.upload_bytes += nb
        if _DEVPROF.enabled:
            _DEVPROF.note_upload("full", nb)
        return self._dev

    def _upload(self, packed: np.ndarray, fids2d: Optional[np.ndarray], layout,
                snap: _Snap, lvl: int) -> DeviceState:
        """The full upload: one array, or segments when the tiles pass
        ``RMQTT_SEG_BYTES`` in the global mode or when the whole-table
        upload runs out of device memory."""
        if packed.nbytes > self._seg_bytes and self.compact_mode == "global":
            return self._build_segments(packed, fids2d, layout, snap, lvl)
        if packed.nbytes > self._seg_bytes:
            # only the global wire can merge segments: a topk table past the
            # budget keeps working as one array instead of raising
            _LOG.warning(
                "table %dMB exceeds RMQTT_SEG_BYTES but compact_mode=%r cannot "
                "segment; keeping one device array",
                packed.nbytes >> 20, self.compact_mode)
        try:
            return DeviceState(
                to_device(packed, self.device),
                to_device(fids2d, self.device) if fids2d is not None else None,
                layout, snap, lvl, packed.dtype.type)
        except torch.OutOfMemoryError as e:
            t = self.table
            if self.compact_mode != "global":
                raise RuntimeError(
                    f"device table upload failed at {packed.nbytes >> 20}MB "
                    f"({t.nchunks} chunks, {t.size} filters) and compact_mode="
                    f"{self.compact_mode!r} cannot use segmented tables; switch "
                    "to RMQTT_COMPACT=global or lower the table size") from e
            self._seg_bytes = max(64 << 20, min(self._seg_bytes, packed.nbytes // 4))
            _LOG.warning(
                "whole-table device upload failed (%s: %s); retrying as "
                "segmented arrays at %dMB/segment (tune RMQTT_SEG_BYTES to "
                "pre-empt this)", type(e).__name__, e, self._seg_bytes >> 20)
            return self._build_segments(packed, fids2d, layout, snap, lvl)

    def _build_segments(self, packed: np.ndarray, fids2d: Optional[np.ndarray],
                        layout, snap: _Snap, lvl: int) -> DeviceState:
        """Split the packed table into ≤ ``_seg_bytes`` device arrays of
        ``seg_cap`` chunks (see :class:`Segment` for the numbering);
        ``fids2d`` splits the same way, so the fused tail decodes each
        segment to global fids and segment results merge by concatenation."""
        total = packed.shape[0]
        nseg = -(-packed.nbytes // self._seg_bytes)
        seg_chunks = -(-total // nseg)
        # aligned for shape stability under growth; small alignments keep
        # toy tables (tests force segmentation) small
        align = 4096 if seg_chunks >= 4096 else (64 if seg_chunks >= 64 else 8)
        seg_chunks = (seg_chunks + align - 1) // align * align
        segs: List[Segment] = []
        for base in range(0, total, seg_chunks):
            lead = 1 if base > 0 else 0

            def cut(arr: np.ndarray, fill: int) -> torch.Tensor:
                part = arr[base : base + seg_chunks]
                pads = [(0, 0)] * part.ndim
                pads[0] = (lead, seg_chunks - part.shape[0])
                if pads[0] != (0, 0):
                    part = np.pad(part, pads, constant_values=fill)
                return to_device(part, self.device)

            segs.append(Segment(base, min(base + seg_chunks, total), cut(packed, 0),
                                cut(fids2d, -1) if fids2d is not None else None))
        return DeviceState(None, None, layout, snap, lvl, packed.dtype.type,
                           segs, seg_chunks)

    def _try_delta_refresh(self, t: PartitionedTable, dt, layout) -> bool:
        """Write only the dirty chunks into the resident arrays. Possible
        iff the layout epoch, row width, tile dtype, packed layout and
        padded capacity all still match the resident snapshot; otherwise
        (or when the delta journal overflowed, or the fused pipeline newly
        wants fid rows) the caller full-uploads.

        The tiles update IN PLACE (``index_copy_``; the JAX version builds
        new arrays): a handle in flight already holds its words, launched
        earlier on the same stream. The fid rows are copied on write,
        because a fused handle's budget regrow re-decodes through the rows
        it was submitted with. Fid rows the fused pipeline no longer wants
        are dropped, segments' too (the JAX matcher keeps segment rows, and
        they then miss the deltas of the time the pipeline was off)."""
        st = self._dev
        if st is None:
            return False
        cids = delta_chunk_plan(
            t, enabled=self.delta_enabled, dev_version=st.snap.version,
            has_resident=True, dev_epoch=st.snap.epoch, dev_lvl=st.lvl,
            dev_dtype=st.dtype, dt=dt, dev_up_chunks=st.up_chunks,
            dev_layout=st.layout, layout=layout,
        )
        if cids is None:
            return False
        want_fids = self._want_fids()
        if want_fids and not st.has_fids():
            return False
        if not want_fids:
            st.drop_fids()
        if cids:
            tiles = (pack_chunk_tiles_packed(t, cids, layout)
                     if layout is not None else pack_chunk_tiles(t, cids, dt))
            ftiles = pack_fid_chunk_tiles(t, cids) if want_fids else None
            if st.segments is None:
                st.fids = self._scatter(st.tiles, st.fids, cids, tiles, ftiles)
            else:
                self._apply_segment_delta(st, t, cids, tiles, ftiles)
            self.uploads += 1
            self.delta_uploads += 1
            nb = tiles.nbytes + (ftiles.nbytes if ftiles is not None else 0)
            self.upload_bytes += nb
            if _DEVPROF.enabled:
                _DEVPROF.note_upload("delta", nb)
        st.snap = _Snap(t.version, st.snap.epoch, t._fid_of_row)
        return True

    def _scatter(self, dst: torch.Tensor, fids: Optional[torch.Tensor], cids,
                 tiles: np.ndarray, ftiles: Optional[np.ndarray]):
        """Tiles of the chunks ``cids`` into ``dst`` in place; their fid rows
        into a copy of ``fids`` (None stays None) → the fid rows to keep."""
        idx = to_device(np.asarray(cids, dtype=np.int64), self.device)
        rows = to_device(tiles, self.device)
        frows = to_device(ftiles, self.device) if ftiles is not None and \
            fids is not None else None
        if not _DEVPROF.enabled:
            _scatter_rows(dst, idx, rows)
            return fids if frows is None else _scatter_rows(fids.clone(), idx, frows)
        # keyed on the pow2 bucket of the dirty-chunk count, the JAX
        # package's padded scatter shape (the port does not pad)
        bucket = 1 << (len(cids) - 1).bit_length()
        _pj("delta_scatter", _scatter_rows, dst, idx, rows,
            _key=_DEVPROF.key_of((dst,), {}) + (bucket,))
        if frows is None:
            return fids
        return _pj("delta_scatter_fids", _scatter_rows, fids.clone(), idx, frows,
                   _key=_DEVPROF.key_of((fids,), {}) + (bucket,))

    def _apply_segment_delta(self, st: DeviceState, t: PartitionedTable, cids,
                             tiles: np.ndarray, ftiles: Optional[np.ndarray]) -> None:
        """Scatter dirty chunks into their segments (global chunk ``cid`` at
        local ``cid - base + 1`` past segment 0) and advance each segment's
        live end as the table grows into the built-in padding."""
        cid_arr = np.asarray(cids, dtype=np.int64)
        segs: List[Segment] = []
        for si, s in enumerate(st.segments):
            sel = np.nonzero((cid_arr >= s.base) & (cid_arr < s.base + st.seg_cap))[0]
            fids = s.fids
            if len(sel):
                loc = cid_arr[sel] if si == 0 else cid_arr[sel] - (s.base - 1)
                fids = self._scatter(s.tiles, s.fids, loc, tiles[sel],
                                     ftiles[sel] if ftiles is not None else None)
            segs.append(Segment(s.base, min(s.base + st.seg_cap, t.nchunks),
                                s.tiles, fids))
        st.segments = segs

    # ------------------------------------------------------------- submit
    def _put(self, arr: np.ndarray, dtype=np.int32) -> torch.Tensor:
        """One per-batch host input → device, widened on the host (the
        kernels take int32; torch has thin uint16 support)."""
        return to_device(np.asarray(arr).astype(dtype, copy=False), self.device)

    def match_submit(self, topics: Sequence[str], pad_to_pow2: bool = True):
        """Encode + dispatch WITHOUT fetching: the device work is queued on
        the current stream, so the caller can encode batch N+1 while N
        computes, then ``match_complete`` each handle in order.

        With the device profiler on, the submit half opens a flight record
        (compile hit-vs-trace, batch/padded rows) that ``match_complete``
        closes with the fetch/decode stage deltas; off = one attribute
        check."""
        if not _DEVPROF.enabled:
            return self._submit_impl(topics, pad_to_pow2)
        # the traces delta is best-effort under concurrency: another
        # matcher tracing between the marks can mislabel this record
        # 'trace' — the registry totals themselves stay exact
        tr0 = _DEVPROF.traces
        sn0 = dict(self.stage_ns) if self.stage_timing else None
        t0 = time.perf_counter_ns()
        meta: dict = {}
        h = self._submit_impl(topics, pad_to_pow2, _meta=meta)
        traces = _DEVPROF.traces - tr0
        padded = meta.get("padded", len(topics))
        rec = {
            "ts": round(time.time(), 3),
            "kind": h[0],
            "batch": len(topics),
            "padded": padded,
            "pad_waste": round(1.0 - len(topics) / padded, 4) if padded else 0.0,
            "traces": traces,
            "compile": "trace" if traces else "hit",
            "submit_ns": time.perf_counter_ns() - t0,
        }
        old = None
        with self._prof_lock:
            self._prof_pending.append((h, rec, sn0))
            if len(self._prof_pending) > 16:
                # abandoned handle (caller never completed it): flush so the
                # record still reaches the ring and the deque stays bounded
                _h, old, _sn = self._prof_pending.popleft()
        if old is not None:
            # ring-only: it never completed, so it is not a dispatch
            _DEVPROF.note_abandoned(old)
        return h

    def _submit_impl(self, topics: Sequence[str], pad_to_pow2: bool = True,
                     _meta: Optional[dict] = None):
        t = self.table
        if t.compact_async:
            # churn-triggered background compaction: the rebuild runs on
            # its own thread while dispatches keep matching against the
            # fragmented-but-correct old layout
            t.maybe_compact_async()
        elif t.needs_compact():
            t.compact()
        b = len(topics)
        if b == 0:
            return ("e",)
        padded = b
        if pad_to_pow2:
            padded = max(1 << (b - 1).bit_length(), self._pad_floor)
        if _meta is not None:
            # the profiler's pad-waste source — an out-param, not an
            # attribute: concurrent submits must not cross-attribute
            _meta["padded"] = padded
        t_enc = time.perf_counter_ns() if self.stage_timing else 0
        while True:
            enc, enc_epoch = t.encode_topics_versioned(
                topics, pad_batch_to=padded, with_groups=True)
            st = self._refresh()
            if st.snap.epoch != enc_epoch:
                # a compaction installed between the encode and the
                # refresh: the chunk ids reference the old layout — re-encode
                continue
            if st.layout is not None:
                # packed tiles: topic tokens re-key into the per-level local
                # id spaces; a layout change racing the refresh re-encodes
                lay, tt = t.translate_packed(enc[0])
                if lay != st.layout:
                    continue
            else:
                tt = enc[0]
            break
        snap = st.snap
        _ttok, tlen, tdollar, chunk_ids, _nc, groups = enc
        if t_enc:
            now = time.perf_counter_ns()
            self.stage_ns["encode"] += now - t_enc
            t_enc = now
        try:
            if st.segments is not None:
                return self._submit_segmented(st, tt, tlen, tdollar, chunk_ids, b,
                                              snap)
            if self.compact_mode != "global":
                return self._submit_topk(st, tt, tlen, tdollar, chunk_ids, b, snap)
            if self._fused is not False and st.fids is not None:
                return self._submit_fused(st.tiles, st.fids, st.layout, tt, tlen,
                                          tdollar, chunk_ids, groups, padded, b)
            return self._submit_global(st.tiles, st.layout, tt, tlen, tdollar,
                                       chunk_ids, groups, padded, b, 0, snap)
        finally:
            if t_enc:
                self.stage_ns["dispatch"] += time.perf_counter_ns() - t_enc

    # ------------------------------------------------- NC split-dispatch
    @staticmethod
    def _tier_ladder(nc: int) -> Tuple[int, ...]:
        """NC tiers: ~1.5×-step ladder (8, 12, 16, 24, 32, 48, …) capped
        at nc. Batches concentrate in a narrow count band just under the
        sticky pow2 cap (cfg3: about 12 real candidates against a cap of
        32), so the 1.5 steps put a tier close above the band while
        small-bucket upward merging keeps the bucket count low."""
        tiers: List[int] = []
        k = 0
        while (8 << k) < nc:
            tiers.append(8 << k)
            if (12 << k) < nc:
                tiers.append(12 << k)
            k += 1
        tiers.append(nc)
        return tuple(tiers)

    def _split_plan(self, chunk_ids: np.ndarray, b: int):
        """Bucket the REAL topics (not the pow2 pad) by candidate count;
        None when splitting can't save ≥25% of the scan work (the padding
        rows each bucket re-adds are part of the estimate)."""
        nc = chunk_ids.shape[1]
        if not self._split or b < self.SPLIT_MIN_BATCH or nc <= 8:
            return None
        counts = (chunk_ids[:b] != 0).sum(axis=1)
        tiers = np.asarray(self._tier_ladder(nc))
        assign = np.searchsorted(tiers, counts)  # smallest tier ≥ count
        sizes = np.bincount(assign, minlength=len(tiers))
        # merge small buckets upward (a bucket in a bigger tier stays
        # correct — extra columns are zero-padded): a tiny bucket saves
        # less compute than its launches and pow2 padding cost
        floor = max(256, b // 16)
        for i in range(len(tiers) - 1):
            if 0 < sizes[i] < floor:
                sizes[i + 1] += sizes[i]
                sizes[i] = 0
                assign[assign == i] = i + 1
        est = sum(
            (1 << (int(s) - 1).bit_length()) * int(t)
            for s, t in zip(sizes, tiers) if s
        )
        if est * 4 >= b * nc * 3:
            return None
        order = np.argsort(assign, kind="stable")
        return order, sizes, tuple(int(t) for t in tiers)

    def _budget_for(self, padded: int, nc: int) -> int:
        g = self._budgets.get((padded, nc))
        if g is None:
            g = max(256, 1 << (4 * padded - 1).bit_length())
            self._budgets[(padded, nc)] = g
        return g

    def _regrow(self, n: int, key: Tuple[int, int]) -> int:
        """Sticky pow2 budget regrow for a batch shape whose routes
        overflowed its budget."""
        g = 1 << max(8, (n - 1).bit_length())
        self._budgets[key] = max(self._budgets.get(key, 0), g)
        return g

    def _group_inputs(self, groups: np.ndarray, chunk_ids: np.ndarray):
        """→ (uniq_cand [U_pow2, NC], inv [B]) for the grouped upload, or
        None when the batch doesn't dedup (uniform streams barely share
        prefixes; devices republishing the same topics collapse U)."""
        uq, first_idx, inv = np.unique(
            groups, return_index=True, return_inverse=True
        )
        u = len(uq)
        u_pow2 = 1 << (max(1, u) - 1).bit_length()
        if u_pow2 >= groups.shape[0]:
            # no dedup (or a batch so small the pow2 bucket erases it):
            # the plain [B, NC] upload is strictly cheaper
            return None
        self._u_cap = max(self._u_cap, u_pow2)
        uniq_cand = np.zeros((self._u_cap, chunk_ids.shape[1]),
                             dtype=chunk_ids.dtype)
        uniq_cand[:u] = chunk_ids[first_idx]
        return uniq_cand, inv.reshape(-1)

    def _bucket_inputs(self, tt, tlen, tdollar, chunk_ids, split):
        """The NC split's buckets uploaded → (device parts, [(topics,
        padded, tier)], budgets, host chunk ids per bucket)."""
        parts: List[Tuple] = []
        meta: List[Tuple[int, int, int]] = []
        budgets: List[int] = []
        hosts: List[np.ndarray] = []
        for arrs, (s, pb, tier) in split_buckets(tt, tlen, tdollar, chunk_ids,
                                                 split):
            parts.append(tuple(self._put(a) for a in arrs))
            meta.append((s, pb, tier))
            budgets.append(self._budget_for(pb, tier))
            hosts.append(arrs[3])
        return parts, meta, tuple(budgets), hosts

    # ------------------------------------------------- fused pipeline
    def _submit_fused(self, tiles, fids, layout, tt, tlen, tdollar, chunk_ids,
                      groups, padded: int, b: int):
        """One batch (or one segment's share of it) through words + the
        fused tail; ``groups`` None skips the grouped upload."""
        split = self._split_plan(chunk_ids, b)
        if split is not None:
            return self._submit_fused_split(tiles, fids, layout, tt, tlen,
                                            tdollar, chunk_ids, split)
        g = self._budget_for(padded, chunk_ids.shape[1])
        ins = (self._put(tt), self._put(tlen), self._put(tdollar))
        grouped = self._group_inputs(groups, chunk_ids) if groups is not None else None
        if grouped is None:
            out = match_fused(tiles, fids, *ins, self._put(chunk_ids), g, layout,
                              self.use_kernel)
        else:
            uniq, inv = grouped
            out = match_fused_grouped(tiles, fids, *ins, self._put(uniq),
                                      self._put(inv, np.int64), g, layout,
                                      self.use_kernel)
        return ("f", b, out, g, fids)

    def _redecode(self, words, fids, chunk_ids, g: int) -> torch.Tensor:
        """A budget regrow: the fused tail again on the submit-time words."""
        tail = fused_compact_decode if self.use_kernel else fused_compact_decode_plain
        if _DEVPROF.enabled:
            return _pj(tail.__name__, tail, words, fids, chunk_ids, g)
        return tail(words, fids, chunk_ids, g)

    def _submit_fused_split(self, tiles, fids, layout, tt, tlen, tdollar,
                            chunk_ids, split):
        """Fused NC split-dispatch: topics bucketed host-side by candidate
        count, one fused pass per bucket, one fetch for the batch."""
        parts, meta, budgets, _hosts = self._bucket_inputs(tt, tlen, tdollar,
                                                           chunk_ids, split)
        wire, outs = match_fused_split(tiles, fids, parts, budgets, layout,
                                       self.use_kernel)
        return ("fs", len(split[0]), split[0], meta, outs, wire, budgets, fids)

    def _complete_fused(self, handle) -> List[np.ndarray]:
        """Block on a fused handle: ONE fetch of ``[fids..., cnts...]``;
        the host's whole decode is an ``np.split`` by counts."""
        _tag, b, out, g, fids = handle
        t0 = time.perf_counter_ns() if self.stage_timing else 0
        while True:
            arr = fetch(out.wire, "fused match fetch")
            cn = arr[g:].astype(np.int64)
            n = int(cn.sum())
            if n <= g:
                break
            g = self._regrow(n, tuple(out.chunk_ids.shape))
            out = out._replace(
                wire=self._redecode(out.words, fids, out.chunk_ids, g))
        if t0:
            now = time.perf_counter_ns()
            self.stage_ns["fetch"] += now - t0
            t0 = now
        if cn[b:].any():
            # a padded topic (tlen=-2, can match nothing) with routes is a
            # device bug: fail loudly
            raise AssertionError("padded topic produced routes — device bug")
        res = self._split_fused_wire(arr, cn, n, b)
        self.fused_batches += 1
        if t0:
            self.stage_ns["decode"] += time.perf_counter_ns() - t0
        return res

    @staticmethod
    def _split_fused_wire(arr, cn, n: int, b: int) -> List[np.ndarray]:
        flat = arr[:n].astype(np.int64)
        if n and int(flat.min()) < 0:
            # a -1 here means a cleared row's bit survived to the final
            # output — device or compaction bug, never valid concurrency
            raise AssertionError(
                "cleared-row fid escaped the fused device decode")
        bounds = np.cumsum(cn[: b - 1])
        return np.split(flat, bounds)

    def _complete_fused_split(self, handle) -> List[np.ndarray]:
        _tag, b, order, meta, outs, wire, budgets, fids = handle
        t0 = time.perf_counter_ns() if self.stage_timing else 0
        while True:
            arr = fetch(wire, "fused match fetch")
            segs = []
            regrow = list(budgets)
            ok = True
            o = 0
            for bi, ((_s, pb, tier), g) in enumerate(zip(meta, budgets)):
                fid_seg = arr[o : o + g]
                cn = arr[o + g : o + g + pb].astype(np.int64)
                o += g + pb
                segs.append((fid_seg, cn))
                n = int(cn.sum())
                if n > g:
                    ok = False
                    regrow[bi] = self._regrow(n, (pb, tier))
            if ok:
                break
            budgets = tuple(regrow)
            wire = torch.cat([self._redecode(f.words, fids, f.chunk_ids, g)
                              for f, g in zip(outs, budgets)])
        if t0:
            now = time.perf_counter_ns()
            self.stage_ns["fetch"] += now - t0
            t0 = now
        res: List[Optional[np.ndarray]] = [None] * b
        pos = 0
        for (s, _pb, _tier), (fid_seg, cn) in zip(meta, segs):
            if cn[s:].any():
                raise AssertionError("padded topic produced routes — device bug")
            rows = self._split_fused_wire(fid_seg, cn, int(cn.sum()), s)
            for orig, r in zip(order[pos : pos + s], rows):
                res[orig] = r
            pos += s
        self.fused_batches += 1
        if t0:
            self.stage_ns["decode"] += time.perf_counter_ns() - t0
        return res

    # ------------------------------------------------- unfused global path
    def _submit_global(self, tiles, layout, tt, tlen, tdollar, chunk_ids, groups,
                       padded: int, b: int, fid_base: int, snap: _Snap):
        """Words + ``compact_global`` (split, grouped or plain); the routes
        decode on the host through ``snap``'s fid map from row ``fid_base``
        on (a segment's affine offset)."""
        split = self._split_plan(chunk_ids, b)
        if split is not None:
            return self._submit_split(tiles, layout, tt, tlen, tdollar, chunk_ids,
                                      split, fid_base, snap)
        g = self._budget_for(padded, chunk_ids.shape[1])
        ins = (self._put(tt), self._put(tlen), self._put(tdollar))
        grouped = self._group_inputs(groups, chunk_ids) if groups is not None else None
        prof = _DEVPROF.enabled
        if grouped is None:
            args = (tiles, *ins, self._put(chunk_ids), g, layout, self.use_kernel)
            out = (_pj("match_global", match_global, *args) if prof
                   else match_global(*args))
        else:
            uniq, inv = grouped
            args = (tiles, *ins, self._put(uniq), self._put(inv, np.int64), g,
                    layout, self.use_kernel)
            out = (_pj("match_global_grouped", match_global_grouped, *args) if prof
                   else match_global_grouped(*args))
        # the handle carries ITS OWN budget: a sticky widening by a later
        # handle must not mask this one's truncation
        return ("g", b, chunk_ids, out, g, fid_base, snap)

    def _recompact(self, words, g: int) -> torch.Tensor:
        """A budget regrow: ``compact_global`` again on the submit-time words."""
        tail = compact_global if self.use_kernel else compact_global_plain
        if _DEVPROF.enabled:
            return _pj(tail.__name__, tail, words, g)
        return tail(words, g)

    def _submit_split(self, tiles, layout, tt, tlen, tdollar, chunk_ids, split,
                      fid_base: int, snap: _Snap):
        parts, meta, budgets, hosts = self._bucket_inputs(tt, tlen, tdollar,
                                                          chunk_ids, split)
        args = (tiles, parts, budgets, layout, self.use_kernel)
        wire, outs = (_pj("match_global_split", match_global_split, *args)
                      if _DEVPROF.enabled else match_global_split(*args))
        return ("s", len(split[0]), split[0], meta, hosts, outs, wire, budgets,
                fid_base, snap)

    def _complete_global(self, handle) -> List[np.ndarray]:
        _tag, b, chunk_ids, out, g, fid_base, snap = handle
        t0 = time.perf_counter_ns() if self.stage_timing else 0
        while True:
            # ONE fetch per match: [routes..., cnts...] (counts are
            # truncation-exact, so overflow is detectable from the same
            # array that carries the routes)
            arr = _unsigned(fetch(out.wire, "match result fetch"))
            cn = arr[g:].astype(np.int64)
            n = int(cn.sum())
            if n <= g:
                break
            g = self._regrow(n, chunk_ids.shape)
            out = out._replace(wire=self._recompact(out.words, g))
        if t0:
            now = time.perf_counter_ns()
            self.stage_ns["fetch"] += now - t0
            t0 = now
        res = self._decode_revalidated(
            snap, fid_base,
            lambda fid_map, overlay, strict: _decode_routes(
                arr[:n], cn, chunk_ids, b, fid_map, overlay=overlay,
                strict=strict))
        if t0:
            self.stage_ns["decode"] += time.perf_counter_ns() - t0
        return res

    def _complete_split(self, handle) -> List[np.ndarray]:
        _tag, b, order, meta, hosts, outs, wire, budgets, fid_base, snap = handle
        while True:
            arr = _unsigned(fetch(wire, "match result fetch"))
            segs: List[Tuple[np.ndarray, np.ndarray]] = []
            regrow = list(budgets)
            ok = True
            o = 0
            for bi, ((_s, pb, tier), g) in enumerate(zip(meta, budgets)):
                routes_seg = arr[o : o + g]
                cn = arr[o + g : o + g + pb].astype(np.int64)
                o += g + pb
                segs.append((routes_seg, cn))
                n = int(cn.sum())
                if n > g:
                    ok = False
                    regrow[bi] = self._regrow(n, (pb, tier))
            if ok:
                break
            budgets = tuple(regrow)
            wire = _cat_wires([self._recompact(u.words, g)
                               for u, g in zip(outs, budgets)])

        # the decode snapshot is taken AFTER the blocking fetch (like every
        # other complete path); _decode_revalidated closes the
        # overlay→gather write window without stalling mutations
        def decode(fid_map, overlay, strict):
            res: List[Optional[np.ndarray]] = [None] * b
            pos = 0
            for (s, _pb, _tier), pc, (routes_seg, cn) in zip(meta, hosts, segs):
                n = int(cn.sum())
                rows = _decode_routes(routes_seg[:n], cn, pc, s, fid_map,
                                      overlay=overlay, strict=strict)
                for orig, r in zip(order[pos : pos + s], rows):
                    res[orig] = r
                pos += s
            return res

        return self._decode_revalidated(snap, fid_base, decode)

    # ------------------------------------------------------- topk mode
    def _submit_topk(self, st: DeviceState, tt, tlen, tdollar, chunk_ids, b: int,
                     snap: _Snap):
        args = (st.tiles, self._put(tt), self._put(tlen), self._put(tdollar),
                self._put(chunk_ids), self.max_words, st.layout, self.use_kernel)
        out = (_pj("match_partitioned", match_partitioned, *args)
               if _DEVPROF.enabled else match_partitioned(*args))
        # same contract as the global budget: the handle carries ITS OWN
        # max_words
        return ("k", b, chunk_ids, out, self.max_words, snap)

    def _complete_topk(self, handle) -> List[np.ndarray]:
        _tag, b, chunk_ids, out, kw, snap = handle
        bp = chunk_ids.shape[0]
        while True:
            arr = fetch(out.wire, "match result fetch")
            k = (arr.size - bp) // (2 * bp)  # min(kw, words per topic)
            cn = arr[2 * bp * k:]
            mx = int(cn[:b].max(initial=0))
            if mx <= kw:
                break
            # rare: re-run wider; sticky so later batches skip the narrow run
            kw = 1 << (mx - 1).bit_length()
            self.max_words = max(self.max_words, kw)
            out = out._replace(wire=(
                _pj("compact_words", _topk_wire, out.words, kw, self.use_kernel)
                if _DEVPROF.enabled else _topk_wire(out.words, kw, self.use_kernel)))
        wi = arr[: bp * k].reshape(bp, k)
        wb = arr[bp * k : 2 * bp * k].view(np.uint32).reshape(bp, k)
        return self._decode_revalidated(
            snap, 0,
            lambda fid_map, overlay, strict: _decode_batch(
                wi[:b], wb[:b], chunk_ids[:b], b, fid_map,
                overlay=overlay, strict=strict))

    # ------------------------------------------------- segmented tables
    def _submit_segmented(self, st: DeviceState, tt, tlen, tdollar, chunk_ids,
                          b: int, snap: _Snap):
        """One sub-handle per segment: the global candidate chunk ids are
        remapped to segment-local ids (front-packed, cut or padded to a
        sticky per-segment NC), matched against the segment's tiles, and
        decoded through its fid rows (fused) or its affine slice of the fid
        map (unfused). A segment no topic of the batch has a candidate in
        launches nothing (an ``"E"`` sub-handle)."""
        cid = chunk_ids.astype(np.int32, copy=False)
        padded = cid.shape[0]
        handles = []
        for si, s in enumerate(st.segments):
            if s.base == 0:
                loc = np.where(cid < s.end, cid, 0)
                fid_base = 0
            else:
                loc = np.where((cid >= s.base) & (cid < s.end), cid - (s.base - 1), 0)
                fid_base = (s.base - 1) * CHUNK
            loc = _front_pack(loc)
            mx = int((loc != 0).sum(axis=1).max(initial=0))
            if mx == 0:
                handles.append(("E", b))
                continue
            ncs = max(self._seg_nc.get(si, 8), 1 << (mx - 1).bit_length())
            self._seg_nc[si] = ncs
            if loc.shape[1] >= ncs:
                loc = loc[:, :ncs]
            else:
                loc = np.pad(loc, ((0, 0), (0, ncs - loc.shape[1])))
            if self._fused is not False and s.fids is not None:
                handles.append(self._submit_fused(s.tiles, s.fids, st.layout, tt,
                                                  tlen, tdollar, loc, None, padded, b))
            else:
                handles.append(self._submit_global(s.tiles, st.layout, tt, tlen,
                                                   tdollar, loc, None, padded, b,
                                                   fid_base, snap))
        return ("M", b, handles)

    _EMPTY_FIDS = np.empty(0, dtype=np.int64)

    def _complete_segmented(self, handle) -> List[np.ndarray]:
        _tag, b, handles = handle
        fused_before = self.fused_batches
        per_seg = [
            # sub-handles complete through the impl directly: only the
            # top-level "M" handle owns a profiler flight record
            [self._EMPTY_FIDS] * b if h[0] == "E" else self._complete_impl(h)
            for h in handles
        ]
        if self.fused_batches > fused_before:
            # per-segment completes each bump the counter, but they are ONE
            # logical batch
            self.fused_batches = fused_before + 1
        out: List[np.ndarray] = []
        for i in range(b):
            arrs = [s[i] for s in per_seg if len(s[i])]
            if not arrs:
                out.append(per_seg[0][i])
            elif len(arrs) == 1:
                out.append(arrs[0])
            else:
                out.append(np.sort(np.concatenate(arrs)))
        return out

    # ---------------------------------------------------- host decode
    def _decode_revalidated(self, snap: _Snap, fid_base: int, decode):
        """Close the overlay→gather window without serializing decode
        against mutations: run ``decode(fid_map, overlay, strict)``
        optimistically lock-free, then revalidate ``table.version`` under
        the lock. Mutations write the fid map and bump version under that
        same lock, so an unchanged version proves no in-place write could
        have landed between the overlay snapshot and the gather and the
        result stands; a changed version (a subscribe raced this decode —
        rare) redoes the decode under the lock."""
        t = self.table
        v0 = t.version
        res = decode(*self._snap_decode_state(snap, fid_base))
        with t._mu:
            if t.version == v0:
                return res
            return decode(*self._snap_decode_state(snap, fid_base))

    def _snap_decode_state(self, snap: Optional[_Snap], fid_base: int = 0):
        """→ (fid_map, overlay, strict) for decoding a handle.

        ``fid_map`` is the row→fid array the handle was submitted against;
        ``overlay`` patches rows mutated since back to their submit-time
        fids (None = nothing to patch); ``strict=False`` means the undo
        journal overflowed — decode best-effort against the live map and
        drop rows that have since been cleared instead of asserting."""
        if snap is None:
            fid_map = self.table._fid_of_row
            overlay, ok = None, True
        else:
            fid_map = snap.fid_map
            overlay, ok = self.table.fid_overlay(snap.version, snap.epoch)
            if not ok or not overlay:
                # journal too old (ok=False): the snapshot array still only
                # carries ITS epoch's in-place writes — decode against it
                # best-effort, dropping rows cleared since (never the live
                # map, which may belong to a newer layout entirely)
                overlay = None
        if fid_base:
            fid_map = fid_map[fid_base:]
            if overlay:
                overlay = {r - fid_base: f for r, f in overlay.items()
                           if r >= fid_base}
        return fid_map, overlay, ok

    # --------------------------------------------------------- complete
    def match_complete(self, handle) -> List[np.ndarray]:
        """Block on a ``match_submit`` handle → per-topic fid arrays
        (ascending); with the device profiler on, closes the handle's
        flight record."""
        if not _DEVPROF.enabled:
            if self._prof_pending:
                # records from a just-disabled profiler must still be
                # dropped: a pending record holds the handle (device
                # buffers included) and would pin it
                self._prof_drop(handle)
            return self._complete_impl(handle)
        ent = self._prof_drop(handle)
        if ent is None:
            # a handle submitted before the profiler flipped on
            return self._complete_impl(handle)
        _h, rec, sn0 = ent
        fused0 = self.fused_batches
        t0 = time.perf_counter_ns()
        out = self._complete_impl(handle)
        rec["complete_ns"] = time.perf_counter_ns() - t0
        rec["fused"] = self.fused_batches > fused0
        rec["routes"] = int(sum(len(r) for r in out))
        if sn0 is not None:
            # per-stage ns deltas; pipelined overlap can smear attribution
            # between ADJACENT records (stage counters are matcher-wide)
            rec["stage_ns"] = {k: self.stage_ns[k] - sn0[k] for k in self.stage_ns}
        _DEVPROF.note_dispatch(rec, rec["submit_ns"] + rec["complete_ns"])
        return out

    def _prof_drop(self, handle):
        """Pop (by handle IDENTITY) this handle's pending flight record, if
        any; a handle from before the profiler was on returns None."""
        with self._prof_lock:
            for i, cand in enumerate(self._prof_pending):
                if cand[0] is handle:
                    del self._prof_pending[i]
                    return cand
        return None

    def _complete_impl(self, handle) -> List[np.ndarray]:
        tag = handle[0]
        if tag == "e":
            return []
        if tag == "f":
            return self._complete_fused(handle)
        if tag == "fs":
            return self._complete_fused_split(handle)
        if tag == "M":
            return self._complete_segmented(handle)
        if tag == "g":
            return self._complete_global(handle)
        if tag == "s":
            return self._complete_split(handle)
        return self._complete_topk(handle)

    def match(self, topics: Sequence[str], pad_to_pow2: bool = True) -> List[np.ndarray]:
        return self.match_complete(self.match_submit(topics, pad_to_pow2))

    # ------------------------------------------------------------- knobs
    def prewarm(self, batch_sizes: Sequence[int] = (1, 8)) -> None:
        """Latch the largest size as the sticky pad floor (small batches
        pad UP to it), unless ``RMQTT_PAD_FLOOR`` pinned the floor. The
        port compiles nothing per shape, so this only latches the floor."""
        sizes = [int(s) for s in batch_sizes if s > 0]
        if not sizes:
            return
        old = self._pad_floor
        if not self._pad_floor_pinned:
            self._pad_floor = max(self._pad_floor, max(sizes))
        if _DEVPROF.enabled:
            _DEVPROF.note_pad_floor(self._pad_floor, old)

    def set_pad_floor(self, floor: int) -> int:
        """Set the sticky pad floor to an exact value (may LOWER it, unlike
        ``prewarm``). → the old floor."""
        old = self._pad_floor
        self._pad_floor = max(1, int(floor))
        if self._pad_floor != old and _DEVPROF.enabled:
            _DEVPROF.note_pad_floor(self._pad_floor, old)
        return old

    def hbm_breakdown(self) -> dict:
        """Device-memory occupancy model of this matcher's residency: tiles
        (packed or legacy), the row→fid map, the segment count (0 for one
        array), plus what legacy field-major tiles would cost at the same
        padded capacity and the host-side overlay journal depth."""

        def nb(a) -> int:
            return a.numel() * a.element_size() if a is not None else 0

        st = self._dev
        tiles = fid = segs = 0
        if st is not None and st.segments is not None:
            segs = len(st.segments)
            for s in st.segments:
                tiles += nb(s.tiles)
                fid += nb(s.fids)
        elif st is not None:
            tiles, fid = nb(st.tiles), nb(st.fids)
        t = self.table
        up = st.up_chunks if st is not None else _pad_chunk_count(t.nchunks)
        legacy = up * CHUNK * (t.max_levels + 3) * (4 if t._tok_wide else 2)
        return {
            "layout": "packed" if st is not None and st.layout is not None
            else "legacy",
            "tiles_bytes": tiles,
            "fid_map_bytes": fid,
            "segments": segs,
            "legacy_tiles_bytes_model": int(legacy),
            "overlay_journal_entries": len(t._fid_undo_v),
            "total_bytes": tiles + fid,
        }


# ------------------------------------------------------- host decoders
def _front_pack(a: np.ndarray) -> np.ndarray:
    """Stable-move each row's nonzero entries to the front (zeros pad the
    tail) — segment remapping punches holes in the front-packed candidate
    lists, and the column cut assumes front-packing."""
    order = np.argsort(a == 0, axis=1, kind="stable")
    return np.take_along_axis(a, order, axis=1)


def _overlay_fids(rows, fids, tj, overlay, strict):
    """Patch gathered fids through a submit-time overlay (rows mutated
    after the handle's snapshot get their AS-OF fids back) and, in
    non-strict mode, drop rows cleared since (their -1 is a legitimate
    concurrent unsubscribe, not a device bug)."""
    if overlay:
        ov_rows = np.fromiter(overlay.keys(), dtype=np.int64, count=len(overlay))
        m = np.isin(rows, ov_rows)
        if m.any():
            fids[m] = np.asarray(
                [overlay[int(r)] for r in rows[m]], dtype=np.int64
            )
    if not strict:
        keep = fids >= 0
        if not bool(keep.all()):
            return tj[keep], fids[keep]
    return tj, fids


def _decode_batch(
    wi: np.ndarray, wb: np.ndarray, chunk_ids: np.ndarray, b: int,
    fid_map: np.ndarray, overlay=None, strict: bool = True,
) -> List[np.ndarray]:
    """(word_idx, word_bits) → per-topic sorted FILTER-ID arrays.

    Prefers the native decoder (runtime/encode.cc rt_match_decode: bit
    extraction + fid map + per-topic sort in C++); the numpy path below
    serves where the runtime cannot be built (no g++) and doubles as its
    differential oracle. A handle with concurrent-mutation state (overlay
    / non-strict) takes the numpy path — the rare case where correctness
    work is needed per row."""
    if overlay is None and strict:
        native = _native_decode(wi, wb, chunk_ids, b, fid_map)
        if native is not None:
            return native
    return _numpy_decode(wi, wb, chunk_ids, b, fid_map, overlay, strict)


def _native_decode(wi, wb, chunk_ids, b, fid_map) -> Optional[List[np.ndarray]]:
    from rmqtt_tpu_torch import runtime as rt

    res = rt.match_decode(
        np.ascontiguousarray(wi, dtype=np.int32),
        np.ascontiguousarray(wb, dtype=np.uint32),
        np.ascontiguousarray(chunk_ids, dtype=np.int32),
        WORDS_PER_CHUNK, CHUNK, fid_map,
    )
    if res is None:
        return None
    flat, counts = res
    bounds = np.cumsum(counts[:-1])
    return np.split(flat, bounds)


def _decode_routes(
    routes: np.ndarray, cn: np.ndarray, chunk_ids: np.ndarray, b: int,
    fid_map: np.ndarray, overlay=None, strict: bool = True,
) -> List[np.ndarray]:
    """Route-level global compaction → per-topic sorted fid arrays.

    ``routes`` carries one ``widx*32 + bitpos`` entry per match, flat
    topic-major by the two-stage prefix-sum construction; ``cn`` is the
    per-(padded-)topic route count vector, which reattributes slots to
    topics. Native path in runtime/encode.cc (rt_match_decode_routes:
    fid map + per-topic sort); the numpy path serves without g++ and
    doubles as its differential oracle."""
    if overlay is None and strict:
        native = _native_decode_routes(routes, cn, chunk_ids, b, fid_map)
        if native is not None:
            return native
    return _numpy_decode_routes(routes, cn, chunk_ids, b, fid_map, overlay, strict)


def _native_decode_routes(routes, cn, chunk_ids, b, fid_map) -> Optional[List[np.ndarray]]:
    from rmqtt_tpu_torch import runtime as rt

    flat = rt.match_decode_routes(
        np.ascontiguousarray(routes, dtype=np.uint32),
        np.ascontiguousarray(cn, dtype=np.int64),
        np.ascontiguousarray(chunk_ids, dtype=np.int32),
        b, WORDS_PER_CHUNK, CHUNK, fid_map,
    )
    if flat is None:
        return None
    bounds = np.cumsum(cn[: b - 1])
    return np.split(flat, bounds)


def _numpy_decode_routes(
    routes: np.ndarray, cn: np.ndarray, chunk_ids: np.ndarray, b: int,
    fid_map: np.ndarray, overlay=None, strict: bool = True,
) -> List[np.ndarray]:
    wpc = WORDS_PER_CHUNK
    padded = chunk_ids.shape[0]
    if cn[b:].any():
        # same fail-loudly contract as the native decoder: a padded topic
        # (tlen=-2, can match nothing) with a nonzero count is a device/
        # compaction bug — never misattribute its routes to topic b-1
        raise AssertionError("padded topic produced routes — device bug")
    tj = np.repeat(np.arange(padded, dtype=np.int64), cn)
    r = routes.astype(np.int64, copy=False)
    widx = r >> 5
    rows = (
        chunk_ids[tj, widx // wpc].astype(np.int64) * CHUNK
        + (widx % wpc) * 32
        + (r & 31)
    )
    fids = fid_map[rows]
    tj, fids = _overlay_fids(rows, fids, tj, overlay, strict)
    return _group_sorted(tj, fids, b)


def _group_sorted(tj: np.ndarray, fids: np.ndarray, b: int) -> List[np.ndarray]:
    """(topic index, fid) pairs → per-topic sorted fid arrays via one
    composite-key sort (shared tail of both numpy decoders).

    The pack requires 0 <= fid < 2^32 — a -1 (cleared-row sentinel, would
    mean a kernel or compaction bug) or a fid past 2^32 (4.3 billion add()
    calls) must fail loudly, not silently corrupt cross-topic attribution."""
    if fids.size and (int(fids.min()) < 0 or int(fids.max()) >= 1 << 32):
        raise AssertionError(
            f"fid out of composite-key range: min={fids.min()} max={fids.max()}"
        )
    composite = np.sort((tj.astype(np.int64) << 32) | fids)
    tj_sorted = composite >> 32
    out = composite & np.int64(0xFFFFFFFF)
    bounds = np.searchsorted(tj_sorted, np.arange(1, b))
    return np.split(out, bounds)


def _numpy_decode(
    wi: np.ndarray, wb: np.ndarray, chunk_ids: np.ndarray, b: int,
    fid_map: np.ndarray, overlay=None, strict: bool = True,
) -> List[np.ndarray]:
    """Pure-numpy decode of the topk wire (no-g++ path + differential
    oracle)."""
    wpc = WORDS_PER_CHUNK
    # expand bits only for NONZERO words: nonzero words are ~2% of the
    # tensor at realistic match rates
    tjw, kjw = np.nonzero(wb)
    words = wb[tjw, kjw]
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    nz_i, cols = np.nonzero(bits)
    tj = tjw[nz_i]
    widx = wi[tjw, kjw][nz_i]
    rows = (
        chunk_ids[tj, widx // wpc].astype(np.int64) * CHUNK
        + (widx % wpc).astype(np.int64) * 32
        + cols
    )
    fids = fid_map[rows]
    tj, fids = _overlay_fids(rows, fids, tj, overlay, strict)
    # one composite-key sort beats a two-key lexsort (~2x on 200K matches)
    return _group_sorted(tj, fids, b)
