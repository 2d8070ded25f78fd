"""Partitioned retained-topic scan, in PyTorch: SUBSCRIBE's inverse match.

The port of the JAX package's ``ops/retained_part.py``. Stored retained
*topics* (concrete, no wildcards) are rows of a ``PartitionedTable``
(``RetainedTable``), keyed by their first levels; an INVERSE index maps
masked partition keys to partition keys, so a wildcard SUBSCRIBE filter
enumerates only the partitions it could match (``filter_masks``). The
reference prunes the same way with a trie walk per SUBSCRIBE
(`rmqtt/src/retain.rs:373-450`, ``RetainTree::matches``).

Its device half tests a batch of filters against the legacy field-major
tiles of ``pack_device_rows`` (``[up_chunks, L+3, 128]`` int16/int32; the
row flag bit 1 carries the ``$``-topic bit) in two tiers:

- narrow filters gather their candidate chunks: :func:`retained_scan_gather`
  (kernel ``launch_retained_scan_gather``, ``csrc/retained_scan.cu``; twin
  :func:`retained_scan_words_plain`, of ``retained_scan_words_impl``);
- broad filters (``#``, ``+/#``), whose candidates cover most chunks,
  stream the whole table: :func:`retained_scan_full` (kernel
  ``launch_retained_scan_full``; twin :func:`retained_scan_full_plain`, of
  ``retained_scan_full_impl``).

A wrapper given CPU tensors runs its plain twin; given CUDA tensors it
launches its kernel or raises ``KernelError`` — it never falls back. Each
counts its launches in ``<wrapper>.launches``. ``PartitionedRetainedScanner``
keeps the device mirror and runs both tiers of a batch into one output
buffer: one host→device copy of the encoded filters and one device→host
copy of the words per scan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rmqtt_tpu_torch.core.topic import HASH, PLUS, is_metadata, split_levels
from rmqtt_tpu_torch.ops._build import kernel_library
from rmqtt_tpu_torch.ops.encode import PAD_TOK, PLUS_TOK
from rmqtt_tpu_torch.ops.match_words import (CHUNK, WORDS_PER_CHUNK, _pack_bits,
                                             _raise_on)
from rmqtt_tpu_torch.ops.partitioned import (PartitionedTable, pack_device_rows,
                                             resolve_device, to_device)
from rmqtt_tpu_torch.utils.devfetch import fetch


def _key_masks(key: Tuple) -> List[Tuple]:
    """All masked variants of a concrete partition key (None = free slot)."""
    kind, toks = key[0], key[1:]
    out = []
    for bits in range(1 << len(toks)):
        out.append((kind,) + tuple(
            None if (bits >> i) & 1 else toks[i] for i in range(len(toks))
        ))
    return out


def filter_masks(levels: Sequence[str]) -> List[Tuple]:
    """Masked partition keys a wildcard filter must consult.

    Concrete topics only occupy kinds ("1", t0) / ("2E", t0, t1) /
    ("4", t0, t1, t2); a filter with prefix length ``p`` (levels before a
    trailing ``#``) constrains topic level i < p to its literal token
    unless that level is ``+``.
    """
    h = levels[-1] == HASH
    p = len(levels) - 1 if h else len(levels)
    n = len(levels)

    def c(i: int) -> Optional[str]:
        return levels[i] if i < p and levels[i] != PLUS else None

    out: List[Tuple] = []
    if (h and p <= 1) or (not h and n == 1):
        out.append(("1", c(0)))
    if (h and p <= 2) or (not h and n == 2):
        out.append(("2E", c(0), c(1)))
    if h or n >= 3:
        out.append(("4", c(0), c(1), c(2)))
    return out


class RetainedTable(PartitionedTable):
    """Partition-chunked store of concrete retained-topic names.

    Reuses the router table's allocation (shared-chunk packing, stable
    fids, compact) and the unused ``first_wild`` row flag — always False
    for concrete topics — to carry the row's ``$``-topic bit, so
    ``pack_device_rows`` ships it as flag bit 1 with zero layout changes.
    """

    def __init__(self, max_levels: int = 8) -> None:
        super().__init__(max_levels)
        # masked key → partition keys (grow-only; keys never disappear)
        self._inv_index: Dict[Tuple, set] = {}
        self._indexed: set = set()
        # filter string → (chunk ids, version) candidate cache
        self._fcand_cache: Dict[str, np.ndarray] = {}
        self._fcand_version = -1
        # version-keyed row→fid snapshot for in-flight scans (fid_snapshot)
        self._fid_snap: Optional[Tuple[int, np.ndarray]] = None

    def fid_snapshot(self) -> np.ndarray:
        """Immutable row→fid mapping AS OF NOW, for pipelined scan handles.

        remove() mutates ``_fid_of_row`` in place and compact() swaps in a
        wholesale-new array (bumping ``version`` either way), so a scan
        completing after a mutation would otherwise decode bit positions
        against the post-mutation mapping (wrong/ghost fids). Memoized on
        ``version``: steady-state scans share one copy (O(1) per scan);
        each mutation burst pays one table-sized copy on the next scan.
        The returned array is never written to."""
        snap = self._fid_snap
        if snap is None or snap[0] != self.version:
            snap = self._fid_snap = (self.version, self._fid_of_row.copy())
        return snap[1]

    def _write_row(self, row: int, levels) -> None:
        # the base writer derives first_wild from wildcards (always False
        # here); re-derive the $-flag it carries instead, so a compaction
        # replay (install-time journal re-add) preserves it
        super()._write_row(row, levels)
        self.first_wild[row] = bool(levels[0]) and is_metadata(levels[0])

    def add(self, topic: str | Sequence[str]) -> int:
        levels = split_levels(topic) if isinstance(topic, str) else list(topic)
        if any(lev in (PLUS, HASH) for lev in levels):
            raise ValueError(f"retained topic may not contain wildcards: {topic!r}")
        fid = super().add(levels)
        key = self._key_of_fid[fid]
        if key not in self._indexed:
            self._indexed.add(key)
            for mk in _key_masks(key):
                self._inv_index.setdefault(mk, set()).add(key)
        return fid

    def candidates_for_filter(self, topic_filter: str | Sequence[str]) -> np.ndarray:
        """Candidate chunk ids a wildcard filter must scan."""
        fstr = topic_filter if isinstance(topic_filter, str) else "/".join(topic_filter)
        if self._fcand_version != self.version:
            self._fcand_cache.clear()
            self._fcand_version = self.version
        hit = self._fcand_cache.get(fstr)
        if hit is not None:
            return hit
        levels = split_levels(fstr)
        masks = filter_masks(levels)
        # broad fast path: when the masks would enumerate more partitions
        # than there are chunks, the union is (nearly) the whole table and
        # the Python walk costs more than the scan — hand back every chunk
        # and let the full-stream tier take it
        total = sum(len(self._inv_index.get(mk, ())) for mk in masks)
        if total > max(4096, self.nchunks):
            out = np.arange(1, self.nchunks, dtype=np.int32)
            self._fcand_cache[fstr] = out
            return out
        chunks: List[int] = []
        seen: set = set()
        for mk in masks:
            for key in self._inv_index.get(mk, ()):
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
        out = np.asarray(chunks, dtype=np.int32)
        self._fcand_cache[fstr] = out
        return out


# ------------------------------------------------------------ plain twins
def _filter_fields(ftok, flen, fprefix, fhash, fwild):
    return (ftok.to(torch.int32), flen.to(torch.int32), fprefix.to(torch.int32),
            fhash.to(torch.bool), fwild.to(torch.bool))


def retained_scan_words_plain(packed_rows, ftok, flen, fprefix, fhash, fwild,
                              chunk_ids) -> torch.Tensor:
    """Plain PyTorch twin of the gather kernel (and of the JAX package's
    ``retained_scan_words_impl``): one tile gather per candidate slot, the
    inverse match on ``[B, L, CHUNK]`` tensors, bits packed per 32 rows::

        level_ok = rtok == ftok | ftok == '+' | level >= fprefix
        len_ok   = fhash ? rlen >= fprefix : rlen == flen
        dollar_ok = !(row is a $-topic & the filter starts with a wildcard)
        live     = rlen >= 1

    → ``[B, NC*4]`` int32; word ``k*4 + w`` bit ``i`` is row ``w*32 + i``
    of tile ``chunk_ids[b, k]``."""
    b, nc = chunk_ids.shape
    lvl = packed_rows.shape[1] - 3
    dev = packed_rows.device
    ftok, flen, fprefix, fhash, fwild = _filter_fields(ftok, flen, fprefix,
                                                       fhash, fwild)
    cid = chunk_ids.to(torch.int64)
    lvl_idx = torch.arange(lvl, dtype=torch.int32, device=dev)
    plus = ftok == PLUS_TOK  # [B, L]
    out = torch.empty((b, nc, WORDS_PER_CHUNK), dtype=torch.int32, device=dev)
    for k in range(nc):
        g = packed_rows[cid[:, k]].to(torch.int32)  # [B, L+3, CHUNK]
        rtok = g[:, :lvl, :]
        rlen = g[:, lvl, :]
        rdollar = (g[:, lvl + 2, :] & 2) != 0
        eq = rtok == ftok[:, :, None]
        beyond = lvl_idx[None, :, None] >= fprefix[:, None, None]
        prefix_ok = (eq | plus[:, :, None] | beyond).all(dim=1)  # [B, CHUNK]
        len_ok = torch.where(fhash[:, None], rlen >= fprefix[:, None],
                             rlen == flen[:, None])
        dollar_ok = ~(rdollar & fwild[:, None])
        out[:, k] = _pack_bits(prefix_ok & len_ok & dollar_ok & (rlen >= 1))
    return out.reshape(b, nc * WORDS_PER_CHUNK)


def retained_scan_full_plain(packed_rows, ftok, flen, fprefix, fhash, fwild,
                             slab: int = 512) -> torch.Tensor:
    """Plain PyTorch twin of the full-stream kernel (and of the JAX
    package's ``retained_scan_full_impl``): the whole table in contiguous
    slabs of ``slab`` tiles, no gathers, every filter against every row.
    → ``[B, up_chunks*4]`` int32; word ``c*4 + w`` bit ``i`` is global row
    ``c*CHUNK + w*32 + i``."""
    up_chunks, lvlp3, _ = packed_rows.shape
    lvl = lvlp3 - 3
    b = ftok.shape[0]
    dev = packed_rows.device
    ftok, flen, fprefix, fhash, fwild = _filter_fields(ftok, flen, fprefix,
                                                       fhash, fwild)
    lvl_idx = torch.arange(lvl, dtype=torch.int32, device=dev)
    plus = ftok == PLUS_TOK  # [B, L]
    out = torch.empty((b, up_chunks, WORDS_PER_CHUNK), dtype=torch.int32,
                      device=dev)
    for s0 in range(0, up_chunks, slab):
        g = packed_rows[s0:s0 + slab].to(torch.int32)  # [S, L+3, CHUNK]
        s = g.shape[0]
        rtok = g[:, :lvl, :]
        rlen = g[:, lvl, :]
        rdollar = (g[:, lvl + 2, :] & 2) != 0
        eq = rtok[None] == ftok[:, None, :, None]  # [B, S, L, CHUNK]
        beyond = lvl_idx[None, None, :, None] >= fprefix[:, None, None, None]
        prefix_ok = (eq | plus[:, None, :, None] | beyond).all(dim=2)  # [B, S, C]
        len_ok = torch.where(fhash[:, None, None], rlen[None] >= fprefix[:, None, None],
                             rlen[None] == flen[:, None, None])
        dollar_ok = ~(rdollar[None] & fwild[:, None, None])
        m = prefix_ok & len_ok & dollar_ok & (rlen[None] >= 1)
        out[:, s0:s0 + s] = _pack_bits(m.reshape(b * s, CHUNK)).reshape(
            b, s, WORDS_PER_CHUNK)
    return out.reshape(b, up_chunks * WORDS_PER_CHUNK)


# ---------------------------------------------------------------- wrappers
def _check_cuda(name: str, tiles, fields, chunk_ids=None) -> None:
    dev = tiles.device
    named = list(zip(("ftok", "flen", "fprefix", "fhash", "fwild"), fields))
    if chunk_ids is not None:
        named.append(("chunk_ids", chunk_ids))
    if tiles.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"{name}: tiles dtype {tiles.dtype}, expected int16 or int32")
    if tiles.dim() != 3 or tiles.shape[2] != CHUNK or tiles.shape[1] < 4:
        raise ValueError(f"{name}: tiles {tuple(tiles.shape)} are not [n, L+3, {CHUNK}]")
    if not tiles.is_contiguous():
        raise ValueError(f"{name}: tiles must be contiguous")
    if tiles.data_ptr() % 16:
        raise ValueError(f"{name}: tiles at {tiles.data_ptr():#x} are not 16-byte "
                         f"aligned (the kernels read rows in 16-byte loads)")
    if tiles.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {tiles.shape[0]} tiles exceed the int32 index")
    for arg, t in named:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, tiles on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} dtype {t.dtype}, expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    ftok = fields[0]
    b = ftok.shape[0]
    if ftok.shape != (b, tiles.shape[1] - 3) or any(
            f.shape != (b,) for f in fields[1:]) or (
            chunk_ids is not None and (chunk_ids.dim() != 2 or chunk_ids.shape[0] != b)):
        raise ValueError(
            f"{name}: filter fields {[tuple(f.shape) for f in fields]}"
            + (f" / chunk_ids {tuple(chunk_ids.shape)}" if chunk_ids is not None else "")
            + f" do not fit tiles {tuple(tiles.shape)}")


def _out(out, shape, dev) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=dev)
    if out.shape != shape or out.dtype != torch.int32 or out.device != dev \
            or not out.is_contiguous():
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device} is not "
                         f"a contiguous int32 {shape} on {dev}")
    return out


def _cpu_result(words: torch.Tensor, out) -> torch.Tensor:
    if out is None:
        return words
    return _out(out, tuple(words.shape), words.device).copy_(words)


def retained_scan_gather(tiles, ftok, flen, fprefix, fhash, fwild, chunk_ids,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Narrow-tier words ``[B, NC*4]`` int32 (into ``out`` when given). CUDA
    tensors (int16/int32 tiles at a 16-byte aligned address, int32 fields,
    contiguous, one device) launch the kernel; CPU tensors run the plain
    twin."""
    if tiles.device.type == "cpu":
        return _cpu_result(retained_scan_words_plain(
            tiles, ftok, flen, fprefix, fhash, fwild, chunk_ids), out)
    if tiles.device.type != "cuda":
        raise ValueError(f"retained_scan_gather: unsupported device {tiles.device}")
    fields = (ftok, flen, fprefix, fhash, fwild)
    _check_cuda("retained_scan_gather", tiles, fields, chunk_ids)
    b, nc = chunk_ids.shape
    out = _out(out, (b, nc * WORDS_PER_CHUNK), tiles.device)
    if b == 0 or nc == 0:
        return out
    lib = kernel_library().lib
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        err = lib.launch_retained_scan_gather(
            tiles.data_ptr(), tiles.element_size(), tiles.shape[0],
            tiles.shape[1] - 3, *(f.data_ptr() for f in fields),
            chunk_ids.data_ptr(), b, nc, out.data_ptr(), stream)
    _raise_on(err, "retained_scan_gather")
    retained_scan_gather.launches += 1
    return out


retained_scan_gather.launches = 0


def retained_scan_full(tiles, ftok, flen, fprefix, fhash, fwild,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Broad-tier words ``[B, up_chunks*4]`` int32 (into ``out`` when
    given). CUDA tensors launch the kernel; CPU tensors run the plain
    twin."""
    if tiles.device.type == "cpu":
        return _cpu_result(retained_scan_full_plain(
            tiles, ftok, flen, fprefix, fhash, fwild), out)
    if tiles.device.type != "cuda":
        raise ValueError(f"retained_scan_full: unsupported device {tiles.device}")
    fields = (ftok, flen, fprefix, fhash, fwild)
    _check_cuda("retained_scan_full", tiles, fields)
    b, up_chunks = ftok.shape[0], tiles.shape[0]
    out = _out(out, (b, up_chunks * WORDS_PER_CHUNK), tiles.device)
    if b == 0 or up_chunks == 0:
        return out
    lib = kernel_library().lib
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        err = lib.launch_retained_scan_full(
            tiles.data_ptr(), tiles.element_size(), up_chunks, tiles.shape[1] - 3,
            *(f.data_ptr() for f in fields), b, out.data_ptr(), stream)
    _raise_on(err, "retained_scan_full")
    retained_scan_full.launches += 1
    return out


retained_scan_full.launches = 0


# ----------------------------------------------------------------- scanner
class RetainedState:
    """The scanner's resident state: the tiles on the device and the
    row→fid map of the table version they mirror."""

    __slots__ = ("rows", "fid_of_row", "version")

    def __init__(self, rows: torch.Tensor, fid_of_row: np.ndarray, version: int):
        self.rows = rows
        self.fid_of_row = fid_of_row
        self.version = version


def retained_state_from_numpy(packed_rows: np.ndarray, fid_of_row: np.ndarray,
                              version: int, device=None) -> RetainedState:
    """Install host arrays as a scanner's resident state: ``packed_rows`` as
    ``pack_device_rows`` returns them for a ``RetainedTable`` and the
    table's row→fid map (``fid_snapshot()``) — from this package or from
    the JAX package, whose arrays are identical. ``version`` names the
    table state they mirror."""
    dev = resolve_device(device)
    rows = np.asarray(packed_rows)
    if rows.ndim != 3 or rows.shape[2] != CHUNK or rows.dtype not in (np.int16, np.int32):
        raise ValueError(f"retained rows {rows.shape} {rows.dtype} are not "
                         f"[n, L+3, {CHUNK}] int16/int32")
    fids = np.array(fid_of_row, dtype=np.int64)  # owned: never written to
    return RetainedState(to_device(rows, dev), fids, int(version))


class PartitionedRetainedScanner:
    """Device mirror of a ``RetainedTable`` + batched inverse match.

    ``scan`` returns per-filter arrays of matched *fids* (the stable
    handles ``RetainedTable.add`` returned). ``scan_submit`` /
    ``scan_complete`` are the pipelined halves. The device defaults to the
    current CUDA device; with none given and no CUDA device the scanner
    raises, and on CUDA it builds the kernels at construction, so a kernel
    that does not build refuses it. ``use_kernel = False`` runs the plain
    twins on the same device (the reference run of ``chip_smoke.py``).
    """

    #: filters whose candidate set exceeds this fraction of all chunks are
    #: routed to the broad tier (their NC pad would poison the narrow one)
    BROAD_FRAC = 0.25

    def __init__(self, table: RetainedTable, device=None) -> None:
        self.table = table
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            kernel_library()
        self._dev: Optional[RetainedState] = None
        self.use_kernel = True
        self.scans = 0  # dispatched (non-empty) scans
        self.uploads = 0
        self.upload_bytes = 0

    def install(self, state: RetainedState) -> None:
        """Make ``state`` the resident mirror (``retained_state_from_numpy``);
        it serves scans while the table's version equals ``state.version``."""
        if state.rows.device != self.device:
            raise ValueError(f"state on {state.rows.device}, scanner on {self.device}")
        self._dev = state

    def _refresh(self) -> RetainedState:
        t = self.table
        st = self._dev
        if st is None or st.version != t.version:
            if t.needs_compact():  # honors compact_min_ops/compact_ratio
                t.compact()
            # sync the narrow-dtype flags BEFORE packing: pack_device_rows
            # reads _tok_wide directly, and the flag only flips inside
            # _tok_dtype() — packing first would ship int16-wrapped tokens
            # against the int32 filter encode of the same scan
            t._tok_dtype()
            t._cand_dtype()
            rows = pack_device_rows(t)
            st = self._dev = RetainedState(to_device(rows, self.device),
                                           t.fid_snapshot(), t.version)
            self.uploads += 1
            self.upload_bytes += rows.nbytes
        return st

    def _encode_part(self, filters: List[Tuple[int, List[str], np.ndarray]],
                     nc: int):
        """One tier → (ftok, flen, fprefix, fhash, fwild, chunk_ids): a row
        per filter, each candidate list padded with chunk 0 to ``nc``."""
        t = self.table
        lvl = t.max_levels
        b = len(filters)
        ftok = np.zeros((b, lvl), dtype=t._tok_dtype())
        flen = np.full((b,), -2, dtype=np.int16)
        fprefix = np.full((b,), lvl + 1, dtype=np.int16)
        fhash = np.zeros((b,), dtype=bool)
        fwild = np.zeros((b,), dtype=bool)
        chunk_ids = np.zeros((b, nc), dtype=t._cand_dtype())
        lookup = t.tokens.lookup
        for j, (_orig, levels, cand) in enumerate(filters):
            hh = levels[-1] == HASH
            # clamp like the forward encode: rows have rlen <= lvl, so
            # comparisons are invariant at lvl+1 and hostile depths can't
            # wrap int16
            flen[j] = min(len(levels), lvl + 1)
            fprefix[j] = min(len(levels) - 1 if hh else len(levels), lvl + 1)
            fhash[j] = hh
            fwild[j] = levels[0] in (PLUS, HASH)
            for i, lev in enumerate(levels[:lvl]):
                ftok[j, i] = PLUS_TOK if lev == PLUS else (
                    PAD_TOK if lev == HASH else lookup(lev))
            chunk_ids[j, : len(cand)] = cand[:nc]
        return ftok, flen, fprefix, fhash, fwild, chunk_ids

    def plan(self, filters: Sequence[str]):
        """Refresh the mirror and encode a batch → (resident state, tiers,
        order). Each tier is ``(mode, encoded arrays, nc)``: ``"gather"``
        with (ftok, flen, fprefix, fhash, fwild, chunk_ids) and its NC,
        ``"full"`` with the first five and ``up_chunks``. ``order[k]`` lists,
        per filter row of tier k, the batch positions it answers (identical
        filters in a batch are scanned once)."""
        t = self.table
        st = self._refresh()
        up_chunks = st.rows.shape[0]
        slots: Dict[str, int] = {}
        dups: List[List[int]] = []
        enc: List[Tuple[int, List[str], np.ndarray]] = []
        for j, f in enumerate(filters):
            fstr = f if isinstance(f, str) else "/".join(f)
            s = slots.get(fstr)
            if s is None:
                slots[fstr] = len(enc)
                dups.append([j])
                enc.append((len(enc), split_levels(fstr),
                            t.candidates_for_filter(fstr)))
            else:
                dups[s].append(j)
        broad_floor = max(16, int(t.nchunks * self.BROAD_FRAC))
        narrow = [e for e in enc if len(e[2]) <= broad_floor]
        broad = [e for e in enc if len(e[2]) > broad_floor]
        tiers: List[Tuple[str, tuple, int]] = []
        order: List[List[List[int]]] = []
        # each tier sized from the batch itself (the kernels take any B and
        # NC): B = its distinct filters, NC = its longest candidate list
        if narrow:
            nc = max(1, max(len(e[2]) for e in narrow))
            tiers.append(("gather", self._encode_part(narrow, nc), nc))
            order.append([dups[e[0]] for e in narrow])
        if broad:
            # broad filters stream the whole table: no chunk-id plan at all
            tiers.append(("full", self._encode_part(broad, 1)[:5], up_chunks))
            order.append([dups[e[0]] for e in broad])
        return st, tiers, order

    def scan_submit(self, filters: Sequence[str]):
        st, tiers, order = self.plan(filters)
        if not tiers:
            return ("empty", len(filters))
        # one upload of every tier's encoded fields, widened to int32
        host = np.concatenate([a.astype(np.int32, copy=False).ravel()
                               for _mode, arrs, _nc in tiers for a in arrs])
        dev_in = to_device(host, self.device)
        spans = [arrs[0].shape[0] * nc * WORDS_PER_CHUNK for _m, arrs, nc in tiers]
        out = torch.empty(sum(spans), dtype=torch.int32, device=self.device)
        off_in = off_out = 0
        metas = []
        for (mode, arrs, nc), span in zip(tiers, spans):
            views = []
            for a in arrs:
                views.append(dev_in[off_in:off_in + a.size].view(a.shape))
                off_in += a.size
            b = arrs[0].shape[0]
            o = out[off_out:off_out + span].view(b, nc * WORDS_PER_CHUNK)
            off_out += span
            if mode == "gather":
                if self.use_kernel:
                    retained_scan_gather(st.rows, *views, out=o)
                else:
                    o.copy_(retained_scan_words_plain(st.rows, *views))
                metas.append((mode, b, nc, arrs[5]))
            else:
                if self.use_kernel:
                    retained_scan_full(st.rows, *views, out=o)
                else:
                    o.copy_(retained_scan_full_plain(st.rows, *views))
                metas.append((mode, b, nc, None))
        self.scans += 1
        # the row→fid map of the version these rows mirror: remove()
        # mutates the table's map in place and compact() swaps it, so a
        # handle completing after a mutation must not decode through it
        return ("h", out, metas, order, len(filters), st.fid_of_row)

    def scan_complete(self, handle) -> List[np.ndarray]:
        if handle[0] == "empty":
            return [np.empty(0, dtype=np.int64) for _ in range(handle[1])]
        _, out, metas, order, nfilters, fid_of_row = handle
        flat = fetch(out, "retained partitioned scan fetch")
        res: List[Optional[np.ndarray]] = [None] * nfilters
        off = 0
        for (mode, b, nc, chunk_ids), idxs in zip(metas, order):
            span = b * nc * WORDS_PER_CHUNK
            words = flat[off: off + span].reshape(b, nc * WORDS_PER_CHUNK)
            off += span
            for j, origs in enumerate(idxs):
                wj = words[j]
                if not wj.any():
                    fids = np.empty(0, dtype=np.int64)
                else:
                    bits = np.unpackbits(
                        np.ascontiguousarray(wj).view(np.uint8),
                        bitorder="little")
                    pos = np.nonzero(bits)[0]
                    if mode == "gather":
                        rows = (chunk_ids[j, pos // (WORDS_PER_CHUNK * 32)]
                                .astype(np.int64) * CHUNK
                                + pos % (WORDS_PER_CHUNK * 32))
                    else:  # full stream: bit position IS the global row
                        rows = pos
                    fids = fid_of_row[rows]
                    fids = np.sort(fids[fids >= 0])
                for orig in origs:  # duplicates share the result array
                    res[orig] = fids
        return res  # type: ignore[return-value]

    def scan(self, filters: Sequence[str]) -> List[np.ndarray]:
        """→ per-filter arrays of matched retained-topic fids."""
        return self.scan_complete(self.scan_submit(filters))
