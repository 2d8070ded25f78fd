"""Host-side token encoding: topic levels → int tokens, filters → table rows.

A numpy copy of the JAX package's ``ops/encode.py`` (the port imports
nothing of that package). The
level-token encoding replaces the reference's per-node string keys
(`rmqtt/src/trie.rs:84-87`, branches keyed by ``Level``):

- every distinct level string used by any *filter* is interned to an int id;
- reserved ids: ``PAD_TOK`` (0, beyond a filter/topic's length), ``PLUS_TOK``
  (1, the ``+`` wildcard), ``HASH_TOK`` (2, the ``#`` wildcard), ``UNK_TOK``
  (3, a publish-topic level never seen in any filter — it can only be matched
  by wildcards);
- a publish topic is encoded with dictionary *lookup* (unknown → ``UNK_TOK``),
  so the kernel never needs strings.

``FilterTable`` is the dense backend's flattened automaton: a
fixed-capacity, padded ``[capacity, max_levels]`` int32 token matrix plus
per-row metadata (level count, prefix length before ``#``, has-``#``,
wildcard-first, ``$``-first), rows allocated and freed as subscriptions
churn (`rmqtt/src/router.rs:434-496` add/remove).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from rmqtt_tpu_torch.core.topic import HASH, PLUS, is_metadata, split_levels

PAD_TOK = 0
PLUS_TOK = 1
HASH_TOK = 2
UNK_TOK = 3
_FIRST_TOK = 4

_MIN_CAPACITY = 1024

# ---------------------------------------------------------------- bit-packed
# tile layout (the "packed8" automaton format). Tokens are re-keyed into
# PER-LEVEL local id spaces (reserved ids 0-3 shared with the global space),
# so one byte covers a level whose local vocabulary fits 252 tokens and two
# bytes cover up to 65532 — against the global int16/int32 id space the
# legacy tiles ship. Rows become a sequence of byte PLANES (one or two per
# level, plus one metadata byte packing flen+1 | has_hash<<5 | first_wild<<6;
# prefix_len is derivable as flen - has_hash and is not stored). Byte planes
# are grouped four-per-int32-lane so the device array is int32 with a
# 128-wide minor dim — see ops/partitioned.py pack_device_rows_packed.

#: local ids 4..255 → 252 one-byte tokens per level; 65532 for two bytes
PACKED_W1_MAX = 252
PACKED_W2_MAX = 65532
#: metadata byte stores flen+1 in 5 bits → filters at most 30 levels deep
PACKED_MAX_LEVELS = 30


class PackedLayout(NamedTuple):
    """Static descriptor of one packed-tile layout. ``widths[i]`` is level
    i's byte width; the level planes are laid out in order followed by the
    metadata plane, then padded to a multiple of four planes for the int32
    lane grouping."""

    widths: Tuple[int, ...]

    @property
    def nlvl(self) -> int:
        return len(self.widths)

    @property
    def planes(self) -> int:
        return sum(self.widths) + 1  # + metadata plane

    @property
    def groups(self) -> int:
        return (self.planes + 3) // 4

    def plane_offsets(self) -> List[int]:
        """Byte-plane index of each level's LOW byte (metadata plane sits at
        index ``planes - 1``)."""
        out: List[int] = []
        p = 0
        for w in self.widths:
            out.append(p)
            p += w
        return out


def group_byte_planes(planes: np.ndarray, groups: int) -> np.ndarray:
    """``[rows, planes] uint8`` → ``[rows, groups]`` int32 lanes, four byte
    planes per lane (little-endian: plane 4g in bits 0-7). The padding
    planes beyond ``planes.shape[1]`` are zero."""
    rows, p = planes.shape
    padded = np.zeros((rows, groups * 4), dtype=np.uint8)
    padded[:, :p] = planes
    b = padded.reshape(rows, groups, 4).astype(np.int32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


class DeltaLog:
    """Bounded journal of dirty unit ids (chunks) per table version.

    Mutations append ``(version, unit)`` entries; device mirrors call
    ``since(dev_version)`` to learn which units changed after the version
    they hold, and scatter-write only those units instead of re-uploading
    the whole table. The log is bounded: on overflow the oldest entries
    drop and the *floor* rises — a consumer older than the floor gets
    ``None`` and must full-upload. ``reset()`` empties the log after a
    wholesale layout change (compact, grow).
    """

    def __init__(self, max_entries: int = 65536) -> None:
        # ONE list of (version, unit) tuples, REPLACED (never trimmed in
        # place) on overflow: consumers snapshot the list reference once,
        # so a concurrent trim can never shift indices under their bisect
        self._e: List[Tuple[int, int]] = []
        self._max = max_entries
        self.floor = 0  # consumers at/above the floor may delta

    def mark(self, version: int, unit: int) -> None:
        self._e.append((version, unit))
        if len(self._e) > self._max:
            half = self._max // 2
            self.floor = self._e[half - 1][0]
            self._e = self._e[half:]

    def since(self, version: int) -> Optional[List[int]]:
        """Distinct units dirtied after ``version``; None = full upload."""
        # snapshot BEFORE the floor check: a trim racing these two reads
        # then either leaves us the untrimmed superset (fine) or a raised
        # floor that fails the check (full upload — safe), never a hole
        e = self._e
        if version < self.floor:
            return None
        # entries are version-ascending: walk back to the first one > version
        i = bisect.bisect_right(e, (version, 1 << 62))
        return sorted({u for _v, u in e[i:]})

    def reset(self, floor_version: int) -> None:
        self._e = []
        self.floor = floor_version


class TokenDict:
    """Interning dictionary: level string ↔ int token id."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._strs: List[str] = []

    def intern(self, level: str) -> int:
        tid = self._ids.get(level)
        if tid is None:
            tid = _FIRST_TOK + len(self._strs)
            self._ids[level] = tid
            self._strs.append(level)
        return tid

    def lookup(self, level: str) -> int:
        return self._ids.get(level, UNK_TOK)

    def __len__(self) -> int:
        return len(self._strs)


def _pow2_at_least(n: int, floor: int) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class FilterTable:
    """The flattened subscription automaton of the dense backend (host
    staging side), a copy of the JAX package's ``FilterTable``.

    Rows are filter slots; the router keys rows by filter id (``fid``). The
    table stores only the *topic-filter shape*; relations (fid → clients)
    stay host-side, mirroring the reference's split between the trie and
    ``AllRelationsMap`` (`rmqtt/src/router.rs:121-139`). Free rows have
    ``flen = -1`` and match nothing.
    """

    def __init__(self, capacity: int = _MIN_CAPACITY, max_levels: int = 8) -> None:
        self.capacity = _pow2_at_least(capacity, _MIN_CAPACITY)
        self.max_levels = max_levels
        self._alloc(self.capacity, self.max_levels)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self.tokens = TokenDict()
        self.size = 0
        # bumped on every mutation; device mirrors key their cache on it
        self.version = 0
        # dirty-row journal: device mirrors delta-upload only the rows a
        # mutation touched (DenseMatcher._refresh)
        self.delta = DeltaLog()

    def _alloc(self, cap: int, lvl: int) -> None:
        self.tok = np.zeros((cap, lvl), dtype=np.int32)
        self.flen = np.full((cap,), -1, dtype=np.int32)
        self.prefix_len = np.zeros((cap,), dtype=np.int32)
        self.has_hash = np.zeros((cap,), dtype=bool)
        self.first_wild = np.zeros((cap,), dtype=bool)
        # row's first level is a $-metadata level (used when rows are stored
        # *topic names*, i.e. the retained-scan direction)
        self.row_dollar = np.zeros((cap,), dtype=bool)

    def _grow(self, need_rows: int, need_levels: int) -> None:
        new_cap = _pow2_at_least(max(need_rows, self.capacity), _MIN_CAPACITY)
        new_lvl = max(need_levels, self.max_levels)
        if new_cap == self.capacity and new_lvl == self.max_levels:
            return
        old = (self.tok, self.flen, self.prefix_len, self.has_hash, self.first_wild,
               self.row_dollar)
        old_cap, old_lvl = self.capacity, self.max_levels
        self._alloc(new_cap, new_lvl)
        self.tok[:old_cap, :old_lvl] = old[0]
        self.flen[:old_cap] = old[1]
        self.prefix_len[:old_cap] = old[2]
        self.has_hash[:old_cap] = old[3]
        self.first_wild[:old_cap] = old[4]
        self.row_dollar[:old_cap] = old[5]
        if new_cap > old_cap:
            self._free = list(range(new_cap - 1, old_cap - 1, -1)) + self._free
        self.capacity, self.max_levels = new_cap, new_lvl
        # capacity/level growth changes the device array shapes: every
        # mirror full-uploads, so the journal can start over
        self.delta.reset(self.version)

    def add(self, topic_filter: str | Sequence[str]) -> int:
        """Insert a (validated) filter; returns its row id (fid)."""
        levels = (split_levels(topic_filter) if isinstance(topic_filter, str)
                  else list(topic_filter))
        nlev = len(levels)
        if not self._free or nlev > self.max_levels:
            self._grow(self.size + 1, nlev)
        fid = self._free.pop()
        hh = levels[-1] == HASH
        row = self.tok[fid]
        row[:] = PAD_TOK
        for i, lev in enumerate(levels):
            if lev == PLUS:
                row[i] = PLUS_TOK
            elif lev == HASH:
                row[i] = HASH_TOK
            else:
                row[i] = self.tokens.intern(lev)
        self.flen[fid] = nlev
        self.prefix_len[fid] = nlev - 1 if hh else nlev
        self.has_hash[fid] = hh
        self.first_wild[fid] = levels[0] in (PLUS, HASH)
        self.row_dollar[fid] = bool(levels[0]) and is_metadata(levels[0])
        self.size += 1
        self.version += 1
        self.delta.mark(self.version, fid)
        return fid

    def remove(self, fid: int) -> None:
        if self.flen[fid] < 0:
            raise KeyError(f"fid {fid} not active")
        self.tok[fid, :] = PAD_TOK
        self.flen[fid] = -1
        self.prefix_len[fid] = 0
        self.has_hash[fid] = False
        self.first_wild[fid] = False
        self.row_dollar[fid] = False
        self._free.append(fid)
        self.size -= 1
        self.version += 1
        self.delta.mark(self.version, fid)

    def force_full_refresh(self) -> None:
        """Invalidate every device mirror's delta state: the next refresh
        re-uploads the WHOLE table (device-plane failover rewarm,
        broker/failover.py). Bumping the version re-arms the refresh;
        raising the journal floor past it makes ``since()`` return None."""
        self.version += 1
        self.delta.reset(self.version)

    def encode_topics(
        self, topics: Sequence[str | Sequence[str]], pad_batch_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode publish topics → (ttok [B, L], tlen [B], tdollar [B]).

        Topics deeper than ``max_levels`` are truncated in the token matrix
        but keep their true length — only ``#``-filters (whose prefix fits in
        ``max_levels`` by construction) can match them, and those compare
        prefix levels only. Padded topics get ``tlen = -2``: no length rule
        passes then (a ``#`` filter with prefix 0 would match ``tlen = 0``).
        """
        batch = len(topics)
        b = pad_batch_to or batch
        lvl = self.max_levels
        ttok = np.zeros((b, lvl), dtype=np.int32)
        tlen = np.zeros((b,), dtype=np.int32)
        tdollar = np.zeros((b,), dtype=bool)
        lookup = self.tokens.lookup
        for j, topic in enumerate(topics):
            levels = split_levels(topic) if isinstance(topic, str) else list(topic)
            tlen[j] = len(levels)
            tdollar[j] = bool(levels[0]) and is_metadata(levels[0])
            for i, lev in enumerate(levels[:lvl]):
                ttok[j, i] = lookup(lev)
        if b > batch:
            tlen[batch:] = -2
        return ttok, tlen, tdollar

    def encode_filters(
        self, filters: Sequence[str | Sequence[str]], pad_batch_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Encode wildcard *filters* as a batch (the retained-scan direction)
        → ``(ftok [B, L], flen [B], fprefix [B], fhash [B], fwild [B])``.
        Levels unknown to the dictionary map to ``UNK_TOK``. Padded filters
        get ``flen = -2`` and ``fprefix = L + 1``, so they match no row."""
        batch = len(filters)
        b = pad_batch_to or batch
        lvl = self.max_levels
        ftok = np.zeros((b, lvl), dtype=np.int32)
        flen = np.full((b,), -2, dtype=np.int32)
        fprefix = np.full((b,), lvl + 1, dtype=np.int32)
        fhash = np.zeros((b,), dtype=bool)
        fwild = np.zeros((b,), dtype=bool)
        lookup = self.tokens.lookup
        for j, f in enumerate(filters):
            levels = split_levels(f) if isinstance(f, str) else list(f)
            hh = levels[-1] == HASH
            flen[j] = len(levels)
            fprefix[j] = len(levels) - 1 if hh else len(levels)
            fhash[j] = hh
            fwild[j] = levels[0] in (PLUS, HASH)
            for i, lev in enumerate(levels[:lvl]):
                if lev == PLUS:
                    ftok[j, i] = PLUS_TOK
                elif lev == HASH:
                    ftok[j, i] = HASH_TOK
                else:
                    ftok[j, i] = lookup(lev)
        return ftok, flen, fprefix, fhash, fwild
