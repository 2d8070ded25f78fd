"""Host-side token encoding: topic levels → int tokens, filters → table rows.

A numpy copy of the JAX package's ``ops/encode.py`` pieces that the
partitioned table needs (the port imports nothing of that package). The
level-token encoding replaces the reference's per-node string keys
(`rmqtt/src/trie.rs:84-87`, branches keyed by ``Level``):

- every distinct level string used by any *filter* is interned to an int id;
- reserved ids: ``PAD_TOK`` (0, beyond a filter/topic's length), ``PLUS_TOK``
  (1, the ``+`` wildcard), ``HASH_TOK`` (2, the ``#`` wildcard), ``UNK_TOK``
  (3, a publish-topic level never seen in any filter — it can only be matched
  by wildcards);
- a publish topic is encoded with dictionary *lookup* (unknown → ``UNK_TOK``),
  so the kernel never needs strings.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

PAD_TOK = 0
PLUS_TOK = 1
HASH_TOK = 2
UNK_TOK = 3
_FIRST_TOK = 4

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
