"""Inputs that hold the retained-scan kernels against their plain twins.

Random field-major tiles whose tokens fall in a small range so that rows
do match, with empty rows (``rlen`` 0 and -1) and ``$`` rows; random
encoded filters with ``+`` levels, trailing ``#``, wildcard-first and
padding entries (``flen`` -2, as the encoder pads a tier); candidate lists
with chunk 0 as padding and repeated ids (``words_cases.edge_chunk_ids``),
ids out of range, NC of 1 and 33, B of 1 and 3, int32 tiles and every
level range of the kernels' instances (L <= 8, <= 16, any); then one
filter's list of hundreds of slots, NC that is no multiple of 8, lists of
padding only, a table of an odd tile count, literal levels past level 1,
filter tokens, lengths and prefixes outside int16 against int16 tiles, and
more filters than one shared-memory group holds. Beside them,
tables built from real topics (:func:`table_inputs`): ``$SYS`` rows
against wildcard-first filters, a bare ``#``, ``+/#``, filters deeper than
the table's ``max_levels``, and a vocabulary past 0x7FFF (int32 tiles).
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run the same
:data:`RETAINED_CASES`. Everything is made with numpy from a seed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from rmqtt_tpu_torch.bench.words_cases import edge_chunk_ids, with_bad_ids
from rmqtt_tpu_torch.core.topic import split_levels
from rmqtt_tpu_torch.ops.encode import _FIRST_TOK, PLUS_TOK
from rmqtt_tpu_torch.ops.match_words import CHUNK


def random_retained_tiles(rng: np.random.Generator, lvl: int, n: int,
                          dtype) -> np.ndarray:
    """``[n, lvl+3, CHUNK]`` tiles of retained rows: tokens 4..6, rlen in
    -1..lvl (rows of 0 and -1 are empty), prefix_len = rlen, flags bit 1
    (``$``) in a fifth of the rows. Chunk 0 is random too: a kernel must
    agree with its twin on any tile."""
    tiles = np.zeros((n, lvl + 3, CHUNK), dtype=dtype)
    tiles[:, :lvl] = rng.integers(_FIRST_TOK, _FIRST_TOK + 3, (n, lvl, CHUNK))
    rlen = rng.integers(-1, lvl + 1, (n, CHUNK))
    tiles[:, lvl] = rlen
    tiles[:, lvl + 1] = rlen
    tiles[:, lvl + 2] = (rng.random((n, CHUNK)) < 0.2).astype(dtype) << 1
    return tiles


def random_filters(rng: np.random.Generator, b: int, lvl: int, max_depth: int = 0,
                   hash_p: float = 0.4, pad_p: float = 0.1):
    """→ (ftok [b, lvl], flen, fprefix, fhash, fwild) int32: filters of 1 to
    ``max_depth`` (default lvl+1) levels over the tiles' tokens, half of the
    levels ``+``, a share ``hash_p`` with a trailing ``#`` (a bare ``#``
    among them), a share ``pad_p`` padding entries (flen -2, fprefix
    lvl+1)."""
    depth = rng.integers(1, (max_depth or lvl + 1) + 1, b)
    fhash = rng.random(b) < hash_p
    fprefix = np.where(fhash, depth - 1, depth)
    ftok = rng.integers(_FIRST_TOK, _FIRST_TOK + 3, (b, lvl))
    ftok[rng.random((b, lvl)) < 0.5] = PLUS_TOK
    ftok[np.arange(lvl)[None, :] >= fprefix[:, None]] = 0  # PAD_TOK past the prefix
    fwild = (ftok[:, 0] == PLUS_TOK) | (fhash & (fprefix == 0))
    flen = np.minimum(depth, lvl + 1)
    pad = rng.random(b) < pad_p
    flen = np.where(pad, -2, flen)
    fprefix = np.where(pad, lvl + 1, np.minimum(fprefix, lvl + 1))
    fhash = fhash & ~pad
    fwild = fwild & ~pad
    return tuple(a.astype(np.int32) for a in (ftok, flen, fprefix, fhash, fwild))


def short_filters(rng: np.random.Generator, b: int, lvl: int):
    """Filters of 1 to 3 levels, 70% with a trailing ``#``, no padding
    entries: each matches many rows of random tiles."""
    return random_filters(rng, b, lvl, max_depth=3, hash_p=0.7, pad_p=0.0)


def deep_filters(rng: np.random.Generator, b: int, lvl: int):
    """Filters of 4 to lvl+1 levels whose levels 0 and 1 are ``+`` and
    level 2 a literal (half of the deeper levels too), so that a test
    reads token rows past level 1; half end in ``#``."""
    depth = rng.integers(4, lvl + 2, b)
    fhash = rng.random(b) < 0.5
    fprefix = np.where(fhash, depth - 1, depth)
    ftok = rng.integers(_FIRST_TOK, _FIRST_TOK + 3, (b, lvl))
    ftok[rng.random((b, lvl)) < 0.5] = PLUS_TOK
    ftok[:, :2] = PLUS_TOK
    ftok[:, 2] = rng.integers(_FIRST_TOK, _FIRST_TOK + 3, b)
    ftok[np.arange(lvl)[None, :] >= fprefix[:, None]] = 0
    fwild = np.ones(b, dtype=bool)
    flen = np.minimum(depth, lvl + 1)
    return tuple(a.astype(np.int32) for a in (ftok, flen, np.minimum(fprefix, lvl + 1),
                                              fhash, fwild))


def wide_filters(rng: np.random.Generator, b: int, lvl: int):
    """Filters of 1 to 3 levels with values past int16 in three of every
    four: a level-0 token, ``flen`` (no ``#``) or ``fprefix`` (``#``) that
    truncate to 16 bits to a value the tiles hold. They match no row of
    int16 tiles; a kernel that truncated them would match some."""
    ftok, flen, fprefix, fhash, fwild = (
        a.copy() for a in random_filters(rng, b, lvl, max_depth=3, hash_p=0.5))
    for j in range(b):
        kind = j % 4
        if kind == 0:  # 0x10004..0x10006 truncate to a tile token
            ftok[j, 0] = 0x10000 + int(rng.integers(_FIRST_TOK, _FIRST_TOK + 3))
            fprefix[j] = max(fprefix[j], 1)
            fwild[j] = False
        elif kind == 1 and not fhash[j] and flen[j] > 0:
            flen[j] += 0x10000 if j % 8 == 1 else -0x10000
        elif kind == 2:
            fhash[j] = True
            fprefix[j] = 0x10000 + int(rng.integers(1, lvl + 1))
    return ftok, flen, fprefix, fhash, fwild


class RetainedCase(NamedTuple):
    name: str
    tier: str  # "gather" or "full"
    dtype: str  # "int16" or "int32"
    lvl: int
    b: int
    nc: int = 0  # gather only
    # gather: "edge", "random", "bad", "packed" (real ids, then chunk 0, as
    # the encoder writes them) or "padding" (chunk 0 only)
    ids: str = "edge"
    nchunks: int = 64
    filters: str = "random"  # "random", "short", "deep" or "wide"


#: random tiles; each kernel at every level range of its instances
RETAINED_CASES = (
    RetainedCase("gather int16 L=8 B=1 NC=33", "gather", "int16", 8, 1, 33),
    RetainedCase("gather int16 L=8 B=3 NC=1", "gather", "int16", 8, 3, 1, "random"),
    RetainedCase("gather int32 L=8 B=64 NC=33", "gather", "int32", 8, 64, 33),
    RetainedCase("gather int16 L=12 B=257 NC=40", "gather", "int16", 12, 257, 40),
    RetainedCase("gather int32 L=20 B=9 NC=5", "gather", "int32", 20, 9, 5, "random"),
    RetainedCase("gather int16 out-of-range ids B=40 NC=16", "gather", "int16", 8,
                 40, 16, "bad"),
    RetainedCase("full int16 L=8 B=1", "full", "int16", 8, 1),
    RetainedCase("full int16 L=8 B=3", "full", "int16", 8, 3),
    RetainedCase("full int32 L=8 B=16", "full", "int32", 8, 16),
    RetainedCase("full int16 L=12 B=33", "full", "int16", 12, 33),
    RetainedCase("full int32 L=20 B=5", "full", "int32", 20, 5),
    RetainedCase("full int16 L=8 B=64, 1,000 tiles", "full", "int16", 8, 64,
                 nchunks=1000),
    # one filter's list spread over many warps; NC no multiple of 8 or 32
    RetainedCase("gather int16 L=8 B=1 NC=300", "gather", "int16", 8, 1, 300,
                 nchunks=512, filters="short"),
    RetainedCase("gather int16 L=8 B=1 NC=147 front-packed", "gather", "int16", 8, 1,
                 147, "packed", nchunks=512, filters="short"),
    RetainedCase("gather int32 L=8 B=1 NC=200", "gather", "int32", 8, 1, 200,
                 nchunks=256, filters="short"),
    RetainedCase("gather int16 L=8 B=7 NC=45 front-packed", "gather", "int16", 8, 7,
                 45, "packed"),
    RetainedCase("gather int32 L=12 B=5 NC=13", "gather", "int32", 12, 5, 13),
    RetainedCase("gather int16 L=8 B=6 NC=40 all padding", "gather", "int16", 8, 6,
                 40, "padding"),
    # a tile count that leaves the last tile pair half empty
    RetainedCase("full int16 L=8 B=5, 1,001 tiles", "full", "int16", 8, 5,
                 nchunks=1001),
    RetainedCase("full int16 L=12 B=2, 3 tiles", "full", "int16", 12, 2, nchunks=3),
    # literal levels past level 1: more than one token row loaded
    RetainedCase("full int16 L=8 B=6 literals past level 1", "full", "int16", 8, 6,
                 filters="deep"),
    RetainedCase("gather int16 L=8 B=6 NC=24 literals past level 1", "gather", "int16",
                 8, 6, 24, filters="deep"),
    # filter values outside int16 against int16 tiles
    RetainedCase("full int16 L=8 B=16 values past int16", "full", "int16", 8, 16,
                 filters="wide"),
    RetainedCase("gather int16 L=8 B=16 NC=24 values past int16", "gather", "int16", 8,
                 16, 24, filters="wide"),
    RetainedCase("full int16 L=20 B=8 values past int16", "full", "int16", 20, 8,
                 filters="wide"),
    RetainedCase("gather int16 L=20 B=8 NC=9 values past int16", "gather", "int16", 20,
                 8, 9, filters="wide"),
    # more filters than one shared-memory group of the full kernel holds
    RetainedCase("full int32 L=20 B=600 past one shared-memory group", "full", "int32",
                 20, 600, nchunks=16),
)


def make_retained_case(case: RetainedCase, seed: int = 0):
    """→ (tiles, (ftok, flen, fprefix, fhash, fwild), ids or None, bad mask
    or None, ids for the plain twin or None), all numpy."""
    rng = np.random.default_rng(seed)
    tiles = random_retained_tiles(rng, case.lvl, case.nchunks,
                                  np.int16 if case.dtype == "int16" else np.int32)
    fields = {"random": random_filters, "short": short_filters, "deep": deep_filters,
              "wide": wide_filters}[case.filters](rng, case.b, case.lvl)
    if case.tier == "full":
        return tiles, fields, None, None, None
    if case.ids == "random":
        ids = rng.integers(0, case.nchunks, (case.b, case.nc)).astype(np.int32)
    elif case.ids == "padding":
        ids = np.zeros((case.b, case.nc), dtype=np.int32)
    elif case.ids == "packed":
        ids = rng.integers(1, case.nchunks, (case.b, case.nc)).astype(np.int32)
        for r in range(case.b):
            ids[r, rng.integers(0, case.nc + 1):] = 0
    else:
        ids = edge_chunk_ids(rng, case.b, case.nc, case.nchunks)
    bad, plain_ids = None, ids
    if case.ids == "bad":
        ids, bad, plain_ids = with_bad_ids(rng, ids, case.nchunks)
    return tiles, fields, ids, bad, plain_ids


#: topics of the table case: $SYS rows beside ordinary ones, empty levels,
#: topics as deep as the table and deeper (the table grows its levels)
TABLE_TOPICS = (
    "$SYS/broker/load", "$SYS/broker/clients/connected", "$SYS/x", "$share",
    "a", "a/b", "a/b/c", "a/x/c", "x/b/c/d", "a//c", "/a", "a/", "",
    "a/b/c/d/e/f/g/h", "a/b/c/d/e/f/g/h/i/j",
)

#: filters of the table case: a bare '#', '+/#' and other wildcard-first
#: filters (which must not see $SYS rows), $SYS filters, filters deeper
#: than max_levels, and one that matches nothing
TABLE_FILTERS = (
    "#", "+/#", "+", "+/+", "+/b/#", "$SYS/#", "$SYS/+/load", "$SYS/broker/#",
    "a/#", "a/+/c", "+/+/c/#", "a/b/c/d/e/f/g/h/#", "a/b/c/d/e/f/g/h/i/j/k/l",
    "a/+/c/d/e/f/g/+/i/j", "a/b/c/d/e/f/g/h/i/j/#", "/#", "a/", "none/such",
)


def table_topics(kind: str, rng: np.random.Generator) -> List[str]:
    """``"dollar"``: :data:`TABLE_TOPICS` plus 600 random ``a``..``d``
    topics; ``"wide"``: past 0x7FFF distinct level tokens (int32 tiles)."""
    if kind == "wide":
        n = 0x7FFF - _FIRST_TOK + 40
        return [f"w{i}/x" for i in range(n)] + list(TABLE_TOPICS)
    out = list(TABLE_TOPICS)
    for _ in range(600):
        depth = int(rng.integers(1, 7))
        out.append("/".join("abcd"[int(rng.integers(0, 4))] for _ in range(depth)))
    return list(dict.fromkeys(out))


def table_inputs(scanner, filters: Sequence[str], nc: Optional[int] = None):
    """Both tiers' inputs for every filter of ``filters`` on a scanner's
    table (the scanner's own encode): → (tiles numpy, gather arrays
    (ftok, flen, fprefix, fhash, fwild, chunk_ids), full arrays (the first
    five)). Each filter's candidate chunks fill its gather row, padded
    with chunk 0 to ``nc`` (default: the longest list)."""
    t = scanner.table
    st = scanner._refresh()
    enc = [(j, split_levels(f), t.candidates_for_filter(f))
           for j, f in enumerate(filters)]
    nc = nc or max(1, max(len(e[2]) for e in enc))
    gather = scanner._encode_part(enc, nc)
    full = scanner._encode_part(enc, 1)[:5]
    return (st.rows.cpu().numpy(),
            tuple(a.astype(np.int32) for a in gather),
            tuple(a.astype(np.int32) for a in full))
