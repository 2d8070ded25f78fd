"""Inputs that hold the match-words kernels against their plain twins.

Random tiles whose bytes fall in small ranges so that rows do match, topics
with padded (``tlen = -2``) and ``$`` entries, and candidate lists with the
shapes the kernels treat apart: chunk 0 (the table's empty chunk, which
pads every list) at the front, in the middle and repeated; a nonzero id
repeated in one row; ids out of range; NC above 32; tiny batches; every
group count of the packed kernel's instances and every legacy level range.
``chip_smoke.py`` phase 3 and ``tests/test_torch_cuda.py`` run the same
:data:`EDGE_CASES`. Everything is made with numpy from a seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from rmqtt_tpu_torch.ops.encode import PackedLayout, group_byte_planes
from rmqtt_tpu_torch.ops.match_words import CHUNK


def random_packed_tiles(rng: np.random.Generator, layout: PackedLayout,
                        n: int) -> np.ndarray:
    """``[n, groups*CHUNK]`` int32 packed tiles: level bytes 0..7 (1 = '+'),
    2-byte levels with high bytes 0..1, meta = flen+1 in 0..7 |
    has_hash<<5 | first_wild<<6. Chunk 0 is random too: a kernel must
    agree with its twin on any tile."""
    planes = np.zeros((n * CHUNK, layout.planes), dtype=np.uint8)
    p = 0
    for w in layout.widths:
        planes[:, p] = rng.integers(0, 8, len(planes))
        p += 1
        if w == 2:
            planes[:, p] = rng.integers(0, 2, len(planes))
            p += 1
    planes[:, p] = (rng.integers(0, 8, len(planes))
                    | (rng.integers(0, 2, len(planes)) << 5)
                    | (rng.integers(0, 2, len(planes)) << 6))
    lanes = group_byte_planes(planes, layout.groups)
    return np.ascontiguousarray(
        lanes.reshape(n, CHUNK, layout.groups).transpose(0, 2, 1)
        .reshape(n, layout.groups * CHUNK))


def random_legacy_tiles(rng: np.random.Generator, lvl: int, n: int,
                        dtype) -> np.ndarray:
    """``[n, lvl+3, CHUNK]`` field-major tiles: tokens 0..7, flen in
    -1..lvl, prefix_len = flen - has_hash (at least 0), random flags."""
    tiles = np.zeros((n, lvl + 3, CHUNK), dtype=dtype)
    tiles[:, :lvl] = rng.integers(0, 8, (n, lvl, CHUNK))
    flen = rng.integers(-1, lvl + 1, (n, CHUNK))
    hh = rng.integers(0, 2, (n, CHUNK))
    tiles[:, lvl] = flen
    tiles[:, lvl + 1] = np.maximum(flen - hh, 0)
    tiles[:, lvl + 2] = hh | (rng.integers(0, 2, (n, CHUNK)) << 1)
    return tiles


def random_topics(rng: np.random.Generator, b: int, nlvl: int,
                  hi_tok: int = 8):
    """→ (ttok [b, nlvl], tlen [b], tdollar [b]) int32; ~10% padded topics
    (tlen -2), ~30% ``$`` topics."""
    tlen = rng.integers(1, nlvl + 2, b)
    tlen[rng.random(b) < 0.1] = -2
    return (rng.integers(0, hi_tok, (b, nlvl)).astype(np.int32),
            tlen.astype(np.int32), (rng.random(b) < 0.3).astype(np.int32))


def edge_chunk_ids(rng: np.random.Generator, b: int, nc: int,
                   nchunks: int) -> np.ndarray:
    """``[b, nc]`` int32 candidate ids, row ``r`` by ``r % 4``: 0 — chunk 0
    first, in the middle and at a few more places, and a nonzero id
    repeated; 1 — chunk 0 only in the middle and last; 2 — one nonzero id
    in a third of the slots, no chunk 0; 3 — front-packed real ids padded
    with chunk 0, as the encoder writes them."""
    cids = rng.integers(1, nchunks, (b, nc))
    for r in range(b):
        row = cids[r]
        kind = r % 4
        if kind == 0:
            row[rng.integers(0, nc, max(1, nc // 4))] = row[-1]
            row[rng.integers(1, nc, 3)] = 0
            row[0] = 0
            row[nc // 2] = 0
        elif kind == 1:
            row[nc // 2] = 0
            row[-1] = 0
        elif kind == 2:
            row[rng.integers(0, nc, max(1, nc // 3))] = row[0]
        else:
            row[rng.integers(0, nc + 1):] = 0
    return cids.astype(np.int32)


def with_bad_ids(rng: np.random.Generator, cids: np.ndarray, nchunks: int):
    """Put ids outside ``[0, nchunks)`` into about a quarter of the slots.
    → (ids, mask of the bad slots, the same ids with the bad ones set to 0
    for the plain twin, which indexes the tiles)."""
    bad = rng.random(cids.shape) < 0.25
    vals = rng.choice(np.array([-1, -7, nchunks, nchunks + 5, 1 << 30]),
                      cids.shape)
    ids = np.where(bad, vals, cids).astype(np.int32)
    return ids, bad, np.where(bad, 0, ids).astype(np.int32)


class Case(NamedTuple):
    name: str
    fmt: str  # "packed", "int16" or "int32"
    shape: Tuple[int, ...]  # packed: level widths; legacy: (L,)
    b: int
    nc: int
    ids: str  # "edge", "random" or "bad"
    wide_tokens: bool = False  # some topic tokens beyond their level's width


_W6 = (1, 1, 1, 1, 1, 2)

#: packed cases reach each group-count instance (1, 2, 4, 8, 16); legacy
#: ones each level range (L <= 8, <= 16, any)
EDGE_CASES = (
    Case("packed 2 groups B=3 NC=33", "packed", _W6, 3, 33, "edge"),
    Case("packed 2 groups B=1 NC=64", "packed", _W6, 1, 64, "edge"),
    Case("packed 2 groups B=2048 NC=32", "packed", _W6, 2048, 32, "edge"),
    Case("packed 1 group B=5 NC=64", "packed", (1,), 5, 64, "edge"),
    Case("packed 3 groups B=257 NC=40", "packed", (1, 2, 1, 1, 1, 1, 1, 1), 257,
         40, "edge"),
    Case("packed 7 groups B=64 NC=33", "packed",
         (2, 1, 1, 1, 2, 1, 1, 1, 1, 2, 1, 1, 1, 1, 2, 1, 1, 1, 1, 2), 64, 33,
         "edge"),
    Case("packed 30 levels 10 wide, 11 groups B=33 NC=12", "packed",
         (1, 2, 1, 1, 2) * 4 + (2, 1, 1, 1, 1) * 2, 33, 12, "edge"),
    Case("packed 30 levels all wide, 16 groups B=130 NC=64", "packed",
         (2,) * 30, 130, 64, "edge"),
    Case("packed out-of-range ids B=100 NC=16", "packed", _W6, 100, 16, "bad"),
    Case("packed tokens beyond their level's width B=64 NC=8", "packed",
         (2, 1, 1, 2, 1), 64, 8, "edge", wide_tokens=True),
    Case("legacy int16 L=8 B=3 NC=33", "int16", (8,), 3, 33, "edge"),
    Case("legacy int32 L=8 B=1 NC=64", "int32", (8,), 1, 64, "edge"),
    Case("legacy int16 L=12 B=257 NC=40", "int16", (12,), 257, 40, "edge"),
    Case("legacy int32 L=16 B=64 NC=33", "int32", (16,), 64, 33, "edge"),
    Case("legacy int16 L=40 B=33 NC=64", "int16", (40,), 33, 64, "edge"),
    Case("legacy int32 L=20 B=9 NC=5", "int32", (20,), 9, 5, "random"),
    Case("legacy int16 out-of-range ids B=100 NC=16", "int16", (8,), 100, 16,
         "bad"),
    Case("legacy int32 out-of-range ids B=40 NC=40", "int32", (8,), 40, 40,
         "bad"),
)


def make_case(case: Case, seed: int = 0, nchunks: int = 64):
    """→ (tiles, ttok, tlen, tdollar, ids, layout or None, bad mask or None,
    ids for the plain twin), all numpy."""
    rng = np.random.default_rng(seed)
    if case.fmt == "packed":
        layout: Optional[PackedLayout] = PackedLayout(case.shape)
        tiles = random_packed_tiles(rng, layout, nchunks)
        nlvl = layout.nlvl
    else:
        layout = None
        nlvl = case.shape[0]
        tiles = random_legacy_tiles(rng, nlvl, nchunks,
                                    np.int16 if case.fmt == "int16" else np.int32)
    ttok, tlen, tdollar = random_topics(rng, case.b, nlvl)
    if case.wide_tokens:
        # a 1-byte level never holds 257 (whose low byte is '+'), a 2-byte
        # one never 65536 + 1 or a negative id
        far = rng.random(ttok.shape) < 0.3
        ttok = np.where(far, rng.choice(np.array([256, 257, 300, 65537, -1]),
                                        ttok.shape), ttok).astype(np.int32)
    if case.ids == "random":
        ids = rng.integers(0, nchunks, (case.b, case.nc)).astype(np.int32)
    else:
        ids = edge_chunk_ids(rng, case.b, case.nc, nchunks)
    bad, plain_ids = None, ids
    if case.ids == "bad":
        ids, bad, plain_ids = with_bad_ids(rng, ids, nchunks)
    return tiles, ttok, tlen, tdollar, ids, layout, bad, plain_ids
