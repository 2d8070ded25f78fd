"""Inputs that hold the dense full-scan kernels against their plain twins.

Each case is a ``FilterTable`` of filters (forward) and one of topic names
(inverse, the retained scan) drawn from a small vocabulary so that rows do
match, with the shapes the kernels treat apart: a batch of 1 and of 3, a
capacity of 1,024 rows, more topics than one block's 128, levels past the
register tile (L = 9, past 16, past the 32 staged levels); and the
semantics the row test must keep: ``$SYS`` rows and topics against
``+``/``#``-first filters, a bare ``#``, ``+/#``, blank levels, padded
topics (``tlen = -2``) and filters (``flen = -2``), topics deeper than the
table, a batch that is no multiple of the forward kernel's topic tile.
``chip_smoke.py`` phase 3d and ``tests/test_torch_cuda.py`` run the
same :data:`DENSE_CASES`. :data:`WORDS_CASES` hold the words kernel
(``match_words``) against its twin on the forward bitmaps of some of them:
a batch of 1, padded topics, a topic that matches nothing, topics with
more nonzero words than ``K``, and ``W`` below ``max_words`` (``K = W``).
Everything is made from a seed.
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple

import numpy as np

from rmqtt_tpu_torch.core.topic import filter_valid
from rmqtt_tpu_torch.ops.encode import FilterTable


class DenseCase(NamedTuple):
    name: str
    filters: int  # random filters besides the fixed ones
    batch: int  # real topics (filters of the inverse) a batch
    pad_to: int  # the padded batch
    deep: int  # levels of the deepest filter and topic (0: none)


DENSE_CASES = (
    DenseCase("B=1, capacity 1024", 300, 1, 1, 0),
    DenseCase("B=3 padded to 4", 300, 3, 4, 0),
    DenseCase("B=37 padded to 64, L=9", 600, 37, 64, 9),
    DenseCase("B=130 padded to 256 (two blocks of topics), capacity 4096", 3000,
              130, 256, 0),
    DenseCase("L=20, past the 16-level tile", 500, 40, 64, 20),
    DenseCase("L=40, past the 32 staged levels", 500, 40, 64, 40),
    DenseCase("B=200 unpadded, the forward tile's ragged edge (200 = 128 + 72)", 3000,
              200, 200, 0),
)

#: filters every case holds (and scans in the inverse direction)
FIXED_FILTERS = ("#", "+/#", "+", "+/+", "$SYS/#", "$SYS/+/x", "a//b", "/#", "a/+/",
                 "", "a/#", "+/b/#", "x/y")
#: topics every case matches (and stores in the inverse direction)
FIXED_TOPICS = ("$SYS/a/x", "$SYS", "", "/", "a//b", "a", "a/b", "x/y", "b/b/b",
                "zz/unknown")
WORDS = ("a", "b", "x", "", "y", "$SYS")


def _random_filter(rng: random.Random, depth: int) -> str:
    while True:
        levels = [rng.choice(WORDS + ("+",)) for _ in range(depth)]
        levels = [lv if i == 0 or lv != "$SYS" else "b" for i, lv in enumerate(levels)]
        if rng.random() < 0.3:
            levels[-1] = "#"
        f = "/".join(levels)
        if filter_valid(f):
            return f


def _random_topic(rng: random.Random, depth: int) -> str:
    levels = [rng.choice(WORDS) for _ in range(depth)]
    return "/".join(lv if i == 0 or lv != "$SYS" else "y" for i, lv in enumerate(levels))


class DenseInputs(NamedTuple):
    """A case's kernel arguments (numpy, in the wrappers' order) and the
    strings they encode, for an oracle: ``forward`` = ``(tok, flen,
    prefix_len, has_hash, first_wild, ttok, tlen, tdollar)``, ``inverse``
    = ``(rtok, rlen, rdollar, ftok, flen, fprefix, fhash, fwild)``; the
    live filter rows (fid → filter), the topics, the live stored topic
    rows (fid → topic) and the scanned filters."""

    forward: tuple
    inverse: tuple
    filters: Dict[int, str]
    topics: List[str]
    stored: Dict[int, str]
    scanned: List[str]


def make_dense_case(case: DenseCase, seed: int = 0, extra_topics=()) -> DenseInputs:
    """→ the case's inputs (:class:`DenseInputs`); ``extra_topics`` are
    appended to the batch's real topics (the padding shrinks by as many)."""
    rng = random.Random(seed * 1000 + sum(map(ord, case.name)))
    filters = list(FIXED_FILTERS) + [_random_filter(rng, rng.randint(1, 6))
                                     for _ in range(case.filters)]
    topics = list(FIXED_TOPICS)
    if case.deep:
        filters += [_random_filter(rng, case.deep) for _ in range(4)]
        filters.append("/".join(["a"] * (case.deep - 1)) + "/#")
        topics += [_random_topic(rng, case.deep) for _ in range(3)]
        topics.append("/".join(["a"] * (case.deep + 5)))  # deeper than the table
    while len(topics) < case.batch:
        topics.append(_random_topic(rng, rng.randint(1, 7)))
    topics = topics[:case.batch] + list(extra_topics)
    fwd = FilterTable()
    live = {fwd.add(f): f for f in filters}
    for fid in range(0, len(filters), 7):  # free rows between live ones
        fwd.remove(fid)
        del live[fid]
    inv = FilterTable()
    names = list(dict.fromkeys(topics + [_random_topic(rng, rng.randint(1, 7))
                                         for _ in range(case.filters)]))
    stored = {inv.add(t): t for t in names}
    for fid in range(3, len(names), 11):
        inv.remove(fid)
        del stored[fid]
    scanned = (filters * (1 + case.batch // len(filters)))[:case.batch]
    rng.shuffle(scanned)
    forward = (fwd.tok, fwd.flen, fwd.prefix_len, fwd.has_hash, fwd.first_wild,
               *fwd.encode_topics(topics, pad_batch_to=max(case.pad_to, len(topics))))
    inverse = (inv.tok, inv.flen, inv.row_dollar,
               *inv.encode_filters(scanned, pad_batch_to=case.pad_to))
    return DenseInputs(forward, inverse, live, topics, stored, scanned)


def as_tensors(arrays, device) -> tuple:
    """numpy arguments → contiguous tensors on ``device``: int32 for the
    tokens and lengths, bool for the flags."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(
        a, dtype=bool if a.dtype == np.bool_ else np.int32)).to(device) for a in arrays)


class WordsCase(NamedTuple):
    name: str
    case: DenseCase  # the forward bitmap's table and topics
    max_words: int
    extra_topics: tuple  # topics appended to the case's batch
    over_k: bool  # some topic has more than K nonzero words


#: a topic whose first level starts with '$' and is in no filter: no row
#: matches it (wildcard-first rows by the $ rule, the others by level 0)
NO_MATCH = "$none/x"

WORDS_CASES = (
    WordsCase("B=1, W=32 below max_words: K = W", DENSE_CASES[0], 128, (), False),
    WordsCase("3 topics padded to 4, K = W = 32", DENSE_CASES[1], 128, (), False),
    WordsCase("37 topics and one that matches nothing, padded to 64, K=8, L=9",
              DENSE_CASES[2], 8, (NO_MATCH,), True),
    WordsCase("topics with more than K nonzero words, K=4, W=128", DENSE_CASES[3], 4,
              (NO_MATCH,), True),
)


def make_words_case(wc: WordsCase, seed: int = 0) -> DenseInputs:
    """→ the inputs of ``wc``'s forward scan: its bitmap is the words
    case's input."""
    return make_dense_case(wc.case, seed, wc.extra_topics)
