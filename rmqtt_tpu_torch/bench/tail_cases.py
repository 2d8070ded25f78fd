"""Inputs that hold the compaction-tail kernels against their plain twins.

Random sparse match words with the shapes the kernels treat apart: a topic
that matches every row (a warp's share of shared memory, a block's, and
past a block's, which sorts in device memory), a budget that cuts inside a
topic, cleared rows (``-1``) in the fid map, one topic with the broker's
budget of 256, an NC that is no power of two, words of 32-bit wires
(``W*32 >= 0x10000``) and, on the card, an empty batch. Then the edges of
the kernels' two paths (one block for ``B <= 64`` and ``budget <= 16,384``,
else a single pass of eight topics a block with a look-back): B = 64 and
65, a small B with a budget past the one-block path, topics of exactly 32,
33, 1,024 and 1,025 kept routes (the register sort, the warp's shared
memory, the block) on both paths, a budget that ends at a block's last
topic, 16,384 topics of which only the last matches, and a B that is no
multiple of a block's topics. ``chip_smoke.py``
phase 3 and ``tests/test_torch_cuda.py`` run :data:`CARD_CASES`; the CPU
tests run :data:`TAIL_CASES`, the ones small enough for the JAX reference
there.
Everything is made with numpy from a seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from rmqtt_tpu_torch.ops.match_words import CHUNK, WORDS_PER_CHUNK


class TailCase(NamedTuple):
    name: str
    b: int  # topics
    nc: int  # candidate chunks a topic (W = nc*4 words)
    density: float  # share of set bits
    budget: Optional[int]  # None: cut inside the first of `full`
    full: Tuple[int, ...] = ()  # topics that match every row
    cleared: float = 0.0  # share of -1 rows in the fid map
    seed: int = 0
    exact: Tuple[Tuple[int, int], ...] = ()  # (topic, routes): that many random bits
    budget_at: Optional[int] = None  # the budget: the routes of the topics before this


TAIL_CASES = (
    TailCase("full topic NC=64", 4, 64, 0.002, 16384, full=(1,)),
    TailCase("budget cut inside a topic", 8, 8, 0.01, None, full=(3,)),
    TailCase("cleared rows (-1 fids)", 16, 4, 0.05, 4096, cleared=0.5),
    TailCase("B=1 budget 256", 1, 32, 0.01, 256),
    TailCase("32-bit wire W=2048", 3, 512, 0.0005, 1024),
    TailCase("overflow, budget 16", 7, 32, 0.01, 16, cleared=0.1),
    TailCase("NC=33", 5, 33, 0.02, 1024, cleared=0.1),
    TailCase("no routes", 6, 8, 0.0, 256),
    TailCase("B=64 budget 256 (one block)", 64, 8, 0.005, 256),
    TailCase("one topic of 33 routes", 3, 8, 0.0, 256, exact=((1, 33),)),
)

#: the card's cases: the CPU's, no topics, and topics past a warp's and a
#: block's shared memory (4,096 and 65,536 routes), whole and cut
CARD_CASES = TAIL_CASES + (
    TailCase("B=0", 0, 8, 0.0, 64),  # the JAX reference gathers from nothing
    TailCase("full topic NC=32 (block in shared memory)", 64, 32, 0.01, 32768,
             full=(5, 40), cleared=0.05),
    TailCase("full topic NC=512 (sort in device memory)", 2, 512, 0.001, 131072,
             full=(1,), cleared=0.05),
    TailCase("full topic NC=512 cut inside", 2, 512, 0.001, None, full=(1,)),
    TailCase("many topics B=20000", 20000, 4, 0.01, 65536, full=(7,)),
    TailCase("B=65 budget 256 (single pass)", 65, 8, 0.005, 256),
    TailCase("B=4 budget 32768 (single pass)", 4, 32, 0.01, 32768, full=(2,)),
    TailCase("kept 32, 33, 1024, 1025 (one block)", 4, 32, 0.0, 4096,
             exact=((0, 32), (1, 33), (2, 1024), (3, 1025))),
    TailCase("kept 32, 33, 1024, 1025 (single pass)", 200, 32, 0.002, 65536,
             exact=((10, 32), (50, 33), (100, 1024), (150, 1025))),
    TailCase("budget ends at a block's last topic", 300, 8, 0.01, None, budget_at=64),
    TailCase("B=16384, only the last topic matches", 16384, 2, 0.0, 4096,
             exact=((16383, 20),)),
    TailCase("B=1001 (no multiple of a block)", 1001, 8, 0.01, 16384, cleared=0.1),
)


def counts_of(words: np.ndarray) -> np.ndarray:
    """Set bits a topic of ``[B, W]`` uint32 words → int64 ``[B]``."""
    return np.unpackbits(words.view(np.uint8), axis=-1).reshape(
        words.shape[0], -1).sum(axis=1).astype(np.int64)


def kept_routes(cnts: np.ndarray, budget: int) -> np.ndarray:
    """Each topic's kept routes: ``clamp(budget - off, 0, cnt)``, ``off``
    the exclusive scan of the counts."""
    off = np.cumsum(cnts) - cnts
    return np.clip(budget - off, 0, cnts)


def make_tail_case(case: TailCase):
    """→ (words ``[B, W]`` uint32, fid_rows ``[chunks, CHUNK]`` int32 with
    ``-1`` for cleared rows, chunk_ids ``[B, NC]`` int32, budget). A budget
    of None is set halfway into the first full topic's routes, or, with
    ``budget_at``, to the routes of the topics before that one."""
    rng = np.random.default_rng(case.seed + case.b * 1000 + case.nc)
    w = case.nc * WORDS_PER_CHUNK
    bits = rng.random((case.b, w, 32)) < case.density
    for t in case.full:
        bits[t] = True
    picks = np.random.default_rng(case.seed + 7)
    for t, n in case.exact:
        bits[t] = False
        bits[t].reshape(-1)[picks.choice(w * 32, n, replace=False)] = True
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    words = words.astype(np.uint32).reshape(case.b, w)
    up = 2 * case.nc + 8
    fid = rng.permutation(up * CHUNK).astype(np.int32)
    fid[rng.random(fid.size) < case.cleared] = -1
    chunk_ids = rng.integers(0, up, (case.b, case.nc)).astype(np.int32)
    budget = case.budget
    if case.budget_at is not None:
        budget = int(counts_of(words)[:case.budget_at].sum())
    elif budget is None:
        cnts = counts_of(words)
        t = case.full[0]
        budget = int(cnts[:t].sum() + cnts[t] // 2)
    return words, fid.reshape(up, CHUNK), chunk_ids, budget
