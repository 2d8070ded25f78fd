"""The port's roofline model (``rmqtt_tpu_torch/bench/roofline_model.py``)
against the JAX package's: the same dict, key for key, for one partitioned
table built in each package from the same ``gen_mixed`` filters, with the
same candidate counts and bandwidth; its default part is the H100's."""

import inspect
import random

import pytest

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu.bench import roofline_model as JR
from rmqtt_tpu.core.topic import split_levels
from rmqtt_tpu_torch.bench import roofline_model as TR
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform

N_FILTERS = 5_000
N_TOPICS = 512


@pytest.fixture(scope="module")
def tables():
    rng = random.Random(0)
    filters = gen_mixed(rng, N_FILTERS)
    topics = gen_topics_uniform(rng, N_TOPICS)
    jt, tt = JP.PartitionedTable(), TP.PartitionedTable()
    for f in filters:
        assert jt.add(f) == tt.add(f)
    jn = [len(jt._candidates_for(split_levels(t))) for t in topics]
    tn = [len(tt._candidates_for(split_levels(t))) for t in topics]
    assert jn == tn and max(tn) > 1
    return jt, tt, tn


@pytest.mark.parametrize("measured", [None, 123_456.7])
def test_model_table_equals_the_jax_model(tables, measured):
    jt, tt, ncs = tables
    want = JR.model_table(jt, ncs, bw_gbps=JR.V5E_HBM_GBPS,
                          measured_topics_per_sec=measured)
    got = TR.model_table(tt, ncs, bw_gbps=TR.V5E_HBM_GBPS,
                         measured_topics_per_sec=measured)
    assert list(got) == list(want)
    assert got == want
    assert got["tile_bytes_packed"] is not None
    assert ("measured_fraction_of_ceiling" in got) == (measured is not None)


def test_default_part_is_the_h100(tables):
    _jt, tt, ncs = tables
    assert TR.V5E_HBM_GBPS == JR.V5E_HBM_GBPS == 819.0
    assert TR.H100_HBM_GBPS == 3350.0
    assert inspect.signature(TR.model_table).parameters["bw_gbps"].default == 3350.0
    at_h100 = TR.model_table(tt, ncs)
    at_v5e = TR.model_table(tt, ncs, bw_gbps=TR.V5E_HBM_GBPS)
    assert at_h100["hbm_gbps"] == 3350.0
    assert at_h100["bytes_per_topic"] == at_v5e["bytes_per_topic"]
    assert abs(at_h100["ceiling_topics_per_sec"]
               - at_v5e["ceiling_topics_per_sec"] * 3350.0 / 819.0) <= 5


@pytest.mark.parametrize("budget", [1 << 20, 5])
def test_tail_bounds(budget):
    """The tails' bounds count the words and chunk ids once, one fid a kept
    route and the wire once; a budget below the routes keeps fewer."""
    import torch

    from rmqtt_tpu_torch.bench.timing import HBM_BYTES_PER_S

    words = torch.zeros((3, 8), dtype=torch.int32)
    words[0, 0] = 0b1011  # 3 routes
    words[2, 5] = -1  # 32 routes
    cids = torch.zeros((3, 2), dtype=torch.int32)
    cnts = torch.tensor([3, 0, 32])
    kept = min(budget, 35)
    nbytes, ops = TR.fused_tail_work(words, cids, cnts, budget)
    assert nbytes == (24 + 6 + kept + budget + 3) * 4
    sort = 3 * 2 + 32 * 5 if budget > 35 else 3 * 2 + 2 * 1
    assert ops == 2 * 24 + 2 * 3 + 4 * kept + sort
    ms, by, term = TR.fused_tail_bound_ms(words, cids, cnts, budget)
    assert by == term == "bytes" and ms == nbytes / HBM_BYTES_PER_S * 1e3
    nbytes, ops = TR.compact_global_work(words, cnts, budget)
    assert (nbytes, ops) == (24 * 4 + (budget + 3) * 2, 2 * 24 + 2 * 3 + 2 * kept)
    wide = torch.zeros((1, 2048), dtype=torch.int32)
    assert TR.compact_global_work(wide, torch.tensor([0]), 4)[0] == 2048 * 4 + 5 * 4
    ms, by, _ = TR.compact_global_bound_ms(words, cnts, budget)
    assert by == "bytes" and ms == nbytes / HBM_BYTES_PER_S * 1e3


# the row test's work (bench/roofline_model.py): a difference for each
# literal level and for the length rule, one instruction each at least, and
# one more for the bit; a LOP3 folds two differences at most
@pytest.mark.parametrize("rows,lvl,b,lit,term", [
    (1 << 20, 8, 16384, 8, "issue"),  # cfg3's forward, every level literal
    (1024, 8, 64, 3, "bytes"),        # a small table: the bitmap's bytes
])
def test_row_test_bound_at_a_hand_computed_shape(rows, lvl, b, lit, term):
    from rmqtt_tpu_torch.bench.timing import (HBM_BYTES_PER_S, INSTR_PER_S, L2_BYTES,
                                              SM_LOAD_BYTES_PER_S)

    pairs = rows * b
    assert TR.row_test_work(pairs, pairs * lit) == (lit + 2) * pairs
    ms, by, got_term = TR.dense_bound_ms(rows, lvl, b, pairs * lit)
    nbytes = (rows + b) * (4 * lvl + 5) + b * rows // 8
    want = {"issue": (lit + 2) * pairs / INSTR_PER_S, "bytes": nbytes / HBM_BYTES_PER_S}
    assert got_term == term and by == ("bytes" if term == "bytes" else "operations")
    assert ms == pytest.approx(want[term] * 1e3, rel=1e-12)
    # warm (a repeat on the same inputs): at most the L2's bytes from the
    # cache, every byte through the SMs' loads; never above the cold bound
    warm_bytes = max(max(nbytes - L2_BYTES, 0) / HBM_BYTES_PER_S,
                     nbytes / SM_LOAD_BYTES_PER_S)
    wms, _wby, wterm = TR.dense_bound_ms(rows, lvl, b, pairs * lit, warm=True)
    assert wms == pytest.approx(max(warm_bytes, want["issue"]) * 1e3, rel=1e-12)
    assert wms <= ms and wterm == "issue"  # warm, both shapes are bound by issue
    # the H100's rates: 4 schedulers x 32 lanes and 128 load bytes a clock
    # on each of 132 SMs at 1.98 GHz; 50 MB of L2
    assert INSTR_PER_S == SM_LOAD_BYTES_PER_S == 128 * 132 * 1.98e9
    assert L2_BYTES == 50 * 2**20
    if term == "issue":  # 10 instructions a pair: 5.1354 ms by hand
        assert ms == pytest.approx(5.1354, abs=1e-4)
    else:  # 37,888 + 2,368 + 8,192 bytes: 1.4e-5 ms cold, 1.4e-6 warm, by hand;
        # warm, 5 instructions a pair (9.8e-6 ms) outweigh them
        assert ms == pytest.approx(48448 / 3.35e12 * 1e3, rel=1e-12)
        assert warm_bytes == pytest.approx(48448 / 3.3454080e13, rel=1e-12)
        assert wms == pytest.approx(5 * 65536 / 3.3454080e13 * 1e3, rel=1e-12)


def test_literal_levels_count_the_compared_levels():
    """Levels below the prefix whose token is not '+', of live rows only;
    a padded filter (prefix L + 1) compares every level."""
    import torch

    from rmqtt_tpu_torch.ops.encode import FilterTable

    t = FilterTable()
    enc = t.encode_filters(["a/+/b/#", "+/+", "#", "a/b/c", "x"], pad_batch_to=6)
    tok, flen, fprefix = (torch.from_numpy(a) for a in enc[:3])
    assert TR.literal_levels(tok, fprefix, flen != -2).tolist() == [2, 0, 0, 3, 1, 0]
    assert TR.literal_levels(tok, fprefix, torch.ones(6, dtype=torch.bool))[5] == 8


# card times recorded in PERF.md §6 (H100 80GB HBM3, 700 W; the least of
# the runs recorded there) at their shapes: (kernel, rows, levels, batch,
# ms, warm). ``warm``: by graph replay or CUDA events, each call finding
# its inputs where the last one left them (the 1M-row tables, ~42 MB, fit
# the 50 MB L2); the others were taken with the L2 flushed by a read
# before each call (bench/dense_kernels.py). Each is held to the bound of
# its own kind. The forward's bound is taken with every level of every row
# literal, the most its table can need, so the data's bound lies at or
# below it; the inverse's with the subscriber mix's own filters
# (retained_sub_filters, seed 5), the batch it was timed at.
RECORDED_DENSE = [
    ("dense_match_packed", 1 << 20, 8, 16384, 17.5407, True),
    ("dense_match_packed", 1 << 20, 8, 1024, 1.1487, True),
    ("dense_match_packed", 1 << 20, 8, 64, 0.1061, True),
    ("dense_match_packed", 1 << 20, 8, 33, 0.0980, True),
    ("dense_match_packed", 1 << 20, 8, 8, 0.0636, True),
    ("dense_match_packed", 1 << 20, 8, 1, 0.0620, True),
    ("dense_match_retained", 1 << 20, 8, 64, 0.3195, True),
    # the rows-on-lanes redesign: warm at 64, 8 and 1 filters, and flushed
    ("dense_match_retained", 1 << 20, 8, 64, 0.0403, True),
    ("dense_match_retained", 1 << 20, 8, 8, 0.0220, False),
    ("dense_match_retained", 1 << 20, 8, 1, 0.0195, False),
    ("dense_match_retained", 1 << 20, 8, 8, 0.0132, True),
    ("dense_match_retained", 1 << 20, 8, 1, 0.0100, True),
    # four warps a block, rounded down; the forward's small batches flushed
    ("dense_match_retained", 1 << 20, 8, 64, 0.0391, True),
    ("dense_match_retained", 1 << 20, 8, 8, 0.0126, True),
    ("dense_match_retained", 1 << 20, 8, 1, 0.0097, True),
    ("dense_match_retained", 1 << 20, 8, 64, 0.0423, False),
    ("dense_match_retained", 1 << 20, 8, 8, 0.0211, False),
    ("dense_match_retained", 1 << 20, 8, 1, 0.0189, False),
    ("dense_match_packed", 1 << 20, 8, 8, 0.0730, False),
    ("dense_match_packed", 1 << 20, 8, 1, 0.0696, False),
]


@pytest.mark.parametrize("name,rows,lvl,b,ms,warm", RECORDED_DENSE,
                         ids=[f"{r[0]}-B={r[3]}-{r[4]}ms" for r in RECORDED_DENSE])
def test_recorded_dense_times_are_not_below_their_bounds(name, rows, lvl, b, ms, warm):
    import torch

    from rmqtt_tpu_torch.bench.workloads import retained_sub_filters
    from rmqtt_tpu_torch.ops.encode import FilterTable

    if name == "dense_match_packed":
        literal = b * rows * lvl
    else:
        enc = FilterTable().encode_filters(retained_sub_filters(random.Random(5))[:b])
        tok, flen, fprefix = (torch.from_numpy(a) for a in enc[:3])
        literal = rows * int(TR.literal_levels(tok, fprefix, flen != -2).sum())
    bound, _by, _term = TR.dense_bound_ms(rows, lvl, b, literal, warm=warm)
    assert bound <= ms


# (b, w, k, ms): the dense words kernel at 4d's batch; the topk mode's
# compact_words on the same kernel at cfg3's [16,384, 128] words, K = 32
# and a regrow's 64, and at the broker's 1 and 8 topics
RECORDED_WORDS = [(16384, 32768, 128, 0.7046), (16384, 128, 32, 0.0067),
                  (16384, 128, 64, 0.0117), (1, 128, 32, 0.0014), (8, 128, 32, 0.0015)]


@pytest.mark.parametrize("b,w,k,ms", RECORDED_WORDS)
def test_recorded_words_times_are_not_below_their_bounds(b, w, k, ms):
    assert TR.dense_words_bound_ms(b, w, k)[0] <= ms


# the match-words kernels at cfg3's B = 16,384, NC = 32 on the 1M-filter
# tables (8,192 tile slots of 8 levels: packed 1,024 B a tile, legacy int16
# 2,816 B), recorded by graph replay (the least of PERF.md §6's runs):
# (tile shape, element bytes, ms). The bound is taken at the most work the
# shape can need (every slot a distinct real tile, every level of every row
# literal), so the data's bound lies at or below it.
RECORDED_MATCH_WORDS = [((256,), 4, 0.0968), ((11, 128), 2, 0.1505)]


@pytest.mark.parametrize("tile,elem,ms", RECORDED_MATCH_WORDS, ids=["packed", "legacy"])
def test_recorded_match_words_times_are_not_below_their_bounds(tile, elem, ms):
    import torch

    b, nc, chunks, lvl = 16384, 32, 8192, 8
    dtype = torch.int32 if elem == 4 else torch.int16
    tiles = torch.zeros((1, *tile), dtype=dtype).expand(chunks, *tile)
    ids = (torch.arange(b * nc, dtype=torch.int32) % (chunks - 1) + 1).reshape(b, nc)
    ttok = torch.zeros((1, lvl), dtype=torch.int32).expand(b, lvl)
    lit = torch.full((chunks,), TP.CHUNK * lvl, dtype=torch.int64)
    bound, _by, _term = TR.words_bound_ms(tiles, ttok, ids, lit)
    assert bound <= ms
