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
    ms, by, ms_int = TR.fused_tail_bound_ms(words, cids, cnts, budget)
    assert by == "bytes" and ms == ms_int == nbytes / HBM_BYTES_PER_S * 1e3
    nbytes, ops = TR.compact_global_work(words, cnts, budget)
    assert (nbytes, ops) == (24 * 4 + (budget + 3) * 2, 2 * 24 + 2 * 3 + 2 * kept)
    wide = torch.zeros((1, 2048), dtype=torch.int32)
    assert TR.compact_global_work(wide, torch.tensor([0]), 4)[0] == 2048 * 4 + 5 * 4
    ms, by, _ = TR.compact_global_bound_ms(words, cnts, budget)
    assert by == "bytes" and ms == nbytes / HBM_BYTES_PER_S * 1e3
