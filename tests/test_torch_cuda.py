"""The CUDA kernels on a card: each against its plain twin (the compaction
tails on ``bench/tail_cases.py``'s ``CARD_CASES`` too), the router on
the card against the same router on the CPU, each hand-selected matcher
mode (unfused, topk, segmented) against the same mode on the CPU, the
dense kernels against their twins and the dense router against the
partitioned one, the sharded matchers over a list of two devices (one
card twice) against the local ones, the port's broker with every batch on
the card against the ``DefaultRouter`` oracle, and its retained replay
through the retained-scan kernels against ``RetainTree``, a broker whose
retainer plugin loads its store into the card's retained table, and
``--workers 2 --router xla``: two broker processes on one card.

This file imports nothing of JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
on a machine with an NVIDIA GPU (``tests/conftest.py`` imports JAX).
Every test here skips where torch sees no CUDA device."""

import asyncio
import collections
import random

import numpy as np
import pytest
import torch

import rmqtt_tpu_torch.ops.compact_tail as CT
import rmqtt_tpu_torch.ops.encode as TE
import rmqtt_tpu_torch.ops.match as DM
import rmqtt_tpu_torch.ops.match_words as MW
import rmqtt_tpu_torch.ops.retained as DR
import rmqtt_tpu_torch.ops.partitioned as TP
import rmqtt_tpu_torch.ops.retained_part as RP
from rmqtt_tpu_torch.bench.mqtt_load import (LoadClient, connect_and_subscribe,
                                             expected_deliveries, oracle_router,
                                             publish_wave)
from rmqtt_tpu_torch.bench.retained_cases import (RETAINED_CASES, TABLE_FILTERS,
                                                  make_retained_case, table_inputs,
                                                  table_topics)
from rmqtt_tpu_torch.bench.dense_cases import (DENSE_CASES, WORDS_CASES, DenseCase, as_tensors,
                                               make_dense_case, make_words_case)
from rmqtt_tpu_torch.bench.tail_cases import CARD_CASES, make_tail_case
from rmqtt_tpu_torch.bench.words_cases import EDGE_CASES, make_case
from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
from rmqtt_tpu_torch.broker.server import MqttBroker
from rmqtt_tpu_torch.bench.workloads import (gen_mixed, gen_retained_topics,
                                             gen_topics_uniform, retained_sub_filters)
from rmqtt_tpu_torch.parallel import ShardedMatcher, ShardedPartitionedMatcher, make_mesh
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter

FORMATS = ["packed", "legacy_int16", "legacy_int32"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(fmt, dev):
    """A ~700-filter table with a 2-byte level, 40 topics (padded and $
    topics among them) → the kernel arguments on ``dev`` and the layout."""
    rng = random.Random(0)
    t = TP.PartitionedTable()
    seen = set()
    while len(seen) < 700:
        depth = rng.randint(1, 6)
        levels = [f"v{d}_{rng.randrange(600 if d == 2 else 6)}" for d in range(depth)]
        r = rng.random()
        if r < 0.35:
            levels[rng.randrange(depth)] = "+"
        if 0.25 <= r < 0.55:
            levels[-1] = "#"
        if rng.random() < 0.05:
            levels[0] = "$sys"
        f = "/".join(levels)
        if f not in seen:
            seen.add(f)
            t.add(f)
    topics = ["/".join(f"v{d}_{rng.randrange(600 if d == 2 else 7)}"
                       for d in range(rng.randint(1, 8))) for _ in range(37)]
    topics += ["$sys/v1_1/v2_3", "$sys"]
    ttok, tlen, tdollar, cids, _nc = t.encode_topics(topics, pad_batch_to=40)
    lay = t.packed_layout() if fmt == "packed" else None
    if lay is not None:
        assert 2 in lay.widths
        _, ttok = t.translate_packed(ttok)
        tiles = TP.pack_device_rows_packed(t, lay)
    else:
        tiles = TP.pack_device_rows(t)
        if fmt == "legacy_int32":
            tiles = tiles.astype(np.int32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (put(tiles), put(ttok.astype(np.int32)), put(tlen.astype(np.int32)),
            put(tdollar.astype(np.int32)), put(cids.astype(np.int32)))
    return args, lay


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_equals_plain_on_cuda(cuda, fmt):
    args, lay = _inputs(fmt, cuda)
    n0 = MW.match_words_packed.launches + MW.match_words_legacy.launches
    if lay is not None:
        got = MW.match_words_packed(*args, layout=lay)
        want = MW.match_words_packed_plain(*args, layout=lay)
    else:
        got = MW.match_words_legacy(*args)
        want = MW.match_words_legacy_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want != 0).any())
    assert MW.match_words_packed.launches + MW.match_words_legacy.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c.name for c in EDGE_CASES])
def test_kernel_edge_cases_on_cuda(cuda, case):
    """NC above 32, B of 1 and 3, chunk 0 at the front / in the middle /
    repeated, a repeated nonzero id, every packed group count and legacy L
    range: equal to the twin. Out-of-range ids give zero words."""
    tiles, ttok, tlen, tdollar, ids, lay, bad, plain_ids = make_case(case)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = [put(a) for a in (tiles, ttok, tlen, tdollar)]
    if lay is not None:
        got = MW.match_words_packed(*args, put(ids), layout=lay)
        want = MW.match_words_packed_plain(*args, put(plain_ids), layout=lay)
    else:
        got = MW.match_words_legacy(*args, put(ids))
        want = MW.match_words_legacy_plain(*args, put(plain_ids))
    if bad is not None:
        badw = put(np.repeat(bad, MW.WORDS_PER_CHUNK, axis=1))
        assert not bool(got[badw].any())
        want = torch.where(badw, torch.zeros_like(want), want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_router_on_cuda_equals_cpu(cuda, packed, monkeypatch):
    """The same ~2K filters and topics through ``TorchRouter`` on the card
    (kernels) and on the CPU (plain twins), a batch big enough for the NC
    split, before and after churn (a delta upload on the card)."""
    monkeypatch.setenv("RMQTT_PACKED", "1" if packed else "0")
    routers = [TorchRouter(device=cuda), TorchRouter(device="cpu")]
    rng = random.Random(1)
    filters = gen_mixed(rng, 2000)
    opts = SubscriptionOptions()
    for r in routers:
        for i, f in enumerate(filters):
            r.add(f, Id(1, f"c{i}"), opts)
        r.table.compact()  # the churn below stays under the compaction trigger
    topics = gen_topics_uniform(rng, 1100)
    counter = MW.match_words_packed if packed else MW.match_words_legacy
    n0 = counter.launches
    got, want = (r.matcher.match(topics) for r in routers)
    assert counter.launches > n0
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert sum(len(w) for w in want) > 1000
    for r in routers:
        for i, f in enumerate(filters[:300]):
            r.remove(f, Id(1, f"c{i}"))
        for j, f in enumerate(gen_mixed(random.Random(2), 300)):
            r.add(f, Id(1, f"n{j}"), opts)
    got, want = (r.matcher.match(topics) for r in routers)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    m = routers[0].matcher
    assert (m.full_uploads, m.delta_uploads) == (1, 1)


MODES = {
    "unfused": {"RMQTT_FUSED": "0"},
    "topk": {"RMQTT_COMPACT": "topk"},
    "segmented_fused": {"RMQTT_SEG_BYTES": "8192"},
    "segmented_unfused": {"RMQTT_SEG_BYTES": "8192", "RMQTT_FUSED": "0"},
    "segmented_legacy": {"RMQTT_SEG_BYTES": "8192", "RMQTT_PACKED": "0"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_matcher_modes_on_cuda_equal_cpu(cuda, mode, monkeypatch):
    """Each hand-selected matcher mode on the card (the words kernels, the
    global modes' compaction kernels, the topk compaction and segment
    scatters as torch ops) equals the same matcher
    on the CPU, on a batch big enough for the NC split and on small ones,
    before and after churn (a delta upload on the card, into the segments
    when segmented)."""
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    tables = [TP.PartitionedTable(), TP.PartitionedTable()]
    rng = random.Random(3)
    filters = gen_mixed(rng, 2000)
    for t in tables:
        for f in filters:
            t.add(f)
        t.compact()
    ms = [TP.PartitionedMatcher(tables[0], device=cuda),
          TP.PartitionedMatcher(tables[1], device="cpu")]
    topics = gen_topics_uniform(rng, 1100)
    counter = MW.match_words_legacy if "legacy" in mode else MW.match_words_packed
    for batch in (topics, topics[:1], topics[:8]):
        n0 = counter.launches
        got, want = (m.match(batch) for m in ms)
        assert counter.launches > n0
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert sum(len(w) for w in ms[1].match(topics)) > 1000
    seg = "SEG_BYTES" in str(MODES[mode])
    assert (ms[0]._dev.segments is not None) == seg
    assert ms[0].hbm_breakdown()["segments"] == (len(ms[0]._dev.segments) if seg else 0)
    for t in tables:
        for fid in range(300):
            t.remove(fid)
        for f in gen_mixed(random.Random(2), 300):
            t.add(f)
    got, want = (m.match(topics) for m in ms)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert (ms[0].full_uploads, ms[0].delta_uploads) == (1, 1)


# ------------------------------------------------- the compaction tails
def _on(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c.name for c in CARD_CASES])
def test_tail_kernels_equal_plain_on_cuda(cuda, case):
    """Both compaction-tail kernels write their twins' whole wire, each
    launch counted once: topics past a warp's and a block's shared memory,
    budgets cutting inside a topic, -1 fids, B=1 and B=0, both widths."""
    words, fids, cids, budget = make_tail_case(case)
    w, f, c = _on(words, cuda), _on(fids, cuda), _on(cids, cuda)
    n0 = (CT.fused_compact_decode.launches, CT.compact_global.launches)
    got = CT.fused_compact_decode(w, f, c, budget)
    want = CT.fused_compact_decode_plain(w, f, c, budget)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    got = CT.compact_global(w, budget)
    want = CT.compact_global_plain(w, budget)
    assert got.dtype == want.dtype and torch.equal(got, want)
    torch.cuda.synchronize()
    assert (CT.fused_compact_decode.launches, CT.compact_global.launches) == (
        n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
def test_tail_kernels_on_unaligned_words_on_cuda(cuda):
    """Words that start off a 16-byte boundary take the kernels' 4-byte
    loads and give the same wires, on the one-launch path and on the
    single pass."""
    for case in (CARD_CASES[0], next(c for c in CARD_CASES if c.name.startswith("B=1001"))):
        words, fids, cids, budget = make_tail_case(case)
        flat = torch.zeros(words.size + 1, dtype=torch.int32, device=cuda)
        flat[1:] = _on(words, cuda).reshape(-1)
        w = flat[1:].view(words.shape)
        assert w.is_contiguous() and w.data_ptr() % 16
        f, c = _on(fids, cuda), _on(cids, cuda)
        assert torch.equal(CT.fused_compact_decode(w, f, c, budget),
                           CT.fused_compact_decode_plain(w, f, c, budget))
        assert torch.equal(CT.compact_global(w, budget), CT.compact_global_plain(w, budget))


@pytest.mark.cuda
def test_tail_kernels_in_a_graph_and_on_two_streams_on_cuda(cuda):
    """The single pass's look-back flags and ticket start cleared on every
    call: a CUDA graph of both wrappers replayed three times, and calls on
    two streams at once, give the twins' wires."""
    case = next(c for c in CARD_CASES if c.name.startswith("many topics"))
    words, fids, cids, budget = make_tail_case(case)
    w, f, c = _on(words, cuda), _on(fids, cuda), _on(cids, cuda)
    want = (CT.fused_compact_decode_plain(w, f, c, budget), CT.compact_global_plain(w, budget))
    CT.fused_compact_decode(w, f, c, budget)  # the build and the attributes
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = (CT.fused_compact_decode(w, f, c, budget), CT.compact_global(w, budget))
    for _ in range(3):
        for x in got:
            x.fill_(7)
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for s in streams:
        with torch.cuda.stream(s):
            outs.append((CT.fused_compact_decode(w, f, c, budget), CT.compact_global(w, budget)))
    torch.cuda.synchronize()
    for got in outs:
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_tail_wrappers_raise_when_the_library_fails(cuda, monkeypatch):
    """Given CUDA tensors the tail wrappers launch or raise: a library that
    does not load makes both raise, and nothing runs the twins instead."""
    import rmqtt_tpu_torch.ops._build as B

    def broken():
        raise B.KernelError("cannot load the kernel library")

    words, fids, cids, budget = make_tail_case(CARD_CASES[0])
    w, f, c = _on(words, cuda), _on(fids, cuda), _on(cids, cuda)
    monkeypatch.setattr(B, "kernel_library", broken)
    n0 = (CT.fused_compact_decode.launches, CT.compact_global.launches)
    with pytest.raises(B.KernelError, match="cannot load"):
        CT.fused_compact_decode(w, f, c, budget)
    with pytest.raises(B.KernelError, match="cannot load"):
        CT.compact_global(w, budget)
    assert (CT.fused_compact_decode.launches, CT.compact_global.launches) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_matcher_runs_the_tail_kernels_on_cuda(cuda, fused, monkeypatch):
    """The matcher's global modes compact through the tail kernels, one
    launch a bucket, and equal the CPU matcher; ``use_kernel = False`` runs
    the twins and launches none."""
    if not fused:
        monkeypatch.setenv("RMQTT_FUSED", "0")
    rng = random.Random(5)
    filters = gen_mixed(rng, 2000)
    tables = [TP.PartitionedTable(), TP.PartitionedTable()]
    for t in tables:
        for f in filters:
            t.add(f)
    ms = [TP.PartitionedMatcher(tables[0], device=cuda),
          TP.PartitionedMatcher(tables[1], device="cpu")]
    topics = gen_topics_uniform(rng, 1100)
    counter = CT.fused_compact_decode if fused else CT.compact_global
    for batch in (topics, topics[:1], topics[:4]):
        n0 = counter.launches
        got, want = (m.match(batch) for m in ms)
        assert counter.launches > n0
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    ms[0].use_kernel = False
    n0 = counter.launches
    got = ms[0].match(topics)
    assert counter.launches == n0
    assert [g.tolist() for g in got] == [w.tolist() for w in ms[1].match(topics)]


# ------------------------------------------- the dense backend, the mesh
@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c.name for c in DENSE_CASES])
def test_dense_kernels_equal_plain_on_cuda(cuda, case):
    """Both dense full-scan kernels against their twins on
    ``bench/dense_cases.py``'s cases (B of 1 and 3, capacity 1,024, two
    blocks of topics, L of 9, 20 and 40, padded topics and filters, $SYS
    rows and topics, a bare '#', '+/#', blank levels)."""
    inp = make_dense_case(case)
    fwd, inv = as_tensors(inp.forward, cuda), as_tensors(inp.inverse, cuda)
    n0 = DM.match_packed.launches, DM.match_retained.launches
    got_f, got_i = DM.match_packed(*fwd), DM.match_retained(*inv)
    torch.cuda.synchronize()
    assert (DM.match_packed.launches, DM.match_retained.launches) == (n0[0] + 1, n0[1] + 1)
    want_f, want_i = DM.match_packed_plain(*fwd), DM.match_retained_plain(*inv)
    assert torch.equal(got_f, want_f) and bool((want_f != 0).any())
    assert torch.equal(got_i, want_i) and bool((want_i != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,deep", [(31, 0), (33, 0), (100, 0), (200, 0), (333, 0), (40, 12),
                                    (150, 12), (100, 20), (70, 40)])
def test_dense_forward_ragged_topic_tile_on_cuda(cuda, b, deep):
    """The forward kernel against its twin on batches that are no multiple
    of its topic tile (32 T topics a warp: T = 8 at up to 8 levels, 4 at up
    to 16, 2 past them, and the least power of two >= ceil(B / 32) below
    that), unpadded, on a 3,000-filter table."""
    case = DenseCase(f"B={b}, L={deep or 'table'}", 3000, b, b, deep)
    fwd = as_tensors(make_dense_case(case).forward, cuda)
    got = DM.match_packed(*fwd)
    torch.cuda.synchronize()
    want = DM.match_packed_plain(*fwd)
    assert torch.equal(got, want) and bool((want != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("wc", WORDS_CASES, ids=[w.name for w in WORDS_CASES])
def test_dense_words_kernel_equals_plain_on_cuda(cuda, wc):
    """The words kernel against ``match_words_plain`` on the forward
    kernel's bitmaps of ``bench/dense_cases.py``'s words cases: word
    indices, bits and counts ``torch.equal``, one launch."""
    inp = make_words_case(wc)
    packed = DM.match_packed(*as_tensors(inp.forward, cuda))
    n0 = DM.match_words.launches
    got = DM.match_words(packed, wc.max_words)
    torch.cuda.synchronize()
    assert DM.match_words.launches == n0 + 1
    for g, w in zip(got, DM.match_words_plain(packed, wc.max_words)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,density,max_words", [
    (5, 100, 0.1, 128), (9, 2048, 0.01, 128), (33, 512, 0.9, 128), (16, 1024, 0.002, 16),
    (2, 300, 0.3, 300)])
def test_dense_words_kernel_on_random_bitmaps_on_cuda(cuda, b, w, density, max_words):
    """Random words of every bit pattern, an all-zero first topic, K below
    and at W."""
    rng = np.random.default_rng(b * 1000 + w)
    vals = rng.integers(-2**31, 2**31, size=(b, w), dtype=np.int64)
    vals[vals == 0] = 1
    bits = np.where(rng.random((b, w)) < density, vals, 0).astype(np.int32)
    bits[0] = 0
    packed = torch.from_numpy(bits).to(cuda)
    for k in (max_words, 1, w):
        got = DM.match_words(packed, k)
        torch.cuda.synchronize()
        for g, want in zip(got, DM.match_words_plain(packed, k)):
            assert torch.equal(g, want)


@pytest.mark.cuda
def test_match_words_raises_when_the_library_fails(cuda, monkeypatch):
    """Given a CUDA bitmap ``match_words`` launches its kernel or raises: a
    library that does not load raises ``KernelError`` and nothing runs the
    twin instead; a bitmap the kernel does not take (not int32, not
    contiguous, W not a multiple of 4, a start off 16-byte alignment) is
    refused first."""
    import rmqtt_tpu_torch.ops._build as B

    def broken():
        raise B.KernelError("cannot load the kernel library")

    packed = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        DM.match_words(packed.to(torch.int64), 8)
    with pytest.raises(ValueError, match="contiguous"):
        DM.match_words(packed.t(), 8)
    with pytest.raises(ValueError, match="W % 4"):
        DM.match_words(packed[:, :63].contiguous(), 8)
    with pytest.raises(ValueError, match="aligned"):
        DM.match_words(packed.reshape(-1)[1:241].view(4, 60), 8)
    monkeypatch.setattr(B, "kernel_library", broken)
    n0 = DM.match_words.launches
    with pytest.raises(B.KernelError, match="cannot load"):
        DM.match_words(packed, 8)
    assert DM.match_words.launches == n0


def _random_words(rng, b, w, density):
    """``[b, w]`` int32 words: every bit pattern, ``density`` of them
    nonzero, an all-zero first topic and a second with ``w / 2`` nonzero
    words."""
    vals = rng.integers(-2**31, 2**31, size=(b, w), dtype=np.int64)
    vals[vals == 0] = 1
    bits = np.where(rng.random((b, w)) < density, vals, 0).astype(np.int32)
    bits[0] = 0
    if b > 1:
        bits[1, :w // 2] = -1
    return bits


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,density", [
    (70, 4, 0.3), (33, 8, 0.2), (9, 16, 0.1), (40, 32, 0.05), (5, 64, 0.05),
    (16384, 128, 0.02), (1, 128, 0.02), (8, 128, 0.02), (3, 256, 0.01), (9, 2048, 0.002)])
def test_compact_words_kernel_on_random_words_on_cuda(cuda, b, w, density):
    """The topk mode's ``compact_words`` kernel against its twin on random
    words, at each lane group the launch picks (1, 2, 4, 8, 16 and 32 lanes
    a topic for W = 4 ... 128; the warp-a-topic kernel past 128), K below,
    at and above W, the regrow's 64: the wire and the three arrays
    ``torch.equal``, one launch a call."""
    words = torch.from_numpy(_random_words(np.random.default_rng(b + w), b, w,
                                           density)).to(cuda)
    for k in sorted({1, 32, 64, w, w + 5}):
        n0 = CT.compact_words.launches
        wire = CT.compact_words(words, k)
        torch.cuda.synchronize()
        assert CT.compact_words.launches == n0 + 1
        assert torch.equal(wire, CT.topk_wire_plain(words, k))
        for g, want in zip(CT.split_topk_wire(wire, b, min(k, w)),
                           CT.match_words_plain(words, k)):
            assert torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", [(16384, 128), (8, 32), (1, 4), (4, 2048)])
def test_compact_words_one_kernel_a_call_on_cuda(cuda, b, w):
    """One call of ``compact_words`` on the card is one kernel and nothing
    else (``torch.profiler``): no sort, no top-k, no concatenation."""
    from rmqtt_tpu_torch.bench.tail_kernels import ops_per_call

    words = torch.from_numpy(_random_words(np.random.default_rng(w), b, w, 0.02)).to(cuda)
    ops = ops_per_call(lambda: CT.compact_words(words, 32))
    assert (ops["kernels"], ops["memsets"]) == (1, 0), ops


@pytest.mark.cuda
def test_compact_words_refuses_and_raises_on_cuda(cuda, monkeypatch):
    """Given CUDA words ``compact_words`` launches its kernel or raises:
    words the kernel does not take (not int32, not contiguous, W not a
    multiple of 4, a start off 16-byte alignment) are refused first, and a
    library that does not load raises ``KernelError`` with nothing run in
    its place."""
    import rmqtt_tpu_torch.ops._build as B

    def broken():
        raise B.KernelError("cannot load the kernel library")

    words = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        CT.compact_words(words.to(torch.int64), 8)
    with pytest.raises(ValueError, match="contiguous"):
        CT.compact_words(words.t(), 8)
    with pytest.raises(ValueError, match="W % 4"):
        CT.compact_words(words[:, :62].contiguous(), 8)
    with pytest.raises(ValueError, match="aligned"):
        CT.compact_words(words.reshape(-1)[1:241].view(4, 60), 8)
    monkeypatch.setattr(B, "kernel_library", broken)
    n0 = CT.compact_words.launches
    with pytest.raises(B.KernelError, match="cannot load"):
        TP._topk_wire(words, 8)
    assert CT.compact_words.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("b,deep", [(1, 0), (2, 0), (33, 0), (64, 0), (33, 12), (5, 40)])
def test_dense_inverse_on_ragged_tables_on_cuda(cuda, b, deep):
    """The redesigned inverse (rows on lanes: 32 x 4 warps x 4 rows a block
    at up to 8 levels, x 2 at up to 16, x 1 past) against its twin at B = 1,
    2, 33 and 64 over tables whose row count is no multiple of a block's
    rows (the case's rows cut by three words), and at L = 12 and 40."""
    case = DenseCase(f"B={b}, L={deep or 'table'}", 700, b, b, deep)
    rtok, rlen, rdollar, *batch = as_tensors(make_dense_case(case).inverse, cuda)
    cut = (rtok.shape[0] // 32 - 3) * 32
    args = (rtok[:cut].contiguous(), rlen[:cut].contiguous(), rdollar[:cut].contiguous(),
            *batch)
    n0 = DM.match_retained.launches
    got = DM.match_retained(*args)
    torch.cuda.synchronize()
    assert DM.match_retained.launches == n0 + 1
    want = DM.match_retained_plain(*args)
    assert torch.equal(got, want) and bool((want != 0).any())


def _routed(rows):
    return [sorted(r.topic_filter for rels in out.values() for r in rels)
            + sorted(tf for _g, tf in shared) for out, shared in rows]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["bitmap", "words"])
def test_dense_router_on_cuda_equals_partitioned(cuda, path, monkeypatch):
    """``TorchRouter(backend="dense")`` on the card routes as
    ``backend="partitioned"`` does: a batch of 512, small batches, and
    after churn (one delta upload); the words path forced with
    ``COMPACT_BITMAP_BYTES = 0`` (max_matches 8, so that topics overflow
    to the bitmap path)."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    if path == "words":
        monkeypatch.setattr(DM, "COMPACT_BITMAP_BYTES", 0)
    dense = TorchRouter(device=cuda, backend="dense")
    part = TorchRouter(device=cuda)
    dense.matcher.max_matches = 8
    rng = random.Random(4)
    filters = gen_mixed(rng, 3000)
    opts = SubscriptionOptions()
    for r in (dense, part):
        for i, f in enumerate(filters):
            r.add(f, Id(1, f"c{i}"), opts)
    topics = gen_topics_uniform(rng, 512)
    n0 = DM.match_packed.launches
    for batch in (topics, topics[:1], topics[:8]):
        items = [(None, t) for t in batch]
        assert _routed(dense.matches_batch_raw(items)) == \
            _routed(part.matches_batch_raw(items))
    assert DM.match_packed.launches >= n0 + 3
    for r in (dense, part):
        for i, f in enumerate(filters[:200]):
            r.remove(f, Id(1, f"c{i}"))
        for j, f in enumerate(gen_mixed(random.Random(5), 200)):
            r.add(f, Id(1, f"n{j}"), opts)
    items = [(None, t) for t in topics]
    assert _routed(dense.matches_batch_raw(items)) == _routed(part.matches_batch_raw(items))
    m = dense.matcher
    assert (m.full_uploads, m.delta_uploads) == (1, 1)


@pytest.mark.cuda
def test_dense_retained_scanner_on_cuda_equals_cpu(cuda):
    rng = random.Random(6)
    topics = gen_retained_topics(rng, 4000)
    tables = [TE.FilterTable(), TE.FilterTable()]
    for t in tables:
        for topic in topics:
            t.add(topic)
    filters = retained_sub_filters(random.Random(5), 64)
    n0 = DM.match_retained.launches
    got = DR.RetainedScanner(tables[0], device=cuda).scan(filters)
    want = DR.RetainedScanner(tables[1], device="cpu").scan(filters)
    assert DM.match_retained.launches == n0 + 1
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert sum(len(w) for w in want) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "unfused", "topk"])
def test_sharded_partitioned_on_cuda_equals_local(cuda, mode):
    """``ShardedPartitionedMatcher`` over ``[cuda:0] x 2`` (dp=2: the code
    path, not multi-card scaling) equals the local matcher, launching the
    legacy words kernel once a device; ``ShardedMatcher`` over the same
    list at fp=2 equals ``DenseMatcher``'s bitmap and counts."""
    table = TP.PartitionedTable()
    rng = random.Random(7)
    for f in gen_mixed(rng, 3000):
        table.add(f)
    topics = gen_topics_uniform(rng, 600)
    mesh = make_mesh([cuda, cuda], dp=2)
    sm = ShardedPartitionedMatcher(table, mesh, compact="topk" if mode == "topk" else None)
    if mode == "unfused":
        sm._fused = False
    local = TP.PartitionedMatcher(table, device=cuda)
    n0 = MW.match_words_legacy.launches
    for batch in (topics, topics[:1], topics[:8]):
        got, want = sm.match(batch), local.match(batch)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert MW.match_words_legacy.launches == n0 + 6
    assert sm.fused_batches == (3 if mode == "fused" else 0)
    dt = TE.FilterTable()
    for f in gen_mixed(random.Random(8), 2000):
        dt.add(f)
    ttok, tlen, td = dt.encode_topics(topics[:512])
    sh = ShardedMatcher(dt, make_mesh([cuda, cuda], dp=1, fp=2))
    packed, counts = sh.assemble(sh.match_encoded(ttok, tlen, td))
    want = DM.DenseMatcher(dt, device=cuda).match_encoded(ttok, tlen, td).cpu().numpy()
    assert np.array_equal(packed, want)
    assert np.array_equal(counts, np.unpackbits(want.view(np.uint8), axis=1).sum(1))


@pytest.mark.cuda
def test_mesh_router_on_cuda(cuda, monkeypatch):
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    mesh_r = TorchRouter(mesh=make_mesh([cuda, cuda], dp=2))
    local = TorchRouter(device=cuda)
    assert isinstance(mesh_r.matcher, ShardedPartitionedMatcher)
    rng = random.Random(9)
    opts = SubscriptionOptions()
    for i, f in enumerate(gen_mixed(rng, 2000)):
        mesh_r.add(f, Id(1, f"c{i}"), opts)
        local.add(f, Id(1, f"c{i}"), opts)
    items = [(None, t) for t in gen_topics_uniform(rng, 300)]
    assert _routed(mesh_r.matches_batch_raw(items)) == _routed(local.matches_batch_raw(items))
    assert mesh_r.device_hbm()["replicas"] == 2


@pytest.mark.cuda
def test_dense_matcher_raises_when_the_library_fails(cuda, monkeypatch):
    """Given CUDA tensors the dense wrappers launch or raise: a library
    that does not load makes ``DenseMatcher`` and ``RetainedScanner``
    raise, and nothing runs the twins instead."""
    import rmqtt_tpu_torch.ops._build as B

    def broken():
        raise B.KernelError("cannot load the kernel library")

    table = TE.FilterTable()
    for f in ("a/+", "a/#", "#"):
        table.add(f)
    m = DM.DenseMatcher(table, device=cuda)
    sc = DR.RetainedScanner(table, device=cuda)
    monkeypatch.setattr(B, "kernel_library", broken)
    n0 = DM.match_packed.launches, DM.match_retained.launches
    with pytest.raises(B.KernelError, match="cannot load"):
        m.match(["a/b"])
    with pytest.raises(B.KernelError, match="cannot load"):
        sc.scan(["a/+"])
    assert (DM.match_packed.launches, DM.match_retained.launches) == n0


@pytest.mark.cuda
def test_broker_on_cuda_equals_default_router(cuda, monkeypatch):
    """An in-process broker on ``TorchRouter`` on the card with the hybrid
    off (every batch on the device): 2K filters over 8 subscribers, 1K QoS 0
    publishes from 4 publishers, deliveries equal to the oracle's."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    rng = random.Random(3)
    filters = gen_mixed(rng, 2000)
    subs = {f"s{k}": filters[k::8] for k in range(8)}
    topics = gen_topics_uniform(rng, 1000)
    payloads = [b"p%d" % i for i in range(len(topics))]
    want = expected_deliveries(oracle_router(subs), topics, payloads)
    assert sum(want.values()) > 1000

    async def run():
        router = TorchRouter(device=cuda)
        broker = MqttBroker(ServerContext(BrokerConfig(port=0), router=router))
        await broker.start()
        try:
            subscribers = await connect_and_subscribe(broker.port, subs)
            pubs = [await LoadClient.connect(broker.port, f"p{k}") for k in range(4)]
            n0, f0 = MW.match_words_packed.launches, router.matcher.fused_batches
            got, _secs = await publish_wave(pubs, subscribers, topics, payloads,
                                            want, timeout=60.0)
            launched = MW.match_words_packed.launches - n0
            fused = router.matcher.fused_batches - f0
            st = broker.ctx.routing.stats()
            for c in [*subscribers, *pubs]:
                await c.close()
            return got, launched, fused, st
        finally:
            await broker.stop()

    got, launched, fused, st = asyncio.run(asyncio.wait_for(run(), timeout=120.0))
    assert got == want
    assert launched > 0 and fused > 0
    assert st["routing_failover_state"] == 0 and st["routing_failovers"] == 0


@pytest.mark.cuda
def test_kernel_build_failure_refuses_the_start(cuda, tmp_path, monkeypatch):
    """A words kernel source that does not build refuses the router and the
    broker's ``--router xla`` context at construction, before any publish."""
    import rmqtt_tpu_torch.ops._build as B

    bad = tmp_path / "match_words.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(B, "SOURCES", (bad,))
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(B, "_LOADED", None)
    with pytest.raises(B.KernelError, match="nvcc failed"):
        TorchRouter(device=cuda)
    with pytest.raises(B.KernelError, match="nvcc failed"):
        ServerContext(BrokerConfig(router="xla"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", RETAINED_CASES, ids=[c.name for c in RETAINED_CASES])
def test_retained_kernels_equal_plain_on_cuda(cuda, case):
    """Random tiles: NC of 1 and 33, B of 1 and 3, chunk 0 as padding and
    repeated, int32 tiles, every level range. Out-of-range ids give zero
    words."""
    tiles, fields, ids, bad, plain_ids = make_retained_case(case)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = [put(a) for a in (tiles, *fields)]
    counter = RP.retained_scan_gather if case.tier == "gather" else RP.retained_scan_full
    n0 = counter.launches
    if case.tier == "gather":
        got = RP.retained_scan_gather(*args, put(ids))
        want = RP.retained_scan_words_plain(*args, put(plain_ids))
    else:
        got = RP.retained_scan_full(*args)
        want = RP.retained_scan_full_plain(*args)
    if bad is not None:
        badw = put(np.repeat(bad, RP.WORDS_PER_CHUNK, axis=1))
        assert not bool(got[badw].any())
        want = torch.where(badw, torch.zeros_like(want), want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want != 0).any())
    assert counter.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dollar", "wide"])
def test_retained_kernels_on_real_topics_on_cuda(cuda, kind):
    """Tables of real topics: $SYS rows against wildcard-first filters, a
    bare '#', '+/#', filters deeper than max_levels; int32 tiles past a
    0x7FFF vocabulary. Both tiers, NC of the longest list, 33 and 1."""
    table = RP.RetainedTable()
    for t in table_topics(kind, np.random.default_rng(4)):
        table.add(t)
    cpu = RP.PartitionedRetainedScanner(table, device="cpu")
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    for nc in (None, 33, 1):
        tiles, gather, full = table_inputs(cpu, TABLE_FILTERS, nc)
        assert tiles.dtype == (np.int32 if kind == "wide" else np.int16)
        args = [put(a) for a in (tiles, *gather)]
        assert torch.equal(RP.retained_scan_gather(*args),
                           RP.retained_scan_words_plain(*args))
        args = [put(a) for a in (tiles, *full)]
        assert torch.equal(RP.retained_scan_full(*args), RP.retained_scan_full_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_retained_kernels_refuse_unaligned_tiles_on_cuda(cuda, dtype):
    """The kernels read tile rows in 16-byte loads: both wrappers refuse a
    view of the tiles that starts off a 16-byte boundary, launching
    nothing, and run on one that starts on it."""
    tiles, fields, ids, _bad, _pids = make_retained_case(RETAINED_CASES[2])
    tiles = tiles.astype(dtype)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    fargs = [put(a) for a in fields]
    flat = torch.zeros(tiles.size + 16, dtype=put(tiles).dtype, device=cuda)
    step = 16 // tiles.itemsize  # elements in 16 bytes
    for off in (1, step):
        view = flat[off:off + tiles.size].view(tiles.shape)
        view.copy_(put(tiles))
        n0 = RP.retained_scan_gather.launches + RP.retained_scan_full.launches
        if view.data_ptr() % 16:
            with pytest.raises(ValueError, match="16-byte"):
                RP.retained_scan_gather(view, *fargs, put(ids))
            with pytest.raises(ValueError, match="16-byte"):
                RP.retained_scan_full(view, *fargs)
            assert RP.retained_scan_gather.launches + RP.retained_scan_full.launches == n0
        else:
            assert torch.equal(RP.retained_scan_gather(view, *fargs, put(ids)),
                               RP.retained_scan_words_plain(view, *fargs, put(ids)))
            assert torch.equal(RP.retained_scan_full(view, *fargs),
                               RP.retained_scan_full_plain(view, *fargs))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_retained_scanner_on_cuda_equals_cpu(cuda):
    """cfg5's draw (20K) and the subscriber mix through the scanner on the
    card and on the CPU: identical fid arrays, both tiers launched."""
    topics = gen_retained_topics(random.Random(7), 20_000)
    filters = retained_sub_filters(random.Random(5), 256)
    res = []
    for dev in (cuda, "cpu"):
        table = RP.RetainedTable()
        for t in topics:
            table.add(t)
        scanner = RP.PartitionedRetainedScanner(table, device=dev)
        res.append([r for lo in range(0, 256, 64) for r in scanner.scan(filters[lo:lo + 64])])
    n = RP.retained_scan_gather.launches, RP.retained_scan_full.launches
    assert all(np.array_equal(a, b) for a, b in zip(*res))
    assert sum(len(r) for r in res[1]) > 10_000 and min(n) > 0


@pytest.mark.cuda
def test_retained_kernel_build_failure_refuses_the_scanner(cuda, tmp_path, monkeypatch):
    """A retained-scan source that does not build refuses the scanner and a
    broker with ``[retain] tpu = true`` at construction."""
    import rmqtt_tpu_torch.ops._build as B

    bad = tmp_path / "retained_scan.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(B, "SOURCES", (B.SOURCES[0], bad))
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(B, "_LOADED", None)
    with pytest.raises(B.KernelError, match="nvcc failed"):
        RP.PartitionedRetainedScanner(RP.RetainedTable(), device=cuda)
    with pytest.raises(B.KernelError, match="nvcc failed"):
        ServerContext(BrokerConfig(retain_tpu=True))


@pytest.mark.cuda
def test_broker_retained_replay_on_cuda(cuda):
    """An in-process broker with ``retain_tpu`` on the card (threshold 100):
    600 retained messages, 16 subscribers of the mix, the replay equal to
    the RetainTree oracle and served by the retained kernels."""
    from rmqtt_tpu_torch.core.trie import RetainTree

    topics = gen_retained_topics(random.Random(9), 600)
    filters = retained_sub_filters(random.Random(5), 16) + ["+/#", "#"]
    payloads = [b"r%d" % i for i in range(len(topics))]
    oracle = RetainTree()
    for i, t in enumerate(topics):
        oracle.insert(t, i)
    want = collections.Counter()
    for j, f in enumerate(filters):
        for _lv, i in oracle.matches(f):
            want[(f"s{j}", topics[i], payloads[i])] += 1

    async def run():
        broker = MqttBroker(ServerContext(BrokerConfig(
            port=0, retain_tpu=True, retain_tpu_threshold=100)))
        await broker.start()
        try:
            pub = await LoadClient.connect(broker.port, "pub")
            for i, (t, p) in enumerate(zip(topics, payloads)):
                pub.publish(t, p, retain=True)
                if i % 256 == 255:
                    # paced: a connection a socket buffer ahead of the
                    # broker stalls on the card's host (PERF.md §7)
                    await pub.ping()
            await pub.ping()
            while broker.ctx.retain.count() < len(topics):
                await asyncio.sleep(0.05)
            n0 = RP.retained_scan_gather.launches + RP.retained_scan_full.launches
            subs = [await LoadClient.connect(broker.port, f"s{j}")
                    for j in range(len(filters))]
            for c, f in zip(subs, filters):
                await c.subscribe([f])
            per = collections.Counter()
            for (cid, _t, _p), k in want.items():
                per[cid] += k
            await asyncio.gather(*(c.wait_count(per[c.client_id], 60.0) for c in subs))
            await asyncio.sleep(0.3)
            got = collections.Counter((c.client_id, t, p) for c in subs
                                      for t, p, _ts in c.received)
            launched = RP.retained_scan_gather.launches + RP.retained_scan_full.launches - n0
            for c in [pub, *subs]:
                await c.close()
            return got, launched, broker.ctx.retain.scans
        finally:
            await broker.stop()

    got, launched, scans = asyncio.run(asyncio.wait_for(run(), timeout=120.0))
    assert got == want and sum(want.values()) > 1000
    assert launched >= len(filters) and scans == len(filters)


@pytest.mark.cuda
def test_plugin_broker_restart_on_cuda(cuda, tmp_path, monkeypatch):
    """The retainer plugin's store (3,000 messages, written by a broker on
    the host trie) loads at start into a broker with ``retain_tpu`` on the
    card (threshold 100): a ``#`` (past 16 candidate chunks: the full-stream
    kernel) and a narrow SUBSCRIBE (the gather kernel) replay equal to
    ``RetainTree``; a filter the
    auto-subscription plugin adds at CONNECT routes through the words
    kernel with every batch on the card."""
    from rmqtt_tpu_torch.broker.fitter import FitterConfig
    from rmqtt_tpu_torch.core.trie import RetainTree
    from rmqtt_tpu_torch.plugins.auto_subscription import AutoSubscriptionPlugin
    from rmqtt_tpu_torch.plugins.retainer import RetainerPlugin

    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    store = {"path": str(tmp_path / "retainer.db")}
    topics = gen_retained_topics(random.Random(11), 3000)
    payloads = [b"r%d" % i for i in range(len(topics))]
    filters = ["#", "/".join(topics[0].split("/")[:2]) + "/#"]
    oracle = RetainTree()
    for i, t in enumerate(topics):
        oracle.insert(t, i)
    want = collections.Counter((f"s{j}", topics[i], payloads[i])
                               for j, f in enumerate(filters) for _lv, i in oracle.matches(f))

    async def write():
        broker = MqttBroker(ServerContext(BrokerConfig(port=0)))
        broker.ctx.plugins.register(RetainerPlugin(broker.ctx, store))
        await broker.start()
        try:
            pub = await LoadClient.connect(broker.port, "pub")
            for i, (t, p) in enumerate(zip(topics, payloads)):
                pub.publish(t, p, retain=True)
                if i % 256 == 255:
                    # paced: a connection a socket buffer ahead of the
                    # broker stalls on the card's host (PERF.md §7)
                    await pub.ping()
            await pub.ping()
            while broker.ctx.retain.count() < len(topics):
                await asyncio.sleep(0.05)
            await pub.close()
        finally:
            await broker.stop()

    async def restart():
        # the replay of '#' is enqueued at once: past the default queue of 1,000
        cfg = BrokerConfig(port=0, retain_tpu=True, retain_tpu_threshold=100,
                           fitter=FitterConfig(max_mqueue=100_000))
        ctx = ServerContext(cfg, router=TorchRouter(device=cuda), retain_device=cuda)
        ctx.plugins.register(RetainerPlugin(ctx, store))
        ctx.plugins.register(AutoSubscriptionPlugin(ctx, {"subscribes": [["inbox/%c", 0]]}))
        broker = MqttBroker(ctx)
        await broker.start()
        try:
            loaded = ctx.retain.count()
            g0, f0 = RP.retained_scan_gather.launches, RP.retained_scan_full.launches
            subs = [await LoadClient.connect(broker.port, f"s{j}") for j in range(len(filters))]
            for c, f in zip(subs, filters):
                await c.subscribe([f])
            per = collections.Counter()
            for (cid, _t, _p), k in want.items():
                per[cid] += k
            await asyncio.gather(*(c.wait_count(per[c.client_id], 60.0) for c in subs))
            await asyncio.sleep(0.3)
            got = collections.Counter((c.client_id, t, p) for c in subs
                                      for t, p, _ts in c.received)
            launched = (RP.retained_scan_gather.launches - g0,
                        RP.retained_scan_full.launches - f0)
            n0 = MW.match_words_packed.launches
            pub = await LoadClient.connect(broker.port, "pub")
            pub.publish("inbox/s1", b"auto")
            await pub.ping()
            await subs[1].wait_count(per["s1"] + 1, 30.0)
            inbox = subs[1].received[-1][:2]
            words = MW.match_words_packed.launches - n0
            st = ctx.routing.stats()
            for c in [pub, *subs]:
                await c.close()
            return loaded, got, launched, inbox, words, st
        finally:
            await broker.stop()

    asyncio.run(asyncio.wait_for(write(), timeout=60.0))
    loaded, got, launched, inbox, words, st = asyncio.run(
        asyncio.wait_for(restart(), timeout=120.0))
    assert loaded == len(topics)
    assert got == want and sum(want.values()) > len(topics)
    assert launched[0] > 0 and launched[1] > 0
    assert inbox == ("inbox/s1", b"auto") and words > 0
    assert st["routing_failover_host_routed"] == 0 and st["routing_failovers"] == 0


@pytest.mark.cuda
def test_native_encode_on_the_card_host_equals_python(cuda):
    """The card's host has g++ (nvcc needs it): the table encodes through
    ``NativeEncoder``, equal to ``_encode_py`` (group ids as partitions)."""
    from rmqtt_tpu_torch.runtime import NativeEncoder

    rng = random.Random(6)
    nat, py = TP.PartitionedTable(), TP.PartitionedTable()
    py._nenc = False
    for f in gen_mixed(rng, 2000):
        assert nat.add(f) == py.add(f)
    topics = gen_topics_uniform(rng, 500) + ["$SYS/a", "a//b", "a/b/", "ü/日本",
                                             "/".join(["d"] * 12)]
    for pad in (None, 512):
        got = nat.encode_topics(topics, pad_batch_to=pad, with_groups=True)
        want = py.encode_topics(topics, pad_batch_to=pad, with_groups=True)
        assert got[4] == want[4]
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        labels = [{}, {}]
        for a, b in zip(got[5], want[5]):
            assert (a == 0) == (b == 0)
            assert labels[0].setdefault(int(a), int(b)) == int(b)
            assert labels[1].setdefault(int(b), int(a)) == int(a)
    assert isinstance(nat._nenc, NativeEncoder)


@pytest.mark.cuda
def test_fetch_guard_on_cuda(cuda):
    """``RMQTT_FETCH_TIMEOUT``'s guarded copy, on a worker thread, equals
    the plain fetch, also for work queued on a side stream."""
    from rmqtt_tpu_torch.utils import devfetch

    x = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    want = devfetch.fetch(x * 3)
    side = torch.cuda.Stream()
    try:
        devfetch.set_fetch_timeout(60)
        assert np.array_equal(devfetch.fetch(x * 3, "guarded"), want)
        with torch.cuda.stream(side):
            y = torch.empty_like(x)
            side.wait_stream(torch.cuda.current_stream())
            torch.cuda._sleep(50_000_000)  # the copy must wait for this
            torch.mul(x, 3, out=y)
            got = devfetch.fetch(y, "side stream")
        assert np.array_equal(got, want)
    finally:
        devfetch.set_fetch_timeout(None)
        devfetch._loaded = False


def _free_ports(n: int) -> int:
    """The first of ``n`` consecutive free ports (``--workers`` gives
    worker i the cluster port base + i)."""
    import socket

    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            for k in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
    raise RuntimeError("no run of free ports")


@pytest.mark.cuda
def test_workers_on_cuda_deliver_across(cuda, tmp_path):
    """``python -m rmqtt_tpu_torch.broker --workers 2 --router xla`` without
    ``[fabric]``: two broadcast-cluster workers share one port, each with its
    own ``TorchRouter`` on the card. 3,000 filters over 8 subscribers (on
    both workers), 600 QoS 0 publishes from 4 publishers: the deliveries
    equal the oracle, and each worker's words kernel launched, since every
    publish is matched on each worker's own table."""
    import json
    import os
    import subprocess
    import sys
    import urllib.request

    rng = random.Random(4)
    filters = gen_mixed(rng, 3000)
    subs = {f"s{k}": filters[k::8] for k in range(8)}
    topics = gen_topics_uniform(rng, 600)
    payloads = [b"w%d" % i for i in range(len(topics))]
    want = expected_deliveries(oracle_router(subs), topics, payloads)
    port, http_port, cluster_base = _free_ports(1), _free_ports(1), _free_ports(2)
    cfg = tmp_path / "rmqtt.toml"
    cfg.write_text(f'[listener]\nhost = "127.0.0.1"\n[http_api]\nhost = "127.0.0.1"\n'
                   f"port = {http_port}\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RMQTT_HYBRID_MAX="0", PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    log = open(tmp_path / "workers.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rmqtt_tpu_torch.broker", "--router", "xla",
         "--port", str(port), "--config", str(cfg), "--workers", "2",
         "--cluster-port-base", str(cluster_base)],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=root)

    def stats():
        """{node id: gauges}, worker 1's own and its peer's."""
        url = f"http://127.0.0.1:{http_port}/api/v1/stats"
        with urllib.request.urlopen(url, timeout=30) as r:
            return {row["node"]: row["stats"] for row in json.loads(r.read())}

    async def run():
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 300.0
        while True:
            assert proc.poll() is None, (tmp_path / "workers.log").read_text()
            try:
                if len(await loop.run_in_executor(None, stats)) == 2:
                    break
            except OSError:
                pass
            assert loop.time() < deadline, "the workers never peered"
            await asyncio.sleep(0.2)
        clients = {cid: await LoadClient.connect(port, cid) for cid in subs}
        # subscribers on both workers: reconnect one until the kernel's
        # placement gives each worker some
        while min(s["connections"] for s in (await loop.run_in_executor(
                None, stats)).values()) == 0:
            assert loop.time() < deadline, "every subscriber on one worker"
            cid = rng.choice(list(clients))
            await clients[cid].close()
            clients[cid] = await LoadClient.connect(port, cid)
        await asyncio.gather(*(c.subscribe(list(subs[cid])) for cid, c in clients.items()))
        pubs = [await LoadClient.connect(port, f"p{k}") for k in range(4)]
        s0 = await loop.run_in_executor(None, stats)
        got, _secs = await publish_wave(pubs, list(clients.values()), topics, payloads,
                                        want, timeout=120.0)
        s1 = await loop.run_in_executor(None, stats)
        for c in [*clients.values(), *pubs]:
            await c.close()
        return got, {n: s1[n]["routing_kernel_launches_packed"]
                     - s0[n]["routing_kernel_launches_packed"] for n in s1}

    try:
        got, launched = asyncio.run(asyncio.wait_for(run(), timeout=420.0))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()
    assert got == want and sum(want.values()) > 600
    assert sorted(launched) == [1, 2] and all(n > 0 for n in launched.values())


@pytest.mark.cuda
def test_scenario_kill_profile_on_cuda(cuda, monkeypatch):
    """The scenario matrix's all-device profile ``storm_churn_overload_kill``
    through the port: a ``--router xla`` broker subprocess on the card
    (``RMQTT_HYBRID_MAX=0``, no routing cache) takes a connect storm,
    subscribe churn, a QoS 0 overload burst and a ``device.dispatch`` kill
    at once. Green by its own SLO engine, the kill failed over to the host
    and back to the device with every QoS 1 message delivered, and the
    broker's words kernel launched (its ``/api/v1/stats``, read just before
    the profile stops it). ``chip_smoke.py`` phase 6h runs the same."""
    from rmqtt_tpu_torch.bench import scenarios as SC

    stats = {}
    stop = SC.ScenarioBroker.stop

    async def stop_after_stats(broker):
        try:
            stats.update((await broker.api("/api/v1/stats"))[0]["stats"])
        finally:
            await stop(broker)

    monkeypatch.setattr(SC.ScenarioBroker, "stop", stop_after_stats)
    report = asyncio.run(asyncio.wait_for(
        SC.run_profile_async("storm_churn_overload_kill"), timeout=150.0))
    assert report["ok"] is True and report["errors"] == [], report
    assert [p["name"] for p in report["phases"]] == [
        "connect_storm", "subscribe_churn", "overload_burst", "failpoint_kill"]
    assert all(p["ok"] for p in report["phases"]), report["phases"]
    kill = report["phases"][-1]
    assert kill["failovers"] >= 1 and kill["triggers"] > 0
    assert kill["delivered"] == kill["published"]
    assert kill["failover_state"] == "device"
    assert report["latency"]["kernel.dispatch"]["count"] > 0
    assert stats["routing_kernel_launches_packed"] > 0
