"""Dense-backend parity: the port's ``FilterTable``, ``DenseMatcher``
(``ops/match.py``), ``RetainedScanner`` (``ops/retained.py``) and
``TorchRouter(backend="dense")`` against the JAX package's ``FilterTable``,
``TpuMatcher``, ``RetainedScanner`` and ``XlaRouter(backend="dense")`` on
the same inputs made with ``random`` seeds, all on the CPU (the wrappers
run their plain twins there). Bitmaps compare bit for bit (a uint32 view),
rows to the ``match_filter`` oracle too. The kernels against these twins
on a card: ``tests/test_torch_cuda.py``."""

import random

import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.encode as JE
import rmqtt_tpu.ops.match as JM
import rmqtt_tpu.ops.retained as JR
import rmqtt_tpu_torch.ops.encode as TE
import rmqtt_tpu_torch.ops.match as TM
import rmqtt_tpu_torch.ops.retained as TR
from rmqtt_tpu.core.topic import filter_valid, match_filter
from rmqtt_tpu_torch.bench.dense_cases import (DENSE_CASES, NO_MATCH, WORDS_CASES, as_tensors,
                                               make_dense_case, make_words_case)
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter

WORDS = ["a", "b", "c", "", "+", "$SYS"]


def _filters(rng, n, deep_every=0):
    """Valid filters of 1-6 levels over ``WORDS`` ('$' first only, a third
    ending in '#'); every ``deep_every``-th one 9-11 levels deep."""
    out = []
    while len(out) < n:
        depth = rng.randint(9, 11) if deep_every and len(out) % deep_every == 1 \
            else rng.randint(1, 6)
        levels = [rng.choice(WORDS) for _ in range(depth)]
        levels = [lv if i == 0 or lv != "$SYS" else "b" for i, lv in enumerate(levels)]
        if rng.random() < 0.3:
            levels[-1] = "#"
        f = "/".join(levels)
        if filter_valid(f):
            out.append(f)
    return out


def _topics(rng, n):
    """Topics of 1-12 levels (deeper than the table), blank levels, $SYS
    and unknown levels."""
    words = ["a", "b", "c", "", "x"]
    out = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 12)))
           for _ in range(n - 3)]
    return out + ["$SYS/a", "$SYS", "a/b/c/a/b/c/a/b/c/a/b/c"]


def _oracle(live, topic):
    return sorted(fid for fid, f in live.items() if match_filter(f, topic))


def _u32(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _same_table(jt, tt):
    for name in ("tok", "flen", "prefix_len", "has_hash", "first_wild", "row_dollar"):
        a, b = getattr(jt, name), getattr(tt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (jt.capacity, jt.max_levels, jt.size, jt.version) == \
        (tt.capacity, tt.max_levels, tt.size, tt.version)
    assert jt._free == tt._free
    assert jt.delta._e == tt.delta._e and jt.delta.floor == tt.delta.floor
    assert jt.tokens._ids == tt.tokens._ids


@pytest.fixture(scope="module")
def tables():
    """Both packages' tables after the same 2,000 adds (some past 8 levels,
    past the 1,024-row minimum) and 300 removes → (jax, port, live)."""
    rng = random.Random(11)
    jt, tt = JE.FilterTable(), TE.FilterTable()
    live = {}
    for f in _filters(rng, 2000, deep_every=400):
        fid = jt.add(f)
        assert tt.add(f) == fid
        live[fid] = f
    for fid in rng.sample(sorted(live), 300):
        jt.remove(fid)
        tt.remove(fid)
        del live[fid]
    return jt, tt, live


def test_filter_table_array_for_array(tables):
    jt, tt, _live = tables
    assert tt.max_levels > 8 and tt.capacity > 1024
    _same_table(jt, tt)
    rng = random.Random(12)
    topics = _topics(rng, 40)
    for a, b in zip(jt.encode_topics(topics, pad_batch_to=64),
                    tt.encode_topics(topics, pad_batch_to=64)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    filters = _filters(rng, 30) + ["#", "+/#", "$SYS/#"]
    for a, b in zip(jt.encode_filters(filters, pad_batch_to=64),
                    tt.encode_filters(filters, pad_batch_to=64)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(KeyError):
        tt.remove(next(iter(set(range(tt.capacity)) - set(_live))))
    jt.force_full_refresh()
    tt.force_full_refresh()
    _same_table(jt, tt)


def test_match_encoded_and_compact_equal_tpu_matcher(tables):
    jt, tt, live = tables
    jm, tm = JM.TpuMatcher(jt, max_matches=16), TM.DenseMatcher(tt, device="cpu",
                                                                  max_matches=16)
    topics = _topics(random.Random(13), 61)
    ttok, tlen, td = tt.encode_topics(topics, pad_batch_to=64)
    want = _u32(jm.match_encoded(ttok, tlen, td))
    got = tm.match_encoded(ttok, tlen, td)
    assert got.dtype == torch.int32 and got.shape == (64, tt.capacity // 32)
    assert np.array_equal(_u32(got.numpy()), want)
    rows = TM.unpack_bitmap(got.numpy()[:61], nrows=tt.capacity)
    for topic, row in zip(topics, rows):
        assert row.tolist() == _oracle(live, topic), topic
    assert TM.match_packed.launches == 0  # the CPU runs the twin
    jids, jcn = (np.asarray(a) for a in jm.match_encoded_compact(ttok, tlen, td))
    tids, tcn = (a.numpy() for a in tm.match_encoded_compact(ttok, tlen, td))
    assert np.array_equal(jcn, tcn) and tcn[:61].max() > 16  # some overflow
    for j in range(64):
        n = min(int(tcn[j]), 16)
        assert np.array_equal(jids[j, :n], tids[j, :n])
        assert (tids[j, n:] == -1).all()


@pytest.mark.parametrize("path", ["bitmap", "words"])
def test_match_rows_equal_tpu_matcher(tables, path, monkeypatch):
    """``match`` on the bitmap path and on the words path (forced with
    ``COMPACT_BITMAP_BYTES = 0``, max_matches 16 so that topics overflow
    back through the bitmap path)."""
    jt, tt, live = tables
    if path == "words":
        monkeypatch.setattr(JM, "COMPACT_BITMAP_BYTES", 0)
        monkeypatch.setattr(TM, "COMPACT_BITMAP_BYTES", 0)
    jm, tm = JM.TpuMatcher(jt, max_matches=16), TM.DenseMatcher(tt, device="cpu",
                                                                  max_matches=16)
    topics = _topics(random.Random(14), 45)
    got, want = tm.match(topics), jm.match(topics)
    assert sum(len(r) > 16 for r in got) > 0
    for topic, g, w in zip(topics, got, want):
        assert np.array_equal(g, w) and g.tolist() == _oracle(live, topic), topic


def test_match_words_nonzero_entries_equal_jax(tables):
    """``match_words`` against ``match_words_impl``: ``word_idx``,
    ``word_bits`` and ``counts`` equal as whole arrays, the zero words that
    fill a topic's slots after its nonzero ones included (``lax.top_k``'s
    order: the lower index first)."""
    jt, tt, _live = tables
    jm, tm = JM.TpuMatcher(jt), TM.DenseMatcher(tt, device="cpu")
    ttok, tlen, td = tt.encode_topics(_topics(random.Random(15), 32))
    packed = tm.match_encoded(ttok, tlen, td)
    nnz = (packed != 0).sum(dim=1)
    w = packed.shape[1]
    for max_words in (8, w):  # topics past K; K = W, every zero word ranked
        wi, wb, cn = (a.numpy() for a in TM.match_words(packed, max_words))
        jwi, jwb, jcn = (np.asarray(a) for a in JM._match_words(
            *jm._refresh(), ttok, tlen, td, nchunks=jm._nchunks(), max_words=max_words))
        assert wi.dtype == wb.dtype == cn.dtype == np.int32
        assert np.array_equal(cn, jcn)
        assert np.array_equal(wi, jwi)
        assert np.array_equal(_u32(wb), jwb)
    assert bool((nnz > 8).any()) and bool((nnz < w).all())  # overflow, zero-filled slots


@pytest.mark.parametrize("wc", WORDS_CASES, ids=[w.name for w in WORDS_CASES])
def test_match_words_cases_equal_jax(wc):
    """``bench/dense_cases.py``'s words cases (the card's and ``chip_smoke.py``
    3d's) through ``match_words`` on CPU tensors and through the JAX
    ``_match_words`` on the same table and topics: whole arrays equal. The
    wrapper runs the twin on the CPU and launches nothing."""
    inp = make_words_case(wc)
    packed = TM.match_packed(*as_tensors(inp.forward, "cpu"))
    n0 = TM.match_words.launches
    wi, wb, cn = (a.numpy() for a in TM.match_words(packed, wc.max_words))
    assert TM.match_words.launches == n0
    jwi, jwb, jcn = (np.asarray(a) for a in JM._match_words(
        *inp.forward, nchunks=1, max_words=wc.max_words))
    assert np.array_equal(wi, jwi) and np.array_equal(_u32(wb), jwb)
    assert np.array_equal(cn, jcn)
    b, w = packed.shape
    k = min(wc.max_words, w)
    assert wi.shape == (b, k) and (k == w) == (wc.max_words >= w)
    nnz = (packed != 0).sum(dim=1).numpy()
    assert bool((nnz > k).any()) == wc.over_k
    real = wc.case.batch + len(wc.extra_topics)
    assert not nnz[real:].any()  # padded topics match nothing
    for j, topic in enumerate(inp.topics):
        if topic == NO_MATCH:
            assert nnz[j] == 0 and cn[j] == 0 and np.array_equal(wi[j], np.arange(k))


def test_overflow_falls_back(monkeypatch):
    """``tests/test_match.py``'s overflow case: 50 rows all matching one
    topic, max_matches 8, the words path forced."""
    monkeypatch.setattr(TM, "COMPACT_BITMAP_BYTES", 0)
    table = TE.FilterTable()
    for _ in range(50):
        table.add("a/#")  # duplicates are the router's concern
    (row,) = TM.DenseMatcher(table, device="cpu", max_matches=8).match(["a/b"])
    assert row.tolist() == list(range(50))


def test_churn_delta_uploads_and_growth_equal_jax():
    """Both matchers through the same churn: delta uploads while at most
    half the rows are dirty, a full upload on capacity growth and on a
    deep filter (levels growth); the counters and every match equal."""
    rng = random.Random(16)
    jt, tt = JE.FilterTable(), TE.FilterTable()
    jm, tm = JM.TpuMatcher(jt), TM.DenseMatcher(tt, device="cpu")
    live = {}
    topics = _topics(rng, 24)

    def add(f):
        fid = jt.add(f)
        assert tt.add(f) == fid
        live[fid] = f

    def check():
        for topic, g, w in zip(topics, tm.match(topics), jm.match(topics)):
            assert np.array_equal(g, w) and g.tolist() == _oracle(live, topic), topic
        assert (tm.uploads, tm.full_uploads, tm.delta_uploads, tm.upload_bytes) == \
            (jm.uploads, jm.full_uploads, jm.delta_uploads, jm.upload_bytes)

    for f in _filters(rng, 600):
        add(f)
    check()
    for step in range(3):  # small churn: one delta upload each
        for fid in rng.sample(sorted(live), 40):
            jt.remove(fid)
            tt.remove(fid)
            del live[fid]
        for f in _filters(rng, 40):
            add(f)
        check()
    assert tm.delta_uploads == 3 and tm.full_uploads == 1
    for f in _filters(rng, 700):  # past 1,024 rows: capacity growth
        add(f)
    check()
    add("a/b/c/a/b/c/a/b/c/a")  # ten levels: levels growth
    check()
    jt.force_full_refresh()
    tt.force_full_refresh()
    check()
    assert tm.full_uploads == 4 and tm.delta_uploads == 3


def test_retained_scanner_equals_jax():
    rng = random.Random(17)
    jt, tt = JE.FilterTable(), TE.FilterTable()
    stored = {}
    words = ["a", "b", "c", "", "$SYS"]
    while len(stored) < 1500:
        levels = [rng.choice(words) for _ in range(rng.randint(1, 10))]
        levels = [lv if i == 0 or lv != "$SYS" else "p" for i, lv in enumerate(levels)]
        topic = "/".join(levels)
        if topic not in stored.values():
            fid = jt.add(topic)
            assert tt.add(topic) == fid
            stored[fid] = topic
    filters = _filters(rng, 40) + ["#", "+/#", "+", "$SYS/#", "a/b/c/a/b/c/a/b/c/a/b/#",
                                   "x/#", "+/+/+/+/+/+/+/+/+/+/+"]
    js, ts = JR.RetainedScanner(jt), TR.RetainedScanner(tt, device="cpu")
    enc = tt.encode_filters(filters, pad_batch_to=64)
    assert np.array_equal(_u32(ts.scan_encoded(*enc).numpy()),
                          _u32(js.scan_encoded(*enc)))
    for f, g, w in zip(filters, ts.scan(filters), js.scan(filters)):
        want = sorted(fid for fid, t in stored.items() if match_filter(f, t))
        assert np.array_equal(g, w) and g.tolist() == want, f


@pytest.mark.parametrize("b", [1, 37])
def test_match_retained_plain_equals_jax(b):
    """The inverse's twin against the JAX ``match_retained_impl`` on the
    same encoded arrays: one filter (a SUBSCRIBE's shape) and a batch that
    is no multiple of 32, over 2,048 stored topics (some deeper than 8
    levels, $SYS among them) with free rows between them."""
    rng = random.Random(23 + b)
    jt = JE.FilterTable()
    words = ["a", "b", "c", "", "$SYS"]
    while jt.size < 1500:
        levels = [rng.choice(words) for _ in range(rng.randint(1, 10))]
        jt.add("/".join(lv if i == 0 or lv != "$SYS" else "p" for i, lv in enumerate(levels)))
    for fid in range(0, 1500, 9):
        jt.remove(fid)
    filters = (["+/#"] + _filters(rng, b))[:b]
    enc = jt.encode_filters(filters)
    rows = (jt.tok, jt.flen, jt.row_dollar)
    want = JM._match_retained(*rows, *enc, nchunks=max(1, jt.capacity // 1024))
    got = TM.match_retained_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (*rows, *enc)))
    assert got.shape == (b, jt.capacity // 32)
    assert np.array_equal(_u32(got.numpy()), _u32(want)) and bool((got != 0).any())


def test_dense_router_equals_xla_router(monkeypatch):
    """``TorchRouter(backend="dense", device="cpu")`` against
    ``XlaRouter(backend="dense")``, every batch on the matcher."""
    from rmqtt_tpu.router.base import Id as JId, SubscriptionOptions as JOpts
    from rmqtt_tpu.router.xla import XlaRouter

    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    rng = random.Random(18)
    tr = TorchRouter(backend="dense", device="cpu")
    jr = XlaRouter(backend="dense")
    assert isinstance(tr.matcher, TM.DenseMatcher)
    for i, f in enumerate(_filters(rng, 400)):
        tr.add(f, Id(1, f"c{i % 50}"), SubscriptionOptions())
        jr.add(f, JId(1, f"c{i % 50}"), JOpts())
    topics = _topics(rng, 30)
    items = [(None, t) for t in topics]

    def norm(rows):
        return [sorted((str(k), sorted(r.topic_filter for r in v)) for k, v in out.items())
                for out, _shared in rows]

    assert norm(tr.matches_batch_raw(items)) == norm(jr.matches_batch_raw(items))
    assert tr.last_match_was_device()
    assert tr.device_hbm()["tiles_bytes"] > 0
    assert tr.device_stats()["compactions"] == 0


def test_router_backend_and_mesh_arguments():
    from rmqtt_tpu_torch.parallel import make_mesh

    mesh = make_mesh([torch.device("cpu")] * 2, dp=2)
    with pytest.raises(ValueError, match="mesh is only supported"):
        TorchRouter(backend="dense", mesh=mesh)
    with pytest.raises(ValueError, match="mesh is only supported"):
        TorchRouter(device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="unknown backend"):
        TorchRouter(backend="sparse", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchRouter(backend="dense")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_wrappers_refuse_other_devices():
    meta = [torch.empty((64, 2), dtype=torch.int32, device="meta")] + [
        torch.empty((64,), dtype=torch.int32, device="meta")] * 4
    topics = [torch.empty((3, 2), dtype=torch.int32, device="meta")] + [
        torch.empty((3,), dtype=torch.int32, device="meta")] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        TM.match_packed(*meta, *topics)
    with pytest.raises(ValueError, match="unsupported device"):
        TM.match_retained(*meta[:3], *topics[:1], *meta[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        TM.match_words(torch.empty((3, 64), dtype=torch.int32, device="meta"), 8)
    assert TM.match_packed.launches == 0 and TM.match_retained.launches == 0
    assert TM.match_words.launches == 0


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c.name for c in DENSE_CASES])
def test_dense_cases_plain_twins_equal_oracle(case):
    """The card tests' and ``chip_smoke.py`` 3d's cases: both plain twins
    against the ``match_filter`` oracle row by row."""
    inp = make_dense_case(case)
    fwd = TM.match_packed(*as_tensors(inp.forward, "cpu")).numpy()
    inv = TM.match_retained(*as_tensors(inp.inverse, "cpu")).numpy()
    assert fwd.shape == (case.pad_to, inp.forward[0].shape[0] // 32)
    assert not fwd[case.batch:].any() and not inv[case.batch:].any()  # padding
    for topic, row in zip(inp.topics, TM.unpack_bitmap(fwd[:case.batch])):
        assert row.tolist() == _oracle(inp.filters, topic), topic
    for f, row in zip(inp.scanned, TM.unpack_bitmap(inv[:case.batch])):
        want = sorted(fid for fid, t in inp.stored.items() if match_filter(f, t))
        assert row.tolist() == want, f
