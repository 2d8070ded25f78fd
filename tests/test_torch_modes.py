"""The matcher's hand-selected modes against the JAX package on the CPU: the
unfused global path (``RMQTT_FUSED=0``), the topk mode
(``RMQTT_COMPACT=topk``) and segmented tables (``RMQTT_SEG_BYTES``), with
their device programs (``compact_global``, ``compact_words`` and the
``match_global`` family) array for array and their host decoders (native
and numpy) value for value. Both packages run on the CPU; the JAX matcher
takes its lax path. Every comparison is exact."""

import logging
import random

import jax
import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.compact_tail as CT
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.core.trie import TopicTree

_VOCAB = ["a", "b", "c", "d", "e", "f", "+"]


def _words(rng, b, w, density):
    bits = rng.random((b, w, 32)) < density
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(
        np.uint32)


def _t(words):
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("b,w,budget,density", [
    (1, 128, 256, 0.01),     # uint16 wire
    (7, 128, 16, 0.01),      # the budget overflows
    (64, 2048, 16384, 0.002),  # uint32 wire (w*32 = 65536)
    (64, 128, 256, 0.0),     # an all-zero batch
])
def test_compact_global_equals_jax(b, w, budget, density):
    words = _words(np.random.default_rng(b * w), b, w, density)
    want = np.asarray(jax.jit(JP.compact_global_impl, static_argnums=1)(words, budget))
    got = TP._unsigned(TP.compact_global(_t(words), budget).numpy())
    assert got.dtype == want.dtype and np.array_equal(got, want)
    n = int(want[budget:].sum())
    assert (n > budget) == (budget == 16) and (n == 0) == (density == 0.0)


def _compact_words_case(w, max_words):
    """9 topics of ``w`` words: an all-zero row, a row with ``w / 2``
    nonzero words (more than ``max_words`` where it is below that) and
    sparse random rows → (words, JAX's three arrays)."""
    rng = np.random.default_rng(w + max_words)
    words = _words(rng, 9, w, 0.05 if w <= 16 else 0.002)
    words[0] = 0
    words[1, : w // 2] = 0xFFFFFFFF
    want = jax.jit(JP.compact_words_impl, static_argnums=1)(words, max_words)
    return words, [np.asarray(j) for j in want]


@pytest.mark.parametrize("w,max_words", [(128, 4), (16, 32), (128, 128), (4, 1), (4, 4),
                                         (4, 9), (16, 3), (16, 16), (128, 32), (128, 200)])
def test_compact_words_equals_jax(w, max_words):
    """``kw`` below, at and above ``w`` (W = 4, 16 and 128), an all-zero row
    and a row with more nonzero words than ``kw``: the twin and the
    wrapper on CPU tensors give JAX's arrays bit for bit, word_idx in the
    zero slots too."""
    words, want = _compact_words_case(w, max_words)
    n0 = CT.compact_words.launches
    wire = TP.compact_words(_t(words), max_words)
    for got in (CT.split_topk_wire(wire, words.shape[0], min(w, max_words)),
                CT.match_words_plain(_t(words), max_words)):
        for j, g in zip(want, got):
            g = g.numpy().view(j.dtype)
            assert g.shape == j.shape and np.array_equal(g, j)
    assert CT.compact_words.launches == n0  # a CPU tensor runs the twin


@pytest.mark.parametrize("w,max_words", [(4, 8), (128, 32)])
def test_topk_wire_slices_equal_jax(w, max_words):
    """``_topk_wire``'s one int32 wire: its three slices are JAX's
    ``word_idx``, ``word_bits`` and ``counts``, with and without the
    kernel flag (the CPU runs the twin either way)."""
    words, want = _compact_words_case(w, max_words)
    b, kw = words.shape[0], min(w, max_words)
    for use_kernel in (True, False):
        wire = TP._topk_wire(_t(words), max_words, use_kernel)
        assert wire.dtype == torch.int32 and wire.numel() == 2 * b * kw + b
        for j, g in zip(want, CT.split_topk_wire(wire, b, kw)):
            g = g.numpy().view(j.dtype)
            assert g.shape == j.shape and np.array_equal(g, j)


def _filters(rng, n, seen):
    out = []
    while len(out) < n:
        levels = [rng.choice(_VOCAB) for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.3:
            levels[-1] = "#"
        f = "/".join(levels)
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def _topics(rng, n):
    return ["/".join(rng.choice("abcdefx") for _ in range(rng.randint(1, 6)))
            for _ in range(n - 1)] + ["$s/a"]


@pytest.mark.parametrize("packed", [True, False])
def test_match_global_family_equals_jax(packed):
    """``match_global`` / ``_grouped`` / ``_split`` and ``match_partitioned``
    against the JAX jitted compositions over one packed or legacy table."""
    rng = random.Random(3)
    jt = JP.PartitionedTable()
    for f in _filters(rng, 600, set()):
        jt.add(f)
    topics = _topics(rng, 30)
    ttok, tlen, tdollar, cids, _nc, groups = jt.encode_topics(
        topics, pad_batch_to=32, with_groups=True)
    lay = jt.packed_layout() if packed else None
    if packed:
        tiles = JP.pack_device_rows_packed(jt, lay)
        _, ttok = jt.translate_packed(ttok)
    else:
        tiles = JP.pack_device_rows(jt)
    t32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))  # noqa: E731
    tiles_t = torch.from_numpy(tiles)
    ins = (t32(ttok), t32(tlen), t32(tdollar))

    def same(got, want):
        want = np.asarray(want)
        got = TP._unsigned(got.numpy())
        return got.dtype == want.dtype and np.array_equal(got, want)

    want = JP._match_global(tiles, ttok, tlen, tdollar, cids, budget=256, layout=lay)
    got = TP.match_global(tiles_t, *ins, t32(cids), 256, lay)
    assert same(got.wire, want) and np.asarray(want)[256:].any()
    _, first, inv = np.unique(groups, return_index=True, return_inverse=True)
    want = JP._match_global_grouped(tiles, ttok, tlen, tdollar, cids[first],
                                    inv.astype(np.int32), budget=256, layout=lay)
    got = TP.match_global_grouped(tiles_t, *ins, t32(cids[first]),
                                  torch.from_numpy(inv.astype(np.int64)), 256, lay)
    assert same(got.wire, want)
    halves = [(ttok[:16], tlen[:16], tdollar[:16], cids[:16, :8]),
              (ttok[16:], tlen[16:], tdollar[16:], cids[16:])]
    want = JP._match_global_split(tiles, tuple(halves), (64, 128), layout=lay)
    wire, outs = TP.match_global_split(
        tiles_t, [tuple(t32(a) for a in h) for h in halves], (64, 128), lay)
    assert same(wire, want) and len(outs) == 2
    # one bucket on the 32-bit wire widens the whole concatenation
    wide = [TP.Unfused(torch.tensor([5, -3], dtype=torch.int16), None),
            TP.Unfused(torch.tensor([70000], dtype=torch.int32), None)]
    assert TP._cat_wires([u.wire for u in wide]).tolist() == [5, 65533, 70000]
    want = JP._match_partitioned(tiles, ttok, tlen, tdollar, cids, max_words=6,
                                 layout=lay)
    got = TP.match_partitioned(tiles_t, *ins, t32(cids), 6, lay).wire.numpy()
    k = (got.size - 32) // 64
    assert np.array_equal(got, np.concatenate(
        [np.asarray(a).reshape(-1).view(np.int32) for a in want])) and k == 6


def test_decoders_equal_jax():
    """The port's native and numpy decoders against the JAX package's, on
    the same routes and words, with an overlay and ``strict=False``."""
    rng = np.random.default_rng(5)
    b, bp, nc = 5, 8, 3
    cids = rng.integers(1, 6, (bp, nc)).astype(np.int32)
    fid_map = rng.permutation(6 * 128).astype(np.int64)
    cleared = fid_map.copy()  # one candidate chunk's rows cleared since
    cleared[cids[1, 0] * 128: cids[1, 0] * 128 + 128] = -1
    words = _words(rng, bp, nc * 4, 0.05)
    words[b:] = 0
    # routes of compact_global over those words (every set bit, no cleared row)
    wire = np.asarray(jax.jit(JP.compact_global_impl, static_argnums=1)(words, 512))
    cn = wire[512:].astype(np.int64)
    routes = wire[: int(cn.sum())]
    overlay = {int(r): 7000 + i for i, r in enumerate(
        (cids[0, 0] * 128 + np.arange(0, 128, 9)).tolist())}
    for kw in (3, nc * 4):
        wi, wb, _ = (np.asarray(a) for a in jax.jit(
            JP.compact_words_impl, static_argnums=1)(words, kw))
        want = JP._decode_batch(wi[:b], wb[:b], cids[:b], b, fid_map)
        for got in (TP._decode_batch(wi[:b], wb[:b], cids[:b], b, fid_map),
                    TP._numpy_decode(wi[:b], wb[:b], cids[:b], b, fid_map)):
            assert [g.tolist() for g in got] == [w.tolist() for w in want]
        for ov, strict in ((overlay, True), (None, False), (overlay, False)):
            fm = fid_map if strict else cleared
            want = JP._decode_batch(wi[:b], wb[:b], cids[:b], b, fm, ov, strict)
            got = TP._decode_batch(wi[:b], wb[:b], cids[:b], b, fm, ov, strict)
            assert [g.tolist() for g in got] == [w.tolist() for w in want]
    want = JP._decode_routes(routes, cn, cids, b, fid_map)
    for got in (TP._decode_routes(routes, cn, cids, b, fid_map),
                TP._numpy_decode_routes(routes, cn, cids, b, fid_map)):
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert sum(len(w) for w in want) == len(routes) > 0
    for ov, strict in ((overlay, True), (None, False), (overlay, False)):
        fm = fid_map if strict else cleared
        want = JP._decode_routes(routes, cn, cids, b, fm, ov, strict)
        got = TP._decode_routes(routes, cn, cids, b, fm, ov, strict)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    # a padded topic with routes, and a cleared row's -1 in strict mode,
    # fail loudly on both decoders of both packages
    bad = cn.copy()
    bad[b] = 1
    bad[0] -= 1
    for dec in (JP._decode_routes, TP._decode_routes, TP._numpy_decode_routes):
        with pytest.raises(AssertionError):
            dec(routes, bad, cids, b, fid_map)
    for dec in (JP._decode_routes, TP._decode_routes, TP._numpy_decode_routes):
        with pytest.raises(AssertionError):
            dec(routes, cn, cids, b, cleared)


class _Pair:
    """The same filters in a JAX and a port table, a matcher on each built
    under one environment, and the trie oracle."""

    def __init__(self, monkeypatch, env, filters, max_words=32):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        self.jt, self.tt = JP.PartitionedTable(), TP.PartitionedTable()
        for t in (self.jt, self.tt):
            t.compact_async = False
        self.jm = JP.PartitionedMatcher(self.jt, max_words=max_words)
        self.tm = TP.PartitionedMatcher(self.tt, device="cpu", max_words=max_words)
        for k in env:
            monkeypatch.delenv(k)
        self.tree = TopicTree()
        self.fid_of = {}
        for f in filters:
            self.add(f)

    def add(self, f):
        fid = self.jt.add(f)
        assert self.tt.add(f) == fid
        self.tree.insert(f, fid)
        self.fid_of[f] = fid

    def remove(self, f):
        fid = self.fid_of.pop(f)
        self.jt.remove(fid)
        self.tt.remove(fid)
        self.tree.remove(f, fid)

    def check(self, topics, jax=True):
        """The port's match equals the oracle's and (``jax``) the JAX
        matcher's."""
        got = self.tm.match(topics)
        want = self.jm.match(topics) if jax else got
        for topic, g, w in zip(topics, got, want):
            oracle = sorted(v for _lv, vs in self.tree.matches(topic) for v in vs)
            assert g.tolist() == w.tolist() == oracle, topic
        return got


# SEG_BYTES: 4 segments of 16 chunks over 64 padded chunks (packed 1,024 B
# a chunk, legacy int16 2,816 B), 3 of them live; topk stays one array
_MODES = {
    "unfused": {"RMQTT_FUSED": "0"},
    "topk": {"RMQTT_COMPACT": "topk"},
    "segmented_fused": {"RMQTT_SEG_BYTES": "12288"},
    "segmented_unfused": {"RMQTT_SEG_BYTES": "12288", "RMQTT_FUSED": "0"},
    "segmented_legacy": {"RMQTT_SEG_BYTES": "49152", "RMQTT_PACKED": "0"},
    "topk_past_seg_bytes": {"RMQTT_COMPACT": "topk", "RMQTT_SEG_BYTES": "12288"},
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_modes_equal_jax_and_oracle(monkeypatch, caplog, mode):
    """Each mode's ``match`` equals the JAX matcher's under the same
    environment and the trie oracle, through removes and adds (delta
    uploads into the segments), a compaction and growth past the resident
    capacity (a full rebuild)."""
    env = _MODES[mode]
    rng = random.Random(7)
    seen = set()
    caplog.set_level(logging.WARNING, logger="rmqtt_tpu_torch.ops")
    p = _Pair(monkeypatch, env, _filters(rng, 4000, seen))
    tm = p.tm
    topics = _topics(rng, 64)
    p.check(topics)
    seg = "SEG_BYTES" in str(env) and env.get("RMQTT_COMPACT") != "topk"
    st = tm._dev
    assert (st.segments is not None) == seg
    assert tm._fused is (False if mode in ("unfused", "segmented_unfused")
                         or "topk" in mode else None)
    if seg:
        assert len(st.segments) >= 3 and tm.hbm_breakdown()["segments"] == len(
            st.segments)
        live = [s for s in st.segments if s.base < p.tt.nchunks]
        assert len(live) >= 3
        assert (st.segments[0].fids is None) == (env.get("RMQTT_FUSED") == "0")
    if mode == "topk_past_seg_bytes":
        assert "cannot segment; keeping one device array" in caplog.text
    # churn: removes and adds, one delta upload
    d0, f0 = tm.delta_uploads, tm.full_uploads
    for f in rng.sample(sorted(p.fid_of), 150):
        p.remove(f)
    for f in _filters(rng, 150, seen):
        p.add(f)
    p.check(topics)
    assert (tm.delta_uploads, tm.full_uploads) == (d0 + 1, f0)
    # a compaction (new layout: full upload), then growth past the capacity
    for t in (p.jt, p.tt):
        t.compact()
    p.check(topics)
    up = tm._dev.up_chunks
    while p.tt.nchunks <= up:
        for f in _filters(rng, 400, seen):
            p.add(f)
    p.check(topics)
    assert tm.full_uploads == f0 + 2 and tm._dev.up_chunks > up
    if mode == "unfused":
        # a batch past SPLIT_MIN_BATCH takes the NC split (match_global_split;
        # held to the JAX function in test_match_global_family_equals_jax)
        big = _topics(rng, 1024)
        assert tm._split_plan(p.tt.encode_topics(big, 1024)[3], 1024) is not None
        p.check(big, jax=False)


@pytest.mark.parametrize("env", [{"RMQTT_FUSED": "0"}, {"RMQTT_COMPACT": "topk"}],
                         ids=["unfused", "topk"])
def test_handle_decodes_at_submit_time(monkeypatch, env):
    """A handle submitted before a remove and an add that reuses the freed
    row decodes to the submit-time fids, as the JAX matcher's does."""
    p = _Pair(monkeypatch, env, ["s/x/1", "s/x/2", "s/+/3", "s/x/#"])
    topics = ["s/x/1", "s/x/9"]
    row = p.tt._row_of_fid[p.fid_of["s/x/1"]]
    hj, ht = p.jm.match_submit(topics), p.tm.match_submit(topics)
    p.remove("s/x/1")
    p.add("s/x/9")
    assert p.tt._row_of_fid[p.fid_of["s/x/9"]] == row  # the freed row, reused
    want, got = p.jm.match_complete(hj), p.tm.match_complete(ht)
    assert [g.tolist() for g in got] == [w.tolist() for w in want] == [[0, 3], [3]]
    p.check(topics)  # and after: the new filter


def test_regrows_are_sticky(monkeypatch):
    """The topk ``max_words`` and the global budgets regrow when a batch
    needs more, stay grown, and the results stay exact."""
    filters = [f"r/{i}" for i in range(300)] + ["r/+", "#"]
    p = _Pair(monkeypatch, {"RMQTT_COMPACT": "topk"}, filters, max_words=1)
    got = p.check(["r/1", "r/+x", "r/299"])
    assert p.tm.max_words > 1 and [len(g) for g in got] == [3, 2, 3]
    q = _Pair(monkeypatch, {"RMQTT_FUSED": "0"}, filters)
    q.check(["r/1"] * 4)
    for k in list(q.tm._budgets):
        q.tm._budgets[k] = 2
    q.check(["r/7"] * 4)
    assert all(g > 2 for g in q.tm._budgets.values())


@pytest.mark.parametrize("compact", ["global", "topk"])
def test_upload_oom_segments_or_raises(monkeypatch, compact):
    """``torch.OutOfMemoryError`` on the whole-table upload: the global mode
    retries as segments on the same device; the topk mode raises the sizing
    ``RuntimeError``. Other exceptions are not caught."""
    tt = TP.PartitionedTable()
    for f in _filters(random.Random(2), 300, set()):
        tt.add(f)
    m = TP.PartitionedMatcher(tt, device="cpu", compact=compact)
    assert m._fused is (None if compact == "global" else False)
    real = TP.to_device
    calls = []

    def oom_once(arr, device):
        calls.append(arr.shape)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(arr, device)

    monkeypatch.setattr(TP, "to_device", oom_once)
    if compact == "topk":
        with pytest.raises(RuntimeError, match="cannot use segmented tables"):
            m.match(["a/b"])
        return
    want = sorted(fid for fid in range(300) if fid in tt._row_of_fid and
                  match_filter(tt._filter_of_fid(fid), "a/b"))
    assert m.match(["a/b"])[0].tolist() == want
    assert m._dev.segments is not None and m._seg_bytes == 64 << 20
    monkeypatch.setattr(TP, "to_device", lambda arr, device: (_ for _ in ()).throw(
        ValueError("not an OOM")))
    m2 = TP.PartitionedMatcher(tt, device="cpu")
    with pytest.raises(ValueError, match="not an OOM"):
        m2.match(["a/b"])


def test_fused_knob_off_then_on_keeps_segments_exact(monkeypatch):
    """The ``fused`` knob turned off drops the segments' fid rows (the
    unfused path does not read them); turned back on, the next refresh
    uploads them whole, so the fused tail never decodes through rows that
    missed the deltas of the time it was off. (The JAX matcher keeps its
    segments' rows and decodes through stale ones there: ROADMAP Queue C
    item 5.)"""
    rng = random.Random(7)
    seen = set()
    p = _Pair(monkeypatch, {"RMQTT_SEG_BYTES": "12288"}, _filters(rng, 4000, seen))
    tm, topics = p.tm, _topics(random.Random(1), 64)
    got = p.tm.match(topics)
    for topic, g in zip(topics, got):
        assert g.tolist() == sorted(v for _lv, vs in p.tree.matches(topic) for v in vs)

    def churn(n):
        for f in rng.sample(sorted(p.fid_of), n):
            p.remove(f)
        for f in _filters(rng, n, seen):
            p.add(f)

    tm._fused = False
    churn(100)
    p.check(topics)
    assert all(s.fids is None for s in tm._dev.segments) and tm.full_uploads == 1
    tm._fused = True
    f0 = tm.fused_batches
    p.check(topics)  # no fid rows resident yet: the unfused path serves
    assert tm.fused_batches == f0
    churn(1)
    got = tm.match(topics)
    for topic, g in zip(topics, got):
        assert g.tolist() == sorted(v for _lv, vs in p.tree.matches(topic) for v in vs)
    assert tm.full_uploads == 2 and all(s.fids is not None for s in tm._dev.segments)
    assert tm.fused_batches == f0 + 1


def test_mode_seams_note_the_jax_kernel_names(monkeypatch):
    """With the device profiler on, the new launch seams note the JAX
    package's program names."""
    from rmqtt_tpu_torch.broker.devprof import DEVPROF

    was = DEVPROF.enabled
    DEVPROF.reset()
    DEVPROF.configure(enabled=True)
    try:
        filters = [f"r/{i}" for i in range(300)] + ["r/+", "#"]
        q = _Pair(monkeypatch, {"RMQTT_FUSED": "0"}, filters)
        q.check(["r/1"] * 16)  # one candidate row for the batch: grouped
        q.check(["r/1", "r/2", "r/3", "r/4"])
        for k in list(q.tm._budgets):
            q.tm._budgets[k] = 2
        q.check(["r/1", "r/2", "r/3", "r/4"])
        p = _Pair(monkeypatch, {"RMQTT_COMPACT": "topk"}, filters, max_words=1)
        p.check(["r/1"])
        s = _Pair(monkeypatch, {"RMQTT_SEG_BYTES": "16384", "RMQTT_FUSED": "0"},
                  _filters(random.Random(1), 3000, set()))
        topics = _topics(random.Random(2), 16)
        s.check(topics)
        s.remove(next(iter(s.fid_of)))
        s.check(topics)
        assert s.tm._dev.segments is not None and s.tm.delta_uploads == 1
        kernels = set(DEVPROF.snapshot()["compile"]["kernels"])
    finally:
        DEVPROF.configure(enabled=was)
        DEVPROF.reset()
    assert {"match_global", "match_global_grouped", "compact_global",
            "match_partitioned", "compact_words", "delta_scatter"} <= kernels
