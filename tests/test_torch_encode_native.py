"""The port's default host path around the kernels, against the JAX package
on the CPU: the native topic encoder (``runtime.NativeEncoder`` behind
``PartitionedTable._encode_native``) equals the JAX table's native encode
and the port's ``_encode_py``; the matcher refuses ``RMQTT_PALLAS=0`` and
starts the other hand-selected modes as the JAX matcher does;
``RMQTT_FETCH_TIMEOUT`` turns a wedged copy into ``TimeoutError``; the CUDA
probe refuses instead of hanging or falling back to the CPU; and
the matcher's device-profiler seams give the JAX matcher's dispatch
records and upload notes on the same batches."""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu.broker.devprof import DEVPROF as JDEVPROF
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
from rmqtt_tpu_torch.broker.devprof import DEVPROF as TDEVPROF
from rmqtt_tpu_torch.core.topic import filter_valid
from rmqtt_tpu_torch.router import TorchRouter
from rmqtt_tpu_torch.runtime import NativeEncoder
from rmqtt_tpu_torch.utils import cudaprobe, devfetch

# level vocabulary: multi-byte UTF-8, the empty level, a $ level
_VOCAB = ["a", "b", "sensor", "ü", "日本", "", "x1", "x2", "x3"]
_NEW = ["late", "ñu"]  # tokens only filters added after the compaction carry


def _filters(rng, n, vocab):
    out = set()
    while len(out) < n:
        levels = [str(rng.choice(vocab)) for _ in range(int(rng.integers(1, 6)))]
        r = rng.random()
        if r < 0.25:
            levels[int(rng.integers(len(levels)))] = "+"
        if r > 0.7:
            levels[-1] = "#"
        if rng.random() < 0.05:
            levels[0] = "$SYS"
        f = "/".join(levels)
        if filter_valid(f):
            out.add(f)
    return sorted(out)


def _topics(rng, n):
    vocab = _VOCAB + _NEW + ["unknown", "ünknown"]
    out = ["/".join(str(rng.choice(vocab)) for _ in range(int(rng.integers(1, 12))))
           for _ in range(n)]
    hot = ["sensor/a/b/1", "sensor/a/b/2", "sensor/a/b"]
    return out + hot * 8 + [
        "$SYS/a", "$SYS", "a//b", "a/b/", "/a", "", "ü/日本/ü",
        "/".join(["a"] * 20), "late/ñu/x", ("a", "b", "c")]


def _partition(groups):
    """Group ids as a partition of the batch: each row labelled by the first
    row with its id; padded rows (id 0) stay 0."""
    first = {}
    return np.array([0 if g == 0 else first.setdefault(int(g), i + 1)
                     for i, g in enumerate(groups)])


def _assert_same_encode(got, want):
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert np.array_equal(_partition(got[5]), _partition(want[5]))


class _Tables:
    """The JAX table (native encode), the port's native and Python-encoding
    tables, mutated alike."""

    def __init__(self):
        self.jax = JP.PartitionedTable()
        self.nat = TP.PartitionedTable()
        self.py = TP.PartitionedTable()
        self.py._nenc = False

    def all(self):
        return self.jax, self.nat, self.py

    def add(self, f):
        fids = {t.add(f) for t in self.all()}
        assert len(fids) == 1
        return fids.pop()

    def remove(self, fid):
        for t in self.all():
            t.remove(fid)

    def check(self, topics, pad=None):
        encs = [t.encode_topics(topics, pad_batch_to=pad, with_groups=True)
                for t in self.all()]
        _assert_same_encode(encs[1], encs[0])
        _assert_same_encode(encs[1], encs[2])
        return encs[1]


def test_native_encode_equals_jax_native_and_python():
    rng = np.random.default_rng(7)
    tabs = _Tables()
    live = [tabs.add(f) for f in _filters(rng, 400, _VOCAB)]
    topics = _topics(rng, 150)
    for pad in (None, len(topics) + 5):
        enc = tabs.check(topics, pad)
    assert isinstance(tabs.nat._nenc, NativeEncoder) and tabs.jax._nenc
    assert enc[1].max() == tabs.nat.max_levels + 1  # the deep topic clamps
    assert enc[2][len(topics) - 10] and not enc[2][0]  # "$SYS/a"
    # removes and adds, then a compaction, then filters with new tokens
    for fid in rng.choice(live, 120, replace=False):
        tabs.remove(int(fid))
    for f in _filters(rng, 60, _VOCAB):
        if f not in tabs.py._key_of_fid.values():
            tabs.add(f)
    tabs.check(topics, len(topics) + 5)
    for t in tabs.all():
        t.compact()
    tabs.check(topics)
    synced = tabs.nat._nenc.tokens_synced
    for f in _filters(rng, 40, _VOCAB + _NEW):
        tabs.add(f)
    tabs.check(topics, len(topics) + 5)
    assert tabs.nat._nenc.tokens_synced > synced
    assert tabs.nat._nenc.tokens_synced == len(tabs.nat.tokens._strs)


def test_mutation_drops_only_its_prefixes():
    """A mutation in one partition drops the native cache entries that
    consulted it (``cache_del``) and keeps the rest; the next encode equals
    ``_encode_py``."""
    rng = np.random.default_rng(3)
    tabs = _Tables()
    for f in _filters(rng, 300, _VOCAB):
        tabs.add(f)
    topics = _topics(rng, 100)
    tabs.check(topics)
    nat = tabs.nat
    entries = nat._nenc_entries
    inv = nat.cand_cache_invalidations
    tabs.add("sensor/a/+/deep/#")
    dropped = nat.cand_cache_invalidations - inv
    assert 0 < dropped < entries and nat._nenc_entries == entries - dropped
    enc = tabs.check(topics)
    hot = topics.index("sensor/a/b/1")
    assert enc[3][hot].any()
    fid = tabs.add("x1/x2/x3/only")
    tabs.check(topics + ["x1/x2/x3/only"])
    tabs.remove(fid)
    tabs.check(topics + ["x1/x2/x3/only"])


def test_small_cache_cap_never_aliases_groups():
    """With a tiny ``cand_cache_max`` the native cache clears between
    batches only: within a batch no two distinct candidate sets share a
    group id."""
    rng = np.random.default_rng(11)
    tabs = _Tables()
    for f in _filters(rng, 300, _VOCAB):
        tabs.add(f)
    for t in tabs.all():
        t.cand_cache_max = 4
    for _ in range(4):
        topics = _topics(rng, 60)
        enc = tabs.check(topics, len(topics) + 3)
        rows = {}
        for cids, g in zip(enc[3], enc[5]):
            if g:
                assert rows.setdefault(int(g), cids.tobytes()) == cids.tobytes()
        assert len(rows) > 4  # the batch alone outgrows the cap


@pytest.mark.parametrize("name,value,hand_selected", [
    ("RMQTT_COMPACT", "topk", True),
    ("RMQTT_FUSED", "0", True),
    ("RMQTT_SEG_BYTES", str(256 << 20), True),
    ("RMQTT_PALLAS", "0", True),
    ("RMQTT_COMPACT", "global", False),
])
def test_unported_matcher_knobs_refuse(monkeypatch, name, value, hand_selected):
    """Of the JAX matcher's knobs that select a mode by hand, only
    ``RMQTT_PALLAS=0`` still refuses (the port has no verify-and-fall-back);
    ``RMQTT_COMPACT=topk``, ``RMQTT_FUSED=0`` and ``RMQTT_SEG_BYTES`` start
    a matcher whose ``match`` equals the JAX matcher's under the same
    environment. The default ``global`` starts as before."""
    monkeypatch.setenv(name, value)
    if name == "RMQTT_PALLAS":
        with pytest.raises(NotImplementedError, match=name):
            TP.PartitionedMatcher(TP.PartitionedTable(), device="cpu")
    elif not hand_selected:
        assert TP.PartitionedMatcher(TP.PartitionedTable(), device="cpu").match(
            ["a/b"])[0].size == 0
    else:
        rng = random.Random(4)
        jt, tt = JP.PartitionedTable(), TP.PartitionedTable()
        for f in gen_mixed(rng, 300):
            assert jt.add(f) == tt.add(f)
        jm, tm = JP.PartitionedMatcher(jt), TP.PartitionedMatcher(tt, device="cpu")
        topics = gen_topics_uniform(rng, 40)
        got, want = tm.match(topics), jm.match(topics)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        assert sum(len(w) for w in want) > 0
        # the JAX matcher's None latches True after its verify race; the
        # port has none and stays None (it runs fused all the same)
        assert tm._fused is (None if name == "RMQTT_SEG_BYTES" else False)


class _Wedged:
    """A tensor stand-in whose copy to the host never returns."""

    is_cuda = False

    def __init__(self):
        self.release = threading.Event()

    def cpu(self):
        self.release.wait()
        return torch.zeros(1)


def test_fetch_guard(monkeypatch):
    monkeypatch.setattr(devfetch, "_loaded", False)
    monkeypatch.delenv("RMQTT_FETCH_TIMEOUT", raising=False)
    t = torch.arange(6, dtype=torch.int32)
    # unset: one plain copy, no worker thread
    monkeypatch.setattr(devfetch.threading, "Thread", None)
    assert devfetch.fetch_timeout() is None
    assert np.array_equal(devfetch.fetch(t, "plain"), np.arange(6))
    monkeypatch.undo()
    monkeypatch.setattr(devfetch, "_loaded", False)
    monkeypatch.setenv("RMQTT_FETCH_TIMEOUT", "0.2")
    assert devfetch.fetch_timeout() == 0.2
    assert np.array_equal(devfetch.fetch(t), np.arange(6))
    wedged = _Wedged()
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="retained partitioned scan fetch"):
        devfetch.fetch(wedged, "retained partitioned scan fetch")
    assert time.perf_counter() - t0 < 10.0  # the copy itself never returns
    wedged.release.set()
    devfetch.set_fetch_timeout(None)
    monkeypatch.setattr(devfetch, "_loaded", False)


def test_cuda_probe_refuses(monkeypatch):
    hang = [sys.executable, "-c", "import time; time.sleep(30)"]
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="cuda probe.*1 s limit"):
        cudaprobe.require_cuda(timeout=1.0, retries=1, cmd=hang)
    assert time.perf_counter() - t0 < 10.0  # the child sleeps 30 s
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cudaprobe.require_cuda(timeout=5.0, retries=1,
                               cmd=[sys.executable, "-c", "print(0)"])
    assert cudaprobe.require_cuda(
        timeout=5.0, retries=1, cmd=[sys.executable, "-c", "print(2)"]) == 2
    # the broker's start with the default probe hung: it refuses, and never
    # routes on the CPU instead
    monkeypatch.setattr(cudaprobe, "_count", None)
    monkeypatch.setattr(cudaprobe, "PROBE_CMD", tuple(hang))
    monkeypatch.setattr(cudaprobe, "PROBE_TIMEOUT_S", 1.0)
    monkeypatch.setattr(cudaprobe, "PROBE_RETRIES", 1)
    monkeypatch.setattr(torch.version, "cuda", "12.4")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="cuda probe"):
        ServerContext(BrokerConfig(router="xla", port=0))
    with pytest.raises(RuntimeError, match="cuda probe"):  # memoized: at once
        TorchRouter()
    assert time.perf_counter() - t0 < 10.0
    # an explicit device skips the probe
    assert TorchRouter(device="cpu").matcher.device.type == "cpu"
    assert ServerContext(BrokerConfig(port=0, retain_tpu=True),
                         retain_device="cpu").retain._device.type == "cpu"


@pytest.fixture()
def profilers():
    """Both packages' process-global device profilers, enabled and empty;
    restored (disabled, emptied) afterwards."""
    saved = [(p, p.enabled) for p in (JDEVPROF, TDEVPROF)]
    for p, _ in saved:
        p.reset()
        p.configure(enabled=True)
    yield JDEVPROF, TDEVPROF
    for p, enabled in saved:
        p.configure(enabled=enabled)
        p.reset()


def test_profiler_seams_match_the_jax_matcher(profilers):
    jprof, tprof = profilers
    rng = random.Random(1)
    jt, tt = JP.PartitionedTable(), TP.PartitionedTable()
    for f in gen_mixed(rng, 600):
        assert jt.add(f) == tt.add(f)
    jm, tm = JP.PartitionedMatcher(jt), TP.PartitionedMatcher(tt, device="cpu")
    tm.stage_timing = True
    topics = gen_topics_uniform(rng, 120)
    seq = [topics[:8], topics[8:21], topics[:8], topics[30:46], topics[:16]]
    for i, batch in enumerate(seq):
        if i == 3:  # mutations between batches: one delta upload
            for fid in range(5):
                jt.remove(fid)
                tt.remove(fid)
        for a, b in zip(jm.match(batch), tm.match(batch)):
            assert np.array_equal(a, b)
    for m in (jm, tm):
        m.set_pad_floor(8)
    jrec, trec = jprof.flight(), tprof.flight()
    assert len(jrec) == len(trec) == len(seq)
    for j, t in zip(jrec, trec):
        for k in ("batch", "padded", "routes"):
            assert j[k] == t[k], k
        assert t["fused"] and set(t["stage_ns"]) == {"encode", "dispatch",
                                                      "fetch", "decode"}
    assert sum(r["routes"] for r in trec) > 0
    assert jprof.upload_counts == tprof.upload_counts == {"delta": 1, "full": 1}
    # a repeated shape goes from trace to hit, in both packages
    for recs in (jrec, trec):
        assert (recs[0]["compile"], recs[2]["compile"]) == ("trace", "hit")
    snap = tprof.snapshot()
    assert snap["dispatch"]["dispatches"] == len(seq)
    assert snap["dispatch"]["pad_floor"] == jprof.snapshot()["dispatch"]["pad_floor"] == 8
    kernels = snap["compile"]["kernels"]
    assert {"match_words_packed", "fused_compact_decode",
            "delta_scatter"} <= set(kernels)
    assert snap["compile"]["cache_hits"] > 0
    # an abandoned handle reaches the ring once 16 newer ones are pending
    handles = [tm.match_submit(topics[:8]) for _ in range(17)]
    assert tprof.flight()[-1].get("abandoned")
    for h in handles[1:]:
        tm.match_complete(h)
    assert not tm._prof_pending
