"""The slice as a whole: ``TorchRouter(device="cpu")`` against the JAX
package's ``XlaRouter`` with every batch on its device matcher
(``RMQTT_HYBRID_MAX=0``, ``RMQTT_HYBRID_ADAPT=0``, ``mesh=None``): the same
~2K mixed filters with ``$share`` groups and No-Local, the same per-topic
fid lists and relation expansions, before and after churn; plus the JAX
package's packed device arrays installed as the port matcher's snapshot."""

import random

import numpy as np
import pytest

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu.core.topic import parse_shared
from rmqtt_tpu.core.trie import TopicTree
from rmqtt_tpu.router.base import Id as JId
from rmqtt_tpu.router.base import SubscriptionOptions as JOpts
from rmqtt_tpu.router.xla import XlaRouter
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter


def _subs(seed, n):
    """(stripped filter, client, no_local, shared_group) rows; some filters
    carry two clients (a second subscription on the same filter)."""
    rng = random.Random(seed)
    out = []
    for i, f in enumerate(gen_mixed(rng, n, shared_frac=0.1)):
        group, stripped = parse_shared(f)
        out.append((stripped, f"c{i}", rng.random() < 0.1, group))
        if rng.random() < 0.05:
            out.append((stripped, f"d{i}", False, group))
    return out


def _as(sub, jax_side):
    stripped, cid, no_local, group = sub
    if jax_side:
        return stripped, JId(1, cid), JOpts(no_local=no_local, shared_group=group)
    return stripped, Id(1, cid), SubscriptionOptions(no_local=no_local,
                                                     shared_group=group)


def _norm(raw):
    """Relation expansion → plain tuples (the two packages' dataclasses
    are different classes with the same fields)."""
    out, shared = raw
    o = {nid: [(r.topic_filter, r.id.node_id, r.id.client_id, r.opts.no_local,
                r.opts.shared_group) for r in rels] for nid, rels in out.items()}
    s = {k: [(sid.client_id, opts.no_local, on) for sid, opts, on in cands]
         for k, cands in shared.items()}
    return o, s


@pytest.fixture()
def routers(monkeypatch):
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    monkeypatch.setenv("RMQTT_HYBRID_ADAPT", "0")
    jr = XlaRouter(mesh=None)
    tr = TorchRouter(device="cpu")
    return jr, tr


def _compare(jr, tr, topics, publisher):
    want = jr.matcher.match(topics)
    got = tr.matcher.match(topics)
    for topic, g, w in zip(topics, got, want):
        assert g.tolist() == w.tolist(), topic
    items_j = [(JId(1, publisher), t) for t in topics]
    items_t = [(Id(1, publisher), t) for t in topics]
    for topic, g, w in zip(topics, tr.matches_batch_raw(items_t),
                           jr.matches_batch_raw(items_j)):
        assert _norm(g) == _norm(w), topic
    return got


def test_router_parity_with_xla_router(routers):
    jr, tr = routers
    subs = _subs(0, 2000)
    for s in subs:
        jr.add(*_as(s, True))
        tr.add(*_as(s, False))
    rng = random.Random(1)
    topics = gen_topics_uniform(rng, 1100) + ["$SYS/x", "v0_1", "v0_2/v1_3"]
    publisher = subs[0][1]  # a No-Local subscriber may be the publisher
    h = tr.matcher.match_submit(topics)
    assert h[0] == "fs", "the NC split did not engage at B >= 1024"
    tr.matcher.match_complete(h)
    got = _compare(jr, tr, topics, publisher)
    assert sum(len(r) for r in got) > 1000
    # the semantic oracle agrees (values = fids)
    tree = TopicTree()
    for fid, f in tr._fid_to_filter.items():
        tree.insert(f, fid)
    for topic, row in zip(topics[:200], got):
        assert row.tolist() == sorted(v for _l, vs in tree.matches(topic) for v in vs)
    # churn: removes and adds, a small batch and the big one again
    for s in rng.sample(subs, 300):
        stripped, cid = s[0], s[1]
        assert jr.remove(stripped, JId(1, cid)) == tr.remove(stripped, Id(1, cid))
    for s in _subs(7, 300):
        jr.add(*_as(s, True))
        tr.add(*_as(s, False))
    _compare(jr, tr, topics[:9], publisher)
    _compare(jr, tr, topics, publisher)
    st = tr.device_stats()
    assert st["fused_batches"] >= 3 and st["uploads"] >= 2
    assert tr.topics_count() == jr.topics_count()
    assert tr.routes_count() == jr.routes_count()
    assert tr.gets(10) == jr.gets(10)
    f0 = subs[5][0]
    assert tr.subscribers_count(f0) == jr.subscribers_count(f0)
    assert tr.is_match(topics[0]) == bool(len(got[0]))


def test_submit_complete_pipelines(routers):
    _jr, tr = routers
    for s in _subs(2, 300):
        tr.add(*_as(s, False))
    topics = gen_topics_uniform(random.Random(3), 64)
    items = [(None, t) for t in topics]
    sync, h1 = tr.submit_batch_raw(items[:32])
    sync2, h2 = tr.submit_batch_raw(items[32:])
    assert not sync and not sync2
    got = tr.complete_batch_raw(h1) + tr.complete_batch_raw(h2)
    assert [_norm(g) for g in got] == [_norm(w) for w in tr.matches_batch_raw(items)]
    assert tr.matcher.match([]) == []


@pytest.mark.parametrize("packed", [True, False])
def test_device_state_from_jax_arrays(packed):
    """The JAX package's packed device mirror, as numpy, installed as the
    port matcher's resident snapshot: the port matches on it without
    re-packing, and a later mutation delta-updates it."""
    rng = random.Random(4)
    jt = JP.PartitionedTable()
    jt._nenc = False
    tt = TP.PartitionedTable()
    filters = gen_mixed(rng, 1500)
    for f in filters:
        assert jt.add(f) == tt.add(f)
    jt.compact()  # settle the layout: no background rebuild mid-test
    tt.compact()
    lay = jt.packed_layout() if packed else None
    tiles = (JP.pack_device_rows_packed(jt, lay) if packed
             else JP.pack_device_rows(jt))
    st = TP.device_state_from_numpy(
        tiles, JP.pack_fid_rows(jt), lay.widths if packed else None,
        tt.version, tt.layout_epoch, tt._fid_of_row, "cpu", lvl=tt.max_levels)
    m = TP.PartitionedMatcher(tt, device="cpu")
    m._packed_pref = packed
    m.install(st)
    topics = gen_topics_uniform(rng, 200)
    got = m.match(topics)
    assert m.full_uploads == 0, "the installed snapshot was re-packed"
    want = JP.PartitionedMatcher(jt).match(topics)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert sum(len(r) for r in got) > 0
    tt.remove(0)
    m.match(topics[:4])
    assert (m.full_uploads, m.delta_uploads) == (0, 1)
