"""Multi-device parity: the port's ``parallel/sharded.py`` over a list of
CPU devices against the JAX package's ``parallel/sharded.py`` on the eight
virtual devices ``tests/conftest.py`` forces, on the same inputs made with
``random`` seeds. ``ShardedMatcher``'s assembled bitmap and counts bit for
bit at (dp, fp) of (1, 8), (2, 4) and (8, 1); ``ShardedPartitionedMatcher``
fused, unfused, topk and after a forced budget regrow equal to the JAX
matcher and the ``match_filter`` oracle; a broker whose ``TorchRouter``
runs over a mesh. The same matchers over a card: ``tests/test_torch_cuda.py``."""

import asyncio
import random

import jax
import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.encode as JE
import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu.parallel.sharded as JS
import rmqtt_tpu_torch.ops.encode as TE
import rmqtt_tpu_torch.ops.partitioned as TP
import rmqtt_tpu_torch.parallel.sharded as TS
from rmqtt_tpu.core.topic import filter_valid, match_filter

CPU8 = [torch.device("cpu")] * 8


def _filters(rng, n, words):
    out = []
    while len(out) < n:
        levels = [rng.choice(words) for _ in range(rng.randint(1, 6))]
        if rng.random() < 0.3:
            levels[-1] = "#"
        f = "/".join(levels)
        if filter_valid(f):
            out.append(f)
    return out


def _topics(rng, n, words):
    return ["/".join(rng.choice(words) for _ in range(rng.randint(1, 6)))
            for _ in range(n)] + ["$sys/x"]


def _oracle(live, topic):
    return sorted(fid for fid, f in live.items() if match_filter(f, topic))


@pytest.fixture(scope="module")
def dense_tables():
    rng = random.Random(23)
    jt, tt = JE.FilterTable(), TE.FilterTable()
    live = {}
    for f in _filters(rng, 2000, ["a", "b", "c", "d", "", "+"]):
        fid = jt.add(f)
        assert tt.add(f) == fid
        live[fid] = f
    return jt, tt, live, _topics(rng, 63, ["a", "b", "c", "d", ""])


@pytest.mark.parametrize("dp,fp", [(1, 8), (2, 4), (8, 1)])
def test_sharded_matcher_equals_jax(dense_tables, dp, fp):
    assert len(jax.devices()) == 8
    jt, tt, live, topics = dense_tables
    js = JS.ShardedMatcher(jt, JS.make_mesh(dp=dp, fp=fp))
    ts = TS.ShardedMatcher(tt, TS.make_mesh(CPU8, dp=dp, fp=fp))
    ttok, tlen, td = tt.encode_topics(topics)
    jpacked, jcounts = js.match_encoded(ttok, tlen, td)
    res = ts.match_encoded(ttok, tlen, td)
    assert len(res.packed) == dp and all(len(r) == fp for r in res.packed)
    packed, counts = ts.assemble(res)
    assert np.array_equal(packed.view(np.uint32), np.asarray(jpacked))
    assert np.array_equal(counts, np.asarray(jcounts))
    for topic, n in zip(topics, counts):
        assert n == len(_oracle(live, topic)), topic


def test_sharded_matcher_refuses_odd_batches(dense_tables):
    _jt, tt, _live, _topics_ = dense_tables
    ts = TS.ShardedMatcher(tt, TS.make_mesh(CPU8, dp=8, fp=1))
    with pytest.raises(ValueError, match="does not divide"):
        ts.match_encoded(*tt.encode_topics(["a", "b", "c"]))
    with pytest.raises(ValueError, match="dp\\(3\\)"):
        TS.make_mesh(CPU8, dp=3, fp=2)


@pytest.fixture(scope="module")
def partitioned_tables():
    rng = random.Random(77)
    jt, tt = JP.PartitionedTable(), TP.PartitionedTable()
    live = {}
    for f in _filters(rng, 1500, ["a", "b", "c", "d", "", "+"]):
        fid = jt.add(f)
        assert tt.add(f) == fid
        live[fid] = f
    return jt, tt, live, _topics(rng, 96, ["a", "b", "c", "x", ""])


@pytest.mark.parametrize("mode", ["fused", "unfused", "topk"])
def test_sharded_partitioned_equals_jax(partitioned_tables, mode):
    jt, tt, live, topics = partitioned_tables
    kw = {"compact": "topk"} if mode == "topk" else {}
    jm = JS.ShardedPartitionedMatcher(jt, JS.make_mesh(dp=2, fp=4), **kw)
    tm = TS.ShardedPartitionedMatcher(tt, TS.make_mesh(CPU8, dp=2, fp=4), **kw)
    if mode == "unfused":
        jm._fused = tm._fused = False
    got, want = tm.match(topics), jm.match(topics)
    for topic, g, w in zip(topics, got, want):
        assert np.array_equal(g, w) and g.tolist() == _oracle(live, topic), topic
    assert tm.fused_batches == (1 if mode == "fused" else 0)
    hbm = tm.hbm_breakdown()
    assert hbm["replicas"] == 8 and hbm["total_bytes"] == 8 * (
        hbm["tiles_bytes"] + hbm["fid_map_bytes"])
    assert (hbm["fid_map_bytes"] > 0) == (mode == "fused")
    assert len(tm.match([])) == 0


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_budget_regrow_and_churn(fused):
    """A forced per-shard overflow regrows (sticky) and returns the same
    rows; a churn goes up as one delta upload into every device's copy."""
    rng = random.Random(91)
    jt, tt = JP.PartitionedTable(), TP.PartitionedTable()
    live = {}
    for f in _filters(rng, 600, ["a", "b", "", "+"]):
        fid = jt.add(f)
        assert tt.add(f) == fid
        live[fid] = f
    topics = _topics(rng, 64, ["a", "b", "x", ""])
    tm = TS.ShardedPartitionedMatcher(tt, TS.make_mesh(CPU8, dp=2, fp=4))
    jm = JS.ShardedPartitionedMatcher(jt, JS.make_mesh(dp=2, fp=4))
    tm._fused = jm._fused = fused
    first = tm.match(topics)
    jm.match(topics)
    for key in list(tm._budgets):
        tm._budgets[key] = 2
    again = tm.match(topics)
    assert all(v >= 256 for v in tm._budgets.values())
    for topic, a, b in zip(topics, first, again):
        assert np.array_equal(a, b) and a.tolist() == _oracle(live, topic), topic
    for fid in rng.sample(sorted(live), 30):
        jt.remove(fid)
        tt.remove(fid)
        del live[fid]
    for f in _filters(rng, 30, ["a", "b", "", "+", "c"]):
        fid = jt.add(f)
        assert tt.add(f) == fid
        live[fid] = f
    for topic, g, w in zip(topics, tm.match(topics), jm.match(topics)):
        assert np.array_equal(g, w) and g.tolist() == _oracle(live, topic), topic
    assert (tm.full_uploads, tm.delta_uploads, tm.upload_bytes) == \
        (jm.full_uploads, jm.delta_uploads, jm.upload_bytes) == (1, 1, jm.upload_bytes)


def test_broker_with_mesh_router():
    """A broker whose ``TorchRouter`` runs the sharded partitioned matcher
    over eight CPU devices (dp=2, fp=4): publishes over real sockets route
    through all of them (``tests/test_sharded.py``'s case)."""
    from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
    from rmqtt_tpu_torch.broker.server import MqttBroker
    from rmqtt_tpu_torch.router.torch_router import TorchRouter
    from tests.mqtt_client import TestClient

    async def run():
        ctx = ServerContext(BrokerConfig(port=0))
        router = TorchRouter(
            is_online=lambda cid: (ctx.registry.get(cid) is not None
                                   and ctx.registry.get(cid).connected),
            mesh=TS.make_mesh(CPU8, dp=2, fp=4))
        assert isinstance(router.matcher, TS.ShardedPartitionedMatcher)
        router.set_hybrid_max(0)
        ctx.router = router
        ctx.routing.router = router
        b = MqttBroker(ctx)
        await b.start()
        try:
            sub = await TestClient.connect(b.port, "mesh-sub")
            await sub.subscribe("m/+/t", "m/#", qos=1)
            pub = await TestClient.connect(b.port, "mesh-pub")
            await pub.publish("m/a/t", b"via-mesh", qos=1)
            got = [await sub.recv(timeout=30), await sub.recv(timeout=30)]
            assert all(p.payload == b"via-mesh" for p in got)
            await sub.disconnect_clean()
            await pub.disconnect_clean()
        finally:
            await b.stop()
        return router.matcher

    m = asyncio.run(asyncio.wait_for(run(), 60))
    assert m.fused_batches > 0 and m.full_uploads >= 1
