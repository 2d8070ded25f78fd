"""``[durability]`` in the port (``broker/durability.py`` over the port's
``storage/sqlite.py``) against the JAX package's broker: the same
persistent sessions, subscriptions (``$share``, ``+`` and ``#`` among
them), retained messages and QoS 1 messages left unacked are journaled,
the broker stops without flushing (the kill -9 model), and a fresh broker
recovers them. The journal is one format: a store written by either
package is recovered by either, to the same counters and the same
deliveries. The port's brokers route every batch on
``TorchRouter(device="cpu")`` and replay retained messages from the
scanner's device mirror (``retain_device="cpu"``, a low threshold)."""

import asyncio
import collections

import pytest

from rmqtt_tpu.broker.context import BrokerConfig as JBrokerConfig
from rmqtt_tpu.broker.context import ServerContext as JServerContext
from rmqtt_tpu.broker.server import MqttBroker as JMqttBroker
from rmqtt_tpu_torch.broker.codec import packets as pk, props as P
from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
from rmqtt_tpu_torch.broker.server import MqttBroker
from rmqtt_tpu_torch.core.trie import RetainTree
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter
from rmqtt_tpu_torch.router.default import DefaultRouter

from tests.mqtt_client import TestClient

#: persistent sessions → (filter, qos); "$share/g/s/#" is the only filter
#: that matches an "s/..." topic, so a delivery on one is the group's
SESSIONS = {
    "d0": [("t/+/x", 1), ("$share/g/s/#", 1)],
    "d1": [("t/#", 1), ("$share/g/s/#", 1)],
    "d2": [("+/a/x", 0), ("t/b/+", 1)],
    "d3": [("#", 1)],
}
#: d0 and d1 stay connected and do not ack; d2 and d3 are offline
CONNECTED = ("d0", "d1")
RETAINED = [f"r/{i % 5}/{i}" for i in range(40)] + ["t/a/x", "s/k"]
PENDING = ["t/a/x", "t/b/x", "t/b/y", "s/1", "s/2", "u/a/x", "t/c/x"]
WAVE = ["t/a/x", "t/q/x", "s/3", "v/a/x", "t/b/z", "w"]
REPLAY_FILTERS = ["r/1/#", "r/+/7", "#", "+/+/x", "s/k"]
RETAIN_THRESHOLD = 10


def _shared(cid: str, topic: str) -> str:
    return "$share/g" if cid in ("d0", "d1") and topic.startswith("s/") else cid


def _broker(pkg: str, db: str):
    kw = dict(port=0, durability_enable=True, durability_path=db,
              durability_flush_interval_ms=3.0)
    if pkg == "jax":
        return JMqttBroker(JServerContext(JBrokerConfig(**kw)))
    return MqttBroker(ServerContext(
        BrokerConfig(retain_tpu=True, retain_tpu_threshold=RETAIN_THRESHOLD, **kw),
        router=TorchRouter(device="cpu"), retain_device="cpu"))


async def _collect(clients: dict, n: int, quiet: float = 0.2) -> list:
    """Wait until ``clients`` ({client id: TestClient}) hold ``n`` PUBLISH
    packets between them (10 s at most), then a quiet window for extras →
    [(client id, packet)]."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 10.0
    while sum(c.publishes.qsize() for c in clients.values()) < n:
        assert loop.time() < deadline, (
            f"{sum(c.publishes.qsize() for c in clients.values())} of {n} deliveries")
        await asyncio.sleep(0.01)
    await asyncio.sleep(quiet)
    rows = []
    for cid, c in clients.items():
        while not c.publishes.empty():
            rows.append((cid, c.publishes.get_nowait()))
    return rows


def _oracle() -> DefaultRouter:
    r = DefaultRouter()
    for cid, rows in SESSIONS.items():
        for f, q in rows:
            group = None
            if f.startswith("$share/"):
                _, group, f = f.split("/", 2)
            r.add(f, Id(1, cid), SubscriptionOptions(qos=q, shared_group=group))
    return r


def _want_deliveries(topics, tag: str, qos_in: int) -> collections.Counter:
    """(client or share group, topic, payload, qos) the oracle resolves
    for ``topics`` published at ``qos_in`` with payload ``tag-i``."""
    want = collections.Counter()
    oracle = _oracle()
    for i, t in enumerate(topics):
        for rels in oracle.matches(None, t).values():
            for r in rels:
                want[(_shared(r.id.client_id, t), t, f"{tag}-{i}".encode(),
                      min(qos_in, r.opts.qos))] += 1
    return want


async def _write(pkg: str, db: str) -> str:
    """Journal the workload on a ``pkg`` broker, then stop it without the
    shutdown flush → the retained store's digest."""
    b = _broker(pkg, db)
    await b.start()
    try:
        subs = {}
        for cid, rows in SESSIONS.items():
            c = await TestClient.connect(b.port, cid, version=pk.V5, clean_start=False,
                                         properties={P.SESSION_EXPIRY_INTERVAL: 3600})
            for f, q in rows:
                ack = await c.subscribe(f, qos=q)
                assert ack.reason_codes[0] < 0x80
            subs[cid] = c
        for cid, c in subs.items():
            if cid not in CONNECTED:
                await c.disconnect_clean()
        connected = {cid: subs[cid] for cid in CONNECTED}
        pub = await TestClient.connect(b.port, "w-pub")
        # retained at QoS 0: stored and journaled, delivered at QoS 0 to
        # the connected sessions (QoS 0 is never a pending row)
        for i, t in enumerate(RETAINED):
            await pub.publish(t, f"ret-{i}".encode(), qos=0, retain=True)
        n = sum(v for (k, *_), v in _want_deliveries(RETAINED, "ret", 0).items()
                if k in (*CONNECTED, "$share/g"))
        assert len(await _collect(connected, n)) == n
        for c in connected.values():
            c.auto_ack = False
        # acked by the publisher = journaled and committed (the barrier),
        # with every record before it
        for i, t in enumerate(PENDING):
            await pub.publish(t, f"pend-{i}".encode(), qos=1)
        digest = b.ctx.retain.digest()["digest"]
        d = b.ctx.durability
        assert d.appends > 0 and d.commits > 0 and not d.wedged
        d._crash_for_test = True  # no shutdown flush: the kill -9 model
        return digest
    finally:
        await b.stop()


async def _recover(pkg: str, db: str) -> dict:
    """Recover the store on a fresh ``pkg`` broker → its counters, the
    re-delivered pending window, a wave over the recovered routes and the
    retained replay of a new client."""
    b = _broker(pkg, db)
    await b.start()
    try:
        d = b.ctx.durability
        out = {"recovered": {k: d.recovered[k]
                             for k in ("retained", "sessions", "subs", "inflight")},
               "digest": b.ctx.retain.digest()["digest"],
               "routes": b.ctx.router.routes_count()}
        want_pend = _want_redelivered()
        clients, redelivered = {}, collections.Counter()
        for cid in SESSIONS:
            c = await TestClient.connect(b.port, cid, version=pk.V5, clean_start=False,
                                         properties={P.SESSION_EXPIRY_INTERVAL: 3600})
            assert c.connack.session_present, cid
            clients[cid] = c
        for cid, p in await _collect(clients, sum(want_pend.values())):
            redelivered[(_shared(cid, p.topic), p.topic, bytes(p.payload), p.qos,
                         p.dup)] += 1
        out["redelivered"] = redelivered
        pub = await TestClient.connect(b.port, "r-pub")
        for i, t in enumerate(WAVE):
            await pub.publish(t, f"wave-{i}".encode(), qos=1)
        want_wave = _want_deliveries(WAVE, "wave", 1)
        wave = collections.Counter()
        for cid, p in await _collect(clients, sum(want_wave.values())):
            wave[(_shared(cid, p.topic), p.topic, bytes(p.payload), p.qos)] += 1
        out["wave"] = wave
        reader = await TestClient.connect(b.port, "r-reader")
        replay = collections.Counter()
        for f in REPLAY_FILTERS:
            await reader.subscribe(f, qos=0)
            n = len(_retain_oracle().matches(f))
            for _cid, p in await _collect({"r-reader": reader}, n):
                replay[(f, p.topic, bytes(p.payload), p.retain)] += 1
            await reader.unsubscribe(f)
        out["replay"] = replay
        if pkg == "torch":
            out["scans"] = b.ctx.retain.device_stats()["retained_scans"]
            out["fused"] = b.ctx.router.matcher.fused_batches
        for c in [*clients.values(), pub, reader]:
            await c.disconnect_clean()
        return out
    finally:
        await b.stop()


def _retain_oracle() -> RetainTree:
    tree = RetainTree()
    for i, t in enumerate(RETAINED):
        tree.insert(t, i)
    return tree


def _want_replay() -> collections.Counter:
    tree, want = _retain_oracle(), collections.Counter()
    for f in REPLAY_FILTERS:
        for _lv, i in tree.matches(f):
            want[(f, RETAINED[i], f"ret-{i}".encode(), True)] += 1
    return want


def _want_redelivered() -> collections.Counter:
    """Every pending QoS 1 row comes back once, with DUP set (the share
    group's to the member it was sent to); QoS 0 deliveries were never
    pending."""
    return collections.Counter({(k, t, p, q, True): n for (k, t, p, q), n
                                in _want_deliveries(PENDING, "pend", 1).items()
                                if q > 0})


@pytest.mark.parametrize("writer,reader", [("jax", "jax"), ("torch", "torch"),
                                           ("jax", "torch"), ("torch", "jax")])
def test_recovery_matches_the_jax_broker(writer, reader, tmp_path, monkeypatch):
    """A store journaled by ``writer``'s broker, recovered by ``reader``'s:
    the recovered counters, the DUP re-deliveries of the unacked window,
    a QoS 1 wave over the recovered routes and a new client's retained
    replay all equal their oracles, so every pair of packages agrees."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    db = str(tmp_path / "durability.db")

    async def run():
        digest = await _write(writer, db)
        return digest, await _recover(reader, db)

    digest, got = asyncio.run(asyncio.wait_for(run(), timeout=60.0))
    n_subs = sum(len(rows) for rows in SESSIONS.values())
    n_pending = sum(_want_redelivered().values())
    assert got["recovered"] == {"retained": len(RETAINED), "sessions": len(SESSIONS),
                                "subs": n_subs, "inflight": n_pending}
    assert got["digest"] == digest and got["routes"] == n_subs
    assert got["redelivered"] == _want_redelivered()
    assert got["wave"] == _want_deliveries(WAVE, "wave", 1)
    assert got["replay"] == _want_replay()
    if reader == "torch":
        # the replay ran on the scanner, the wave on the matcher
        assert got["scans"] >= len(REPLAY_FILTERS) and got["fused"] > 0


def test_durability_refuses_multi_process_sharing(tmp_path):
    """One journal cannot serve several processes: ``[durability]`` with
    ``[fabric]`` is refused at construction, and the ``--workers``
    supervisor refuses a durability config before it starts a worker."""
    import subprocess
    import sys

    with pytest.raises(ValueError, match="fabric"):
        ServerContext(BrokerConfig(port=0, durability_enable=True,
                                   durability_path=str(tmp_path / "d.db"),
                                   fabric_enable=True, fabric_dir=str(tmp_path)))
    conf_p = tmp_path / "rmqtt.toml"
    conf_p.write_text("[listener]\nport = 0\n[durability]\nenable = true\n"
                      f'path = "{tmp_path}/d.db"\n')
    r = subprocess.run([sys.executable, "-m", "rmqtt_tpu_torch.broker", "--config",
                        str(conf_p), "--workers", "2"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "durability" in r.stderr and "--workers" in r.stderr
