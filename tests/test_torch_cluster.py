"""The port's cluster layer and multi-process deployments against the JAX
package's: a broadcast cluster and a raft cluster of in-process brokers
over real TCP, the intra-node fabric of in-process workers over real UDS,
and ``python -m rmqtt_tpu_torch.broker --workers 2 --fabric``. The port's
brokers route every batch on ``TorchRouter(device="cpu")`` (hybrid off);
the same drive on both packages delivers the same multiset, equal to a
``DefaultRouter`` oracle. A ``$share`` delivery counts for its group: which
member takes a message is a load-balancing choice.

Also the two faults of the reference's ``cluster/transport.py`` that the
port's copy fixes (``PeerClient``): concurrent first calls opened two
connections and the dropped one tore down the live one, and a failed
connect counted twice on the peer's breaker; and the fault of its
``cluster/raft.py``: a leader kept its breaker to a restarted peer open
after the peer asked for a vote. Each case fails on the JAX package's
module."""

import asyncio
import collections
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import types
import urllib.request

import pytest

import rmqtt_tpu.broker.context as j_context
import rmqtt_tpu.broker.server as j_server
import rmqtt_tpu.cluster.broadcast as j_broadcast
import rmqtt_tpu.cluster.raft as j_raft_node
import rmqtt_tpu.cluster.raft_mode as j_raft_mode
import rmqtt_tpu.cluster.transport as j_transport
import rmqtt_tpu_torch.broker.context as t_context
import rmqtt_tpu_torch.broker.server as t_server
import rmqtt_tpu_torch.cluster.broadcast as t_broadcast
import rmqtt_tpu_torch.cluster.raft as t_raft_node
import rmqtt_tpu_torch.cluster.raft_mode as t_raft_mode
import rmqtt_tpu_torch.cluster.transport as t_transport
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter
from rmqtt_tpu_torch.router.default import DefaultRouter

from tests.mqtt_client import TestClient

PKGS = {
    "jax": types.SimpleNamespace(ctx=j_context, server=j_server, bcast=j_broadcast,
                                 raft=j_raft_mode, raft_node=j_raft_node,
                                 transport=j_transport),
    "torch": types.SimpleNamespace(ctx=t_context, server=t_server, bcast=t_broadcast,
                                   raft=t_raft_mode, raft_node=t_raft_node,
                                   transport=t_transport),
}
SHARE = "$share/g/work/#"


def _broker(pkg: str, **cfg):
    m = PKGS[pkg]
    ctx_kw = {"router": TorchRouter(device="cpu")} if pkg == "torch" else {}
    return m.server.MqttBroker(m.ctx.ServerContext(m.ctx.BrokerConfig(port=0, **cfg),
                                                   **ctx_kw))


async def _until(cond, what: str, timeout: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        assert loop.time() < deadline, f"{what}: not within {timeout} s"
        await asyncio.sleep(0.01)


async def _collect(clients: dict, n: int, quiet: float = 0.2) -> collections.Counter:
    """Wait until ``clients`` hold ``n`` PUBLISH packets between them, then
    a quiet window for extras → multiset of (client or "$share", topic,
    payload, qos, retain)."""
    await _until(lambda: sum(c.publishes.qsize() for c in clients.values()) >= n,
                 f"{n} deliveries")
    await asyncio.sleep(quiet)
    got = collections.Counter()
    for cid, c in clients.items():
        while not c.publishes.empty():
            p = c.publishes.get_nowait()
            key = "$share" if cid.startswith("w") and p.topic.startswith("work/") else cid
            got[(key, p.topic, bytes(p.payload), p.qos, p.retain)] += 1
    return got


def _workload(seed: int):
    """Two subscribers' filters, topics for them and for the share group."""
    rng = random.Random(seed)
    filters = gen_mixed(rng, 40)
    subs = {"a": filters[0::2], "b": filters[1::2]}
    topics = gen_topics_uniform(rng, 40) + [f"work/{i}" for i in range(6)]
    return subs, topics


def _want(subs, topics, members=("w1", "w2")) -> collections.Counter:
    oracle = DefaultRouter()
    for cid, fs in subs.items():
        for f in fs:
            oracle.add(f, Id(1, cid), SubscriptionOptions(qos=1))
    for cid in members:
        oracle.add("work/#", Id(1, cid), SubscriptionOptions(qos=1, shared_group="g"))
    want = collections.Counter()
    for i, t in enumerate(topics):
        for rels in oracle.matches(None, t).values():
            for r in rels:
                key = "$share" if r.opts.shared_group else r.id.client_id
                want[(key, t, f"m{i}".encode(), 1, False)] += 1
    return want


async def _drive(ports, subs, topics) -> dict:
    """Connect subscriber "a" and share member "w1" on the first node, "b"
    and "w2" on the last, and subscribe them → {client id: client}."""
    clients = {}
    for cid, port in (("a", ports[0]), ("w1", ports[0]), ("b", ports[-1]),
                      ("w2", ports[-1])):
        c = await TestClient.connect(port, cid)
        for f in (subs[cid] if cid in subs else [SHARE]):
            ack = await c.subscribe(f, qos=1)
            assert ack.reason_codes[0] < 0x80
        clients[cid] = c
    return clients


async def _publish(port, topics) -> None:
    """QoS 1 publishes of ``topics`` (payload ``m<i>``); every 8th waits for
    its ack, so routing batches hold several topics and at most 8 are in
    flight, inside the broker's inbound window of 16."""
    pub = await TestClient.connect(port, "pub")
    for i, t in enumerate(topics):
        await pub.publish(t, f"m{i}".encode(), qos=1, wait_ack=i % 8 == 7)
    await pub.ping()
    await pub.disconnect_clean()


# ------------------------------------------------------------ broadcast
async def _broadcast_run(pkg: str, subs, topics) -> tuple:
    m = PKGS[pkg]
    brokers = [_broker(pkg, node_id=i + 1, cluster=True) for i in range(2)]
    clusters = []
    try:
        for b in brokers:
            await b.start()
            c = m.bcast.BroadcastCluster(b.ctx, ("127.0.0.1", 0), [])
            await c.start()
            clusters.append(c)
        for i, c in enumerate(clusters):
            for j, other in enumerate(clusters):
                if i != j:
                    nid = brokers[j].ctx.node_id
                    c.peers[nid] = m.transport.PeerClient(nid, "127.0.0.1",
                                                          other.bound_port)
            c.bcast.peers = list(c.peers.values())
        # the membership heartbeats open every link before the drive
        await _until(lambda: all(p.connected for c in clusters
                                 for p in c.peers.values()), "links up")
        ports = [b.port for b in brokers]
        clients = await _drive(ports, subs, topics)
        await _publish(ports[-1], topics)
        got = await _collect(clients, sum(_want(subs, topics).values()))
        # retained sync on set: node 2 holds node 1's retained message
        pub = await TestClient.connect(ports[0], "rpub")
        await pub.publish("ret/k", b"keep", qos=1, retain=True)
        await _until(lambda: brokers[1].ctx.retain.get("ret/k") is not None,
                     "retained copy on node 2")
        late = await TestClient.connect(ports[1], "late")
        await late.subscribe("ret/#", qos=1)
        got += await _collect({"late": late}, 1)
        for c in [*clients.values(), pub, late]:
            await c.disconnect_clean()
        routed = brokers[0].ctx.router
        fused = routed.matcher.fused_batches if pkg == "torch" else None
        return got, fused
    finally:
        for c in clusters:
            await c.stop()
        for b in brokers:
            await b.stop()


def test_broadcast_cluster_matches_the_jax_cluster(monkeypatch):
    """Two broadcast-mode nodes of each package: cross-node publishes at
    QoS 1, a ``$share`` group with a member on each node, a retained
    message synced on set and replayed on the other node."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    subs, topics = _workload(11)
    want = _want(subs, topics)
    want[("late", "ret/k", b"keep", 1, True)] += 1

    async def run():
        return (await _broadcast_run("jax", subs, topics),
                await _broadcast_run("torch", subs, topics))

    (got_j, _), (got_t, fused) = asyncio.run(asyncio.wait_for(run(), timeout=60.0))
    assert got_j == want and got_t == want
    assert fused > 0


# ----------------------------------------------------------------- raft
async def _raft_run(pkg: str, subs, topics) -> collections.Counter:
    m = PKGS[pkg]
    brokers = [_broker(pkg, node_id=i + 1, cluster=True, cluster_mode="raft")
               for i in range(3)]
    clusters = []
    try:
        for b in brokers:
            await b.start()
            c = m.raft.RaftCluster(b.ctx, ("127.0.0.1", 0), [])
            await c.server.start()
            await c.raft.restore_pending()
            clusters.append(c)
        for i, c in enumerate(clusters):
            for j, other in enumerate(clusters):
                if i != j:
                    nid = brokers[j].ctx.node_id
                    c.peers[nid] = m.transport.PeerClient(nid, "127.0.0.1",
                                                          other.bound_port)
            c.bcast.peers = list(c.peers.values())
            c.raft.peers = c.peers
            c.raft.start()

        def one_leader():
            leaders = [c for c in clusters if c.raft.is_leader]
            return len(leaders) == 1 and all(
                c.raft.leader_id == leaders[0].raft.node_id for c in clusters)

        await _until(one_leader, "a raft leader")
        ports = [b.port for b in brokers]
        clients = await _drive(ports, subs, topics)
        n_routes = sum(len(fs) for fs in subs.values()) + 2
        await _until(lambda: all(b.ctx.router.routes_count() == n_routes
                                 for b in brokers), "routes replicated")
        await _publish(ports[1], topics)
        got = await _collect(clients, sum(_want(subs, topics).values()))
        for c in clients.values():
            await c.disconnect_clean()
        # the sessions' unsubscribes commit before the nodes stop (the JAX
        # package's ClusterServer.stop can wait forever on a link that a
        # retrying proposal opens meanwhile)
        await _until(lambda: all(b.ctx.router.routes_count() == 0 for b in brokers),
                     "routes removed")
        return got
    finally:
        for c in clusters:
            await c.stop()
        for b in brokers:
            await b.stop()


def test_raft_cluster_matches_the_jax_cluster(monkeypatch):
    """Three raft-mode nodes of each package: the route table replicated
    through the log to every node, publishes on a third node."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    subs, topics = _workload(12)
    want = _want(subs, topics)

    async def run():
        return await _raft_run("jax", subs, topics), await _raft_run("torch", subs, topics)

    got_j, got_t = asyncio.run(asyncio.wait_for(run(), timeout=60.0))
    assert got_j == want and got_t == want


# --------------------------------------------------------------- fabric
async def _fabric_run(pkg: str, subs, topics) -> tuple:
    with tempfile.TemporaryDirectory(prefix="rmqtt-fab-") as fabric_dir:
        return await _fabric_drive(pkg, fabric_dir, subs, topics)


async def _fabric_drive(pkg: str, fabric_dir: str, subs, topics) -> tuple:
    workers = [_broker(pkg, node_id=w, fabric_enable=True, fabric_dir=fabric_dir,
                       fabric_worker_id=w, fabric_workers=3) for w in (1, 2, 3)]
    try:
        for w in workers:
            await w.start()
        await _until(lambda: all(w.ctx.fabric.is_owner or w.ctx.fabric._owner_up.is_set()
                                 for w in workers), "workers registered")
        ports = [w.port for w in workers]
        clients = await _drive(ports, subs, topics)
        owner = workers[0].ctx
        n_routes = sum(len(fs) for fs in subs.values()) + 2
        await _until(lambda: owner.router.routes_count() == n_routes,
                     "every subscription in the owner's table")
        st0 = owner.routing.stats()
        f0 = owner.router.matcher.fused_batches if pkg == "torch" else 0
        await _publish(ports[1], topics)  # a plain worker submits to the owner
        got = await _collect(clients, sum(_want(subs, topics).values()))
        st1 = owner.routing.stats()
        fused = (owner.router.matcher.fused_batches - f0) if pkg == "torch" else None
        fallbacks = [w.ctx.fabric.submit_fallbacks for w in workers]
        for c in clients.values():
            await c.disconnect_clean()
        return got, fused, st1["routing_dispatches"] - st0["routing_dispatches"], fallbacks
    finally:
        for w in workers:
            await w.stop()


def test_fabric_matches_the_jax_fabric(monkeypatch):
    """Three fabric workers of each package in one loop: the owner (worker
    1) holds the node's table — for the port a ``TorchRouter(device="cpu")``
    — and matches every publish submitted by worker 2; every routing batch
    of the owner ran on the matcher (on the card, the words kernel), and no
    publish degraded to a worker's local table."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    subs, topics = _workload(13)
    want = _want(subs, topics)

    async def run():
        return await _fabric_run("jax", subs, topics), await _fabric_run("torch", subs, topics)

    (got_j, _, _, fb_j), (got_t, fused, batches, fb_t) = asyncio.run(
        asyncio.wait_for(run(), timeout=60.0))
    assert got_j == want and got_t == want
    assert fb_j == fb_t == [0, 0, 0]
    assert fused == batches > 0


# --------------------------------------------------- --workers 2 --fabric
def _free_port(n: int = 1) -> int:
    """The first of ``n`` consecutive free ports (``--workers`` gives worker
    i the cluster port base + i)."""
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


@pytest.mark.parametrize("fabric", [True, False], ids=["fabric", "broadcast"])
def test_workers_subprocess(fabric, tmp_path):
    """``python -m rmqtt_tpu_torch.broker --workers 2 --router trie``, with
    ``--fabric`` and without (a localhost broadcast cluster): two
    SO_REUSEPORT workers on one port found at run time. Once the workers
    are wired (the owner lists worker 2; the cluster's stats hold both
    nodes) every subscriber gets every publish, wherever the kernel placed
    the connections."""
    port, http_port = _free_port(), _free_port()
    cfg = tmp_path / "rmqtt.toml"
    cfg.write_text(f'[listener]\nhost = "127.0.0.1"\n[http_api]\nhost = "127.0.0.1"\n'
                   f"port = {http_port}\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.getcwd(), os.environ.get("PYTHONPATH", "")) if p))
    log = open(tmp_path / "workers.log", "wb")
    mode = ["--fabric"] if fabric else ["--cluster-port-base", str(_free_port(2))]
    proc = subprocess.Popen(
        [sys.executable, "-m", "rmqtt_tpu_torch.broker", "--port", str(port),
         "--config", str(cfg), "--workers", "2", "--router", "trie", *mode],
        env=env, stdout=log, stderr=subprocess.STDOUT)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{http_port}{path}",
                                    timeout=5) as r:
            return json.loads(r.read())

    def wired():
        if fabric:
            return get("/api/v1/fabric").get("registered_workers") == [2]
        return len(get("/api/v1/stats")) == 2

    async def drive():
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60.0
        while True:
            assert proc.poll() is None, (tmp_path / "workers.log").read_text()
            try:
                if await loop.run_in_executor(None, wired):
                    break
            except OSError:
                pass
            assert loop.time() < deadline, "the workers were never wired"
            await asyncio.sleep(0.1)
        subs = {f"fs{i}": await TestClient.connect(port, f"fs{i}") for i in range(12)}
        for c in subs.values():
            await c.subscribe("fport/+", qos=0)
        pub = await TestClient.connect(port, "fpub")
        if fabric:
            # the subscriptions reach the owner's table over the mesh: probe
            # until every subscriber has one, wherever it landed
            seen = set()
            while len(seen) < len(subs):
                await pub.publish("fport/probe", b"p", qos=0)
                for cid, c in subs.items():
                    while not c.publishes.empty():
                        c.publishes.get_nowait()
                        seen.add(cid)
                assert loop.time() < deadline + 30.0, f"{len(seen)} of {len(subs)} subscribed"
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.2)  # probes still in flight
            for c in subs.values():
                while not c.publishes.empty():
                    c.publishes.get_nowait()
        for i in range(8):
            await pub.publish("fport/news", b"m%d" % i, qos=1)
        got = await _collect(subs, len(subs) * 8)
        for c in [*subs.values(), pub]:
            await c.disconnect_clean()
        return got, (await loop.run_in_executor(None, get, "/api/v1/fabric"))

    try:
        got, fab = asyncio.run(asyncio.wait_for(drive(), timeout=120.0))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()
    want = collections.Counter({(cid, "fport/news", b"m%d" % i, 0, False): 1
                                for cid in (f"fs{k}" for k in range(12))
                                for i in range(8)})
    assert got == want
    if fabric:
        assert fab["role"] == "owner" and fab["counters"]["submit_fallbacks"] == 0


# ------------------------------------------------- PeerClient (transport)
async def _echo_server(m):
    async def handler(mtype, body, _node):
        return body

    server = m.transport.ClusterServer("127.0.0.1", 0, handler)
    await server.start()
    return server


@pytest.mark.parametrize("pkg", ["torch"])
def test_peer_client_concurrent_first_calls(pkg):
    """Eight calls on a fresh ``PeerClient`` at once (a heartbeat, the
    startup retain pull and publish forwards do this): one connection,
    every call answered. The JAX package's client opens several, closes the
    dropped ones, and their read loops fail the live calls."""
    m = PKGS[pkg]

    async def run():
        server = await _echo_server(m)
        peer = m.transport.PeerClient(2, "127.0.0.1", server.bound_port)
        try:
            got = await asyncio.gather(*(peer.call("echo", i) for i in range(8)),
                                       return_exceptions=True)
            return got, len(server._conns)
        finally:
            await peer.close()
            await server.stop()

    got, conns = asyncio.run(asyncio.wait_for(run(), timeout=20.0))
    assert got == list(range(8)) and conns == 1


@pytest.mark.parametrize("pkg", ["torch"])
def test_peer_client_counts_a_failed_connect_once(pkg):
    """Calls to a peer that is not listening yet (a worker that starts a
    moment later) count one failure each on its breaker: it opens after its
    threshold of calls, not half of it. The JAX package's client counts a
    failed connect twice (in the connect and again in the call), so three
    start-up calls opened the breaker and dropped the first cross-worker
    publishes for its cooldown."""
    m = PKGS[pkg]
    port = _free_port()

    async def run():
        peer = m.transport.PeerClient(2, "127.0.0.1", port)
        states = []
        for _ in range(peer.breaker.threshold):
            with pytest.raises(m.transport.PeerUnavailable):
                await peer.call("heartbeat", None, timeout=1.0)
            states.append((peer.breaker.failures, peer.breaker.state))
        return states, peer.breaker

    states, breaker = asyncio.run(asyncio.wait_for(run(), timeout=20.0))
    n = breaker.threshold
    assert states[:-1] == [(k, breaker.CLOSED) for k in range(1, n)]
    assert states[-1][1] == breaker.OPEN


@pytest.mark.parametrize("pkg", ["torch"])
def test_cluster_server_stop_closes_a_link_accepted_meanwhile(pkg):
    """A peer connects just as ``ClusterServer.stop`` runs: the loop has
    accepted the link, but its handler starts only after ``stop()`` closed
    the links it knew of. ``stop()`` still returns, because the handler
    sees the server closing and closes its link. Each yield count between
    the connect and ``stop()`` lands the call at another step of the
    accept; on the JAX package's server the counts 3 and 4 wait forever
    in ``wait_closed()`` (Python 3.12), for the handler of a link nobody
    closes."""
    m = PKGS[pkg]

    async def handler(mtype, body, _node):
        return body

    async def one(yields):
        server = m.transport.ClusterServer("127.0.0.1", 0, handler)
        await server.start()
        with socket.create_connection(("127.0.0.1", server.bound_port)):
            for _ in range(yields):
                await asyncio.sleep(0)
            await asyncio.wait_for(server.stop(), timeout=5.0)
        return len(server._conns)

    async def run():
        return [await one(k) for k in range(8)]

    assert asyncio.run(asyncio.wait_for(run(), timeout=60.0)) == [0] * 8


@pytest.mark.parametrize("pkg", ["torch"])
def test_vote_request_closes_the_leader_breaker(pkg):
    """A leader's breaker to a peer opens while the peer is down. When the
    peer comes back with the same id and an empty log, its first (pre-)vote
    request reaches the leader: the leader closes its breaker to it, and
    its next heartbeat reaches the peer, which so learns the leader before
    its first CONNECT proposes a handshake lock. The JAX package's leader
    keeps the breaker open for its cooldown (3 s, doubled by each failed
    probe), and the restarted node's proposals fail meanwhile."""
    m = PKGS[pkg]
    port = _free_port()

    async def run():
        peer = m.transport.PeerClient(3, "127.0.0.1", port)
        node = m.raft_node.RaftNode(1, {3: peer}, apply_cb=None)
        node.term, node.state, node.leader_id = 1, m.raft_node.LEADER, 1
        node._next_index, node._match_index = {3: 1}, {3: 0}
        for _ in range(peer.breaker.threshold):
            await node._replicate(3)  # the peer is down: each heartbeat fails
        assert peer.breaker.state == peer.breaker.OPEN
        heard = []

        async def restarted(mtype, body, _node):
            heard.append(mtype)
            return {"term": body["term"], "success": True}

        server = m.transport.ClusterServer("127.0.0.1", port, restarted)
        await server.start()
        try:
            reply = await node.on_message(m.raft_node.RAFT_VOTE, {
                "term": 1, "candidate": 3, "last_log_index": 0,
                "last_log_term": 0, "prevote": True})
            await node._replicate(3)
            return reply, heard
        finally:
            await peer.close()
            await server.stop()

    reply, heard = asyncio.run(asyncio.wait_for(run(), timeout=20.0))
    assert reply == {"term": 1, "granted": False}
    assert heard == [t_raft_node.RAFT_APPEND]
