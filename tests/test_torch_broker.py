"""The port's broker (``rmqtt_tpu_torch.broker``): its modules are the JAX
package's with imports rewritten (one case per file, the deliberate
changes listed with their reasons); it serves MQTT over TCP with every
routed batch on ``TorchRouter(device="cpu")`` and delivers exactly what the
JAX package's broker on its trie router delivers; with ``[retain] tpu``
its retained replay runs on the scanner and equals the JAX broker's; a
configuration that names any plugin or bridge starts it;
``--router xla`` and ``[retain] tpu`` need a CUDA device."""

import asyncio
import collections
import difflib
import gc
import json
import pathlib
import random
import re
import threading
import tomllib

import pytest
import torch

from rmqtt_tpu.broker.context import BrokerConfig as JBrokerConfig
from rmqtt_tpu.broker.context import ServerContext as JServerContext
from rmqtt_tpu.broker.server import MqttBroker as JMqttBroker
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.broker import server as tserver
from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
from rmqtt_tpu_torch.conf import PLUGIN_REGISTRY
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter
from rmqtt_tpu_torch.router.default import DefaultRouter

from tests.mqtt_client import TestClient

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "rmqtt_tpu"
PORT_PKG = ROOT / "rmqtt_tpu_torch"

# ---------------------------------------------------------------- copies
#: the rewrite that turns a JAX-package module into its port: the package
#: name, paths into the reference source tree made relative, and the JAX
#: package's own change numbers dropped from comments
_RULES = [
    (re.compile(r" \(PR ?\d+\)"), ""),
    (re.compile(r"\bPR ?\d+'s\b"), "the"),
    (re.compile(r"^PR ?\d+ made", re.M), "The device profiler made"),
    (re.compile(r"\(PR ?\d+ "), "("),
    (re.compile(r" PR ?\d+\b"), ""),
]


#: an absolute path into the reference checkout, e.g. ``/x/reference/``
_REFERENCE_PREFIX = re.compile(r"(?<![\w.])/\w+/reference/")


def rewrite(text: str) -> str:
    text = _REFERENCE_PREFIX.sub("", text).replace("rmqtt_tpu", "rmqtt_tpu_torch")
    for rx, sub in _RULES:
        text = rx.sub(sub, text)
    return text


#: ported modules that differ from the rewrite on purpose
DELIBERATE = {
    "broker/__main__.py": "main() runs under the __main__ check, so importing "
                          "the module (the boundary test does) starts nothing",
    "broker/context.py": "router 'xla' runs the CUDA probe (utils/cudaprobe.py: "
                         "a subprocess count that refuses the start, never a "
                         "CPU fallback) and builds TorchRouter; retain_device= "
                         "goes to RetainStore; stats() adds the retained-scan "
                         "gauges",
    "cluster/transport.py": "PeerClient serializes its connects (a lock, as "
                            "the fabric's _Link has): concurrent first "
                            "callers opened two connections, the dropped "
                            "writer closed, and its read loop tore down the "
                            "live one with the pending calls on it; and a "
                            "call counts a failed send once on the breaker "
                            "(it counted twice, opening it after half its "
                            "threshold); ClusterServer.stop sets a closing "
                            "flag before close(), and a link whose handler "
                            "starts after that closes itself: stop() closed "
                            "only the links it knew of, and wait_closed() "
                            "(py3.12) waited forever for one accepted just "
                            "before close()",
    "cluster/raft.py": "a vote request closes the node's breaker to the "
                       "candidate: a leader whose breaker opened while a "
                       "peer was down heartbeat the restarted peer only "
                       "after the cooldown (doubled by each failed probe), "
                       "so the peer knew no leader and its first CONNECT's "
                       "hs_lock timed out (ROADMAP Queue C item 4)",
    "broker/hostprof.py": "its lock is reentrant: the gc callback runs on "
                          "whichever thread collects, also one that holds "
                          "the lock (a plain Lock deadlocks the broker)",
    "broker/retain.py": "the device mirror runs on the port's scanner on an "
                        "explicit device: tpu=True resolves it at construction "
                        "(with none given, after the CUDA probe, which refuses "
                        "the start without a usable card) and builds the "
                        "kernels there, instead of tpuprobe's "
                        "ensure_safe_platform at the first scan; device_stats() "
                        "counts scans and kernel launches",
    "broker/devprof.py": "the HBM census reads the CUDA allocator instead of "
                         "jax.live_arrays()",
    "broker/routing.py": "stats() also reports the words kernels' and the "
                         "compaction tails' launch counts "
                         "(routing_kernel_launches_packed/_legacy/_fused_tail/"
                         "_compact_global); a "
                         "kernel fault rejects the batch instead of failing "
                         "over to the host trie",
    "broker/failover.py": "a kernel fault in the half-open probe routes on "
                          "the card again instead of keeping the host plane",
    "broker/server.py": "parse_args(argv) split out of main(argv)",
    "runtime/__init__.py": "the port's own binding: builds with g++ into "
                           "_build/, binds the trie, the topic encoder "
                           "(NativeEncoder, without the stale-library branches), "
                           "codec and validation, not the match decoders",
    "router/torch_router.py": "TorchRouter, the port of XlaRouter",
    "bench/scenarios.py": "overload_burst reads its verdict once the broker "
                          "has taken the whole burst in (publish.received): "
                          "on the card's device router each publish of a "
                          "connection is one dispatch, so the broker was "
                          "still reading the burst when the last pulse was "
                          "written, and the drops read then missed the "
                          "backlog (held line for line by "
                          "test_scenarios_copy_differs_only_in_overload_burst)",
}

_COPIED = ([p.relative_to(JAX_PKG).as_posix()
            for p in sorted((JAX_PKG / "broker").rglob("*.py"))]
           + ["conf.py", "plugins/__init__.py", "cluster/__init__.py",
              "cluster/wire.py", "cluster/messages.py",
              "cluster/transport.py", "cluster/membership.py",
              "cluster/broadcast.py", "cluster/raft.py", "cluster/raft_mode.py",
              "storage/__init__.py", "storage/sqlite.py", "storage/redis.py",
              "utils/__init__.py",
              "utils/failpoints.py", "utils/counter.py", "utils/sysmon.py",
              "ops/hybrid.py", "router/default.py", "router/native.py",
              "router/cache.py", "core/topic.py", "utils/httpc.py", "utils/ec.py",
              "bench/scenarios.py"]
           + [p.relative_to(JAX_PKG).as_posix()
              for d in ("plugins", "bridge")
              for p in sorted((JAX_PKG / d).glob("*.py"))
              if p.name != "__init__.py" or d == "bridge"])
VERBATIM = [rel for rel in _COPIED if rel not in DELIBERATE]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    want = rewrite((JAX_PKG / rel).read_text())
    assert (PORT_PKG / rel).read_text() == want, (
        f"rmqtt_tpu_torch/{rel} is no longer the JAX package's module with "
        "imports rewritten: port the change there too, or list it in "
        "DELIBERATE with its reason")


def test_scenarios_copy_differs_only_in_overload_burst():
    """``bench/scenarios.py`` is the JAX module after the rewrite but for
    one block of lines inserted into ``overload_burst`` (its DELIBERATE
    entry)."""
    want = rewrite((JAX_PKG / "bench/scenarios.py").read_text()).splitlines()
    got = (PORT_PKG / "bench/scenarios.py").read_text().splitlines()
    ops = [op for op in difflib.SequenceMatcher(None, want, got, autojunk=False)
           .get_opcodes() if op[0] != "equal"]
    assert len(ops) == 1 and ops[0][0] == "insert", ops
    start = want.index("async def overload_burst(broker, msgs: int = 5000, payload: int = 1024,")
    end = next(i for i, line in enumerate(want) if line.startswith("async def failpoint_kill("))
    assert start < ops[0][1] < end


def test_every_broker_module_is_ported():
    jax_side = {p.relative_to(JAX_PKG).as_posix()
                for p in (JAX_PKG / "broker").rglob("*.py")}
    port_side = {p.relative_to(PORT_PKG).as_posix()
                 for p in (PORT_PKG / "broker").rglob("*.py")}
    assert jax_side == port_side and len(port_side) == 41
    for rel in DELIBERATE:
        assert (PORT_PKG / rel).exists(), rel


def test_every_plugin_and_bridge_module_is_ported():
    """Every module of ``plugins/`` and ``bridge/`` and the two utilities
    they import, and each is held to the JAX package by the copy check."""
    def modules(pkg):
        return ({p.relative_to(pkg).as_posix()
                 for d in ("plugins", "bridge") for p in (pkg / d).glob("*.py")}
                | {"utils/httpc.py", "utils/ec.py"})

    jax_side, port_side = modules(JAX_PKG), modules(PORT_PKG)
    assert jax_side == port_side and len(port_side) == 27
    assert all((PORT_PKG / rel).exists() for rel in port_side)
    assert port_side <= set(_COPIED)


# ---------------------------------------------------------- live TCP drive
async def _drive(port: int, subs, topics, want_n):
    """Subscribe ``subs`` ({client: [(filter, qos)]}), publish ``topics``
    at QoS 0/1/2 from 25 clients, read until every subscriber has its
    ``want_n`` deliveries and then a short quiet window → received multiset
    of (client, topic, payload, qos)."""
    clients = {}
    for cid, rows in subs.items():
        c = await TestClient.connect(port, cid)
        for q in range(3):
            await c.subscribe(*[f for f, fq in rows if fq == q], qos=q)
        clients[cid] = c
    pubs = [await TestClient.connect(port, f"p{k}") for k in range(25)]

    async def publish(k, pub):
        # 25 publishers at once, so the routing batches hold several
        # topics; every 8th QoS 1/2 publish waits for its ack, which keeps
        # at most 8 in flight, inside the broker's inbound window of 16
        acked = 0
        for i in range(k, len(topics), len(pubs)):
            qos = i % 3
            acked += qos > 0
            await pub.publish(topics[i], f"m{i}".encode(), qos=qos,
                              wait_ack=qos > 0 and acked % 8 == 0)
        await pub.ping()

    await asyncio.gather(*(publish(k, pub) for k, pub in enumerate(pubs)))

    async def collect(cid, c):
        rows = []
        while len(rows) < want_n[cid]:
            rows.append(await c.recv(timeout=5.0))
        try:
            while True:
                rows.append(await c.recv(timeout=0.2))
        except asyncio.TimeoutError:
            pass
        return [(cid, p.topic, bytes(p.payload), p.qos) for p in rows]

    got = collections.Counter()
    for rows in await asyncio.gather(*(collect(cid, c) for cid, c in clients.items())):
        got.update(rows)
    for c in [*clients.values(), *pubs]:
        await c.disconnect_clean()
    return got


def test_live_tcp_drive_matches_the_jax_broker(monkeypatch):
    """The port's MqttBroker with every batch on TorchRouter(device="cpu")
    (hybrid off) against the JAX broker on its trie router: ~200 filters,
    500 publishes at QoS 0/1/2, identical deliveries, all on the device."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    rng = random.Random(5)
    filters = gen_mixed(rng, 200)
    subs = collections.defaultdict(list)
    for i, f in enumerate(filters):
        subs[f"s{i % 8}"].append((f, i % 3))
    topics = gen_topics_uniform(rng, 500)
    oracle = DefaultRouter()
    for cid, rows in subs.items():
        for f, q in rows:
            oracle.add(f, Id(1, cid), SubscriptionOptions(qos=q))
    want = collections.Counter()
    for i, topic in enumerate(topics):
        for rels in oracle.matches(None, topic).values():
            for r in rels:
                want[(r.id.client_id, topic, f"m{i}".encode())] += 1
    want_n = collections.Counter()
    for (cid, *_), n in want.items():
        want_n[cid] += n
    assert sum(want.values()) > 500

    async def run():
        jb = JMqttBroker(JServerContext(JBrokerConfig(port=0)))
        router = TorchRouter(device="cpu")
        tb = tserver.MqttBroker(ServerContext(BrokerConfig(port=0), router=router))
        await jb.start()
        await tb.start()
        try:
            got_j = await _drive(jb.port, subs, topics, want_n)
            fused0 = router.matcher.fused_batches
            got_t = await _drive(tb.port, subs, topics, want_n)
            st = tb.ctx.routing.stats()
            return got_j, got_t, router.matcher.fused_batches - fused0, st
        finally:
            await tb.stop()
            await jb.stop()

    got_j, got_t, fused, st = asyncio.run(asyncio.wait_for(run(), timeout=20.0))
    assert got_t == got_j
    no_qos = collections.Counter()
    for (cid, topic, payload, _qos), n in got_t.items():
        no_qos[(cid, topic, payload)] += n
    assert no_qos == want
    assert fused > 0 and st["routing_failover_state"] == 0
    assert st["routing_failovers"] == 0


def test_load_client_wave_on_cpu(monkeypatch):
    """The load client and oracle ``chip_smoke.py`` drives the broker with
    (``bench/mqtt_load.py``), here against an in-process broker with every
    batch on ``TorchRouter(device="cpu")``."""
    from rmqtt_tpu_torch.bench.mqtt_load import (LoadClient, connect_and_subscribe,
                                                 expected_deliveries, oracle_router,
                                                 publish_wave)

    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    rng = random.Random(6)
    filters = gen_mixed(rng, 300)
    subs = {f"s{k}": filters[k::4] for k in range(4)}
    topics = gen_topics_uniform(rng, 300)
    payloads = [b"p%d" % i for i in range(len(topics))]
    want = expected_deliveries(oracle_router(subs), topics, payloads)
    assert sum(want.values()) > 300

    async def run():
        router = TorchRouter(device="cpu")
        broker = tserver.MqttBroker(ServerContext(BrokerConfig(port=0), router=router))
        await broker.start()
        try:
            subscribers = await connect_and_subscribe(broker.port, subs)
            pubs = [await LoadClient.connect(broker.port, f"p{k}") for k in range(4)]
            f0 = router.matcher.fused_batches
            got, secs = await publish_wave(pubs, subscribers, topics, payloads,
                                           want, timeout=15.0, quiet=0.2)
            for c in [*subscribers, *pubs]:
                await c.close()
            return got, secs, router.matcher.fused_batches - f0
        finally:
            await broker.stop()

    got, secs, fused = asyncio.run(asyncio.wait_for(run(), timeout=20.0))
    assert got == want and secs > 0 and fused > 0


def test_unfused_router_knob_and_wave_on_cpu(monkeypatch):
    """``RMQTT_FUSED=0``: the router's matcher binds the ``fused`` knob
    (source ``env``) in the knob registry, and a live TCP wave through an
    in-process broker on ``TorchRouter(device="cpu")`` is exact, every batch
    on the unfused global path (no fused batch)."""
    from rmqtt_tpu_torch.bench.mqtt_load import (LoadClient, connect_and_subscribe,
                                                 expected_deliveries, oracle_router,
                                                 publish_wave)
    from rmqtt_tpu_torch.broker.knobs import build_registry

    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    monkeypatch.setenv("RMQTT_FUSED", "0")
    rng = random.Random(9)
    filters = gen_mixed(rng, 300)
    subs = {f"s{k}": filters[k::4] for k in range(4)}
    topics = gen_topics_uniform(rng, 200)
    payloads = [b"u%d" % i for i in range(len(topics))]
    want = expected_deliveries(oracle_router(subs), topics, payloads)
    assert sum(want.values()) > 200

    async def run():
        router = TorchRouter(device="cpu")
        rows = {r["name"]: r for r in build_registry(router, None).snapshot()}
        assert rows["fused"]["value"] is False and rows["fused"]["source"] == "env"
        assert "pallas" not in rows
        broker = tserver.MqttBroker(ServerContext(BrokerConfig(port=0), router=router))
        await broker.start()
        try:
            subscribers = await connect_and_subscribe(broker.port, subs)
            pubs = [await LoadClient.connect(broker.port, f"p{k}") for k in range(4)]
            got, _secs = await publish_wave(pubs, subscribers, topics, payloads,
                                            want, timeout=15.0, quiet=0.2)
            for c in [*subscribers, *pubs]:
                await c.close()
            return got, router.matcher.fused_batches
        finally:
            await broker.stop()

    got, fused = asyncio.run(asyncio.wait_for(run(), timeout=20.0))
    assert got == want and fused == 0


def test_gc_inside_the_host_profiler_lock():
    """A collection that starts while the host profiler holds its lock (its
    snapshot allocates under it) runs the profiler's gc callback on the
    same thread, which takes the lock again: it must not deadlock."""
    from rmqtt_tpu_torch.broker.hostprof import HostProfiler

    hp = HostProfiler(enabled=True)
    gc.callbacks.append(hp._gc_cb)
    try:
        done = threading.Event()

        def collect_under_the_lock():
            with hp._lock:
                gc.collect()
            done.set()

        threading.Thread(target=collect_under_the_lock, daemon=True).start()
        assert done.wait(10.0), "the gc callback waited on its own lock"
    finally:
        gc.callbacks.remove(hp._gc_cb)
    assert sum(hp.gc_pauses.values()) >= 1


# ------------------------------------------------------ configured plugins
def _toml(v) -> str:
    """A value of a ``[plugins.<name>]`` section in TOML (inline tables)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml(x) for x in v) + "]"
    return "{" + ", ".join(f"{k} = {_toml(x)}" for k, x in v.items()) + "}"


def _plugin_config(name: str, tmp_path, remote: dict) -> dict:
    """A ``[plugins.<name>]`` section that exercises the plugin; the bridges
    point at ``remote`` (the fakes' and a second broker's ports)."""
    http = f"http://127.0.0.1:{remote['http']}"
    return {
        "rmqtt-sys-topic": {"publish_interval": 0.5},
        "rmqtt-topic-rewrite": {"rules": [{"source_topic_filter": "old/#",
                                           "dest_topic": "new/%c"}]},
        "rmqtt-auto-subscription": {"subscribes": [["inbox/%c", 1]]},
        "rmqtt-counter": {},
        "rmqtt-shared-subscription": {"strategy": "hash_topic"},
        "rmqtt-p2p-messaging": {},
        "rmqtt-acl": {"rules": [{"permission": "deny", "action": "publish",
                                 "topics": ["secret/#"]}, {"permission": "allow"}]},
        "rmqtt-web-hook": {"urls": [f"{http}/hook"], "events": ["client_connected"]},
        "rmqtt-auth-http": {"http_auth_req": f"{http}/auth"},
        "rmqtt-auth-jwt": {"secret": "s3cret"},
        "rmqtt-auth-cram": {"users": {"dev": "pw"}},
        "rmqtt-session-storage": {"path": str(tmp_path / "sessions.db")},
        "rmqtt-message-storage": {"path": str(tmp_path / "messages.db"), "expiry": 60},
        "rmqtt-retainer": {"path": str(tmp_path / "retain.db")},
        "rmqtt-bridge-ingress-mqtt": {"port": remote["mqtt"],
                                      "subscribes": [{"filter": "r/#", "qos": 1}]},
        "rmqtt-bridge-egress-mqtt": {"port": remote["mqtt"], "forwards": ["l/#"]},
        "rmqtt-bridge-ingress-nats": {"port": remote["nats"], "subscribes": ["n/#"]},
        "rmqtt-bridge-egress-nats": {"port": remote["nats"], "forwards": ["n/#"]},
        "rmqtt-bridge-ingress-kafka": {
            "servers": f"127.0.0.1:{remote['kafka']}",
            "subscribes": [{"topic": "cmds", "local_topic": "k/${topic}",
                            "offset": "earliest"}]},
        "rmqtt-bridge-egress-kafka": {
            "servers": f"127.0.0.1:{remote['kafka']}",
            "forwards": [{"filter": "k/#", "remote_topic": "events"}]},
        "rmqtt-bridge-egress-reductstore": {
            "url": http.replace(str(remote["http"]), str(remote["reduct"])),
            "forwards": [{"filter": "rs/#", "bucket": "mqtt", "entry": "events"}]},
        "rmqtt-bridge-ingress-pulsar": {
            "servers": f"127.0.0.1:{remote['pulsar']}",
            "subscribes": [{"topic": "persistent://public/default/cmds",
                            "subscription": "rmqtt", "local_topic": "p/cmds"}]},
        "rmqtt-bridge-egress-pulsar": {
            "servers": f"127.0.0.1:{remote['pulsar']}",
            "forwards": [{"filter": "p/#",
                          "remote_topic": "persistent://public/default/events"}]},
    }[name]


async def _http_ok(reader, writer):
    """A local HTTP endpoint that allows every auth request and takes every
    hook post."""
    try:
        length = 0
        await reader.readline()
        while (line := await reader.readline()) not in (b"\r\n", b""):
            if line.lower().startswith(b"content-length"):
                length = int(line.split(b":")[1])
        await reader.readexactly(length)
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 5\r\n\r\nallow")
        await writer.drain()
    finally:
        writer.close()


@pytest.mark.parametrize("name", sorted(PLUGIN_REGISTRY))
def test_configured_plugin_starts(name, tmp_path, monkeypatch):
    """A TOML naming the plugin in ``[plugins] default_startups`` starts the
    port's broker through ``parse_args`` and ``_amain``: the plugin is
    registered with its section and active. The bridges point at the JAX
    package's test fakes (Kafka, NATS, Pulsar, ReductStore) and at a second
    broker of the port."""
    from tests.test_kafka_bridge import FakeKafka
    from tests.test_nats_limit import MiniNatsServer
    from tests.test_pulsar_bridge import FakePulsar
    from tests.test_reductstore_bridge import FakeReduct

    started = []
    broker_cls = tserver.MqttBroker

    class Recorded(broker_cls):
        def __init__(self, ctx):
            super().__init__(ctx)
            started.append(self)

    monkeypatch.setattr(tserver, "MqttBroker", Recorded)

    async def run():
        fakes = [FakeKafka(), MiniNatsServer(), FakePulsar(), FakeReduct()]
        for f in fakes:
            await f.start()
        http = await asyncio.start_server(_http_ok, "127.0.0.1", 0)
        remote = broker_cls(ServerContext(BrokerConfig(port=0)))
        await remote.start()
        ports = {"kafka": fakes[0].port, "nats": fakes[1].port, "pulsar": fakes[2].port,
                 "reduct": fakes[3].port, "http": http.sockets[0].getsockname()[1],
                 "mqtt": remote.port}
        section = "\n".join(f"{k} = {_toml(v)}"
                            for k, v in _plugin_config(name, tmp_path, ports).items())
        cfg = tmp_path / "rmqtt.toml"
        cfg.write_text(f'[listener]\nport = 0\n[plugins]\ndefault_startups = ["{name}"]\n'
                       f"[plugins.{name}]\n{section}\n")
        args = tserver.parse_args(["--config", str(cfg), "--no-http-api"])
        main = asyncio.create_task(tserver._amain(args))
        try:
            while not (started and started[0]._server is not None):
                assert not main.done(), main.exception()
                await asyncio.sleep(0.02)
            (plugin,) = started[0].ctx.plugins.describe()
            got = (plugin["name"], plugin["active"],
                   started[0].ctx.plugins.get(name).config)
        finally:
            main.cancel()
            await asyncio.gather(main, return_exceptions=True)
            if started:
                await started[0].stop()
            await remote.stop()
            http.close()
            for f in fakes:
                await f.stop()
        return got, section

    (got_name, active, config), section = asyncio.run(asyncio.wait_for(run(), 30.0))
    assert (got_name, active) == (name, True)
    assert config == tomllib.loads(section)


def test_router_xla_needs_cuda(monkeypatch):
    """``--router xla`` is TorchRouter on the current CUDA device: without
    one the start raises, and nothing routes on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerContext(BrokerConfig(router="xla", port=0))
    args = tserver.parse_args(["--router", "xla", "--port", "0", "--no-http-api"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(asyncio.wait_for(tserver._amain(args), timeout=20.0))


def test_retain_tpu_needs_cuda(monkeypatch, tmp_path):
    """``[retain] tpu = true`` puts the retained scan on the current CUDA
    device: without one the start raises, and no scan runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerContext(BrokerConfig(port=0, retain_tpu=True))
    cfg = tmp_path / "rmqtt.toml"
    cfg.write_text("[listener]\nport = 0\n[retain]\ntpu = true\n")
    args = tserver.parse_args(["--config", str(cfg), "--no-http-api"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(asyncio.wait_for(tserver._amain(args), timeout=20.0))
    assert ServerContext(BrokerConfig(port=0, retain_tpu=True),
                         retain_device="cpu").retain._device.type == "cpu"


async def _replay(port: int, topics, filters, want_n):
    """Publish ``topics`` retained (payload = index) from 4 clients, then
    subscribe each filter from a client of its own and read its ``want_n``
    replayed messages and a short quiet window → received multiset of
    (client, topic, payload, retain flag)."""
    pubs = [await TestClient.connect(port, f"rp{k}") for k in range(4)]
    for i, t in enumerate(topics):
        await pubs[i % 4].publish(t, f"r{i}".encode(), qos=1, retain=True)
    subs = []
    for j, f in enumerate(filters):
        c = await TestClient.connect(port, f"rs{j}")
        await c.subscribe(f, qos=0)
        subs.append(c)

    async def collect(j, c):
        rows = [await c.recv(timeout=5.0) for _ in range(want_n[j])]
        try:
            while True:
                rows.append(await c.recv(timeout=0.2))
        except asyncio.TimeoutError:
            pass
        return [(f"rs{j}", p.topic, bytes(p.payload), p.retain) for p in rows]

    got = collections.Counter()
    for rows in await asyncio.gather(*(collect(j, c) for j, c in enumerate(subs))):
        got.update(rows)
    for c in [*pubs, *subs]:
        await c.disconnect_clean()
    return got


def test_retained_replay_matches_the_jax_broker():
    """The port's broker with ``retain_tpu`` on the scanner (``device="cpu"``,
    a threshold the store passes) replays exactly what the JAX broker
    replays from its trie: $SYS rows, a bare '#', '+/#', deep filters."""
    from rmqtt_tpu_torch.bench.retained_cases import TABLE_FILTERS, TABLE_TOPICS
    from rmqtt_tpu_torch.core.trie import RetainTree

    rng = random.Random(8)
    topics = list(dict.fromkeys([t for t in TABLE_TOPICS if t] + [
        "/".join(rng.choice("abcd") for _ in range(rng.randint(1, 5)))
        for _ in range(300)]))
    filters = list(TABLE_FILTERS) + ["a/+", "+/b/+", "c/#"]
    oracle = RetainTree()
    for i, t in enumerate(topics):
        oracle.insert(t, i)
    want_n = [len(oracle.matches(f)) for f in filters]

    async def run():
        jb = JMqttBroker(JServerContext(JBrokerConfig(port=0)))
        tb = tserver.MqttBroker(ServerContext(
            BrokerConfig(port=0, retain_tpu=True, retain_tpu_threshold=50),
            retain_device="cpu"))
        await jb.start()
        await tb.start()
        try:
            got_j = await _replay(jb.port, topics, filters, want_n)
            got_t = await _replay(tb.port, topics, filters, want_n)
            return got_j, got_t, tb.ctx.stats().to_json()
        finally:
            await tb.stop()
            await jb.stop()

    got_j, got_t, st = asyncio.run(asyncio.wait_for(run(), timeout=60.0))
    assert got_t == got_j and sum(got_j.values()) == sum(want_n) > 500
    assert all(retain for (*_k, retain) in got_t)
    assert st["retained_scans"] == len(filters) and st["retained_mirror_build_ms"] > 0
    assert st["retaineds"] == len(topics)


def test_trie_and_native_routers_need_no_device():
    for name in ("trie", "native"):
        ctx = ServerContext(BrokerConfig(router=name, port=0))
        assert type(ctx.router).__name__ == {"trie": "DefaultRouter",
                                             "native": "NativeRouter"}[name]
