"""The port's plugins and bridges against the JAX package's: each drive
feeds the same plugin configuration and the same client script to the JAX
broker (its trie router) and to the port's broker with every routing
batch on ``TorchRouter(device="cpu")`` (``RMQTT_HYBRID_MAX=0``), and the
results are identical: deliveries, acks and reason codes, ``$SYS`` leaves,
hook and auth posts, bridge traffic. The stores of the retainer,
session-storage and message-storage plugins written by either package's
broker load into the other's with identical replays. The Kafka, NATS,
Pulsar and ReductStore bridges run against the fakes of the JAX package's
tests."""

import asyncio
import base64
import collections
import importlib
import json
import shutil
import subprocess
import time

import pytest

import rmqtt_tpu.broker.context as j_context
import rmqtt_tpu.broker.server as j_server
import rmqtt_tpu_torch.broker.context as t_context
import rmqtt_tpu_torch.broker.server as t_server
from rmqtt_tpu.broker.auth import RC_CONTINUE_AUTHENTICATION, cram_response
from rmqtt_tpu.broker.codec import packets as pk, props as P
from rmqtt_tpu_torch.bench.workloads import gen_retained_topics
from rmqtt_tpu_torch.core.trie import RetainTree
from rmqtt_tpu_torch.router import TorchRouter

from tests.mqtt_client import TestClient
from tests.test_kafka_bridge import FakeKafka
from tests.test_nats_limit import MiniNatsServer
from tests.test_plugins2 import make_jwt
from tests.test_pulsar_bridge import FakePulsar
from tests.test_reductstore_bridge import FakeReduct

PKGS = {"jax": (j_context, j_server, "rmqtt_tpu"),
        "torch": (t_context, t_server, "rmqtt_tpu_torch")}


@pytest.fixture(autouse=True)
def _every_batch_on_the_matcher(monkeypatch):
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")


def _plugin_cls(pkg: str, module: str, cls: str):
    return getattr(importlib.import_module(f"{PKGS[pkg][2]}.plugins.{module}"), cls)


async def _broker(pkg: str, plugins=(), retain_tpu: bool = False, **cfg):
    """A started broker of ``pkg`` with ``plugins`` ((module, class,
    config) each) registered: the JAX package's on its trie, the port's on
    ``TorchRouter(device="cpu")``; ``retain_tpu`` puts the port's retained
    store on its scanner (threshold 50, on the CPU)."""
    ctx_mod, server_mod, _root = PKGS[pkg]
    kw = {}
    if pkg == "torch":
        kw["router"] = TorchRouter(device="cpu")
        if retain_tpu:
            cfg.update(retain_tpu=True, retain_tpu_threshold=50)
            kw["retain_device"] = "cpu"
    b = server_mod.MqttBroker(ctx_mod.ServerContext(ctx_mod.BrokerConfig(port=0, **cfg),
                                                    **kw))
    for module, cls, pcfg in plugins:
        b.ctx.plugins.register(_plugin_cls(pkg, module, cls)(b.ctx, pcfg))
    await b.start()
    return b


def _both(drive, timeout: float = 20.0) -> dict:
    """``drive(pkg)`` run once on each package → {pkg: result}."""
    return {pkg: asyncio.run(asyncio.wait_for(drive(pkg), timeout)) for pkg in PKGS}


async def _drain(clients, quiet: float = 0.3) -> collections.Counter:
    """Every PUBLISH the clients hold or receive until ``quiet`` seconds
    pass without one → multiset of (client id, topic, payload, qos)."""
    got = collections.Counter()

    async def one(cid, c):
        try:
            while True:
                p = await c.recv(timeout=quiet)
                got[(cid, p.topic, bytes(p.payload), p.qos)] += 1
        except asyncio.TimeoutError:
            pass

    await asyncio.gather(*(one(cid, c) for cid, c in clients.items()))
    return got


# ----------------------------------------------------------- routing plugins
ROUTING_PLUGINS = [
    ("topic_rewrite", "TopicRewritePlugin", {"rules": [
        {"source_topic_filter": "old/#", "dest_topic": "new/%c", "action": "publish"},
        {"source_topic_filter": "legacy/#", "dest_topic": "v2/$1",
         "regex": r"^legacy/(.+)$"}]}),
    ("auto_subscription", "AutoSubscriptionPlugin", {"subscribes": [["inbox/%c", 1]]}),
    ("shared_sub", "SharedSubscriptionPlugin", {"strategy": "round_robin_per_group"}),
    ("p2p", "P2pPlugin", {}),
    ("acl_file", "AclFilePlugin", {"rules": [
        {"permission": "deny", "action": "publish", "clientid": "mallory",
         "topics": ["secret/#"]},
        {"permission": "deny", "action": "subscribe", "topics": ["forbidden/#"]},
        {"permission": "allow"}]}),
]


def test_routing_plugins_match_the_jax_broker():
    """Topic rewrite (a placeholder and a regex rule), auto-subscription,
    a shared group of three under round robin per group, p2p and the ACL
    file: the same deliveries (client, topic, payload, QoS) and the same
    SUBACK and PUBACK reason codes on both brokers."""
    async def drive(pkg):
        b = await _broker(pkg, ROUTING_PLUGINS)
        try:
            port = b.port
            names = ["w0", "w1", "w2", "rw-sub", "auto-c", "bob", "mallory", "alice"]
            c = {n: await TestClient.connect(port, n, version=pk.V5) for n in names}
            codes = {}
            for n in ("w0", "w1", "w2"):
                codes[n] = (await c[n].subscribe("$share/g/work/+", qos=1)).reason_codes
            codes["rw-sub"] = (await c["rw-sub"].subscribe("new/#", "v2/#",
                                                            qos=1)).reason_codes
            codes["mallory"] = (await c["mallory"].subscribe("forbidden/x", "open/+",
                                                              qos=1)).reason_codes
            await asyncio.sleep(0.05)  # auto-subscriptions land after CONNACK
            acks = []
            for i in range(9):
                acks.append((await c["alice"].publish(f"work/{i}", b"w%d" % i,
                                                      qos=1)).reason_code)
            acks.append((await c["alice"].publish("old/x", b"moved", qos=1)).reason_code)
            acks.append((await c["alice"].publish("legacy/a/b", b"re", qos=1)).reason_code)
            acks.append((await c["alice"].publish("inbox/auto-c", b"auto", qos=1)).reason_code)
            acks.append((await c["alice"].publish("$p2p/bob/chat", b"hi bob",
                                                  qos=1)).reason_code)
            acks.append((await c["mallory"].publish("secret/x", b"no", qos=1)).reason_code)
            acks.append((await c["mallory"].publish("open/1", b"yes", qos=1)).reason_code)
            got = await _drain(c)
            for cl in c.values():
                await cl.disconnect_clean()
            return codes, acks, got
        finally:
            await b.stop()

    res = _both(drive)
    assert res["torch"] == res["jax"]
    codes, acks, got = res["torch"]
    assert codes["mallory"] == [0x87, 1] and acks[-2] == 0x87
    assert got[("rw-sub", "new/alice", b"moved", 1)] == 1
    assert got[("rw-sub", "v2/a/b", b"re", 1)] == 1
    assert got[("auto-c", "inbox/auto-c", b"auto", 1)] == 1
    assert got[("bob", "chat", b"hi bob", 1)] == 1
    assert got[("mallory", "open/1", b"yes", 1)] == 1
    shared = collections.Counter(cid for (cid, t, *_r) in got.elements()
                                 if t.startswith("work/"))
    assert shared == {"w0": 3, "w1": 3, "w2": 3}


# ------------------------------------------------------------ the stores
def _cross(write, read, tmp_path):
    """``write(pkg, dir)`` by each package into a directory of its own, then
    ``read(pkg, dir)`` by each package from a copy of each directory →
    {(writer, reader): result}."""
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        asyncio.run(asyncio.wait_for(write(pkg, tmp_path / pkg), 20.0))
    out = {}
    for writer in PKGS:
        for reader in PKGS:
            copy = tmp_path / f"{writer}-read-by-{reader}"
            shutil.copytree(tmp_path / writer, copy)
            out[(writer, reader)] = asyncio.run(asyncio.wait_for(read(reader, copy), 20.0))
    return out


def test_retainer_store_loads_across_packages(tmp_path):
    """Retained messages persisted by the retainer of either package's broker
    load into both: the port's broker keeps them on its scanner (past a
    lowered threshold, on the CPU) and replays exactly what the JAX broker
    replays from its trie, equal to ``RetainTree``."""
    import random

    topics = gen_retained_topics(random.Random(12), 120)
    filters = ["#", "+/#", "/".join(topics[0].split("/")[:2]) + "/#",
               topics[1], "+/+/+"]
    oracle = RetainTree()
    for i, t in enumerate(topics):
        oracle.insert(t, i)
    want = collections.Counter((f"r{j}", topics[i], b"k%d" % i, 0)
                               for j, f in enumerate(filters)
                               for _lv, i in oracle.matches(f))

    def plugin(path):
        return [("retainer", "RetainerPlugin", {"path": str(path / "retainer.db")})]

    async def write(pkg, path):
        b = await _broker(pkg, plugin(path))
        try:
            pub = await TestClient.connect(b.port, "pub")
            for i, t in enumerate(topics):
                await pub.publish(t, b"k%d" % i, qos=1, retain=True)
            await pub.disconnect_clean()
        finally:
            await b.stop()

    async def read(pkg, path):
        b = await _broker(pkg, plugin(path), retain_tpu=True)
        try:
            subs = {f"r{j}": await TestClient.connect(b.port, f"r{j}")
                    for j in range(len(filters))}
            for (cid, c), f in zip(subs.items(), filters):
                await c.subscribe(f, qos=0)
            got = await _drain(subs)
            for c in subs.values():
                await c.disconnect_clean()
            scans = b.ctx.retain.scans if pkg == "torch" else len(filters)
            return got, scans
        finally:
            await b.stop()

    out = _cross(write, read, tmp_path)
    assert all(got == want for got, _s in out.values())
    assert all(scans == len(filters) for _g, scans in out.values())
    assert sum(want.values()) > 2 * len(topics)


def test_session_and_message_storage_carry_across(tmp_path):
    """A persistent session (session-storage) and a stored message
    (message-storage) written by either package's broker: after a restart
    on the other's (or its own) store, the session resumes with its
    subscription and the publish it missed, and a late subscriber gets the
    stored message once."""
    def plugins(path):
        return [("session_storage", "SessionStoragePlugin",
                 {"path": str(path / "sessions.db")}),
                ("message_storage", "MessageStoragePlugin",
                 {"path": str(path / "messages.db"), "expiry": 60})]

    async def write(pkg, path):
        b = await _broker(pkg, plugins(path))
        try:
            c = await TestClient.connect(b.port, "comeback", version=pk.V5,
                                         properties={P.SESSION_EXPIRY_INTERVAL: 300})
            await c.subscribe("stored/t", qos=1)
            await c.disconnect_clean()
            pub = await TestClient.connect(b.port, "pub")
            await pub.publish("stored/m", b"before-sub", qos=1)
            await pub.disconnect_clean()
            await asyncio.sleep(0.05)  # the session snapshot follows the disconnect
        finally:
            await b.stop()

    async def read(pkg, path):
        b = await _broker(pkg, plugins(path))
        try:
            pub = await TestClient.connect(b.port, "pub")
            await pub.publish("stored/t", b"while-down", qos=1)
            c = await TestClient.connect(b.port, "comeback", version=pk.V5,
                                         clean_start=False,
                                         properties={P.SESSION_EXPIRY_INTERVAL: 300})
            late = await TestClient.connect(b.port, "late")
            await late.subscribe("stored/#", qos=1)
            got = await _drain({"comeback": c, "late": late})
            await late.unsubscribe("stored/#")
            await late.subscribe("stored/#", qos=1)
            again = await _drain({"late": late})
            for cl in (c, late, pub):
                await cl.disconnect_clean()
            return c.connack.session_present, got, again
        finally:
            await b.stop()

    out = _cross(write, read, tmp_path)
    first = out[("jax", "jax")]
    assert all(v == first for v in out.values())
    present, got, again = first
    assert present and again == collections.Counter()
    assert got[("comeback", "stored/t", b"while-down", 1)] == 1
    assert got[("late", "stored/m", b"before-sub", 1)] == 1


# ---------------------------------------------------------------- $SYS
def test_sys_topic_matches_the_jax_broker():
    """sys-topic on both brokers: the same ``$SYS`` leaves in a publish
    cycle and the same client event topics; the port's ``device/hbm``
    carries the occupancy model (``modeled_bytes``), as the JAX broker's
    does. The port's broker also publishes ``routing/failover``: the JAX
    broker's trie has no device plane."""
    async def drive(pkg):
        b = await _broker(pkg, [("sys_topic", "SysTopicPlugin", {"publish_interval": 0.3})])
        try:
            c = await TestClient.connect(b.port, "syswatch")
            await c.subscribe("$SYS/#", qos=0)
            await TestClient.connect(b.port, "evt")
            # each cycle starts with the version row (and the subscribe
            # replays it retained): its third arrival closes a whole cycle
            leaves, hbm, versions = set(), None, 0
            while versions < 3:
                p = await c.recv(timeout=5.0)
                leaf = p.topic.split("/", 3)[3]
                leaves.add(leaf)
                versions += leaf == "version"
                if leaf == "device/hbm":
                    hbm = json.loads(p.payload)
            return leaves, hbm
        finally:
            await b.stop()

    res = _both(drive)
    (jl, jhbm), (tl, thbm) = res["jax"], res["torch"]
    # the device plane's own leaves: the failover state, the kernel
    # dispatch stage's latency, and slow operations where one was slow
    # the latency rows name each package's own stages (the JAX broker's
    # routing cache, the port's kernel dispatch); the port's broker adds
    # its device plane's failover state
    def rows(leaves):
        return {leaf for leaf in leaves if not leaf.startswith("latency/")}

    assert rows(tl) - rows(jl) == {"routing/failover"} and rows(jl) <= rows(tl)
    assert any(leaf.startswith("latency/publish/") for leaf in jl & tl)
    assert {"version", "stats", "clients/evt/connected", "device/hbm"} <= tl
    assert "modeled_bytes" in jhbm and "modeled_bytes" in thbm


# ------------------------------------------------------------------- auth
async def _http_endpoint(events: list):
    """auth-http (``/auth``: every user but ``baduser``) and web-hook
    (``/hook``) endpoint → the started server."""
    async def handler(reader, writer):
        try:
            path = (await reader.readline()).split()[1].decode()
            length = 0
            while (line := await reader.readline()) not in (b"\r\n", b""):
                if line.lower().startswith(b"content-length"):
                    length = int(line.split(b":")[1])
            body = (await reader.readexactly(length)).decode()
            if path == "/auth":
                events.append(("auth", body))
                status, out = ((b"403 Forbidden", b"deny") if "baduser" in body
                               else (b"200 OK", b"allow"))
            else:
                hook = json.loads(body)
                events.append(("hook", hook["action"], hook.get("clientid")))
                status, out = b"200 OK", b"ok"
            writer.write(b"HTTP/1.1 %s\r\nContent-Length: %d\r\n\r\n%s"
                         % (status, len(out), out))
            await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(handler, "127.0.0.1", 0)


def test_auth_http_and_web_hook_match_the_jax_broker():
    """auth-http allows and refuses the same CONNECTs, and the web hook posts
    the same events (connect, subscribe, disconnect), in the same order."""
    async def drive(pkg):
        events = []
        http = await _http_endpoint(events)
        url = f"http://127.0.0.1:{http.sockets[0].getsockname()[1]}"
        b = await _broker(pkg, [
            ("auth_http", "AuthHttpPlugin", {"http_auth_req": f"{url}/auth"}),
            ("web_hook", "WebHookPlugin", {"urls": [f"{url}/hook"], "events": [
                "client_connected", "session_subscribed", "client_disconnected"]})],
            allow_anonymous=False)
        try:
            codes = []
            for cid, user in (("good", "alice"), ("bad", "baduser"), ("good2", "carol")):
                c = await TestClient.connect(b.port, cid, version=pk.V5, username=user)
                codes.append(c.connack.reason_code)
                if c.connack.reason_code == 0:
                    await c.subscribe("hooked/+", qos=1)
                    await c.disconnect_clean()
                else:
                    await c.close()
                await asyncio.sleep(0.1)  # one client's hook posts at a time
            t0 = time.perf_counter()
            while len(events) < 9 and time.perf_counter() - t0 < 5:
                await asyncio.sleep(0.02)
            return codes, [e[:2] if e[0] == "auth" else e for e in events]
        finally:
            await b.stop()
            http.close()

    res = _both(drive)
    assert res["torch"] == res["jax"]
    codes, events = res["torch"]
    assert codes[0] == 0 and codes[1] != 0 and codes[2] == 0
    assert ("hook", "session_subscribed", "good2") in events


@pytest.fixture(scope="module")
def signing_keys(tmp_path_factory):
    """An RSA and a P-256 key pair from openssl (an independent signer)."""
    d = tmp_path_factory.mktemp("jwt")
    keys = {}
    for alg, gen in (("RS256", ["openssl", "genrsa", "-out", str(d / "RS256.key"), "2048"]),
                     ("ES256", ["openssl", "ecparam", "-name", "prime256v1", "-genkey",
                                "-noout", "-out", str(d / "ES256.key")])):
        subprocess.run(gen, check=True, capture_output=True)
        kind = "rsa" if alg == "RS256" else "ec"
        subprocess.run(["openssl", kind, "-in", str(d / f"{alg}.key"), "-pubout", "-out",
                        str(d / f"{alg}.pub")], check=True, capture_output=True)
        keys[alg] = (d / f"{alg}.key", (d / f"{alg}.pub").read_text())
    return d, keys


def _signed_jwt(d, key, alg: str, claims: dict) -> str:
    """An RS256 or ES256 token over ``claims`` signed by openssl (ES256's DER
    signature turned into the raw r || s a JWT carries)."""
    from rmqtt_tpu.plugins.auth_jwt import _der_read

    def b64(b):
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    signing = f"{b64(json.dumps({'alg': alg, 'typ': 'JWT'}).encode())}." \
              f"{b64(json.dumps(claims).encode())}"
    blob = d / "in.bin"
    blob.write_bytes(signing.encode())
    sig = subprocess.run(["openssl", "dgst", "-sha256", "-sign", str(key), str(blob)],
                         check=True, capture_output=True).stdout
    if alg == "ES256":
        _, seq, _ = _der_read(sig, 0)
        _, r, after = _der_read(seq, 0)
        _, s, _ = _der_read(seq, after)
        sig = int.from_bytes(r, "big").to_bytes(32, "big") + \
            int.from_bytes(s, "big").to_bytes(32, "big")
    return f"{signing}.{b64(sig)}"


def test_auth_jwt_and_cram_match_the_jax_broker(signing_keys):
    """auth-jwt with HS256 (claims carrying an ACL), RS256 and ES256 public
    keys, and auth-cram's SCRAM-style AUTH exchange: the same CONNACK,
    SUBACK and PUBACK reason codes on both brokers."""
    d, keys = signing_keys
    exp = time.time() + 300
    hs = {"good": make_jwt(b"s3cret", {"exp": exp, "acl": {"pub": ["ok/#"],
                                                          "sub": ["ok/#"]}}),
          "bad": make_jwt(b"wrong", {"exp": exp}),
          "old": make_jwt(b"s3cret", {"exp": time.time() - 5})}
    signed = {alg: _signed_jwt(d, key, alg, {"sub": alg, "exp": exp})
              for alg, (key, _pem) in keys.items()}

    def responder(secret: bytes):
        async def handler(client, p):
            if p.reason_code == RC_CONTINUE_AUTHENTICATION:
                nonce = p.properties.get(P.AUTHENTICATION_DATA)
                await client._send(pk.Auth(RC_CONTINUE_AUTHENTICATION, {
                    P.AUTHENTICATION_METHOD: "CRAM-SHA256",
                    P.AUTHENTICATION_DATA: cram_response(secret, nonce)}))

        return handler

    async def drive(pkg):
        out = []
        b = await _broker(pkg, [("auth_jwt", "AuthJwtPlugin", {"secret": "s3cret"})],
                          allow_anonymous=False)
        try:
            c = await TestClient.connect(b.port, "hs", version=pk.V5, username="u",
                                         password=hs["good"].encode())
            out.append(c.connack.reason_code)
            out += (await c.subscribe("ok/t", "forbidden/t", qos=1)).reason_codes
            out.append((await c.publish("ok/t", b"x", qos=1)).reason_code)
            out.append((await c.publish("forbidden/t", b"x", qos=1)).reason_code)
            await c.disconnect_clean()
            for name in ("bad", "old"):
                c = await TestClient.connect(b.port, name, version=pk.V5,
                                             password=hs[name].encode())
                out.append(c.connack.reason_code)
                await c.close()
        finally:
            await b.stop()
        for alg, (_key, pem) in keys.items():
            b = await _broker(pkg, [("auth_jwt", "AuthJwtPlugin", {"public_key_pem": pem})],
                              allow_anonymous=False)
            try:
                for name, token in ((alg, signed[alg]),
                                    ("other", signed["ES256" if alg == "RS256" else "RS256"])):
                    c = await TestClient.connect(b.port, name, version=pk.V5,
                                                 password=token.encode())
                    out.append((alg, name, c.connack.reason_code))
                    await c.close()
            finally:
                await b.stop()
        b = await _broker(pkg, [("auth_cram", "AuthCramPlugin", {"users": {"alice": "wonderland"}})])
        try:
            for cid, secret in (("cram-ok", b"wonderland"), ("cram-bad", b"nope")):
                c = await TestClient.connect(
                    b.port, cid, version=pk.V5, username="alice",
                    properties={P.AUTHENTICATION_METHOD: "CRAM-SHA256"},
                    auth_handler=responder(secret))
                out.append((cid, c.connack.reason_code))
                await c.close()
        finally:
            await b.stop()
        return out

    res = _both(drive)
    assert res["torch"] == res["jax"]
    out = res["torch"]
    assert out[:5] == [0, 1, 0x87, 0, 0x87] and out[5] != 0 and out[6] != 0
    assert ("RS256", "RS256", 0) in out and ("ES256", "ES256", 0) in out
    assert ("RS256", "other", 0) not in out and ("cram-ok", 0) in out
    assert ("cram-bad", 0) not in out


# ---------------------------------------------------------------- bridges
def test_mqtt_bridges_match_the_jax_broker():
    """The MQTT ingress and egress bridges between two brokers of one
    package: the same messages in under the local prefix and out under the
    remote prefix."""
    async def drive(pkg):
        remote = await _broker(pkg)
        local = await _broker(pkg, [
            ("bridge_mqtt", "BridgeIngressMqttPlugin", {
                "host": "127.0.0.1", "port": remote.port, "local_prefix": "in/",
                "subscribes": [{"filter": "from-remote/#", "qos": 1}]}),
            ("bridge_mqtt", "BridgeEgressMqttPlugin", {
                "host": "127.0.0.1", "port": remote.port, "remote_prefix": "out/",
                "forwards": ["to-remote/#"]})])
        try:
            for p in local.ctx.plugins._plugins.values():
                await asyncio.wait_for(p._client.connected.wait(), 5.0)
            lsub = await TestClient.connect(local.port, "lsub")
            await lsub.subscribe("in/#", qos=1)
            rsub = await TestClient.connect(remote.port, "rsub")
            await rsub.subscribe("out/#", qos=1)
            rpub = await TestClient.connect(remote.port, "rpub")
            lpub = await TestClient.connect(local.port, "lpub")
            for i in range(16):
                await rpub.publish(f"from-remote/{i}", b"in%d" % i, qos=1)
                await lpub.publish(f"to-remote/{i}", b"out%d" % i, qos=1)
            got = await _drain({"lsub": lsub, "rsub": rsub}, quiet=0.5)
            for c in (lsub, rsub, rpub, lpub):
                await c.disconnect_clean()
            return got
        finally:
            await local.stop()
            await remote.stop()

    res = _both(drive)
    assert res["torch"] == res["jax"]
    assert sum(res["torch"].values()) == 32
    assert res["torch"][("lsub", "in/from-remote/3", b"in3", 1)] == 1
    assert res["torch"][("rsub", "out/to-remote/3", b"out3", 1)] == 1


def test_external_bridges_match_the_jax_broker():
    """The NATS, Kafka and Pulsar ingress and egress bridges and the
    ReductStore egress bridge against the JAX package's test fakes: the
    same local deliveries and the same records at each fake."""
    async def drive(pkg):
        nats, kafka, pulsar, reduct = MiniNatsServer(), FakeKafka(npartitions=1), \
            FakePulsar(), FakeReduct()
        for f in (nats, kafka, pulsar, reduct):
            await f.start()
        kafka.log("commands", 0).append((b"dev-1", b"reboot", [("corr", b"abc")], 5))
        pulsar.seed("persistent://public/default/cmds", [("corr", "xyz")], b"do-it")
        b = await _broker(pkg, [
            ("bridge_nats", "BridgeIngressNatsPlugin", {
                "host": "127.0.0.1", "port": nats.port, "subscribes": ["from-nats/#"],
                "local_prefix": "nats/"}),
            ("bridge_nats", "BridgeEgressNatsPlugin", {
                "host": "127.0.0.1", "port": nats.port, "forwards": ["to-nats/#"]}),
            ("bridge_kafka", "BridgeEgressKafkaPlugin", {
                "servers": f"127.0.0.1:{kafka.port}",
                "forwards": [{"filter": "k/#", "remote_topic": "events", "partition": -1}]}),
            ("bridge_pulsar", "BridgeEgressPulsarPlugin", {
                "servers": f"127.0.0.1:{pulsar.port}",
                "forwards": [{"filter": "pl/#",
                              "remote_topic": "persistent://public/default/events"}]}),
            ("bridge_reductstore", "BridgeEgressReductstorePlugin", {
                "url": f"http://127.0.0.1:{reduct.port}",
                "forwards": [{"filter": "rs/#", "bucket": "mqtt", "entry": "events"}]}),
        ])
        try:
            for name in ("rmqtt-bridge-ingress-nats", "rmqtt-bridge-egress-nats"):
                await asyncio.wait_for(b.ctx.plugins.get(name)._client.connected.wait(), 5)
            sub = await TestClient.connect(b.port, "sub", version=pk.V5)
            await sub.subscribe("nats/#", "kafka/#", "pulsar/#", qos=0)
            # the Kafka and Pulsar ingress start consuming at once (from the
            # earliest record): loaded once the subscriber is there
            for module, cls, cfg in (
                    ("bridge_kafka", "BridgeIngressKafkaPlugin", {
                        "servers": f"127.0.0.1:{kafka.port}",
                        "subscribes": [{"topic": "commands", "local_topic": "kafka/${topic}",
                                        "offset": "earliest", "qos": 0}]}),
                    ("bridge_pulsar", "BridgeIngressPulsarPlugin", {
                        "servers": f"127.0.0.1:{pulsar.port}",
                        "subscribes": [{"topic": "persistent://public/default/cmds",
                                        "subscription": "rmqtt",
                                        "initial_position": "earliest",
                                        "local_topic": "pulsar/cmds", "qos": 0}]})):
                plugin = _plugin_cls(pkg, module, cls)(b.ctx, cfg)
                b.ctx.plugins.register(plugin)
                assert await b.ctx.plugins.start(plugin.name)
            await asyncio.sleep(0.1)  # the NATS SUB reaches the server
            r, w = await asyncio.open_connection("127.0.0.1", nats.port)
            await r.readline()
            w.write(b"CONNECT {}\r\nPUB from-nats.a.b 5\r\nhello\r\n")
            await w.drain()
            pub = await TestClient.connect(b.port, "pub", version=pk.V5)
            for topic in ("to-nats/x/y", "k/dev/1", "pl/a", "rs/dev/1"):
                await pub.publish(topic, topic.encode(), qos=1)
            got = []
            try:
                for _ in range(3):
                    got.append(await sub.recv(timeout=10))
            except asyncio.TimeoutError:
                raise AssertionError(f"{pkg}: ingress delivered {[p.topic for p in got]}")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 10 and not (
                    nats.published and kafka.log("events", 0) and reduct.records
                    and "persistent://public/default/events" in pulsar.topics):
                await asyncio.sleep(0.05)
            local = sorted((p.topic, bytes(p.payload),
                            sorted(p.properties.get(P.USER_PROPERTY, [])))
                           for p in got)
            def untraced(props):  # each publish carries a trace id of its own
                return [(k, v) for k, v in props if k != "mqtt_trace_id"]

            remote = {
                "nats": sorted(nats.published),
                "kafka": [(k, v, untraced(h)) for k, v, h, _ts in kafka.log("events", 0)],
                "pulsar": [(untraced(props), v) for props, v in
                           pulsar.topics.get("persistent://public/default/events", [])],
                "reduct": [(bk, e, lb, body) for bk, e, _ts, lb, body in reduct.records],
            }
            w.close()
            await sub.disconnect_clean()
            await pub.disconnect_clean()
            return local, remote
        finally:
            await asyncio.wait_for(b.stop(), 10)
            for f in (nats, kafka, pulsar, reduct):
                await asyncio.wait_for(f.stop(), 10)

    res = _both(drive, timeout=40.0)
    assert res["torch"] == res["jax"]
    local, remote = res["torch"]
    assert [t for t, *_r in local] == ["kafka/commands", "nats/from-nats/a/b", "pulsar/cmds"]
    assert ("to-nats.x.y", b"to-nats/x/y") in remote["nats"]
    assert [v for _k, v, _h in remote["kafka"]] == [b"k/dev/1"]
    assert remote["pulsar"] and remote["reduct"][0][3] == b"rs/dev/1"
