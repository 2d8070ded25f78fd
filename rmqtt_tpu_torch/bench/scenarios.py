"""Scenario matrix: composable load phases → named profiles → one report.

The broker benchmarking literature (PAPERS.md, arxiv 2603.21600) shows
edge/IoT broker behavior is dominated by *mixed* phases — connect storms
while fan-in runs, subscribe churn under overload — which five separate
bench scripts each tested in isolation with divergent ad-hoc JSON. This
module is the convergence point:

phase primitives
    Small async functions (``connect_storm``, ``subscribe_churn``,
    ``fan_in``, ``fan_out``, ``pipe``/``pipe_qos1``, ``overload_burst``,
    ``failpoint_kill``, ``durable_qos``) that each drive one traffic
    shape against a REAL broker (real sockets, real MQTT frames) and
    return one stats row with an ``ok`` verdict.

profiles
    Named compositions (``PROFILES``): phases grouped into steps, phases
    within a step running CONCURRENTLY (the mixed-regime point —
    ``storm_churn_overload_kill`` runs a connect storm, subscribe churn,
    an overload burst and a failpoint-driven device kill all at once).
    Each profile declares the broker config it needs (router, overload
    watermarks, storage plugins) and its ``[slo]`` objectives, so the
    broker-side SLO engine (broker/slo.py) judges the run.

``ScenarioReport``
    One JSON schema (``SCHEMA``) for every runner and legacy script:
    goodput, broker-side per-stage p50/p99 pulled from `/api/v1/latency`,
    reason-labeled drop deltas, RSS (start/peak/end), live burn-rate
    samples observed mid-run, and per-objective SLO verdicts. ``ok``
    gates CI: exit codes follow it (scripts/slo_matrix.py).

The broker runs as a subprocess by default (honest RSS, env knobs like
``RMQTT_HYBRID_MAX=0`` for the all-device kill profile); ``inproc=True``
runs it in-process through the same TOML config path for the tier-1
smoke profile, where re-importing jax per run would dominate.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.codec import MqttCodec, packets as pk
from rmqtt_tpu_torch.utils.sysmon import rss_mb

SCHEMA = "rmqtt_tpu_torch.scenario_report/1"

REPO = Path(__file__).resolve().parent.parent.parent


# ----------------------------------------------------------------- report
def base_report(profile: str, mode: str = "subprocess") -> dict:
    """The shared ScenarioReport skeleton every entry point fills."""
    return {
        "schema": SCHEMA,
        "profile": profile,
        "mode": mode,
        "started_at": round(time.time(), 3),
        "duration_s": None,
        "ok": None,
        "phases": [],
        "goodput": {},
        "latency": {},
        "drops": {},
        "rss_mb": {},
        "slo": None,
        "slo_live": None,
        "errors": [],
    }


def finish_report(report: dict, ok: bool) -> dict:
    report["duration_s"] = round(time.time() - report["started_at"], 3)
    report["ok"] = bool(ok)
    return report


def write_report(report: dict, out: Optional[str]) -> None:
    """One compact JSON line to stdout (the machine-readable contract)
    plus an optional pretty file."""
    print(json.dumps(report, sort_keys=True))
    if out:
        Path(out).write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
        print(f"report -> {out} (ok={report['ok']})", file=sys.stderr)


def latency_stages(latency_body: dict) -> dict:
    """`/api/v1/latency` → {stage: {count, p50_ms, p99_ms}} for the report
    (ns → ms; count-unit stages keep raw units)."""
    out = {}
    for stage, row in (latency_body.get("histograms") or {}).items():
        if not row.get("count"):
            continue
        if row.get("unit") == "ns":
            out[stage] = {"count": row["count"],
                          "p50_ms": round(row["p50"] / 1e6, 3),
                          "p99_ms": round(row["p99"] / 1e6, 3)}
        else:
            out[stage] = {"count": row["count"], "p50": row["p50"],
                          "p99": row["p99"], "unit": row.get("unit")}
    return out


def drop_deltas(metrics0: dict, metrics1: dict) -> dict:
    """Reason-labeled drop-counter deltas across the run."""
    out = {}
    for key, after in metrics1.items():
        if not key.startswith("messages.dropped"):
            continue
        delta = after - metrics0.get(key, 0)
        if delta:
            reason = key[len("messages.dropped."):] or "total"
            out["total" if key == "messages.dropped" else reason] = delta
    return out


# ---------------------------------------------------------- mini client
class MiniClient:
    """Bench-grade asyncio MQTT client: enough for the phases (CONNECT,
    SUBSCRIBE/UNSUBSCRIBE, QoS0/1/2 publish + receive with auto-ack) and
    nothing more. Tests use the richer tests/mqtt_client.py; this one
    lives with the bench package so the runner has no test imports."""

    def __init__(self, reader, writer, codec) -> None:
        self.reader = reader
        self.writer = writer
        self.codec = codec
        self.publishes: asyncio.Queue = asyncio.Queue()
        self.received = 0
        self.auto_ack = True
        self._acks: Dict[tuple, asyncio.Future] = {}
        self._pid = 0
        self._task: Optional[asyncio.Task] = None

    @classmethod
    async def connect(cls, port: int, cid: str, clean_start: bool = True,
                      keepalive: int = 120, retries: int = 4,
                      host: str = "127.0.0.1",
                      auto_ack: bool = True) -> "MiniClient":
        """``auto_ack`` must be set HERE, not after connect returns: a
        resumed session's queued deliveries start arriving the moment the
        CONNACK lands, racing any post-connect attribute flip."""
        last: Optional[Exception] = None
        for attempt in range(retries):
            writer = c = None
            try:
                reader, writer = await asyncio.open_connection(host, port)
                codec = MqttCodec()
                writer.write(codec.encode(pk.Connect(
                    client_id=cid, clean_start=clean_start,
                    keepalive=keepalive)))
                await writer.drain()
                c = cls(reader, writer, codec)
                c.auto_ack = auto_ack
                c._task = asyncio.ensure_future(c._read_loop())
                ack = await c._wait(("connack",), timeout=10.0)
                if ack.reason_code != 0:
                    raise ConnectionError(f"refused rc={ack.reason_code}")
                return c
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                # the handshake busy gate legitimately refuses storms; the
                # failed attempt must not leak its socket or read task (the
                # broker would keep counting it as a live connection)
                last = e
                if c is not None:
                    await c.close()
                elif writer is not None:
                    try:
                        writer.close()
                    except Exception:
                        pass
                await asyncio.sleep(0.2 * (attempt + 1))
        raise last if last is not None else ConnectionError("connect failed")

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self.reader.read(1 << 16)
                if not data:
                    return
                for p in self.codec.feed(data):
                    await self._on_packet(p)
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass

    async def _on_packet(self, p) -> None:
        if isinstance(p, pk.Connack):
            self._resolve(("connack",), p)
        elif isinstance(p, pk.Publish):
            self.received += 1
            if self.auto_ack:
                if p.qos == 1:
                    await self._send(pk.Puback(p.packet_id))
                elif p.qos == 2:
                    await self._send(pk.Pubrec(p.packet_id))
            await self.publishes.put(p)
        elif isinstance(p, pk.Puback):
            self._resolve(("puback", p.packet_id), p)
        elif isinstance(p, pk.Pubrec):
            self._resolve(("pubrec", p.packet_id), p)
            await self._send(pk.Pubrel(p.packet_id))
        elif isinstance(p, pk.Pubcomp):
            self._resolve(("pubcomp", p.packet_id), p)
        elif isinstance(p, pk.Pubrel):
            await self._send(pk.Pubcomp(p.packet_id))
        elif isinstance(p, pk.Suback):
            self._resolve(("suback", p.packet_id), p)
        elif isinstance(p, pk.Unsuback):
            self._resolve(("unsuback", p.packet_id), p)

    async def _send(self, p) -> None:
        self.writer.write(self.codec.encode(p))
        await self.writer.drain()

    def _resolve(self, key, value) -> None:
        fut = self._acks.get(key)
        if fut is not None and not fut.done():
            fut.set_result(value)

    async def _wait(self, key, timeout: float = 10.0):
        fut = asyncio.get_running_loop().create_future()
        self._acks[key] = fut
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._acks.pop(key, None)

    def _next_pid(self) -> int:
        self._pid = self._pid % 65000 + 1
        return self._pid

    async def subscribe(self, *filters: str, qos: int = 0) -> None:
        pid = self._next_pid()
        await self._send(pk.Subscribe(
            pid, [(f, pk.SubOpts(qos=qos)) for f in filters]))
        await self._wait(("suback", pid))

    async def unsubscribe(self, *filters: str) -> None:
        pid = self._next_pid()
        await self._send(pk.Unsubscribe(pid, list(filters)))
        await self._wait(("unsuback", pid))

    async def publish(self, topic: str, payload: bytes = b"x", qos: int = 0,
                      retain: bool = False) -> None:
        pid = self._next_pid() if qos else None
        await self._send(pk.Publish(topic=topic, payload=payload, qos=qos,
                                    retain=retain, packet_id=pid))
        if qos == 1:
            await self._wait(("puback", pid))
        elif qos == 2:
            await self._wait(("pubcomp", pid))

    async def blast(self, topic: str, n: int, payload: bytes = b"x" * 64,
                    chunk: int = 64, pause_s: float = 0.0) -> None:
        """QoS0 firehose: pre-encoded frame written in chunks so the bench
        client isn't the syscall bottleneck; ``pause_s`` spreads the blast
        so broker-side samplers (overload/SLO) get ticks mid-burst."""
        frame = self.codec.encode(pk.Publish(topic=topic, payload=payload))
        full, rest = divmod(n, chunk)
        batch = frame * chunk
        for _ in range(full):
            self.writer.write(batch)
            if self.writer.transport.get_write_buffer_size() > 1 << 20:
                await self.writer.drain()
            if pause_s:
                await asyncio.sleep(pause_s)
        self.writer.write(frame * rest)
        await self.writer.drain()

    async def drain(self, want: int, timeout: float = 30.0) -> int:
        """Receive until ``want`` publishes or timeout; returns the count."""
        deadline = time.monotonic() + timeout
        got = 0
        while got < want:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                await asyncio.wait_for(self.publishes.get(), left)
            except asyncio.TimeoutError:
                break
            got += 1
        return got

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
        try:
            self.writer.close()
        except Exception:
            pass


async def _http_json(port: int, path: str, method: str = "GET",
                     obj: Any = None, timeout: float = 10.0):
    """One admin-API round trip against the broker's HTTP port."""
    payload = json.dumps(obj).encode() if obj is not None else b""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), timeout)
        status = int(status_line.split()[1])
        length = 0
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout)
            if line in (b"\r\n", b""):
                break
            k, _, v = line.decode("latin1").partition(":")
            if k.strip().lower() == "content-length":
                length = int(v)
        body = await asyncio.wait_for(reader.readexactly(length), timeout)
        return status, json.loads(body)
    finally:
        writer.close()


# --------------------------------------------------------------- profiles
@dataclass
class Profile:
    """One named scenario: broker shape + SLO objectives + phase steps."""

    name: str
    descr: str
    #: steps run in order; phases WITHIN a step run concurrently
    steps: Tuple[Tuple[Tuple[str, Callable, Dict[str, Any]], ...], ...]
    #: [[slo.objectives]] rows written into the broker's config
    slo: Tuple[Dict[str, Any], ...] = ()
    router: str = "trie"
    #: extra TOML appended to the generated config ({workdir} formatted in)
    extra_toml: str = ""
    #: subprocess env overrides (e.g. RMQTT_HYBRID_MAX=0)
    env: Dict[str, str] = field(default_factory=dict)
    slo_sample_interval: float = 0.25
    slo_fast_window_s: float = 3.0
    slo_slow_window_s: float = 15.0
    #: profiles whose broker shape needs env knobs or real process
    #: isolation refuse the in-process fast path
    subprocess_only: bool = False
    #: custom orchestrator: a profile that cannot run as phases against ONE
    #: broker (the multi-node cluster scenarios) supplies its own
    #: ``async runner(profile, inproc, workdir) -> ScenarioReport`` and
    #: run_profile_async delegates to it wholesale
    runner: Optional[Callable] = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return json.dumps(str(v))


def profile_toml(profile: Profile, port: int, api_port: int,
                 workdir: str) -> str:
    """The broker config one profile runs under: telemetry + SLO engine on
    with bench-scale windows, the profile's objectives as
    [[slo.objectives]] rows, and its extra sections appended."""
    lines = [
        "[listener]", 'host = "127.0.0.1"', f"port = {port}", "",
        "[node]", f'router = "{profile.router}"', "",
        "[observability]", "enable = true", "slow_ms = 250.0", "",
        "[slo]", "enable = true",
        f"sample_interval = {profile.slo_sample_interval}",
        f"fast_window_s = {profile.slo_fast_window_s}",
        f"slow_window_s = {profile.slo_slow_window_s}", "",
    ]
    for obj in profile.slo:
        lines.append("[[slo.objectives]]")
        lines.extend(f"{k} = {_toml_value(v)}" for k, v in obj.items())
        lines.append("")
    lines += ["[http_api]", 'host = "127.0.0.1"', f"port = {api_port}", "",
              "[log]", 'to = "off"', ""]
    extra = profile.extra_toml.format(workdir=workdir)
    return "\n".join(lines) + extra + "\n"


class ScenarioBroker:
    """The broker under test + its admin API, subprocess or in-process.

    Subprocess is the default (own RSS, own env, real process isolation);
    ``inproc`` drives the SAME TOML through conf.load into an in-process
    MqttBroker for the tier-1 smoke profile, where paying a jax re-import
    per run would dominate the runtime."""

    def __init__(self, profile: Profile, workdir: str,
                 inproc: bool = False) -> None:
        if inproc and profile.subprocess_only:
            raise ValueError(f"profile {profile.name} needs a subprocess "
                             f"broker (env overrides / process isolation)")
        self.profile = profile
        self.workdir = workdir
        self.inproc = inproc
        self.port = _free_port()
        self.api_port = _free_port()
        self.proc: Optional[subprocess.Popen] = None
        self._inproc_broker = None
        self._inproc_api = None
        self._inproc_cluster = None

    async def start(self) -> None:
        conf_path = Path(self.workdir) / "rmqtt.toml"
        conf_path.write_text(
            profile_toml(self.profile, self.port, self.api_port,
                         self.workdir))
        if self.inproc:
            from rmqtt_tpu_torch import conf
            from rmqtt_tpu_torch.broker.context import ServerContext
            from rmqtt_tpu_torch.broker.http_api import HttpApi
            from rmqtt_tpu_torch.broker.server import MqttBroker

            settings = conf.load(str(conf_path))
            broker = MqttBroker(ServerContext(settings.broker))
            conf.instantiate_plugins(broker.ctx, settings)
            api = HttpApi(broker.ctx, **settings.http_api)
            await broker.start()
            await api.start()
            self._inproc_broker, self._inproc_api = broker, api
        else:
            env = dict(os.environ, JAX_PLATFORMS="cpu", **self.profile.env)
            # append: a crash-torture restart must not truncate the
            # killed process's log (it is the post-mortem)
            log_f = open(Path(self.workdir) / "broker.log", "ab")
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "rmqtt_tpu_torch.broker",
                 "--config", str(conf_path)],
                cwd=str(REPO), env=env, stdout=log_f, stderr=log_f)
            log_f.close()
        deadline = time.monotonic() + 120.0
        for check_port in (self.port, self.api_port):
            while True:
                if self.proc is not None and self.proc.poll() is not None:
                    tail = (Path(self.workdir) / "broker.log").read_bytes()[-2000:]
                    raise RuntimeError(
                        f"broker exited rc={self.proc.returncode} before "
                        f"listening: ...{tail.decode(errors='replace')}")
                try:
                    with socket.create_connection(
                        ("127.0.0.1", check_port), timeout=0.3
                    ):
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise RuntimeError("broker never started listening")
                    await asyncio.sleep(0.15)

    def rss(self) -> float:
        return rss_mb(self.proc.pid if self.proc is not None else None)

    async def api(self, path: str, method: str = "GET", obj: Any = None):
        status, body = await _http_json(self.api_port, path, method, obj)
        if status != 200:
            raise RuntimeError(f"{method} {path} -> {status}: {body}")
        return body

    def kill(self) -> None:
        """SIGKILL the broker subprocess — no shutdown path runs, no
        flush, no goodbyes (the crash-torture primitive). ``start()``
        again restarts it on the same ports and workdir."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=10)
            self.proc = None

    async def stop(self) -> None:
        if self.inproc:
            if self._inproc_api is not None:
                await self._inproc_api.stop()
            if self._inproc_broker is not None:
                await self._inproc_broker.stop()
        elif self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


# ------------------------------------------------------- phase primitives
# every phase: async (broker, **params) -> stats dict with an "ok" bool

async def connect_storm(broker, conns: int = 100, wave: int = 25,
                        hold_s: float = 0.3,
                        min_established_frac: float = 0.95) -> dict:
    """Dial ``conns`` connections in waves (the storm regime), hold them
    briefly, then close; the broker's busy gate may refuse mid-wave —
    clients retry like real fleets do."""
    clients: List[MiniClient] = []
    failures = 0
    t0 = time.monotonic()
    tag = f"storm-{int(t0 * 1000) % 100000}"
    for start in range(0, conns, wave):
        n = min(wave, conns - start)
        results = await asyncio.gather(
            *(MiniClient.connect(broker.port, f"{tag}-{start + i}")
              for i in range(n)),
            return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                failures += 1
            else:
                clients.append(r)
    secs = time.monotonic() - t0
    await asyncio.sleep(hold_s)
    for c in clients:
        await c.close()
    established = len(clients)
    return {
        "ok": established >= conns * min_established_frac,
        "established": established, "failures": failures,
        "seconds": round(secs, 3),
        "handshakes_per_s": round(established / secs, 1) if secs else 0.0,
    }


async def subscribe_churn(broker, clients: int = 8, rounds: int = 12,
                          filters_per: int = 4) -> dict:
    """Wildcard subscribe/unsubscribe churn: every round each client swaps
    its whole filter set — the regime that invalidates match caches and
    (on device routers) dirties the HBM table."""
    conns = [await MiniClient.connect(broker.port, f"churn-{i}")
             for i in range(clients)]
    subs = unsubs = 0
    t0 = time.monotonic()
    try:
        for r in range(rounds):
            for i, c in enumerate(conns):
                filters = [f"churn/{i}/{r % 3}/{j}/+" for j in range(filters_per)]
                await c.subscribe(*filters, qos=0)
                subs += len(filters)
                await c.unsubscribe(*filters)
                unsubs += len(filters)
    finally:
        for c in conns:
            await c.close()
    return {"ok": True, "subscribes": subs, "unsubscribes": unsubs,
            "seconds": round(time.monotonic() - t0, 3)}


async def fan_in(broker, pubs: int = 16, msgs_per: int = 120, qos: int = 0,
                 payload: int = 64, min_delivery_frac: float = 1.0,
                 topic_prefix: str = "fi") -> dict:
    """N publishers → 1 subscriber (device-fleet telemetry ingest)."""
    sub = await MiniClient.connect(broker.port, f"{topic_prefix}-sub")
    await sub.subscribe(f"{topic_prefix}/#", qos=qos)
    publishers = [await MiniClient.connect(broker.port, f"{topic_prefix}-p{i}")
                  for i in range(pubs)]
    expected = pubs * msgs_per
    t0 = time.monotonic()
    try:
        if qos == 0:
            await asyncio.gather(*(
                p.blast(f"{topic_prefix}/{i}", msgs_per, b"x" * payload)
                for i, p in enumerate(publishers)))
        else:
            async def _pump(i, p):
                for k in range(msgs_per):
                    await p.publish(f"{topic_prefix}/{i}", b"x" * payload,
                                    qos=qos)
            await asyncio.gather(*(
                _pump(i, p) for i, p in enumerate(publishers)))
        got = await sub.drain(expected, timeout=60.0)
    finally:
        for c in [sub, *publishers]:
            await c.close()
    secs = time.monotonic() - t0
    return {
        "ok": got >= expected * min_delivery_frac,
        "published": expected, "delivered": got,
        "seconds": round(secs, 3),
        "msgs_per_s": round(got / secs, 1) if secs else 0.0,
    }


async def fan_out(broker, subs: int = 20, msgs: int = 120, qos: int = 0,
                  payload: int = 64, min_delivery_frac: float = 1.0,
                  topic: str = "fo/cmd") -> dict:
    """1 publisher → N subscribers (command fan-out to a fleet)."""
    subscribers = [await MiniClient.connect(broker.port, f"fo-s{i}")
                   for i in range(subs)]
    for c in subscribers:
        await c.subscribe(topic, qos=qos)
    publ = await MiniClient.connect(broker.port, "fo-pub")
    t0 = time.monotonic()
    try:
        if qos == 0:
            await publ.blast(topic, msgs, b"x" * payload)
        else:
            for _ in range(msgs):
                await publ.publish(topic, b"x" * payload, qos=qos)
        got = sum(await asyncio.gather(*(
            c.drain(msgs, timeout=60.0) for c in subscribers)))
    finally:
        for c in [publ, *subscribers]:
            await c.close()
    secs = time.monotonic() - t0
    expected = subs * msgs
    return {
        "ok": got >= expected * min_delivery_frac,
        "published": msgs, "delivered": got, "expected": expected,
        "seconds": round(secs, 3),
        "deliveries_per_s": round(got / secs, 1) if secs else 0.0,
    }


async def pipe(broker, msgs: int = 5000, payload: int = 64) -> dict:
    """1→1 QoS0 pipe (raw throughput floor) — fan_in degenerate case."""
    return await fan_in(broker, pubs=1, msgs_per=msgs, qos=0,
                        payload=payload, topic_prefix="pipe")


async def pipe_qos1(broker, msgs: int = 2000, payload: int = 64,
                    window: int = 64) -> dict:
    """1→1 QoS1 pipe, publisher pipelined ``window`` deep and paced by
    deliveries (stays under the broker's bounded deliver queue, so
    nothing is policy-dropped) — the lossless end-to-end figure."""
    sub = await MiniClient.connect(broker.port, "pq1-sub")
    await sub.subscribe("pq1/t", qos=1)
    publ = await MiniClient.connect(broker.port, "pq1-pub")
    t0 = time.monotonic()
    deadline = t0 + 120.0
    state = {"sent": 0, "got": 0}
    try:
        # BOTH halves share the deadline: if deliveries stall, the paced
        # sender would otherwise spin forever after the receiver gives up
        # and the whole profile would hang instead of reporting FAIL
        async def sender():
            while state["sent"] < msgs and time.monotonic() < deadline:
                if state["sent"] - state["got"] >= window * 4:
                    await asyncio.sleep(0.002)
                    continue
                burst = bytearray()
                for _ in range(min(window, msgs - state["sent"])):
                    state["sent"] += 1
                    burst += publ.codec.encode(pk.Publish(
                        topic="pq1/t", payload=b"x" * payload, qos=1,
                        packet_id=(state["sent"] % 65000) + 1))
                publ.writer.write(bytes(burst))
                await publ.writer.drain()

        async def receiver():
            while state["got"] < msgs and time.monotonic() < deadline:
                try:
                    await asyncio.wait_for(sub.publishes.get(), 2.0)
                except asyncio.TimeoutError:
                    continue
                state["got"] += 1

        await asyncio.gather(sender(), receiver())
    finally:
        for c in (sub, publ):
            await c.close()
    secs = time.monotonic() - t0
    return {
        "ok": state["got"] == msgs,
        "published": state["sent"], "delivered": state["got"],
        "seconds": round(secs, 3),
        "msgs_per_s": round(state["got"] / secs, 1) if secs else 0.0,
    }


async def overload_burst(broker, msgs: int = 5000, payload: int = 1024,
                         pulses: int = 10, pulse_gap_s: float = 0.1,
                         expect_drops: Tuple[str, ...] = (
                             "shed_qos0", "queue_full")) -> dict:
    """QoS0 firehose at a NON-READING subscriber: its deliver queue backs
    up past the overload watermarks, the controller escalates, and QoS0
    is shed/dropped by policy. The phase verdict is that the protection
    ENGAGED (reason-labeled drops appeared), not that everything arrived
    — profiles pair this with availability objectives that exclude the
    intentional reasons."""
    # raw, loop-less subscriber with a TINY receive buffer set BEFORE
    # connect: the backlog must land in the broker's deliver queue (the
    # thing the controller manages), not in kernel socket buffering — the
    # blast volume is sized past the broker-side sndbuf cap on top
    sk = socket.socket()
    sk.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    sk.setblocking(False)
    await asyncio.get_running_loop().sock_connect(
        sk, ("127.0.0.1", broker.port))
    reader, writer = await asyncio.open_connection(sock=sk)
    codec = MqttCodec()
    writer.write(codec.encode(pk.Connect(client_id="ob-sub", keepalive=120)))
    writer.write(codec.encode(pk.Subscribe(1, [("ob/t", pk.SubOpts(qos=0))])))
    await writer.drain()
    # consume CONNACK/SUBACK then stop reading for good
    await reader.read(64)
    m0 = await broker.api("/api/v1/metrics")
    publ = await MiniClient.connect(broker.port, "ob-pub")
    t0 = time.monotonic()
    try:
        per = max(1, msgs // pulses)
        for _ in range(pulses):
            await publ.blast("ob/t", per, b"x" * payload)
            await asyncio.sleep(pulse_gap_s)  # let the samplers tick
        # the verdict waits until the broker has taken the burst in: a
        # device router routes a connection's publishes one dispatch at a
        # time, so the broker can still be reading the burst when the last
        # pulse is written, and drops read then miss the backlog to come
        received0 = m0.get("metrics", {}).get("publish.received", 0)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            m = (await broker.api("/api/v1/metrics")).get("metrics", {})
            if m.get("publish.received", 0) - received0 >= per * pulses:
                break
            await asyncio.sleep(0.1)
    finally:
        await publ.close()
        try:
            writer.close()
        except Exception:
            pass
    m1 = await broker.api("/api/v1/metrics")
    drops = drop_deltas(m0.get("metrics", {}), m1.get("metrics", {}))
    ov = await broker.api("/api/v1/overload")
    engaged = any(drops.get(r, 0) > 0 for r in expect_drops)
    return {
        "ok": engaged,
        "published": msgs, "drops": drops,
        "overload_state": ov.get("state"),
        "overload_transitions": ov.get("transitions"),
        "seconds": round(time.monotonic() - t0, 3),
    }


async def failpoint_kill(broker, site: str = "device.dispatch",
                         action: str = "times(4, error)",
                         msgs: int = 10, settle_s: float = 20.0,
                         expect_failover: bool = False) -> dict:
    """Arm a failpoint over the live HTTP surface mid-traffic (device
    kill by default), publish QoS1 through the fault window, disarm, and
    wait for the failover plane to switch back. Contract: zero lost."""
    sub = await MiniClient.connect(broker.port, "fk-sub")
    await sub.subscribe("fk/#", qos=1)
    publ = await MiniClient.connect(broker.port, "fk-pub")
    sent = 0
    t0 = time.monotonic()
    try:
        for i in range(3):  # healthy warmup (JIT, cache)
            await publ.publish(f"fk/{i % 2}", b"warm", qos=1)
            sent += 1
        fp0 = (await broker.api("/api/v1/failpoints"))["failpoints"]
        base = fp0.get(site, {}).get("triggers", 0)
        await broker.api("/api/v1/failpoints", "PUT", {site: action})
        for i in range(msgs):
            await publ.publish(f"fk/{i % 2}", f"fault-{i}".encode(), qos=1)
            sent += 1
        await broker.api("/api/v1/failpoints", "PUT", {site: "off"})
        # wait for the failover plane to recover (probe + switchback)
        deadline = time.monotonic() + settle_s
        fo = {}
        while time.monotonic() < deadline:
            fo = await broker.api("/api/v1/routing/failover")
            if fo.get("state") in ("device", "unavailable"):
                break
            await asyncio.sleep(0.2)
        for i in range(3):
            await publ.publish(f"fk/{i % 2}", b"post", qos=1)
            sent += 1
        got = await sub.drain(sent, timeout=30.0)
        fp1 = (await broker.api("/api/v1/failpoints"))["failpoints"]
        triggers = fp1.get(site, {}).get("triggers", 0) - base
        engaged = (not expect_failover) or fo.get("failovers", 0) >= 1
        return {
            "ok": got == sent and triggers > 0 and engaged,
            "published": sent, "delivered": got, "triggers": triggers,
            "failovers": fo.get("failovers"),
            "switchbacks": fo.get("switchbacks"),
            "failover_state": fo.get("state"),
            "seconds": round(time.monotonic() - t0, 3),
        }
    finally:
        for c in (sub, publ):
            await c.close()


async def durable_qos(broker, msgs: int = 60, qos: int = 1,
                      payload: int = 48) -> dict:
    """The durable-path profile: QoS1/2 publishes through the message
    storage plugin into an OFFLINE persistent session, resume, then a
    mid-delivery session TAKEOVER with unacked in-flight messages — the
    inflight-resend seam. Contract: every payload reaches the durable
    subscriber at least once (exactly once stays the tests' pin)."""
    cid = f"dur{qos}"
    topic = f"dq{qos}/t"
    sub = await MiniClient.connect(broker.port, cid, clean_start=False)
    await sub.subscribe(f"dq{qos}/#", qos=qos)
    await sub.close()  # offline, session persists (v3 clean_session=0)
    publ = await MiniClient.connect(broker.port, f"dq{qos}-pub")
    t0 = time.monotonic()
    try:
        for i in range(msgs):
            await publ.publish(topic, f"m-{i}".encode(), qos=qos)
    finally:
        await publ.close()
    # resume WITHOUT acking: deliveries land, the in-flight window fills
    # with unacked entries — exactly the state a takeover must transfer
    seen: set = set()
    duplicates = 0
    sub2 = await MiniClient.connect(broker.port, cid, clean_start=False,
                                    auto_ack=False)
    first_deadline = time.monotonic() + 15.0
    first = 0
    while first < min(10, msgs) and time.monotonic() < first_deadline:
        try:
            p = await asyncio.wait_for(sub2.publishes.get(), 2.0)
        except asyncio.TimeoutError:
            break
        first += 1
        seen.add(bytes(p.payload))
    # takeover: same client id, new connection; the broker transfers the
    # session and RESENDS the unacked in-flight window (DUP) alongside
    # the still-queued remainder — nothing the old connection left
    # unacked may be lost
    sub3 = await MiniClient.connect(broker.port, cid, clean_start=False)
    deadline = time.monotonic() + 30.0
    while len(seen) < msgs and time.monotonic() < deadline:
        try:
            p = await asyncio.wait_for(sub3.publishes.get(), 2.0)
        except asyncio.TimeoutError:
            continue
        if bytes(p.payload) in seen:
            duplicates += 1  # QoS1 redelivery after takeover is legal
        seen.add(bytes(p.payload))
    await sub2.close()
    await sub3.close()
    return {
        "ok": len(seen) == msgs,
        "published": msgs,
        "distinct_delivered": len(seen),
        "lost": msgs - len(seen),
        "duplicates": duplicates,
        "delivered_first_conn": first,
        "seconds": round(time.monotonic() - t0, 3),
    }


# ------------------------------------------------------------ the matrix
_OVERLOAD_TOML = """
[overload]
enable = true
sample_interval = 0.1
mqueue_elevated = 0.15
mqueue_critical = 0.6
queue_elevated = 0.5
queue_critical = 0.9
shed_slow_fraction = 0.15
"""

_STORAGE_TOML = """
[plugins]
default_startups = ["rmqtt-message-storage"]

[plugins.rmqtt-message-storage]
path = "{workdir}/messages.db"
"""

#: availability objective variants: strict (nothing may drop beyond a
#: close-race sliver) and one that treats overload-policy drops as
#: intentional, not failure
_AVAIL_STRICT = {"name": "delivery", "kind": "availability", "target": 0.995}
_AVAIL_SHED_OK = {"name": "delivery", "kind": "availability",
                  "target": 0.98,
                  "exclude_reasons": ["shed_qos0", "queue_full"]}


def _lat(name: str, stage: str, threshold_ms: float,
         target: float) -> Dict[str, Any]:
    return {"name": name, "kind": "latency", "stage": stage,
            "threshold_ms": threshold_ms, "target": target}


PROFILES: Dict[str, Profile] = {}


def _profile(p: Profile) -> Profile:
    PROFILES[p.name] = p
    return p


_profile(Profile(
    name="device_fleet_fanin",
    descr="connect storm then telemetry fan-in: many devices, one ingest",
    steps=(
        (("connect_storm", connect_storm, {"conns": 120, "wave": 40}),),
        (("fan_in", fan_in, {"pubs": 24, "msgs_per": 120}),),
    ),
    slo=(
        _lat("publish-p99", "publish.e2e", 2000.0, 0.95),
        _lat("connect-p99", "connect.handshake", 2000.0, 0.9),
        _AVAIL_STRICT,
    ),
))

_profile(Profile(
    name="command_fanout",
    descr="one commander, a fleet of listeners: fan-out under light churn",
    steps=(
        (("connect_storm", connect_storm, {"conns": 60, "wave": 30}),),
        (("fan_out", fan_out, {"subs": 30, "msgs": 120}),
         ("subscribe_churn", subscribe_churn,
          {"clients": 4, "rounds": 8})),
    ),
    slo=(
        _lat("publish-p99", "publish.e2e", 2000.0, 0.95),
        _AVAIL_STRICT,
    ),
))

_profile(Profile(
    name="storm_churn_overload_kill",
    descr="everything at once: connect storm + subscribe churn + QoS0 "
          "overload burst + failpoint-driven device kill, on the device "
          "router with the failover plane live",
    steps=(
        (("connect_storm", connect_storm,
          {"conns": 60, "wave": 20, "min_established_frac": 0.9}),
         ("subscribe_churn", subscribe_churn, {"clients": 4, "rounds": 6}),
         ("overload_burst", overload_burst, {}),
         ("failpoint_kill", failpoint_kill,
          {"site": "device.dispatch", "action": "times(6, error)",
           "msgs": 14, "expect_failover": True})),
    ),
    slo=(
        # generous latency bound: four regimes share one CPU core here —
        # the objective pins "no collapse", profiles on real fleets tighten
        _lat("publish-p99", "publish.e2e", 8000.0, 0.8),
        _AVAIL_SHED_OK,
    ),
    router="xla",
    extra_toml=_OVERLOAD_TOML + """
[routing]
cache = false
failover_timeout_s = 30.0
failover_threshold = 2
failover_cooldown = 0.3
failover_k_successes = 2
""",
    # all-device regime: every batch crosses the device plane, so the
    # kill phase actually kills the serving path (keeps the host
    # mirror alive as the failover target even with hybrid off)
    env={"RMQTT_HYBRID_MAX": "0", "RMQTT_HYBRID_ADAPT": "0"},
    subprocess_only=True,
    slo_fast_window_s=4.0,
    slo_slow_window_s=30.0,
))

_profile(Profile(
    name="durable_qos12",
    descr="QoS1+QoS2 through sqlite message storage into persistent "
          "sessions: offline queueing, resume, mid-flight takeover with "
          "inflight resend, under concurrent background load",
    steps=(
        (("durable_qos1", durable_qos, {"msgs": 60, "qos": 1}),
         ("durable_qos2", durable_qos, {"msgs": 40, "qos": 2}),
         ("background_fanout", fan_out, {"subs": 6, "msgs": 200})),
    ),
    slo=(
        _lat("publish-p99", "publish.e2e", 4000.0, 0.9),
        _AVAIL_STRICT,
    ),
    extra_toml=_STORAGE_TOML,
))

_profile(Profile(
    name="smoke_fast",
    descr="seconds-long tier-1 smoke: storm + churn + shed phases with "
          "the SLO verdict asserted (keeps the harness itself from "
          "rotting)",
    steps=(
        (("connect_storm", connect_storm, {"conns": 24, "wave": 12}),
         ("subscribe_churn", subscribe_churn,
          {"clients": 3, "rounds": 4})),
        (("overload_burst", overload_burst, {}),),
    ),
    slo=(
        _lat("publish-p99", "publish.e2e", 8000.0, 0.8),
        _AVAIL_SHED_OK,
    ),
    extra_toml=_OVERLOAD_TOML,
    slo_sample_interval=0.2,
    slo_fast_window_s=2.0,
    slo_slow_window_s=8.0,
))

_profile(Profile(
    name="throughput_suite",
    descr="the legacy throughput_bench scenarios as one profile: QoS0 "
          "pipe, paced QoS1 pipe, fan-out, fan-in",
    steps=(
        (("pipe", pipe, {"msgs": 20000}),),
        (("pipe_qos1", pipe_qos1, {"msgs": 4000}),),
        (("fan_out", fan_out, {"subs": 50, "msgs": 400}),),
        (("fan_in", fan_in, {"pubs": 50, "msgs_per": 400}),),
    ),
    slo=(
        _lat("publish-p99", "publish.e2e", 4000.0, 0.9),
        _AVAIL_STRICT,
    ),
))

# ------------------------------------------- multi-node cluster scenario
class ClusterProcNode:
    """One broker process of a scenario cluster: broadcast mode, fast
    membership knobs, HTTP admin API (membership polls + failpoint arming
    ride the same surface operators use)."""

    def __init__(self, idx: int, workdir: str, mports: List[int],
                 cports: List[int], aports: List[int]) -> None:
        self.idx = idx  # 1-based node id
        self.workdir = workdir
        self.port = mports[idx - 1]
        self.api_port = aports[idx - 1]
        peers = ", ".join(
            f'"{j + 1}@127.0.0.1:{cports[j]}"'
            for j in range(len(cports)) if j != idx - 1)
        self.conf = Path(workdir) / f"node{idx}.toml"
        self.conf.write_text(f"""
[listener]
host = "127.0.0.1"
port = {self.port}

[node]
id = {idx}

[cluster]
listen = "127.0.0.1:{cports[idx - 1]}"
mode = "broadcast"
peers = [{peers}]
heartbeat_interval = 0.25
suspect_timeout = 0.75
dead_timeout = 1.5
alive_hold = 1

[http_api]
host = "127.0.0.1"
port = {self.api_port}

[log]
to = "off"
""")
        self.proc: Optional[subprocess.Popen] = None

    def spawn(self) -> None:
        log_f = open(Path(self.workdir) / f"node{self.idx}.log", "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "rmqtt_tpu_torch.broker",
             "--config", str(self.conf)],
            cwd=str(REPO), env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=log_f, stderr=log_f)
        log_f.close()

    async def wait_ready(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        for port in (self.port, self.api_port):
            while True:
                if self.proc is not None and self.proc.poll() is not None:
                    raise RuntimeError(
                        f"node {self.idx} exited rc={self.proc.returncode}")
                try:
                    with socket.create_connection(("127.0.0.1", port),
                                                  timeout=0.3):
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"node {self.idx} never listened")
                    await asyncio.sleep(0.15)

    async def api(self, path: str, method: str = "GET", obj: Any = None):
        status, body = await _http_json(self.api_port, path, method, obj)
        if status != 200:
            raise RuntimeError(f"node {self.idx} {method} {path} -> {status}")
        return body

    def kill(self) -> None:
        if self.proc is not None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


async def _peer_state(node: ClusterProcNode, nid: int) -> Optional[str]:
    body = await node.api("/api/v1/cluster")
    for row in body.get("membership", {}).get("peers", []):
        if row["node"] == nid:
            return row["state"]
    return None


async def _wait_peer_state(node: ClusterProcNode, nid: int, state: str,
                           timeout: float = 25.0) -> float:
    """Poll one node's membership view until ``nid`` is ``state``; returns
    the observation timestamp (time.monotonic)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if await _peer_state(node, nid) == state:
                return time.monotonic()
        except Exception:
            pass
        await asyncio.sleep(0.1)
    raise TimeoutError(f"node {nid} never {state} from node {node.idx}")


async def _wait_digests_equal(nodes: List[ClusterProcNode],
                              timeout: float = 25.0) -> float:
    """Seconds until every node reports the same retained-store digest."""
    t0 = time.monotonic()
    deadline = t0 + timeout
    while time.monotonic() < deadline:
        try:
            ds = [
                (await n.api("/api/v1/cluster"))["digests"]["retain"]["digest"]
                for n in nodes
            ]
            if len(set(ds)) == 1:
                return time.monotonic() - t0
        except Exception:
            pass
        await asyncio.sleep(0.2)
    raise TimeoutError("retained digests never converged")


async def run_cluster_partition_heal(profile: Profile, inproc: bool = False,
                                     workdir: Optional[str] = None) -> dict:
    """The multi-node scenario ROADMAP item 5 left open: a 3-node
    broadcast cluster under live QoS1 traffic is SIGKILLed, restarted,
    fully partitioned (cluster.rpc failpoint over the live HTTP API) and
    healed. The report carries the partition-tolerance metrics: detection
    time, CONNECT latency during the outage (fast-fail kick), anti-entropy
    convergence times, the duplicate-session fence verdict, and zero loss
    for the surviving traffic path."""
    if inproc:
        raise ValueError("cluster profiles need real processes")
    report = base_report(profile.name, "subprocess")
    report["descr"] = profile.descr
    mports = [_free_port() for _ in range(3)]
    cports = [_free_port() for _ in range(3)]
    aports = [_free_port() for _ in range(3)]
    acked: List[bytes] = []
    stop_traffic = asyncio.Event()
    traffic: Optional[asyncio.Task] = None
    clients: List[MiniClient] = []

    with tempfile.TemporaryDirectory() as td:
        wd = workdir or td
        nodes = [ClusterProcNode(i, wd, mports, cports, aports)
                 for i in (1, 2, 3)]
        try:
            for n in nodes:
                n.spawn()
            for n in nodes:
                await n.wait_ready()
            # ---- phase: membership converges to all-ALIVE
            t0 = time.monotonic()
            for n in nodes:
                for other in nodes:
                    if other is not n:
                        await _wait_peer_state(n, other.idx, "ALIVE")
            report["phases"].append({
                "name": "membership_converge", "ok": True,
                "seconds": round(time.monotonic() - t0, 3)})
            # ---- live QoS1 traffic: node 1 → node 2, for the whole run
            sub = await MiniClient.connect(nodes[1].port, "cph-sub")
            clients.append(sub)
            await sub.subscribe("cph/t", qos=1)
            pub = await MiniClient.connect(nodes[0].port, "cph-pub")
            clients.append(pub)

            async def stream():
                seq = 0
                while not stop_traffic.is_set():
                    payload = f"cph-{seq}".encode()
                    try:
                        await pub.publish("cph/t", payload, qos=1)
                        acked.append(payload)
                    except (ConnectionError, asyncio.TimeoutError, OSError):
                        await asyncio.sleep(0.1)
                    seq += 1
                    await asyncio.sleep(0.02)

            traffic = asyncio.ensure_future(stream())
            await asyncio.sleep(1.0)
            # ---- phase: SIGKILL node 3 mid-traffic
            t_kill = time.monotonic()
            nodes[2].kill()
            t_seen = await _wait_peer_state(nodes[0], 3, "DEAD")
            await _wait_peer_state(nodes[1], 3, "DEAD")
            detect_s = t_seen - t_kill
            # CONNECT during the outage: the kick must skip the dead peer
            t_c = time.monotonic()
            probe = await MiniClient.connect(nodes[0].port, "cph-probe")
            clients.append(probe)
            connect_s = time.monotonic() - t_c
            await probe.close()
            # retained divergence while node 3 is down
            for i in range(8):
                await pub.publish(f"cph/keep/{i}", f"k{i}".encode(),
                                  qos=1, retain=True)
            report["phases"].append({
                "name": "node_kill", "ok": connect_s < 2.0 and detect_s < 5.0,
                "seconds": round(time.monotonic() - t_kill, 3),
                "detect_s": round(detect_s, 3),
                "connect_during_outage_s": round(connect_s, 3)})
            # ---- phase: node 3 rejoins; anti-entropy reconverges it
            nodes[2].spawn()
            await nodes[2].wait_ready()
            await _wait_peer_state(nodes[0], 3, "ALIVE")
            rejoin_converge_s = await _wait_digests_equal(nodes)
            report["phases"].append({
                "name": "rejoin", "ok": True,
                "seconds": round(rejoin_converge_s, 3),
                "converge_s": round(rejoin_converge_s, 3)})
            # ---- phase: full partition of node 3 + duplicate session
            t_p = time.monotonic()
            await nodes[2].api("/api/v1/failpoints", "PUT",
                               {"cluster.rpc": "error"})
            await _wait_peer_state(nodes[0], 3, "DEAD")
            await _wait_peer_state(nodes[2], 1, "DEAD")
            dup_a = await MiniClient.connect(nodes[0].port, "cph-dup")
            clients.append(dup_a)
            dup_b = await MiniClient.connect(nodes[2].port, "cph-dup")
            clients.append(dup_b)
            pub3 = await MiniClient.connect(nodes[2].port, "cph-pub3")
            clients.append(pub3)
            await pub3.publish("cph/keep/part", b"island", qos=1, retain=True)
            await nodes[2].api("/api/v1/failpoints", "PUT",
                               {"cluster.rpc": "off"})
            await _wait_peer_state(nodes[0], 3, "ALIVE")
            await _wait_peer_state(nodes[2], 1, "ALIVE")
            partition_converge_s = await _wait_digests_equal(nodes)
            # exactly one cph-dup survivor, fence-resolved
            kicks = live = 0
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                stats = [(await n.api("/api/v1/stats"))[0]["stats"]
                         for n in nodes]
                kicks = sum(s["cluster_fence_kicks"] for s in stats)
                # /api/v1/clients is cluster-merged — one node's listing
                # names every live copy, keyed by owning node_id
                found = {
                    c["node_id"]
                    for c in await nodes[0].api("/api/v1/clients")
                    if c.get("clientid") == "cph-dup" and c.get("connected")
                }
                live = len(found)
                if kicks >= 1 and live == 1:
                    break
                await asyncio.sleep(0.25)
            report["phases"].append({
                "name": "partition_fence",
                "ok": kicks == 1 and live == 1,
                "seconds": round(time.monotonic() - t_p, 3),
                "converge_s": round(partition_converge_s, 3),
                "fence_kicks": kicks, "dup_survivors": live})
            # ---- drain: every acked publish reached the subscriber
            stop_traffic.set()
            await traffic
            want = set(acked)
            got: set = set()
            deadline = time.monotonic() + 30.0
            while not want <= got and time.monotonic() < deadline:
                try:
                    p = await asyncio.wait_for(sub.publishes.get(), 1.0)
                    got.add(p.payload)
                except asyncio.TimeoutError:
                    pass
            lost = len(want - got)
            active_s = time.monotonic() - t0
            report["phases"].append({
                "name": "steady_traffic", "ok": lost == 0,
                "published": len(acked), "delivered": len(want & got),
                "lost": lost, "seconds": round(active_s, 3)})
            report["goodput"] = {
                "published": len(acked), "delivered": len(want & got),
                "phase_seconds": round(active_s, 3),
                "delivered_per_s": (round(len(want & got) / active_s, 1)
                                    if active_s else 0.0),
            }
            report["cluster"] = {
                "nodes": 3,
                "detect_s": round(detect_s, 3),
                "connect_during_outage_s": round(connect_s, 3),
                "rejoin_converge_s": round(rejoin_converge_s, 3),
                "partition_converge_s": round(partition_converge_s, 3),
                "fence_kicks": kicks,
            }
        except Exception as e:
            report["errors"].append(f"{type(e).__name__}: {e}")
        finally:
            # the failure path must not strand the stream task or leak
            # client sockets — a timed-out phase still tears down cleanly
            stop_traffic.set()
            if traffic is not None:
                traffic.cancel()
                try:
                    await traffic
                except (asyncio.CancelledError, Exception):
                    pass
            for c in clients:
                try:
                    await c.close()
                except Exception:
                    pass
            for n in nodes:
                n.stop()
    report["slo"] = {"state": None, "objectives": []}
    ok = (not report["errors"]
          and all(p.get("ok") for p in report["phases"]))
    return finish_report(report, ok)


_profile(Profile(
    name="cluster_partition_heal",
    descr="3-node broadcast cluster under live QoS1 traffic: SIGKILL + "
          "rejoin, full partition + heal; membership detection, fast-fail "
          "CONNECTs during the outage, anti-entropy digest convergence, "
          "duplicate-session fence resolution, zero loss on the surviving "
          "path",
    steps=(),
    subprocess_only=True,
    runner=run_cluster_partition_heal,
))


# --------------------------------------------- crash-torture (durability)
_DURABILITY_TOML = """
[durability]
enable = true
path = "{workdir}/durability.db"
flush_interval_ms = 20.0
compact_min = 192
"""


def _retained_matches(oracle: dict, got: Dict[str, str]) -> bool:
    """Retained-store vs client-side oracle, honoring the maybe-applied
    window: a set whose PUBACK the kill swallowed may legitimately have
    landed, so for those topics EITHER the last-acked value or the
    unacked candidate is correct. On a match the oracle re-anchors to
    the observed store so later rounds compare exactly."""
    maybe = oracle["retained_maybe"]
    expected = oracle["retained"]
    for topic in set(expected) | set(got) | set(maybe):
        have = got.get(topic)
        want = expected.get(topic)
        if have == want:
            continue
        if have is not None and have in maybe.get(topic, ()):
            continue  # the unacked set landed after all
        return False
    oracle["retained"] = dict(got)
    oracle["retained_maybe"] = {}
    return True


async def crash_torture_round(broker: "ScenarioBroker", oracle: dict, *,
                              rnd: int, rng, msgs: int = 60,
                              qos2_every: int = 3, retain_every: int = 5,
                              torn: bool = False,
                              recovery_bound_ms: float = 30000.0) -> dict:
    """One kill-9 round against a live durability-enabled broker.

    Live QoS1/2 + retained traffic, SIGKILL at a randomized point mid-
    stream (with ``flush_interval_ms = 20`` the kill regularly lands
    inside an open commit window; ``torn`` additionally arms
    ``storage.torn_write`` over the live HTTP API so the journal wedges
    with a truncated tail record), restart, then verify the durability
    invariants against client-side oracles:

    - **zero acked loss** — every publish the broker PUBACK/PUBCOMP'd
      reaches the durable subscriber after the restart;
    - **duplicates only with DUP=1** — a payload received twice must carry
      the DUP flag on the re-receipt;
    - **retained equality** — a fresh subscriber's retained replay matches
      the oracle's topic → last-acked-payload map exactly;
    - **bounded recovery** — ``durability_recovery_ms`` under the bound.

    The oracle dict accumulates ACROSS rounds (``acked``/``received``/
    ``retained``/``violations``) so state built in round N is still held
    to account in round N+k.
    """
    acked: set = oracle["acked"]
    received: Dict[str, List[bool]] = oracle["received"]
    sub = await MiniClient.connect(broker.port, "tortoise",
                                   clean_start=False)
    await sub.subscribe("t/#", qos=2)
    pub = await MiniClient.connect(broker.port, f"torture-pub-{rnd}")

    def _record(p) -> None:
        payload = p.payload.decode()
        seen = received.setdefault(payload, [])
        if seen and not p.dup:
            oracle["violations"].append(
                f"round {rnd}: duplicate of {payload!r} without DUP")
        seen.append(bool(p.dup))

    async def _drain_forever(client) -> None:
        try:
            while True:
                _record(await client.publishes.get())
        except asyncio.CancelledError:
            pass

    drainer = asyncio.ensure_future(_drain_forever(sub))
    killed = asyncio.Event()

    async def _killer(after_s: float) -> None:
        await asyncio.sleep(after_s)
        broker.kill()
        killed.set()

    # the kill lands somewhere inside the publish stream (the publisher
    # paces itself on acks, so wall time tracks message progress). Torn
    # rounds kill on the wedge instead — the first post-arm publish times
    # out against the wedged journal, and THAT is the crash moment
    kill_task = None
    if not torn:
        kill_task = asyncio.ensure_future(
            _killer(rng.uniform(0.15, 0.15 + msgs * 0.012)))
    sent_before_death = 0
    torn_armed = False
    try:
        for i in range(msgs):
            if i >= (msgs * 2) // 3 and sub.auto_ack:
                # the tail of the stream dies UNACKED at the subscriber:
                # the broker acks the publisher (journaled pending) but no
                # subscriber ack ever lands, so the kill strands a real
                # inflight window — recovery's pending replay
                # (recovered.inflight → DUP=1 redelivery) is exercised,
                # not just the retained/session paths
                sub.auto_ack = False
            if torn and not torn_armed and i >= msgs // 2:
                # arm the torn write over the live API: the NEXT group
                # commit truncates its tail record and wedges the journal
                # — every later publish must go un-acked
                try:
                    await broker.api("/api/v1/failpoints", "PUT",
                                     {"storage.torn_write":
                                      "times(1, error)"})
                    torn_armed = True
                except Exception:
                    break  # broker already dead
            payload = f"r{rnd}-{i}"
            if retain_every and i % retain_every == retain_every - 1:
                topic = f"keep/{i % 4}"
                try:
                    await asyncio.wait_for(
                        pub.publish(topic, payload.encode(), qos=1,
                                    retain=True), 3.0)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    # maybe-applied window: the set may have committed
                    # with only its PUBACK lost to the kill — the oracle
                    # accepts EITHER value for this topic this round
                    oracle["retained_maybe"].setdefault(
                        topic, set()).add(payload)
                    break
                oracle["retained"][topic] = payload
                oracle["retained_maybe"].pop(topic, None)
            else:
                qos = 2 if qos2_every and i % qos2_every == 0 else 1
                try:
                    await asyncio.wait_for(
                        pub.publish(f"t/{i % 5}", payload.encode(),
                                    qos=qos), 3.0)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    break  # killed mid-publish (or wedged) — not acked
                acked.add(payload)
            sent_before_death = i + 1
        if not killed.is_set():
            if kill_task is not None:
                await killed.wait()  # traffic outran the timer
            else:
                broker.kill()  # torn round: the wedge is the crash
                killed.set()
    finally:
        if kill_task is not None:
            kill_task.cancel()
            await asyncio.gather(kill_task, return_exceptions=True)
        if not killed.is_set():
            broker.kill()
            killed.set()
        drainer.cancel()
        await asyncio.gather(drainer, return_exceptions=True)
        await sub.close()
        await pub.close()

    # ---- restart on the same workdir/db; recovery runs before listen
    await broker.start()
    dur = await broker.api("/api/v1/durability")
    # ---- the durable subscriber returns; unacked QoS1/2 re-deliver DUP=1
    sub = await MiniClient.connect(broker.port, "tortoise",
                                   clean_start=False)
    await sub.subscribe("t/#", qos=2)
    deadline = time.monotonic() + 30.0
    missing = set(acked) - set(received)
    while missing and time.monotonic() < deadline:
        try:
            p = await asyncio.wait_for(
                sub.publishes.get(), max(0.1, deadline - time.monotonic()))
        except asyncio.TimeoutError:
            break
        _record(p)
        missing = set(acked) - set(received)
    await sub.close()

    # ---- retained oracle: a fresh subscriber's replay IS the store
    verifier = await MiniClient.connect(broker.port, f"torture-rv-{rnd}")
    await verifier.subscribe("keep/#", qos=0)
    got_retained: Dict[str, str] = {}
    quiet_until = time.monotonic() + 2.0
    while time.monotonic() < quiet_until:
        try:
            p = await asyncio.wait_for(verifier.publishes.get(), 0.5)
        except asyncio.TimeoutError:
            break
        if p.retain:
            got_retained[p.topic] = p.payload.decode()
            quiet_until = time.monotonic() + 0.5
    await verifier.close()

    recovery_ms = float(dur.get("recovery_ms") or 0.0)
    retained_ok = _retained_matches(oracle, got_retained)
    ok = (not missing and not oracle["violations"] and retained_ok
          and recovery_ms <= recovery_bound_ms)
    return {
        "ok": ok,
        "round": rnd,
        "torn": torn,
        "sent_before_death": sent_before_death,
        "acked_total": len(acked),
        "missing_acked": sorted(missing),
        "dup_violations": list(oracle["violations"]),
        "retained_expected": len(oracle["retained"]),
        "retained_got": len(got_retained),
        "retained_ok": retained_ok,
        "recovered": dur.get("recovered", {}),
        "recovery_ms": recovery_ms,
    }


async def run_crash_rounds(workdir: str, *, rounds: int = 5,
                           msgs: int = 60, torn_every: int = 3,
                           seed: int = 20260804,
                           recovery_bound_ms: float = 30000.0,
                           profile: "Optional[Profile]" = None) -> dict:
    """N crash-torture rounds against one broker/journal (state carries
    across kills — that is the point). Every ``torn_every``-th round arms
    the torn-write failpoint. Returns a verdict dict with per-round rows;
    ``ok`` iff every invariant held in every round."""
    import random

    rng = random.Random(seed)
    prof = profile or PROFILES["crash_restart"]
    broker = ScenarioBroker(prof, workdir)
    oracle: Dict[str, Any] = {"acked": set(), "received": {},
                              "retained": {}, "retained_maybe": {},
                              "violations": []}
    rows = []
    await broker.start()
    try:
        for rnd in range(rounds):
            torn = bool(torn_every) and rnd % torn_every == torn_every - 1
            row = await crash_torture_round(
                broker, oracle, rnd=rnd, rng=rng, msgs=msgs, torn=torn,
                recovery_bound_ms=recovery_bound_ms)
            rows.append(row)
    finally:
        await broker.stop()
    return {
        "ok": all(r["ok"] for r in rows) and len(rows) == rounds,
        "rounds": rows,
        "acked_total": len(oracle["acked"]),
        "retained_topics": len(oracle["retained"]),
        "dup_violations": oracle["violations"],
    }


async def run_crash_restart(profile: "Profile", inproc: bool = False,
                            workdir: Optional[str] = None) -> dict:
    """Scenario-matrix runner for the ``crash_restart`` profile: the
    kill-9 torture loop wrapped in the shared ScenarioReport schema."""
    if inproc:
        raise ValueError("crash_restart needs a real process to SIGKILL")
    report = base_report(profile.name, "subprocess")
    report["descr"] = profile.descr
    with tempfile.TemporaryDirectory() as td:
        wd = workdir or td
        t0 = time.monotonic()
        verdict = await run_crash_rounds(wd, rounds=3, msgs=48)
        seconds = round(time.monotonic() - t0, 3)
    for row in verdict["rounds"]:
        report["phases"].append({
            "name": f"crash_round_{row['round']}"
                    + ("_torn" if row["torn"] else ""),
            **row})
    report["goodput"] = {
        "published": verdict["acked_total"],
        "delivered": verdict["acked_total"],
        "phase_seconds": seconds,
        "delivered_per_s": round(verdict["acked_total"] / seconds, 1)
        if seconds else 0.0,
    }
    report["crash_torture"] = {k: v for k, v in verdict.items()
                               if k != "rounds"}
    return finish_report(report, verdict["ok"])


_profile(Profile(
    name="crash_restart",
    descr="kill-9 torture against the durability plane: live QoS1/2 + "
          "retained traffic, SIGKILL inside the commit window (torn-write "
          "rounds included), restart, verify zero acked loss / DUP-flagged "
          "duplicates / retained oracle equality / bounded recovery",
    steps=(),
    extra_toml=_DURABILITY_TOML,
    subprocess_only=True,
    runner=run_crash_restart,
))


# ------------------------------------------- sharded accept (connect storm)
async def run_connect_storm_sharded(profile: Profile, inproc: bool = False,
                                    workdir: Optional[str] = None) -> dict:
    """Scenario-matrix runner for ``connect_storm_sharded``: CONNECT
    waves against M SO_REUSEPORT fabric workers sharing ONE client port
    (the ``--workers N --fabric`` deployment shape — the kernel
    load-balances accepts across the worker processes). Each worker gets
    its OWN admin API port so the report carries per-worker connection
    gauges — the evidence that the kernel actually sharded the accept
    load instead of funneling every handshake into one process. A QoS1
    anchor stream runs through the whole storm and must land every acked
    publish (zero acked loss across the worker fleet); each wave reports
    its own CONNECT p50/p99."""
    if inproc:
        raise ValueError("sharded accept needs real SO_REUSEPORT worker "
                         "processes")
    nworkers, waves, wave_conns = 2, 6, 24
    report = base_report(profile.name, "subprocess")
    report["descr"] = profile.descr
    port = _free_port()
    api_ports = [_free_port() for _ in range(nworkers)]
    procs: List[subprocess.Popen] = []
    held: List[MiniClient] = []
    clients: List[MiniClient] = []
    acked: List[bytes] = []
    stop_traffic = asyncio.Event()
    traffic: Optional[asyncio.Task] = None

    async def _wait_tcp(p, deadline):
        while True:
            try:
                with socket.create_connection(("127.0.0.1", p), timeout=0.3):
                    return
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"port {p} never opened")
                await asyncio.sleep(0.15)

    with tempfile.TemporaryDirectory() as td:
        wd = Path(workdir or td)
        fdir = wd / "fab"
        fdir.mkdir(exist_ok=True)
        try:
            for wid in range(1, nworkers + 1):
                conf_path = wd / f"w{wid}.toml"
                conf_path.write_text(
                    "[listener]\n"
                    'host = "127.0.0.1"\n'
                    f"port = {port}\n"
                    "reuse_port = true\n\n"
                    "[http_api]\n"
                    'host = "127.0.0.1"\n'
                    f"port = {api_ports[wid - 1]}\n\n"
                    "[log]\n"
                    'to = "off"\n')
                log_f = open(wd / f"w{wid}.log", "ab")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "rmqtt_tpu_torch.broker",
                     "--config", str(conf_path), "--node-id", str(wid),
                     "--fabric", "--fabric-dir", str(fdir),
                     "--fabric-worker-id", str(wid),
                     "--fabric-workers", str(nworkers)],
                    cwd=str(REPO),
                    env=dict(os.environ, JAX_PLATFORMS="cpu"),
                    stdout=log_f, stderr=log_f))
                log_f.close()
            deadline = time.monotonic() + 120.0
            for p in (port, *api_ports):
                await _wait_tcp(p, deadline)
            await asyncio.sleep(1.0)  # workers register over the UDS mesh
            # ---- QoS1 anchor stream through the whole storm: the
            # kernel places sub and pub on whatever workers it likes, so
            # delivery may also cross the fabric mid-storm
            sub = await MiniClient.connect(port, "css-sub")
            clients.append(sub)
            await sub.subscribe("css/t", qos=1)
            pub = await MiniClient.connect(port, "css-pub")
            clients.append(pub)

            async def stream():
                seq = 0
                while not stop_traffic.is_set():
                    payload = f"css-{seq}".encode()
                    try:
                        await pub.publish("css/t", payload, qos=1)
                        acked.append(payload)
                    except (ConnectionError, asyncio.TimeoutError, OSError):
                        await asyncio.sleep(0.1)
                    seq += 1
                    await asyncio.sleep(0.01)

            traffic = asyncio.ensure_future(stream())
            # ---- the storm: waves of concurrent CONNECTs, every client
            # HELD OPEN so the final per-worker gauges show placement
            wave_rows = []
            t0 = time.monotonic()
            for w in range(waves):
                times: List[float] = []

                async def dial(i):
                    t = time.monotonic()
                    c = await MiniClient.connect(port, f"css-{w}-{i}")
                    times.append((time.monotonic() - t) * 1e3)
                    held.append(c)

                res = await asyncio.gather(
                    *(dial(i) for i in range(wave_conns)),
                    return_exceptions=True)
                fails = sum(1 for r in res if isinstance(r, BaseException))
                ts = sorted(times)
                wave_rows.append({
                    "wave": w + 1, "connects": len(ts), "failures": fails,
                    "connect_p50_ms":
                        round(ts[len(ts) // 2], 3) if ts else None,
                    "connect_p99_ms":
                        round(ts[min(len(ts) - 1, int(len(ts) * 0.99))], 3)
                        if ts else None,
                })
            storm_s = time.monotonic() - t0
            # ---- sharding evidence: each worker's own connection gauge
            per_worker = []
            for i in range(nworkers):
                status, body = await _http_json(api_ports[i],
                                                "/api/v1/stats")
                if status != 200:
                    raise RuntimeError(f"worker {i + 1} stats -> {status}")
                per_worker.append(body[0]["stats"]["connections"])
            sharded = sum(1 for c in per_worker if c > 0)
            report["phases"].append({
                "name": "connect_storm_sharded",
                "ok": (sharded >= 2
                       and all(r["failures"] == 0 for r in wave_rows)),
                "connections": len(held),
                "seconds": round(storm_s, 3),
                "handshakes_per_s": (round(len(held) / storm_s, 1)
                                     if storm_s else 0.0),
                "waves": wave_rows,
                "per_worker_connections": per_worker,
                "workers_accepting": sharded,
            })
            # ---- drain: every acked anchor publish reached the sub
            stop_traffic.set()
            await traffic
            traffic = None
            want = set(acked)
            got: set = set()
            deadline = time.monotonic() + 30.0
            while not want <= got and time.monotonic() < deadline:
                try:
                    p = await asyncio.wait_for(sub.publishes.get(), 1.0)
                    got.add(p.payload)
                except asyncio.TimeoutError:
                    pass
            lost = len(want - got)
            active_s = time.monotonic() - t0
            report["phases"].append({
                "name": "anchor_stream", "ok": lost == 0,
                "published": len(acked), "delivered": len(want & got),
                "lost": lost, "seconds": round(active_s, 3)})
            report["goodput"] = {
                "published": len(acked), "delivered": len(want & got),
                "phase_seconds": round(active_s, 3),
                "delivered_per_s": (round(len(want & got) / active_s, 1)
                                    if active_s else 0.0),
            }
            report["connect_storm"] = {
                "workers": nworkers,
                "waves": wave_rows,
                "per_worker_connections": per_worker,
                "workers_accepting": sharded,
                "handshakes_per_s": (round(len(held) / storm_s, 1)
                                     if storm_s else 0.0),
            }
        except Exception as e:
            report["errors"].append(f"{type(e).__name__}: {e}")
        finally:
            stop_traffic.set()
            if traffic is not None:
                traffic.cancel()
                try:
                    await traffic
                except (asyncio.CancelledError, Exception):
                    pass
            for c in [*clients, *held]:
                try:
                    await c.close()
                except Exception:
                    pass
            for proc in procs:
                proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
    report["slo"] = {"state": None, "objectives": []}
    ok = (not report["errors"]
          and all(p.get("ok") for p in report["phases"]))
    return finish_report(report, ok)


_profile(Profile(
    name="connect_storm_sharded",
    descr="CONNECT waves against SO_REUSEPORT fabric workers sharing one "
          "client port: per-wave CONNECT p99, per-worker accept counts "
          "(kernel sharding evidence), QoS1 anchor stream with zero acked "
          "loss across the storm",
    steps=(),
    subprocess_only=True,
    runner=run_connect_storm_sharded,
))


#: tier-1 wiring (tests/test_slo.py), chaos_matrix.FAST_SUBSET-style
FAST_SUBSET = ["smoke_fast"]


# ------------------------------------------------------------- orchestrator
async def _poll_live(broker, report: dict, interval: float,
                     stop: asyncio.Event) -> None:
    """Mid-run sampler: RSS peak + the live SLO surface (the acceptance
    point that `/api/v1/slo` shows burn rates DURING a run, not only
    after it)."""
    peak = 0.0
    samples = 0
    max_fast: Dict[str, float] = {}
    while not stop.is_set():
        peak = max(peak, broker.rss())
        try:
            snap = await broker.api("/api/v1/slo")
            samples += 1
            for row in snap.get("objectives", ()):
                burn = row.get("fast", {}).get("burn_rate", 0.0)
                name = row["name"]
                if burn >= max_fast.get(name, 0.0):
                    max_fast[name] = burn
        except Exception:
            pass  # the broker may be busy; the final snapshot still lands
        try:
            await asyncio.wait_for(stop.wait(), interval)
        except asyncio.TimeoutError:
            continue
    report["rss_mb"]["peak"] = round(peak, 1)
    report["slo_live"] = {"samples": samples,
                          "max_fast_burn": {k: round(v, 3)
                                            for k, v in max_fast.items()}}


async def run_profile_async(name, inproc: bool = False,
                            workdir: Optional[str] = None) -> dict:
    """Run one profile (a registered name or a Profile instance — the
    legacy wrappers build scaled copies) end to end; returns the
    ScenarioReport."""
    profile = name if isinstance(name, Profile) else PROFILES[name]
    if profile.runner is not None:
        return await profile.runner(profile, inproc=inproc, workdir=workdir)
    report = base_report(profile.name, "inproc" if inproc else "subprocess")
    report["descr"] = profile.descr
    with tempfile.TemporaryDirectory() as td:
        wd = workdir or td
        broker = ScenarioBroker(profile, wd, inproc=inproc)
        await broker.start()
        stop = asyncio.Event()
        poller = None
        try:
            report["rss_mb"]["start"] = round(broker.rss(), 1)
            m0 = (await broker.api("/api/v1/metrics")).get("metrics", {})
            poller = asyncio.ensure_future(
                _poll_live(broker, report,
                           max(0.3, profile.slo_sample_interval), stop))
            for step in profile.steps:
                rows = await asyncio.gather(
                    *(fn(broker, **params) for _, fn, params in step),
                    return_exceptions=True)
                for (pname, _fn, params), row in zip(step, rows):
                    if isinstance(row, BaseException):
                        report["errors"].append(
                            f"{pname}: {type(row).__name__}: {row}")
                        row = {"ok": False,
                               "error": f"{type(row).__name__}: {row}"}
                    report["phases"].append({"name": pname, **row})
            # one more SLO sample interval so the windows see the tail.
            # Collection failures (a profile that crashed the broker) must
            # not discard the report — the phase rows and errors ARE the
            # diagnostics a failed run exists to deliver.
            latency, slo, m1 = {}, {}, m0
            try:
                await asyncio.sleep(profile.slo_sample_interval * 2)
                latency = await broker.api("/api/v1/latency")
                slo = await broker.api("/api/v1/slo")
                m1 = (await broker.api("/api/v1/metrics")).get("metrics", {})
            except Exception as e:
                report["errors"].append(
                    f"post-run collection: {type(e).__name__}: {e}")
            report["rss_mb"]["end"] = round(broker.rss(), 1)
        finally:
            stop.set()
            if poller is not None:
                try:
                    await asyncio.wait_for(poller, 5.0)
                except Exception:
                    poller.cancel()
            await broker.stop()
    report["latency"] = latency_stages(latency)
    report["drops"] = drop_deltas(m0, m1)
    published = sum(p.get("published", 0) for p in report["phases"])
    delivered = sum(p.get("delivered", 0) for p in report["phases"])
    active_s = sum(p.get("seconds", 0.0) for p in report["phases"])
    report["goodput"] = {
        "published": published,
        "delivered": delivered,
        "phase_seconds": round(active_s, 3),
        "delivered_per_s": round(delivered / active_s, 1) if active_s else 0.0,
    }
    report["slo"] = {
        "state": slo.get("state"),
        "transitions": slo.get("transitions"),
        "objectives": [
            {k: row.get(k) for k in
             ("name", "kind", "state", "target", "ratio", "compliant",
              "budget_remaining")}
            | {"fast_burn": row.get("fast", {}).get("burn_rate"),
               "slow_burn": row.get("slow", {}).get("burn_rate")}
            for row in slo.get("objectives", ())
        ],
    }
    slo_ok = all(o["compliant"] for o in report["slo"]["objectives"])
    phases_ok = all(p.get("ok") for p in report["phases"])
    return finish_report(report,
                         slo_ok and phases_ok and not report["errors"])


def run_profile(name: str, inproc: bool = False) -> dict:
    return asyncio.run(run_profile_async(name, inproc=inproc))
