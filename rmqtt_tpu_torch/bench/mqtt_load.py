"""A small asyncio MQTT 3.1.1 load client on the port's own codec, and the
delivery oracle it is checked against.

``LoadClient`` connects, subscribes filters in SUBSCRIBE packets of many
filters, publishes at QoS 0 (retained or not) and records every PUBLISH the
broker delivers to it, retained replays included. ``expected_deliveries`` resolves the same subscriptions through the
port's ``DefaultRouter`` (trie + relations, ``matches`` with its
``collapse``): the multiset of (client id, topic, payload) a broker must
deliver. ``chip_smoke.py`` drives ``python -m rmqtt_tpu_torch.broker`` with
them; ``tests/test_torch_cuda.py`` drives an in-process broker.
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

from rmqtt_tpu_torch.broker.codec import MqttCodec, packets as pk, props as P
from rmqtt_tpu_torch.router.base import Id, SubscriptionOptions
from rmqtt_tpu_torch.router.default import DefaultRouter

#: filters per SUBSCRIBE packet
SUBSCRIBE_CHUNK = 1000


class LoadClient:
    """One MQTT connection. ``received`` holds (topic, payload, arrival
    ``perf_counter``) for every PUBLISH the broker sent, in order."""

    def __init__(self, client_id: str, reader, writer, version: int = pk.V311) -> None:
        self.client_id = client_id
        self.reader = reader
        self.writer = writer
        self.codec = MqttCodec(version)
        self.session_present = False
        self.received: List[Tuple[str, bytes, float]] = []
        self._arrived = asyncio.Event()
        self._acks: Dict[tuple, asyncio.Future] = {}
        self._pid = 0
        self._task: Optional[asyncio.Task] = None

    @classmethod
    async def connect(cls, port: int, client_id: str, host: str = "127.0.0.1",
                      session_expiry: int = 0,
                      username: Optional[str] = None) -> "LoadClient":
        """MQTT 3.1.1 with a clean session; with ``session_expiry`` > 0 an
        MQTT 5 connection that resumes or creates a persistent session
        outliving it by that many seconds (``session_present`` says which).
        A refused CONNACK raises ``ConnectionError``."""
        version = pk.V5 if session_expiry else pk.V311
        reader, writer = await asyncio.open_connection(host, port)
        c = cls(client_id, reader, writer, version)
        c._task = asyncio.get_running_loop().create_task(c._read_loop())
        ack = c._expect(("connack",))
        writer.write(c.codec.encode(pk.Connect(
            client_id=client_id, protocol=version, clean_start=not session_expiry,
            keepalive=0, username=username,
            properties=({P.SESSION_EXPIRY_INTERVAL: session_expiry}
                        if session_expiry else {}))))
        connack = await asyncio.wait_for(ack, 30.0)
        if connack.reason_code != 0:
            writer.close()
            c._task.cancel()
            raise ConnectionError(f"{client_id}: CONNACK {connack.reason_code}")
        c.session_present = connack.session_present
        return c

    def _expect(self, key: tuple) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._acks[key] = fut
        return fut

    def _resolve(self, key: tuple, value) -> None:
        fut = self._acks.pop(key, None)
        if fut is not None and not fut.done():
            fut.set_result(value)

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self.reader.read(1 << 20)
                if not data:
                    break
                now = time.perf_counter()
                for p in self.codec.feed(data):
                    if isinstance(p, pk.Publish):
                        self.received.append((p.topic, bytes(p.payload), now))
                        self._arrived.set()
                    elif isinstance(p, pk.Connack):
                        self._resolve(("connack",), p)
                    elif isinstance(p, pk.Suback):
                        self._resolve(("suback", p.packet_id), p)
                    elif isinstance(p, pk.Pingresp):
                        self._resolve(("pingresp",), p)
        finally:
            for fut in self._acks.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(
                        f"{self.client_id}: connection closed"))
            self._arrived.set()

    def _next_pid(self) -> int:
        self._pid = self._pid % 65535 + 1
        return self._pid

    async def subscribe(self, filters: Sequence[str], qos: int = 0,
                        retain_handling: int = 0, check: bool = True) -> List[int]:
        """SUBSCRIBE ``filters`` in packets of ``SUBSCRIBE_CHUNK``, each
        sent after the previous SUBACK → the SUBACKs' reason codes; with
        ``check`` every filter must be granted. ``retain_handling`` 2
        (MQTT 5) asks for no retained replay."""
        opts = pk.SubOpts(qos=qos, retain_handling=retain_handling)
        codes: List[int] = []
        for i in range(0, len(filters), SUBSCRIBE_CHUNK):
            part = filters[i:i + SUBSCRIBE_CHUNK]
            pid = self._next_pid()
            ack = self._expect(("suback", pid))
            self.writer.write(self.codec.encode(pk.Subscribe(
                pid, [(f, opts) for f in part])))
            # a fabric worker asks the table's owner once per filter, so one
            # packet can take minutes while 64 connections subscribe at once
            suback = await asyncio.wait_for(ack, 600.0)
            bad = [f for f, rc in zip(part, suback.reason_codes) if rc >= 0x80]
            if len(suback.reason_codes) != len(part) or (check and bad):
                raise RuntimeError(f"{self.client_id}: SUBACK refused {bad[:4]}")
            codes.extend(suback.reason_codes)
        return codes

    def publish(self, topic: str, payload: bytes, retain: bool = False) -> None:
        """Queue one QoS 0 PUBLISH (no ack; ``ping`` waits until the broker
        has read it)."""
        self.writer.write(self.codec.encode(pk.Publish(topic=topic, payload=payload,
                                                       qos=0, retain=retain)))

    async def ping(self, timeout: float = 60.0) -> None:
        """One PINGREQ round trip: the broker has read every packet sent
        before it."""
        ack = self._expect(("pingresp",))
        self.writer.write(self.codec.encode(pk.Pingreq()))
        await asyncio.wait_for(ack, timeout)

    async def wait_count(self, n: int, timeout: float) -> None:
        """Until ``len(received) >= n``; raises TimeoutError after
        ``timeout`` seconds without reaching it."""
        deadline = time.perf_counter() + timeout
        while len(self.received) < n:
            left = deadline - time.perf_counter()
            if left <= 0 or self._task.done():
                raise TimeoutError(f"{self.client_id}: {len(self.received)} of "
                                   f"{n} deliveries")
            self._arrived.clear()
            try:
                await asyncio.wait_for(self._arrived.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def close(self) -> None:
        try:
            self.writer.write(self.codec.encode(pk.Disconnect(0)))
            await self.writer.drain()
        except ConnectionError:
            pass
        self.writer.close()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, ConnectionError):
                pass


def oracle_router(subs: Dict[str, Sequence[str]]) -> DefaultRouter:
    """A ``DefaultRouter`` holding ``subs`` ({client id: filters}, QoS 0)."""
    r = DefaultRouter()
    opts = SubscriptionOptions()
    for cid, filters in subs.items():
        sid = Id(1, cid)
        for f in filters:
            r.add(f, sid, opts)
    return r


def expected_deliveries(oracle: DefaultRouter, topics: Sequence[str],
                        payloads: Sequence[bytes]) -> collections.Counter:
    """The multiset of (client id, topic, payload) a broker holding the
    oracle's subscriptions must deliver for these publishes."""
    want: collections.Counter = collections.Counter()
    for topic, payload in zip(topics, payloads):
        for rels in oracle.matches(None, topic).values():
            for r in rels:
                want[(r.id.client_id, topic, payload)] += 1
    return want


async def publish_wave(publishers: Sequence[LoadClient],
                       subscribers: Sequence[LoadClient],
                       topics: Sequence[str], payloads: Sequence[bytes],
                       want: collections.Counter, timeout: float = 300.0,
                       quiet: float = 0.5):
    """Publish ``topics`` at QoS 0, dealt round-robin over ``publishers``,
    and wait until every subscriber holds its share of ``want`` plus a
    ``quiet`` window for extras. → (received multiset, seconds from the
    first publish to the last delivery)."""
    marks = {c.client_id: len(c.received) for c in subscribers}
    per_client: collections.Counter = collections.Counter()
    for (cid, _t, _p), n in want.items():
        per_client[cid] += n
    t0 = time.perf_counter()

    async def run(k: int, pub: LoadClient) -> None:
        for n, i in enumerate(range(k, len(topics), len(publishers))):
            pub.publish(topics[i], payloads[i])
            if n % 64 == 63:
                await pub.writer.drain()
        await pub.ping(timeout)

    await asyncio.gather(*(run(k, p) for k, p in enumerate(publishers)))
    await asyncio.gather(*(c.wait_count(marks[c.client_id] + per_client[c.client_id],
                                        timeout) for c in subscribers))
    last = max((c.received[-1][2] for c in subscribers
                if len(c.received) > marks[c.client_id]), default=t0)
    await asyncio.sleep(quiet)
    got: collections.Counter = collections.Counter()
    for c in subscribers:
        for topic, payload, _t in c.received[marks[c.client_id]:]:
            got[(c.client_id, topic, payload)] += 1
    return got, last - t0


async def connect_and_subscribe(port: int, subs: Dict[str, Sequence[str]],
                                session_expiry: int = 0,
                                retain_handling: int = 0) -> List[LoadClient]:
    """One connection per client id of ``subs``, each subscribing its
    filters (all clients at once); ``session_expiry`` and
    ``retain_handling`` as in ``LoadClient``. → the connected clients."""
    clients = [await LoadClient.connect(port, cid, session_expiry=session_expiry)
               for cid in subs]
    await asyncio.gather(*(c.subscribe(list(subs[c.client_id]),
                                       retain_handling=retain_handling)
                           for c in clients))
    return clients
