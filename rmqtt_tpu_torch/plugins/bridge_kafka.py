"""Kafka bridge plugins (ingress + egress).

Mirror `rmqtt-plugins/rmqtt-bridge-ingress-kafka` / `-egress-kafka`
capability on the dependency-free wire client (`bridge/kafka_client.py`):

- ingress: explicit-partition consumers (the reference's
  ``start_partition``/``stop_partition`` manual assignment,
  `ingress-kafka/src/config.rs:80-101`) fetch RecordBatches and republish
  into the broker; record headers become v5 user properties; the record key
  surfaces as the ``_message_key`` property (config.rs:25 MESSAGE_KEY).
- egress: matching local publishes are produced to a remote topic; the
  ``_message_key`` user property (when present) becomes the record key, the
  MQTT topic rides a ``mqtt_topic`` header; partition -1 round-robins over
  the topic's partitions (config.rs:22 PARTITION_UNASSIGNED).

Config::

    [plugins.rmqtt-bridge-egress-kafka]
    servers = "127.0.0.1:9092"
    forwards = [
      { filter = "iot/#", remote_topic = "mqtt-events", partition = -1 },
    ]

    [plugins.rmqtt-bridge-ingress-kafka]
    servers = "127.0.0.1:9092"
    subscribes = [
      { topic = "commands", local_topic = "kafka/${topic}",
        start_partition = -1, stop_partition = -1, offset = "latest",
        qos = 0, retain = false },
    ]
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import List, Optional

from rmqtt_tpu_torch.bridge.kafka_client import EARLIEST, LATEST, KafkaClient, KafkaError
from rmqtt_tpu_torch.broker.codec import props as P
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import Id
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, fire_async_as

#: chaos seam (utils/failpoints.py), shared by every bridge egress pump: an
#: injected fault is raised as ConnectionError so it trips the SAME breaker
#: path a real remote outage would
_FP_EGRESS = FAILPOINTS.register("bridge.egress")

log = logging.getLogger("rmqtt_tpu_torch.bridge.kafka")

MESSAGE_KEY = "_message_key"  # reference ingress-kafka/src/config.rs:25


class BridgeIngressKafkaPlugin(Plugin):
    name = "rmqtt-bridge-ingress-kafka"
    descr = "Kafka topics → local MQTT topics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.servers = self.config.get("servers", "127.0.0.1:9092")
        self.subscribes: List[dict] = self.config.get("subscribes", [])
        self.reconnect_delay = float(self.config.get("reconnect_delay", 3.0))
        self._client: Optional[KafkaClient] = None
        self._tasks: List[asyncio.Task] = []
        self.forwarded = 0

    async def start(self) -> None:
        self._client = KafkaClient(self.servers, client_id=f"rmqtt-in-{self.ctx.node_id}")
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._consume_entry(entry)) for entry in self.subscribes
        ]

    async def stop(self) -> bool:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        if self._client is not None:
            await self._client.close()
            self._client = None
        return True

    def attrs(self):
        return {"servers": self.servers, "entries": len(self.subscribes),
                "forwarded": self.forwarded}

    async def _consume_entry(self, entry: dict) -> None:
        topic = entry["topic"]
        start_p = int(entry.get("start_partition", -1))
        stop_p = int(entry.get("stop_partition", -1))
        where = EARLIEST if entry.get("offset", "latest") in ("beginning", "earliest") else LATEST
        while True:  # partition discovery, with retry
            try:
                parts = await self._client.partitions(topic)
                if parts:
                    break
                raise KafkaError(3, f"no partitions for {topic}")
            except asyncio.CancelledError:
                raise
            except (KafkaError, ConnectionError, OSError) as e:
                log.warning("kafka ingress %s: %s; retrying", topic, e)
                await asyncio.sleep(self.reconnect_delay)
        # manual assignment window (config.rs start/stop_partition;
        # -1 = unbounded on that side). Each partition consumer is fully
        # self-healing (never raises), so one transient failure can neither
        # kill nor duplicate its siblings.
        assigned = [
            p for p in parts
            if (start_p < 0 or p >= start_p) and (stop_p < 0 or p <= stop_p)
        ]
        await asyncio.gather(
            *(self._consume_partition(entry, topic, p, where) for p in assigned)
        )

    async def _consume_partition(self, entry: dict, topic: str, partition: int,
                                 where: int) -> None:
        while True:  # initial offset resolution, with retry
            try:
                offset = await self._client.list_offset(topic, partition, at=where)
                break
            except asyncio.CancelledError:
                raise
            except (KafkaError, ConnectionError, OSError) as e:
                log.warning("kafka list_offset %s[%s]: %s; retrying", topic, partition, e)
                await asyncio.sleep(self.reconnect_delay)
        qos = int(entry.get("qos", 0))
        retain = bool(entry.get("retain", False))
        local_pattern = entry.get("local_topic", "$kafka/${topic}")
        from_id = Id(self.ctx.node_id, f"kafka-in-{self.ctx.node_id}")
        while True:
            try:
                records, _hw = await self._client.fetch(topic, partition, offset)
            except asyncio.CancelledError:
                raise
            except (KafkaError, ConnectionError, OSError) as e:
                log.warning("kafka fetch %s[%s]: %s; retrying", topic, partition, e)
                await asyncio.sleep(self.reconnect_delay)
                continue
            if not records:
                # a broker honoring fetch's max_wait_ms long-polls for us;
                # one that answers empty immediately (minimal servers) would
                # otherwise turn this loop into a full-speed RPC spin that
                # saturates the event loop
                await asyncio.sleep(0.05)
                continue
            for off, _ts, key, value, headers in records:
                offset = off + 1
                local = (
                    local_pattern
                    .replace("${topic}", topic)
                    .replace("${partition}", str(partition))
                )
                properties = {P.USER_PROPERTY: [(hk, hv.decode("utf-8", "replace"))
                                                for hk, hv in headers]}
                if key:
                    properties[P.USER_PROPERTY].append(
                        (MESSAGE_KEY, key.decode("utf-8", "replace"))
                    )
                msg = Message(
                    topic=local, payload=value or b"", qos=qos, retain=retain,
                    properties=properties, from_id=from_id,
                )
                if retain:
                    self.ctx.retain.set(local, msg)
                await self.ctx.registry.forwards(msg)
                self.forwarded += 1


class BridgeEgressKafkaPlugin(Plugin):
    name = "rmqtt-bridge-egress-kafka"
    descr = "local MQTT topics → Kafka topics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.servers = self.config.get("servers", "127.0.0.1:9092")
        self.forwards: List[dict] = self.config.get("forwards", [])
        self.max_queue = int(self.config.get("max_queue", 10_000))
        self._client: Optional[KafkaClient] = None
        self._q: Optional[asyncio.Queue] = None
        self._pump: Optional[asyncio.Task] = None
        self._unhooks = []
        self._rr = 0
        self.breaker = None  # set in start() from the overload registry

    async def start(self) -> None:
        self._client = KafkaClient(self.servers, client_id=f"rmqtt-out-{self.ctx.node_id}")
        self._q = asyncio.Queue(maxsize=self.max_queue)
        # circuit-broken producer (broker/overload.py): a dead Kafka stops
        # costing a connect timeout per queued record; buffered work stays
        # bounded by the queue and overflow drops are reason-labeled
        self.breaker = self.ctx.overload.breaker("bridge.kafka")
        self._pump = asyncio.get_running_loop().create_task(self._drain())

        async def on_publish(_ht, args, prev):
            msg = prev if prev is not None else args[1]
            # CRITICAL overload: bridge egress is non-essential plugin work
            if not self.ctx.overload.allow_noncritical():
                self.ctx.metrics.inc("bridge.kafka.paused")
                return None
            # capture the publish's trace id in THIS task (the tracing
            # contextvar is ingress-scoped; the drain pump is another
            # task) — but only once a forward actually matches, so
            # non-bridged publishes never pay the lazy 128-bit id draw.
            # It exits as a record header joinable with /api/v1/traces.
            trace = CURRENT_TRACE.get()
            tid = None
            # every matching entry forwards independently (each has its own
            # remote topic/partition)
            for entry in self.forwards:
                if match_filter(entry.get("filter", "#"), msg.topic):
                    if tid is None and trace is not None:
                        tid = trace.tid
                    try:
                        self._q.put_nowait((entry, msg, tid))
                    except asyncio.QueueFull:
                        self.ctx.metrics.inc("bridge.kafka.dropped")
                        if self.breaker.state != self.breaker.CLOSED:
                            self.ctx.metrics.drop("circuit_open")
            return None

        self._unhooks = [
            self.ctx.hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=-100)
        ]

    async def _drain(self) -> None:
        while True:
            entry, msg, tid = await self._q.get()
            # open circuit: park (bounded by the queue) until the next
            # half-open probe window instead of paying a timeout per item
            await self.breaker.wait_ready()
            topic = entry.get("remote_topic", msg.topic.replace("/", "."))
            partition = int(entry.get("partition", -1))
            key = None
            for uk, uv in msg.properties.get(P.USER_PROPERTY, []) or []:
                if uk == MESSAGE_KEY:
                    key = uv.encode()
            headers = [("mqtt_topic", msg.topic.encode())]
            if tid is not None:
                headers.append(("mqtt_trace_id", tid.encode()))
            try:
                if _FP_EGRESS.action is not None:
                    await fire_async_as(_FP_EGRESS)
                if partition < 0:  # PARTITION_UNASSIGNED: round-robin
                    parts = await self._client.partitions(topic)
                    if not parts:
                        raise KafkaError(3, f"no partitions for {topic}")
                    self._rr += 1
                    partition = parts[self._rr % len(parts)]
                await self._client.produce(
                    topic, msg.payload, key=key, partition=partition,
                    headers=headers, timestamp_ms=int(time.time() * 1000),
                )
                self.breaker.ok()
                self.ctx.metrics.inc("bridge.kafka.forwarded")
            except asyncio.CancelledError:
                raise
            except (KafkaError, ConnectionError, OSError) as e:
                self.breaker.fail()
                log.warning("kafka egress %s: %s", topic, e)
                self.ctx.metrics.inc("bridge.kafka.errors")

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        if self._pump is not None:
            self._pump.cancel()
            self._pump = None
        if self._client is not None:
            await self._client.close()
            self._client = None
        return True

    def attrs(self):
        return {"servers": self.servers, "entries": len(self.forwards),
                "breaker": self.breaker.state if self.breaker else None}
