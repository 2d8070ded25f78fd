"""Pulsar bridge plugins (ingress + egress).

Mirror `rmqtt-plugins/rmqtt-bridge-ingress-pulsar` / `-egress-pulsar`
capability on the dependency-free wire client (`bridge/pulsar_client.py`):

- ingress: a consumer per entry (subscription name + type + initial
  position, config.rs:174-232) republishes Pulsar messages into the
  broker; message properties become v5 user properties.
- egress: matching local publishes are produced to a remote Pulsar topic
  with the MQTT topic / publisher identity as message properties
  (forward_all_from / forward_all_publish, egress config.rs:126-146) and
  an optional partition key.

Config::

    [plugins.rmqtt-bridge-egress-pulsar]
    servers = "127.0.0.1:6650"
    forwards = [
      { filter = "iot/#", remote_topic = "persistent://public/default/mqtt",
        partition_key = "", forward_all_from = true, forward_all_publish = true },
    ]

    [plugins.rmqtt-bridge-ingress-pulsar]
    servers = "127.0.0.1:6650"
    subscribes = [
      { topic = "persistent://public/default/cmds", subscription = "rmqtt",
        subscription_type = "shared", initial_position = "earliest",
        local_topic = "$pulsar/cmds", qos = 0 },
    ]
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import List, Optional

from rmqtt_tpu_torch.bridge.pulsar_client import PulsarClient
from rmqtt_tpu_torch.broker.codec import props as P
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import Id
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, fire_async_as

_FP_EGRESS = FAILPOINTS.register("bridge.egress")  # chaos seam (failpoints)

log = logging.getLogger("rmqtt_tpu_torch.bridge.pulsar")


def _host_port(servers: str):
    first = servers.split(",")[0].strip()
    if ":" not in first:
        return first, 6650
    host, _, port = first.rpartition(":")
    return host, int(port)


class BridgeIngressPulsarPlugin(Plugin):
    name = "rmqtt-bridge-ingress-pulsar"
    descr = "Pulsar topics → local MQTT topics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.servers = self.config.get("servers", "127.0.0.1:6650")
        self.subscribes: List[dict] = self.config.get("subscribes", [])
        self.reconnect_delay = float(self.config.get("reconnect_delay", 3.0))
        self._task: Optional[asyncio.Task] = None
        self._client: Optional[PulsarClient] = None
        self.forwarded = 0

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> bool:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._client is not None:
            await self._client.close()
            self._client = None
        return True

    def attrs(self):
        return {"servers": self.servers, "entries": len(self.subscribes),
                "forwarded": self.forwarded,
                "connected": bool(self._client and self._client.connected.is_set())}

    async def _run(self) -> None:
        host, port = _host_port(self.servers)
        by_consumer = {i + 1: e for i, e in enumerate(self.subscribes)}
        from_id = Id(self.ctx.node_id, f"pulsar-in-{self.ctx.node_id}")
        PERMITS = 1000
        consumed: dict = {}

        async def on_message(consumer_id, msg_id_raw, props, payload):
            entry = by_consumer.get(consumer_id)
            if entry is None:
                return
            local = entry.get("local_topic") or "$pulsar/" + entry["topic"].rsplit("/", 1)[-1]
            properties = {P.USER_PROPERTY: list(props)} if props else {}
            msg = Message(
                topic=local, payload=payload, qos=int(entry.get("qos", 0)),
                retain=bool(entry.get("retain", False)),
                properties=properties, from_id=from_id,
            )
            await self.ctx.registry.forwards(msg)
            self.forwarded += 1
            await self._client.ack(consumer_id, msg_id_raw)
            # replenish FLOW permits at half-window or the broker stops
            # dispatching once the initial grant is used up
            consumed[consumer_id] = consumed.get(consumer_id, 0) + 1
            if consumed[consumer_id] >= PERMITS // 2:
                consumed[consumer_id] = 0
                await self._client.flow(consumer_id, PERMITS // 2)

        while True:
            try:
                self._client = PulsarClient(host, port, on_message=on_message)
                await self._client.connect()
                for cid, entry in by_consumer.items():
                    await self._client.subscribe(
                        entry["topic"], entry.get("subscription", "rmqtt"),
                        consumer_id=cid,
                        sub_type=entry.get("subscription_type", "shared"),
                        initial_position=entry.get("initial_position", "latest"),
                    )
                    await self._client.flow(cid, 1000)
                # stay up until the connection drops
                while self._client.connected.is_set():
                    await asyncio.sleep(0.5)
                raise ConnectionError("pulsar connection lost")
            except asyncio.CancelledError:
                raise
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                log.warning("pulsar ingress: %s; reconnecting", e)
                if self._client is not None:
                    await self._client.close()
                await asyncio.sleep(self.reconnect_delay)


class BridgeEgressPulsarPlugin(Plugin):
    name = "rmqtt-bridge-egress-pulsar"
    descr = "local MQTT topics → Pulsar topics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.servers = self.config.get("servers", "127.0.0.1:6650")
        self.forwards: List[dict] = self.config.get("forwards", [])
        self.max_queue = int(self.config.get("max_queue", 10_000))
        self.reconnect_delay = float(self.config.get("reconnect_delay", 3.0))
        self._client: Optional[PulsarClient] = None
        self._q: Optional[asyncio.Queue] = None
        self._pump: Optional[asyncio.Task] = None
        self._unhooks = []
        self._seq = itertools.count(1)
        self.breaker = None  # set in start() from the overload registry

    async def start(self) -> None:
        self._q = asyncio.Queue(maxsize=self.max_queue)
        # circuit-broken producer (broker/overload.py): a dead Pulsar fails
        # fast between probes; overflow drops while open are reason-labeled
        self.breaker = self.ctx.overload.breaker("bridge.pulsar")
        self._pump = asyncio.get_running_loop().create_task(self._drain())

        async def on_publish(_ht, args, prev):
            msg = prev if prev is not None else args[1]
            if not self.ctx.overload.allow_noncritical():
                self.ctx.metrics.inc("bridge.pulsar.paused")
                return None
            # trace id captured in the ingress task, drawn only once a
            # forward matches (non-bridged publishes skip the lazy id
            # draw); becomes a Pulsar message property so consumers can
            # join back to the trace API
            trace = CURRENT_TRACE.get()
            tid = None
            for i, entry in enumerate(self.forwards):
                if match_filter(entry.get("filter", "#"), msg.topic):
                    if tid is None and trace is not None:
                        tid = trace.tid
                    try:
                        self._q.put_nowait((i, entry, msg, tid))
                    except asyncio.QueueFull:
                        self.ctx.metrics.inc("bridge.pulsar.dropped")
                        if self.breaker.state != self.breaker.CLOSED:
                            self.ctx.metrics.drop("circuit_open")
            return None

        self._unhooks = [
            self.ctx.hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=-100)
        ]

    async def _ensure_client(self) -> None:
        if self._client is not None and self._client.connected.is_set():
            return
        host, port = _host_port(self.servers)
        if self._client is not None:
            await self._client.close()
        self._client = PulsarClient(host, port)
        await self._client.connect()
        for i, entry in enumerate(self.forwards):
            await self._client.create_producer(entry["remote_topic"], producer_id=i + 1)

    async def _drain(self) -> None:
        while True:
            i, entry, msg, tid = await self._q.get()
            await self.breaker.wait_ready()
            props = [("mqtt_topic", msg.topic)]
            if tid is not None:
                props.append(("mqtt_trace_id", tid))
            if entry.get("forward_all_from", True) and msg.from_id is not None:
                props.append(("from_node", str(msg.from_id.node_id)))
                props.append(("from_clientid", msg.from_id.client_id))
            if entry.get("forward_all_publish", True):
                props.append(("qos", str(msg.qos)))
                props.append(("retain", "true" if msg.retain else "false"))
            try:
                if _FP_EGRESS.action is not None:
                    await fire_async_as(_FP_EGRESS)
                await self._ensure_client()
                await self._client.send(
                    i + 1, next(self._seq), msg.payload, properties=props,
                    partition_key=entry.get("partition_key") or None,
                )
                self.breaker.ok()
                self.ctx.metrics.inc("bridge.pulsar.forwarded")
            except asyncio.CancelledError:
                raise
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                self.breaker.fail()
                log.warning("pulsar egress: %s", e)
                self.ctx.metrics.inc("bridge.pulsar.errors")
                await asyncio.sleep(self.reconnect_delay)

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
        return {"servers": self.servers, "entries": len(self.forwards)}
