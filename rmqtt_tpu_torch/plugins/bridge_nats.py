"""NATS bridge plugins (ingress + egress).

Mirror `rmqtt-plugins/rmqtt-bridge-ingress-nats` / `-egress-nats`: NATS
subjects map to MQTT topics (``.``↔``/``, ``*``↔``+``, ``>``↔``#``);
ingress republishes NATS messages into the broker, egress forwards matching
local publishes to NATS (bounded queue, reconnecting client).
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from rmqtt_tpu_torch.bridge.nats_client import (
    NatsClient,
    mqtt_filter_to_nats,
    mqtt_to_nats_subject,
    nats_to_mqtt_topic,
)
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import Id
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, fire_async_as

_FP_EGRESS = FAILPOINTS.register("bridge.egress")  # chaos seam (failpoints)

log = logging.getLogger("rmqtt_tpu_torch.bridge.nats")


class BridgeIngressNatsPlugin(Plugin):
    name = "rmqtt-bridge-ingress-nats"
    descr = "NATS subjects → local MQTT topics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.host = self.config.get("host", "127.0.0.1")
        self.port = int(self.config.get("port", 4222))
        # MQTT-style filters, converted to NATS subjects
        self.filters: List[str] = self.config.get("subscribes", ["#"])
        self.local_prefix = self.config.get("local_prefix", "")
        self.qos = int(self.config.get("qos", 0))
        self.queue = self.config.get("queue")  # NATS queue group
        self._client: Optional[NatsClient] = None

    async def start(self) -> None:
        async def on_message(subject: str, payload: bytes) -> None:
            topic = self.local_prefix + nats_to_mqtt_topic(subject)
            msg = Message(topic=topic, payload=payload, qos=self.qos,
                          from_id=Id(self.ctx.node_id, f"nats-in-{self.ctx.node_id}"))
            await self.ctx.registry.forwards(msg)

        self._client = NatsClient(self.host, self.port, on_message=on_message)
        self._client.start()
        for f in self.filters:
            await self._client.subscribe(mqtt_filter_to_nats(f), queue=self.queue)

    async def stop(self) -> bool:
        if self._client is not None:
            await self._client.stop()
            self._client = None
        return True

    def attrs(self):
        return {"remote": f"{self.host}:{self.port}",
                "connected": bool(self._client and self._client.connected.is_set())}


class BridgeEgressNatsPlugin(Plugin):
    name = "rmqtt-bridge-egress-nats"
    descr = "local MQTT topics → NATS subjects"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.host = self.config.get("host", "127.0.0.1")
        self.port = int(self.config.get("port", 4222))
        self.filters: List[str] = self.config.get("forwards", ["#"])
        self.subject_prefix = self.config.get("subject_prefix", "")
        self.max_queue = int(self.config.get("max_queue", 10_000))
        self._client: Optional[NatsClient] = None
        self._q: Optional[asyncio.Queue] = None
        self._pump: Optional[asyncio.Task] = None
        self._unhooks = []
        self.breaker = None  # set in start() from the overload registry

    async def start(self) -> None:
        self._client = NatsClient(self.host, self.port)
        self._client.start()
        self._q = asyncio.Queue(maxsize=self.max_queue)
        # circuit-broken producer (broker/overload.py): repeated publish
        # failures open the circuit and the pump backs off instead of
        # spinning; overflow drops while open are reason-labeled
        self.breaker = self.ctx.overload.breaker("bridge.nats")
        self._pump = asyncio.get_running_loop().create_task(self._drain())

        async def on_publish(_ht, args, prev):
            msg = prev if prev is not None else args[1]
            if not self.ctx.overload.allow_noncritical():
                self.ctx.metrics.inc("bridge.nats.paused")
                return None
            if any(match_filter(f, msg.topic) for f in self.filters):
                # trace id captured in the ingress task (the drain pump is
                # another task); rides out as a NATS header when the
                # server supports them
                trace = CURRENT_TRACE.get()
                try:
                    self._q.put_nowait(
                        (msg, trace.tid if trace is not None else None))
                except asyncio.QueueFull:
                    self.ctx.metrics.inc("bridge.nats.dropped")
                    if self.breaker.state != self.breaker.CLOSED:
                        self.ctx.metrics.drop("circuit_open")
            return None

        self._unhooks = [
            self.ctx.hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=-100)
        ]

    async def _drain(self) -> None:
        while True:
            msg, tid = await self._q.get()
            # the connect wait is BOUNDED and counts as a breaker failure:
            # an indefinitely-down remote must open the circuit (a bare
            # connected.wait() would park here forever with it closed)
            while True:
                await self.breaker.wait_ready()
                if self._client.connected.is_set():
                    break
                try:
                    await asyncio.wait_for(self._client.connected.wait(), 3.0)
                    break
                except asyncio.TimeoutError:
                    self.breaker.fail()
            if _FP_EGRESS.action is not None:  # chaos seam (failpoints)
                try:
                    await fire_async_as(_FP_EGRESS)
                except ConnectionError:
                    self.breaker.fail()
                    self.ctx.metrics.inc("bridge.nats.errors")
                    continue
            ok = await self._client.publish(
                self.subject_prefix + mqtt_to_nats_subject(msg.topic), msg.payload,
                headers=[("Mqtt-Trace-Id", tid)] if tid is not None else None,
            )
            if ok:
                self.breaker.ok()
            else:
                self.breaker.fail()
            self.ctx.metrics.inc("bridge.nats.forwarded" if ok else "bridge.nats.errors")

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        if self._pump is not None:
            self._pump.cancel()
            self._pump = None
        if self._client is not None:
            await self._client.stop()
            self._client = None
        return True
