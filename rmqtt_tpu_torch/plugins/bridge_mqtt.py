"""MQTT bridge plugins (ingress + egress).

Mirror `rmqtt-plugins/rmqtt-bridge-ingress-mqtt` / `-egress-mqtt`:
- ingress: connect to a remote broker, subscribe configured filters,
  republish inbound messages into the local broker with optional topic
  prefix remapping and reconnection.
- egress: forward locally published messages matching configured filters to
  a remote broker (queue + the client's reconnect/backoff).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import List, Optional

from rmqtt_tpu_torch.bridge.client import MqttClient
from rmqtt_tpu_torch.broker.codec import packets as pk
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import Id
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, fire_async_as

_FP_EGRESS = FAILPOINTS.register("bridge.egress")  # chaos seam (failpoints)

log = logging.getLogger("rmqtt_tpu_torch.bridge")


class BridgeIngressMqttPlugin(Plugin):
    name = "rmqtt-bridge-ingress-mqtt"
    descr = "remote MQTT broker → local broker"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.remote_host = self.config.get("host", "127.0.0.1")
        self.remote_port = int(self.config.get("port", 1883))
        self.filters: List[dict] = self.config.get(
            "subscribes", [{"filter": "#", "qos": 0}]
        )
        self.local_prefix = self.config.get("local_prefix", "")
        self.client_id = self.config.get("client_id", f"bridge-in-{ctx.node_id}")
        self._client: Optional[MqttClient] = None

    async def start(self) -> None:
        async def on_publish(p: pk.Publish) -> None:
            topic = self.local_prefix + p.topic
            msg = Message(
                topic=topic, payload=p.payload, qos=p.qos, retain=p.retain,
                from_id=Id(self.ctx.node_id, self.client_id),
            )
            if p.retain:
                self.ctx.retain.set(topic, msg)
            await self.ctx.registry.forwards(msg)

        self._client = MqttClient(
            self.remote_host, self.remote_port, self.client_id, on_publish=on_publish
        )
        self._client.start()
        for sub in self.filters:
            await self._client.subscribe(sub["filter"], int(sub.get("qos", 0)))

    async def stop(self) -> bool:
        if self._client is not None:
            await self._client.stop()
            self._client = None
        return True

    def attrs(self):
        return {
            "remote": f"{self.remote_host}:{self.remote_port}",
            "connected": bool(self._client and self._client.connected.is_set()),
        }


class BridgeEgressMqttPlugin(Plugin):
    name = "rmqtt-bridge-egress-mqtt"
    descr = "local broker → remote MQTT broker"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.remote_host = self.config.get("host", "127.0.0.1")
        self.remote_port = int(self.config.get("port", 1883))
        self.filters: List[str] = self.config.get("forwards", ["#"])
        self.remote_prefix = self.config.get("remote_prefix", "")
        self.client_id = self.config.get("client_id", f"bridge-out-{ctx.node_id}")
        self.max_queue = int(self.config.get("max_queue", 10_000))
        self._client: Optional[MqttClient] = None
        self._q: Optional[asyncio.Queue] = None
        self._pump: Optional[asyncio.Task] = None
        self._unhooks = []
        self.breaker = None  # set in start() from the overload registry

    async def start(self) -> None:
        self._client = MqttClient(self.remote_host, self.remote_port, self.client_id)
        self._client.start()
        self._q = asyncio.Queue(maxsize=self.max_queue)
        # circuit-broken producer (broker/overload.py): a dead upstream
        # broker fails fast; overflow drops while open are reason-labeled
        self.breaker = self.ctx.overload.breaker("bridge.mqtt")
        self._pump = asyncio.get_running_loop().create_task(self._drain())

        async def on_publish(_ht, args, prev):
            msg = prev if prev is not None else args[1]
            # don't loop our own bridged-in messages back out
            if msg.from_id is not None and msg.from_id.client_id == self.client_id:
                return None
            if not self.ctx.overload.allow_noncritical():
                self.ctx.metrics.inc("bridge.egress.paused")
                return None
            if any(match_filter(f, msg.topic) for f in self.filters):
                try:
                    self._q.put_nowait(msg)
                except asyncio.QueueFull:
                    self.ctx.metrics.inc("bridge.egress.dropped")
                    if self.breaker.state != self.breaker.CLOSED:
                        self.ctx.metrics.drop("circuit_open")
            return None

        self._unhooks = [
            self.ctx.hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=-100)
        ]

    async def _drain(self) -> None:
        while True:
            msg: Message = await self._q.get()
            # bounded connect wait that FEEDS the breaker: a dead upstream
            # must open the circuit, not park the pump forever with it
            # closed (connected.wait() alone never returns then)
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
                    self.ctx.metrics.inc("bridge.egress.errors")
                    continue
            ok = await self._client.publish(
                self.remote_prefix + msg.topic, msg.payload, qos=min(msg.qos, 1),
                retain=msg.retain,
            )
            if ok:
                self.breaker.ok()
                self.ctx.metrics.inc("bridge.egress.forwarded")
            else:
                self.breaker.fail()
                self.ctx.metrics.inc("bridge.egress.errors")

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
