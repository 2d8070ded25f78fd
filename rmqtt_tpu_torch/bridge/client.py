"""Asyncio MQTT client (bridge-grade: reconnect, QoS1, callbacks).

The client half the bridge plugins need (the reference bridges embed their
own client sessions, `rmqtt-plugins/rmqtt-bridge-ingress-mqtt`): CONNECT/
SUBSCRIBE/PUBLISH over the shared wire codec, exponential-backoff reconnect
with resubscribe, inbound publish callback, QoS0/1 outbound (QoS1 acked).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.codec import MqttCodec, packets as pk
from rmqtt_tpu_torch.broker.codec.packets import SubOpts

log = logging.getLogger("rmqtt_tpu_torch.bridge")

OnPublish = Callable[[pk.Publish], Awaitable[None]]


class MqttClient:
    def __init__(
        self,
        host: str,
        port: int,
        client_id: str,
        on_publish: Optional[OnPublish] = None,
        version: int = pk.V311,
        keepalive: int = 30,
        username: Optional[str] = None,
        password: Optional[bytes] = None,
        reconnect_min: float = 0.5,
        reconnect_max: float = 30.0,
    ) -> None:
        self.host = host
        self.port = port
        self.client_id = client_id
        self.on_publish = on_publish
        self.version = version
        self.keepalive = keepalive
        self.username = username
        self.password = password
        self.reconnect_min = reconnect_min
        self.reconnect_max = reconnect_max
        self.connected = asyncio.Event()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._codec = MqttCodec(version)
        self._subs: Dict[str, int] = {}  # filter → qos (for resubscribe)
        self._pid = itertools.cycle(range(1, 65536))
        self._acks: Dict[int, asyncio.Future] = {}
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass

    # ---------------------------------------------------------------- core
    async def _run(self) -> None:
        backoff = self.reconnect_min
        while not self._stopping:
            try:
                await self._session()
                backoff = self.reconnect_min
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                log.warning("bridge %s: connection lost (%s); retry in %.1fs",
                            self.client_id, e, backoff)
            self.connected.clear()
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.reconnect_max)

    async def _session(self) -> None:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), 10.0
        )
        self._writer = writer
        self._codec = MqttCodec(self.version)
        writer.write(
            self._codec.encode(
                pk.Connect(
                    client_id=self.client_id, protocol=self.version,
                    keepalive=self.keepalive, clean_start=True,
                    username=self.username, password=self.password,
                )
            )
        )
        await writer.drain()
        ping_task: Optional[asyncio.Task] = None
        try:
            while True:
                data = await asyncio.wait_for(
                    reader.read(65536), timeout=max(self.keepalive * 2, 10)
                )
                if not data:
                    raise ConnectionError("closed by remote")
                for p in self._codec.feed(data):
                    if isinstance(p, pk.Connack):
                        if p.reason_code != 0:
                            raise ConnectionError(f"connack rc={p.reason_code}")
                        self.connected.set()
                        if self.keepalive and ping_task is None:
                            ping_task = asyncio.create_task(self._ping_loop())
                        await self._resubscribe()
                    elif isinstance(p, pk.Publish):
                        if p.qos == 1:
                            await self._send(pk.Puback(p.packet_id))
                        elif p.qos == 2:
                            await self._send(pk.Pubrec(p.packet_id))
                        if self.on_publish is not None:
                            await self.on_publish(p)
                    elif isinstance(p, pk.Pubrel):
                        await self._send(pk.Pubcomp(p.packet_id))
                    elif isinstance(p, (pk.Puback, pk.Pubcomp)):
                        fut = self._acks.pop(p.packet_id, None)
                        if fut is not None and not fut.done():
                            fut.set_result(p)
                    elif isinstance(p, pk.Pubrec):
                        await self._send(pk.Pubrel(p.packet_id))
                    elif isinstance(p, pk.Suback):
                        fut = self._acks.pop(("sub", p.packet_id), None)  # type: ignore[arg-type]
                        if fut is not None and not fut.done():
                            fut.set_result(p)
        finally:
            if ping_task is not None:
                ping_task.cancel()
            for fut in self._acks.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("bridge session ended"))
            self._acks.clear()
            try:
                writer.close()
            except Exception:
                pass
            self._writer = None

    async def _ping_loop(self) -> None:
        while True:
            await asyncio.sleep(max(self.keepalive * 0.7, 1.0))
            await self._send(pk.Pingreq())

    async def _send(self, p) -> None:
        if self._writer is None:
            raise ConnectionError("not connected")
        self._writer.write(self._codec.encode(p))
        await self._writer.drain()

    async def _resubscribe(self) -> None:
        for tf, qos in self._subs.items():
            pid = next(self._pid)
            await self._send(pk.Subscribe(pid, [(tf, SubOpts(qos=qos))]))

    # ----------------------------------------------------------------- API
    async def subscribe(self, topic_filter: str, qos: int = 0) -> None:
        self._subs[topic_filter] = qos
        if self.connected.is_set():
            pid = next(self._pid)
            await self._send(pk.Subscribe(pid, [(topic_filter, SubOpts(qos=qos))]))

    async def publish(
        self, topic: str, payload: bytes, qos: int = 0, retain: bool = False,
        wait_ack: bool = True, timeout: float = 10.0,
    ) -> bool:
        if not self.connected.is_set():
            return False
        pid = next(self._pid) if qos else None
        # install the ack future BEFORE the send: drain() can suspend under
        # write backpressure, letting the read loop process the PUBACK first
        fut = None
        if qos and wait_ack:
            fut = asyncio.get_running_loop().create_future()
            self._acks[pid] = fut
        try:
            await self._send(
                pk.Publish(topic=topic, payload=payload, qos=qos, retain=retain, packet_id=pid)
            )
        except (ConnectionError, OSError):
            if fut is not None:
                self._acks.pop(pid, None)
            return False
        if fut is not None:
            try:
                await asyncio.wait_for(fut, timeout)
            except (asyncio.TimeoutError, ConnectionError):
                self._acks.pop(pid, None)
                return False
        return True
