"""Minimal asyncio NATS client (for the NATS bridge plugins).

The reference bridges to NATS via the async-nats crate
(`rmqtt-plugins/rmqtt-bridge-ingress-nats`). NATS speaks a simple text
protocol (INFO/CONNECT/SUB/PUB/MSG/PING/PONG, docs.nats.io), implemented
here directly: publish, queue-group subscribe, auto-reconnect with
resubscribe. Subject mapping MQTT↔NATS: ``/``↔``.``, ``+``↔``*``, ``#``↔``>``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from typing import Awaitable, Callable, Dict, Optional, Tuple

log = logging.getLogger("rmqtt_tpu_torch.bridge.nats")

# on_message(subject, payload)
OnMessage = Callable[[str, bytes], Awaitable[None]]


def mqtt_to_nats_subject(topic: str) -> str:
    return topic.replace(".", "_").replace("/", ".")


def nats_to_mqtt_topic(subject: str) -> str:
    return subject.replace("/", "_").replace(".", "/")


def mqtt_filter_to_nats(topic_filter: str) -> str:
    out = []
    for lev in topic_filter.split("/"):
        if lev == "+":
            out.append("*")
        elif lev == "#":
            out.append(">")
        else:
            out.append(lev.replace(".", "_"))
    return ".".join(out)


class NatsClient:
    def __init__(
        self,
        host: str,
        port: int = 4222,
        on_message: Optional[OnMessage] = None,
        name: str = "rmqtt-bridge",
        reconnect_min: float = 0.5,
        reconnect_max: float = 30.0,
    ) -> None:
        self.host = host
        self.port = port
        self.on_message = on_message
        self.name = name
        self.reconnect_min = reconnect_min
        self.reconnect_max = reconnect_max
        self.connected = asyncio.Event()
        # server advertises header support (HPUB/HMSG) in its INFO line;
        # publishes with headers fall back to plain PUB when unsupported
        self._hdr_support = False
        self._writer: Optional[asyncio.StreamWriter] = None
        self._subs: Dict[int, Tuple[str, Optional[str]]] = {}  # sid → (subject, queue)
        self._sid = itertools.count(1)
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

    async def _run(self) -> None:
        backoff = self.reconnect_min
        while not self._stopping:
            try:
                await self._session()
                backoff = self.reconnect_min
            except (ConnectionError, OSError, asyncio.TimeoutError, ValueError) as e:
                log.warning("nats bridge: connection lost (%s); retry in %.1fs", e, backoff)
            self.connected.clear()
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.reconnect_max)

    async def _session(self) -> None:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), 10.0
        )
        self._writer = writer
        try:
            info = await asyncio.wait_for(reader.readline(), 10.0)
            if not info.startswith(b"INFO"):
                raise ValueError(f"unexpected NATS greeting: {info[:40]!r}")
            try:
                self._hdr_support = bool(json.loads(info[4:]).get("headers"))
            except (ValueError, AttributeError):
                self._hdr_support = False
            opts = {"verbose": False, "pedantic": False, "name": self.name,
                    "lang": "python", "version": "0.1", "protocol": 0}
            if self._hdr_support:
                opts["headers"] = True  # opt in so the server accepts HPUB
            writer.write(b"CONNECT " + json.dumps(opts).encode() + b"\r\n")
            await writer.drain()
            self.connected.set()
            # resubscribe
            for sid, (subject, queue) in self._subs.items():
                q = f" {queue}" if queue else ""
                writer.write(f"SUB {subject}{q} {sid}\r\n".encode())
            await writer.drain()
            while True:
                line = await reader.readline()
                if not line:
                    raise ConnectionError("nats closed")
                if line.startswith(b"MSG"):
                    parts = line.decode().split()
                    # MSG <subject> <sid> [reply-to] <#bytes>
                    subject = parts[1]
                    nbytes = int(parts[-1])
                    payload = await reader.readexactly(nbytes)
                    await reader.readexactly(2)  # trailing \r\n
                    if self.on_message is not None:
                        await self.on_message(subject, payload)
                elif line.startswith(b"PING"):
                    writer.write(b"PONG\r\n")
                    await writer.drain()
                elif line.startswith(b"-ERR"):
                    log.warning("nats error: %s", line.decode().strip())
        finally:
            self.connected.clear()
            try:
                writer.close()
            except Exception:
                pass
            self._writer = None

    async def subscribe(self, subject: str, queue: Optional[str] = None) -> int:
        sid = next(self._sid)
        self._subs[sid] = (subject, queue)
        if self.connected.is_set() and self._writer is not None:
            q = f" {queue}" if queue else ""
            self._writer.write(f"SUB {subject}{q} {sid}\r\n".encode())
            await self._writer.drain()
        return sid

    async def publish(self, subject: str, payload: bytes,
                      headers: Optional[list] = None) -> bool:
        """``headers`` is ``[(key, value), ...]``; sent as an HPUB header
        block when the server supports headers, silently dropped (plain
        PUB) when it doesn't — delivery beats metadata."""
        if not self.connected.is_set() or self._writer is None:
            return False
        if headers and self._hdr_support:
            hdr = b"NATS/1.0\r\n" + b"".join(
                f"{k}: {v}\r\n".encode() for k, v in headers) + b"\r\n"
            self._writer.write(
                f"HPUB {subject} {len(hdr)} {len(hdr) + len(payload)}\r\n".encode()
                + hdr + payload + b"\r\n")
        else:
            self._writer.write(
                f"PUB {subject} {len(payload)}\r\n".encode() + payload + b"\r\n")
        await self._writer.drain()
        return True
