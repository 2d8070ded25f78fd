"""MQTT-over-WebSocket transport (RFC 6455, server side).

The reference supports WS/WSS listeners (`rmqtt-net/src/ws.rs`, builder
listeners `rmqtt-net/src/builder.rs`). This is a dependency-free WebSocket
server endpoint: HTTP upgrade with ``Sec-WebSocket-Accept``, the ``mqtt``
subprotocol, binary frames (client→server masked per spec), fragmentation
reassembly, ping/pong, close — adapted to the broker's reader/writer duck
type so the same connection handler serves TCP and WS.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Optional, Tuple

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


async def websocket_accept(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                           timeout: float = 10.0) -> bool:
    """Perform the server-side HTTP upgrade. Returns False on a bad request."""
    try:
        request = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
    except (asyncio.TimeoutError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        return False
    lines = request.decode("latin1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        if v:
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if key is None or "websocket" not in headers.get("upgrade", "").lower():
        writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n")
        await writer.drain()
        return False
    accept = base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
    proto = ""
    offered = [p.strip() for p in headers.get("sec-websocket-protocol", "").split(",") if p.strip()]
    if "mqtt" in offered:
        proto = "Sec-WebSocket-Protocol: mqtt\r\n"
    writer.write(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n{proto}\r\n"
        ).encode()
    )
    await writer.drain()
    return True


class WsReader:
    """Duck-typed StreamReader over WS binary frames."""

    def __init__(self, reader: asyncio.StreamReader, writer: "WsWriter") -> None:
        self._reader = reader
        self._writer = writer
        self._buf = bytearray()
        self._closed = False
        self._fragments = bytearray()

    async def read(self, n: int = -1) -> bytes:
        while not self._buf and not self._closed:
            payload = await self._next_message()
            if payload is None:
                self._closed = True
                break
            self._buf += payload
        if not self._buf:
            return b""
        if n < 0 or n >= len(self._buf):
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out

    async def _next_message(self) -> Optional[bytes]:
        """One complete (possibly fragmented) binary message; None on close."""
        while True:
            frame = await self._read_frame()
            if frame is None:
                return None
            fin, op, payload = frame
            if op == OP_PING:
                await self._writer.send_frame(OP_PONG, payload)
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                try:
                    await self._writer.send_frame(OP_CLOSE, payload[:2])
                except (ConnectionError, OSError):
                    pass
                return None
            if op in (OP_BIN, OP_TEXT):
                if fin:
                    return payload
                self._fragments = bytearray(payload)
            elif op == OP_CONT:
                self._fragments += payload
                if fin:
                    out = bytes(self._fragments)
                    self._fragments = bytearray()
                    return out

    async def _read_frame(self) -> Optional[Tuple[bool, int, bytes]]:
        try:
            head = await self._reader.readexactly(2)
            fin = bool(head[0] & 0x80)
            op = head[0] & 0x0F
            masked = bool(head[1] & 0x80)
            length = head[1] & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", await self._reader.readexactly(2))
            elif length == 127:
                (length,) = struct.unpack(">Q", await self._reader.readexactly(8))
            if length > 16 * 1024 * 1024:
                return None
            mask = await self._reader.readexactly(4) if masked else None
            payload = await self._reader.readexactly(length) if length else b""
            if mask:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            return fin, op, payload
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return None


class WsWriter:
    """Duck-typed StreamWriter sending WS binary frames (server: unmasked)."""

    # bytes only reach the wire on drain() (a whole WS frame per drain):
    # callers must NOT elide drains the way they may for raw StreamWriters
    buffers_until_drain = True

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer
        self._pending = bytearray()

    def write(self, data: bytes) -> None:
        self._pending += data

    async def drain(self) -> None:
        if self._pending:
            data, self._pending = bytes(self._pending), bytearray()
            await self.send_frame(OP_BIN, data)

    async def send_frame(self, op: int, payload: bytes) -> None:
        head = bytearray([0x80 | op])
        n = len(payload)
        if n < 126:
            head.append(n)
        elif n < 65536:
            head.append(126)
            head += struct.pack(">H", n)
        else:
            head.append(127)
            head += struct.pack(">Q", n)
        self._writer.write(bytes(head) + payload)
        await self._writer.drain()

    def get_extra_info(self, name, default=None):
        return self._writer.get_extra_info(name, default)

    def close(self) -> None:
        self._writer.close()

    @property
    def transport(self):
        return self._writer.transport


def mask_client_frame(op: int, payload: bytes, mask: bytes = b"\x12\x34\x56\x78") -> bytes:
    """Build a masked client→server frame (for test clients/bridges)."""
    head = bytearray([0x80 | op])
    n = len(payload)
    if n < 126:
        head.append(0x80 | n)
    elif n < 65536:
        head.append(0x80 | 126)
        head += struct.pack(">H", n)
    else:
        head.append(0x80 | 127)
        head += struct.pack(">Q", n)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return bytes(head) + mask + masked
