"""Dependency-free Apache Pulsar wire-protocol client (asyncio).

The reference's Pulsar bridges sit on the `pulsar` crate; no Pulsar stack
ships in this image, so this implements the protocol subset a bridge needs
directly over the public binary protocol (pulsar.apache.org/docs/developing
-binary-protocol): frames are ``[totalSize][commandSize][BaseCommand]``
with SEND/MESSAGE adding ``[0x0e01][crc32c][metadataSize][MessageMetadata]
[payload]``. Commands are protobuf messages — encoded/decoded here with a
minimal hand-rolled protobuf layer (varint + length-delimited fields only),
field numbers per PulsarApi.proto.

Scope notes (vs the crate the reference uses): connects straight to the
configured broker (no topic-lookup redirection — correct for standalone /
single-broker deployments), no batching, no compression, subscription
types Exclusive/Shared/Failover/KeyShared.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.bridge.kafka_client import crc32c  # same Castagnoli table

log = logging.getLogger("rmqtt_tpu_torch.bridge.pulsar")

# BaseCommand.Type values / field numbers (PulsarApi.proto: the submessage
# field number equals these for every command used here)
CONNECT = 2
CONNECTED = 3
SUBSCRIBE = 4
PRODUCER = 5
SEND = 6
SEND_RECEIPT = 7
SEND_ERROR = 8
MESSAGE = 9
ACK = 10
FLOW = 11
SUCCESS = 13
ERROR = 14
PRODUCER_SUCCESS = 17
PING = 18
PONG = 19

SUB_TYPES = {"exclusive": 0, "shared": 1, "failover": 2, "key_shared": 3}
POS_LATEST, POS_EARLIEST = 0, 1

MAGIC = b"\x0e\x01"
PROTOCOL_VERSION = 6  # baseline features only


# ------------------------------------------------------- minimal protobuf
def _uvarint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def pb_varint(out: bytearray, field: int, v: int) -> None:
    _uvarint(out, (field << 3) | 0)
    _uvarint(out, v)


def pb_bytes(out: bytearray, field: int, data: bytes) -> None:
    _uvarint(out, (field << 3) | 2)
    _uvarint(out, len(data))
    out += data


def pb_str(out: bytearray, field: int, s: str) -> None:
    pb_bytes(out, field, s.encode())


def pb_decode(buf: bytes) -> Dict[int, list]:
    """Generic decode → {field: [values]} (varint ints, bytes for len-delim)."""
    out: Dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            out.setdefault(field, []).append(v)
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            out.setdefault(field, []).append(bytes(buf[pos : pos + ln]))
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
    return out


def base_command(ctype: int, sub: bytes = b"") -> bytes:
    out = bytearray()
    pb_varint(out, 1, ctype)
    # ALWAYS emit the submessage field (even empty): the broker-side decoder
    # checks hasX() for the command's field — a bare PONG is rejected
    pb_bytes(out, ctype, sub)  # submessage field number == type value
    return bytes(out)


def message_metadata(producer_name: str, sequence_id: int,
                     properties: List[Tuple[str, str]] = (),
                     partition_key: Optional[str] = None) -> bytes:
    out = bytearray()
    pb_str(out, 1, producer_name)
    pb_varint(out, 2, sequence_id)
    pb_varint(out, 3, int(time.time() * 1000))
    for k, v in properties:
        kv = bytearray()
        pb_str(kv, 1, k)
        pb_str(kv, 2, v)
        pb_bytes(out, 4, bytes(kv))
    if partition_key is not None:
        pb_str(out, 6, partition_key)
    return bytes(out)


def frame_simple(cmd: bytes) -> bytes:
    return struct.pack(">II", 4 + len(cmd), len(cmd)) + cmd


def frame_payload(cmd: bytes, metadata: bytes, payload: bytes) -> bytes:
    tail = struct.pack(">I", len(metadata)) + metadata + payload
    crc = crc32c(tail)
    body = struct.pack(">I", len(cmd)) + cmd + MAGIC + struct.pack(">I", crc) + tail
    return struct.pack(">I", len(body)) + body


# ----------------------------------------------------------------- client
class PulsarClient:
    def __init__(self, host: str, port: int = 6650,
                 on_message: Optional[Callable[..., Awaitable[None]]] = None) -> None:
        self.host, self.port = host, port
        self.on_message = on_message  # async (consumer_id, msg_id_raw, props, payload)
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.connected = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._req_id = 0
        self._req_waiters: Dict[int, asyncio.Future] = {}  # request_id → fut
        self._send_waiters: Dict[Tuple[int, int], asyncio.Future] = {}
        self._producer_names: Dict[int, str] = {}

    def _next_request(self) -> Tuple[int, asyncio.Future]:
        self._req_id += 1
        fut = asyncio.get_running_loop().create_future()
        self._req_waiters[self._req_id] = fut
        return self._req_id, fut

    async def connect(self, timeout: float = 10.0) -> None:
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), timeout
        )
        sub = bytearray()
        pb_str(sub, 1, "rmqtt-tpu-bridge")
        pb_varint(sub, 4, PROTOCOL_VERSION)
        await self._send(frame_simple(base_command(CONNECT, bytes(sub))))
        self._task = asyncio.get_running_loop().create_task(self._read_loop())
        await asyncio.wait_for(self.connected.wait(), timeout)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass

    async def _send(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()

    # ------------------------------------------------------------ commands
    async def create_producer(self, topic: str, producer_id: int = 1,
                              timeout: float = 10.0) -> str:
        rid, fut = self._next_request()
        sub = bytearray()
        pb_str(sub, 1, topic)
        pb_varint(sub, 2, producer_id)
        pb_varint(sub, 3, rid)
        await self._send(frame_simple(base_command(PRODUCER, bytes(sub))))
        reply = await asyncio.wait_for(fut, timeout)
        name = reply.get(2, [b"producer"])[0].decode()
        self._producer_names[producer_id] = name
        return name

    async def send(self, producer_id: int, sequence_id: int, payload: bytes,
                   properties: List[Tuple[str, str]] = (),
                   partition_key: Optional[str] = None, timeout: float = 10.0) -> None:
        sub = bytearray()
        pb_varint(sub, 1, producer_id)
        pb_varint(sub, 2, sequence_id)
        meta = message_metadata(
            self._producer_names.get(producer_id, "producer"), sequence_id,
            properties, partition_key,
        )
        fut = asyncio.get_running_loop().create_future()
        self._send_waiters[(producer_id, sequence_id)] = fut
        try:
            await self._send(frame_payload(base_command(SEND, bytes(sub)), meta, payload))
            await asyncio.wait_for(fut, timeout)
        finally:
            self._send_waiters.pop((producer_id, sequence_id), None)

    async def subscribe(self, topic: str, subscription: str, consumer_id: int = 1,
                        sub_type: str = "shared", initial_position: str = "latest",
                        timeout: float = 10.0) -> None:
        rid, fut = self._next_request()
        sub = bytearray()
        pb_str(sub, 1, topic)
        pb_str(sub, 2, subscription)
        pb_varint(sub, 3, SUB_TYPES.get(sub_type, 1))
        pb_varint(sub, 4, consumer_id)
        pb_varint(sub, 5, rid)
        pb_varint(sub, 13, POS_EARLIEST if initial_position in ("earliest", "beginning") else POS_LATEST)
        await self._send(frame_simple(base_command(SUBSCRIBE, bytes(sub))))
        await asyncio.wait_for(fut, timeout)

    async def flow(self, consumer_id: int, permits: int = 1000) -> None:
        sub = bytearray()
        pb_varint(sub, 1, consumer_id)
        pb_varint(sub, 2, permits)
        await self._send(frame_simple(base_command(FLOW, bytes(sub))))

    async def ack(self, consumer_id: int, message_id_raw: bytes) -> None:
        sub = bytearray()
        pb_varint(sub, 1, consumer_id)
        pb_varint(sub, 2, 0)  # Individual
        pb_bytes(sub, 3, message_id_raw)
        await self._send(frame_simple(base_command(ACK, bytes(sub))))

    # ----------------------------------------------------------- read loop
    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self.reader.readexactly(4)
                (total,) = struct.unpack(">I", head)
                body = await self.reader.readexactly(total)
                (csize,) = struct.unpack(">I", body[:4])
                cmd = pb_decode(body[4 : 4 + csize])
                ctype = cmd.get(1, [0])[0]
                rest = body[4 + csize :]
                await self._dispatch(ctype, cmd, rest)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self.connected.clear()
            # fail fast: in-flight calls must not sit out their timeouts
            err = ConnectionError("pulsar connection lost")
            for fut in list(self._req_waiters.values()) + list(self._send_waiters.values()):
                if not fut.done():
                    fut.set_exception(err)
            self._req_waiters.clear()
            self._send_waiters.clear()

    async def _dispatch(self, ctype: int, cmd: Dict[int, list], rest: bytes) -> None:
        sub = pb_decode(cmd[ctype][0]) if ctype in cmd and cmd[ctype] else {}
        if ctype == CONNECTED:
            self.connected.set()
        elif ctype == PING:
            await self._send(frame_simple(base_command(PONG)))
        elif ctype in (PRODUCER_SUCCESS, SUCCESS):
            rid = sub.get(1, [0])[0]
            fut = self._req_waiters.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_result(sub)
        elif ctype == ERROR:
            rid = sub.get(1, [0])[0]
            fut = self._req_waiters.pop(rid, None)
            msg = sub.get(3, [b""])[0]
            if fut is not None and not fut.done():
                fut.set_exception(ConnectionError(f"pulsar error: {msg!r}"))
        elif ctype == SEND_RECEIPT:
            key = (sub.get(1, [0])[0], sub.get(2, [0])[0])
            fut = self._send_waiters.get(key)
            if fut is not None and not fut.done():
                fut.set_result(True)
        elif ctype == SEND_ERROR:
            key = (sub.get(1, [0])[0], sub.get(2, [0])[0])
            fut = self._send_waiters.get(key)
            if fut is not None and not fut.done():
                fut.set_exception(ConnectionError("pulsar send error"))
        elif ctype == MESSAGE:
            consumer_id = sub.get(1, [0])[0]
            msg_id_raw = sub.get(2, [b""])[0]
            if len(rest) >= 10 and rest[:2] == MAGIC:
                (msize,) = struct.unpack(">I", rest[6:10])
                meta = pb_decode(rest[10 : 10 + msize])
                payload = rest[10 + msize :]
            else:  # checksum-less variant: [metadataSize][metadata][payload]
                (msize,) = struct.unpack(">I", rest[:4])
                meta = pb_decode(rest[4 : 4 + msize])
                payload = rest[4 + msize :]
            props = []
            for kv in meta.get(4, []):
                d = pb_decode(kv)
                props.append((d.get(1, [b""])[0].decode(), d.get(2, [b""])[0].decode()))
            if self.on_message is not None:
                await self.on_message(consumer_id, msg_id_raw, props, payload)
