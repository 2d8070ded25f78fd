"""Compact binary serialization for cluster RPC payloads.

The reference serializes RPC payloads with postcard (compact, schema-less;
`rmqtt/src/grpc.rs:537-545`). This is the equivalent: a small self-describing
binary format for the JSON-ish data model (None/bool/int/float/str/bytes/
list/dict) — no pickle (cluster links shouldn't deserialize arbitrary
objects), no base64 inflation for payload bytes.
"""

from __future__ import annotations

import struct
from typing import Any

#: shared frame cap for length-prefixed links built on this format (the
#: cluster TCP mesh and the intra-node fabric UDS mesh both enforce it;
#: reference caps messages at 4MB, grpc.rs:154)
MAX_FRAME = 8 * 1024 * 1024

_NONE = 0
_TRUE = 1
_FALSE = 2
_INT = 3
_FLOAT = 4
_STR = 5
_BYTES = 6
_LIST = 7
_DICT = 8
_NEGINT = 9


def _write_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _enc(out, obj)
    return bytes(out)


def _enc(out: bytearray, o: Any) -> None:
    if o is None:
        out.append(_NONE)
    elif o is True:
        out.append(_TRUE)
    elif o is False:
        out.append(_FALSE)
    elif isinstance(o, int):
        if o >= 0:
            out.append(_INT)
            _write_varint(out, o)
        else:
            out.append(_NEGINT)
            _write_varint(out, -o)
    elif isinstance(o, float):
        out.append(_FLOAT)
        out += struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        out.append(_STR)
        _write_varint(out, len(b))
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        out.append(_BYTES)
        _write_varint(out, len(b))
        out += b
    elif isinstance(o, (list, tuple)):
        out.append(_LIST)
        _write_varint(out, len(o))
        for item in o:
            _enc(out, item)
    elif isinstance(o, dict):
        out.append(_DICT)
        _write_varint(out, len(o))
        for k, v in o.items():
            _enc(out, k)
            _enc(out, v)
    else:
        raise TypeError(f"unserializable type {type(o).__name__}")


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated wire data")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def varint(self) -> int:
        shift, value = 0, 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 70:
                raise ValueError("malformed varint")


def loads(data: bytes) -> Any:
    c = _Cursor(data)
    obj = _dec(c)
    if c.pos != len(data):
        raise ValueError("trailing wire data")
    return obj


def frame(obj: Any, max_frame: int = MAX_FRAME) -> bytes:
    """One length-prefixed frame (4-byte BE length + payload) — the shared
    primitive under every link that speaks this format (cluster transport,
    intra-node fabric)."""
    data = dumps(obj)
    if len(data) > max_frame:
        raise ValueError(f"oversized wire frame: {len(data)}")
    return len(data).to_bytes(4, "big") + data


async def read_frame(reader, max_frame: int = MAX_FRAME) -> Any:
    """Read one length-prefixed frame from an asyncio StreamReader."""
    head = await reader.readexactly(4)
    length = int.from_bytes(head, "big")
    if length > max_frame:
        raise ConnectionError(f"oversized wire frame: {length}")
    return loads(await reader.readexactly(length))


def _dec(c: _Cursor, depth: int = 0) -> Any:
    if depth > 64:
        raise ValueError("wire data too deeply nested")
    tag = c.take(1)[0]
    if tag == _NONE:
        return None
    if tag == _TRUE:
        return True
    if tag == _FALSE:
        return False
    if tag == _INT:
        return c.varint()
    if tag == _NEGINT:
        return -c.varint()
    if tag == _FLOAT:
        return struct.unpack(">d", c.take(8))[0]
    if tag == _STR:
        return c.take(c.varint()).decode("utf-8")
    if tag == _BYTES:
        return c.take(c.varint())
    if tag == _LIST:
        return [_dec(c, depth + 1) for _ in range(c.varint())]
    if tag == _DICT:
        return {_dec(c, depth + 1): _dec(c, depth + 1) for _ in range(c.varint())}
    raise ValueError(f"unknown wire tag {tag}")
