"""MQTT wire primitives: varint, UTF-8 strings, binary data, fixed ints."""

from __future__ import annotations


class ProtocolViolation(ValueError):
    """Wire-level violation. ``reason_code`` is the v5 DISCONNECT reason the
    server should send before closing (0x81 malformed packet by default;
    the codec's size cap uses 0x95 packet-too-large)."""

    def __init__(self, msg: str, reason_code: int = 0x81) -> None:
        super().__init__(msg)
        self.reason_code = reason_code


def encode_varint(n: int) -> bytes:
    """Variable byte integer (MQTT 1.5.5), up to 268 435 455."""
    if n < 0 or n > 0x0FFFFFFF:
        raise ProtocolViolation(f"varint out of range: {n}")
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ProtocolViolation("utf8 string too long")
    return len(b).to_bytes(2, "big") + b


def encode_binary(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise ProtocolViolation("binary data too long")
    return len(b).to_bytes(2, "big") + b


class Reader:
    """Cursor over one packet body; all reads bounds-checked."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: int | None = None) -> None:
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def _need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise ProtocolViolation("truncated packet")

    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        self._need(1)
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        self._need(2)
        v = int.from_bytes(self.buf[self.pos : self.pos + 2], "big")
        self.pos += 2
        return v

    def u32(self) -> int:
        self._need(4)
        v = int.from_bytes(self.buf[self.pos : self.pos + 4], "big")
        self.pos += 4
        return v

    def varint(self) -> int:
        mult, value = 1, 0
        for _ in range(4):
            b = self.u8()
            value += (b & 0x7F) * mult
            if not b & 0x80:
                return value
            mult *= 128
        raise ProtocolViolation("malformed varint")

    def take(self, n: int) -> bytes:
        self._need(n)
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return bytes(v)

    def rest(self) -> bytes:
        return self.take(self.end - self.pos)

    def utf8(self) -> str:
        n = self.u16()
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ProtocolViolation(f"invalid utf8: {e}") from e

    def binary(self) -> bytes:
        return self.take(self.u16())
