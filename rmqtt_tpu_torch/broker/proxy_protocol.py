"""HAProxy PROXY protocol v1/v2 (listener-side parse).

The reference enables this per listener (`rmqtt-net/src/builder.rs:152,
466-474, 715+` via the proxy_protocol crate): when a load balancer fronts
the broker, the ORIGINAL client address arrives in a PROXY header before
the MQTT bytes. This is an independent stdlib implementation of the parse
side (spec: haproxy.org/download/1.8/doc/proxy-protocol.txt):

- v1: ASCII line ``PROXY TCP4|TCP6|UNKNOWN <src> <dst> <sport> <dport>\\r\\n``
  (max 107 bytes).
- v2: 12-byte signature ``\\r\\n\\r\\n\\x00\\r\\nQUIT\\n`` + ver/cmd + family
  + 2-byte length + address block (TLVs ignored).

``read_proxy_header(reader)`` consumes exactly the header bytes (exact
reads, nothing buffered past it) and returns the advertised source address
or None for LOCAL/UNKNOWN (caller keeps the socket peer address).
Malformed headers raise ``ProxyProtocolError``.
"""

from __future__ import annotations

import asyncio
import socket
from typing import Optional, Tuple

V2_SIG = b"\r\n\r\n\x00\r\nQUIT\n"


class ProxyProtocolError(Exception):
    pass


async def read_proxy_header(reader: asyncio.StreamReader) -> Optional[Tuple[str, int]]:
    first = await reader.readexactly(1)
    if first == b"P":
        return await _read_v1(reader)
    if first == b"\r":
        return await _read_v2(reader)
    raise ProxyProtocolError(f"not a PROXY header (starts {first!r})")


async def _read_v1(reader) -> Optional[Tuple[str, int]]:
    # already consumed 'P'; the rest of the line is at most 106 bytes
    line = bytearray(b"P")
    while not line.endswith(b"\r\n"):
        if len(line) > 107:
            raise ProxyProtocolError("v1 header too long")
        line += await reader.readexactly(1)
    parts = line[:-2].decode("ascii", "replace").split(" ")
    if parts[0] != "PROXY":
        raise ProxyProtocolError(f"bad v1 magic {parts[0]!r}")
    if len(parts) >= 2 and parts[1] == "UNKNOWN":
        return None  # keep the socket peer address
    if len(parts) != 6 or parts[1] not in ("TCP4", "TCP6"):
        raise ProxyProtocolError(f"bad v1 header {line!r}")
    src_ip = parts[2]
    try:
        sport = int(parts[4])
    except ValueError as e:
        raise ProxyProtocolError(f"bad v1 source port {parts[4]!r}") from e
    family = socket.AF_INET if parts[1] == "TCP4" else socket.AF_INET6
    try:
        socket.inet_pton(family, src_ip)
    except OSError as e:
        raise ProxyProtocolError(f"bad v1 source ip {src_ip!r}") from e
    if not 0 <= sport <= 65535:
        raise ProxyProtocolError(f"bad v1 source port {sport}")
    return src_ip, sport


async def _read_v2(reader) -> Optional[Tuple[str, int]]:
    rest = await reader.readexactly(len(V2_SIG) - 1 + 4)  # sig + vercmd/fam/len
    sig = b"\r" + rest[: len(V2_SIG) - 1]
    if sig != V2_SIG:
        raise ProxyProtocolError("bad v2 signature")
    ver_cmd, fam_proto = rest[11], rest[12]
    length = int.from_bytes(rest[13:15], "big")
    body = await reader.readexactly(length)
    if ver_cmd >> 4 != 2:
        raise ProxyProtocolError(f"bad v2 version {ver_cmd >> 4}")
    cmd = ver_cmd & 0x0F
    if cmd == 0:  # LOCAL (health check): keep socket address
        return None
    if cmd != 1:
        raise ProxyProtocolError(f"bad v2 command {cmd}")
    family = fam_proto >> 4
    if family == 1:  # AF_INET
        if length < 12:
            raise ProxyProtocolError("v2 ipv4 block too short")
        src = socket.inet_ntop(socket.AF_INET, body[0:4])
        sport = int.from_bytes(body[8:10], "big")
        return src, sport
    if family == 2:  # AF_INET6
        if length < 36:
            raise ProxyProtocolError("v2 ipv6 block too short")
        src = socket.inet_ntop(socket.AF_INET6, body[0:16])
        sport = int.from_bytes(body[32:34], "big")
        return src, sport
    return None  # AF_UNSPEC / AF_UNIX: keep socket address


def encode_v1(src: str, dst: str, sport: int, dport: int, tcp6: bool = False) -> bytes:
    """Build a v1 header (test harness / egress bridges)."""
    fam = "TCP6" if tcp6 else "TCP4"
    return f"PROXY {fam} {src} {dst} {sport} {dport}\r\n".encode()


def encode_v2(src: str, dst: str, sport: int, dport: int) -> bytes:
    """Build a v2 PROXY (ipv4) header (test harness / egress bridges)."""
    body = (
        socket.inet_pton(socket.AF_INET, src)
        + socket.inet_pton(socket.AF_INET, dst)
        + sport.to_bytes(2, "big")
        + dport.to_bytes(2, "big")
    )
    return V2_SIG + bytes([0x21, 0x11]) + len(body).to_bytes(2, "big") + body
