"""MQTT frame codec: incremental decode + version-dependent encode.

Equivalent of the reference's `MqttCodec` (`rmqtt-codec/src/lib.rs:46-134`):
feed bytes in, complete `Packet`s out; encode `Packet`s per negotiated
protocol version. The CONNECT packet carries its own version (sniffed like
`rmqtt-codec/src/version.rs`); everything after uses the codec's version.
Inbound frames above ``max_inbound_size`` are rejected
(`rmqtt-codec/src/v5/codec.rs:250`).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from rmqtt_tpu_torch.broker.codec import packets as pk
from rmqtt_tpu_torch.broker.codec.packets import (
    Auth,
    Connack,
    Connect,
    Disconnect,
    Packet,
    Pingreq,
    Pingresp,
    Puback,
    Pubcomp,
    Publish,
    Pubrec,
    Pubrel,
    Suback,
    SubOpts,
    Subscribe,
    Unsuback,
    Unsubscribe,
    Will,
)
from rmqtt_tpu_torch.broker.codec.primitives import (
    ProtocolViolation as ProtocolError,
    Reader,
    encode_binary,
    encode_utf8,
    encode_varint,
)
from rmqtt_tpu_torch.broker.codec.props import decode_properties, encode_properties

_PROTO_NAMES = {b"MQIsdp": pk.V31, b"MQTT": None}  # None → level byte decides

# native frame scanner (runtime/codec.cc): None = not probed, False = absent
_native = None
# per-call crossover: below this buffered size the scan wrapper's ~10µs
# (array alloc + ctypes marshalling) outweighs the Python decode it saves.
# tests derive their chunk sizes from this so native coverage survives tuning
NATIVE_MIN_BYTES = 512


def _native_lib():
    global _native
    if _native is None:
        try:
            from rmqtt_tpu_torch import runtime as _rt

            _native = _rt.load() or False
        except Exception:
            _native = False
    return _native or None


_SCAN_ERRORS = {
    1: "malformed remaining length",
    2: "packet too large",
    3: "invalid QoS 3",
    4: "malformed PUBLISH",
    5: "malformed properties length",
}


class MqttCodec:
    """Incremental decoder + encoder for one connection."""

    def __init__(self, version: int = pk.V311, max_inbound_size: int = 1024 * 1024) -> None:
        self.version = version
        self.max_inbound_size = max_inbound_size
        self._buf = bytearray()
        # set when a frame fails to decode: earlier valid packets from the
        # same feed() are still returned; callers must check it after
        # processing them (and then close the connection)
        self.pending_error: Optional[ProtocolError] = None

    # ------------------------------------------------------------- decode
    def feed(self, data: bytes) -> List[Packet]:
        if self.pending_error is not None:
            raise self.pending_error
        self._buf += data
        out: List[Packet] = []
        # the native wrapper costs ~10µs per call (array alloc + ctypes);
        # it wins on coalesced multi-frame reads, loses on tiny interactive
        # feeds — only engage above the crossover size
        lib = _native_lib() if len(self._buf) >= NATIVE_MIN_BYTES else None
        if lib is not None and self._have_complete_frame():
            # C++ fast path: scan all complete frames at once, PUBLISH
            # pre-parsed (runtime/codec.cc). Stops at CONNECT/incomplete;
            # the Python loop below handles whatever remains. The cheap
            # completeness peek keeps large fragmented packets O(1) per
            # chunk (no buffer snapshot until a frame can actually decode).
            self._feed_native(lib, out)
            if self.pending_error is not None:
                if out:
                    return out
                raise self.pending_error
        while True:
            try:
                frame = self._next_frame()
            except ProtocolError as e:
                self.pending_error = e
                if out:
                    return out  # deliver what decoded before the bad frame
                raise
            if frame is None:
                return out
            first, body = frame
            try:
                out.append(self._decode(first, body))
            except ProtocolError as e:
                self.pending_error = e
                if out:
                    return out
                raise

    def _have_complete_frame(self) -> bool:
        """Fixed-header peek: is at least one full frame buffered? (Also
        true for frames the scan should reject — it surfaces the error.)"""
        buf = self._buf
        if len(buf) < 2:
            return False
        mult, length, i = 1, 0, 1
        while True:
            if i >= len(buf):
                return False
            b = buf[i]
            length += (b & 0x7F) * mult
            i += 1
            if not b & 0x80:
                break
            mult *= 128
            if mult > 128**3:
                return True  # malformed: let the scan report it
        return length > self.max_inbound_size or len(buf) >= i + length

    def _feed_native(self, lib, out: List[Packet]) -> None:
        from rmqtt_tpu_torch import runtime as rt

        v5 = self.version == pk.V5
        while True:
            buf = bytes(self._buf)
            rows, consumed, err, hit_cap = rt.codec_scan(lib, buf, v5, self.max_inbound_size)
            if consumed:
                del self._buf[:consumed]
            for m in rows:
                first = m[0]
                try:
                    if first >> 4 == pk.TYPE_PUBLISH:
                        out.append(self._build_publish(buf, m, v5))
                    else:
                        out.append(self._decode(first, buf[m[1] : m[1] + m[2]]))
                except ProtocolError as e:
                    self.pending_error = e
                    return
            if err:
                self.pending_error = ProtocolError(
                    _SCAN_ERRORS.get(err, f"scan error {err}"),
                    reason_code=0x95 if err == 2 else 0x81,
                )
                return
            if not hit_cap:
                return

    def _build_publish(self, buf: bytes, m, v5: bool) -> Publish:
        first = m[0]
        qos = (first >> 1) & 0x3
        try:
            topic = buf[m[3] : m[3] + m[4]].decode("utf-8")
        except UnicodeDecodeError as e:
            raise ProtocolError(f"invalid utf8: {e}") from e
        props = {}
        if v5 and m[7] > 1:  # a single byte is the zero-length varint
            props = decode_properties(Reader(buf[m[6] : m[6] + m[7]]))
        # positional: ~350ns/pkt cheaper than kwargs on the hot path
        return Publish(
            topic,
            buf[m[8] : m[8] + m[9]],
            qos,
            bool(first & 0x1),
            bool(first & 0x8),
            m[5] if m[5] >= 0 else None,
            props,
        )

    def _next_frame(self) -> Optional[Tuple[int, bytes]]:
        buf = self._buf
        if len(buf) < 2:
            return None
        # fixed header: 1 byte type/flags + varint remaining length
        mult, length, i = 1, 0, 1
        while True:
            if i >= len(buf):
                return None  # varint incomplete
            b = buf[i]
            length += (b & 0x7F) * mult
            i += 1
            if not b & 0x80:
                break
            mult *= 128
            if mult > 128**3:
                raise ProtocolError("malformed remaining length")
        if length > self.max_inbound_size:
            raise ProtocolError(
                f"packet too large: {length} > {self.max_inbound_size}",
                reason_code=0x95,
            )
        if len(buf) < i + length:
            return None
        first = buf[0]
        body = bytes(buf[i : i + length])
        del buf[: i + length]
        return first, body

    def _decode(self, first: int, body: bytes) -> Packet:
        ptype, flags = first >> 4, first & 0x0F
        r = Reader(body)
        v5 = self.version == pk.V5
        if ptype == pk.TYPE_CONNECT:
            return self._decode_connect(r)
        if ptype == pk.TYPE_CONNACK:
            session_present = bool(r.u8() & 0x01)
            reason = r.u8()
            props = decode_properties(r) if v5 else {}
            return Connack(session_present, reason, props)
        if ptype == pk.TYPE_PUBLISH:
            qos = (flags >> 1) & 0x3
            if qos == 3:
                raise ProtocolError("invalid QoS 3")
            topic = r.utf8()
            packet_id = r.u16() if qos else None
            props = decode_properties(r) if v5 else {}
            return Publish(
                topic,
                r.rest(),
                qos,
                bool(flags & 0x1),
                bool(flags & 0x8),
                packet_id,
                props,
            )
        if ptype in (pk.TYPE_PUBACK, pk.TYPE_PUBREC, pk.TYPE_PUBREL, pk.TYPE_PUBCOMP):
            if ptype == pk.TYPE_PUBREL and flags != 0x2:
                raise ProtocolError("bad PUBREL flags")
            pid = r.u16()
            reason, props = 0, {}
            if v5 and r.remaining():
                reason = r.u8()
                if r.remaining():
                    props = decode_properties(r)
            cls = {
                pk.TYPE_PUBACK: Puback,
                pk.TYPE_PUBREC: Pubrec,
                pk.TYPE_PUBREL: Pubrel,
                pk.TYPE_PUBCOMP: Pubcomp,
            }[ptype]
            return cls(pid, reason, props)
        if ptype == pk.TYPE_SUBSCRIBE:
            if flags != 0x2:
                raise ProtocolError("bad SUBSCRIBE flags")
            pid = r.u16()
            props = decode_properties(r) if v5 else {}
            filters = []
            while r.remaining():
                tf = r.utf8()
                filters.append((tf, SubOpts.decode(r.u8())))
            if not filters:
                raise ProtocolError("SUBSCRIBE with no filters")
            return Subscribe(pid, filters, props)
        if ptype == pk.TYPE_SUBACK:
            pid = r.u16()
            props = decode_properties(r) if v5 else {}
            return Suback(pid, list(r.rest()), props)
        if ptype == pk.TYPE_UNSUBSCRIBE:
            if flags != 0x2:
                raise ProtocolError("bad UNSUBSCRIBE flags")
            pid = r.u16()
            props = decode_properties(r) if v5 else {}
            filters = []
            while r.remaining():
                filters.append(r.utf8())
            if not filters:
                raise ProtocolError("UNSUBSCRIBE with no filters")
            return Unsubscribe(pid, filters, props)
        if ptype == pk.TYPE_UNSUBACK:
            pid = r.u16()
            props = decode_properties(r) if v5 else {}
            return Unsuback(pid, list(r.rest()) if v5 else [], props)
        if ptype == pk.TYPE_PINGREQ:
            return Pingreq()
        if ptype == pk.TYPE_PINGRESP:
            return Pingresp()
        if ptype == pk.TYPE_DISCONNECT:
            reason, props = 0, {}
            if v5 and r.remaining():
                reason = r.u8()
                if r.remaining():
                    props = decode_properties(r)
            return Disconnect(reason, props)
        if ptype == pk.TYPE_AUTH:
            if not v5:
                raise ProtocolError("AUTH requires MQTT 5")
            reason, props = 0, {}
            if r.remaining():
                reason = r.u8()
                if r.remaining():
                    props = decode_properties(r)
            return Auth(reason, props)
        raise ProtocolError(f"unknown packet type {ptype}")

    def _decode_connect(self, r: Reader) -> Connect:
        name = r.binary()
        level = r.u8()
        if name == b"MQIsdp" and level == 3:
            version = pk.V31
        elif name == b"MQTT" and level in (4, 5):
            version = pk.V311 if level == 4 else pk.V5
        else:
            raise ProtocolError(f"unsupported protocol {name!r} level {level}")
        self.version = version
        cflags = r.u8()
        if cflags & 0x01:
            raise ProtocolError("CONNECT reserved flag set")
        keepalive = r.u16()
        props = decode_properties(r) if version == pk.V5 else {}
        client_id = r.utf8()
        will = None
        if cflags & 0x04:
            wprops = decode_properties(r) if version == pk.V5 else {}
            wtopic = r.utf8()
            wpayload = r.binary()
            will = Will(
                topic=wtopic,
                payload=wpayload,
                qos=(cflags >> 3) & 0x3,
                retain=bool(cflags & 0x20),
                properties=wprops,
            )
            if will.qos == 3:
                raise ProtocolError("invalid will QoS")
        elif cflags & 0x38:
            raise ProtocolError("will flags without will")
        username = r.utf8() if cflags & 0x80 else None
        password = r.binary() if cflags & 0x40 else None
        return Connect(
            client_id=client_id,
            protocol=version,
            clean_start=bool(cflags & 0x02),
            keepalive=keepalive,
            username=username,
            password=password,
            will=will,
            properties=props,
        )

    # ------------------------------------------------------------- encode
    def encode(self, p: Packet) -> bytes:
        v5 = self.version == pk.V5
        if isinstance(p, Connect):
            return self._encode_connect(p)
        if isinstance(p, Connack):
            body = bytes([0x01 if p.session_present else 0x00, p.reason_code])
            if v5:
                body += encode_properties(p.properties)
            return self._frame(pk.TYPE_CONNACK, 0, body)
        if isinstance(p, Publish):
            if p.qos and p.packet_id is None:
                raise ProtocolError("QoS>0 PUBLISH needs packet_id")
            # C++ fast path (runtime/codec.cc rt_codec_encode_publish):
            # the whole frame — header byte, varint, topic, packet id,
            # props blob, payload — is assembled in one native call. Byte
            # equality with the Python arm below is property-tested; only
            # engage above the same crossover the scanner uses (the ctypes
            # marshalling costs more than small frames save)
            if len(p.payload) >= NATIVE_MIN_BYTES:
                lib = _native_lib()
                topic_b = p.topic.encode("utf-8")
                if lib is not None and len(topic_b) <= 0xFFFF:
                    from rmqtt_tpu_torch.runtime import codec_encode_publish

                    data = codec_encode_publish(
                        lib, topic_b, bytes(p.payload),
                        encode_properties(p.properties) if v5 else b"",
                        p.qos, p.retain, p.dup, p.packet_id)
                    if data is not None:
                        return data
            flags = (0x8 if p.dup else 0) | ((p.qos & 0x3) << 1) | (0x1 if p.retain else 0)
            body = bytearray(encode_utf8(p.topic))
            if p.qos:
                body += p.packet_id.to_bytes(2, "big")
            if v5:
                body += encode_properties(p.properties)
            body += p.payload
            return self._frame(pk.TYPE_PUBLISH, flags, bytes(body))
        if isinstance(p, (Puback, Pubrec, Pubrel, Pubcomp)):
            t = {
                Puback: pk.TYPE_PUBACK,
                Pubrec: pk.TYPE_PUBREC,
                Pubrel: pk.TYPE_PUBREL,
                Pubcomp: pk.TYPE_PUBCOMP,
            }[type(p)]
            flags = 0x2 if t == pk.TYPE_PUBREL else 0
            body = bytearray(p.packet_id.to_bytes(2, "big"))
            if v5 and (p.reason_code or p.properties):
                body.append(p.reason_code)
                if p.properties:
                    body += encode_properties(p.properties)
            return self._frame(t, flags, bytes(body))
        if isinstance(p, Subscribe):
            body = bytearray(p.packet_id.to_bytes(2, "big"))
            if v5:
                body += encode_properties(p.properties)
            for tf, opts in p.filters:
                body += encode_utf8(tf)
                body.append(opts.encode() if v5 else opts.qos & 0x3)
            return self._frame(pk.TYPE_SUBSCRIBE, 0x2, bytes(body))
        if isinstance(p, Suback):
            body = bytearray(p.packet_id.to_bytes(2, "big"))
            if v5:
                body += encode_properties(p.properties)
            body += bytes(p.reason_codes)
            return self._frame(pk.TYPE_SUBACK, 0, bytes(body))
        if isinstance(p, Unsubscribe):
            body = bytearray(p.packet_id.to_bytes(2, "big"))
            if v5:
                body += encode_properties(p.properties)
            for tf in p.filters:
                body += encode_utf8(tf)
            return self._frame(pk.TYPE_UNSUBSCRIBE, 0x2, bytes(body))
        if isinstance(p, Unsuback):
            body = bytearray(p.packet_id.to_bytes(2, "big"))
            if v5:
                body += encode_properties(p.properties)
                body += bytes(p.reason_codes)
            return self._frame(pk.TYPE_UNSUBACK, 0, bytes(body))
        if isinstance(p, Pingreq):
            return self._frame(pk.TYPE_PINGREQ, 0, b"")
        if isinstance(p, Pingresp):
            return self._frame(pk.TYPE_PINGRESP, 0, b"")
        if isinstance(p, Disconnect):
            body = b""
            if v5 and (p.reason_code or p.properties):
                body = bytes([p.reason_code]) + (
                    encode_properties(p.properties) if p.properties else b""
                )
            return self._frame(pk.TYPE_DISCONNECT, 0, body)
        if isinstance(p, Auth):
            body = b""
            if p.reason_code or p.properties:
                body = bytes([p.reason_code]) + encode_properties(p.properties)
            return self._frame(pk.TYPE_AUTH, 0, body)
        raise ProtocolError(f"cannot encode {type(p).__name__}")

    def _encode_connect(self, p: Connect) -> bytes:
        # mirror _decode_connect: the negotiated version governs all
        # subsequent packets on this codec (client-side use)
        self.version = p.protocol
        v5 = p.protocol == pk.V5
        if p.protocol == pk.V31:
            head = encode_binary(b"MQIsdp") + bytes([3])
        else:
            head = encode_binary(b"MQTT") + bytes([4 if p.protocol == pk.V311 else 5])
        cflags = 0
        if p.clean_start:
            cflags |= 0x02
        if p.will:
            cflags |= 0x04 | ((p.will.qos & 0x3) << 3) | (0x20 if p.will.retain else 0)
        if p.username is not None:
            cflags |= 0x80
        if p.password is not None:
            cflags |= 0x40
        body = bytearray(head)
        body.append(cflags)
        body += p.keepalive.to_bytes(2, "big")
        if v5:
            body += encode_properties(p.properties)
        body += encode_utf8(p.client_id)
        if p.will:
            if v5:
                body += encode_properties(p.will.properties)
            body += encode_utf8(p.will.topic)
            body += encode_binary(p.will.payload)
        if p.username is not None:
            body += encode_utf8(p.username)
        if p.password is not None:
            body += encode_binary(p.password)
        return self._frame(pk.TYPE_CONNECT, 0, bytes(body))

    def _frame(self, ptype: int, flags: int, body: bytes) -> bytes:
        return bytes([(ptype << 4) | flags]) + encode_varint(len(body)) + body
