"""MQTT v5 property encode/decode.

The property table of MQTT 5.0 §2.2.2 — the reference implements this in
`rmqtt-codec/src/v5/{encode,decode}.rs`. Properties travel as
``dict[property_id, value]``; ``USER_PROPERTY`` and ``SUBSCRIPTION_IDENTIFIER``
accumulate into lists since they may repeat.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from rmqtt_tpu_torch.broker.codec.primitives import (
    ProtocolViolation,
    Reader,
    encode_binary,
    encode_utf8,
    encode_varint,
)

# property ids (MQTT-5.0 2.2.2.2)
PAYLOAD_FORMAT_INDICATOR = 0x01
MESSAGE_EXPIRY_INTERVAL = 0x02
CONTENT_TYPE = 0x03
RESPONSE_TOPIC = 0x08
CORRELATION_DATA = 0x09
SUBSCRIPTION_IDENTIFIER = 0x0B
SESSION_EXPIRY_INTERVAL = 0x11
ASSIGNED_CLIENT_IDENTIFIER = 0x12
SERVER_KEEP_ALIVE = 0x13
AUTHENTICATION_METHOD = 0x15
AUTHENTICATION_DATA = 0x16
REQUEST_PROBLEM_INFORMATION = 0x17
WILL_DELAY_INTERVAL = 0x18
REQUEST_RESPONSE_INFORMATION = 0x19
RESPONSE_INFORMATION = 0x1A
SERVER_REFERENCE = 0x1C
REASON_STRING = 0x1F
RECEIVE_MAXIMUM = 0x21
TOPIC_ALIAS_MAXIMUM = 0x22
TOPIC_ALIAS = 0x23
MAXIMUM_QOS = 0x24
RETAIN_AVAILABLE = 0x25
USER_PROPERTY = 0x26
MAXIMUM_PACKET_SIZE = 0x27
WILDCARD_SUBSCRIPTION_AVAILABLE = 0x28
SUBSCRIPTION_IDENTIFIER_AVAILABLE = 0x29
SHARED_SUBSCRIPTION_AVAILABLE = 0x2A

# property id → wire type
_U8 = "u8"
_U16 = "u16"
_U32 = "u32"
_VARINT = "varint"
_UTF8 = "utf8"
_BIN = "bin"
_PAIR = "pair"

_TYPES: Dict[int, str] = {
    PAYLOAD_FORMAT_INDICATOR: _U8,
    MESSAGE_EXPIRY_INTERVAL: _U32,
    CONTENT_TYPE: _UTF8,
    RESPONSE_TOPIC: _UTF8,
    CORRELATION_DATA: _BIN,
    SUBSCRIPTION_IDENTIFIER: _VARINT,
    SESSION_EXPIRY_INTERVAL: _U32,
    ASSIGNED_CLIENT_IDENTIFIER: _UTF8,
    SERVER_KEEP_ALIVE: _U16,
    AUTHENTICATION_METHOD: _UTF8,
    AUTHENTICATION_DATA: _BIN,
    REQUEST_PROBLEM_INFORMATION: _U8,
    WILL_DELAY_INTERVAL: _U32,
    REQUEST_RESPONSE_INFORMATION: _U8,
    RESPONSE_INFORMATION: _UTF8,
    SERVER_REFERENCE: _UTF8,
    REASON_STRING: _UTF8,
    RECEIVE_MAXIMUM: _U16,
    TOPIC_ALIAS_MAXIMUM: _U16,
    TOPIC_ALIAS: _U16,
    MAXIMUM_QOS: _U8,
    RETAIN_AVAILABLE: _U8,
    USER_PROPERTY: _PAIR,
    MAXIMUM_PACKET_SIZE: _U32,
    WILDCARD_SUBSCRIPTION_AVAILABLE: _U8,
    SUBSCRIPTION_IDENTIFIER_AVAILABLE: _U8,
    SHARED_SUBSCRIPTION_AVAILABLE: _U8,
}

# properties that may appear more than once → list-valued
_REPEATABLE = {USER_PROPERTY, SUBSCRIPTION_IDENTIFIER}


def encode_properties(props: Dict[int, object]) -> bytes:
    body = bytearray()
    for pid, value in props.items():
        ptype = _TYPES.get(pid)
        if ptype is None:
            raise ProtocolViolation(f"unknown property id {pid}")
        values = value if pid in _REPEATABLE and isinstance(value, list) else [value]
        for v in values:
            body += encode_varint(pid)
            if ptype == _U8:
                body.append(int(v) & 0xFF)
            elif ptype == _U16:
                body += int(v).to_bytes(2, "big")
            elif ptype == _U32:
                body += int(v).to_bytes(4, "big")
            elif ptype == _VARINT:
                body += encode_varint(int(v))
            elif ptype == _UTF8:
                body += encode_utf8(str(v))
            elif ptype == _BIN:
                body += encode_binary(bytes(v))
            elif ptype == _PAIR:
                k, val = v
                body += encode_utf8(str(k)) + encode_utf8(str(val))
    return bytes(encode_varint(len(body))) + bytes(body)


def decode_properties(r: Reader) -> Dict[int, object]:
    length = r.varint()
    end = r.pos + length
    props: Dict[int, object] = {}
    while r.pos < end:
        pid = r.varint()
        ptype = _TYPES.get(pid)
        if ptype is None:
            raise ProtocolViolation(f"unknown property id {pid}")
        if ptype == _U8:
            v: object = r.u8()
        elif ptype == _U16:
            v = r.u16()
        elif ptype == _U32:
            v = r.u32()
        elif ptype == _VARINT:
            v = r.varint()
        elif ptype == _UTF8:
            v = r.utf8()
        elif ptype == _BIN:
            v = r.binary()
        else:  # _PAIR
            v = (r.utf8(), r.utf8())
        if pid in _REPEATABLE:
            props.setdefault(pid, [])
            props[pid].append(v)  # type: ignore[union-attr]
        else:
            if pid in props:
                raise ProtocolViolation(f"duplicate property id {pid}")
            props[pid] = v
    if r.pos != end:
        raise ProtocolViolation("property length mismatch")
    return props
