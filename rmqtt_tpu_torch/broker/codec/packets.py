"""Version-unified MQTT packet model.

One dataclass per control packet, shared across v3.1/v3.1.1/v5 — the
reference's ``MqttPacket`` unification (`rmqtt-codec/src/lib.rs:60-67`,
v3 `src/v3/packet.rs:126`, v5 `src/v5/packet/mod.rs:29`). v5-only fields
(properties, reason codes) are simply empty/zero under v3.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

# protocol levels (CONNECT byte 7/8): 3 = MQTT 3.1, 4 = MQTT 3.1.1, 5 = MQTT 5.0
V31, V311, V5 = 3, 4, 5

Properties = Dict[int, object]  # property id → value ([(k,v)...] for user props)


@dataclass
class Will:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    properties: Properties = field(default_factory=dict)


@dataclass
class Connect:
    client_id: str = ""
    protocol: int = V311
    clean_start: bool = True
    keepalive: int = 60
    username: Optional[str] = None
    password: Optional[bytes] = None
    will: Optional[Will] = None
    properties: Properties = field(default_factory=dict)


@dataclass
class Connack:
    session_present: bool = False
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


# slots=True on the per-message hot classes: ~30% cheaper construction and
# no per-instance __dict__ (the broker creates one Publish per inbound
# message and one per delivery); subclasses declare empty __slots__ so they
# don't silently grow a __dict__ back
@dataclass(slots=True)
class Publish:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None
    properties: Properties = field(default_factory=dict)


@dataclass(slots=True)
class _Ack:
    packet_id: int
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


class Puback(_Ack):
    __slots__ = ()


class Pubrec(_Ack):
    __slots__ = ()


class Pubrel(_Ack):
    __slots__ = ()


class Pubcomp(_Ack):
    __slots__ = ()


@dataclass
class SubOpts:
    """SUBSCRIBE per-filter options byte (v5 3.8.3.1; v3: qos only)."""

    qos: int = 0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0

    def encode(self) -> int:
        return (
            (self.qos & 0x3)
            | (0x04 if self.no_local else 0)
            | (0x08 if self.retain_as_published else 0)
            | ((self.retain_handling & 0x3) << 4)
        )

    @classmethod
    def decode(cls, b: int) -> "SubOpts":
        return cls(
            qos=b & 0x3,
            no_local=bool(b & 0x04),
            retain_as_published=bool(b & 0x08),
            retain_handling=(b >> 4) & 0x3,
        )


@dataclass
class Subscribe:
    packet_id: int
    filters: List[Tuple[str, SubOpts]] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Suback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Unsubscribe:
    packet_id: int
    filters: List[str] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Unsuback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)


@dataclass
class Pingreq:
    pass


@dataclass
class Pingresp:
    pass


@dataclass
class Disconnect:
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class Auth:
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


Packet = Union[
    Connect,
    Connack,
    Publish,
    Puback,
    Pubrec,
    Pubrel,
    Pubcomp,
    Subscribe,
    Suback,
    Unsubscribe,
    Unsuback,
    Pingreq,
    Pingresp,
    Disconnect,
    Auth,
]

# control packet type ids (MQTT spec 2.1.2)
TYPE_CONNECT = 1
TYPE_CONNACK = 2
TYPE_PUBLISH = 3
TYPE_PUBACK = 4
TYPE_PUBREC = 5
TYPE_PUBREL = 6
TYPE_PUBCOMP = 7
TYPE_SUBSCRIBE = 8
TYPE_SUBACK = 9
TYPE_UNSUBSCRIBE = 10
TYPE_UNSUBACK = 11
TYPE_PINGREQ = 12
TYPE_PINGRESP = 13
TYPE_DISCONNECT = 14
TYPE_AUTH = 15
