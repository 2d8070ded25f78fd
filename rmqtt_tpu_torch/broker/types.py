"""Broker data types: the routed message, connect info, reason codes.

Mirrors the reference's DTO layer (`rmqtt/src/types.rs`):
``Publish`` wrapper with create-time / expiry / p2p target / delay-interval,
``ConnectInfo``, and the v5 reason codes used by the broker paths.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from rmqtt_tpu_torch.broker.codec import packets as pk
from rmqtt_tpu_torch.broker.codec import props as P
from rmqtt_tpu_torch.router.base import Id


def now() -> float:
    return time.time()


@dataclass(frozen=True, slots=True)
class Message:
    """A publish in flight through the broker (reference types.rs `Publish`)."""

    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    properties: Dict[int, object] = field(default_factory=dict)
    create_time: float = field(default_factory=now)
    expiry_interval: Optional[float] = None  # seconds (v5 message expiry)
    from_id: Optional[Id] = None
    target_clientid: Optional[str] = None  # p2p short-circuit (types.rs)
    delay_interval: Optional[int] = None  # $delayed publishes
    # id assigned by the message store when persisted (reference msg_id,
    # message.rs:71); travels with ForwardsTo so receiving nodes can ack
    # delivery for mark-forwarded bookkeeping (shared.rs:596-613)
    stored_id: Optional[int] = None

    def is_expired(self, at: Optional[float] = None) -> bool:
        if self.expiry_interval is None:
            return False
        return (at or now()) >= self.create_time + self.expiry_interval

    def remaining_expiry(self, at: Optional[float] = None) -> Optional[int]:
        """Seconds left, for forwarding the v5 message-expiry property."""
        if self.expiry_interval is None:
            return None
        left = self.create_time + self.expiry_interval - (at or now())
        return max(0, int(left))

    @classmethod
    def from_publish(
        cls,
        p: pk.Publish,
        from_id: Optional[Id] = None,
        topic: Optional[str] = None,
        delay_interval: Optional[float] = None,
        expiry_cap: float = 0.0,
    ) -> "Message":
        """``topic`` overrides the wire topic ($delayed stripped),
        ``expiry_cap`` > 0 clamps the expiry — taking these here avoids
        per-publish dataclasses.replace churn on the hot ingress path."""
        expiry = p.properties.get(P.MESSAGE_EXPIRY_INTERVAL)
        expiry = float(expiry) if expiry is not None else None
        if expiry_cap > 0 and (expiry is None or expiry > expiry_cap):
            expiry = expiry_cap
        return cls(
            topic=p.topic if topic is None else topic,
            payload=p.payload,
            qos=p.qos,
            retain=p.retain,
            properties={k: v for k, v in p.properties.items() if k != P.TOPIC_ALIAS},
            expiry_interval=expiry,
            delay_interval=delay_interval,
            from_id=from_id,
        )


@dataclass
class CertInfo:
    """TLS client-certificate metadata surfaced into ConnectInfo
    (reference rmqtt-net/src/cert_extractor.rs + rmqtt-codec CertInfo)."""

    common_name: Optional[str] = None
    subject: Optional[str] = None
    serial: Optional[str] = None
    organization: Optional[str] = None


@dataclass
class ConnectInfo:
    """Who connected and how (reference types.rs ConnectInfo V3/V5)."""

    id: Id
    protocol: int
    keepalive: int
    clean_start: bool
    username: Optional[str] = None
    password: Optional[bytes] = None
    properties: Dict[int, object] = field(default_factory=dict)
    remote_addr: Optional[Tuple[str, int]] = None
    will: Optional[pk.Will] = None
    cert_info: Optional[CertInfo] = None


# --- v5 reason codes used by broker paths (MQTT-5.0 2.4) ---
class HandshakeLockedError(Exception):
    """Another node holds the distributed handshake lock for this client id
    (raft mode, reference cluster-raft/src/shared.rs:71-106)."""


RC_SUCCESS = 0x00
RC_NORMAL_DISCONNECT = 0x00
RC_GRANTED_QOS0 = 0x00
RC_GRANTED_QOS1 = 0x01
RC_GRANTED_QOS2 = 0x02
RC_DISCONNECT_WITH_WILL = 0x04
RC_NO_MATCHING_SUBSCRIBERS = 0x10
RC_UNSPECIFIED_ERROR = 0x80
RC_MALFORMED_PACKET = 0x81
RC_PROTOCOL_ERROR = 0x82
RC_IMPL_SPECIFIC_ERROR = 0x83
RC_UNSUPPORTED_PROTOCOL_VERSION = 0x84
RC_CLIENT_ID_NOT_VALID = 0x85
RC_BAD_USERNAME_PASSWORD = 0x86
RC_NOT_AUTHORIZED = 0x87
RC_SERVER_UNAVAILABLE = 0x88
RC_SERVER_BUSY = 0x89
RC_BANNED = 0x8A
RC_SESSION_TAKEN_OVER = 0x8E
RC_TOPIC_FILTER_INVALID = 0x8F
RC_TOPIC_NAME_INVALID = 0x90
RC_PACKET_ID_IN_USE = 0x91
RC_PACKET_ID_NOT_FOUND = 0x92
RC_RECEIVE_MAX_EXCEEDED = 0x93
RC_TOPIC_ALIAS_INVALID = 0x94
RC_PACKET_TOO_LARGE = 0x95
RC_QUOTA_EXCEEDED = 0x97
RC_PAYLOAD_FORMAT_INVALID = 0x99
RC_RETAIN_NOT_SUPPORTED = 0x9A
RC_QOS_NOT_SUPPORTED = 0x9B
RC_SHARED_SUB_NOT_SUPPORTED = 0x9E
RC_KEEPALIVE_TIMEOUT = 0x8D
RC_SUB_ID_NOT_SUPPORTED = 0xA1
RC_WILDCARD_SUB_NOT_SUPPORTED = 0xA2

# v3 CONNACK return codes (MQTT-3.1.1 3.2.2.3)
V3_ACCEPTED = 0
V3_UNACCEPTABLE_PROTOCOL = 1
V3_IDENTIFIER_REJECTED = 2
V3_SERVER_UNAVAILABLE = 3
V3_BAD_USERNAME_PASSWORD = 4
V3_NOT_AUTHORIZED = 5
