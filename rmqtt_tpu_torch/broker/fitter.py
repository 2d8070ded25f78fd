"""Per-connection negotiated limits.

Mirrors the reference ``Fitter`` (`rmqtt/src/fitter.rs`):
keepalive clamping with backoff factor (:127-163), max message-queue length
(:166), max inflight window min'd with the client's v5 Receive-Maximum
(:176-188), session expiry from v5 properties capped by server config
(:191-215), message expiry cap (:218-226), and topic-alias maxima (:229-244).
"""

from __future__ import annotations

from dataclasses import dataclass

from rmqtt_tpu_torch.broker.codec import packets as pk, props as P
from rmqtt_tpu_torch.broker.types import ConnectInfo


@dataclass
class Limits:
    keepalive: int
    server_keepalive: bool  # True if the server overrode the client's value
    max_inflight: int
    max_mqueue: int
    session_expiry: float
    max_message_expiry: float
    max_topic_aliases_in: int
    max_topic_aliases_out: int
    max_packet_size: int


@dataclass
class FitterConfig:
    max_keepalive: int = 0  # 0 = no clamp
    min_keepalive: int = 0
    keepalive_backoff: float = 0.75  # timeout factor: keepalive * backoff * 2
    max_inflight: int = 16
    max_mqueue: int = 1000
    max_session_expiry: float = 2 * 3600.0
    default_session_expiry: float = 2 * 3600.0  # for v3 clean_session=0
    max_message_expiry: float = 5 * 60.0
    max_topic_aliases: int = 32
    max_packet_size: int = 1024 * 1024


class Fitter:
    def __init__(self, cfg: FitterConfig) -> None:
        self.cfg = cfg

    def fit(self, ci: ConnectInfo) -> Limits:
        cfg = self.cfg
        keepalive = ci.keepalive
        server_keepalive = False
        if cfg.max_keepalive and keepalive > cfg.max_keepalive:
            keepalive, server_keepalive = cfg.max_keepalive, True
        if cfg.min_keepalive and 0 < keepalive < cfg.min_keepalive:
            keepalive, server_keepalive = cfg.min_keepalive, True

        recv_max = ci.properties.get(P.RECEIVE_MAXIMUM)
        max_inflight = cfg.max_inflight
        if recv_max:
            max_inflight = min(max_inflight, int(recv_max)) or 1

        if ci.protocol == pk.V5:
            expiry = float(ci.properties.get(P.SESSION_EXPIRY_INTERVAL, 0))
            if expiry == 0xFFFFFFFF:
                expiry = cfg.max_session_expiry
            session_expiry = min(expiry, cfg.max_session_expiry)
        else:
            session_expiry = 0.0 if ci.clean_start else cfg.default_session_expiry

        alias_out = int(ci.properties.get(P.TOPIC_ALIAS_MAXIMUM, 0))
        return Limits(
            keepalive=keepalive,
            server_keepalive=server_keepalive,
            max_inflight=max_inflight,
            max_mqueue=cfg.max_mqueue,
            session_expiry=session_expiry,
            max_message_expiry=cfg.max_message_expiry,
            max_topic_aliases_in=cfg.max_topic_aliases if ci.protocol == pk.V5 else 0,
            max_topic_aliases_out=min(alias_out, cfg.max_topic_aliases),
            max_packet_size=cfg.max_packet_size,
        )

    def keepalive_timeout(self, keepalive: int) -> float:
        """Socket-idle deadline, always > keepalive (fitter.rs:158-163:
        small keepalives get +3s slack, otherwise keepalive * backoff * 2 —
        1.5x with the default backoff of 0.75)."""
        if keepalive == 0:
            return 0.0
        if keepalive < 6:
            return float(keepalive + 3)
        return keepalive * self.cfg.keepalive_backoff * 2
