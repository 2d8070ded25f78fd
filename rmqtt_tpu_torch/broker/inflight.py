"""QoS in-flight windows and packet-id allocation.

Mirrors `rmqtt/src/inflight.rs`: ``OutInflight`` is the
ordered window of unacked outbound QoS1/2 messages with retry/expiry
timestamps, credit gating (:319 ``has_credit``) and packet-id allocation
(:324); ``InInflight`` deduplicates received QoS2 publishes until PUBREL.
"""

from __future__ import annotations

import asyncio
import enum
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from rmqtt_tpu_torch.broker.types import Message


class MomentStatus(enum.Enum):
    """Delivery stage of an outbound QoS message (inflight.rs:80)."""

    UNACK = "unack"  # QoS1: waiting PUBACK / QoS2: waiting PUBREC
    UNRECEIVED = "unreceived"  # QoS2 alias of UNACK stage
    UNCOMPLETE = "uncomplete"  # QoS2: PUBREL sent, waiting PUBCOMP


@dataclass
class OutEntry:
    packet_id: int
    msg: Message
    qos: int
    status: MomentStatus = MomentStatus.UNACK
    sent_at: float = field(default_factory=time.monotonic)
    retries: int = 0
    subscription_ids: tuple = ()
    # wire fields of the original delivery, so a DUP retransmission matches
    # it (retain-as-published flag, v5 content/correlation/sub-id props)
    retain: bool = False
    wire_props: dict = field(default_factory=dict)
    # trace of the publish this delivery belongs to (broker/tracing.py):
    # the PUBACK/PUBCOMP arrives in the read loop, a different task from
    # the fan-out, so the context must travel with the inflight entry
    trace: object = None
    # durable pending id (broker/durability.py DeliverItem.did): the ack
    # journals against it; 0 = this delivery is not journaled
    did: int = 0


class OutInflight:
    """Outbound QoS1/2 window (ordered, credit-gated)."""

    def __init__(self, max_inflight: int = 16, retry_interval: float = 20.0,
                 max_retries: int = 3) -> None:
        self.max_inflight = max_inflight
        self.retry_interval = retry_interval
        self.max_retries = max_retries
        self._entries: "OrderedDict[int, OutEntry]" = OrderedDict()
        self._next_pid = 1
        # event-driven credit: a 10ms sleep-poll in the deliver loop capped
        # per-session QoS1/2 delivery at ~max_inflight/10ms (measured 1.6K
        # msg/s at the default window of 16)
        self._credit_ev = asyncio.Event()
        self._credit_ev.set()
        # event-driven retry wake: an idle session's retry loop must BLOCK
        # until something is actually in flight — a 20s sleep-poll per
        # session is ~12.5K timer wakeups/s at 250K held connections, which
        # saturates the core doing nothing (the ramp-rate collapse measured
        # in the round-5 scale soaks)
        self._nonempty_ev = asyncio.Event()

    def has_credit(self) -> bool:
        return len(self._entries) < self.max_inflight

    async def wait_credit(self) -> None:
        await self._credit_ev.wait()

    async def wait_nonempty(self) -> None:
        """Block until the window holds at least one entry."""
        if not self._entries:
            await self._nonempty_ev.wait()

    def _update_credit(self) -> None:
        if self.has_credit():
            self._credit_ev.set()
        else:
            self._credit_ev.clear()
        if self._entries:
            self._nonempty_ev.set()
        else:
            self._nonempty_ev.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def alloc_packet_id(self) -> Optional[int]:
        """Next free id in 1..65535 (inflight.rs:324)."""
        for _ in range(65535):
            pid = self._next_pid
            self._next_pid = pid % 65535 + 1
            if pid not in self._entries:
                return pid
        return None

    def push(self, entry: OutEntry) -> None:
        self._entries[entry.packet_id] = entry
        self._update_credit()

    def get(self, packet_id: int) -> Optional[OutEntry]:
        return self._entries.get(packet_id)

    def ack(self, packet_id: int) -> Optional[OutEntry]:
        """PUBACK (QoS1) or PUBCOMP (QoS2 final): remove from window."""
        e = self._entries.pop(packet_id, None)
        self._update_credit()
        return e

    def pubrec(self, packet_id: int) -> Optional[OutEntry]:
        """QoS2 PUBREC: advance to UNCOMPLETE (awaiting PUBCOMP)."""
        e = self._entries.get(packet_id)
        if e is not None:
            e.status = MomentStatus.UNCOMPLETE
            e.sent_at = time.monotonic()
            e.retries = 0
            # keep the dict ordered by sent_at so next_retry_in() can look at
            # the head only
            self._entries.move_to_end(packet_id)
        return e

    def next_retry_in(self) -> Optional[float]:
        """Seconds until the oldest entry needs retrying (inflight.rs:206)."""
        if not self._entries:
            return None
        oldest = next(iter(self._entries.values()))
        return max(0.0, oldest.sent_at + self.retry_interval - time.monotonic())

    def entries(self) -> List[OutEntry]:
        """Snapshot of the current window (offline-inflight hook/persist)."""
        return list(self._entries.values())

    def due(self) -> Iterator[OutEntry]:
        """Entries past their retry deadline (inflight.rs:257)."""
        deadline = time.monotonic() - self.retry_interval
        for e in list(self._entries.values()):
            if e.sent_at <= deadline:
                yield e

    def mark_retry(self, e: OutEntry) -> bool:
        """Bump retry state; False if retries exhausted (drop it)."""
        e.retries += 1
        e.sent_at = time.monotonic()
        if e.retries > self.max_retries:
            self._entries.pop(e.packet_id, None)
            self._update_credit()
            return False
        if e.packet_id in self._entries:
            self._entries.move_to_end(e.packet_id)  # keep sent_at ordering
        return True

    def drain(self) -> Iterator[OutEntry]:
        """Take everything (session takeover transfer, session.rs:1374-1427)."""
        entries = list(self._entries.values())
        self._entries.clear()
        self._update_credit()
        return iter(entries)


class InInflight:
    """Received-QoS2 dedup set (inflight.rs ``InInflight``)."""

    def __init__(self, max_size: int = 65535) -> None:
        self.max_size = max_size
        self._ids: set[int] = set()

    def __len__(self) -> int:
        return len(self._ids)

    def add(self, packet_id: int) -> bool:
        """False if the window is full. Callers must check ``packet_id in
        self`` first for the duplicate case (which needs a PUBREC reply,
        while a full window needs RC_RECEIVE_MAX_EXCEEDED)."""
        if packet_id in self._ids or len(self._ids) >= self.max_size:
            return False
        self._ids.add(packet_id)
        return True

    def __contains__(self, packet_id: int) -> bool:
        return packet_id in self._ids

    def remove(self, packet_id: int) -> bool:
        try:
            self._ids.remove(packet_id)
            return True
        except KeyError:
            return False
