"""Bounded deliver queue with drop policies.

Mirrors `rmqtt/src/queue.rs`: the per-session message queue
between fan-out and the socket writer, bounded, with a drop ``Policy``
(:65-75) — ``DROP_CURRENT`` discards the incoming message (used for QoS0),
``DROP_EARLY`` discards the oldest queued one. An optional token-bucket rate
limit mirrors the ``Limiter``-wrapped receiver (:201-238).
"""

from __future__ import annotations

import asyncio
import enum
import time
from collections import deque
from typing import Deque, Generic, Optional, Tuple, TypeVar

T = TypeVar("T")


class Policy(enum.Enum):
    DROP_CURRENT = "current"  # drop the new message (queue.rs Policy::Current)
    DROP_EARLY = "early"  # drop the oldest queued message (Policy::Early)


class DeliverQueue(Generic[T]):
    def __init__(self, maxlen: int = 1000, rate_limit: Optional[float] = None) -> None:
        self.maxlen = maxlen
        self._q: Deque[T] = deque()
        self._event = asyncio.Event()
        self._rate_limit = rate_limit
        self._allowance = rate_limit or 0.0
        self._last = time.monotonic()

    def __len__(self) -> int:
        return len(self._q)

    def occupancy(self) -> float:
        """Queue fullness in [0, 1] (overload-controller pressure signal)."""
        return len(self._q) / self.maxlen if self.maxlen else 0.0

    def push(self, item: T, policy: Policy = Policy.DROP_EARLY) -> Optional[T]:
        """Enqueue; returns the dropped item if the queue was full."""
        dropped: Optional[T] = None
        if len(self._q) >= self.maxlen:
            if policy is Policy.DROP_CURRENT:
                return item
            dropped = self._q.popleft()
        self._q.append(item)
        self._event.set()
        return dropped

    def pop(self) -> Optional[T]:
        if not self._q:
            self._event.clear()
            return None
        return self._q.popleft()

    async def wait_nonempty(self) -> None:
        if self._q:
            return
        self._event.clear()
        await self._event.wait()

    async def throttle(self) -> None:
        """Token-bucket pacing of the consumer (queue.rs Limiter)."""
        if not self._rate_limit:
            return
        nw = time.monotonic()
        self._allowance = min(
            self._rate_limit, self._allowance + (nw - self._last) * self._rate_limit
        )
        self._last = nw
        if self._allowance < 1.0:
            await asyncio.sleep((1.0 - self._allowance) / self._rate_limit)
            # re-anchor the accrual clock AFTER the sleep: leaving _last at
            # the pre-sleep stamp double-counted the slept interval (once as
            # the token this wait earned, again as elapsed time on the next
            # call), letting the sustained rate drift to ~2x the limit
            self._last = time.monotonic()
            self._allowance = 0.0
        else:
            self._allowance -= 1.0

    def drain(self) -> Deque[T]:
        q, self._q = self._q, deque()
        self._event.clear()
        return q
