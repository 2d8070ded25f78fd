"""Delayed publish: the ``$delayed/<secs>/<topic>`` scheme.

Mirrors `rmqtt/src/delayed.rs`: parse (:151-167), a bounded
min-heap of pending publishes drained by a background task (:103-129) that
re-injects them into the normal forward path when due; overflow is refused
(cap ``mqtt_delayed_publish_max``, context.rs:140).
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import Awaitable, Callable, List, Optional, Tuple

from rmqtt_tpu_torch.broker.types import Message

PREFIX = "$delayed/"


def parse_delayed(topic: str) -> Tuple[Optional[int], str]:
    """``$delayed/5/a/b`` → ``(5, "a/b")``; non-delayed topics pass through."""
    if not topic.startswith(PREFIX):
        return None, topic
    rest = topic[len(PREFIX) :]
    idx = rest.find("/")
    if idx <= 0:
        raise ValueError(f"malformed $delayed topic: {topic!r}")
    try:
        secs = int(rest[:idx])
    except ValueError as e:
        raise ValueError(f"malformed $delayed interval in {topic!r}") from e
    target = rest[idx + 1 :]
    if not target or secs < 0:
        raise ValueError(f"malformed $delayed topic: {topic!r}")
    return secs, target


class DelayedSender:
    """Heap of pending delayed publishes + drain task (delayed.rs:103-129)."""

    def __init__(
        self,
        forward: Callable[[Message], Awaitable[None]],
        max_pending: int = 100_000,
    ) -> None:
        self._forward = forward
        self.max_pending = max_pending
        self._heap: List[Tuple[float, int, Message, int]] = []
        self._seq = itertools.count()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        # durability seam (broker/durability.py): called as on_fired(did)
        # AFTER a journaled entry's forward completes, resolving its
        # durable record (a crash in between replays the fire — the
        # delayed path is at-least-once across kill -9, like QoS1)
        self.on_fired: Optional[Callable[[int], None]] = None

    def __len__(self) -> int:
        return len(self._heap)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def push(self, delay_secs: float, msg: Message, did: int = 0) -> bool:
        """Schedule; False if the pending cap is hit (message dropped).
        ``did`` is the durable journal id riding a journaled entry (0 =
        not journaled); it feeds ``on_fired`` after delivery."""
        if len(self._heap) >= self.max_pending:
            return False
        heapq.heappush(
            self._heap,
            (time.monotonic() + delay_secs, next(self._seq), msg, did))
        self._wake.set()
        return True

    async def _run(self) -> None:
        while True:
            if not self._heap:
                self._wake.clear()
                await self._wake.wait()
            due, _, msg, did = self._heap[0]
            delay = due - time.monotonic()
            if delay > 0:
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=delay)
                    self._wake.clear()
                    continue  # new earlier item may have arrived
                except asyncio.TimeoutError:
                    pass
            heapq.heappop(self._heap)
            if not msg.is_expired():
                await self._forward(msg)
            if did and self.on_fired is not None:
                # resolve the durable record only after the forward (whose
                # own enq records precede this in the journal) completed
                self.on_fired(did)
