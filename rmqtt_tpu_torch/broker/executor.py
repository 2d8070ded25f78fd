"""Per-listener bounded handshake executor.

Mirrors the reference `HandshakeExecutor` (`rmqtt/src/executor.rs:66-137`):
each listener port gets its own execution entry with a concurrency bound
(``workers`` = the listener's max_handshaking limit) and a pending-queue
bound (``queue_max`` = max_connections); the port counts as BUSY once its
active handshakes exceed 35% of the worker bound (executor.rs:100-106
dynamic busy limit), which feeds the server-wide overload gate.

asyncio translation: a semaphore is the worker pool, bounded waiting is the
queue; a connection that cannot even queue is refused immediately. In
normal operation the server's busy gate refuses connections at the 35%
rule BEFORE the semaphore ever blocks (same as the reference, whose
frontends consult is_busy at accept) — the worker/queue bounds are the
hard backstop for paths that race the gate.
"""

from __future__ import annotations

import asyncio
from typing import Dict

BUSY_FRACTION = 0.35  # executor.rs:100: busy at 35% of the handshake limit


class ExecutorFull(Exception):
    """The listener's pending-handshake queue is at capacity."""


class ListenerExecutor:
    def __init__(self, workers: int, queue_max: int) -> None:
        self.workers = max(1, workers)
        self.queue_max = max(1, queue_max)
        self.busy_limit = max(1, int(self.workers * BUSY_FRACTION))
        self._sem = asyncio.Semaphore(self.workers)
        self.active = 0
        self.waiting = 0

    @property
    def is_busy(self) -> bool:
        return self.active >= self.busy_limit

    async def acquire(self) -> None:
        if self.waiting >= self.queue_max:
            raise ExecutorFull()
        self.waiting += 1
        try:
            await self._sem.acquire()
        finally:
            self.waiting -= 1
        self.active += 1

    def release(self) -> None:
        self.active -= 1
        self._sem.release()


class HandshakeExecutor:
    """Per-port entries, lazily created (executor.rs get())."""

    def __init__(self, workers: int, queue_max: int) -> None:
        self.workers = workers
        self.queue_max = queue_max
        self._entries: Dict[int, ListenerExecutor] = {}

    def entry(self, port: int) -> ListenerExecutor:
        e = self._entries.get(port)
        if e is None:
            e = self._entries[port] = ListenerExecutor(self.workers, self.queue_max)
        return e

    def active_count(self) -> int:
        return sum(e.active for e in self._entries.values())

    def is_busy(self) -> bool:
        return any(e.is_busy for e in self._entries.values())
