"""Counter / RateCounter (reference rmqtt-utils equivalents)."""

from __future__ import annotations

import enum
import time
from collections import deque
from typing import Deque, Tuple


class StatsMergeMode(enum.Enum):
    """How a gauge merges across cluster nodes (counter.rs StatsMergeMode)."""

    NONE = "none"
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    AVG = "avg"


class Counter:
    """(current, max) pair; max tracks the high-water mark (counter.rs:39)."""

    __slots__ = ("current", "max")

    def __init__(self, current: int = 0, max_: int = 0) -> None:
        self.current = current
        self.max = max(max_, current)

    def inc(self, n: int = 1) -> int:
        self.current += n
        if self.current > self.max:
            self.max = self.current
        return self.current

    def dec(self, n: int = 1) -> int:
        self.current -= n
        return self.current

    def sets(self, v: int) -> None:
        self.current = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Counter", mode: StatsMergeMode) -> "Counter":
        """Cluster merge (counter.rs merge modes)."""
        if mode is StatsMergeMode.SUM:
            return Counter(self.current + other.current, self.max + other.max)
        if mode is StatsMergeMode.MAX:
            return Counter(max(self.current, other.current), max(self.max, other.max))
        if mode is StatsMergeMode.MIN:
            return Counter(min(self.current, other.current), min(self.max, other.max))
        if mode is StatsMergeMode.AVG:
            return Counter((self.current + other.current) // 2, (self.max + other.max) // 2)
        return Counter(self.current, self.max)

    def to_json(self) -> dict:
        return {"count": self.current, "max": self.max}


class RateCounter:
    """Sliding-window events/sec (rate_counter.rs)."""

    def __init__(self, window: float = 5.0) -> None:
        self.window = window
        self._events: Deque[Tuple[float, int]] = deque()
        self._total = 0

    def inc(self, n: int = 1) -> None:
        self._trim()  # keep the window bounded even if rate() is never read
        self._events.append((time.monotonic(), n))
        self._total += n

    def _trim(self) -> None:
        cutoff = time.monotonic() - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self) -> float:
        self._trim()
        return sum(n for _, n in self._events) / self.window

    def total(self) -> int:
        return self._total
