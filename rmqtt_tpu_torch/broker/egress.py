"""Syscall-batched data plane: per-connection egress coalescing + the
keepalive timer wheel.

The IoT broker benchmarking study (PAPERS.md, arxiv 2603.21600) shows
per-connection syscall and timer overhead — not topic matching — dominates
broker cost at high fan-out and high connection counts. Two structures
attack exactly those costs:

``EgressBuf``
    One per plain-socket connection. Every frame ``send_raw`` would have
    written individually is appended to a vector instead, and ONE
    ``call_soon``-scheduled micro-flush per loop tick hands the whole
    vector to ``StreamWriter.writelines`` — a single vectored send — the
    per-peer flush-loop shape the intra-node fabric already proved
    (broker/fabric.py ``_deliver_flush_loop``). The deliver loop drains a
    connection's whole queue without yielding to the event loop, so a
    64-subscriber fan-out burst that used to cost one write syscall per
    frame collapses into one per connection per tick. Frames stay the
    exact bytes the codec produced (the QoS0 ``wire_cache`` bytes land in
    the vector uncopied), so coalescing is pinned zero-behavior-change at
    the protocol level: byte-identical frames, enqueue order preserved —
    acks can never reorder ahead of the PUBLISH they follow because one
    FIFO vector serves the whole connection. High-water backpressure is
    kept: past ``egress_high_water`` buffered bytes the caller flushes
    inline and awaits ``drain()``, feeding asyncio flow control (and
    through queue growth, the overload plane) exactly like the legacy
    gate. Kill-switch: ``RMQTT_EGRESS_COALESCE=0`` or ``[network]
    egress_coalesce=false`` restores byte-identical legacy per-frame
    writes; ``buffers_until_drain`` writers (WsWriter) always take the
    legacy path so their flush-on-drain contract holds.

``KeepaliveWheel``
    One hashed timer wheel per worker replacing one asyncio timer handle
    per connection. Entries are lazy: arming/re-arming on packet arrival
    costs nothing (``_read_loop`` already stamps ``_last_packet``); the
    wheel's single ticking task inspects only the slot whose deadline
    cohort is due, compares against the live ``_last_packet`` stamp, and
    either re-files the entry at its true deadline or fires the same
    CLIENT_KEEPALIVE hook → ``keepalive.timeouts`` → close sequence the
    per-connection ``_keepalive_loop`` ran. A million connections cost
    one task and one callback per tick instead of a million heap-queued
    timers.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Set

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS

#: default high-water mark, matching the legacy send_raw drain gate
DEFAULT_HIGH_WATER = 64 * 1024

_FP_EGRESS = FAILPOINTS.register("net.egress")


class EgressBuf:
    """Per-connection frame vector + once-per-tick micro-flush."""

    __slots__ = ("writer", "metrics", "high_water", "_vec", "_bytes",
                 "_scheduled", "_closed")

    def __init__(self, writer, metrics, high_water: int = DEFAULT_HIGH_WATER) -> None:
        self.writer = writer
        self.metrics = metrics
        self.high_water = high_water
        self._vec: List[bytes] = []
        self._bytes = 0
        self._scheduled = False
        self._closed = False

    @property
    def pending_bytes(self) -> int:
        return self._bytes

    def feed(self, data: bytes) -> None:
        """Append one wire frame; schedule the tick flush if none is
        pending. Must run on the event loop (send_raw holds _wlock)."""
        self._vec.append(data)
        self._bytes += len(data)
        self.metrics.inc("net.egress_frames")
        if not self._scheduled:
            self._scheduled = True
            asyncio.get_running_loop().call_soon(self.flush)

    def flush(self) -> None:
        """Hand the whole vector to the transport as ONE vectored write.
        Synchronous on purpose: run() calls it before ``writer.close()``
        so a closing connection's last frames (DISCONNECT included) still
        reach the transport buffer, which close() flushes."""
        self._scheduled = False
        if not self._vec:
            return
        vec, self._vec = self._vec, []
        n_bytes, self._bytes = self._bytes, 0
        if self._closed:
            return
        try:
            if _FP_EGRESS.action is not None:  # chaos seam (failpoints.py)
                _FP_EGRESS.fire_sync()
            if len(vec) == 1:
                self.writer.write(vec[0])
            else:
                writelines = getattr(self.writer, "writelines", None)
                if writelines is not None:
                    writelines(vec)
                else:
                    self.writer.write(b"".join(vec))
        except Exception:
            # a failed vectored write means the connection is done: close
            # the writer so the session's read loop reaps it (partial
            # frames must never be retried — the stream would desync)
            self._closed = True
            try:
                self.writer.close()
            except Exception:
                pass
            return
        self.metrics.inc("net.egress_flushes")
        self.metrics.inc("net.egress_bytes", n_bytes)
        if len(vec) > 1:
            self.metrics.inc("net.egress_coalesced", len(vec) - 1)

    def close(self) -> None:
        """Drop anything still queued and refuse further writes (the
        socket is gone; a late scheduled flush becomes a no-op)."""
        self._closed = True
        self._vec.clear()
        self._bytes = 0


class _WheelEntry:
    __slots__ = ("state", "timeout", "deadline", "slot")

    def __init__(self, state, timeout: float) -> None:
        self.state = state
        self.timeout = timeout
        self.deadline = 0.0
        self.slot: int = -1


class KeepaliveWheel:
    """Hashed timer wheel: one ticking task serves every connection.

    Entries are filed into ``slots[deadline // tick % n_slots]``; each
    tick visits one slot and only touches entries whose deadline cohort
    is due (longer timeouts simply re-file on their wheel round — the
    classic hashed-wheel rounds check, done by deadline comparison).
    Firing re-checks ``state._last_packet`` first, so a connection that
    saw traffic since it was filed is re-filed at its TRUE deadline
    without ever running a coroutine — arm/disarm on packet arrival is
    free because arrival never touches the wheel at all."""

    def __init__(self, metrics, hooks, tick: float = 1.0,
                 n_slots: int = 512) -> None:
        self.metrics = metrics
        self.hooks = hooks
        self.tick = max(0.01, float(tick))
        self.n_slots = n_slots
        self.slots: List[Set[_WheelEntry]] = [set() for _ in range(n_slots)]
        self.sessions = 0  # live armed entries (gauge)
        self.timeouts = 0  # keepalive kills fired (counter)
        self.ticks = 0
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- arming
    def _file(self, entry: _WheelEntry, deadline: float) -> None:
        entry.deadline = deadline
        entry.slot = int(deadline / self.tick) % self.n_slots
        self.slots[entry.slot].add(entry)

    def arm(self, state, timeout: float) -> _WheelEntry:
        """Register one connection; called once at session start (NOT per
        packet — packet arrival only stamps ``_last_packet``)."""
        entry = _WheelEntry(state, timeout)
        self._file(entry, time.monotonic() + timeout)
        self.sessions += 1
        return entry

    def disarm(self, entry: _WheelEntry) -> None:
        if entry.slot >= 0:
            self.slots[entry.slot].discard(entry)
            entry.slot = -1
            self.sessions -= 1

    # ------------------------------------------------------------ ticking
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="keepalive-wheel")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        cursor = int(time.monotonic() / self.tick)
        while True:
            await asyncio.sleep(self.tick)
            now = time.monotonic()
            target = int(now / self.tick)
            # visit every slot the clock crossed since the last tick (a
            # laggy loop must not skip cohorts)
            while cursor < target:
                cursor += 1
                self.ticks += 1
                self._expire_slot(cursor % self.n_slots, now)

    def _expire_slot(self, idx: int, now: float) -> None:
        slot = self.slots[idx]
        if not slot:
            return
        due = [e for e in slot if e.deadline <= now + self.tick * 0.5]
        for entry in due:
            slot.discard(entry)
            state = entry.state
            idle = now - state._last_packet
            if idle < entry.timeout:
                # saw traffic since filing: re-file at the true deadline —
                # clamped a full tick ahead, or a deadline due within the
                # half-tick early-catch window could land in the slot the
                # cursor just left and miss a whole wheel round
                self._file(entry, max(state._last_packet + entry.timeout,
                                      now + self.tick))
                continue
            entry.slot = -1
            self.sessions -= 1
            asyncio.get_running_loop().create_task(self._fire(entry, idle))

    async def _fire(self, entry: _WheelEntry, idle: float) -> None:
        """Same sequence as SessionState._keepalive_loop: the hook may
        veto the kill (plugins extend keepalive), in which case the entry
        re-arms for another full timeout."""
        state = entry.state
        proceed = await self.hooks.fire(
            HookType.CLIENT_KEEPALIVE, state.s.id, idle, initial=True
        )
        if proceed:
            self.timeouts += 1
            self.metrics.inc("keepalive.timeouts")
            state._closing.set()
        else:
            self._file(entry, time.monotonic() + entry.timeout)
            self.sessions += 1
