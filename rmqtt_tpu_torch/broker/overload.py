"""Overload-control subsystem: the layer between telemetry and the data plane.

the telemetry *observes* pressure (queue wait, batch size, e2e latency);
this module *reacts* to it. The reference broker's only protections are the
handshake busy gate (`executor.rs:100-137`, `node.rs:212-239`) and the
per-session drop policy (`queue.rs:65-75`); everything broker-wide here is
new surface grown on those seams. Three planes, driven by one watermark
state machine:

``OverloadController``
    Samples cheap pressure signals — routing-queue fraction, aggregate
    deliver-queue occupancy, in-flight-window saturation, process RSS,
    connect rate — into ``NORMAL → ELEVATED → CRITICAL`` states with
    hysteresis (escalate immediately at a high watermark; de-escalate only
    after ``hold`` consecutive samples below ``clear_ratio`` × watermark, so
    a signal hovering at the boundary cannot flap the state).

admission control
    ``TokenBucket`` gates per listener (CONNECT) and per client id
    (PUBLISH). Refusals carry proper MQTT reason codes — v5 ``Quota
    exceeded`` (0x97) on CONNACK/PUBACK/PUBREC, v3 CONNACK 0x03 or a
    disconnect — instead of silent drops. The handshake busy gate stays the
    first tier (it refuses before reading any bytes); these buckets are the
    second.

degradation tiers
    ELEVATED sheds QoS0 to slow consumers (queue past
    ``shed_slow_fraction``), pauses retained-scan fan-out and periodic
    ``$SYS`` publishing, and shrinks the router batch window. CRITICAL
    refuses new CONNECTs and non-essential plugin work while QoS1/2 acks
    keep flowing. Every shed is reason-labeled in metrics and stamped onto
    the publish's trace, so a trace shows *why* a message never arrived.

``CircuitBreaker``
    Shared closed/open/half-open breaker with exponential backoff and
    jitter (the reference wraps its gRPC clients in a tower breaker,
    `grpc.rs:318`; `context.rs:585-677` carries the config). Wrapped around
    cluster transport sends (`cluster/transport.py`) and the
    kafka/pulsar/nats/mqtt bridge producers, so a dead peer or sink fails
    fast instead of eating event-loop time per queued item.

With ``[overload] enable = false`` (the default) the controller never
starts, every admission check is a single attribute test, and no behavior
changes — pinned by tests/test_overload.py.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from rmqtt_tpu_torch.utils.sysmon import rss_mb

log = logging.getLogger("rmqtt_tpu_torch.overload")


class OverloadState(enum.IntEnum):
    NORMAL = 0
    ELEVATED = 1
    CRITICAL = 2


# ---------------------------------------------------------------- admission
class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``allow(n)`` is exact against the real-valued oracle (no integer
    quantization, no sleep): tokens accrue continuously from the injectable
    monotonic ``clock``, so unit tests drive it deterministically."""

    __slots__ = ("rate", "burst", "tokens", "_last", "_clock")

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = float(rate)
        # the default burst floors at one whole token: burst = rate alone
        # would make a fractional rate (e.g. 0.5/s) cap below the 1.0 cost
        # of allow() and refuse EVERYTHING forever
        self.burst = float(burst) if burst else max(float(rate), 1.0)
        self.tokens = self.burst
        self._clock = clock
        self._last = clock()

    def allow(self, n: float = 1.0) -> bool:
        now = self._clock()
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


# ---------------------------------------------------------- circuit breaker
class CircuitBreaker:
    """Closed / open / half-open breaker with exponential backoff + jitter.

    - CLOSED: calls flow; ``threshold`` consecutive failures → OPEN.
    - OPEN: calls are rejected (``allow() is False``) until the current
      cooldown elapses, then the next ``allow()`` transitions to HALF_OPEN
      and admits probes. Rejected-while-open attempts never re-arm the
      cooldown (a fast retry loop — e.g. raft heartbeats — must not be able
      to hold the breaker open forever).
    - HALF_OPEN: probes are admitted; one success closes the breaker and
      resets the backoff, one failure re-opens it with the cooldown
      multiplied by ``backoff`` (capped at ``max_cooldown``) plus up to
      ``jitter`` fractional randomization, so a fleet of breakers to one
      dead sink doesn't probe in lockstep.

    ``clock``/``rng`` are injectable for deterministic tests."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    __slots__ = ("threshold", "cooldown", "max_cooldown", "backoff", "jitter",
                 "state", "failures", "opened_at", "opens", "rejected",
                 "_cooldown_cur", "_clock", "_rng")

    def __init__(self, threshold: int = 5, cooldown: float = 3.0,
                 max_cooldown: float = 30.0, backoff: float = 2.0,
                 jitter: float = 0.1,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None) -> None:
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self.max_cooldown = max(float(max_cooldown), float(cooldown))
        self.backoff = float(backoff)
        self.jitter = float(jitter)
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.opens = 0  # lifetime CLOSED/HALF_OPEN → OPEN transitions
        self.rejected = 0  # calls refused while open
        self._cooldown_cur = self.cooldown
        self._clock = clock
        self._rng = rng if rng is not None else random

    def allow(self) -> bool:
        """May a call proceed right now? (OPEN → HALF_OPEN on cooldown.)"""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if self._clock() - self.opened_at >= self._cooldown_cur:
                self.state = self.HALF_OPEN
                return True
            self.rejected += 1
            return False
        return True  # HALF_OPEN: probes flow

    def remaining(self) -> float:
        """Seconds until the next probe would be admitted (0 if now)."""
        if self.state != self.OPEN:
            return 0.0
        return max(0.0, self._cooldown_cur - (self._clock() - self.opened_at))

    async def wait_ready(self) -> None:
        """Park until a call may proceed — the drain-pump form of the gate.
        Sleeps on ``remaining()`` and only calls ``allow()`` once the window
        is due, so the ``rejected`` counter keeps meaning *refused calls*,
        not wait-loop poll iterations."""
        while True:
            wait = self.remaining()
            if wait <= 0.0 and self.allow():
                return
            await asyncio.sleep(min(max(wait, 0.05), 1.0))

    def ok(self) -> None:
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = None
        self._cooldown_cur = self.cooldown

    def fail(self) -> None:
        if self.state == self.OPEN:
            # a failure observed while already open (e.g. an in-flight call
            # that started pre-open): never re-arms the cooldown
            return
        if self.state == self.HALF_OPEN:
            # the probe failed: back off exponentially, re-open
            self._cooldown_cur = min(
                self.max_cooldown, self._cooldown_cur * self.backoff
            ) * (1.0 + self.jitter * self._rng.random())
            self._open()
            return
        self.failures += 1
        if self.failures >= self.threshold:
            self._cooldown_cur = self.cooldown * (
                1.0 + self.jitter * self._rng.random())
            self._open()

    def _open(self) -> None:
        self.state = self.OPEN
        self.opened_at = self._clock()
        self.opens += 1
        self.failures = 0

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "opens": self.opens,
            "rejected": self.rejected,
            "cooldown_s": round(self._cooldown_cur, 3),
            "retry_in_s": round(self.remaining(), 3),
        }


def backoff_delays(attempts: int, base: float = 0.05, cap: float = 1.0,
                   factor: float = 2.0, jitter: float = 0.1,
                   rng: Optional[random.Random] = None):
    """The breaker's cooldown discipline as a reusable schedule: yields
    ``attempts - 1`` sleep durations (the first try is immediate), each
    ``min(cap, base * factor**i)`` plus up to ``jitter`` randomization so
    a herd of retriers against one busy resource doesn't probe in
    lockstep. Bounded by construction — exhausting the generator is the
    caller's signal to give up and surface the error."""
    r = rng if rng is not None else random
    d = float(base)
    for _ in range(max(0, int(attempts) - 1)):
        yield min(float(cap), d) * (1.0 + float(jitter) * r.random())
        d *= float(factor)


# ------------------------------------------------------ watermark machine
@dataclass
class Watermark:
    """One pressure signal's thresholds; 0 disables that edge."""

    name: str
    elevated: float = 0.0
    critical: float = 0.0

    def level(self, value: float, scale: float = 1.0) -> int:
        lvl = 0
        if self.elevated and value >= self.elevated * scale:
            lvl = 1
        if self.critical and value >= self.critical * scale:
            lvl = 2
        return lvl


class WatermarkMachine:
    """Signals → state with hysteresis.

    Escalation is immediate: the worst signal's full-threshold level wins.
    De-escalation is sticky: the state only drops once every signal has
    stayed below ``clear_ratio`` × its threshold for ``hold`` consecutive
    samples — a signal oscillating exactly at a watermark therefore pins
    the state instead of flapping it (the no-flap acceptance test)."""

    def __init__(self, watermarks: List[Watermark], clear_ratio: float = 0.85,
                 hold: int = 2) -> None:
        self.watermarks = {w.name: w for w in watermarks}
        self.clear_ratio = min(1.0, max(0.0, clear_ratio))
        self.hold = max(1, int(hold))
        self.state = OverloadState.NORMAL
        self.trigger: Optional[str] = None  # which signal drove the state
        self._below = 0

    def update(self, values: Dict[str, float]) -> OverloadState:
        raw = clear = 0
        raw_trig = clear_trig = None
        for name, w in self.watermarks.items():
            v = values.get(name)
            if v is None:
                continue
            lvl = w.level(v)
            if lvl > raw:
                raw, raw_trig = lvl, name
            c = w.level(v, self.clear_ratio)
            if c > clear:
                clear, clear_trig = c, name
        if raw > self.state:
            self.state = OverloadState(raw)
            self.trigger = raw_trig
            self._below = 0
        elif clear < self.state:
            self._below += 1
            if self._below >= self.hold:
                self.state = OverloadState(clear)
                self.trigger = clear_trig if self.state else None
                self._below = 0
        else:
            self._below = 0
        return self.state


# ------------------------------------------------------------- controller
class OverloadController:
    """Broker-wide overload brain: sampling loop + the three planes.

    Constructed unconditionally on every ``ServerContext`` so the data-plane
    guards are a single attribute test; with ``enable = false`` nothing is
    sampled, admitted differently, shed, paused, or shrunk."""

    def __init__(self, ctx, cfg) -> None:
        self.ctx = ctx
        self.enabled = bool(cfg.overload_enable)
        self.sample_interval = max(0.01, float(cfg.overload_sample_interval))
        self.machine = WatermarkMachine(
            [
                Watermark("routing_queue", cfg.overload_queue_elevated,
                          cfg.overload_queue_critical),
                Watermark("mqueue", cfg.overload_mqueue_elevated,
                          cfg.overload_mqueue_critical),
                Watermark("inflight", cfg.overload_inflight_elevated,
                          cfg.overload_inflight_critical),
                Watermark("rss_mb", cfg.overload_rss_elevated_mb,
                          cfg.overload_rss_critical_mb),
                Watermark("connect_rate", cfg.overload_connect_rate_elevated,
                          cfg.overload_connect_rate_critical),
            ],
            clear_ratio=cfg.overload_clear_ratio,
            hold=cfg.overload_hold,
        )
        self.connect_rate_limit = float(cfg.overload_connect_rate_limit)
        self.connect_burst = float(cfg.overload_connect_burst) or None
        self.publish_rate_limit = float(cfg.overload_publish_rate_limit)
        self.publish_burst = float(cfg.overload_publish_burst) or None
        self.shed_slow_fraction = float(cfg.overload_shed_slow_fraction)
        self.batch_shrink = max(1, int(cfg.overload_batch_shrink))
        self.breaker_defaults = dict(
            threshold=int(cfg.overload_breaker_threshold),
            cooldown=float(cfg.overload_breaker_cooldown),
            max_cooldown=float(cfg.overload_breaker_max_cooldown),
        )
        self._connect_buckets: Dict[int, TokenBucket] = {}
        self._publish_buckets: Dict[str, TokenBucket] = {}
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.transitions = 0
        self.state_since = time.time()
        self.last_signals: Dict[str, float] = {}
        self.connect_refused = 0
        self.publish_refused = 0
        self.retained_paused = 0
        self.sys_paused = 0
        self._task: Optional[asyncio.Task] = None
        self._orig_batch: Optional[int] = None

    # --------------------------------------------------------------- state
    @property
    def state(self) -> OverloadState:
        return self.machine.state

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self.enabled and self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.sample_interval)
            try:
                self.tick()
            except Exception:  # a sampling bug must not kill the controller
                log.exception("overload sample failed")

    # ------------------------------------------------------------- sampling
    def sample(self) -> Dict[str, float]:
        """One cheap pass over the pressure signals (all O(sessions) work
        in a single loop; everything else is attribute reads)."""
        ctx = self.ctx
        mq_len = mq_cap = infl_len = infl_cap = 0
        for s in ctx.registry.sessions():
            mq_len += len(s.deliver_queue)
            mq_cap += s.deliver_queue.maxlen
            infl_len += len(s.out_inflight)
            infl_cap += s.limits.max_inflight
        sig = {
            "routing_queue": ctx.routing.queue_fraction(),
            "mqueue": mq_len / mq_cap if mq_cap else 0.0,
            "inflight": infl_len / infl_cap if infl_cap else 0.0,
            "rss_mb": rss_mb(),
            "connect_rate": ctx.handshake_rate.rate(),
        }
        self.last_signals = {k: round(v, 4) for k, v in sig.items()}
        return sig

    def tick(self) -> OverloadState:
        """Sample + state update + tier application (test entry point)."""
        old = self.machine.state
        new = self.machine.update(self.sample())
        if new != old:
            self._transition(old, new)
        # prune publish buckets that have refilled to full (idle at least
        # burst/rate seconds): a full bucket admits everything, so dropping
        # it loses no state — without this, a churn of unique client ids
        # would grow the dict unboundedly. The stored `tokens` is stale
        # (updated only on allow()), so project the refill to NOW.
        if len(self._publish_buckets) > 10_000:
            now = time.monotonic()
            self._publish_buckets = {
                cid: b for cid, b in self._publish_buckets.items()
                if b.tokens + (now - b._last) * b.rate < b.burst
            }
        return new

    def _transition(self, old: OverloadState, new: OverloadState) -> None:
        ctx = self.ctx
        self.transitions += 1
        self.state_since = time.time()
        ctx.metrics.inc("overload.transitions")
        # batch-window shrink at ELEVATED+ (restore at NORMAL): a smaller
        # dispatch quantum keeps the routing loop yielding to deliver loops
        if new >= OverloadState.ELEVATED and self._orig_batch is None:
            self._orig_batch = ctx.routing.max_batch
            ctx.routing.max_batch = max(1, self._orig_batch // self.batch_shrink)
        elif new == OverloadState.NORMAL and self._orig_batch is not None:
            ctx.routing.max_batch = self._orig_batch
            self._orig_batch = None
        trigger = self.machine.trigger
        log.warning("overload state %s -> %s (trigger=%s signals=%s)",
                    old.name, new.name, trigger, self.last_signals)
        # slow-ring annotation: the state change lands on the same timeline
        # operators read for stalls, tying "publishes got shed here" to why
        tele = getattr(ctx, "telemetry", None)
        if tele is not None and tele.enabled:
            tele.slow_ops.append({
                "op": "overload.state", "ms": 0.0, "ts": round(time.time(), 3),
                "detail": {"from": old.name, "to": new.name,
                           "trigger": trigger, "signals": self.last_signals},
            })
        # a CRITICAL escalation freezes the host-plane flight recorder
        # (broker/hostprof.py): whether the pressure is host-made (GC,
        # a wedged loop) or genuine load is the first triage question
        if new >= OverloadState.CRITICAL:
            from rmqtt_tpu_torch.broker.hostprof import HOSTPROF

            if HOSTPROF.enabled:
                HOSTPROF.auto_dump("overload_critical")
        snapshot = self.snapshot()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # tick() driven synchronously in tests: no hook task
        from rmqtt_tpu_torch.broker.hooks import HookType

        loop.create_task(
            ctx.hooks.fire(HookType.SERVER_OVERLOAD, old.name, new.name, snapshot)
        )

    # ------------------------------------------------------------ admission
    def admit_connect(self, listener_port: int) -> bool:
        """Second-tier CONNECT admission (the busy gate already ran).
        CRITICAL refuses everything; otherwise the per-listener bucket."""
        if not self.enabled:
            return True
        if self.machine.state >= OverloadState.CRITICAL:
            self.connect_refused += 1
            self.ctx.metrics.inc("overload.connect_refused")
            return False
        if self.connect_rate_limit:
            b = self._connect_buckets.get(listener_port)
            if b is None:
                b = self._connect_buckets[listener_port] = TokenBucket(
                    self.connect_rate_limit, self.connect_burst)
            if not b.allow():
                self.connect_refused += 1
                self.ctx.metrics.inc("overload.connect_refused")
                return False
        return True

    def admit_publish(self, client_id: str) -> bool:
        """Per-client PUBLISH admission; the caller answers with the proper
        reason code (v5 0x97 / v3 disconnect)."""
        if not self.enabled or not self.publish_rate_limit:
            return True
        b = self._publish_buckets.get(client_id)
        if b is None:
            b = self._publish_buckets[client_id] = TokenBucket(
                self.publish_rate_limit, self.publish_burst)
        if b.allow():
            return True
        self.publish_refused += 1
        return False

    # ------------------------------------------------------------- shedding
    def should_shed_qos0(self, queue) -> bool:
        """ELEVATED sheds QoS0 fan-out to slow consumers (a ``DeliverQueue``
        past the occupancy fraction); CRITICAL sheds QoS0 to every consumer
        with any backlog."""
        if not self.enabled:
            return False
        state = self.machine.state
        if state < OverloadState.ELEVATED:
            return False
        if state >= OverloadState.CRITICAL:
            return len(queue) > 0
        return queue.occupancy() >= self.shed_slow_fraction

    def allow_retained_scan(self) -> bool:
        if self.enabled and self.machine.state >= OverloadState.ELEVATED:
            self.retained_paused += 1
            return False
        return True

    def allow_sys(self) -> bool:
        """Periodic $SYS publishing pauses at ELEVATED (fan-out work the
        broker can defer); the overload topics themselves still publish."""
        if self.enabled and self.machine.state >= OverloadState.ELEVATED:
            self.sys_paused += 1
            return False
        return True

    def allow_noncritical(self) -> bool:
        """Non-essential plugin work (bridge egress, web hooks) at CRITICAL."""
        return not (self.enabled and
                    self.machine.state >= OverloadState.CRITICAL)

    # ------------------------------------------------------ circuit breakers
    def breaker(self, name: str, **overrides) -> CircuitBreaker:
        """A named breaker from the shared registry (created on first use
        with the [overload] defaults), so every wrapped egress shows up in
        /api/v1/overload and $SYS regardless of which plugin made it."""
        b = self.breakers.get(name)
        if b is None:
            kw = dict(self.breaker_defaults)
            kw.update(overrides)
            b = self.breakers[name] = CircuitBreaker(**kw)
        return b

    def register_breaker(self, name: str, breaker: CircuitBreaker) -> CircuitBreaker:
        self.breakers[name] = breaker
        return breaker

    # ----------------------------------------------------------- observability
    def snapshot(self) -> dict:
        m = self.ctx.metrics
        return {
            "enabled": self.enabled,
            "state": self.machine.state.name,
            "state_value": int(self.machine.state),
            "state_since": round(self.state_since, 3),
            "trigger": self.machine.trigger,
            "transitions": self.transitions,
            "signals": dict(self.last_signals),
            "watermarks": {
                name: {"elevated": w.elevated, "critical": w.critical}
                for name, w in self.machine.watermarks.items()
            },
            "clear_ratio": self.machine.clear_ratio,
            "admission": {
                "connect_rate_limit": self.connect_rate_limit,
                "publish_rate_limit": self.publish_rate_limit,
                "connect_refused": self.connect_refused,
                "publish_refused": self.publish_refused,
            },
            "shed": {
                "qos0": m.get("messages.dropped.shed_qos0"),
                "rate_limited": m.get("messages.dropped.rate_limited"),
                "circuit_open": m.get("messages.dropped.circuit_open"),
                "retained_scans_paused": self.retained_paused,
                "sys_publishes_paused": self.sys_paused,
            },
            "breakers": {name: b.snapshot() for name, b in self.breakers.items()},
        }
