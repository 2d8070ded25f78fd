"""Device-plane failover: TPU routing faults degrade to the host trie.

The device router (`router/xla.py`) is one failure domain: an XLA dispatch
error, a hung kernel completion, or an OOM on a table upload used to reach
`RoutingService` as rejected publish futures — the broker had no
degraded-but-correct routing plane. This module closes that gap by wiring
two existing primitives together:

- the :class:`~rmqtt_tpu_torch.broker.overload.CircuitBreaker` wraps the device
  router: classified device failures (``dispatch_error`` / ``complete_error``
  / ``timeout`` / ``upload_error``) count toward the breaker; once it opens,
  `RoutingService` routes every batch through the **host-side trie mirror**
  the hybrid already maintains (`XlaRouter._side` — updated synchronously on
  every subscribe/unsubscribe, so the fallback table is *current*, not a
  snapshot; see README "Failure domains & failover" for the staleness
  contract).
- the full-pack upload path rewarm: a half-open probe first calls
  ``router.device_rewarm()`` (layout-epoch bump → the delta gate closes, the
  next refresh re-packs and re-uploads the WHOLE table, so delta state can't
  go stale across the outage), then runs ``k_successes`` consecutive canary
  matches through the device matcher checked against the trie oracle. All
  green → breaker closes, routing switches back; any failure → re-open with
  the breaker's exponential backoff.

A per-batch deadline (``timeout_s``) acts as the completion-queue watchdog:
a hung device (the ``device.complete = hang`` failpoint, or a real wedged
kernel) times the batch out, serves it from the host, and trips the breaker
— ``_complete_loop`` never wedges. The abandoned executor thread is
swallowed, not awaited.

Failover state surfaces everywhere overload state already does: RoutingService
``stats()`` (``routing_failover_state`` 0=device 1=host 2=probing),
Prometheus, the dashboard, ``$SYS/brokers/<n>/routing/failover``, the
slow-op ring, and ``routing.failover`` trace spans on host-routed publishes.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

from rmqtt_tpu_torch.broker.overload import CircuitBreaker
from rmqtt_tpu_torch.ops._build import kernel_fault

log = logging.getLogger("rmqtt_tpu_torch.failover")

#: failure taxonomy — every counter/metric reason comes from this set
REASONS = ("dispatch_error", "complete_error", "upload_error", "timeout",
           "canary_mismatch")


def _swallow_abandoned(fut) -> None:
    """Done-callback for executor futures a watchdog abandoned (the probe
    here, the per-batch deadline in broker/routing.py): retrieve the late
    result/exception so asyncio never logs 'exception was never retrieved'
    for a thread that finally unwedged."""
    if not fut.cancelled():
        fut.exception()


def device_verify(router, k: int = 1,
                  static_topic: str = "rmqtt/failover/canary"
                  ) -> Optional[bool]:
    """``k`` consecutive canary matches through the DEVICE matcher checked
    against the host trie oracle — the verify step shared by the failover
    plane's half-open probe and the autotuner's canary epochs
    (broker/autotune.py): both must prove "the device still answers
    CORRECTLY under the current settings" before trusting a transition.

    → True (all canaries agreed), False (mismatch or canary raised), or
    None when the router exposes no device canary entry point (trie-only
    routers; the caller decides whether that means pass or fail — the
    probe fails closed, the autotuner skips the check).

    Topics derive from live filters where possible (router.canary_topics):
    on a non-empty table a static unmatched topic would compare
    empty-vs-empty and vacuously pass a device that recovered into wrong
    answers."""
    canary = getattr(router, "device_canary", None)
    if not callable(canary):
        return None
    ct = getattr(router, "canary_topics", None)
    topics = (ct() if callable(ct) else []) or [static_topic]
    for _ in range(max(1, int(k))):
        if not canary(topics):
            return False
    return True


def classify(exc: BaseException, default: str) -> str:
    """Refine a call-site reason (dispatch/complete) by exception content:
    HBM refresh failures — a real device OOM on upload after table growth,
    or the ``device.upload`` failpoint — surface during dispatch but are a
    distinct failure domain (rewarm fixes them; a dead kernel it won't)."""
    s = str(exc)
    if ("device.upload" in s or "RESOURCE_EXHAUSTED" in s
            or "out of memory" in s.lower()):
        return "upload_error"
    return default


class DeviceFailover:
    """Failover brain shared by ``RoutingService`` and the admin surfaces.

    Hot-path contract: while the device plane is healthy the routing
    service pays ONE attribute test (``fo.active``) per dispatch plus a
    breaker reset per completed batch; all bookkeeping lives on the
    failure/probe paths."""

    DEVICE, HOST, PROBING = 0, 1, 2  # state_value() encoding

    def __init__(self, router, breaker: CircuitBreaker, *,
                 timeout_s: float = 30.0, k_successes: int = 3,
                 canary_topic: str = "rmqtt/failover/canary",
                 metrics=None, telemetry=None) -> None:
        self.router = router
        self.breaker = breaker
        self.timeout_s = float(timeout_s)
        self.k_successes = max(1, int(k_successes))
        self.canary_topic = canary_topic
        self.metrics = metrics
        self.telemetry = telemetry
        self.active = False  # True while routing via the host fallback
        self.failovers = 0  # device → host transitions
        self.switchbacks = 0  # host → device transitions
        self.host_batches = 0
        self.host_items = 0
        self.probes = 0
        self.probe_failures = 0
        self.failures: Dict[str, int] = {r: 0 for r in REASONS}
        self.state_since = time.time()
        self.last_failover_ts: Optional[float] = None
        self.last_switchback_ts: Optional[float] = None
        self._probe_task = None  # at most one probe in flight
        self._pacer_task = None  # clock-driven probe scheduler while active
        self._abandoned = 0  # probe threads wedged past the watchdog

    # ------------------------------------------------------------- queries
    @property
    def usable(self) -> bool:
        """Can the host fallback serve right now? (The Python-trie mirror
        is dropped past 200K filters — then there is nothing to route
        through and device failures stay failures.)"""
        avail = getattr(self.router, "host_available", None)
        return bool(avail()) if callable(avail) else False

    def state_value(self) -> int:
        if not self.active:
            return self.DEVICE
        return (self.PROBING if self.breaker.state == self.breaker.HALF_OPEN
                else self.HOST)

    @property
    def failure_total(self) -> int:
        return sum(self.failures.values())

    # ------------------------------------------------------------ failures
    def record_failure(self, reason: str) -> None:
        """One classified device-plane failure: reason-labeled counter +
        breaker bookkeeping; opening the breaker activates the host plane."""
        if reason not in self.failures:
            reason = "dispatch_error"
        self.failures[reason] += 1
        if self.metrics is not None:
            self.metrics.inc(f"routing.failover.failures.{reason}")
        self.breaker.fail()
        if not self.active and self.breaker.state != self.breaker.CLOSED:
            self._transition(True, reason)

    def note_device_ok(self) -> None:
        """A device batch completed fine: reset the consecutive-failure
        count (the breaker's threshold is *consecutive*, like the peers)."""
        if not self.active:
            self.breaker.ok()

    # ---------------------------------------------------------- host plane
    def note_host_batch(self, n_items: int) -> None:
        self.host_batches += 1
        self.host_items += n_items
        if self.metrics is not None:
            self.metrics.inc("routing.failover.host_routed", n_items)

    # -------------------------------------------------------------- probes
    #: max probe threads left wedged past the watchdog before probing
    #: pauses until one unwedges — a persistently hung device must not
    #: leak one default-executor worker per cooldown forever (the pool
    #: caps at min(32, cpus+4); unbounded leaks starve every other
    #: run_in_executor user in the process)
    MAX_ABANDONED_PROBES = 4

    def maybe_probe(self, loop) -> None:
        """Called per dispatch while active: once the breaker cooldown has
        elapsed, launch ONE background probe (rewarm + K canaries). The
        live traffic keeps flowing through the host path meanwhile."""
        if self._probe_task is not None or self.breaker.state == self.breaker.CLOSED:
            return
        if self._abandoned >= self.MAX_ABANDONED_PROBES:
            return  # wedged-thread budget spent: wait for one to return
        if self.breaker.remaining() > 0.0 or not self.breaker.allow():
            return  # still cooling down (allow() flips OPEN → HALF_OPEN)
        self._probe_task = loop.create_task(self._probe(loop))

    async def _pace(self, loop) -> None:
        """Clock-driven probe scheduler: dispatch-triggered probes alone
        would strand the broker on the host plane when traffic is idle or
        fully served by the match cache (cache hits never dispatch) —
        recovery must not depend on cache misses. Sleeps track the
        breaker's cooldown so this is a handful of wakeups per outage."""
        try:
            while self.active:
                self.maybe_probe(loop)
                wait = self.breaker.remaining()
                await asyncio.sleep(min(max(wait, 0.05), 0.5))
        finally:
            self._pacer_task = None

    def stop(self) -> None:
        """Cancel background probe/pacer tasks (routing-service shutdown)."""
        for t in (self._pacer_task, self._probe_task):
            if t is not None:
                t.cancel()
        self._pacer_task = self._probe_task = None

    async def _probe(self, loop) -> None:
        self.probes += 1
        try:
            # same watchdog contract as routing._device_call: a probe that
            # hangs inside the device matcher must not strand the broker in
            # PROBING forever — abandon the executor thread, count the probe
            # as failed, and let the backed-off breaker schedule the next one
            fut = loop.run_in_executor(None, self._probe_sync)
            if self.timeout_s > 0:
                done, pending = await asyncio.wait({fut}, timeout=self.timeout_s)
                if pending:
                    self._abandoned += 1

                    def _unwedged(f) -> None:
                        self._abandoned -= 1
                        _swallow_abandoned(f)

                    fut.add_done_callback(_unwedged)
                    raise TimeoutError(
                        f"probe exceeded the {self.timeout_s:.1f}s "
                        f"failover deadline")
                ok = fut.result()
            else:
                ok = await fut
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if kernel_fault(e):
                # the card's kernels themselves fail: the host plane must
                # not carry on in their place — route on the card again,
                # where each batch rejects with the kernel's error
                log.error("failover probe hit a kernel fault, routing on "
                          "the card again: %s", e)
                self.breaker.ok()
                self._transition(False, "kernel_fault")
                return
            log.warning("failover probe raised: %s", e)
            ok = False
        finally:
            self._probe_task = None
        if ok:
            self.breaker.ok()
            self._transition(False, "probe_ok")
        else:
            self.probe_failures += 1
            if self.metrics is not None:
                self.metrics.inc("routing.failover.probe_failures")
            self.breaker.fail()  # HALF_OPEN fail → re-open, backed off

    def _probe_sync(self) -> bool:
        """The probe body (executor thread): force a full HBM re-upload,
        then ``k_successes`` consecutive canary matches, device vs the trie
        oracle. Device failpoints stay armed inside — a still-injected
        fault keeps the breaker open."""
        rewarm = getattr(self.router, "device_rewarm", None)
        if callable(rewarm):
            rewarm()
        ok = device_verify(self.router, self.k_successes, self.canary_topic)
        if ok is None:
            return False  # no canary entry point: fail closed, stay on host
        if not ok:
            self.failures["canary_mismatch"] += 1
            if self.metrics is not None:
                self.metrics.inc("routing.failover.failures.canary_mismatch")
            return False
        return True

    # ---------------------------------------------------------- transitions
    def _transition(self, to_host: bool, reason: str) -> None:
        self.active = to_host
        self.state_since = time.time()
        if to_host:
            self.failovers += 1
            self.last_failover_ts = self.state_since
            if self.metrics is not None:
                self.metrics.inc("routing.failover.failovers")
            log.warning("device routing plane FAILED OVER to host trie "
                        "(reason=%s breaker=%s)", reason, self.breaker.snapshot())
            # postmortem artifact: freeze the flight recorder at the moment
            # the device plane was declared dead (broker/devprof.py) — the
            # last K dispatch records + compile registry + HBM model are
            # exactly what the cfg4/cfg5 deaths never left behind
            try:
                from rmqtt_tpu_torch.broker.devprof import DEVPROF

                DEVPROF.auto_dump("failover_trip")
            except Exception:  # pragma: no cover - dump must never block failover
                pass
            # start the clock-driven probe pacer (see _pace); transitions
            # to host always happen on the event loop (dispatch/complete
            # coroutines), so a running loop is available
            if self._pacer_task is None:
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    loop = None  # non-asyncio harness: dispatch-driven only
                if loop is not None:
                    self._pacer_task = loop.create_task(self._pace(loop))
        else:
            self.switchbacks += 1
            self.last_switchback_ts = self.state_since
            if self.metrics is not None:
                self.metrics.inc("routing.failover.switchbacks")
            log.warning("device routing plane RECOVERED (full re-upload + "
                        "%d canary matches); switching back", self.k_successes)
        # slow-ring annotation (same timeline operators read for stalls,
        # mirroring overload._transition)
        tele = self.telemetry
        if tele is not None and tele.enabled:
            tele.slow_ops.append({
                "op": "routing.failover", "ms": 0.0,
                "ts": round(self.state_since, 3),
                "detail": {"to": "host" if to_host else "device",
                           "reason": reason, "failovers": self.failovers,
                           "switchbacks": self.switchbacks},
            })

    # ------------------------------------------------------- observability
    def snapshot(self) -> dict:
        return {
            "state": ("host" if self.state_value() == self.HOST
                      else "probing" if self.state_value() == self.PROBING
                      else "device"),
            "state_value": self.state_value(),
            "state_since": round(self.state_since, 3),
            "usable": self.usable,
            "failovers": self.failovers,
            "switchbacks": self.switchbacks,
            "host_batches": self.host_batches,
            "host_routed": self.host_items,
            "probes": self.probes,
            "probe_failures": self.probe_failures,
            "failures": dict(self.failures),
            "timeout_s": self.timeout_s,
            "k_successes": self.k_successes,
            "breaker": self.breaker.snapshot(),
        }
