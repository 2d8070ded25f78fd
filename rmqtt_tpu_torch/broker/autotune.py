"""Device-plane autotuner: devprof rollups → live kernel-knob selection.

Every performance-critical knob the kernel PRs grew — sticky pad floor,
batch window, fused/pallas on-off, the delta-upload gate — shipped as a
static env-flag/TOML matrix a human re-derives per workload (the cfg1
small-batch 0.06x cliff in BENCH_LAST_TPU.json is exactly a mistuned pad
floor). This module closes the loop the ROADMAP item-1 follow-on names:
a controller that consumes the signals the flight recorders already
emit per interval — devprof rollups (pad-waste fraction, dispatch
p50/p99, batch-size histogram, retrace counts, fused/fallback share,
delta-vs-full upload bytes; ``DeviceProfiler.rollup_summary``) plus the
routing batcher's own telemetry (batch-size EMA, queue fraction) — and
adapts the live knobs through the :class:`~rmqtt_tpu_torch.broker.knobs.KnobRegistry`
seam under a small, deliberately conservative policy:

**hysteresis-guarded hill-climbing, one knob at a time**
    A rule must re-propose the SAME move on ``confirm_ticks`` consecutive
    ticks before anything is touched (a boundary signal oscillating
    around a threshold proposes forever and applies never), trigger and
    release thresholds are separated bands, a move that would invert a
    recent commit is suppressed, and at most one knob is ever in flight.

**canary epochs** (failover's half-open probe discipline)
    Every change starts as a canary: ``canary_k`` dispatches must
    complete under the new setting. The canary rolls back instantly —
    value AND provenance restored — on a p99 regression past
    ``p99_guard`` x the pre-change baseline, a retrace storm, excess
    fresh compiles, or a device-vs-trie canary mismatch (the
    ``device_verify`` helper shared with broker/failover.py). A rolled-
    back knob enters a cooldown before the policy may touch it again.

**journal everything**
    Every phase transition (canary / commit / rollback / abort / hold)
    lands on a bounded ring with before/after window metrics, on the
    telemetry slow-op ring (the timeline operators already read), and on
    the reason-labeled metrics counters.

Exploration PAUSES outright while retraces are storming — a storm means
the shape discipline broke down and any measurement taken inside one is
noise.

Surfaces follow the house pattern: ``[routing] autotune*`` conf knobs,
``/api/v1/autotune`` (+ ``/sum`` via a ``what=autotune`` DATA query),
``rmqtt_autotune_*`` exposition, ``$SYS/brokers/<n>/autotune``,
dashboard cards, ``autotune_*`` stats gauges, and the offline fitter
``scripts/autotune_replay.py`` (seed knobs from recorded devprof dumps /
bench artifacts so a TPU window starts pre-tuned).

``enabled=False`` (the default) is pinned to zero behavior change: no
task starts, ``tick()`` returns on its first branch, no knob is ever
written (every registry row keeps its default/env/conf source) and the
snapshot surfaces stay shape-stable.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

log = logging.getLogger("rmqtt_tpu_torch.autotune")

#: knobs whose change can alter DEVICE results/shape discipline: their
#: canary commit additionally requires a device-vs-trie oracle verify
DEVICE_KNOBS = frozenset(
    {"pad_floor", "fused", "pallas", "delta_uploads", "packed"})

#: batch-wait ladder (ms) for the micro-batch window rule
LINGER_LADDER = (0.0, 0.5, 1.0, 2.0)

PAD_FLOOR_MAX = 64  # ladder cap: past this, padding cost dwarfs compiles


def _ladder_step(ladder: Tuple[float, ...], value: float, up: bool
                 ) -> Optional[float]:
    """Nearest ladder notch above/below ``value`` (None at the rail)."""
    if up:
        for v in ladder:
            if v > value:
                return v
        return None
    for v in reversed(ladder):
        if v < value:
            return v
    return None


class AutotuneService:
    """The closed-loop controller. Constructed unconditionally (like the
    overload controller) so every surface exists shape-stable; with
    ``enabled=False`` it owns no task and never writes a knob."""

    IDLE, CANARY, HOLD = 0, 1, 2  # state_value() encoding

    def __init__(
        self,
        registry,
        *,
        enabled: bool = False,
        interval_s: float = 5.0,
        canary_k: int = 8,
        cooldown_s: float = 30.0,
        # the rollup p99 is a log2-bucket UPPER bound (exact to one
        # bucket), so adjacent-bucket moves read as exactly 2x: a guard
        # of 2.0 tolerates one-bucket quantization noise and rolls back
        # from two buckets (a real 4x) up
        p99_guard: float = 2.0,
        confirm_ticks: int = 2,
        journal_max: int = 256,
        routing=None,
        router=None,
        telemetry=None,
        metrics=None,
        devprof=None,
        node_id: int = 1,
    ) -> None:
        self.registry = registry
        self.enabled = bool(enabled)
        self.interval_s = max(0.1, float(interval_s))
        self.canary_k = max(1, int(canary_k))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.p99_guard = max(1.0, float(p99_guard))
        self.confirm_ticks = max(1, int(confirm_ticks))
        self.routing = routing
        self.router = router
        self.telemetry = telemetry
        self.metrics = metrics
        if devprof is None:
            from rmqtt_tpu_torch.broker.devprof import DEVPROF as devprof
        self.devprof = devprof
        self.node_id = node_id
        # --- policy thresholds (bands; up- and down-triggers never meet)
        self.pad_waste_high = 0.5   # floor-down trigger
        self.trace_up = 3           # window traces that trigger floor-up
        self.min_dispatches = 4     # evidence floor per tick window
        self.linger_up_ema = 2.0    # batch EMA below which linger helps
        self.linger_down_ema = 16.0  # batch EMA above which linger is moot
        self.linger_up_rate = 50    # window dispatches before linger moves
        self.canary_trace_budget = 4  # fresh compiles a canary tolerates
        self.canary_max_ticks = 6   # ticks before a dispatch-starved abort
        # boot grace: the first ticks observe prewarm/startup compiles and
        # a floor that hasn't latched yet — acting on them tunes the
        # bootstrap, not the workload
        self.warmup_ticks = 2
        # --- state
        self.decisions = 0   # canary epochs started (knob writes)
        self.commits = 0
        self.rollbacks = 0
        self.aborts = 0
        self.holds = 0
        self.journal: deque = deque(maxlen=max(8, int(journal_max)))
        self._seq = 0
        self._canary: Optional[dict] = None
        self._pending: Optional[Tuple[str, Any, str]] = None
        self._pending_ticks = 0
        self._cooldown_until: Dict[str, float] = {}
        self._last_commit: Dict[str, Tuple[Any, Any, float]] = {}
        self._hold_until = 0.0
        self._ticks = 0
        self._last_tick_t: Optional[float] = None
        # counter baselines prime from the profiler's CURRENT totals:
        # storms/traces that predate this controller (an earlier bench
        # leg, a warmup pass) are history, not a reason to hold
        self._last = {"traces": getattr(self.devprof, "traces", 0),
                      "storms": getattr(self.devprof, "storms", 0),
                      "dispatches": getattr(self.devprof, "dispatches", 0)}
        self._task: Optional[asyncio.Task] = None
        self._lock = threading.Lock()  # ticks are serialized

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start the controller task; a no-op while disabled (the pinned
        zero-behavior-change contract: no task, no timestamps)."""
        if not self.enabled or self._task is not None:
            return
        self._task = asyncio.get_running_loop().create_task(
            self._loop(), name="autotune")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.interval_s)
            # executor hop: the tick reads profiler locks and a canary
            # commit may run a device-vs-trie verify (a real device match)
            # — neither belongs on the event loop
            await loop.run_in_executor(None, self.tick)

    # ------------------------------------------------------------- signals
    def _signals(self) -> dict:
        """One tick's observation window: devprof rollups since the last
        tick + cumulative counters + routing batcher telemetry. Pure read
        — the policy and the canary evaluator both consume this dict, and
        tests inject synthetic ones through ``tick(sig=...)``."""
        dp = self.devprof
        win = dp.rollup_summary(since=self._last_tick_t) \
            if self._last_tick_t is not None else dp.rollup_summary(n=1)
        uc = dp.upload_counts
        ub = dp.upload_bytes
        sig = {
            "dispatches_total": dp.dispatches,
            "traces_total": dp.traces,
            "storms_total": dp.storms,
            "dispatches": win["dispatches"],
            "pad_waste": win["pad_waste"],
            "traces": win["traces"],
            # warm (no-fresh-compile) p99 ONLY: the ladder's legitimate
            # shape compile must not read as a latency regression (the
            # trace budget bounds compile count), and a window holding
            # nothing BUT compile dispatches carries no steady-state
            # evidence at all — report 0 so the canary guard skips it
            # rather than judging compile cost against the baseline
            "p99_ms": (win["warm_p99_ms"] if win.get("warm_dispatches")
                       else 0.0),
            "batch_p50": win["batch_p50"],
            "batch_p99": win["batch_p99"],
            "delta_avg_bytes": (ub.get("delta", 0) / uc["delta"]
                                if uc.get("delta") else 0.0),
            "full_avg_bytes": (ub.get("full", 0) / uc["full"]
                               if uc.get("full") else 0.0),
            "batch_ema": (self.routing.batch_size_ema
                          if self.routing is not None else 0.0),
            "queue_frac": (self.routing.queue_fraction()
                           if self.routing is not None else 0.0),
        }
        return sig

    # -------------------------------------------------------------- policy
    def propose(self, sig: dict) -> Optional[Tuple[str, Any, str]]:
        """One rule pass over a tick's signals → ``(knob, new_value,
        reason)`` or None. Pure (no writes, no clocks) so the policy is
        unit-testable as an oracle; rule order IS the priority order and
        the first match wins — one knob at a time by construction."""
        if sig.get("dispatches", 0) < self.min_dispatches:
            return None  # not enough evidence in this window
        reg = self.registry
        cand = None
        # --- sticky pad floor ladder (the cfg1 cliff knob)
        if cand is None and "pad_floor" in reg:
            floor = int(reg.value("pad_floor"))
            # batch_p99 is a log2 bucket's EXCLUSIVE upper bound: real
            # batches sit strictly below it, so p99 <= floor means the
            # floor pads every observed batch
            if (floor > 1 and sig["pad_waste"] >= self.pad_waste_high
                    and 0 < sig["batch_p99"] <= floor):
                cand = ("pad_floor", floor // 2, "pad_waste")
            elif (floor < PAD_FLOOR_MAX and sig["traces"] >= self.trace_up
                    and sig["pad_waste"] < self.pad_waste_high
                    and 2 * floor < sig["batch_p99"] <= 2 * PAD_FLOOR_MAX):
                # distinct small BATCH shapes are compiling AND padding
                # isn't already the problem: raise the floor so they
                # collapse onto one executable. Two guards keep this
                # honest: the pad-waste band keeps it disjoint from the
                # down-rule, and `batch_p99 > 2*floor` requires a batch
                # from a bucket strictly ABOVE the floor's own — the
                # floor's bucket [floor, 2*floor) is dominated by batches
                # the floor already covers, and compiles from other
                # causes (candidate-count drift under churn, table
                # re-layout) can't be fixed by padding and must not walk
                # the floor up
                cand = ("pad_floor", min(PAD_FLOOR_MAX, max(2, floor * 2)),
                        "retrace")
        # --- micro-batch window (batch-wait ladder)
        if cand is None and "linger_ms" in reg:
            linger = float(reg.value("linger_ms"))
            if (sig["batch_ema"] and sig["batch_ema"] <= self.linger_up_ema
                    and sig["dispatches"] >= self.linger_up_rate):
                nxt = _ladder_step(LINGER_LADDER, linger, up=True)
                if nxt is not None:
                    cand = ("linger_ms", nxt, "micro_batch")
            elif sig["batch_ema"] >= self.linger_down_ema and linger > 0:
                nxt = _ladder_step(LINGER_LADDER, linger, up=False)
                if nxt is not None:
                    cand = ("linger_ms", nxt, "batch_formed")
        # --- delta-upload gate (churn regime where scatter costs more
        # than the repack it replaces)
        if cand is None and "delta_uploads" in reg:
            if (bool(reg.value("delta_uploads"))
                    and sig["delta_avg_bytes"] and sig["full_avg_bytes"]
                    and sig["delta_avg_bytes"] > sig["full_avg_bytes"]):
                cand = ("delta_uploads", False, "delta_gate")
        return cand

    # ---------------------------------------------------------------- tick
    def tick(self, sig: Optional[dict] = None) -> None:
        """One controller step (synchronous — the async loop hops here via
        an executor; tests and the bench drive it directly). Evaluates an
        in-flight canary first, then considers one new move."""
        if not self.enabled:
            return
        with self._lock:
            now = time.monotonic()
            if sig is None:
                sig = self._signals()
            self._last_tick_t = time.time()
            self._ticks += 1
            storms_new = sig["storms_total"] - self._last["storms"]
            self._last = {"traces": sig["traces_total"],
                          "storms": sig["storms_total"],
                          "dispatches": sig["dispatches_total"]}
            if self._canary is not None:
                self._canary_tick(sig, storms_new, now)
                return
            if self._ticks <= self.warmup_ticks:
                # boot grace: observe only (no canary can be in flight
                # yet, and startup compile bursts are not workload signal)
                self._pending = None
                return
            if storms_new > 0 and now >= self._hold_until:
                # a storm outside any canary: measurements inside it are
                # noise — hold all exploration for a cooldown
                self._hold_until = now + max(self.cooldown_s, self.interval_s)
                self.holds += 1
                self._journal("hold", None, None, None, "retrace_storm", sig)
                self._pending = None
                return
            if now < self._hold_until:
                self._pending = None
                return
            cand = self.propose(sig)
            if cand is None or not self._admissible(cand, now):
                self._pending = None
                return
            # hysteresis: the same move must persist confirm_ticks ticks
            if self._pending == cand:
                self._pending_ticks += 1
            else:
                self._pending = cand
                self._pending_ticks = 1
            if self._pending_ticks < self.confirm_ticks:
                return
            self._pending = None
            self._start_canary(cand, sig, now)

    def _admissible(self, cand: Tuple[str, Any, str], now: float) -> bool:
        knob, new, _reason = cand
        if now < self._cooldown_until.get(knob, 0.0):
            return False
        last = self._last_commit.get(knob)
        if last is not None:
            frm, to, t = last
            # anti-flap: don't invert a commit that just landed — the
            # signal that justified it needs time to clear
            if new == frm and now - t < 4 * max(self.cooldown_s,
                                                self.interval_s):
                return False
        return True

    # -------------------------------------------------------------- canary
    def _start_canary(self, cand: Tuple[str, Any, str], sig: dict,
                      now: float) -> None:
        knob, new, reason = cand
        try:
            # provenance is captured NOW, not at construction: rolling
            # back onto a value an earlier canary committed must restore
            # 'autotune', not relabel it default/env
            pre_source = self.registry.source(knob)
            old = self.registry.set(knob, new, source="autotune")
        except (KeyError, ValueError) as e:
            log.warning("autotune could not apply %s=%r: %s", knob, new, e)
            return
        self.decisions += 1
        self._canary = {
            "knob": knob, "from": old, "to": new, "reason": reason,
            "t0_mono": now, "ticks": 0, "dispatches_seen": 0,
            "traces_seen": 0, "worst_p99_ms": 0.0,
            "baseline_p99_ms": sig.get("p99_ms", 0.0),
            "start_dispatches": sig["dispatches_total"],
            # cumulative anchors: window values would double-count the
            # rollup bucket both ticks overlap
            "start_traces": sig["traces_total"],
            "old_source": pre_source,
        }
        self._journal("canary", knob, old, new, reason, sig)
        log.info("autotune CANARY %s: %r -> %r (%s; %d dispatches to "
                 "verify)", knob, old, new, reason, self.canary_k)

    def _canary_tick(self, sig: dict, storms_new: int, now: float) -> None:
        c = self._canary
        c["ticks"] += 1
        c["dispatches_seen"] = (sig["dispatches_total"]
                                - c["start_dispatches"])
        c["traces_seen"] = sig["traces_total"] - c["start_traces"]
        if sig.get("p99_ms", 0.0) > c["worst_p99_ms"]:
            c["worst_p99_ms"] = sig["p99_ms"]
        if storms_new > 0:
            self._rollback(c, "retrace_storm", sig, now)
            return
        if c["traces_seen"] > self.canary_trace_budget:
            self._rollback(c, "trace_churn", sig, now)
            return
        if c["dispatches_seen"] < self.canary_k:
            if c["ticks"] >= self.canary_max_ticks:
                self._abort(c, sig, now)
            return
        base = c["baseline_p99_ms"]
        if base > 0 and c["worst_p99_ms"] > base * self.p99_guard:
            self._rollback(c, "p99_regression", sig, now)
            return
        if c["knob"] in DEVICE_KNOBS:
            ok = self._verify()
            if ok is False:
                self._rollback(c, "canary_mismatch", sig, now)
                return
        self._commit(c, sig, now)

    def _verify(self) -> Optional[bool]:
        """Device-vs-trie oracle check for device-affecting knobs — the
        verify half shared with the failover probe. None (router exposes
        no canary) means 'nothing to check', which is a pass here: the
        p99/storm gates already ran."""
        if self.router is None:
            return None
        from rmqtt_tpu_torch.broker.failover import device_verify

        try:
            return device_verify(self.router, k=1)
        except Exception as e:  # a canary crash is a failed canary
            log.warning("autotune canary verify raised: %s", e)
            return False

    def _commit(self, c: dict, sig: dict, now: float) -> None:
        self._canary = None
        self.commits += 1
        self._last_commit[c["knob"]] = (c["from"], c["to"], now)
        self._journal("commit", c["knob"], c["from"], c["to"], c["reason"],
                      sig, canary=c)
        log.info("autotune COMMIT %s: %r -> %r (%s; p99 %.3f vs baseline "
                 "%.3f ms over %d dispatches)", c["knob"], c["from"],
                 c["to"], c["reason"], c["worst_p99_ms"],
                 c["baseline_p99_ms"], c["dispatches_seen"])

    def _rollback(self, c: dict, why: str, sig: dict, now: float) -> None:
        self._canary = None
        self.rollbacks += 1
        try:
            self.registry.restore(c["knob"], c["from"], c["old_source"])
        except KeyError:  # pragma: no cover - registry rebuilt mid-canary
            pass
        self._cooldown_until[c["knob"]] = now + self.cooldown_s
        if self.metrics is not None:
            self.metrics.inc(f"autotune.rollback.{why}")
        self._journal("rollback", c["knob"], c["to"], c["from"], why, sig,
                      canary=c)
        log.warning("autotune ROLLBACK %s: %r -> %r (%s); cooldown %.0fs",
                    c["knob"], c["to"], c["from"], why, self.cooldown_s)

    def _abort(self, c: dict, sig: dict, now: float) -> None:
        """Dispatch-starved canary: traffic stopped before canary_k
        dispatches could vouch for the new setting — revert (unverified
        settings never stick) without the failure cooldown's stigma."""
        self._canary = None
        self.aborts += 1
        try:
            self.registry.restore(c["knob"], c["from"], c["old_source"])
        except KeyError:  # pragma: no cover
            pass
        self._cooldown_until[c["knob"]] = now + self.cooldown_s / 2.0
        self._journal("abort", c["knob"], c["to"], c["from"],
                      "dispatch_starved", sig, canary=c)

    # ------------------------------------------------------------- journal
    def _journal(self, phase: str, knob: Optional[str], frm: Any, to: Any,
                 reason: str, sig: dict, canary: Optional[dict] = None
                 ) -> None:
        self._seq += 1
        entry = {
            "seq": self._seq,
            "ts": round(time.time(), 3),
            "phase": phase,
            "knob": knob,
            "from": frm,
            "to": to,
            "reason": reason,
            "before": {
                "p99_ms": (canary or {}).get("baseline_p99_ms",
                                             sig.get("p99_ms", 0.0)),
                "pad_waste": sig.get("pad_waste", 0.0),
                "batch_p99": sig.get("batch_p99", 0),
            },
            "after": {
                "p99_ms": ((canary or {}).get("worst_p99_ms")
                           if canary else sig.get("p99_ms", 0.0)),
                "dispatches": (canary or {}).get(
                    "dispatches_seen", sig.get("dispatches", 0)),
                "traces": (canary or {}).get("traces_seen",
                                             sig.get("traces", 0)),
            },
        }
        self.journal.append(entry)
        tele = self.telemetry
        if tele is not None and getattr(tele, "enabled", False):
            # slow-op ring row: the cross-plane timeline ops_doctor and the
            # stall postmortems already read (overload/failover/slo pattern)
            tele.slow_ops.append({
                "op": f"autotune.{phase}", "ms": 0.0,
                "ts": entry["ts"],
                "detail": {"knob": knob, "from": frm, "to": to,
                           "reason": reason},
            })
        if self.metrics is not None:
            self.metrics.inc(f"autotune.{phase}")

    # ------------------------------------------------------------ surfaces
    def state_value(self) -> int:
        if self._canary is not None:
            return self.CANARY
        if time.monotonic() < self._hold_until:
            return self.HOLD
        return self.IDLE

    def snapshot(self) -> dict:
        """The ``/api/v1/autotune`` body — shape-stable disabled or not
        (zeros + empty journal + the live knob table). Taken under the
        tick lock: ticks run on an executor thread and a journal append
        racing this iteration would raise mid-request. The hold is
        bounded by one tick (rare canary commits include a device
        verify, still single-digit ms)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        now = time.monotonic()
        sv = self.state_value()
        c = self._canary
        return {
            "enabled": self.enabled,
            "state": ("canary" if sv == self.CANARY
                      else "hold" if sv == self.HOLD else "idle"),
            "state_value": sv,
            "decisions": self.decisions,
            "commits": self.commits,
            "rollbacks": self.rollbacks,
            "aborts": self.aborts,
            "holds": self.holds,
            "interval_s": self.interval_s,
            "canary_k": self.canary_k,
            "p99_guard": self.p99_guard,
            "cooldown_s": self.cooldown_s,
            "confirm_ticks": self.confirm_ticks,
            "canary": ({"knob": c["knob"], "from": c["from"], "to": c["to"],
                        "reason": c["reason"],
                        "dispatches_seen": c["dispatches_seen"],
                        "need": self.canary_k} if c is not None else None),
            "cooldowns": {
                k: round(t - now, 1)
                for k, t in self._cooldown_until.items() if t > now
            },
            "journal": list(self.journal),
            "knobs": (self.registry.snapshot()
                      if self.registry is not None else []),
        }

    @staticmethod
    def merge_snapshots(base: dict, others: Iterable[dict]) -> dict:
        """Cluster merge (``/api/v1/autotune/sum``): counters sum, state
        merges by worst; journals and knob tables stay per-node (fetch
        each node's ``/api/v1/autotune`` for them)."""
        others = list(others)
        out = {
            "nodes": 1 + len(others),
            "enabled": bool(base.get("enabled", False)),
            "state_value": base.get("state_value", 0),
            "decisions": 0, "commits": 0, "rollbacks": 0,
            "aborts": 0, "holds": 0,
        }
        for snap in [base, *others]:
            for k in ("decisions", "commits", "rollbacks", "aborts",
                      "holds"):
                out[k] += snap.get(k, 0)
            out["state_value"] = max(out["state_value"],
                                     snap.get("state_value", 0))
        out["state"] = ("canary" if out["state_value"] == 1
                        else "hold" if out["state_value"] == 2 else "idle")
        return out

    def prometheus_lines(self, labels: str) -> List[str]:
        rows = [
            ("rmqtt_autotune_enabled", "gauge", 1 if self.enabled else 0),
            ("rmqtt_autotune_state", "gauge", self.state_value()),
            ("rmqtt_autotune_canaries_total", "counter", self.decisions),
            ("rmqtt_autotune_commits_total", "counter", self.commits),
            ("rmqtt_autotune_rollbacks_total", "counter", self.rollbacks),
            ("rmqtt_autotune_holds_total", "counter", self.holds),
        ]
        out: List[str] = []
        for name, typ, val in rows:
            out.append(f"# TYPE {name} {typ}")
            out.append(f"{name}{{{labels}}} {val}")
        return out
