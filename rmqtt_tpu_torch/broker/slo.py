"""Live SLO engine: declarative objectives → error budgets → burn rates.

the telemetry answers "how long did ops take", the reason-labeled drop
counters answer "what was lost and why". This layer turns both into the
operator-facing question: **are we inside our service-level objectives,
and how fast are we spending the error budget?**

``Objective``
    One declarative target, parsed from the ``[slo]`` config section (or
    the built-in defaults). Two kinds:

    - ``latency`` — "at least ``target`` of ``stage`` samples complete
      under ``threshold_ms``", evaluated over the telemetry layer's log2
      histograms. Because buckets are powers of two, the threshold is
      quantized UP to the containing bucket's exclusive upper bound
      (``effective_threshold_ms`` in every surface says what was actually
      enforced); good = samples in buckets at or below that bound.
    - ``availability`` — "at least ``target`` of messages are delivered,
      not dropped", over ``messages.delivered`` vs the reason-labeled
      ``messages.dropped.*`` counters. ``exclude_reasons`` removes drops
      that are *policy*, not failure (e.g. ``shed_qos0`` under an overload
      profile that deliberately sheds).

``SloEngine``
    Samples each objective's cumulative (good, total) pair on a fixed
    interval into a bounded ring, then evaluates **multi-window burn
    rates** the Google-SRE way: the error budget is ``1 - target``; the
    burn rate over a window is ``bad_fraction / budget`` (1.0 = spending
    exactly the sustainable rate, N = exhausting N windows' budget per
    window). Two windows per objective — ``fast`` (default 5 m, catches
    cliffs) and ``slow`` (default 1 h, catches slow leaks) — drive a
    per-objective state machine::

        OK → BURNING    fast burn ≥ burn_alert (budget draining fast)
        *  → EXHAUSTED  slow burn ≥ 1.0        (window's whole budget gone)

    Budget-exhaustion transitions land on the same timelines operators
    already watch: a slow-ring annotation (``slo.state``), a
    ``SERVER_SLO`` hook fire (SERVER_OVERLOAD-style), and the
    ``slo.transitions`` counter.

Like the histograms underneath, per-objective samples are **mergeable by
addition** — ``merge_snapshots`` sums (good, total) pairs per objective
name across nodes for cluster-wide ``/api/v1/slo/sum``.

With ``[slo] enable = false`` nothing is sampled and no task starts; the
snapshot surface stays shape-stable (objectives listed with zero data).
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from rmqtt_tpu_torch.broker.telemetry import Histogram, prom_sanitize

log = logging.getLogger("rmqtt_tpu_torch.slo")

_BUDGET_FLOOR = 1e-9  # target=1.0 ("no errors ever") still divides cleanly


class SloState(enum.IntEnum):
    OK = 0
    BURNING = 1
    EXHAUSTED = 2


#: objectives used when the [slo] section declares none: a broker-wide
#: latency target on the publish pipeline, a handshake target, and a
#: delivery-availability target over the reason-labeled drop counters
DEFAULT_OBJECTIVES: Tuple[Dict[str, Any], ...] = (
    {"name": "publish-e2e-p99", "kind": "latency", "stage": "publish.e2e",
     "threshold_ms": 100.0, "target": 0.99},
    {"name": "connect-p99", "kind": "latency", "stage": "connect.handshake",
     "threshold_ms": 500.0, "target": 0.99},
    {"name": "delivery", "kind": "availability", "target": 0.999},
)


@dataclass
class Objective:
    """One parsed SLO row; ``from_spec`` validates the declarative dict."""

    name: str
    kind: str  # "latency" | "availability"
    target: float
    stage: str = "publish.e2e"  # latency only
    threshold_ms: float = 100.0  # latency only
    exclude_reasons: Tuple[str, ...] = ()  # availability only
    # derived (latency): the log2 bucket the threshold falls in, and the
    # bucket-quantized bound actually enforced
    _lim_bucket: int = field(default=0, repr=False)
    effective_threshold_ms: float = field(default=0.0, repr=False)

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "Objective":
        known = {"name", "kind", "target", "stage", "threshold_ms",
                 "exclude_reasons"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown slo objective keys: {sorted(unknown)}")
        kind = str(spec.get("kind", "latency"))
        if kind not in ("latency", "availability"):
            raise ValueError(
                f"slo objective kind must be latency|availability, got {kind!r}")
        target = float(spec.get("target", 0.99))
        if not 0.0 < target <= 1.0:
            raise ValueError(f"slo target must be in (0, 1], got {target}")
        name = str(spec.get("name") or "").strip()
        # names land in $SYS topic levels and Prometheus label values:
        # constrain to a safe charset instead of escaping per surface
        if not name or not all(
            c.isalnum() or c in "._-" for c in name
        ):
            raise ValueError(
                f"slo objective name must be non-empty [A-Za-z0-9._-], "
                f"got {name!r}")
        obj = cls(
            name=name,
            kind=kind,
            target=target,
            stage=str(spec.get("stage", "publish.e2e")),
            threshold_ms=float(spec.get("threshold_ms", 100.0)),
            exclude_reasons=tuple(
                str(r) for r in spec.get("exclude_reasons", ())),
        )
        if kind == "latency":
            if obj.threshold_ms <= 0:
                raise ValueError(
                    f"slo threshold_ms must be > 0, got {obj.threshold_ms}")
            obj._lim_bucket = Histogram.bucket_index(
                int(obj.threshold_ms * 1e6))
            obj.effective_threshold_ms = round(
                Histogram.bucket_upper(obj._lim_bucket) / 1e6, 6)
        return obj

    # ------------------------------------------------------------- sampling
    def cumulative(self, ctx) -> Tuple[int, int]:
        """This objective's (good, total) event counts since process start.
        Monotonic by construction — windows are deltas of these."""
        if self.kind == "latency":
            tele = ctx.telemetry
            tele.flush()
            counts = tele.hist(self.stage).counts
            total = sum(counts)
            good = sum(counts[: self._lim_bucket + 1])
            return good, total
        m = ctx.metrics
        delivered = m.get("messages.delivered")
        bad = m.get("messages.dropped")
        for reason in self.exclude_reasons:
            bad -= m.get("messages.dropped." + reason)
        bad = max(0, bad)
        return delivered, delivered + bad


def _burn(good: int, total: int, target: float) -> Tuple[float, float]:
    """(bad_fraction, burn_rate) for one window's delta. Zero-event windows
    are vacuously healthy (no evidence of burn, no evidence of health)."""
    if total <= 0:
        return 0.0, 0.0
    bad_frac = (total - good) / total
    return bad_frac, bad_frac / max(1.0 - target, _BUDGET_FLOOR)


class SloEngine:
    """Per-node SLO evaluator: the sampling loop + every surface's body.

    Constructed unconditionally on ``ServerContext`` (like the overload
    controller) so `/api/v1/slo`, the gauges and `$SYS` are shape-stable
    whether or not the engine is enabled."""

    def __init__(self, ctx, cfg,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.ctx = ctx
        self.enabled = bool(cfg.slo_enable)
        self.sample_interval = max(0.05, float(cfg.slo_sample_interval))
        self.fast_window_s = max(self.sample_interval,
                                 float(cfg.slo_fast_window_s))
        self.slow_window_s = max(self.fast_window_s,
                                 float(cfg.slo_slow_window_s))
        self.burn_alert = max(1.0, float(cfg.slo_burn_alert))
        specs = list(cfg.slo_objectives) or list(DEFAULT_OBJECTIVES)
        self.objectives: List[Objective] = [
            Objective.from_spec(s) for s in specs]
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo objective names: {names}")
        # a typo'd stage name would be silently vacuously healthy forever
        # (hist() auto-creates an empty histogram); plugins may register
        # custom stages after construction, so this warns instead of
        # raising — loudly, at startup, where operators read logs
        known = set(getattr(getattr(ctx, "telemetry", None), "_h", ()) or ())
        for obj in self.objectives:
            if obj.kind == "latency" and known and obj.stage not in known:
                log.warning(
                    "slo objective %r targets unknown telemetry stage %r "
                    "(known: %s) — it will report vacuously healthy until "
                    "that stage records", obj.name, obj.stage,
                    sorted(known))
        self._clock = clock
        # ring of (t, ((good, total), ...)) — one slot per objective per
        # sample, bounded to one slow window (+1 baseline slot so a full
        # window always has a sample at-or-before its left edge)
        slots = int(self.slow_window_s / self.sample_interval) + 2
        self._ring: deque = deque(maxlen=max(4, slots))
        self._states: List[SloState] = [SloState.OK] * len(self.objectives)
        self.transitions = 0
        self._task: Optional[asyncio.Task] = None

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
            except Exception:  # an evaluation bug must not kill the engine
                log.exception("slo sample failed")

    # ------------------------------------------------------------- sampling
    def tick(self) -> None:
        """One sample + state evaluation (test entry point)."""
        t = self._clock()
        self._ring.append(
            (t, tuple(o.cumulative(self.ctx) for o in self.objectives)))
        for i, obj in enumerate(self.objectives):
            new = self._evaluate(i, t)
            old = self._states[i]
            if new != old:
                self._states[i] = new
                self._transition(obj, i, old, new)

    def _window_delta(self, i: int, window_s: float,
                      now: float) -> Tuple[int, int, float]:
        """(good, total, coverage) for objective ``i`` over the trailing
        window: newest sample at-or-before the window's left edge is the
        baseline (falling back to the oldest sample when history is
        shorter than the window). ``coverage`` is the fraction of the
        window the delta actually spans — burn rates scale by it, so a
        3-minute-old broker can't claim an hour's budget is spent (the
        un-covered remainder of the window counts as clean)."""
        if not self._ring:
            return 0, 0, 0.0
        cutoff = now - window_s
        base = self._ring[0]
        for entry in self._ring:
            if entry[0] <= cutoff:
                base = entry
            else:
                break
        latest = self._ring[-1]
        g0, t0 = base[1][i]
        g1, t1 = latest[1][i]
        coverage = min(1.0, max(0.0, (latest[0] - base[0]) / window_s))
        return max(0, g1 - g0), max(0, t1 - t0), coverage

    def _window_burn(self, i: int, window_s: float,
                     now: float) -> Tuple[int, int, float, float, float]:
        """(good, total, coverage, bad_fraction, coverage-scaled burn)."""
        good, total, coverage = self._window_delta(i, window_s, now)
        frac, burn = _burn(good, total, self.objectives[i].target)
        return good, total, coverage, frac, burn * coverage

    def _evaluate(self, i: int, now: float) -> SloState:
        *_rest, fast_burn = self._window_burn(i, self.fast_window_s, now)
        *_rest, slow_burn = self._window_burn(i, self.slow_window_s, now)
        if slow_burn >= 1.0:
            return SloState.EXHAUSTED
        if fast_burn >= self.burn_alert:
            return SloState.BURNING
        return SloState.OK

    def _transition(self, obj: Objective, i: int, old: SloState,
                    new: SloState) -> None:
        ctx = self.ctx
        self.transitions += 1
        ctx.metrics.inc("slo.transitions")
        log.warning("slo %s: %s -> %s (target=%s)",
                    obj.name, old.name, new.name, obj.target)
        # slow-ring annotation: budget exhaustion lands on the timeline
        # operators read for stalls and overload transitions
        tele = getattr(ctx, "telemetry", None)
        if tele is not None and tele.enabled:
            tele.slow_ops.append({
                "op": "slo.state", "ms": 0.0, "ts": round(time.time(), 3),
                "detail": {"objective": obj.name, "from": old.name,
                           "to": new.name, "target": obj.target},
            })
        # entering BURNING/EXHAUSTED freezes the host-plane flight
        # recorder (broker/hostprof.py): the budget started draining NOW,
        # and the loop-lag / GC / blocking forensics of the last minutes
        # are exactly what diagnoses it (rate-limited per reason)
        if new > old:
            from rmqtt_tpu_torch.broker.hostprof import HOSTPROF

            if HOSTPROF.enabled:
                HOSTPROF.auto_dump(f"slo_{new.name.lower()}")
        row = self._objective_row(obj, i, self._clock())
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # tick() driven synchronously in tests: no hook task
        from rmqtt_tpu_torch.broker.hooks import HookType

        loop.create_task(
            ctx.hooks.fire(HookType.SERVER_SLO, obj.name, old.name,
                           new.name, row))

    # ----------------------------------------------------------- surfaces
    @property
    def worst_state(self) -> SloState:
        return max(self._states, default=SloState.OK)

    def _objective_row(self, obj: Objective, i: int, now: float) -> dict:
        # cumulative counts read LIVE (not from the last tick) so a
        # snapshot taken right after a burst judges the burst; windows
        # stay tick-sampled. Disabled engines report zeros (shape-stable,
        # no evaluation).
        good, total = obj.cumulative(self.ctx) if self.enabled else (0, 0)
        fg, ft, fcov, fast_frac, fast_burn = self._window_burn(
            i, self.fast_window_s, now)
        sg, st, scov, slow_frac, slow_burn = self._window_burn(
            i, self.slow_window_s, now)
        row = {
            "name": obj.name,
            "kind": obj.kind,
            "target": obj.target,
            "state": self._states[i].name,
            "state_value": int(self._states[i]),
            "good": good,
            "total": total,
            "ratio": round(good / total, 6) if total else 1.0,
            "compliant": (good / total >= obj.target) if total else True,
            "fast": {"window_s": self.fast_window_s, "good": fg, "total": ft,
                     "coverage": round(fcov, 4),
                     "bad_fraction": round(fast_frac, 6),
                     "burn_rate": round(fast_burn, 4)},
            "slow": {"window_s": self.slow_window_s, "good": sg, "total": st,
                     "coverage": round(scov, 4),
                     "bad_fraction": round(slow_frac, 6),
                     "burn_rate": round(slow_burn, 4)},
            "budget_remaining": round(max(0.0, 1.0 - slow_burn), 4),
        }
        if obj.kind == "latency":
            row["stage"] = obj.stage
            row["threshold_ms"] = obj.threshold_ms
            row["effective_threshold_ms"] = obj.effective_threshold_ms
        else:
            row["exclude_reasons"] = list(obj.exclude_reasons)
        return row

    def snapshot(self) -> dict:
        """The `/api/v1/slo` body; shape-stable when disabled (objectives
        listed with zero data, no burn)."""
        now = self._clock()
        worst = self.worst_state
        return {
            "enabled": self.enabled,
            "state": worst.name,
            "state_value": int(worst),
            "transitions": self.transitions,
            "sample_interval": self.sample_interval,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_alert": self.burn_alert,
            "objectives": [
                self._objective_row(obj, i, now)
                for i, obj in enumerate(self.objectives)
            ],
        }

    @staticmethod
    def merge_snapshots(base: dict, others: Iterable[dict]) -> dict:
        """Cluster-wide merge (`/api/v1/slo/sum`): per-objective (good,
        total) pairs — cumulative AND per-window — sum across nodes (the
        same additivity the latency histograms are built on); burn rates
        are recomputed from the merged sums and states merge by worst."""
        others = list(others)
        merged: Dict[str, dict] = {}
        order: List[str] = []
        for snap in [base, *others]:
            for row in snap.get("objectives") or ():
                name = row["name"]
                agg = merged.get(name)
                if agg is None:
                    agg = merged[name] = {
                        k: row[k] for k in row
                        if k not in ("good", "total", "ratio", "compliant",
                                     "fast", "slow", "budget_remaining",
                                     "state", "state_value")
                    }
                    agg.update(good=0, total=0, state_value=0)
                    for w in ("fast", "slow"):
                        agg[w] = {"window_s": row[w]["window_s"],
                                  "good": 0, "total": 0, "coverage": 0.0}
                    order.append(name)
                agg["good"] += row["good"]
                agg["total"] += row["total"]
                agg["state_value"] = max(agg["state_value"],
                                         int(row.get("state_value", 0)))
                for w in ("fast", "slow"):
                    agg[w]["good"] += row[w]["good"]
                    agg[w]["total"] += row[w]["total"]
                    # longest-running node's coverage: the merged deltas
                    # span at most that much of the window
                    agg[w]["coverage"] = max(agg[w]["coverage"],
                                             row[w].get("coverage", 1.0))
        for agg in merged.values():
            target = float(agg.get("target", 0.99))
            g, t = agg["good"], agg["total"]
            agg["ratio"] = round(g / t, 6) if t else 1.0
            agg["compliant"] = (g / t >= target) if t else True
            for w in ("fast", "slow"):
                frac, burn = _burn(agg[w]["good"], agg[w]["total"], target)
                agg[w]["bad_fraction"] = round(frac, 6)
                agg[w]["burn_rate"] = round(burn * agg[w]["coverage"], 4)
            agg["budget_remaining"] = round(
                max(0.0, 1.0 - agg["slow"]["burn_rate"]), 4)
            agg["state"] = SloState(agg["state_value"]).name
        worst = max((a["state_value"] for a in merged.values()), default=0)
        return {
            "nodes": 1 + len(others),
            "enabled": bool(base.get("enabled", False)),
            "state": SloState(worst).name,
            "state_value": worst,
            "objectives": [merged[name] for name in order],
        }

    def prometheus_lines(self, labels: str) -> List[str]:
        """`rmqtt_slo_*` exposition families, one objective-labeled sample
        per row: state / burn rates / budget plus good-vs-bad event
        counters (``result`` label) so dashboards can derive their own
        windows."""
        now = self._clock()
        # NOTE: the worst-state scalar exports as rmqtt_slo_state via the
        # generic Stats-gauge loop (slo_state); the per-objective family
        # must use a DIFFERENT name — two TYPE lines for one metric name
        # are invalid exposition
        gauges = {
            "rmqtt_slo_objective_state": lambda r: r["state_value"],
            "rmqtt_slo_target": lambda r: r["target"],
            "rmqtt_slo_burn_rate_fast": lambda r: r["fast"]["burn_rate"],
            "rmqtt_slo_burn_rate_slow": lambda r: r["slow"]["burn_rate"],
            "rmqtt_slo_budget_remaining": lambda r: r["budget_remaining"],
        }
        rows = [self._objective_row(obj, i, now)
                for i, obj in enumerate(self.objectives)]
        out: List[str] = []
        for metric, getter in gauges.items():
            out.append(f"# TYPE {metric} gauge")
            for row in rows:
                oname = prom_sanitize(row["name"])
                out.append(
                    f'{metric}{{{labels},objective="{oname}"}} '
                    f'{format(getter(row), "g")}')
        out.append("# TYPE rmqtt_slo_events_total counter")
        for row in rows:
            oname = prom_sanitize(row["name"])
            out.append(
                f'rmqtt_slo_events_total{{{labels},objective="{oname}",'
                f'result="good"}} {row["good"]}')
            out.append(
                f'rmqtt_slo_events_total{{{labels},objective="{oname}",'
                f'result="bad"}} {row["total"] - row["good"]}')
        return out
