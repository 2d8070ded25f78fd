"""Broker-wide latency telemetry: log2 histograms + slow-op ring log.

The counter surface (`broker/metrics.py`) says how OFTEN things happen;
this layer says how LONG they take. Three pieces:

``Histogram``
    A fixed power-of-two-bucket latency histogram (ns resolution).
    Bucket ``i`` covers ``[2^i, 2^(i+1))`` ns (bucket 0 additionally
    absorbs 0), the top bucket absorbs overflow (2^39 ns ≈ 9 min — far
    past anything a broker op should take). Recording is two int ops
    (``bit_length`` + list increment); quantile estimation walks the 40
    counts and returns the containing bucket's upper bound, so an
    estimate always brackets the exact sorted-oracle value within one
    bucket boundary (a factor of 2). Histograms MERGE by bucket-wise
    addition — the property that makes per-node histograms summable
    cluster-wide (`/api/v1/latency/sum`) and across scrape intervals,
    which order statistics (raw percentiles) never are.

``Telemetry``
    The stage registry. The hot-path contract is near-zero overhead:

    - enabled: ONE ``perf_counter_ns()`` pair + one ``record()`` (a dict
      lookup, a bit_length, two int adds, one compare) per stage;
    - disabled: hot paths guard on ``tele.enabled`` so the cost is a
      single attribute load + branch — no timestamp is ever taken, no
      histogram is touched, no slow-log append happens (the acceptance
      bar for ``[observability] enable = false``).

    ``span()`` wraps the pair as a context manager — the API plugins and
    extensions should reach for when timing their own stages (the built-in
    hot paths inline the pair + ``recorder()`` instead, where the context
    manager's enter/exit dispatch would be measurable); when disabled it
    returns a shared no-op object.

slow-op ring
    A bounded ``deque`` capturing any nanosecond-stage op at or over
    ``slow_ms`` with op name, duration, timestamp and caller detail
    (topic, batch size, cache hit/miss) — the "what was that stall?"
    log that histograms by design cannot answer.

Stage names are pre-registered (``STAGES``) so every surface — JSON
endpoints, Prometheus, $SYS, the dashboard — is shape-stable whether or
not traffic (or telemetry itself) has happened yet.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE

NBUCKETS = 40  # [2^0, 2^40) ns ≈ up to ~18 min; top bucket absorbs overflow

# canonical broker stages (unit: ns unless listed in UNITS)
STAGES = (
    "connect.handshake",   # accept → CONNACK sent (server.py)
    "publish.e2e",         # publish ingress → last forward enqueued (shared.py)
    "publish.cache_hit",   # match-cache hit path: lookup+derive+collapse
    "publish.cache_miss",  # miss path: full batcher round trip
    "routing.queue_wait",  # batcher ingress-queue park time per item
    "routing.match",       # per-dispatch backend match latency (batch)
    "routing.batch_size",  # dispatch batch-size distribution (count, not ns)
    "deliver.ack_rtt",     # QoS1/2 delivery → PUBACK/PUBCOMP round trip
    "kernel.dispatch",     # router kernel/trie match call (native/xla)
)

UNITS: Dict[str, str] = {"routing.batch_size": "count"}

# recorder buffer fold threshold: big enough to amortize the fold loop,
# small enough that a mid-burst fold stall is microseconds
_FOLD_AT = 512


def _slow_entry(name: str, dur_ns: int, detail: Any, trace: Any) -> dict:
    """One slow-op ring row (cold path — only built at/over ``slow_ms``).
    Falls back to the tracing contextvar so entries recorded in the
    publish-ingress task gain the active trace id (broker/tracing.py);
    cross-task recorders pass their trace explicitly."""
    if trace is None:
        trace = CURRENT_TRACE.get()
    entry = {
        "op": name,
        "ms": round(dur_ns / 1e6, 3),
        "ts": round(time.time(), 3),
        "detail": detail,
    }
    if trace is not None:
        entry["trace"] = trace.tid
    return entry


def prom_sanitize(name: str) -> str:
    """Exposition-format metric-name scrub: grammar allows [a-zA-Z0-9_:];
    metric keys here are dotted and plugin counters may carry arbitrary
    chars. Single definition shared by every exporter."""
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


class Histogram:
    """Fixed log2-bucket histogram; ns-resolution; mergeable by addition.

    ``count`` is DERIVED from the buckets on read: the recording paths run
    per publish, and one fewer read-modify-write per record is a measured
    win (bench cfg7); every read path is cold."""

    __slots__ = ("counts", "sum")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * NBUCKETS
        self.sum = 0

    @property
    def count(self) -> int:
        return sum(self.counts)

    @staticmethod
    def bucket_index(value: int) -> int:
        if value <= 1:
            return 0
        return min(value.bit_length() - 1, NBUCKETS - 1)

    @staticmethod
    def bucket_upper(i: int) -> int:
        """Exclusive upper bound of bucket ``i`` (top bucket: +inf proxy)."""
        return 1 << (i + 1)

    def record(self, value: int) -> None:
        self.counts[self.bucket_index(value)] += 1
        self.sum += value

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-th sample (0 if empty).

        The exact q-th order statistic lies in the same bucket, so the
        estimate is exact-to-one-bucket: ``upper/2 <= exact < upper``
        (bucket 0: ``0 <= exact < 2``)."""
        total = self.count
        if total == 0:
            return 0.0
        rank = max(1, int(q * total + 0.999999))  # ceil, 1-based
        rank = min(rank, total)
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return float(self.bucket_upper(i))
        return float(self.bucket_upper(NBUCKETS - 1))

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> "Histogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        return self

    def to_json(self) -> dict:
        return {"count": self.count, "sum": self.sum, "buckets": list(self.counts)}

    @classmethod
    def from_json(cls, d: dict) -> "Histogram":
        h = cls()
        buckets = list(d.get("buckets", ()))[:NBUCKETS]
        h.counts[: len(buckets)] = [int(b) for b in buckets]
        h.sum = int(d.get("sum", 0))
        return h

    def snapshot(self, unit: str = "ns") -> dict:
        """JSON row for the admin surfaces: counts + quantile estimates in
        the recorded unit (callers convert ns → ms for display)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "unit": unit,
            "mean": round(self.mean(), 1),
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
            "buckets": list(self.counts),
        }


class _Span:
    """Enabled-mode timer: one perf_counter_ns pair around the block."""

    __slots__ = ("_tele", "_name", "_detail", "_t0")

    def __init__(self, tele: "Telemetry", name: str, detail: Any) -> None:
        self._tele = tele
        self._name = name
        self._detail = detail

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._tele.record(self._name, time.perf_counter_ns() - self._t0, self._detail)
        return False


class _NullSpan:
    """Disabled-mode span: never takes a timestamp."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Telemetry:
    """Per-node latency registry: stage histograms + the slow-op ring."""

    __slots__ = ("enabled", "slow_ms", "slow_ns", "slow_ops", "_h",
                 "_recorders", "_folds", "_reg_lock")

    def __init__(
        self,
        enabled: bool = True,
        slow_ms: float = 100.0,
        slow_log_max: int = 256,
        stages: Iterable[str] = STAGES,
    ) -> None:
        self.enabled = enabled
        self.slow_ms = slow_ms
        self.slow_ns = int(slow_ms * 1e6)
        self.slow_ops: deque = deque(maxlen=max(1, slow_log_max))
        self._h: Dict[str, Histogram] = {name: Histogram() for name in stages}
        self._recorders: Dict[str, Callable] = {}
        self._folds: Dict[str, Callable[[], None]] = {}
        # guards recorder CREATION (rare): first calls can come from
        # executor threads (kernel.dispatch), and an unlocked insert could
        # both race flush()'s iteration and build duplicate closures whose
        # buffered samples would never fold
        self._reg_lock = threading.Lock()

    def hist(self, name: str) -> Histogram:
        h = self._h.get(name)
        if h is None:
            h = self._h[name] = Histogram()
        return h

    def record(self, name: str, dur_ns: int, detail: Any = None,
               trace: Any = None) -> None:
        """Record one op. Callers on hot paths guard with ``self.enabled``
        (so the disabled cost is one branch); the guard here keeps
        un-guarded callers correct, not fast. The histogram update is
        inlined (not ``hist().record()``) — this runs several times per
        publish and the two extra method dispatches measurably widen the
        telemetry-on overhead (bench cfg7)."""
        if not self.enabled:
            return
        try:
            h = self._h[name]
        except KeyError:
            h = self._h[name] = Histogram()
        i = dur_ns.bit_length() - 1
        if i < 0:
            i = 0
        elif i >= NBUCKETS:
            i = NBUCKETS - 1
        h.counts[i] += 1
        h.sum += dur_ns
        # non-ns stages (batch size) are not durations: never slow-log
        if dur_ns >= self.slow_ns and name not in UNITS:
            self.slow_ops.append(_slow_entry(name, dur_ns, detail, trace))

    def span(self, name: str, detail: Any = None):
        """Context-manager timer; a shared no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, detail)

    def recorder(self, name: str) -> Callable[[int, Any], None]:
        """A per-stage fast-path recorder closure (memoized per stage).

        ``record()`` pays a name lookup + several attribute loads + the
        histogram update per call; at publish rates that is the single
        biggest telemetry cost (bench cfg7). The recorder instead buffers
        the raw duration with one C-level ``deque.append`` and folds the
        buffer into the histogram AMORTIZED — every ``_FOLD_AT`` ops or on
        the next read (``flush()``) — so the per-op cost is an append, one
        slow-threshold compare (slow ops keep their true timestamps and
        details, checked eagerly), and a length check. Totals stay exact:
        folding only defers the bucket increments, it never drops them.
        When disabled this returns a shared no-op so un-guarded calls
        stay correct."""
        rec = self._recorders.get(name)  # lock-free fast path (dict get)
        if rec is not None:
            return rec
        with self._reg_lock:
            return self._make_recorder(name)

    def _make_recorder(self, name: str) -> Callable[[int, Any], None]:
        rec = self._recorders.get(name)  # re-check under the lock
        if rec is not None:
            return rec
        if not self.enabled:
            rec = self._recorders[name] = (
                lambda dur_ns, detail=None, trace=None: None)
            return rec
        h = self.hist(name)
        counts = h.counts
        slow_ns = self.slow_ns
        slow_ops = self.slow_ops
        is_ns = name not in UNITS
        top = NBUCKETS - 1
        pending: deque = deque()
        append = pending.append
        popleft = pending.popleft
        fold_lock = threading.Lock()

        def fold() -> None:
            # executor threads record concurrently with the loop (kernel
            # dispatch runs off-loop): the hot append is GIL-atomic, and
            # the lock serializes the bucket/sum read-modify-writes so a
            # concurrent double-fold can't lose increments — totals stay
            # exact. Cold: taken every _FOLD_AT ops or per read.
            with fold_lock:
                s = 0
                while True:
                    try:
                        v = popleft()
                    except IndexError:
                        break
                    i = v.bit_length() - 1
                    counts[0 if i < 0 else (top if i > top else i)] += 1
                    s += v
                h.sum += s

        self._folds[name] = fold

        def rec(dur_ns: int, detail: Any = None, trace: Any = None) -> None:
            append(dur_ns)
            if dur_ns >= slow_ns and is_ns:
                slow_ops.append(_slow_entry(name, dur_ns, detail, trace))
            if len(pending) >= _FOLD_AT:
                fold()

        self._recorders[name] = rec
        return rec

    def flush(self) -> None:
        """Fold every recorder's pending samples into its histogram; all
        read paths call this, so readers always see exact totals. The
        list() snapshot keeps a concurrent first-recorder registration
        (executor thread) from invalidating the iteration."""
        for fold in list(self._folds.values()):
            fold()

    # ------------------------------------------------------------- surfaces
    def p_ms(self, name: str, q: float) -> float:
        """Quantile of a ns-stage in milliseconds (admin/stat gauges)."""
        self.flush()
        return round(self.hist(name).quantile(q) / 1e6, 3)

    def snapshot(self) -> dict:
        """The `/api/v1/latency` body: shape-stable in disabled mode (all
        pre-registered stages present with zero counts, empty slow log)."""
        self.flush()
        return {
            "enabled": self.enabled,
            "slow_threshold_ms": self.slow_ms,
            "histograms": {
                name: h.snapshot(UNITS.get(name, "ns"))
                for name, h in sorted(list(self._h.items()))
            },
            "slow_ops": list(self.slow_ops),
        }

    @staticmethod
    def merge_snapshots(base: dict, others: Iterable[dict]) -> dict:
        """Cluster-wide merge (`/api/v1/latency/sum`): bucket-wise addition
        of each node's histograms — the whole point of fixed buckets."""
        others = list(others)
        merged: Dict[str, Histogram] = {}
        units: Dict[str, str] = {}
        for snap in [base, *others]:
            for name, row in (snap.get("histograms") or {}).items():
                units.setdefault(name, row.get("unit", "ns"))
                h = merged.get(name)
                if h is None:
                    merged[name] = Histogram.from_json(row)
                else:
                    h.merge(Histogram.from_json(row))
        return {
            "nodes": 1 + len(others),
            "enabled": bool(base.get("enabled", False)),
            "histograms": {
                name: h.snapshot(units.get(name, "ns"))
                for name, h in sorted(merged.items())
            },
        }

    def prometheus_lines(self, labels: str) -> List[str]:
        """Exposition-format histogram families. ``labels`` is the shared
        label body (e.g. ``node="1"``). ns stages export in SECONDS (the
        Prometheus base-unit convention) as ``rmqtt_latency_<stage>_seconds``;
        count stages export raw as ``rmqtt_<stage>``."""
        self.flush()
        out: List[str] = []
        for name, h in sorted(self._h.items()):
            unit = UNITS.get(name, "ns")
            safe = prom_sanitize(name)
            if unit == "ns":
                metric = f"rmqtt_latency_{safe}_seconds"
                scale = 1e-9
            else:
                metric = f"rmqtt_{safe}"
                scale = 1.0
            out.append(f"# TYPE {metric} histogram")
            acc = 0
            for i, c in enumerate(h.counts):
                acc += c
                # exposition `le` is INCLUSIVE; our buckets have exclusive
                # uppers, so bucket i's inclusive max is upper-1 (a
                # boundary-exact sample — e.g. a 64-item batch — belongs
                # to the next bucket and must not be claimed by this le)
                le = format((h.bucket_upper(i) - 1) * scale, "g")
                out.append(f'{metric}_bucket{{{labels},le="{le}"}} {acc}')
            out.append(f'{metric}_bucket{{{labels},le="+Inf"}} {h.count}')
            out.append(f"{metric}_sum{{{labels}}} {format(h.sum * scale, 'g')}")
            out.append(f"{metric}_count{{{labels}}} {h.count}")
        return out


# module-level disabled singleton: subsystems constructed without a broker
# context (bare RoutingService in unit tests, standalone routers) share one
# no-op registry instead of None-checking on the hot path
NULL_TELEMETRY = Telemetry(enabled=False, slow_log_max=1)
