"""Device-plane flight recorder: recompile tracking, HBM accounting and
dispatch time-series for the TPU router.

The host plane has histograms (broker/telemetry.py), tracing
(broker/tracing.py) and SLO budgets (broker/slo.py); the device plane —
the component the whole paper is about — reported a handful of flat
counters. The last real-chip window left cfg4/cfg5 dead with no
on-device diagnosis and cfg1's small-batch loss attributed to "dispatch
overhead" only via offline A/B. This module is the instrument that
makes those diagnosable in production:

``shape-key registry`` (compile/retrace tracking)
    Every ``jax.jit`` entry seam in the matcher stack (match / fused /
    compact / split / delta-scatter / pallas — ``ops/partitioned.py``,
    ``parallel/sharded.py``) reports one ``note_jit(kernel, key, ns)``
    per dispatch. ``jax.jit`` caches executables on exactly the
    (static-args, arg-shapes/dtypes) signature, so a never-seen key IS a
    trace+compile by construction and a seen key is a cache hit — no
    jax-internal hooks needed, and the wall time of a first-seen call
    brackets the trace+compile cost. A burst of ``storm_n`` traces
    inside ``storm_window`` seconds is a **retrace storm** (the failure
    mode the sticky pad floor and pow2 padding exist to prevent): it
    bumps a counter, lands on the slow-op ring, and auto-dumps the
    flight recorder — the padding invariants become *checkable in
    production* instead of assumed.

``dispatch rollups`` (time series, not cumulative counters)
    Fixed-interval ring-buffer buckets of dispatch count, batch items,
    padded rows (pad-waste fraction = (padded − real) / padded), active
    dispatch-path wall time (log2 histogram → p50/p99 per interval),
    delta-vs-full upload bytes and fused-vs-fallback share.

``flight recorder``
    A bounded ring of the last K dispatch records (shape kind, compile
    hit/trace, batch/padded, per-stage ns from the ``stage_timing``,
    fused flag, trace id when one is in scope). ``dump()`` freezes ring
    + snapshot into one JSON artifact; ``auto_dump()`` fires on retrace
    storms, device-plane failover trips (broker/failover.py), fused-
    verify disagreement (ops/partitioned.py, parallel/sharded.py) and
    bench/chip-hunter failure exits — exactly the postmortem cfg4/cfg5
    never got.

Surfaces follow the house pattern: ``/api/v1/device`` (+ cluster
``/device/sum`` via a ``what=device`` DATA query), ``rmqtt_device_*``
Prometheus families, ``$SYS/brokers/<n>/device/#``, dashboard cards,
``stats()`` gauges, ``[observability]`` knobs (``device_profile``,
``device_ring``, ``recompile_storm_n``, ``recompile_storm_window``).
``enabled=False`` (the module default) keeps every instrumented seam at
ONE attribute check — no keys built, no timestamps taken, no ring
appends — while the surfaces stay shape-stable.

In ``rmqtt_tpu_torch`` the seams are the matcher's launch seams (the words
kernels, the fused tail, the delta scatter: a new signature is a kernel
build or a shape's first launch), and the HBM model
(``TorchRouter.device_hbm``) reconciles against the CUDA allocator.

The profiler is process-global (``DEVPROF``), like the failpoint
registry: the jit executable caches it models are process-global too,
so per-matcher registries would double-count shared compilations.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.telemetry import Histogram, prom_sanitize
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE

_LOG = logging.getLogger("rmqtt_tpu_torch.devprof")

DUMP_SCHEMA = "rmqtt_tpu_torch.devprof_dump/1"

#: per-kernel shape keys kept with their trace wall time (the report's
#: "top shape keys" table); past the cap older keys stay counted but lose
#: their per-key row — the registry set itself is never evicted (it is
#: what makes hit-vs-trace classification exact)
_KEY_ROWS_MAX = 128


class _Rollup:
    """One fixed-interval dispatch bucket (the time-series element)."""

    __slots__ = ("t", "dispatches", "items", "padded", "hist", "whist",
                 "bhist", "delta_bytes", "full_bytes", "fused", "fallback",
                 "traces")

    def __init__(self, t: int) -> None:
        self.t = t
        self.dispatches = 0
        self.items = 0
        self.padded = 0
        self.hist = Histogram()  # active dispatch-path ns (submit+complete)
        # warm-only subset: dispatches that carried NO fresh jit trace.
        # The autotuner's canary compares steady-state p99 against its
        # baseline — a ladder step legitimately compiles its new shape
        # once, and judging that one-off against the guard would veto
        # every exploration (the trace budget bounds compile COUNT
        # separately)
        self.whist = Histogram()
        # per-dispatch batch-size distribution (log2 buckets, mergeable by
        # addition like every Histogram): the autotuner's primary
        # regime-detection signal — pad-waste alone can't distinguish
        # "steady batch-1 traffic" from "mixed small batches", and the two
        # regimes want different pad floors (broker/autotune.py)
        self.bhist = Histogram()
        self.delta_bytes = 0
        self.full_bytes = 0
        self.fused = 0
        self.fallback = 0
        self.traces = 0

    def row(self) -> dict:
        return {
            "t": self.t,
            "dispatches": self.dispatches,
            "items": self.items,
            "padded": self.padded,
            "pad_waste": round(1.0 - self.items / self.padded, 4)
            if self.padded else 0.0,
            "p50_ms": round(self.hist.quantile(0.50) / 1e6, 3),
            "p99_ms": round(self.hist.quantile(0.99) / 1e6, 3),
            "warm_p99_ms": round(self.whist.quantile(0.99) / 1e6, 3),
            # quantiles are the bucket's EXCLUSIVE upper bound (exact to
            # one log2 bucket); batch_hist keys are those bounds too, so
            # consumers (autotune replay) merge rows by key addition
            "batch_p50": int(self.bhist.quantile(0.50)),
            "batch_p99": int(self.bhist.quantile(0.99)),
            "batch_hist": {
                str(Histogram.bucket_upper(i)): c
                for i, c in enumerate(self.bhist.counts) if c
            },
            "delta_bytes": self.delta_bytes,
            "full_bytes": self.full_bytes,
            "fused": self.fused,
            "fallback": self.fallback,
            "traces": self.traces,
        }


class DeviceProfiler:
    """Process-global device-plane profiler + flight recorder."""

    def __init__(
        self,
        enabled: bool = False,
        ring: int = 256,
        storm_n: int = 8,
        storm_window: float = 10.0,
        interval_s: float = 5.0,
        rollup_max: int = 120,
        dump_dir: Optional[str] = None,
    ) -> None:
        self.enabled = enabled
        self.storm_n = max(2, storm_n)
        self.storm_window = max(0.1, storm_window)
        self.interval_s = max(0.1, interval_s)
        self.rollup_max = max(2, rollup_max)
        self.dump_dir = dump_dir
        #: callable returning the router/matcher HBM occupancy breakdown
        #: (wired by ServerContext / the bench); None = model unavailable
        self.hbm_provider: Optional[Callable[[], dict]] = None
        #: telemetry registry whose slow-op ring storm/pad-floor events
        #: annotate (wired by ServerContext); None outside a broker
        self.telemetry = None
        self._lock = threading.Lock()
        self._reset_state(ring)

    def _reset_state(self, ring: int) -> None:
        self.ring_cap = max(1, ring)
        self.flight_ring: deque = deque(maxlen=self.ring_cap)
        # compile/retrace registry
        self._seen: set = set()  # (kernel, key) signatures already traced
        self.traces = 0
        self.cache_hits = 0
        self.trace_ns_total = 0
        self._kernel_traces: Dict[str, int] = {}
        self._kernel_trace_ns: Dict[str, int] = {}
        self._key_rows: Dict[str, List[dict]] = {}
        self._trace_ts: deque = deque()  # monotonic stamps for storm window
        self.storms = 0
        self.last_storm: Optional[dict] = None
        self._last_storm_mono = -1e18
        # dispatch accounting
        self.dispatches = 0
        self.items_total = 0
        self.padded_total = 0
        self.fused_total = 0
        self.fallback_total = 0
        self._rollups: deque = deque(maxlen=self.rollup_max)
        # upload accounting
        self.upload_counts = {"delta": 0, "full": 0}
        self.upload_bytes = {"delta": 0, "full": 0}
        # pad floor (reported by the matcher at prewarm/floor change)
        self.pad_floor = 1
        # dump bookkeeping
        self.dumps_log: deque = deque(maxlen=16)
        self.last_dump: Optional[dict] = None
        self._last_dump_mono: Dict[str, float] = {}

    # ------------------------------------------------------------ lifecycle
    def configure(self, **kw: Any) -> None:
        """Apply [observability] device knobs (ServerContext / bench).
        Counters survive a reconfigure; only a ``ring`` change rebuilds the
        flight ring (keeping the newest records that still fit)."""
        with self._lock:
            for name in ("enabled", "dump_dir", "telemetry", "hbm_provider"):
                if name in kw:
                    setattr(self, name, kw[name])
            if "storm_n" in kw:
                self.storm_n = max(2, int(kw["storm_n"]))
            if "storm_window" in kw:
                self.storm_window = max(0.1, float(kw["storm_window"]))
            if "interval_s" in kw:
                self.interval_s = max(0.1, float(kw["interval_s"]))
            if "ring" in kw and int(kw["ring"]) != self.ring_cap:
                self.ring_cap = max(1, int(kw["ring"]))
                self.flight_ring = deque(self.flight_ring,
                                         maxlen=self.ring_cap)
            if ("rollup_max" in kw
                    and max(2, int(kw["rollup_max"])) != self.rollup_max):
                self.rollup_max = max(2, int(kw["rollup_max"]))
                self._rollups = deque(self._rollups,
                                      maxlen=self.rollup_max)

    def reset(self) -> None:
        """Drop every counter/ring (tests; the registry is process-global,
        so accumulated state would otherwise leak across test cases)."""
        with self._lock:
            self._reset_state(self.ring_cap)

    # ------------------------------------------------------- shape keys
    @staticmethod
    def key_of(args: tuple, kwargs: dict) -> Tuple:
        """Shape key of one jit call: (shape, dtype) per array argument +
        the static kwargs, i.e. exactly the signature ``jax.jit`` caches
        executables on — so registry membership predicts hit-vs-trace."""

        def k(v: Any) -> Any:
            shape = getattr(v, "shape", None)
            if shape is not None:
                return (tuple(shape), str(getattr(v, "dtype", "")))
            if isinstance(v, (tuple, list)):
                return tuple(k(x) for x in v)
            if isinstance(v, (int, float, str, bool)) or v is None:
                return v
            return repr(v)

        return tuple(k(a) for a in args) + tuple(
            (n, k(v)) for n, v in sorted(kwargs.items()))

    def note_jit(self, kernel: str, key: Tuple, dur_ns: int) -> bool:
        """Record one jit-seam call. → True iff this (kernel, key) was a
        never-seen signature (a trace+compile). Called only when enabled
        (call sites guard on ``.enabled``)."""
        sig = (kernel, key)
        storm: Optional[dict] = None
        with self._lock:
            if sig in self._seen:
                self.cache_hits += 1
                return False
            self._seen.add(sig)
            self.traces += 1
            self.trace_ns_total += dur_ns
            self._kernel_traces[kernel] = self._kernel_traces.get(kernel, 0) + 1
            self._kernel_trace_ns[kernel] = (
                self._kernel_trace_ns.get(kernel, 0) + dur_ns)
            rows = self._key_rows.setdefault(kernel, [])
            if len(rows) < _KEY_ROWS_MAX:
                rows.append({"key": repr(key), "trace_ms": round(dur_ns / 1e6, 3),
                             "ts": round(time.time(), 3)})
            self._rollup().traces += 1
            # storm window: a burst of distinct signatures means the shape
            # discipline (pad floor, pow2 NC, sticky budgets) broke down
            now = time.monotonic()
            self._trace_ts.append(now)
            horizon = now - self.storm_window
            while self._trace_ts and self._trace_ts[0] < horizon:
                self._trace_ts.popleft()
            if (len(self._trace_ts) >= self.storm_n
                    and now - self._last_storm_mono >= self.storm_window):
                self.storms += 1
                self._last_storm_mono = now
                storm = self.last_storm = {
                    "ts": round(time.time(), 3),
                    "traces_in_window": len(self._trace_ts),
                    "window_s": self.storm_window,
                    "kernel": kernel,
                    "key": repr(key),
                }
        if storm is not None:
            _LOG.warning(
                "device RETRACE STORM: %d jit traces in %.1fs (last: %s %s) "
                "— shape discipline broke down (pad floor / pow2 padding)",
                storm["traces_in_window"], storm["window_s"], kernel,
                storm["key"])
            self._annotate_ring("device.retrace_storm", storm)
            self.auto_dump("retrace_storm")
        return True

    # ------------------------------------------------------- dispatch ring
    def _rollup(self) -> _Rollup:
        """Current interval bucket (caller holds the lock). The bucket key
        must keep the interval's resolution — int() truncation collapsed
        every sub-second interval onto 1s buckets, which silently starved
        any consumer windowing finer than a second (the autotuner's bench
        cadence)."""
        t = round(time.time() // self.interval_s * self.interval_s, 3)
        if not self._rollups or self._rollups[-1].t != t:
            self._rollups.append(_Rollup(t))
        return self._rollups[-1]

    def note_dispatch(self, rec: dict, dispatch_ns: int) -> None:
        """One completed logical dispatch: flight-ring record + rollup.
        ``dispatch_ns`` is the ACTIVE dispatch-path wall time (submit work
        + complete work, excluding the pipeline park in between)."""
        trace = CURRENT_TRACE.get()
        if trace is not None:
            rec["trace"] = trace.tid
        rec["total_ms"] = round(dispatch_ns / 1e6, 3)
        with self._lock:
            self.dispatches += 1
            self.items_total += rec.get("batch", 0)
            self.padded_total += rec.get("padded", 0)
            if rec.get("fused"):
                self.fused_total += 1
            else:
                self.fallback_total += 1
            r = self._rollup()
            r.dispatches += 1
            r.items += rec.get("batch", 0)
            r.padded += rec.get("padded", 0)
            r.hist.record(dispatch_ns)
            if not rec.get("traces"):
                r.whist.record(dispatch_ns)
            r.bhist.record(rec.get("batch", 0))
            if rec.get("fused"):
                r.fused += 1
            else:
                r.fallback += 1
            # under the lock: configure(ring=...) swaps the deque object,
            # and an append racing the swap would land on the orphan
            self.flight_ring.append(rec)

    def note_abandoned(self, rec: dict) -> None:
        """A submit whose handle was never completed: the record reaches
        the flight ring (submit-half data only, marked) but counts toward
        NO dispatch/rollup totals and carries no trace id — stamping the
        flushing publish's context onto a stale record would send an
        operator to the wrong publish."""
        rec["abandoned"] = True
        with self._lock:
            self.flight_ring.append(rec)

    def note_upload(self, kind: str, nbytes: int) -> None:
        """One device upload ('delta' scatter or 'full' repack+put)."""
        with self._lock:
            self.upload_counts[kind] = self.upload_counts.get(kind, 0) + 1
            self.upload_bytes[kind] = self.upload_bytes.get(kind, 0) + nbytes
            r = self._rollup()
            if kind == "delta":
                r.delta_bytes += nbytes
            else:
                r.full_bytes += nbytes

    def note_pad_floor(self, floor: int, old: int) -> None:
        """The matcher latched a new sticky pad floor (prewarm / change):
        log it with the current cumulative waste fraction and annotate the
        slow ring, so the cfg1 small-batch regime shows WHY it pays what
        it pays. Tracks the reported value directly — the autotuner's
        ladder LOWERS the floor too (broker/autotune.py), so a monotonic
        max here would misreport the live setting."""
        with self._lock:
            self.pad_floor = max(1, floor)
            waste = (round(1.0 - self.items_total / self.padded_total, 4)
                     if self.padded_total else 0.0)
        _LOG.info(
            "sticky pad floor %d -> %d (small batches pad up to this "
            "compiled shape; cumulative pad-waste fraction %.4f)",
            old, floor, waste)
        self._annotate_ring("device.pad_floor", {
            "floor": floor, "old": old, "pad_waste": waste})

    def rollup_summary(self, since: Optional[float] = None,
                       n: Optional[int] = None) -> dict:
        """Rollup CONSUMER API (the autotuner's signal source): merge the
        interval buckets at/after ``since`` (or the newest ``n``; the
        newest 6 by default) into one window summary — dispatch count,
        pad-waste fraction, dispatch p50/p99 and the batch-size quantiles,
        upload bytes, fused/fallback share, traces. Cheaper than
        ``snapshot()`` (no kernel tables, no HBM provider call — the
        provider may read the CUDA allocator) so a controller can poll
        it every few seconds."""
        with self._lock:
            rolls = list(self._rollups)
        if since is not None:
            rolls = [r for r in rolls if r.t + self.interval_s > since]
        elif n is not None:
            rolls = rolls[-max(0, n):]
        else:
            rolls = rolls[-6:]
        hist = Histogram()
        whist = Histogram()
        bhist = Histogram()
        out = {"intervals": len(rolls), "dispatches": 0, "items": 0,
               "padded": 0, "traces": 0, "fused": 0, "fallback": 0,
               "delta_bytes": 0, "full_bytes": 0}
        for r in rolls:
            out["dispatches"] += r.dispatches
            out["items"] += r.items
            out["padded"] += r.padded
            out["traces"] += r.traces
            out["fused"] += r.fused
            out["fallback"] += r.fallback
            out["delta_bytes"] += r.delta_bytes
            out["full_bytes"] += r.full_bytes
            hist.merge(r.hist)
            whist.merge(r.whist)
            bhist.merge(r.bhist)
        out["pad_waste"] = (round(1.0 - out["items"] / out["padded"], 4)
                            if out["padded"] else 0.0)
        out["p50_ms"] = round(hist.quantile(0.50) / 1e6, 3)
        out["p99_ms"] = round(hist.quantile(0.99) / 1e6, 3)
        out["warm_dispatches"] = whist.count
        out["warm_p99_ms"] = round(whist.quantile(0.99) / 1e6, 3)
        out["batch_p50"] = int(bhist.quantile(0.50))
        out["batch_p99"] = int(bhist.quantile(0.99))
        # the merged window's sparse batch histogram (upper-bound key →
        # count, same encoding as _Rollup.row) so consumers that merge
        # summaries (history samples, the offline fitter) keep the
        # mergeable-by-addition property
        out["batch_hist"] = {
            str(Histogram.bucket_upper(i)): c
            for i, c in enumerate(bhist.counts) if c
        }
        return out

    def _annotate_ring(self, op: str, detail: dict) -> None:
        """Slow-op ring annotation (the timeline operators read for stalls
        — same pattern as overload/failover/slo transitions)."""
        tele = self.telemetry
        if tele is not None and getattr(tele, "enabled", False):
            tele.slow_ops.append({
                "op": op, "ms": 0.0, "ts": round(time.time(), 3),
                "detail": detail,
            })

    # ------------------------------------------------------------ HBM model
    @staticmethod
    def live_device_arrays() -> Optional[dict]:
        """Reconciliation source: the CUDA caching allocator's census of
        the current device (``torch.cuda.memory_allocated`` /
        ``memory_stats``). None without CUDA (the model stands alone)."""
        import torch

        if not torch.cuda.is_available():
            return None
        ms = torch.cuda.memory_stats()
        return {
            "live_arrays": int(ms.get("active.all.current", 0)),
            "live_arrays_bytes": int(torch.cuda.memory_allocated()),
            "device_bytes_in_use": int(ms.get("reserved_bytes.all.current", 0)),
        }

    def hbm_snapshot(self) -> dict:
        """Occupancy model (matcher-reported breakdown) reconciled against
        the allocator's census. ``modeled ≤ live`` always holds — the
        allocator holds more than the table (topic uploads in flight, the
        fused tail's buffers) — and
        a modeled total far ABOVE live means the model went stale."""
        out: dict = {"modeled_bytes": 0}
        provider = self.hbm_provider
        if provider is not None:
            try:
                bd = provider() or {}
                out.update(bd)
                out["modeled_bytes"] = int(bd.get("total_bytes", 0))
            except Exception as e:  # a dead weak provider must not 500 /device
                out["provider_error"] = str(e)
        live = self.live_device_arrays()
        if live:
            out.update(live)
        return out

    # ------------------------------------------------------------ surfaces
    def snapshot(self) -> dict:
        """The `/api/v1/device` body: shape-stable whether enabled or not
        (zeros everywhere before any dispatch / with the profiler off)."""
        with self._lock:
            kernels = {
                k: {
                    "traces": self._kernel_traces[k],
                    "trace_ms": round(self._kernel_trace_ns.get(k, 0) / 1e6, 3),
                    "keys": sorted(self._key_rows.get(k, []),
                                   key=lambda r: -r["trace_ms"])[:8],
                }
                for k in sorted(self._kernel_traces)
            }
            rollups = [r.row() for r in self._rollups]
            recent = Histogram()
            for r in list(self._rollups)[-6:]:
                recent.merge(r.hist)
            snap = {
                "enabled": self.enabled,
                "compile": {
                    "traces": self.traces,
                    "cache_hits": self.cache_hits,
                    "trace_ms_total": round(self.trace_ns_total / 1e6, 3),
                    "storms": self.storms,
                    "last_storm": self.last_storm,
                    "storm_n": self.storm_n,
                    "storm_window_s": self.storm_window,
                    "kernels": kernels,
                },
                "dispatch": {
                    "dispatches": self.dispatches,
                    "items": self.items_total,
                    "padded_items": self.padded_total,
                    "pad_waste": round(
                        1.0 - self.items_total / self.padded_total, 4)
                    if self.padded_total else 0.0,
                    "pad_floor": self.pad_floor,
                    "fused": self.fused_total,
                    "fallback": self.fallback_total,
                    "p50_ms": round(recent.quantile(0.50) / 1e6, 3),
                    "p99_ms": round(recent.quantile(0.99) / 1e6, 3),
                    "interval_s": self.interval_s,
                    "rollups": rollups,
                },
                "uploads": {
                    "delta": self.upload_counts.get("delta", 0),
                    "full": self.upload_counts.get("full", 0),
                    "delta_bytes": self.upload_bytes.get("delta", 0),
                    "full_bytes": self.upload_bytes.get("full", 0),
                },
                "flight_len": len(self.flight_ring),
                "flight_cap": self.ring_cap,
                "dumps": list(self.dumps_log),
            }
        snap["hbm"] = self.hbm_snapshot()
        return snap

    def flight(self) -> List[dict]:
        with self._lock:  # concurrent ring appends (executor threads)
            return list(self.flight_ring)

    @staticmethod
    def merge_snapshots(base: dict, others: List[dict]) -> dict:
        """Cluster merge (`/api/v1/device/sum`): counters sum, pad waste is
        recomputed from the summed item/padded totals, HBM bytes sum to a
        fleet total. Per-kernel key detail stays per-node (fetch each
        node's `/api/v1/device` for it)."""
        others = list(others)
        out = {
            "nodes": 1 + len(others),
            "enabled": bool(base.get("enabled", False)),
            "compile": {"traces": 0, "cache_hits": 0, "trace_ms_total": 0.0,
                        "storms": 0},
            "dispatch": {"dispatches": 0, "items": 0, "padded_items": 0,
                         "fused": 0, "fallback": 0},
            "uploads": {"delta": 0, "full": 0, "delta_bytes": 0,
                        "full_bytes": 0},
            "hbm": {"modeled_bytes": 0},
        }
        for snap in [base, *others]:
            c = snap.get("compile") or {}
            for k in out["compile"]:
                out["compile"][k] = round(out["compile"][k] + c.get(k, 0), 3)
            d = snap.get("dispatch") or {}
            for k in out["dispatch"]:
                out["dispatch"][k] += d.get(k, 0)
            u = snap.get("uploads") or {}
            for k in out["uploads"]:
                out["uploads"][k] += u.get(k, 0)
            out["hbm"]["modeled_bytes"] += (snap.get("hbm") or {}).get(
                "modeled_bytes", 0)
        padded = out["dispatch"]["padded_items"]
        out["dispatch"]["pad_waste"] = (
            round(1.0 - out["dispatch"]["items"] / padded, 4) if padded
            else 0.0)
        return out

    def prometheus_lines(self, labels: str) -> List[str]:
        """`rmqtt_device_*` exposition families (grammar-pinned by the
        scrape test like every other exporter)."""
        with self._lock:
            kt = dict(self._kernel_traces)
            rows = [
                ("rmqtt_device_jit_traces_total", "counter", self.traces),
                ("rmqtt_device_jit_cache_hits_total", "counter",
                 self.cache_hits),
                ("rmqtt_device_jit_trace_seconds_total", "counter",
                 format(self.trace_ns_total * 1e-9, "g")),
                ("rmqtt_device_retrace_storms_total", "counter", self.storms),
                ("rmqtt_device_dispatches_total", "counter", self.dispatches),
                ("rmqtt_device_fused_dispatches_total", "counter",
                 self.fused_total),
                ("rmqtt_device_upload_delta_bytes_total", "counter",
                 self.upload_bytes.get("delta", 0)),
                ("rmqtt_device_upload_full_bytes_total", "counter",
                 self.upload_bytes.get("full", 0)),
                ("rmqtt_device_pad_waste_ratio", "gauge",
                 round(1.0 - self.items_total / self.padded_total, 4)
                 if self.padded_total else 0.0),
                ("rmqtt_device_pad_floor", "gauge", self.pad_floor),
            ]
        out: List[str] = []
        for name, typ, val in rows:
            out.append(f"# TYPE {name} {typ}")
            out.append(f"{name}{{{labels}}} {val}")
        hbm = self.hbm_snapshot()
        out.append("# TYPE rmqtt_device_hbm_modeled_bytes gauge")
        out.append(f"rmqtt_device_hbm_modeled_bytes{{{labels}}} "
                   f"{hbm.get('modeled_bytes', 0)}")
        if kt:
            out.append("# TYPE rmqtt_device_kernel_traces_total counter")
            for kernel, n in sorted(kt.items()):
                out.append(
                    f'rmqtt_device_kernel_traces_total{{{labels},'
                    f'kernel="{prom_sanitize(kernel)}"}} {n}')
        return out

    # ------------------------------------------------------------- dumping
    def dump(self, reason: str) -> dict:
        """Freeze the flight recorder + snapshot into one artifact dict."""
        return {
            "schema": DUMP_SCHEMA,
            "reason": reason,
            "ts": round(time.time(), 3),
            "snapshot": self.snapshot(),
            "flight": self.flight(),
        }

    def dump_to(self, path: str, reason: str) -> Optional[str]:
        """Write a dump artifact; → the path, or None on failure (a dump
        must never take the caller down with it)."""
        try:
            d = self.dump(reason)
            dirname = os.path.dirname(path)
            if dirname:
                os.makedirs(dirname, exist_ok=True)
            with open(path, "w") as f:
                json.dump(d, f, indent=1)
            self.last_dump = d
            self.dumps_log.append({"reason": reason, "ts": d["ts"],
                                   "path": path})
            _LOG.warning("device flight recorder dumped (%s) -> %s",
                         reason, path)
            return path
        except Exception as e:  # pragma: no cover - disk-full etc.
            _LOG.warning("flight-recorder dump failed (%s): %s", reason, e)
            return None

    def auto_dump(self, reason: str) -> None:
        """Event-triggered dump (failover trip / fused-verify disagreement /
        retrace storm). Rate-limited per reason so a flapping trigger can't
        spam the disk, and OFFLOADED to a daemon thread: the triggers fire
        from the asyncio event loop (failover transition) and the match hot
        path (storm in note_jit) — serializing the ring + a disk write
        there would stall the broker at exactly its worst moment. With no
        ``dump_dir`` the artifact stays in memory (``last_dump``) and on
        the dumps log."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump_mono.get(reason, -1e18) < 30.0:
                return
            self._last_dump_mono[reason] = now
        try:
            threading.Thread(target=self._auto_dump_now, args=(reason,),
                             name="rmqtt-devprof-dump", daemon=True).start()
        except Exception as e:  # pragma: no cover - thread exhaustion
            _LOG.warning("flight-recorder auto-dump thread failed (%s): %s",
                         reason, e)

    def _auto_dump_now(self, reason: str) -> None:
        if self.dump_dir:
            path = os.path.join(
                self.dump_dir,
                f"devprof_{prom_sanitize(reason)}_{int(time.time())}.json")
            self.dump_to(path, reason)
            return
        self.last_dump = self.dump(reason)
        self.dumps_log.append({"reason": reason,
                               "ts": self.last_dump["ts"], "path": None})
        _LOG.warning("device flight recorder dumped in memory (%s); set "
                     "RMQTT_DEVPROF_DIR for an on-disk artifact", reason)


#: process-global instance — matchers guard on ``DEVPROF.enabled`` (one
#: attribute check per jit seam when off); the broker configures it from
#: the [observability] section, the bench enables it directly
DEVPROF = DeviceProfiler(
    enabled=os.environ.get("RMQTT_DEVICE_PROFILE", "") == "1",
    dump_dir=os.environ.get("RMQTT_DEVPROF_DIR") or None,
)
