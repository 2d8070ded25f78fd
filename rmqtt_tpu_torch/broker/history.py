"""Unified telemetry history: the broker's black-box flight recorder.

Every plane is instrumented — latency histograms, devprof,
hostprof, overload/SLO state machines, the autotune journal — but
each keeps its own short in-memory rollup ring: nothing is queryable
*across* planes, and nothing survives a restart. Regressions surface as
trends across phases, not point snapshots (the IoT-broker benchmarking
literature is unanimous on this), so "what changed at time T" needs a
timeline, not eight disconnected `/api/v1/*` bodies.

This service closes that gap with one fixed-interval collector that
snapshots every plane into a single schema'd sample row
(``rmqtt_tpu_torch.history_sample/1``):

- every ``stats()`` gauge (the cross-plane shape-stable surface);
- tracked ``metrics`` counters delta-encoded into per-second ``.rate``
  series (a cumulative counter is useless on a timeline; its rate is the
  signal);
- devprof/hostprof rollup summaries since the previous sample
  (dispatch p50/p99, pad waste + the mergeable batch histogram; loop lag,
  GC pauses, blocking incidents);
- per-objective SLO burn rates, and the collector's own cost
  (``history.collect_ms`` — which the ``history.collect`` failpoint can
  inflate, giving chaos drills a provokable latency step).

Samples land in a bounded in-memory ring *and*, when ``history_dir`` is
set, in CRC-framed on-disk segment files (``seg-NNNNNNNNNN.hist``) with
rotation + retention — the exact framing discipline of the
durability journal (``frame_record``/``decode_record``), so a kill-9
mid-append loses at most the torn tail and a cold start reads every
intact frame back into the ring.

On top of the timeline:

- **Range queries** — ``GET /api/v1/history?series=&from=&to=&step=``
  with step-bucket downsampling, and ``/api/v1/history/sum`` merging
  node timelines over the existing ``what=`` DATA-query path (counters
  sum, ``*_ms``/``*_p50``/``*_p99``/``.rate`` average, sparse bucket
  histograms key-add, ``*_state`` takes the worst).
- **Anomaly annotation** — per-tracked-series EWMA mean + EWMA absolute
  deviation (a robust MAD-style scale); a breach lands a row on the
  shared slow-op ring (the cross-plane correlation timeline
  ops_doctor joins), fires the ``SERVER_ANOMALY`` hook
  (``SERVER_SLO``-style), bumps ``rmqtt_history_anomalies_total{series}``
  and records which devprof/hostprof auto-dumps landed in the same
  window — the "p99 stepped 2.1x, 3 s after a retrace storm" join
  becomes mechanical.

House pattern: ``[observability] history_*`` knobs, default ON with a
pinned low-overhead budget (``bench.py --config 17`` bounds the
collector at <=2% on the publish path); ``history = false`` costs one
attribute check and every surface stays shape-stable.
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import struct
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.durability import decode_record, frame_record
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS

log = logging.getLogger("rmqtt_tpu_torch.history")

SCHEMA = "rmqtt_tpu_torch.history_sample/1"

_FP_COLLECT = FAILPOINTS.register("history.collect")

#: segment file naming — monotonic sequence number, lexicographic sort ==
#: chronological sort (the recovery scan depends on it)
_SEG_RE = re.compile(r"^seg-(\d{10})\.hist$")

#: metrics counters whose per-second rate rides the sample (dotted names
#: from broker/metrics.py Metrics; the timeline wants rates, not totals)
RATE_COUNTERS = ("publish.received", "messages.delivered",
                 "messages.dropped")

#: series watched by the anomaly annotator. Every entry must be a key the
#: collector actually emits; zero-change series never breach (the EWMA
#: residual is exactly 0 and the deviation floor is strictly positive)
TRACKED_SERIES = (
    "publish_e2e_p99_ms",
    "routing_match_p99_ms",
    "host_loop_lag_p99_ms",
    "device.p99_ms",
    "history.collect_ms",
    "rss_mb",
    "publish.received.rate",
    "hotkeys_top1_share",
)

#: devprof/hostprof auto-dumps within this many seconds of a breach are
#: attached to the anomaly row by reference (path + reason)
DUMP_CORRELATE_WINDOW_S = 30.0


def _merge_value(key: str, values: List[Any]):
    """One downsample/cluster-merge cell: how N values of series ``key``
    combine. Shared by step-bucketing and /sum so a downsampled local
    query and a cluster merge agree on semantics."""
    dicts = [v for v in values if isinstance(v, dict)]
    if dicts:  # sparse bucket histogram (e.g. device.batch_hist): key-add
        out: Dict[str, int] = {}
        for d in dicts:
            for k, c in d.items():
                try:
                    out[k] = out.get(k, 0) + int(c)
                except (TypeError, ValueError):
                    continue
        return out
    nums = [v for v in values if isinstance(v, (int, float))]
    if not nums:
        return values[0] if values else None
    if key.endswith("_state") or key.endswith("_state_value"):
        return max(nums)  # worst state wins
    return round(sum(nums) / len(nums), 3)


def _sum_value(key: str, values: List[Any]):
    """Cluster-merge cell (/sum): like :func:`_merge_value` but counters
    SUM across nodes; quantiles/averages/rates stay averaged, states
    stay worst-of."""
    dicts = [v for v in values if isinstance(v, dict)]
    if dicts:
        return _merge_value(key, values)
    nums = [v for v in values if isinstance(v, (int, float))]
    if not nums:
        return values[0] if values else None
    if key.endswith("_state") or key.endswith("_state_value"):
        return max(nums)
    if (key.endswith(("_ms", "_p50", "_p99", "_ema", ".rate", "_waste",
                      "_burn", "_share"))
            or key == "t"):
        return round(sum(nums) / len(nums), 3)
    total = sum(nums)
    return round(total, 3) if isinstance(total, float) else total


class _Baseline:
    """Per-series EWMA mean + EWMA absolute deviation (a streaming
    MAD-style scale estimate — robust to single spikes, adapts after a
    sustained level shift so one regression is one episode, not an
    alarm that never clears)."""

    __slots__ = ("mean", "dev", "n")

    def __init__(self) -> None:
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0

    def observe(self, x: float, alpha: float = 0.3
                ) -> Tuple[bool, float, float]:
        """Feed one sample → (breach_possible_residual, mean, dev) BEFORE
        the baseline absorbs ``x`` (detection precedes adaptation)."""
        if self.n == 0:
            self.mean = x
        resid = abs(x - self.mean)
        mean, dev = self.mean, self.dev
        self.dev = (1 - alpha) * self.dev + alpha * resid
        self.mean = (1 - alpha) * self.mean + alpha * x
        self.n += 1
        return resid, mean, dev


class HistoryService:
    """Broker-wide telemetry timeline: collector + ring + segments +
    range queries + anomaly annotation. Constructed unconditionally by
    ``ServerContext`` (shape-stable surfaces); everything is a no-op
    behind one ``enabled`` check when ``[observability] history=false``."""

    def __init__(self, ctx, cfg) -> None:
        self.ctx = ctx
        self.enabled = bool(cfg.history_enable)
        self.interval_s = max(0.5, float(cfg.history_interval_s))
        self.dir = str(cfg.history_dir or "")
        self.segment_rows = max(16, int(cfg.history_segment_rows))
        self.retention_segments = max(1, int(cfg.history_retention_segments))
        self.anomaly_enable = bool(cfg.history_anomaly_enable)
        self.anomaly_k = max(1.0, float(cfg.history_anomaly_k))
        self.anomaly_warmup = max(2, int(cfg.history_anomaly_warmup))
        self.ring: deque = deque(maxlen=max(8, int(cfg.history_ring_max)))
        self.anomalies: deque = deque(maxlen=256)
        # counters (the stats()/Prometheus surface)
        self.samples_total = 0
        self.anomalies_total: Dict[str, int] = {s: 0 for s in TRACKED_SERIES}
        self.segments_written = 0
        self.recovered_rows = 0
        self.torn_tails = 0
        self.retention_deleted = 0
        # collector state
        self._task: Optional[asyncio.Task] = None
        self._last_counters: Dict[str, int] = {}
        self._last_t: Optional[float] = None
        self._baselines: Dict[str, _Baseline] = {}
        # segment writer state
        self._fh = None
        self._seg_seq = 0
        self._seg_rows = 0
        if self.enabled and self.dir:
            self._recover()
            self._open_segment()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Arm the collector task on the RUNNING loop (sync, like every
        plane armed from ``ServerContext.start``). Disabled = no-op."""
        if not self.enabled:
            return
        if self._task is not None and not self._task.done():
            return
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name="history-collector")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._close_segment()

    async def _run(self) -> None:
        # sample at tick START (then sleep): the timeline's first row
        # lands at broker start, and a short-lived arm window (tests,
        # the cfg17 paired bench) still contains a real collection
        while True:
            try:
                self.collect_once()
            except Exception:
                log.exception("history collection failed")
            await asyncio.sleep(self.interval_s)

    # ------------------------------------------------------------ collector
    def collect_once(self) -> Optional[dict]:
        """Take one sample NOW: snapshot every plane into a flat row,
        append it to the ring (+ segment), run the anomaly pass. Public
        and synchronous so tests and drills drive ticks directly."""
        if not self.enabled:
            return None
        t0 = time.perf_counter()
        if _FP_COLLECT.action is not None:  # chaos seam: a provokable
            _FP_COLLECT.fire_sync()         # collector latency step
        now = time.time()
        row: Dict[str, Any] = {"t": round(now, 3)}
        row.update(self.ctx.stats().to_json())
        # counter deltas → per-second rates
        dt = (now - self._last_t) if self._last_t else None
        for name in RATE_COUNTERS:
            cur = self.ctx.metrics.get(name)
            prev = self._last_counters.get(name)
            rate = 0.0
            if dt and dt > 0 and prev is not None:
                rate = max(0.0, (cur - prev) / dt)
            row[name + ".rate"] = round(rate, 3)
            self._last_counters[name] = cur
        # device plane: the window summary since the previous sample
        try:
            from rmqtt_tpu_torch.broker.devprof import DEVPROF

            dv = DEVPROF.rollup_summary(since=self._last_t)
            for k in ("dispatches", "items", "padded", "pad_waste",
                      "p50_ms", "p99_ms", "traces", "batch_hist"):
                if k in dv:
                    row["device." + k] = dv[k]
        except Exception:
            pass
        # host plane: loop lag / GC / blocking over the same window
        try:
            from rmqtt_tpu_torch.broker.hostprof import HOSTPROF

            hv = HOSTPROF.rollup_summary(since=self._last_t)
            for k in ("ticks", "laggy", "lag_p50_ms", "lag_p99_ms",
                      "gc_pauses", "gc_pause_ms", "blocked"):
                if k in hv:
                    row["host." + k] = hv[k]
        except Exception:
            pass
        # hot-key attribution (broker/hotkeys.py): top-1/top-8 share +
        # distinct-key estimate per key space — a sudden skew shift
        # (hotkeys_top1_share is a tracked series) is the earliest
        # noisy-neighbor signal, often ahead of any latency breach
        try:
            hk = getattr(self.ctx, "hotkeys", None)
            if hk is not None and hk.enabled:
                hv = hk.history_summary()
                row["hotkeys_top1_share"] = hv.pop("top1_share", 0.0)
                for k, v in hv.items():
                    row["hotkeys." + k] = v
        except Exception:
            pass
        # SLO burn rates per objective (slo_state already rides stats())
        try:
            for obj in self.ctx.slo.snapshot().get("objectives") or ():
                name = obj.get("name")
                if not name:
                    continue
                row[f"slo.{name}.fast_burn"] = float(
                    (obj.get("fast") or {}).get("burn_rate", 0.0))
                row[f"slo.{name}.slow_burn"] = float(
                    (obj.get("slow") or {}).get("burn_rate", 0.0))
        except Exception:
            pass
        row["history.collect_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        self._last_t = now
        self.ring.append(row)
        self.samples_total += 1
        self._persist(["s", row])
        if self.anomaly_enable:
            self._annotate(row)
        return row

    # ------------------------------------------------------------ anomalies
    def _annotate(self, row: dict) -> None:
        for series in TRACKED_SERIES:
            x = row.get(series)
            if not isinstance(x, (int, float)):
                continue
            bl = self._baselines.get(series)
            if bl is None:
                bl = self._baselines[series] = _Baseline()
            n_before = bl.n
            resid, mean, dev = bl.observe(float(x))
            if n_before < self.anomaly_warmup:
                continue
            # strictly positive scale floor: a flat series (dev -> 0) can
            # never breach, and tiny baselines don't alarm on noise
            devf = max(dev, 0.05 * abs(mean), 1e-3)
            if resid <= self.anomaly_k * devf:
                continue
            anomaly = {
                "ts": row["t"],
                "series": series,
                "value": round(float(x), 3),
                "baseline": round(mean, 3),
                "dev": round(dev, 3),
                "factor": round(resid / devf, 2),
                "dumps": self._dump_refs(row["t"]),
            }
            self.anomalies.append(anomaly)
            self.anomalies_total[series] = (
                self.anomalies_total.get(series, 0) + 1)
            self._persist(["a", anomaly])
            self._fire(series, float(x), anomaly)

    @staticmethod
    def _dump_refs(ts: float,
                   window_s: float = DUMP_CORRELATE_WINDOW_S) -> List[dict]:
        """devprof/hostprof auto-dumps within the window, by reference —
        the breach row names the postmortem artifacts that explain it."""
        refs: List[dict] = []
        try:
            from rmqtt_tpu_torch.broker.devprof import DEVPROF
            from rmqtt_tpu_torch.broker.hostprof import HOSTPROF

            for plane, prof in (("device", DEVPROF), ("host", HOSTPROF)):
                for d in list(getattr(prof, "dumps_log", ()) or ()):
                    if abs(float(d.get("ts", 0)) - ts) <= window_s:
                        refs.append({"plane": plane,
                                     "reason": d.get("reason"),
                                     "path": d.get("path"),
                                     "ts": d.get("ts")})
        except Exception:
            pass
        return refs

    def _fire(self, series: str, value: float, anomaly: dict) -> None:
        """Slow-op ring row + SERVER_ANOMALY hook — the exact transition
        idiom of slo.py/overload.py, so anomalies join the shared
        correlation timeline every other plane annotates."""
        tele = getattr(self.ctx, "telemetry", None)
        if tele is not None and getattr(tele, "enabled", False):
            tele.slow_ops.append({
                "op": "history.anomaly", "ms": 0.0,
                "ts": round(time.time(), 3),
                "detail": {"series": series, "value": anomaly["value"],
                           "baseline": anomaly["baseline"],
                           "factor": anomaly["factor"],
                           "dumps": len(anomaly["dumps"])},
            })
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # collect_once() driven synchronously in tests
        loop.create_task(self.ctx.hooks.fire(
            HookType.SERVER_ANOMALY, series, value, anomaly))

    # ------------------------------------------------------------ segments
    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"seg-{seq:010d}.hist")

    def _recover(self) -> None:
        """Cold-start read-back: newest ``retention_segments`` files,
        every CRC-intact frame; the first torn/corrupt frame in a file
        drops that file's tail (the crash model — nothing framed after a
        tear is trusted). Recovered samples refill the ring so a
        restarted broker serves its pre-restart timeline."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            names = sorted(n for n in os.listdir(self.dir)
                           if _SEG_RE.match(n))
        except OSError:
            return
        for name in names:
            self._seg_seq = max(self._seg_seq,
                                int(_SEG_RE.match(name).group(1)))
        for name in names[-self.retention_segments:]:
            rows, anoms, torn = read_segment(os.path.join(self.dir, name))
            for r in rows:
                self.ring.append(r)
                self.recovered_rows += 1
            for a in anoms:
                self.anomalies.append(a)
                if a.get("series") in self.anomalies_total:
                    self.anomalies_total[a["series"]] += 1
            self.torn_tails += torn
        if self.recovered_rows:
            last = self.ring[-1]
            self._last_t = float(last.get("t") or 0) or None
            log.info("history recovered %d sample(s), %d torn tail(s) "
                     "from %s", self.recovered_rows, self.torn_tails,
                     self.dir)

    def _open_segment(self) -> None:
        self._seg_seq += 1
        try:
            self._fh = open(self._seg_path(self._seg_seq), "ab")
        except OSError:
            log.exception("history segment open failed; persistence off")
            self._fh = None
            return
        self._seg_rows = 0
        self.segments_written += 1
        self._enforce_retention()

    def _close_segment(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    def _persist(self, event: list) -> None:
        if self._fh is None:
            return
        try:
            self._fh.write(frame_record(event))
            self._fh.flush()
        except (OSError, ValueError):
            log.exception("history append failed; persistence off")
            self._close_segment()
            return
        if event[0] == "s":
            self._seg_rows += 1
            if self._seg_rows >= self.segment_rows:
                self._close_segment()
                self._open_segment()

    def _enforce_retention(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if _SEG_RE.match(n))
            for name in names[:-self.retention_segments]:
                os.unlink(os.path.join(self.dir, name))
                self.retention_deleted += 1
        except OSError:
            pass

    # -------------------------------------------------------------- queries
    def query(self, series=None, frm=None, to=None, step=None) -> dict:
        """The `/api/v1/history` body: ring samples filtered to
        [from, to], optionally projected to ``series`` (comma-separated;
        ``t`` always rides) and step-bucket downsampled (numeric avg,
        ``*_state`` worst, sparse histograms key-add). Shape-stable when
        disabled: same keys, empty timelines."""
        samples = [dict(r) for r in self.ring]
        anomalies = list(self.anomalies)
        try:
            lo = float(frm) if frm not in (None, "") else None
            hi = float(to) if to not in (None, "") else None
            step_s = float(step) if step not in (None, "") else None
        except (TypeError, ValueError):
            lo = hi = step_s = None
        if lo is not None:
            samples = [r for r in samples if r["t"] >= lo]
            anomalies = [a for a in anomalies if a["ts"] >= lo]
        if hi is not None:
            samples = [r for r in samples if r["t"] <= hi]
            anomalies = [a for a in anomalies if a["ts"] <= hi]
        names: Optional[List[str]] = None
        if series:
            names = [s.strip() for s in str(series).split(",") if s.strip()]
            samples = [
                {"t": r["t"], **{k: r[k] for k in names if k in r}}
                for r in samples
            ]
        if step_s and step_s > 0:
            buckets: Dict[int, List[dict]] = {}
            for r in samples:
                buckets.setdefault(int(r["t"] // step_s), []).append(r)
            down = []
            for b in sorted(buckets):
                rows = buckets[b]
                keys = {k for r in rows for k in r if k != "t"}
                out = {"t": round(b * step_s, 3), "n": len(rows)}
                for k in sorted(keys):
                    out[k] = _merge_value(
                        k, [r[k] for r in rows if k in r])
                down.append(out)
            samples = down
        return {
            "schema": SCHEMA,
            "enabled": self.enabled,
            "interval_s": self.interval_s,
            "node": getattr(self.ctx.cfg, "node_id", 0),
            "count": len(samples),
            "samples": samples,
            "anomalies": anomalies,
            "series": names,
            "step": step_s,
            "persistence": {
                "dir": self.dir or None,
                "segments_written": self.segments_written,
                "recovered_rows": self.recovered_rows,
                "torn_tails": self.torn_tails,
            },
        }

    @staticmethod
    def merge_snapshots(base: dict, others: List[dict]) -> dict:
        """Cluster merge (`/api/v1/history/sum`): node timelines align on
        step buckets (the query ``step`` or the collection interval);
        within a bucket counters SUM, ``*_ms``/quantile/``.rate`` series
        average, sparse bucket histograms key-add and ``*_state`` takes
        the worst. Anomalies concatenate (they are per-node facts)."""
        snaps = [base, *list(others)]
        step = (base.get("step") or base.get("interval_s") or 5.0)
        buckets: Dict[int, List[dict]] = {}
        for snap in snaps:
            for r in snap.get("samples") or ():
                if isinstance(r, dict) and isinstance(
                        r.get("t"), (int, float)):
                    buckets.setdefault(int(r["t"] // step), []).append(r)
        samples = []
        for b in sorted(buckets):
            rows = buckets[b]
            keys = {k for r in rows for k in r if k not in ("t", "n")}
            out: Dict[str, Any] = {"t": round(b * step, 3), "n": len(rows)}
            for k in sorted(keys):
                out[k] = _sum_value(k, [r[k] for r in rows if k in r])
            samples.append(out)
        anomalies = sorted(
            (dict(a, node=snap.get("node", i))
             for i, snap in enumerate(snaps)
             for a in snap.get("anomalies") or ()),
            key=lambda a: a.get("ts", 0))
        return {
            "schema": SCHEMA,
            "nodes": len(snaps),
            "enabled": any(s.get("enabled") for s in snaps),
            "step": step,
            "count": len(samples),
            "samples": samples,
            "anomalies": anomalies,
        }

    # ------------------------------------------------------------- surfaces
    def snapshot(self) -> dict:
        """Small gauge block for ``ServerContext.stats()``."""
        return {
            "samples": self.samples_total,
            "anomalies": sum(self.anomalies_total.values()),
            "segments": self.segments_written,
            "recovered_rows": self.recovered_rows,
        }

    def prometheus_lines(self, labels: str) -> List[str]:
        """Exposition counters. One ``{series=...}`` row per tracked
        series, zeros included — the scrape shape never depends on which
        series happened to breach."""
        out = [
            "# TYPE rmqtt_history_samples_recorded_total counter",
            f"rmqtt_history_samples_recorded_total{{{labels}}} "
            f"{self.samples_total}",
            "# TYPE rmqtt_history_anomalies_total counter",
        ]
        for series in TRACKED_SERIES:
            out.append(
                f'rmqtt_history_anomalies_total{{{labels},'
                f'series="{series}"}} {self.anomalies_total.get(series, 0)}')
        return out


# ---------------------------------------------------------------- offline
def read_segment(path: str) -> Tuple[List[dict], List[dict], int]:
    """One segment file → (samples, anomalies, torn_frames). Streaming
    frame scan: 8-byte header, exactly ``len`` payload bytes, CRC check
    via the shared ``decode_record``; the first bad frame ends the file
    (everything after a tear is untrusted). Shared by recovery and the
    offline renderers (history_report / autotune_replay / bench_trend)."""
    rows: List[dict] = []
    anomalies: List[dict] = []
    torn = 0
    try:
        with open(path, "rb") as f:
            while True:
                head = f.read(8)
                if not head:
                    break
                if len(head) < 8:
                    torn += 1
                    break
                _crc, ln = struct.unpack("<II", head)
                if ln > 1 << 24:  # corrupt length: nothing sane is 16MB
                    torn += 1
                    break
                payload = f.read(ln)
                ev = decode_record(head + payload)
                if ev is None:
                    torn += 1
                    break
                if ev[0] == "s" and len(ev) > 1 and isinstance(ev[1], dict):
                    rows.append(ev[1])
                elif ev[0] == "a" and len(ev) > 1 and isinstance(ev[1], dict):
                    anomalies.append(ev[1])
    except OSError:
        return rows, anomalies, torn + 1
    return rows, anomalies, torn


def load_dir(dirpath: str) -> Tuple[List[dict], List[dict], int]:
    """Every segment in a history dir, chronological → merged
    (samples, anomalies, torn_frames)."""
    rows: List[dict] = []
    anomalies: List[dict] = []
    torn = 0
    try:
        names = sorted(n for n in os.listdir(dirpath) if _SEG_RE.match(n))
    except OSError:
        return rows, anomalies, 0
    for name in names:
        r, a, t = read_segment(os.path.join(dirpath, name))
        rows.extend(r)
        anomalies.extend(a)
        torn += t
    return rows, anomalies, torn
