"""Distributed per-publish tracing: where did THIS publish go, and why
was it slow.

the latency telemetry (`broker/telemetry.py`) answers aggregate
questions; this layer answers per-message ones. A publish entering the
broker gets a 128-bit trace id and a per-hop span buffer; every stage the
telemetry layer already times appends a span *reusing the same
``perf_counter_ns`` reads* (the tracer converts them to wall-clock through
a per-process epoch anchor), so tracing adds allocations but no extra
clock reads on the shared stages. The context crosses the cluster as an
optional ``trace`` field on the FORWARDS / FORWARDS_TO wire bodies
(`cluster/messages.py trace_to_wire`) — spans recorded on the remote node
carry the same trace id and are stitched back together by the trace API
(`/api/v1/traces/<id>`, a ``what=traces`` DATA query per peer) — and
exits through the kafka/nats/pulsar bridge producers as an
``mqtt_trace_id`` message header.

Sampling is HEAD probabilistic plus ALWAYS-RECORD-ON-SLOW:

- a head-SAMPLED publish (probability ``trace_sample``) buffers every span
  and commits at finish;
- an UNSAMPLED publish carries only an armed context: each ``add`` is one
  threshold compare and a drop — no tuple, no id, no epoch math (the
  cfg7 overhead bound is won or lost on this path). The moment a span
  meets the shared ``[observability] slow_ms`` threshold the trace flips
  to recording: the slow span and everything after it (including the
  closing ingress span and any late delivery/ack spans) are kept and the
  trace commits — so "why was that publish slow" is answerable even at
  sample = 0, at the price of the fast spans that preceded the stall.
- the slow-op ring (`telemetry.py`) stamps the active trace id onto its
  entries, joining the two views.
- trace ids are LAZY: generated on first use (commit, cluster wire,
  bridge header, slow-ring stamp) so a fast unsampled publish never pays
  the 128-bit draw.

Disabled mode (``[observability] enable = false``): ``begin`` returns
``None`` and every call site guards on it — no trace ids, no span tuples,
no timestamps, nothing allocated (pinned by test).

The store is bounded two ways: ``trace_max_traces`` committed traces
(FIFO eviction → ``traces_dropped``) and ``trace_max_spans`` spans per
trace (overflow → ``spans_dropped``), so a hot broker can keep tracing at
100% sampling without unbounded growth.
"""

from __future__ import annotations

import contextvars
import random
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

# The active trace for the current asyncio task (set around the publish
# ingress pipeline and the cluster-RPC delivery handlers). Code that runs
# in OTHER tasks (deliver loops, ack handling) gets the trace as an
# explicit reference on DeliverItem/OutEntry instead.
CURRENT_TRACE: contextvars.ContextVar[Optional["Trace"]] = contextvars.ContextVar(
    "rmqtt_trace", default=None
)

# trace lifecycle states
_OPEN = 0       # spans buffering; finish() not yet decided
_COMMITTED = 1  # in the store; late spans append to the stored record
_DROPPED = 2    # sampled out; late SLOW spans can still promote


def new_trace_id() -> str:
    """128-bit trace id as 32 lowercase hex chars (W3C trace-id shape)."""
    return "%032x" % random.getrandbits(128)


class Trace:
    """One publish's span buffer. Cheap on purpose: a handful of slots,
    spans as 4-tuples (dict records only built at commit), id drawn
    lazily; an unsampled-and-not-slow trace drops spans with ONE compare
    — the cfg7 overhead bound is won or lost right there."""

    __slots__ = ("_tid", "sampled", "slow", "topic", "spans", "state",
                 "_tracer", "_record")

    def __init__(self, tracer: "Tracer", tid: Optional[str], sampled: bool,
                 topic: Optional[str] = None) -> None:
        self._tracer = tracer
        self._tid = tid
        self.sampled = sampled
        self.slow = False
        self.topic = topic
        self.spans: List[tuple] = []  # (name, start_epoch_ns, dur_ns, detail)
        self.state = _OPEN
        self._record: Optional[dict] = None

    @property
    def tid(self) -> str:
        """Trace id, drawn on first use (commit / cluster wire / bridge
        header / slow-ring stamp) — fast unsampled publishes never pay the
        128-bit draw."""
        t = self._tid
        if t is None:
            t = self._tid = new_trace_id()
        return t

    def add(self, name: str, t0_perf: int, dur_ns: int, detail: Any = None) -> None:
        """Record a span from a ``perf_counter_ns`` pair ALREADY taken by a
        telemetry stage — tracing never adds clock reads to shared stages.
        Unsampled traces keep nothing until a span crosses the slow
        threshold; from that span on everything is kept (the slow span and
        its aftermath are what make "why was it slow" answerable)."""
        tr = self._tracer
        if dur_ns < tr.slow_ns:
            if not (self.sampled or self.slow):
                return  # unsampled fast span: the hot-path early-out
        else:
            self.slow = True
        self._buffer(name, tr._epoch0 + (t0_perf - tr._perf0), dur_ns, detail)

    def add_wall(self, name: str, dur_ns: int, detail: Any = None) -> None:
        """Span whose only timing is a duration (ack RTT measured off the
        inflight entry's monotonic stamp): start = now - dur."""
        if dur_ns < self._tracer.slow_ns:
            if not (self.sampled or self.slow):
                return
        else:
            self.slow = True
        self._buffer(name, time.time_ns() - dur_ns, dur_ns, detail)

    def _buffer(self, name: str, start_ns: int, dur_ns: int, detail: Any) -> None:
        tr = self._tracer
        if self.state == _COMMITTED:
            # late span (deliver loop / ack, after finish): straight into
            # the stored record so cross-task stages still land — and a
            # late SLOW span must flip the stored flag too, or the trace
            # stays invisible to the slow-only listings
            rec = self._record
            if rec is not None and self.slow:
                rec["slow"] = True
            tr._append_span(rec, name, start_ns, dur_ns, detail)
            return
        if len(self.spans) >= tr.max_spans:
            tr.spans_dropped += 1
            return
        self.spans.append((name, start_ns, dur_ns, detail))
        if self.state == _DROPPED and self.slow:
            # always-record-on-slow, tail edition: a slow span arriving
            # after the sampled-out finish resurrects the trace
            tr.commit(self)


class Tracer:
    """Per-node trace registry: sampling policy + the bounded span store."""

    __slots__ = ("enabled", "sample", "max_traces", "max_spans", "slow_ns",
                 "node_id", "store", "_epoch0", "_perf0", "_rand",
                 "traces_recorded", "traces_sampled_out", "traces_dropped",
                 "spans_recorded", "spans_dropped")

    def __init__(
        self,
        enabled: bool = True,
        sample: float = 0.01,
        max_traces: int = 512,
        max_spans: int = 64,
        slow_ms: float = 100.0,
        node_id: int = 1,
    ) -> None:
        self.enabled = enabled
        self.sample = max(0.0, min(1.0, float(sample)))
        self.max_traces = max(1, int(max_traces))
        self.max_spans = max(1, int(max_spans))
        self.slow_ns = int(slow_ms * 1e6)
        self.node_id = node_id
        self.store: "OrderedDict[str, dict]" = OrderedDict()
        # epoch anchor: span starts come in as perf_counter_ns stamps (the
        # telemetry t0s); one wall/perf pair taken at construction converts
        # them to epoch ns without per-span wall reads. Cross-node span
        # alignment therefore inherits host NTP quality, like any
        # distributed tracer.
        self._epoch0 = time.time_ns()
        self._perf0 = time.perf_counter_ns()
        self._rand = random.random
        self.traces_recorded = 0
        self.traces_sampled_out = 0
        self.traces_dropped = 0  # store evictions (FIFO over max_traces)
        self.spans_recorded = 0
        self.spans_dropped = 0  # per-trace max_spans overflow

    # ---------------------------------------------------------------- begin
    def begin(self, topic: str) -> Optional[Trace]:
        """New trace at publish ingress; None when disabled (the disabled
        contract: no id, no allocation, and call sites take no timestamps).
        The id is drawn lazily (Trace.tid) — begin costs one random() and
        one small object."""
        if not self.enabled:
            return None
        return Trace(self, None, self._rand() < self.sample, topic)

    def from_wire(self, tw, topic: Optional[str] = None) -> Optional[Trace]:
        """Adopt a trace context that rode a cluster wire body
        (``messages.trace_to_wire`` shape: ``[tid, sampled]``); None for
        untraced publishes and frames from older nodes."""
        if not self.enabled or not tw:
            return None
        return Trace(self, str(tw[0]), bool(tw[1]), topic)

    # --------------------------------------------------------------- finish
    def finish(self, trace: Trace) -> None:
        """Head-sampled or slow → commit; otherwise drop (late slow spans
        can still promote, see Trace._add)."""
        if trace.state != _OPEN:
            return
        if trace.sampled or trace.slow:
            self.commit(trace)
        else:
            trace.state = _DROPPED
            self.traces_sampled_out += 1

    def commit(self, trace: Trace) -> None:
        rec = self.store.get(trace.tid)
        if rec is None:
            rec = {
                "trace_id": trace.tid,
                "node": self.node_id,
                "topic": trace.topic,
                "sampled": trace.sampled,
                "slow": False,
                "spans": [],
            }
            self.store[trace.tid] = rec
            self.traces_recorded += 1
            while len(self.store) > self.max_traces:
                self.store.popitem(last=False)
                self.traces_dropped += 1
        else:
            # same id committed twice on one node (e.g. a broadcast
            # FORWARDS and a targeted FORWARDS_TO for the same publish):
            # merge into one record
            self.store.move_to_end(trace.tid)
            rec["topic"] = rec["topic"] or trace.topic
        rec["slow"] = rec["slow"] or trace.slow
        for name, start_ns, dur_ns, detail in trace.spans:
            self._append_span(rec, name, start_ns, dur_ns, detail)
        trace.spans = []
        trace.state = _COMMITTED
        trace._record = rec

    def _append_span(self, rec: Optional[dict], name: str, start_ns: int,
                     dur_ns: int, detail: Any) -> None:
        if rec is None:
            return
        spans = rec["spans"]
        if len(spans) >= self.max_spans:
            self.spans_dropped += 1
            return
        spans.append({
            "name": name,
            "node": self.node_id,
            "start_ns": start_ns,
            "dur_ns": dur_ns,
            "detail": detail,
        })
        self.spans_recorded += 1

    # ---------------------------------------------------------------- reads
    @staticmethod
    def _bounds(rec: dict):
        spans = rec["spans"]
        if not spans:
            return 0, 0
        start = min(s["start_ns"] for s in spans)
        end = max(s["start_ns"] + s["dur_ns"] for s in spans)
        return start, end

    def _export(self, rec: dict) -> dict:
        """Full trace body: spans time-sorted, envelope recomputed."""
        start, end = self._bounds(rec)
        return {
            "trace_id": rec["trace_id"],
            "topic": rec["topic"],
            "sampled": rec["sampled"],
            "slow": rec["slow"],
            "nodes": sorted({s["node"] for s in rec["spans"]}),
            "ts": round(start / 1e9, 6),
            "dur_ms": round((end - start) / 1e6, 3),
            "spans": sorted(rec["spans"], key=lambda s: s["start_ns"]),
        }

    def _summary(self, rec: dict) -> dict:
        start, end = self._bounds(rec)
        return {
            "trace_id": rec["trace_id"],
            "topic": rec["topic"],
            "sampled": rec["sampled"],
            "slow": rec["slow"],
            "nodes": sorted({s["node"] for s in rec["spans"]}),
            "ts": round(start / 1e9, 6),
            "dur_ms": round((end - start) / 1e6, 3),
            "spans": len(rec["spans"]),
        }

    def get(self, tid: str) -> Optional[dict]:
        rec = self.store.get(tid)
        return self._export(rec) if rec is not None else None

    def recent(self, limit: int = 50) -> List[dict]:
        """Newest-first summaries of the committed traces."""
        out = []
        for rec in reversed(self.store.values()):
            if len(out) >= limit:
                break
            out.append(self._summary(rec))
        return out

    def slow_traces(self, limit: int = 50) -> List[dict]:
        out = []
        for rec in reversed(self.store.values()):
            if len(out) >= limit:
                break
            if rec["slow"]:
                out.append(self._summary(rec))
        return out

    @staticmethod
    def merge_traces(parts: List[dict]) -> dict:
        """Stitch one trace's per-node exports (`/api/v1/traces/<id>`
        cluster fetch): union of spans sorted on the shared timeline."""
        spans: List[dict] = []
        nodes: set = set()
        topic = None
        slow = sampled = False
        for p in parts:
            spans.extend(p.get("spans", []))
            nodes.update(p.get("nodes", []))
            topic = topic or p.get("topic")
            slow = slow or bool(p.get("slow"))
            sampled = sampled or bool(p.get("sampled"))
        spans.sort(key=lambda s: s["start_ns"])
        start = min((s["start_ns"] for s in spans), default=0)
        end = max((s["start_ns"] + s["dur_ns"] for s in spans), default=0)
        return {
            "trace_id": parts[0]["trace_id"],
            "topic": topic,
            "sampled": sampled,
            "slow": slow,
            "nodes": sorted(nodes),
            "ts": round(start / 1e9, 6),
            "dur_ms": round((end - start) / 1e6, 3),
            "spans": spans,
        }

    @staticmethod
    def dedup_summaries(rows: List[dict]) -> List[dict]:
        """Collapse per-node summaries of the same trace (cluster-merged
        recent/slow listings): union nodes, sum span counts, keep the
        earliest start."""
        by_id: Dict[str, dict] = {}
        for r in rows:
            cur = by_id.get(r["trace_id"])
            if cur is None:
                by_id[r["trace_id"]] = dict(r)
                continue
            cur["spans"] += r["spans"]
            cur["nodes"] = sorted(set(cur["nodes"]) | set(r["nodes"]))
            cur["slow"] = cur["slow"] or r["slow"]
            cur["sampled"] = cur["sampled"] or r["sampled"]
            cur["topic"] = cur["topic"] or r.get("topic")
            if r["ts"] and (not cur["ts"] or r["ts"] < cur["ts"]):
                cur["ts"] = r["ts"]
            cur["dur_ms"] = max(cur["dur_ms"], r["dur_ms"])
        return sorted(by_id.values(), key=lambda r: r["ts"], reverse=True)

    # ------------------------------------------------------------- surfaces
    def snapshot(self) -> dict:
        """Counters + store gauge for $SYS and the trace API envelope;
        shape-stable whether or not tracing has seen traffic."""
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "stored_traces": len(self.store),
            "max_traces": self.max_traces,
            "max_spans": self.max_spans,
            "traces_recorded": self.traces_recorded,
            "traces_sampled_out": self.traces_sampled_out,
            "traces_dropped": self.traces_dropped,
            "spans_recorded": self.spans_recorded,
            "spans_dropped": self.spans_dropped,
        }

    def prometheus_lines(self, labels: str) -> List[str]:
        """Exposition lines for the scrape endpoint: monotonic counters
        (conventional ``_total`` suffix) + the store-size gauge."""
        counters = (
            ("rmqtt_tracing_traces_recorded_total", self.traces_recorded),
            ("rmqtt_tracing_traces_sampled_out_total", self.traces_sampled_out),
            ("rmqtt_tracing_traces_dropped_total", self.traces_dropped),
            ("rmqtt_tracing_spans_recorded_total", self.spans_recorded),
            ("rmqtt_tracing_spans_dropped_total", self.spans_dropped),
        )
        out: List[str] = []
        for name, v in counters:
            out.append(f"# TYPE {name} counter")
            out.append(f"{name}{{{labels}}} {v}")
        out.append("# TYPE rmqtt_tracing_stored_traces gauge")
        out.append(f"rmqtt_tracing_stored_traces{{{labels}}} {len(self.store)}")
        return out
