"""Micro-batched routing service: the publish-ingress → kernel seam.

The reference resolves `Router::matches()` inline per publish
(`rmqtt/src/shared.rs:771-778`). The TPU path instead runs a
bounded ingress queue + batcher (SURVEY.md §2.4 item 2's back-pressure system
re-purposed): concurrent publishes park a future on the queue; the drain task
collects up to ``max_batch`` (or until ``linger_ms`` passes) and resolves
them with ONE ``Router.matches_batch`` call. With ``DefaultRouter`` the batch
degrades to a loop — the seam is identical, only the router swaps, exactly
like the reference's extension manager (`rmqtt/src/extend.rs:64-113`).

Batching is latency-adaptive: a dispatch takes whatever is queued RIGHT NOW
(no linger), so a lone publish at low load pays zero added latency, while
under load the previous dispatch's service time naturally accumulates the
next batch (the classic adaptive-batching scheme — batch size tracks load
with no tuning knob). An optional ``linger_ms > 0`` restores a bounded wait
for workloads that prefer fuller device batches over first-packet latency.

In FRONT of the queue sits an epoch-versioned match-result cache
(`rmqtt_tpu_torch/router/cache.py`): repeat-topic publishes — the dominant regime
under zipf-skewed IoT traffic — resolve synchronously from the cached
expanded relations and never enter the batcher, so device/native batches
shrink to misses only. Misses are deduplicated per dispatch (one match per
DISTINCT topic, matched with ``from_id=None``) and the per-publish result is
derived from the shared entry (No-Local re-filtered, shared-group liveness
re-flagged, round-robin choice still per publish).
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Tuple

from rmqtt_tpu_torch.broker.failover import _swallow_abandoned
from rmqtt_tpu_torch.broker.telemetry import NULL_TELEMETRY, Telemetry
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.ops._build import kernel_fault
from rmqtt_tpu_torch.router.base import Id, Router, SubRelationsMap
from rmqtt_tpu_torch.router.cache import MatchCache


class RoutingService:
    #: consecutive per-item failures in _isolate before the rest of the
    #: batch rejects without further retries (systemic-outage bailout)
    _ISOLATE_FAIL_STREAK = 3

    def __init__(
        self,
        router: Router,
        max_batch: int = 1024,
        linger_ms: float = 0.0,
        max_queue: int = 100_000,
        pipeline_depth: int = 3,
        prewarm: bool = True,
        cache_enable: bool = True,
        cache_capacity: int = 8192,
        cache_shared_bypass: bool = False,
        telemetry: Optional[Telemetry] = None,
    ) -> None:
        self.router = router
        # latency telemetry (broker/telemetry.py): stage histograms for
        # queue wait / match / hit-vs-miss + the slow-op ring. The disabled
        # singleton keeps every hot-path guard a single attribute test;
        # per-publish stages go through fast recorder closures (no-ops
        # when disabled — the t0 guards mean they're never even called)
        self.tele = telemetry if telemetry is not None else NULL_TELEMETRY
        self._rec_hit = self.tele.recorder("publish.cache_hit")
        self._rec_miss = self.tele.recorder("publish.cache_miss")
        self._rec_qwait = self.tele.recorder("routing.queue_wait")
        self.max_batch = max_batch
        self.linger = linger_ms / 1000.0
        self._q: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        self._task: Optional[asyncio.Task] = None
        # pipelined dispatch (routers exposing submit/complete halves):
        # up to pipeline_depth batches in flight — batch N+1's host encode
        # and dispatch overlap batch N's device compute, so burst latency
        # approaches the slowest stage instead of the sum of stages. The
        # semaphore is the in-flight bound (acquired before submit, released
        # after completion); pipeline_depth=1 degrades to serial dispatch.
        self.pipeline_depth = max(1, pipeline_depth)
        self._pipe_sem: Optional[asyncio.Semaphore] = None  # built in start()
        self._completion_q: asyncio.Queue = asyncio.Queue()
        self._completer: Optional[asyncio.Task] = None
        # small-batch fast path: device routers pre-compile their tiny
        # dispatch shapes off the hot path at start() (and latch a sticky
        # pad floor), so cfg1-style traffic — one publish per dispatch —
        # hits an already-compiled executable instead of paying a fresh
        # XLA compile per distinct small shape
        self.prewarm = prewarm
        # device-plane failover (broker/failover.py), wired by ServerContext
        # for device routers with a host trie mirror; None keeps every
        # dispatch guard a single attribute test
        self.failover = None
        # intra-node routing fabric (broker/fabric.py), wired by
        # ServerContext when [fabric] is enabled; surfaced through stats()
        # so the fabric counters ride every admin plane (None = zeros)
        self.fabric = None
        # hot-key attribution plane (broker/hotkeys.py), wired by
        # ServerContext only when enabled: the dispatch seam attributes
        # automaton work to first-segment prefixes; None keeps the
        # disabled cost at a single attribute test per dispatch
        self.hotkeys = None
        # epoch-versioned match-result cache (pre-queue fast path). The
        # cache is only sound for routers that OPT IN via epochs_tracked
        # (their add/remove bump Router.epochs on every mutation); any
        # other router — duck-typed or a custom Router subclass that never
        # bumps — runs uncached rather than risk stale serves
        self.cache: Optional[MatchCache] = None
        if (cache_enable and cache_capacity > 0
                and getattr(router, "epochs_tracked", False)):
            self.cache = MatchCache(
                router.epochs,
                capacity=cache_capacity,
                shared_bypass=cache_shared_bypass,
                is_online=getattr(router, "_is_online", lambda cid: True),
            )
        # observability (TaskExecStats analogue, context.rs:506-555):
        # dispatch counts + an EMA of batch size, surfaced via ctx.stats()
        self.dispatches = 0
        self.dispatched_items = 0
        self.batch_size_ema = 0.0
        self.inflight = 0  # batches currently past collect, not yet resolved

    def stats(self) -> dict:
        """Gauges for the admin surface (per-exec stats parity). The _ema
        key is average-mode for cluster merging (counter.rs AVG), not a
        summable count — /stats/sum treats the suffix accordingly (as it
        does the _ms latency-percentile keys below)."""
        c = self.cache
        t = self.tele
        t.flush()  # ONE fold pass; the quantile reads below skip theirs

        def pq(name: str, q: float) -> float:
            return round(t.hist(name).quantile(q) / 1e6, 3)

        # device-table lifecycle counters (router/xla.py device_stats):
        # zeros for routers without a device mirror so the surface stays
        # shape-stable (Prometheus/dashboard/$SYS all iterate these keys)
        ds = getattr(self.router, "device_stats", None)
        d = ds() if callable(ds) else {}
        return {
            # latency percentile gauges (broker/telemetry.py histograms):
            # zeros when telemetry is disabled — shape-stable either way
            "routing_match_p50_ms": pq("routing.match", 0.50),
            "routing_match_p99_ms": pq("routing.match", 0.99),
            "routing_queue_wait_p50_ms": pq("routing.queue_wait", 0.50),
            "routing_queue_wait_p99_ms": pq("routing.queue_wait", 0.99),
            "publish_e2e_p50_ms": pq("publish.e2e", 0.50),
            "publish_e2e_p99_ms": pq("publish.e2e", 0.99),
            "routing_queued": self._q.qsize(),
            "routing_inflight_batches": self.inflight,
            "routing_dispatches": self.dispatches,
            "routing_dispatched_items": self.dispatched_items,
            "routing_batch_size_ema": round(self.batch_size_ema, 1),
            # match-result cache gauges (zeros when the cache is disabled so
            # the observability surface stays shape-stable for dashboards)
            "routing_cache_size": len(c) if c is not None else 0,
            "routing_cache_hits": c.hits if c is not None else 0,
            "routing_cache_misses": c.misses if c is not None else 0,
            "routing_cache_invalidations": c.invalidations if c is not None else 0,
            "routing_cache_evictions": c.evictions if c is not None else 0,
            "routing_cache_door_rejects": c.door_rejects if c is not None else 0,
            # device-table churn gauges (delta uploads / bg compaction)
            "routing_uploads": d.get("uploads", 0),
            "routing_delta_uploads": d.get("delta_uploads", 0),
            "routing_upload_bytes": d.get("upload_bytes", 0),
            "routing_compactions": d.get("compactions", 0),
            # cumulative time, so the suffix is _total (summed in
            # /stats/sum), NOT _ms (averaged like latency percentiles)
            "routing_compact_ms_total": d.get("compact_ms", 0.0),
            "routing_cand_cache_invalidations": d.get("cand_cache_invalidations", 0),
            "routing_fused_batches": d.get("fused_batches", 0),
            # per-stage device dispatch attribution (stage_timing via
            # XlaRouter.device_stats): cumulative ms → _total suffix (summed
            # in /stats/sum); zeros for trie/native routers and while
            # stage_timing is off, so the surface stays shape-stable
            "routing_stage_encode_ms_total": d.get("stage_encode_ms_total", 0.0),
            "routing_stage_dispatch_ms_total": d.get("stage_dispatch_ms_total", 0.0),
            "routing_stage_fetch_ms_total": d.get("stage_fetch_ms_total", 0.0),
            "routing_stage_decode_ms_total": d.get("stage_decode_ms_total", 0.0),
            # hand-kernel launches in this process (TorchRouter.device_stats,
            # ops/match_words.py and ops/compact_tail.py counters): which
            # words kernel and which compaction tail the device plane ran;
            # zeros for routers without a device matcher
            "routing_kernel_launches_packed": d.get("kernel_launches_packed", 0),
            "routing_kernel_launches_legacy": d.get("kernel_launches_legacy", 0),
            "routing_kernel_launches_fused_tail": d.get("kernel_launches_fused_tail", 0),
            "routing_kernel_launches_compact_global": d.get(
                "kernel_launches_compact_global", 0),
            # device-plane failover gauges (broker/failover.py): zeros when
            # failover is not wired so the surface stays shape-stable.
            # state: 0 = device (healthy), 1 = host fallback, 2 = probing
            "routing_failover_state": (
                self.failover.state_value() if self.failover is not None else 0),
            "routing_failovers": (
                self.failover.failovers if self.failover is not None else 0),
            "routing_switchbacks": (
                self.failover.switchbacks if self.failover is not None else 0),
            "routing_failover_host_routed": (
                self.failover.host_items if self.failover is not None else 0),
            "routing_device_failures": (
                self.failover.failure_total if self.failover is not None else 0),
            # intra-node fabric gauges (broker/fabric.py): zeros without a
            # fabric so the surface stays shape-stable. The two stage keys
            # attribute fabric submit RTT / remote fan-out write time next
            # to the device-stage *_ms_total gauges, keeping the
            # host-vs-device split honest when matches cross workers
            "fabric_enabled": 1 if self.fabric is not None else 0,
            "fabric_owner": (
                1 if self.fabric is not None and self.fabric.is_owner else 0),
            "fabric_batches": self.fabric.batches if self.fabric else 0,
            "fabric_items": self.fabric.items if self.fabric else 0,
            "fabric_bytes_out": self.fabric.bytes_out if self.fabric else 0,
            "fabric_deliver_in": self.fabric.deliver_in if self.fabric else 0,
            "fabric_deliver_out": self.fabric.deliver_out if self.fabric else 0,
            "fabric_kicks_o1": self.fabric.kicks_o1 if self.fabric else 0,
            "fabric_kick_rpcs": self.fabric.kick_rpcs if self.fabric else 0,
            "fabric_plan_hits": self.fabric.plan_hits if self.fabric else 0,
            "fabric_owner_reconnects": (
                self.fabric.owner_reconnects if self.fabric else 0),
            "fabric_submit_fallbacks": (
                self.fabric.submit_fallbacks if self.fabric else 0),
            "directory_epoch": (
                (self.fabric.dir_epoch if self.fabric.is_owner
                 else self.fabric.replica_epoch) if self.fabric else 0),
            "routing_stage_fabric_submit_ms_total": (
                round(self.fabric.submit_ms_total, 3) if self.fabric else 0.0),
            "routing_stage_fabric_fanout_ms_total": (
                round(self.fabric.fanout_ms_total, 3) if self.fabric else 0.0),
        }

    def set_batch_window(self, max_batch: Optional[int] = None,
                         linger_ms: Optional[float] = None) -> None:
        """Knob seam (broker/knobs.py / the autotuner): retune the batcher
        live. ``_collect`` reads both per dispatch, so the next batch
        collected after this call already runs under the new window — no
        queue drain or task restart involved."""
        if max_batch is not None:
            self.max_batch = max(1, int(max_batch))
        if linger_ms is not None:
            self.linger = max(0.0, float(linger_ms)) / 1000.0

    def queue_fraction(self) -> float:
        """Ingress-queue fullness in [0, 1] — the overload controller's
        routing-backlog pressure signal (broker/overload.py)."""
        return self._q.qsize() / (self._q.maxsize or 1)

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self._task is None:
            self._task = loop.create_task(self._run())
        if self._completer is None and hasattr(self.router, "submit_batch_raw"):
            self._pipe_sem = asyncio.Semaphore(self.pipeline_depth)
            self._completer = loop.create_task(self._complete_loop())
        if self.prewarm and hasattr(self.router, "prewarm"):
            # background thread: compiling the small shapes can take
            # seconds on a real chip and must not stall broker start
            loop.run_in_executor(None, self.router.prewarm)

    async def stop(self) -> None:
        if self.failover is not None:
            self.failover.stop()  # cancel probe/pacer background tasks
        for name in ("_task", "_completer"):
            t = getattr(self, name)
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
                setattr(self, name, None)
        # reject everything still parked in either queue — those waiters
        # would otherwise await forever (e.g. forwards() during shutdown).
        # Destructure defensively (the batch is always item[0]): a future
        # queue-shape change must not turn shutdown into a TypeError that
        # strands every parked waiter
        while not self._completion_q.empty():
            item = self._completion_q.get_nowait()
            self._reject(item[0], RuntimeError("routing service stopped"))
        while not self._q.empty():
            item = self._q.get_nowait()
            self._reject([item], RuntimeError("routing service stopped"))

    def _cache_lookup(self, topic: str):
        """Pre-queue fast path: the entry for ``topic`` if current."""
        if self.cache is None:
            return None
        return self.cache.get(topic)

    async def matches(self, from_id: Optional[Id], topic: str) -> SubRelationsMap:
        relmap, _hit = await self.matches_for_fanout(from_id, topic)
        return relmap

    async def matches_for_fanout(
        self, from_id: Optional[Id], topic: str
    ) -> Tuple[SubRelationsMap, bool]:
        """``(relations, cache_hit)`` — the fan-out entry point. A cache hit
        resolves synchronously (never enters the batcher); a miss parks on
        the ingress queue as before.

        NOTE: even for prefer_inline routers the MISS path keeps the queue
        round trip — its yield is load-bearing: a read loop processing a
        whole TCP chunk of publishes would otherwise starve the deliver
        loops and overflow bounded deliver queues (measured: QoS0 drops
        under flood). The hit path preserves that cooperative yield with an
        explicit sleep(0), still far cheaper than the queue round trip."""
        t0 = time.perf_counter_ns() if self.tele.enabled else 0
        # the active trace rides the queue item so the batcher task can
        # stamp queue-wait/match spans onto it (broker/tracing.py); spans
        # reuse t0 and the dispatch timestamps — no extra clock reads
        trace = CURRENT_TRACE.get() if t0 else None
        entry = self._cache_lookup(topic)
        if entry is not None:
            await asyncio.sleep(0)
            out = self.router.collapse(self.cache.derive(entry, from_id))
            if t0:
                dur = time.perf_counter_ns() - t0
                self._rec_hit(dur, topic, trace)
                if trace is not None:
                    trace.add("publish.cache_hit", t0, dur, topic)
            return out, True
        fut = asyncio.get_running_loop().create_future()
        # t0 doubles as the enqueue timestamp for the queue-wait histogram
        await self._q.put((from_id, topic, fut, False, t0, trace))
        res = await fut
        # only meaningful with the cache on: a cache-off broker recording
        # every publish as a "miss" would read as a malfunctioning cache
        # (same rule as the hit/miss counters in shared.forwards)
        if t0 and self.cache is not None:
            dur = time.perf_counter_ns() - t0
            self._rec_miss(dur, topic, trace)
            if trace is not None:
                trace.add("publish.cache_miss", t0, dur, topic)
        return res, False

    async def matches_raw(self, from_id: Optional[Id], topic: str):
        """Un-collapsed variant for cluster-global shared-group choice."""
        t0 = time.perf_counter_ns() if self.tele.enabled else 0
        trace = CURRENT_TRACE.get() if t0 else None
        entry = self._cache_lookup(topic)
        if entry is not None:
            await asyncio.sleep(0)  # keep the cooperative yield (see above)
            out = self.cache.derive(entry, from_id)
            if t0:
                dur = time.perf_counter_ns() - t0
                self._rec_hit(dur, topic, trace)
                if trace is not None:
                    trace.add("publish.cache_hit", t0, dur, topic)
            return out
        fut = asyncio.get_running_loop().create_future()
        await self._q.put((from_id, topic, fut, True, t0, trace))
        res = await fut
        if t0 and self.cache is not None:  # see matches_for_fanout
            dur = time.perf_counter_ns() - t0
            self._rec_miss(dur, topic, trace)
            if trace is not None:
                trace.add("publish.cache_miss", t0, dur, topic)
        return res

    async def _collect(self):
        batch = [await self._q.get()]
        while len(batch) < self.max_batch:
            try:
                batch.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        if self.linger > 0 and len(batch) < self.max_batch:
            deadline = asyncio.get_running_loop().time() + self.linger
            while len(batch) < self.max_batch:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._q.get(), timeout))
                except asyncio.TimeoutError:
                    break
                except asyncio.CancelledError:
                    # stop() mid-linger: items already popped off the queue
                    # are invisible to stop()'s drain — reject them here or
                    # their waiters hang forever
                    self._reject(batch, RuntimeError("routing service stopped"))
                    raise
        return batch

    def _plan(self, batch):
        """→ (match items, per-item waiter groups or None).

        Without the cache, items mirror the batch 1:1. With it, misses are
        DEDUPLICATED per distinct topic and matched with ``from_id=None``
        (No-Local is re-applied per waiter at resolve time) so a burst of
        publishes to one hot topic costs one match; epoch snapshots are
        taken here — BEFORE the match runs — so a subscribe landing while
        the batch is in flight makes the entry born-stale, never wrong."""
        if self.cache is None:
            return [(fid, topic) for fid, topic, *_ in batch], None
        order: dict = {}
        items: list = []
        groups: list = []
        for i, (_fid, topic, _fut, _raw, _t, _tr) in enumerate(batch):
            j = order.get(topic)
            if j is None:
                order[topic] = len(items)
                items.append((None, topic))
                groups.append(([i], self.cache.snapshot(topic)))
            else:
                groups[j][0].append(i)
        return items, groups

    def _resolve(self, batch, results, groups=None) -> None:
        """Resolve waiters from per-item results. A result slot may be an
        EXCEPTION (the poisoned-batch isolation path, ``_isolate``): it
        rejects only that item's waiters — the co-batched publishes still
        resolve normally."""
        if groups is None:
            for (_, _, fut, raw, _t, _tr), res in zip(batch, results):
                if fut.done():
                    continue
                if isinstance(res, BaseException):
                    fut.set_exception(res)
                    continue
                try:
                    fut.set_result(res if raw else self.router.collapse(res))
                except Exception as e:
                    # a collapse failure (e.g. a shared-sub strategy callback
                    # bug) must reject ITS waiter, not kill the service task
                    fut.set_exception(e)
            return
        for (idxs, snap), res in zip(groups, results):
            if isinstance(res, BaseException):
                for i in idxs:
                    fut = batch[i][2]
                    if not fut.done():
                        fut.set_exception(res)
                continue
            topic = batch[idxs[0]][1]
            entry = self.cache.put(topic, res, snap)
            # ONE waiter may consume the fresh raw directly (its containers
            # are unaliased until collapse mutates them); the rest derive
            # copies from the entry. No-Local publishers always derive, and
            # a transient (unstored) entry ALIASES the raw, so the raw may
            # only be consumed directly when no other waiter derives from it
            raw_free = entry.stored or len(idxs) == 1
            for i in idxs:
                fid, _topic, fut, raw, _t, _tr = batch[i]
                if fut.done():
                    continue
                try:
                    if raw_free and (fid is None or not entry.has_no_local):
                        derived, raw_free = res, False
                    else:
                        derived = self.cache.derive(entry, fid)
                    fut.set_result(
                        derived if raw else self.router.collapse(derived))
                except Exception as e:
                    fut.set_exception(e)

    @staticmethod
    def _reject(batch, exc) -> None:
        for it in batch:
            fut = it[2]
            if not fut.done():
                fut.set_exception(exc)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        # CPU routers (trie/native) match in microseconds: a thread-pool hop
        # per dispatch costs more than the match itself and caps serial
        # publish throughput. Device routers keep the executor (the kernel
        # blocks; numpy/jax release the GIL for the heavy parts).
        inline_ok = self.router.inline_ok
        pipelined = hasattr(self.router, "submit_batch_raw")
        while True:
            batch = await self._collect()
            try:
                await self._dispatch_one(loop, batch, inline_ok, pipelined)
            except asyncio.CancelledError:
                # shutdown while this batch was mid-dispatch: its waiters
                # must not hang (stop()'s drain only sees the queues)
                self._reject(batch, RuntimeError("routing service stopped"))
                raise

    async def _dispatch_one(self, loop, batch, inline_ok, pipelined) -> None:
        items, groups = self._plan(batch)
        self.dispatches += 1
        self.dispatched_items += len(items)
        hk = self.hotkeys
        if hk is not None:
            # per dispatched (deduplicated) match item: the automaton work
            # a namespace prefix is responsible for, not raw publish volume
            hk.on_dispatch_items(items)
        self.batch_size_ema = (
            len(items) if self.dispatches == 1
            else 0.9 * self.batch_size_ema + 0.1 * len(items)
        )
        tele = self.tele
        t_disp = 0
        if tele.enabled:
            t_disp = time.perf_counter_ns()
            rec_qwait = self._rec_qwait
            for it in batch:
                if it[4]:
                    wait = t_disp - it[4]
                    tr = it[5]
                    rec_qwait(wait, it[1], tr)
                    if tr is not None:  # same t0/t_disp reads as the stage
                        tr.add("routing.queue_wait", it[4], wait, it[1])
            tele.record("routing.batch_size", len(items))
        fo = self.failover
        if fo is not None and fo.active:
            # device plane is out: route through the host trie mirror and
            # (once the breaker cooldown elapses) kick a background probe
            fo.maybe_probe(loop)
            await self._host_dispatch(loop, batch, items, groups, t_disp)
            return
        if inline_ok(len(items)):
            # inline batches are HOST-served by contract (inline_ok is only
            # true for the trie routers / the hybrid's trie branch): a
            # failure here is host-side poison, not device evidence — it
            # must neither trip nor reset the device breaker
            try:
                results = self.router.matches_batch_raw(items)
            except Exception as e:
                await self._isolate(loop, batch, items, groups, e)
                return
            self._resolve(batch, results, groups)
            if t_disp:
                self._record_match(t_disp, len(items), batch)
            return
        if pipelined:
            # in-flight bound: block BEFORE submitting so at most
            # pipeline_depth batches are ever past submit
            await self._pipe_sem.acquire()
            self.inflight += 1
            try:
                done, payload = await self._device_call(
                    loop, self.router.submit_batch_raw, items,
                    "device dispatch")
            except TimeoutError as e:
                self.inflight -= 1
                self._pipe_sem.release()
                await self._device_failed(
                    loop, batch, items, groups, e, "timeout", t_disp)
                return
            except Exception as e:
                self.inflight -= 1
                self._pipe_sem.release()
                await self._device_failed(
                    loop, batch, items, groups, e, "dispatch_error", t_disp)
                return
            except asyncio.CancelledError:
                self.inflight -= 1
                self._pipe_sem.release()
                raise
            if done:
                # the router resolved synchronously (the hybrid's trie
                # branch, or a device matcher with no submit entry point):
                # don't spend a pipeline permit or a completion-queue round
                # trip on it
                self.inflight -= 1
                self._pipe_sem.release()
                self._resolve(batch, payload, groups)
                if t_disp:
                    self._record_match(t_disp, len(items), batch)
                if fo is not None and self._served_by_device():
                    fo.note_device_ok()
                return
            await self._completion_q.put((batch, groups, payload, t_disp, items))
            return
        self.inflight += 1
        try:
            results = await loop.run_in_executor(
                None, self.router.matches_batch_raw, items
            )
        except Exception as e:
            self.inflight -= 1
            await self._device_failed(
                loop, batch, items, groups, e, "dispatch_error", t_disp)
            return
        except asyncio.CancelledError:
            self.inflight -= 1
            raise
        self.inflight -= 1
        self._resolve(batch, results, groups)
        if t_disp:
            self._record_match(t_disp, len(items), batch)
        if fo is not None and self._served_by_device():
            fo.note_device_ok()

    def _served_by_device(self) -> bool:
        """Was the dispatch that just resolved served by the DEVICE matcher?
        Hybrid routers report per-batch (last_match_was_device — reads are
        safe: dispatches are serialized on the single batcher task); plain
        device routers have no trie branch, so default True."""
        probe = getattr(self.router, "last_match_was_device", None)
        return probe() if callable(probe) else True

    async def _device_call(self, loop, fn, arg, what: str):
        """One device-router call in the executor, under the failover
        plane's per-batch deadline. On timeout the executor thread is
        ABANDONED (its eventual result/exception is swallowed) so a hung
        kernel can never wedge the dispatch or completion loop — the
        watchdog contract of broker/failover.py."""
        fo = self.failover
        fut = loop.run_in_executor(None, fn, arg)
        if fo is None or not fo.usable or fo.timeout_s <= 0:
            return await fut
        done, pending = await asyncio.wait({fut}, timeout=fo.timeout_s)
        if pending:
            fut.add_done_callback(_swallow_abandoned)
            raise TimeoutError(
                f"{what} exceeded the {fo.timeout_s:.1f}s failover deadline")
        return fut.result()

    async def _host_dispatch(self, loop, batch, items, groups, t_disp) -> None:
        """Serve one batch through the host trie mirror (failover plane):
        same resolve semantics as the device path, plus ``routing.failover``
        trace spans and the host-routed counters."""
        fo = self.failover
        router = self.router
        t0 = time.perf_counter_ns() if (t_disp or self.tele.enabled) else 0
        try:
            if router.host_inline_ok():
                results = router.host_matches_batch_raw(items)
            else:
                results = await loop.run_in_executor(
                    None, router.host_matches_batch_raw, items)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # the host fallback itself failed (e.g. a genuinely poisoned
            # topic): isolate per item ON THE HOST PATH so one bad encode
            # doesn't reject the co-batched publishes
            await self._isolate(loop, batch, items, groups, e,
                                router.host_matches_batch_raw)
            return
        fo.note_host_batch(len(items))
        self._resolve(batch, results, groups)
        if t0:
            dur = time.perf_counter_ns() - t0
            detail = {"backend": "host-fallback", "batch": len(items)}
            for it in batch:
                tr = it[5]
                if tr is not None:
                    tr.add("routing.failover", t0, dur, detail)
            self.tele.record("routing.match", dur, detail)

    async def _device_failed(self, loop, batch, items, groups, exc,
                             reason: str, t_disp) -> None:
        """A batch failed on the primary path. With a usable failover plane
        the failure is CLASSIFIED (breaker bookkeeping; the breaker opening
        activates host routing) and this batch is served from the host trie
        — zero lost publishes. Without one, fall back to poisoned-batch
        isolation: split-and-retry so only the faulty item's futures reject.

        A fault of the card's kernels (one that fails to build, load or
        launch) rejects the whole batch and leaves the breaker alone: the
        port never serves a batch off the card because its kernels failed."""
        if kernel_fault(exc):
            self._resolve(batch, [exc] * len(items), groups)
            return
        fo = self.failover
        if fo is not None and fo.usable:
            from rmqtt_tpu_torch.broker.failover import classify

            fo.record_failure(classify(exc, reason))
            await self._host_dispatch(loop, batch, items, groups, t_disp)
            return
        await self._isolate(loop, batch, items, groups, exc)

    async def _isolate(self, loop, batch, items, groups, exc,
                       match_fn=None) -> None:
        """Poisoned-batch isolation (one bad topic encode must not reject
        its co-batched publishes): split the failed batch in half, retry
        each half once, and for a half that still fails match its items
        one by one — failures become per-item exceptions that ``_resolve``
        routes to only their own waiters.

        The per-item pass bails out after ``_ISOLATE_FAIL_STREAK``
        consecutive failures: poison is item-shaped (a bad topic fails
        alone among healthy neighbours), so an unbroken failure run means
        the PATH is down (dead device with no usable failover plane) — and
        then 2+N guaranteed-to-fail serial retries per batch would back up
        the dispatch loop exactly when the broker is already degraded.
        Remaining items reject with the original error immediately."""
        if match_fn is None:
            match_fn = getattr(self.router, "matches_batch_raw", None)
        n = len(items)
        if n == 1 or match_fn is None:
            # a single item IS the poison; a pipelined-only router (no
            # synchronous batch entry point) can't be retried — both
            # degrade to rejecting with the original error
            self._resolve(batch, [exc] * n, groups)
            return
        results: list = [exc] * n
        streak = 0

        async def retry(lo: int, hi: int) -> None:
            nonlocal streak
            try:
                sub = await loop.run_in_executor(None, match_fn, items[lo:hi])
            except asyncio.CancelledError:
                raise
            except Exception:
                for j in range(lo, hi):  # per-item: isolate the poison
                    if streak >= self._ISOLATE_FAIL_STREAK:
                        return  # systemic, not poison: stop amplifying
                    try:
                        one = await loop.run_in_executor(
                            None, match_fn, items[j:j + 1])
                        results[j] = one[0]
                        streak = 0
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        results[j] = e
                        streak += 1
            else:
                results[lo:hi] = sub

        mid = n // 2
        await retry(0, mid)
        await retry(mid, n)
        self._resolve(batch, results, groups)

    def _record_match(self, t0: int, n: int, batch=None) -> None:
        """Per-dispatch backend match latency (submit → results expanded).
        The same timestamp pair also stamps a ``routing.match`` span onto
        every traced item of the batch — the per-publish view of the
        kernel dispatch (backend name = native/xla/trie in the detail).
        A slow dispatch's ring entry carries the batch's first trace id
        (the batcher task has no trace contextvar of its own)."""
        dur = time.perf_counter_ns() - t0
        detail = {"backend": type(self.router).__name__, "batch": n}
        first_trace = None
        if batch is not None:
            for it in batch:
                tr = it[5]
                if tr is not None:
                    if first_trace is None:
                        first_trace = tr
                    tr.add("routing.match", t0, dur, detail)
        self.tele.record("routing.match", dur, detail, first_trace)

    async def _complete_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch, groups, handle, t_disp, items = await self._completion_q.get()
            fo = self.failover
            try:
                try:
                    # watchdog (broker/failover.py): a hung device completes
                    # nothing — the deadline serves the batch from the host
                    # trie and abandons the wedged executor thread instead
                    # of wedging this loop with it
                    results = await self._device_call(
                        loop, self.router.complete_batch_raw, handle,
                        "device completion")
                except asyncio.CancelledError:
                    # shutdown mid-completion: don't strand these waiters
                    self._reject(batch, RuntimeError("routing service stopped"))
                    raise
                except TimeoutError as e:
                    await self._device_failed(
                        loop, batch, items, groups, e, "timeout", t_disp)
                except Exception as e:
                    await self._device_failed(
                        loop, batch, items, groups, e, "complete_error", t_disp)
                else:
                    self._resolve(batch, results, groups)
                    if t_disp:
                        self._record_match(t_disp, len(items), batch)
                    if fo is not None:
                        fo.note_device_ok()
            finally:
                self.inflight -= 1
                self._pipe_sem.release()
