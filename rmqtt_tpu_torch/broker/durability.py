"""Crash-safe durability plane: journaled broker state + cold-start recovery.

Every fault plane so far (failover, fencing, anti-entropy, fabric owner
respawn) keeps the broker correct while the *process survives*; a SIGKILL
still lost the retained store, durable sessions, subscriptions and unacked
QoS1/2 windows. This module closes that gap, mirroring the reference's
layer-3 session/retain persistence (PAPER.md) with the crash-consistency
discipline of a write-ahead log:

**Journal.** Retained set/clear, session create/destroy, subscribe/
unsubscribe and QoS1/2 pending open/ack transitions append CRC-framed
records (``crc32 || len || payload``, payload = cluster wire encoding) to a
monotonically-keyed journal namespace on the existing ``SqliteStore`` /
``RedisStore`` surface. Appends only buffer in memory; a flusher commits
the buffer as ONE store transaction per group-commit window
(``flush_interval_ms`` / ``flush_max``), so the hot path never pays a
per-op fsync — concurrent publishers share each commit.

**Acknowledgement barrier.** A QoS1/2 PUBACK/PUBREC (and SUBACK/UNSUBACK)
waits on :meth:`DurabilityService.barrier` — resolved once every record
journaled so far is committed. That is the zero-acked-loss contract the
kill-9 torture harness (scripts/crash_torture.py) verifies: anything the
broker acknowledged is on disk first.

**Compaction.** When the journal outgrows ``compact_min`` rows past the
last snapshot, the flusher folds snapshot+journal into per-row snapshot
namespaces (retained topic → message, client id → session state), stamps
``snapshot_seq`` and deletes the folded journal prefix. Every journal
event is an idempotent upsert, so the crash window between snapshot write
and meta stamp replays harmlessly.

**Recovery.** ``MqttBroker.start`` runs :meth:`recover` before any
listener accepts (mirroring the fabric warm-up gate): snapshot+journal
fold back into ``RetainStore``, the session registry, the router and
per-session pending windows; unacked QoS1/2 re-deliver with DUP=1 when the
client returns. A torn journal tail (the ``storage.torn_write`` failpoint,
or a real partial write) fails its CRC and is dropped —
scan-to-last-valid, never a crash. Counters
(``durability_recovered_{retained,sessions,subs,inflight}``,
``durability_recovery_ms``) surface on ``/api/v1/durability``, Prometheus,
``$SYS`` and the dashboard.

``[durability] enable = false`` (the default) constructs nothing:
``ctx.durability is None`` and every hot-path guard is a single attribute
test — pinned byte-for-byte zero behavior change.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.cluster import wire
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, FailpointError

log = logging.getLogger("rmqtt_tpu_torch.durability")

_FP_FSYNC = FAILPOINTS.register("storage.fsync")
_FP_TORN = FAILPOINTS.register("storage.torn_write")

#: store namespaces (shared sqlite file / redis prefix with nothing else —
#: the durability plane owns its own store instance)
NS_JOURNAL = "dj"
NS_SNAP_RETAIN = "dret"
NS_SNAP_SESS = "dsess"
NS_SNAP_DELAYED = "ddly"
NS_SNAP_MSG = "dmsg"
NS_META = "dmeta"

#: journal keys: zero-padded so lexicographic == numeric order everywhere
#: and ``delete_int_upto`` (raft-log compaction helper) applies directly
_KEY = "%020d"


# --------------------------------------------------------------- records
def frame_record(event: list) -> bytes:
    """CRC-framed journal record: a torn write (truncated value) fails the
    length or CRC check on recovery instead of resurrecting garbage."""
    payload = wire.dumps(event)
    return struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload)) + payload


def decode_record(blob) -> Optional[list]:
    """Framed bytes → event list, or None for a torn/corrupt record."""
    if not isinstance(blob, (bytes, bytearray)) or len(blob) < 8:
        return None
    crc, ln = struct.unpack_from("<II", blob)
    payload = bytes(blob[8:])
    if len(payload) != ln or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        return None
    try:
        ev = wire.loads(payload)
    except Exception:
        return None
    return ev if isinstance(ev, list) and ev else None


def fold_event(state: Dict[str, Any], ev: list) -> None:
    """Apply one journal event to the folded state. Every event is an
    idempotent upsert/delete so compaction's crash window (snapshot rows
    written, meta seq not yet stamped) replays harmlessly."""
    kind = ev[0]
    if kind == "ret":
        _topic, mw = ev[1], ev[2]
        if mw is None:
            state["retained"].pop(_topic, None)
        else:
            state["retained"][_topic] = mw
    elif kind == "sess+":
        # a create resets the slate: any prior subs/pending belonged to the
        # terminated predecessor (its sess- may share this journal window)
        state["sessions"][ev[1]] = {"info": ev[2], "subs": {}, "pending": {}}
    elif kind == "sess-":
        state["sessions"].pop(ev[1], None)
    elif kind == "off":
        # session went offline at wall time ev[2]: the expiry countdown
        # anchor, so a restart resumes the REMAINING window, not a full one
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess["info"]["disconnected_at"] = ev[2]
    elif kind == "on":
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess["info"].pop("disconnected_at", None)
            if len(ev) > 2 and ev[2]:
                # a resume re-fences the session (shared.py next_fence):
                # recovery must restore the HIGHEST fence it held, or a
                # healed partition would prefer a peer's staler copy
                sess["info"]["fence"] = ev[2]
    elif kind == "sub":
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess["subs"][ev[2]] = ev[3]
    elif kind == "unsub":
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess["subs"].pop(ev[2], None)
    elif kind == "msg":
        # one fan-out's payload, journaled ONCE and referenced by each
        # per-subscriber enq record (1,000 subscribers must not commit
        # 1,000 copies of the body inside the publisher's ack barrier)
        state.setdefault("msgs", {})[str(ev[1])] = ev[2]
    elif kind == "enq":
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess["pending"][str(ev[2])] = ev[3]
    elif kind == "ack":
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess["pending"].pop(str(ev[2]), None)
    elif kind == "q2+":
        # publisher-side QoS2 dedup window: a persistent publisher's DUP
        # resend after a broker crash must hit the dedup, not re-fan-out
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess.setdefault("q2", {})[str(ev[2])] = True
    elif kind == "q2-":
        sess = state["sessions"].get(ev[1])
        if sess is not None:
            sess.setdefault("q2", {}).pop(str(ev[2]), None)
    elif kind == "dly+":
        state.setdefault("delayed", {})[str(ev[1])] = [ev[2], ev[3]]
    elif kind == "dly-":
        state.setdefault("delayed", {}).pop(str(ev[1]), None)
    # unknown kinds are skipped: an older broker reading a newer journal
    # degrades to ignoring what it cannot fold instead of refusing to boot


class DurabilityService:
    """The journaled-state plane (module docstring). One per broker; built
    by ``ServerContext`` only when ``[durability] enable = true``."""

    def __init__(self, ctx, cfg) -> None:
        self.ctx = ctx
        self.flush_interval = max(0.0005, cfg.durability_flush_interval_ms / 1000.0)
        self.flush_max = max(1, cfg.durability_flush_max)
        self.compact_min = max(16, cfg.durability_compact_min)
        self.backend = "redis" if cfg.durability_storage else "sqlite"
        if cfg.durability_storage:
            from rmqtt_tpu_torch.storage import make_store

            self.store = make_store({"storage": cfg.durability_storage,
                                     "prefix": "rmqtt-dur"})
        else:
            from rmqtt_tpu_torch.storage.sqlite import SqliteStore

            # the journal is the durability contract: per-commit fsync
            # (group-committed, so the hot path amortizes it) unless the
            # operator explicitly trades it away with sync = "normal"
            self.store = SqliteStore(cfg.durability_path,
                                     synchronous=cfg.durability_sync)
        # ride the context-wide expire sweep like the plugin stores (the
        # durability rows carry no TTL today, but the registration keeps
        # the "every configured store is swept" contract uniform)
        ctx.add_store(self.store)
        # ----- journal state (event loop owns _buf/_seq; flusher commits)
        self._buf: List[Tuple[int, bytes]] = []
        self._seq = 0
        self._committed = 0
        self._snapshot_seq = 0
        self._waiters: List[Tuple[int, asyncio.Future]] = []
        self._flush_ev = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        # journaling is PARKED until recover() establishes the seq space:
        # plugin start (session storage's restore path calls
        # registry.subscribe, which journals) runs before recover(), and
        # appends issued from seq 0 would collide with — and upsert-
        # overwrite — the previous run's live journal rows once recover()
        # re-anchors _seq to last_valid
        self._recovering = True
        self._compacting = False
        self._compact_fut: Optional[asyncio.Future] = None
        # per-publish body dedup: id(msg) → (strong msg ref, body seq)
        self._body_cache: Dict[int, Tuple[Any, int]] = {}
        #: a torn write means the process is (modeled as) crashing: no
        #: further commits, no further ack barriers resolve — anything not
        #: yet acknowledged stays unacknowledged, preserving zero acked loss
        self.wedged = False
        self._crash_for_test = False  # tests: skip the shutdown flush
        # ----- counters / surfaces
        self.appends = 0
        self.commits = 0
        self.commit_errors = 0
        self.compactions = 0
        self.recovered = {"retained": 0, "sessions": 0, "subs": 0,
                          "inflight": 0, "delayed": 0, "skipped_expired": 0}
        self.recovery_ms = 0.0

    # ----------------------------------------------------------- journal
    def _append(self, event: list) -> int:
        seq = self._seq + 1
        self._seq = seq
        self._buf.append((seq, frame_record(event)))
        self.appends += 1
        if len(self._buf) >= self.flush_max:
            self._flush_ev.set()
        return seq

    # Live hooks — called from the broker hot paths behind a single
    # ``ctx.durability is not None`` guard. All no-ops during recovery
    # (the recovered state is already in the store).
    def on_retain(self, topic: str, msg) -> None:
        if self._recovering:
            return
        from rmqtt_tpu_torch.cluster.messages import msg_to_wire

        self._append(["ret", topic, None if msg is None else msg_to_wire(msg)])

    def on_session_created(self, session) -> None:
        if self._recovering or session.limits.session_expiry <= 0:
            return
        self._append(["sess+", session.client_id, {
            "proto": session.connect_info.protocol,
            "ka": session.connect_info.keepalive,
            "expiry": session.limits.session_expiry,
            "inflight": session.limits.max_inflight,
            "mqueue": session.limits.max_mqueue,
            "created_at": session.created_at,
            "fence": list(session.fence),
        }])

    def on_session_terminated(self, client_id: str) -> None:
        if not self._recovering:
            self._append(["sess-", client_id])

    def on_session_offline(self, client_id: str) -> None:
        """Socket gone: anchor the expiry countdown so a restart resumes
        the REMAINING window (MQTT session-expiry semantics — without the
        anchor a crash-looping broker would refresh every session's full
        expiry on each boot and never expire anything)."""
        if not self._recovering:
            self._append(["off", client_id, time.time()])

    def on_session_online(self, client_id: str, fence=None) -> None:
        """The client resumed before expiry: clear the countdown anchor
        and record the resume's re-fence (each resume stamps a fresh
        fence epoch that must survive a later crash)."""
        if not self._recovering:
            self._append(["on", client_id,
                          list(fence) if fence else None])

    def on_subscribe(self, client_id: str, full_filter: str, opts) -> None:
        if self._recovering:
            return
        from rmqtt_tpu_torch.cluster.messages import opts_to_wire

        self._append(["sub", client_id, full_filter, opts_to_wire(opts)])

    def on_unsubscribe(self, client_id: str, full_filter: str) -> None:
        if not self._recovering:
            self._append(["unsub", client_id, full_filter])

    def _body_ref(self, msg) -> int:
        """Journal this publish's payload ONCE (the fan-out passes the
        same Message object to every subscriber's enqueue); per-subscriber
        enq records carry the returned seq instead of the body. The cache
        holds strong refs, so an id() can't be reused while cached."""
        key = id(msg)
        hit = self._body_cache.get(key)
        if hit is not None and hit[0] is msg:
            return hit[1]
        from rmqtt_tpu_torch.cluster.messages import msg_to_wire

        seq = self._seq + 1
        self._append(["msg", seq, msg_to_wire(msg)])
        self._body_cache[key] = (msg, seq)
        while len(self._body_cache) > 64:
            self._body_cache.pop(next(iter(self._body_cache)))
        return seq

    def on_enqueue(self, client_id: str, item) -> int:
        """A QoS1/2 delivery entered a durable session's queue: journal it
        as pending and return its durable id (the journal seq). The id
        rides the DeliverItem/OutEntry until the subscriber acks."""
        if self._recovering:
            return 0
        ref = self._body_ref(item.msg)
        seq = self._seq + 1  # the id IS the seq this record gets
        return self._append(["enq", client_id, seq,
                             [item.qos, item.retain, item.topic_filter,
                              list(item.sub_ids), ref]])

    def on_ack(self, client_id: str, did: int) -> None:
        """Pending entry resolved: subscriber PUBACK/PUBCOMP, or a terminal
        drop (retries exhausted, expired, queue overflow)."""
        if did and not self._recovering:
            self._append(["ack", client_id, did])

    def on_qos2_open(self, client_id: str, packet_id: int) -> None:
        """Persistent publisher's incoming QoS2 accepted: journal the dedup
        window entry so a post-crash DUP resend can't fan out twice."""
        if not self._recovering:
            self._append(["q2+", client_id, packet_id])

    def on_qos2_release(self, client_id: str, packet_id: int) -> None:
        if not self._recovering:
            self._append(["q2-", client_id, packet_id])

    def on_delayed(self, delay_secs: float, msg) -> int:
        """A ``$delayed`` publish was scheduled: journal it with its wall
        fire time so a restart re-arms the REMAINING delay — its PUBACK
        rides the same barrier as every other journaled record. Returns
        the durable id the DelayedSender's fire resolves."""
        if self._recovering:
            return 0
        from rmqtt_tpu_torch.cluster.messages import msg_to_wire

        seq = self._seq + 1
        return self._append(["dly+", seq, time.time() + delay_secs,
                             msg_to_wire(msg)])

    def on_delayed_done(self, did: int) -> None:
        """The delayed entry fired (and its fan-out's own enq records are
        already journaled ahead of this) or was refused at the cap."""
        if did and not self._recovering:
            self._append(["dly-", did])

    @property
    def dirty(self) -> bool:
        return self._seq > self._committed

    async def barrier(self) -> None:
        """Resolve once everything journaled so far is committed. The ack
        gate: group-committed, so concurrent publishers share one fsync —
        a lone publisher pays at most one flush window of latency."""
        target = self._seq
        if target <= self._committed:
            return
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((target, fut))
        self._flush_ev.set()  # hasten: an ack is waiting on this window
        await fut

    # ------------------------------------------------------------ flusher
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._flush_loop(), name="durability-flush")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._buf and not self.wedged and not self._crash_for_test:
            # clean shutdown: best-effort final commit — SNAPSHOT
            # discipline like the flusher (a record appended while the
            # commit is in flight, e.g. an expiry-task terminate, must not
            # be marked committed and dropped unwritten)
            batch = list(self._buf)
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self._commit_sync, batch)
                self._committed = batch[-1][0]
                del self._buf[: len(batch)]
                self.commits += 1
            except Exception:
                log.warning("durability: final flush failed", exc_info=True)
        self._resolve_waiters()  # committed barriers resolve, not cancel
        for _t, fut in self._waiters:
            if not fut.done():
                fut.cancel()
        self._waiters.clear()
        if self._compact_fut is not None:
            # let an in-flight background compaction finish before the
            # store closes under it
            try:
                await self._compact_fut
            except Exception:
                pass
            self._compact_fut = None
        self.ctx.remove_store(self.store)
        try:
            self.store.close()
        except Exception:
            pass

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                await asyncio.wait_for(self._flush_ev.wait(),
                                       self.flush_interval)
            except asyncio.TimeoutError:
                pass
            self._flush_ev.clear()
            if self.wedged:
                return  # crashed-journal model: no further commits
            if not self._buf:
                continue
            batch = list(self._buf)
            try:
                torn = await loop.run_in_executor(
                    None, self._commit_sync, batch)
            except Exception:
                # storage.fsync fault or a real store failure: the batch
                # stays buffered (barriers keep parking), retried next tick
                self.commit_errors += 1
                if self.commit_errors in (1, 10, 100, 1000):
                    log.warning("durability commit failed (x%d)",
                                self.commit_errors, exc_info=True)
                continue
            self.commits += 1
            del self._buf[: len(batch)]
            if torn:
                # the torn record was "written" but its writer is modeled
                # as crashing mid-append: wedge — anything past the torn
                # point must never be acknowledged
                self.wedged = True
                log.error("durability: torn journal write injected — "
                          "journal wedged (recovery drops the torn tail)")
                return
            self._committed = batch[-1][0]
            self._resolve_waiters()
            if (self._committed - self._snapshot_seq >= self.compact_min
                    and not self._compacting):
                # compaction runs CONCURRENTLY on an executor thread (the
                # store's own lock serializes row access, and the fold
                # only reads seqs ≤ upto, which no live commit touches):
                # an inline await here would stall every group commit —
                # and thus every parked ack barrier — for the whole fold
                self._compacting = True
                self._compact_fut = loop.run_in_executor(
                    None, self._compact_bg, self._committed)

    def _compact_bg(self, upto: int) -> None:
        try:
            self._compact_sync(upto)
        except Exception:
            log.warning("durability compaction failed", exc_info=True)
        finally:
            self._compacting = False

    def _resolve_waiters(self) -> None:
        if not self._waiters:
            return
        keep = []
        for target, fut in self._waiters:
            if target <= self._committed:
                if not fut.done():
                    fut.set_result(None)
            else:
                keep.append((target, fut))
        self._waiters = keep

    def _commit_sync(self, batch: List[Tuple[int, bytes]]) -> bool:
        """One group commit (executor thread). Returns True when the
        torn-write failpoint truncated the final record mid-append."""
        if _FP_FSYNC.action is not None:
            _FP_FSYNC.fire_sync()
        torn = False
        if _FP_TORN.action is not None:
            try:
                _FP_TORN.fire_sync()
            except FailpointError:
                torn = True
        rows = [(_KEY % seq, blob) for seq, blob in batch]
        if torn:
            key, blob = rows[-1]
            rows[-1] = (key, blob[: max(4, len(blob) // 2)])
        self.store.put_many(NS_JOURNAL, rows)
        return torn

    # --------------------------------------------------------- compaction
    def _compact_sync(self, upto: int) -> None:
        """Fold snapshot+journal(≤ upto) into fresh snapshot rows, stamp
        the meta seq, drop the folded journal prefix (executor thread;
        serialized with commits by the flusher loop). Write order makes
        every crash window safe: snapshot rows first (replay is
        idempotent), meta stamp second, journal delete last."""
        state, _last, _torn = self._load_state_sync(upto)
        for ns, fresh in ((NS_SNAP_RETAIN, state["retained"]),
                          (NS_SNAP_SESS, state["sessions"]),
                          (NS_SNAP_DELAYED, state["delayed"]),
                          (NS_SNAP_MSG, state["msgs"])):
            stale = [k for k, _v in self.store.scan(ns) if k not in fresh]
            if fresh:
                self.store.put_many(ns, list(fresh.items()))
            if stale:
                self.store.delete_many(ns, stale)
        self.store.put(NS_META, "snapshot_seq", upto)
        self.store.delete_int_upto(NS_JOURNAL, upto)
        self._snapshot_seq = upto
        self.compactions += 1

    def _load_state_sync(self, upto: Optional[int]):
        """snapshot + journal fold (executor thread) → (state, last_valid
        seq, torn_seq_or_None). Journal rows past a CRC-invalid record are
        a torn tail: dropped (scan-to-last-valid by design)."""
        snap_seq = int(self.store.get(NS_META, "snapshot_seq") or 0)
        state: Dict[str, Any] = {"retained": {}, "sessions": {},
                                 "delayed": {}, "msgs": {}}
        for topic, mw in self.store.scan(NS_SNAP_RETAIN):
            state["retained"][topic] = mw
        for cid, sess in self.store.scan(NS_SNAP_SESS):
            state["sessions"][cid] = sess
        for did_s, row in self.store.scan(NS_SNAP_DELAYED):
            state["delayed"][did_s] = row
        for ref_s, mw in self.store.scan(NS_SNAP_MSG):
            state["msgs"][ref_s] = mw
        rows = [(int(k), blob) for k, blob in self.store.scan(NS_JOURNAL)]
        rows.sort()
        last_valid, torn_at = snap_seq, None
        events = []
        for seq, blob in rows:
            if seq <= snap_seq:
                continue  # pre-snapshot leftovers (compaction crash window)
            if upto is not None and seq > upto:
                break
            ev = decode_record(blob)
            if ev is None:
                torn_at = seq
                break
            events.append(ev)
            last_valid = seq
        self._snapshot_seq = snap_seq
        for ev in events:
            fold_event(state, ev)
        # prune message bodies no live pending references (every enq they
        # backed has acked): keeps the body table bounded by the open
        # pending set, not by publish history
        referenced = {
            str(row[4])
            for sess in state["sessions"].values()
            for row in (sess.get("pending") or {}).values()
            if isinstance(row[4], int)
        }
        state["msgs"] = {k: v for k, v in state["msgs"].items()
                         if k in referenced}
        return state, last_valid, torn_at

    # ----------------------------------------------------------- recovery
    async def recover(self) -> None:
        """Boot phase (server.py, before listeners accept): replay
        snapshot+journal into the live broker. Runs after plugin start so
        retainer-loaded retained rows (possibly stale) are superseded —
        the session-storage plugin refuses to coexist — and with
        journaling suppressed: the recovered state is already durable."""
        t0 = time.monotonic()
        loop = asyncio.get_running_loop()
        state, last_valid, torn_at = await loop.run_in_executor(
            None, self._recover_load_sync)
        self._seq = self._committed = last_valid
        if torn_at is not None:
            log.warning("durability: dropped torn journal tail at seq %d",
                        torn_at)
        post: List[list] = []  # reap events journaled AFTER recovery
        self._recovering = True
        try:
            await self._restore_retained(state["retained"], post)
            await self._restore_sessions(state["sessions"], post,
                                         state.get("msgs") or {})
            self._restore_delayed(state.get("delayed") or {}, post)
        finally:
            self._recovering = False
        # the DelayedSender resolves journaled entries when they fire
        self.ctx.delayed.on_fired = self.on_delayed_done
        for ev in post:
            self._append(ev)
        self.recovery_ms = round((time.monotonic() - t0) * 1000.0, 3)
        r = self.recovered
        log.info(
            "durability recovery: %d retained, %d sessions, %d subs, "
            "%d inflight (%d expired skipped) in %.1fms (journal seq %d)",
            r["retained"], r["sessions"], r["subs"], r["inflight"],
            r["skipped_expired"], self.recovery_ms, last_valid)

    def _recover_load_sync(self):
        state, last_valid, torn_at = self._load_state_sync(None)
        if torn_at is not None:
            # the torn record and anything after it never happened; its
            # rows must not collide with the seqs we are about to re-issue
            victims = [k for k, _b in self.store.scan(NS_JOURNAL)
                       if int(k) >= torn_at]
            if victims:
                self.store.delete_many(NS_JOURNAL, victims)
        return state, last_valid, torn_at

    async def _restore_retained(self, retained: Dict[str, Any],
                                post: List[list]) -> None:
        from rmqtt_tpu_torch.cluster.messages import msg_from_wire

        for topic, mw in retained.items():
            try:
                msg = msg_from_wire(mw)
            except Exception:
                continue
            if msg.is_expired():
                # skipped on restore AND reaped from the durable state, so
                # it cannot resurrect on the next restart either
                self.recovered["skipped_expired"] += 1
                post.append(["ret", topic, None])
                continue
            if self.ctx.retain.set_local(topic, msg):
                self.recovered["retained"] += 1

    async def _restore_sessions(self, sessions: Dict[str, Any],
                                post: List[list],
                                msgs: Dict[str, Any]) -> None:
        from rmqtt_tpu_torch.broker.fitter import Limits
        from rmqtt_tpu_torch.broker.session import DeliverItem, Session
        from rmqtt_tpu_torch.broker.types import ConnectInfo
        from rmqtt_tpu_torch.cluster.messages import msg_from_wire, opts_from_wire
        from rmqtt_tpu_torch.core.topic import strip_prefixes
        from rmqtt_tpu_torch.router.base import Id

        # NOTE: parallels session.py's restore_session() deliberately —
        # this copy must additionally thread the durable `did` through
        # every pending item and read the journal-shaped state; keep the
        # remaining-expiry and fence semantics of the two in lockstep.
        ctx = self.ctx
        loop = asyncio.get_running_loop()
        for cid, sess in sessions.items():
            if ctx.registry.get(cid) is not None:
                continue  # already present (defensive; no plugin coexists)
            info = sess.get("info") or {}
            expiry = float(info.get("expiry", 0.0))
            disc = info.get("disconnected_at")
            if disc is not None:
                # offline when the broker died: resume the REMAINING
                # expiry window (restore_session semantics) — a crash
                # must not refresh the countdown
                expiry = expiry - max(0.0, time.time() - float(disc))
            else:
                # connected when the broker died: the countdown starts at
                # recovery — anchor it durably, or repeated crashes would
                # re-grant the full window every boot
                post.append(["off", cid, time.time()])
            if expiry <= 0:
                self.recovered["skipped_expired"] += 1 if disc else 0
                post.append(["sess-", cid])
                continue
            sid = Id(ctx.cfg.node_id, cid)
            ci = ConnectInfo(id=sid, protocol=int(info.get("proto", 4)),
                             keepalive=int(info.get("ka", 60)),
                             clean_start=False)
            limits = Limits(
                keepalive=int(info.get("ka", 60)), server_keepalive=False,
                max_inflight=int(info.get("inflight", 16)),
                max_mqueue=int(info.get("mqueue", 1000)),
                session_expiry=expiry,
                max_message_expiry=ctx.cfg.fitter.max_message_expiry,
                max_topic_aliases_in=0, max_topic_aliases_out=0,
                max_packet_size=ctx.cfg.max_packet_size,
            )
            session = Session(ctx, sid, ci, limits, clean_start=False)
            fence = info.get("fence")
            if fence:
                # the restored fence must advance the local clock too, or
                # the next takeover could stamp a LOWER fence than the
                # state it resumes (restore_session's contract)
                session.fence = tuple(fence)
                observe = getattr(ctx.registry, "observe_fence", None)
                if observe is not None:
                    observe(int(fence[0]))
            ctx.registry._sessions[cid] = session
            for tf, ow in (sess.get("subs") or {}).items():
                try:
                    stripped = strip_prefixes(tf)
                except ValueError:
                    stripped = tf
                # LOCAL router add, not registry.subscribe: in raft mode
                # the registry proposes through consensus, and boot
                # recovery must never stall (or abort the boot) on an
                # unavailable quorum — the anti-entropy SYNC_ROUTES
                # exchange reconciles peers once the cluster heals
                opts = opts_from_wire(ow)
                ctx.router.add(stripped, session.id, opts)
                session.subscriptions[tf] = opts
                self.recovered["subs"] += 1
            pending = sess.get("pending") or {}
            for did_s in sorted(pending, key=int):
                qos, retain, tf, sub_ids, mw = pending[did_s]
                if isinstance(mw, int):  # deduped body reference
                    mw = msgs.get(str(mw))
                if mw is None:
                    post.append(["ack", cid, int(did_s)])
                    continue
                try:
                    msg = msg_from_wire(mw)
                except Exception:
                    continue
                if msg.is_expired():
                    self.recovered["skipped_expired"] += 1
                    post.append(["ack", cid, int(did_s)])
                    continue
                # unacked QoS1/2 re-delivers with DUP=1 when the client
                # resumes: the crash may have lost the first send's fate
                overflow = session.deliver_queue.push(DeliverItem(
                    msg=msg, qos=int(qos), retain=bool(retain),
                    topic_filter=tf, sub_ids=tuple(sub_ids), dup=True,
                    did=int(did_s)))
                self.recovered["inflight"] += 1
                if overflow is not None and overflow.did:
                    # pendings can exceed max_mqueue (queued + inflight
                    # were journaled separately): DROP_EARLY evicted the
                    # OLDEST restored item — that drop is terminal and
                    # must resolve its record, or it would resurrect and
                    # re-overflow on every restart
                    post.append(["ack", cid, overflow.did])
                    self.recovered["inflight"] -= 1
            # publisher-side QoS2 dedup window: a DUP resend of an
            # already-accepted publish must dedup, not re-fan-out
            for pid_s in (sess.get("q2") or {}):
                session.in_qos2.add(int(pid_s))
            session._expiry_task = loop.create_task(session._expire(expiry))
            self.recovered["sessions"] += 1

    def _restore_delayed(self, delayed: Dict[str, Any],
                         post: List[list]) -> None:
        """Re-arm journaled ``$delayed`` publishes with their REMAINING
        delay (due entries fire immediately); expired messages are reaped.
        A crash between a fire's fan-out and its dly- record replays the
        fire — the delayed path is at-least-once across kill -9."""
        from rmqtt_tpu_torch.cluster.messages import msg_from_wire

        for did_s in sorted(delayed, key=int):
            fire_at, mw = delayed[did_s]
            try:
                msg = msg_from_wire(mw)
            except Exception:
                continue
            if msg.is_expired():
                self.recovered["skipped_expired"] += 1
                post.append(["dly-", int(did_s)])
                continue
            if not self.ctx.delayed.push(
                    max(0.0, float(fire_at) - time.time()), msg,
                    did=int(did_s)):
                post.append(["dly-", int(did_s)])  # cap refusal = terminal
                continue
            self.recovered["delayed"] += 1

    # ----------------------------------------------------------- surfaces
    def snapshot(self) -> dict:
        """/api/v1/durability body (+ the retained digest the torture
        harness compares against its client-side oracle)."""
        return {
            "enabled": True,
            "backend": self.backend,
            "wedged": self.wedged,
            "journal": {
                "seq": self._seq,
                "committed": self._committed,
                "buffered": len(self._buf),
                "snapshot_seq": self._snapshot_seq,
                "len": max(0, self._committed - self._snapshot_seq),
            },
            "appends": self.appends,
            "commits": self.commits,
            "commit_errors": self.commit_errors,
            "compactions": self.compactions,
            "recovered": dict(self.recovered),
            "recovery_ms": self.recovery_ms,
            "flush_interval_ms": round(self.flush_interval * 1000.0, 3),
            "flush_max": self.flush_max,
            "compact_min": self.compact_min,
            "retain_digest": self.ctx.retain.digest(),
        }
