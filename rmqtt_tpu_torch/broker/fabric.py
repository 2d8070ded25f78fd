"""Intra-node routing fabric: one device-table owner per node, UDS mesh.

``--workers N`` used to peer the SO_REUSEPORT workers as a localhost
*broadcast cluster*: every cross-worker publish paid full cluster-RPC
serialization against every peer (an O(workers) scatter-gather match), and
every CONNECT paid an O(workers) kick scatter. This module replaces that
with a node-local fabric:

- **Router owner.** One worker (``fabric.owner_id``, worker 1 by default)
  holds the node's single authoritative device table: every worker forwards
  its subscription mutations to the owner, so the owner's router — and only
  the owner's — sees the union. Publishes are *submitted* to the owner in
  batches over a per-worker UDS link; the owner runs match once per batch on
  the shared device plane (through its normal ``RoutingService``, so the
  match cache, micro-batcher and pipelined device dispatch all apply) and
  returns per-worker fan-out plans.

- **UDS mesh, length-prefixed frames.** Every worker listens on
  ``<fabric.dir>/fabric-<wid>.sock``; links are lazy outbound connections
  carrying ``cluster/wire.py``-encoded frames (4-byte BE length prefix) with
  optional correlation ids — the wire primitives without the full cluster
  RPC stack (no breakers, no membership; a dead link IS a dead worker and
  the supervisor's problem).

- **Zero-copy fan-out.** The submitting worker delivers its own slice of
  the plan locally and writes one ``deliver`` frame per remote worker:
  message + relations + the per-(version, retain) QoS0 wire frames already
  encoded for the plan's subscriber population. Receivers seed each
  ``DeliverItem``'s shared ``wire_cache`` with those bytes, so a
  10K-subscriber fan-out encodes each (version, flags) frame once
  node-wide and peer workers write bytes, not re-encoded Message objects.

- **Subscription directory.** The owner maintains ``client_id →
  (worker, online, protocol)`` and replicates it to workers as compact
  epoch-tagged deltas over the same links. CONNECT-time kicks become O(1):
  a directory miss is *no RPC at all* (the common case — a fresh client),
  a hit is one targeted kick to the owning worker. The directory also
  backs the owner router's shared-subscription liveness.

- **Fault handling.** Workers detect owner death on the UDS link; submits
  park (bounded by ``submit_deadline_s``) while a keeper reconnects with
  backoff, then **re-register** — full session/subscription/retained state
  — so a respawned owner rebuilds the table and directory from worker
  replicas. Past the deadline a publish degrades to worker-local match
  (reason-counted) instead of stalling forever. The ``fabric.submit``
  failpoint injects exactly this seam for chaos drills.

Without ``[fabric] enable``, none of this is constructed and ``--workers``
behaves exactly as before (localhost broadcast cluster) — pinned by test.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.session import DeliverItem, restore_session, session_snapshot
from rmqtt_tpu_torch.broker.shared import SessionRegistry
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.cluster import wire
from rmqtt_tpu_torch.cluster.messages import (
    msg_from_wire,
    msg_to_wire,
    opts_from_wire,
    opts_to_wire,
    relation_from_wire,
    relation_to_wire,
)
from rmqtt_tpu_torch.router.base import Id, SubRelation
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, FailpointError

log = logging.getLogger("rmqtt_tpu_torch.fabric")

#: chaos seam (utils/failpoints.py): fires on every publish submission to
#: the router owner — an injected error degrades that publish to
#: worker-local match, exactly like an owner outage past the deadline
_FP_SUBMIT = FAILPOINTS.register("fabric.submit")

# frame vocabulary (all frames: {"t": type, "b": body, "corr"?: int})
F_REGISTER = "register"  # worker → owner: full state (sessions/subs/retains)
F_ATTACH = "attach"      # worker → owner: session connected here
F_DETACH = "detach"      # worker → owner: session terminated here
F_ONLINE = "online"      # worker → owner: online-flag flip (durable offline)
F_SUB_ADD = "sub_add"    # worker → owner: subscription added
F_SUB_DEL = "sub_del"    # worker → owner: subscription removed
F_SUBMIT = "submit"      # worker → owner: publish batch → fan-out plans
F_DELIVER = "deliver"    # worker → worker: message + rels + QoS0 frames
F_KICK = "kick"          # worker → worker: targeted takeover kick
F_DIR = "dir"            # owner → worker: epoch-tagged directory delta
F_DIR_SYNC = "dir_sync"  # worker → owner: full directory pull (gap repair)
F_RETAIN = "retain"      # retained set/clear replication (owner relays)
F_GEN = "gen"            # owner → worker: table-generation bump (plan cache)


class FabricUnavailable(ConnectionError):
    """The owner link is down (or the ``fabric.submit`` failpoint fired)
    and the bounded wait expired: the caller degrades to local-only
    routing for this publish."""


class _Link:
    """One lazy outbound UDS connection to a peer worker.

    ``call`` (correlation id + timeout) and ``notify`` (fire-and-forget),
    like the cluster ``PeerClient`` but without the breaker/backoff
    machinery: fabric links are node-local — a connect failure means the
    peer process is dead, which the supervisor handles. Frames arriving
    WITHOUT a correlation id are owner→worker pushes (directory deltas,
    retain replication) and dispatch into ``handler``."""

    def __init__(self, fabric: "FabricService", wid: int, path: str) -> None:
        self.fabric = fabric
        self.wid = wid
        self.path = path
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._corr = itertools.count(1)
        self._wlock = asyncio.Lock()
        self._connect_lock = asyncio.Lock()

    @property
    def connected(self) -> bool:
        return self._writer is not None

    async def _ensure(self) -> None:
        if self._writer is not None:
            return
        # serialize: concurrent senders on a fresh link (keeper register vs
        # an attach, kick vs deliver flush) must not open duplicate
        # connections — the loser's orphaned read-loop would later tear
        # down the healthy winner
        async with self._connect_lock:
            if self._writer is not None:
                return
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(self.path),
                    self.fabric.call_timeout)
            except (OSError, asyncio.TimeoutError) as e:
                raise FabricUnavailable(
                    f"fabric worker {self.wid} unreachable: {e}") from e
            self._writer = writer
            self._reader_task = asyncio.get_running_loop().create_task(
                self._read_loop(reader))

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                frame = await wire.read_frame(reader)
                corr = frame.get("corr")
                if corr is not None and "reply" in frame:
                    fut = self._pending.pop(corr, None)
                    if fut is not None and not fut.done():
                        fut.set_result(frame["reply"])
                    continue
                # owner → worker push riding the worker-initiated link
                self.fabric._dispatch_push(frame)
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self.teardown(ConnectionError("fabric link lost"))
            self.fabric._on_link_down(self.wid)

    def teardown(self, exc: Exception) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
        for fut in self._pending.values():
            if not fut.done():
                try:
                    fut.set_exception(FabricUnavailable(str(exc)))
                except RuntimeError:
                    pass  # event loop already closed (interpreter teardown)
        self._pending.clear()

    async def close(self) -> None:
        task, self._reader_task = self._reader_task, None
        if task is not None:
            task.cancel()
        self.teardown(ConnectionError("closed"))
        if task is not None:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def _send(self, obj: dict) -> None:
        await self._ensure()
        data = wire.frame(obj)
        try:
            async with self._wlock:
                writer = self._writer  # a concurrent teardown may None it
                if writer is None:
                    raise FabricUnavailable(
                        f"fabric link to worker {self.wid} lost")
                writer.write(data)
                await writer.drain()
        except (OSError, ConnectionError) as e:
            self.teardown(e)
            raise FabricUnavailable(str(e)) from e
        self.fabric.bytes_out += len(data)

    async def notify(self, mtype: str, body: Any = None) -> None:
        await self._send({"t": mtype, "b": body})

    async def call(self, mtype: str, body: Any = None,
                   timeout: Optional[float] = None) -> Any:
        corr = next(self._corr)
        fut = asyncio.get_running_loop().create_future()
        self._pending[corr] = fut
        try:
            await self._send({"t": mtype, "b": body, "corr": corr})
            reply = await asyncio.wait_for(
                fut, timeout or self.fabric.call_timeout)
            if isinstance(reply, dict) and "__err" in reply:
                raise FabricUnavailable(reply["__err"])
            return reply
        except asyncio.TimeoutError as e:
            raise FabricUnavailable(
                f"fabric call {mtype} to worker {self.wid} timed out") from e
        finally:
            self._pending.pop(corr, None)


class FabricService:
    """Per-worker fabric runtime: the UDS server + link table, plus the
    owner's table/directory state or the worker's replica/submit queue."""

    def __init__(self, ctx, cfg) -> None:
        self.ctx = ctx
        self.worker_id = int(cfg.fabric_worker_id or cfg.node_id)
        self.owner_id = int(cfg.fabric_owner_id)
        self.sock_dir = cfg.fabric_dir
        self.is_owner = self.worker_id == self.owner_id
        self.batch_max = max(1, int(cfg.fabric_batch_max))
        self.call_timeout = float(cfg.fabric_call_timeout_s)
        self.submit_deadline = float(cfg.fabric_submit_deadline_s)
        self.expected_workers = int(cfg.fabric_workers)
        self.warm_grace = float(cfg.fabric_warm_grace_s)
        self.running = False
        self._server = None
        self._links: Dict[int, _Link] = {}
        # ---- counters (RoutingService.stats() → every admin surface)
        self.batches = 0          # submit batches (client: sent; owner: served)
        self.items = 0            # publishes through submit batches
        self.bytes_out = 0        # bytes written on fabric links
        self.deliver_out = 0      # deliver frames sent to peers
        self.deliver_in = 0       # deliver frames received
        self.kicks_o1 = 0         # CONNECTs whose kick resolved via directory
        self.kick_rpcs = 0        # of those, targeted kick RPCs (≤1 each)
        self.plan_hits = 0        # publishes served from the worker plan cache
        self.owner_reconnects = 0
        self.submit_fallbacks = 0  # publishes degraded to local-only match
        self.submit_ms_total = 0.0   # client-side submit→plan wall
        self.fanout_ms_total = 0.0   # client-side remote deliver-frame wall
        # ---- owner state
        self.directory: Dict[str, list] = {}  # cid → [wid, online, ver]
        self.dir_epoch = 0
        self._worker_subs: Dict[int, set] = {}   # wid → {(tf, cid)}
        self._worker_conns: Dict[int, tuple] = {}  # wid → (writer, wlock)
        # cid → live subscription count in the owner table: directory ops
        # for a subscription-LESS client (the bulk of a connect storm)
        # cannot change any fan-out plan, so they must not invalidate the
        # node's plan caches (_dir_mutate consults this before bumping)
        self._cid_subs: Dict[str, int] = {}
        # ---- owner table generation: bumped on every SUBSCRIPTION-TABLE
        # mutation (sub add/remove, register, purge) and on directory ops
        # touching clients that hold subscriptions, then pushed to workers
        # — the validity stamp of worker plan caches
        self.table_gen = 0
        # ---- worker state
        self.replica: Dict[str, list] = {}
        self.replica_epoch = 0
        # worker-side fan-out PLAN cache (the match-cache discipline at the
        # fabric seam): a plan the owner marked cacheable (no shared-group
        # choice involved) is reused for repeat (topic, publisher, qos,
        # retain) publishes while the owner's table generation is unchanged
        # — hot cross-worker publishes then pay ZERO submit RPCs node-wide.
        # Any table/directory mutation bumps the generation (pushed as
        # F_GEN / riding dir deltas and submit replies), invalidating every
        # cached plan at once — coarse, but stale serves are bounded by one
        # push latency, never by a TTL.
        self.remote_gen = -1  # unknown until the first owner contact
        self._plan_cache: Dict[tuple, tuple] = {}  # key → (gen, plan)
        self._owner_link: Optional[_Link] = None
        self._owner_up = asyncio.Event()
        self._keeper: Optional[asyncio.Task] = None
        self._submit_task: Optional[asyncio.Task] = None
        self._submit_q: list = []  # [(fut, item, deadline_monotonic)]
        self._submit_evt = asyncio.Event()
        # pipelined submission (the RoutingService pipeline_depth idea at
        # the fabric seam): up to 4 submit batches in flight to the owner,
        # so sustained throughput is not capped at batch_max per UDS RTT
        self._submit_sem = asyncio.Semaphore(4)
        self._bg: set = set()
        self._conns: set = set()  # inbound writers (closed on stop)
        # deliver coalescing: concurrent publishes targeting the same peer
        # worker merge into ONE frame per flush cycle (the deliver-side
        # analogue of submit batching — frame overhead amortizes across a
        # burst instead of costing one frame per publish per worker)
        self._dq: Dict[int, list] = {}
        self._dq_evt = asyncio.Event()
        self._deliver_task: Optional[asyncio.Task] = None
        # owner warm-up gate: a (re)spawned owner must not plan fan-outs
        # against a table still missing workers' re-registrations — early
        # submits would be acked yet silently skip their subscribers. The
        # gate opens when every expected worker has registered, or after
        # warm_grace seconds (a permanently-dead worker must not stall the
        # node forever).
        self._warm = asyncio.Event()

    # ------------------------------------------------------------ lifecycle
    def sock_path(self, wid: int) -> str:
        return os.path.join(self.sock_dir, f"fabric-{wid}.sock")

    async def start(self) -> None:
        os.makedirs(self.sock_dir, exist_ok=True)
        path = self.sock_path(self.worker_id)
        try:
            os.unlink(path)  # stale socket from a previous incarnation
        except FileNotFoundError:
            pass
        self._server = await asyncio.start_unix_server(self._on_conn, path)
        self.running = True
        self._deliver_task = asyncio.get_running_loop().create_task(
            self._deliver_flush_loop())
        if self.is_owner:
            self._wrap_online()
            self._owner_up.set()
            if self.expected_workers <= 1:
                self._warm.set()
            else:
                self._spawn(self._warm_grace_timer())
        else:
            self._owner_link = _Link(self, self.owner_id,
                                     self.sock_path(self.owner_id))
            self._keeper = asyncio.get_running_loop().create_task(
                self._owner_keeper())
            self._submit_task = asyncio.get_running_loop().create_task(
                self._submit_loop())
        # retained replication: every local retain set/clear crosses the
        # fabric (owner applies + relays), so subscribe-time replay works
        # on whichever worker a client lands on
        self.ctx.retain.on_set = self._on_retain_set
        # durable sessions going offline flip the directory online flag so
        # the owner's shared-subscription liveness stays honest node-wide
        self.ctx.hooks.register(
            HookType.CLIENT_DISCONNECTED, self._on_client_disconnected)
        log.info("fabric worker %s%s listening on %s", self.worker_id,
                 " (owner)" if self.is_owner else "", path)

    async def stop(self) -> None:
        self.running = False
        for t in (self._keeper, self._submit_task, self._deliver_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        self._keeper = self._submit_task = self._deliver_task = None
        for fut, _item, _dl in self._submit_q:
            if not fut.done():
                fut.set_exception(FabricUnavailable("fabric stopped"))
        self._submit_q.clear()
        if self._owner_link is not None:
            await self._owner_link.close()
        for link in self._links.values():
            await link.close()
        self._links.clear()
        for t in list(self._bg):
            t.cancel()
        if self._server is not None:
            self._server.close()
            # close live inbound links too: peers must see EOF NOW (their
            # owner-down detection), and py3.12 wait_closed would otherwise
            # wait on connection handlers that serve forever
            for w in list(self._conns):
                try:
                    w.close()
                except Exception:
                    pass
            await self._server.wait_closed()
            self._server = None
        try:
            os.unlink(self.sock_path(self.worker_id))
        except OSError:
            pass

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    async def _warm_grace_timer(self) -> None:
        await asyncio.sleep(self.warm_grace)
        if not self._warm.is_set():
            log.warning(
                "fabric owner warm-up grace expired with %d/%d workers "
                "registered; serving submits anyway",
                len(self._worker_conns), max(0, self.expected_workers - 1))
            self._warm.set()

    async def warm_wait(self) -> None:
        """Block until the owner's table covers every expected worker (or
        the grace expired) — one event check once warm."""
        if not self._warm.is_set():
            await self._warm.wait()

    def _wrap_online(self) -> None:
        """Owner: liveness for remote workers' clients comes from the
        directory, not the local registry (the cache's captured closure is
        re-pointed too — it was bound at ServerContext construction)."""
        router = self.ctx.router
        orig = getattr(router, "_is_online", lambda cid: True)

        def online(cid: str) -> bool:
            ent = self.directory.get(cid)
            if ent is not None:
                return bool(ent[1])
            return orig(cid)

        router._is_online = online
        cache = getattr(self.ctx.routing, "cache", None)
        if cache is not None:
            cache._is_online = online

    # ------------------------------------------------------- link plumbing
    def link(self, wid: int) -> _Link:
        if wid == self.owner_id and self._owner_link is not None:
            return self._owner_link
        link = self._links.get(wid)
        if link is None:
            link = self._links[wid] = _Link(self, wid, self.sock_path(wid))
        return link

    def _on_link_down(self, wid: int) -> None:
        if wid == self.owner_id and not self.is_owner and self.running:
            self._owner_up.clear()

    def _dispatch_push(self, frame: dict) -> None:
        """A push frame (no reply expected) arriving on an outbound link."""
        self._spawn(self._handle(frame.get("t"), frame.get("b"), None))

    async def _on_conn(self, reader, writer) -> None:
        from types import SimpleNamespace

        # handler context: the inbound push channel + (after a REGISTER
        # frame) the connected worker's identity
        conn = SimpleNamespace(writer=writer, wlock=asyncio.Lock(), wid=None)
        self._conns.add(writer)
        pending: set = set()

        async def dispatch(frame: dict) -> None:
            mtype, body, corr = frame.get("t"), frame.get("b"), frame.get("corr")
            try:
                reply = await self._handle(mtype, body, conn)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.exception("fabric handler error for %s", mtype)
                reply = {"__err": f"{type(e).__name__}: {e}"}
            if corr is not None:
                try:
                    data = wire.frame({"corr": corr, "reply": reply})
                    async with conn.wlock:
                        writer.write(data)
                        await writer.drain()
                    self.bytes_out += len(data)
                except (ConnectionError, OSError):
                    pass

        try:
            while True:
                frame = await wire.read_frame(reader)
                task = asyncio.get_running_loop().create_task(dispatch(frame))
                pending.add(task)
                task.add_done_callback(pending.discard)
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self._conns.discard(writer)
            for t in pending:
                t.cancel()
            if conn.wid is not None and self.is_owner:
                # the worker's register link died: that worker is gone —
                # purge its table slice and directory entries so matches
                # stop planning deliveries into a dead process
                if self._worker_conns.get(conn.wid, (None,))[0] is writer:
                    del self._worker_conns[conn.wid]
                    self._purge_worker(conn.wid)
            try:
                writer.close()
            except Exception:
                pass

    # --------------------------------------------------------- worker side
    async def _owner_keeper(self) -> None:
        """Keep the owner link registered: (re)connect with backoff, replay
        full local state, seed the directory replica, release submits."""
        backoff = 0.05
        while True:
            if self._owner_up.is_set():
                await asyncio.sleep(0.2)
                continue
            try:
                reply = await self._owner_link.call(
                    F_REGISTER, self._register_body(), timeout=self.call_timeout)
                self.replica = {cid: list(ent) for cid, ent in
                                (reply.get("directory") or {}).items()}
                self.replica_epoch = int(reply.get("epoch", 0))
                self._observe_gen(reply.get("gen"))
                for topic, mw in reply.get("retains", []):
                    self._merge_retain(topic, mw)
                self.owner_reconnects += 1
                self._owner_up.set()
                self._submit_evt.set()
                backoff = 0.05
                log.info("fabric worker %s registered with owner (epoch %s)",
                         self.worker_id, self.replica_epoch)
            except (FabricUnavailable, OSError):
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 1.0)

    def _register_body(self) -> dict:
        from rmqtt_tpu_torch.core.topic import strip_prefixes

        sessions, subs = [], []
        for s in self.ctx.registry.sessions():
            sessions.append([s.client_id, bool(s.connected),
                             int(s.connect_info.protocol)])
            for full_filter, opts in s.subscriptions.items():
                try:
                    stripped = strip_prefixes(full_filter)
                except Exception:
                    stripped = full_filter
                subs.append([stripped, s.client_id, opts_to_wire(opts)])
        retains = [[t, msg_to_wire(m)] for t, m in self.ctx.retain.all_items()]
        return {"wid": self.worker_id, "sessions": sessions, "subs": subs,
                "retains": retains}

    async def submit_publish(self, msg: Message) -> dict:
        """Queue one publish for batched submission to the owner; returns
        the decoded fan-out plan. Raises :class:`FabricUnavailable` when
        the owner stayed unreachable past ``submit_deadline_s`` (or the
        ``fabric.submit`` failpoint is armed)."""
        if _FP_SUBMIT.action is not None:
            try:
                await _FP_SUBMIT.fire_async()
            except FailpointError as e:
                raise FabricUnavailable(str(e)) from e
        fid = msg.from_id
        cid = fid.client_id if fid else ""
        key = (msg.topic, cid, int(msg.qos), bool(msg.retain))
        ent = self._plan_cache.get(key)
        if ent is not None and ent[0] == self.remote_gen:
            # hot path: the owner's plan for this (topic, publisher) is
            # still valid under the current table generation — zero RPCs
            self.plan_hits += 1
            return ent[1]
        item = [fid.node_id if fid else self.worker_id, cid, msg.topic,
                int(msg.qos), bool(msg.retain)]
        fut = asyncio.get_running_loop().create_future()
        self._submit_q.append(
            (fut, item, time.monotonic() + self.submit_deadline))
        self._submit_evt.set()
        plan = await fut
        if plan.get("c") and plan.get("_gen") == self.remote_gen:
            self._plan_cache[key] = (plan["_gen"], plan)
        return plan

    async def _submit_loop(self) -> None:
        while True:
            await self._submit_evt.wait()
            if not self._submit_q:
                self._submit_evt.clear()
                continue
            if not self._owner_up.is_set():
                # owner down: park until the keeper re-registers, bounded
                # by the OLDEST queued item's deadline — then degrade
                timeout = self._submit_q[0][2] - time.monotonic()
                if timeout > 0:
                    try:
                        await asyncio.wait_for(self._owner_up.wait(), timeout)
                    except asyncio.TimeoutError:
                        pass
                if not self._owner_up.is_set():
                    now = time.monotonic()
                    keep = []
                    for fut, item, dl in self._submit_q:
                        if dl <= now:
                            if not fut.done():
                                fut.set_exception(FabricUnavailable(
                                    "router owner unreachable"))
                        else:
                            keep.append((fut, item, dl))
                    self._submit_q[:] = keep
                    continue
            batch, self._submit_q[:] = (self._submit_q[:self.batch_max],
                                        self._submit_q[self.batch_max:])
            await self._submit_sem.acquire()
            self._spawn(self._submit_one(batch))

    async def _submit_one(self, batch: list) -> None:
        t0 = time.perf_counter()
        try:
            # a (re)spawned owner may legitimately HOLD submits behind its
            # warm-up gate for up to warm_grace seconds — the call timeout
            # must cover that, or every timeout triggers a spurious full
            # re-register storm during recovery
            reply = await self._owner_link.call(
                F_SUBMIT, {"items": [it for _f, it, _d in batch]},
                timeout=self.call_timeout + self.warm_grace)
        except FabricUnavailable:
            self._owner_up.clear()
            self._submit_q[:0] = batch  # retry after re-register
            self._submit_evt.set()
            return
        finally:
            self._submit_sem.release()
        self.submit_ms_total += (time.perf_counter() - t0) * 1e3
        self.batches += 1
        self.items += len(batch)
        self._observe_gen(reply.get("gen"))
        gen = reply.get("gen")
        plans = reply.get("plans") or []
        for (fut, _item, _dl), plan in zip(batch, plans):
            if fut.done():
                continue
            if "err" in plan:
                fut.set_exception(FabricUnavailable(plan["err"]))
            else:
                plan["_gen"] = gen  # plan-cache validity stamp
                fut.set_result(plan)
        for fut, _item, _dl in batch[len(plans):]:
            if not fut.done():
                fut.set_exception(FabricUnavailable("short plan reply"))

    # ---------------------------------------------------------- owner side
    def _dir_mutate(self, ops: List[list]) -> None:
        """Apply directory ops locally and push one epoch-tagged delta to
        every registered worker. Op row: [cid, wid_or_None, online, ver].

        The table generation only bumps when an op touches a client that
        HOLDS subscriptions (its ver/online/worker feed plan frame specs
        and shared liveness); attach/detach of subscription-less clients —
        the bulk of a connect storm — leave every worker's plan cache
        intact."""
        for cid, wid, online, ver in ops:
            if wid is None:
                self.directory.pop(cid, None)
            else:
                self.directory[cid] = [wid, bool(online), int(ver)]
        if any(self._cid_subs.get(op[0], 0) > 0 for op in ops):
            self.table_gen += 1
        prev = self.dir_epoch
        self.dir_epoch += 1
        body = {"prev": prev, "epoch": self.dir_epoch, "ops": ops,
                "gen": self.table_gen}
        for wid, (writer, wlock) in list(self._worker_conns.items()):
            self._spawn(self._push(wid, writer, wlock, F_DIR, body))

    def _bump_gen(self) -> None:
        """Table mutation outside a directory delta (sub add/remove,
        register, purge): invalidate every worker's plan cache NOW."""
        self.table_gen += 1
        body = {"gen": self.table_gen}
        for wid, (writer, wlock) in list(self._worker_conns.items()):
            self._spawn(self._push(wid, writer, wlock, F_GEN, body))

    def _observe_gen(self, gen) -> None:
        """Worker: adopt a newer table generation (cached plans stamped
        with an older one stop serving instantly — the stamp check)."""
        if gen is not None and int(gen) > self.remote_gen:
            self.remote_gen = int(gen)
            if len(self._plan_cache) > 8192:
                self._plan_cache.clear()  # bound memory across many gens

    async def _push(self, wid: int, writer, wlock, mtype: str, body) -> None:
        try:
            data = wire.frame({"t": mtype, "b": body})
            async with wlock:
                writer.write(data)
                await writer.drain()
            self.bytes_out += len(data)
        except (ConnectionError, OSError):
            log.warning("fabric push %s to worker %s failed", mtype, wid)

    def _purge_worker(self, wid: int) -> None:
        self._bump_gen()
        router = self.ctx.router
        for tf, cid in self._worker_subs.pop(wid, set()):
            try:
                router.remove(tf, Id(wid, cid))
            except Exception:
                pass
            self._cid_subs_add(cid, -1)
        ops = [[cid, None, False, 0] for cid, ent in self.directory.items()
               if ent[0] == wid]
        if ops:
            self._dir_mutate(ops)
        log.info("fabric owner purged worker %s (%d sessions)", wid, len(ops))

    def _apply_register(self, body: dict, conn) -> dict:
        wid = int(body["wid"])
        self._bump_gen()
        router = self.ctx.router
        # replace any previous incarnation's state wholesale
        if wid in self._worker_conns:
            self._worker_conns.pop(wid, None)
        self._purge_worker(wid)
        subs = set()
        for tf, cid, ow in body.get("subs", []):
            router.add(tf, Id(wid, cid), opts_from_wire(ow))
            subs.add((tf, cid))
            self._cid_subs_add(cid)
        self._worker_subs[wid] = subs
        ops = [[cid, wid, online, ver]
               for cid, online, ver in body.get("sessions", [])]
        if conn is not None:
            conn.wid = wid
            self._worker_conns[wid] = (conn.writer, conn.wlock)
        if len(self._worker_conns) >= self.expected_workers - 1:
            self._warm.set()
        if ops:
            self._dir_mutate(ops)
        for topic, mw in body.get("retains", []):
            self._merge_retain(topic, mw, relay_from=wid)
        return {
            "epoch": self.dir_epoch,
            "gen": self.table_gen,
            "directory": {cid: list(ent)
                          for cid, ent in self.directory.items()},
            "retains": [[t, msg_to_wire(m)]
                        for t, m in self.ctx.retain.all_items()],
        }

    def partition_plan(self, relmap, qos: int, retain: bool,
                       local_wid: int) -> Tuple[List[SubRelation], dict, list]:
        """Split a collapsed relation map into (local rels, {wid: [rel
        wire]}, needed QoS0 frame specs). Relations carry their owning
        worker in ``Id.node_id`` (that is the id each worker registers
        under), so partitioning needs no directory lookups."""
        local: List[SubRelation] = []
        remote: Dict[int, list] = {}
        specs = set()
        for node_id, rels in relmap.items():
            for rel in rels:
                wid = rel.id.node_id
                if wid == local_wid:
                    local.append(rel)
                    continue
                remote.setdefault(wid, []).append(relation_to_wire(rel))
                if (min(rel.opts.qos, qos) == 0
                        and not rel.opts.subscription_ids):
                    ent = self.directory.get(rel.id.client_id)
                    ver = ent[2] if ent else 4
                    specs.add((ver, retain and rel.opts.retain_as_published))
        return local, remote, [[v, r] for v, r in specs]

    async def _plan_items(self, items: List[list]) -> List[dict]:
        """Owner: match a submitted batch once on the shared device plane
        and return per-worker fan-out plans. Items run concurrently so the
        owner's RoutingService batcher coalesces them into real device
        batches (one match per batch node-wide)."""
        routing = self.ctx.routing
        router = self.ctx.router

        async def one(item):
            node, cid, topic, qos, retain = item
            from_id = Id(int(node), cid) if cid else None
            raw = await routing.matches_raw(from_id, topic)
            # shared-group choice is per publish (round robin): a plan
            # that involved one must never be reused from a worker cache
            cacheable = not raw[1]
            relmap = router.collapse(raw)
            _local, remote, specs = self.partition_plan(
                relmap, int(qos), bool(retain), local_wid=int(node))
            # the submitter's own slice rides under its wid so one loop on
            # the far side delivers everything (local + remote view)
            if _local:
                remote[int(node)] = [relation_to_wire(r) for r in _local]
            plan = {"rels": remote, "fspecs": specs}
            if cacheable:
                plan["c"] = 1
            return plan

        results = await asyncio.gather(
            *(one(it) for it in items), return_exceptions=True)
        plans = []
        for res in results:
            if isinstance(res, BaseException):
                plans.append({"err": f"{type(res).__name__}: {res}"})
            else:
                plans.append(res)
        return plans

    # ------------------------------------------------------------ delivery
    def encode_frames(self, msg: Message, specs: List[list],
                      wire_cache: dict) -> List[list]:
        """Encode the plan's QoS0 frame specs ONCE (into the local fan-out's
        ``wire_cache`` too, so local deliver loops reuse the same bytes) and
        return the shippable [version, retain, rem, frame] rows."""
        from rmqtt_tpu_torch.broker.session import encode_qos0_frame

        if msg.qos != 0 or not specs:
            return []
        rem = msg.remaining_expiry()
        rows = []
        for ver, retain in specs:
            key = (int(ver), bool(retain), rem)
            data = wire_cache.get(key)
            if data is None:
                data = wire_cache[key] = encode_qos0_frame(
                    msg, int(ver), bool(retain), rem)
            rows.append([key[0], key[1], rem, data])
        return rows

    async def deliver_remote(self, wid: int, msg: Message, rel_rows: list,
                             frames: List[list],
                             p2p: Optional[str] = None) -> bool:
        """One ``deliver`` frame to a peer worker (fire-and-forget, like the
        broadcast mode's targeted ForwardsTo notify). False = the peer is
        unreachable and the rels are lost (reason-counted by the caller)."""
        body = {"msg": msg_to_wire(msg), "rels": rel_rows,
                "frames": frames, "p2p": p2p}
        try:
            await self.link(wid).notify(F_DELIVER, body)
        except FabricUnavailable:
            return False
        self.deliver_out += 1
        return True

    def deliver_enqueue(self, wid: int, body: dict) -> None:
        """Coalescing fast path: queue one publish's deliver body for
        ``wid``; the flush loop merges everything queued per peer into ONE
        frame. Loss (peer unreachable at flush) is reason-counted there."""
        self._dq.setdefault(wid, []).append(body)
        self._dq_evt.set()

    async def _deliver_flush_loop(self) -> None:
        while True:
            await self._dq_evt.wait()
            self._dq_evt.clear()
            if not self._dq:
                continue
            batches, self._dq = self._dq, {}
            for wid, bodies in batches.items():
                try:
                    await self.link(wid).notify(F_DELIVER, {"many": bodies})
                    self.deliver_out += 1
                except FabricUnavailable:
                    lost = sum(max(1, len(b.get("rels") or ()))
                               for b in bodies)
                    self.ctx.metrics.drop("fabric_peer_down", lost)

    def _handle_deliver(self, body: dict) -> int:
        many = body.get("many")
        if many is not None:
            return sum(self._handle_deliver_one(b) for b in many)
        return self._handle_deliver_one(body)

    def _handle_deliver_one(self, body: dict) -> int:
        msg = msg_from_wire(body["msg"])
        self.deliver_in += 1
        registry = self.ctx.registry
        if body.get("p2p"):
            target = registry.get(body["p2p"])
            if target is None:
                self.ctx.metrics.drop("no_session")
                return 0
            target.enqueue(DeliverItem(msg=msg, qos=msg.qos, retain=False,
                                       topic_filter=""))
            return 1
        # seed the shared per-fanout encode cache with the frames the
        # publishing worker already built: same-version QoS0 subscribers
        # here write those bytes straight to their sockets
        wire_cache = {(int(v), bool(r), rem): bytes(data)
                      for v, r, rem, data in body.get("frames", [])}
        count = 0
        for rw in body.get("rels", []):
            rel = relation_from_wire(rw)
            count += registry._deliver_local(
                rel.id.client_id, rel.topic_filter, rel.opts, msg, wire_cache)
        return count

    # ------------------------------------------------------------ retained
    def _merge_retain(self, topic: str, mw: Optional[dict],
                      relay_from: Optional[int] = None) -> None:
        """Apply one replicated retained set/clear, newest create_time wins
        (the broadcast cluster's dedup rule). The owner relays to every
        other registered worker so all stores converge."""
        retain = self.ctx.retain
        if mw is None:
            retain.remove_local(topic)
        else:
            msg = msg_from_wire(mw)
            cur = retain.get(topic)
            if cur is None or msg.create_time >= cur.create_time:
                retain.set_local(topic, msg)
        if self.is_owner:
            body = {"topic": topic, "msg": mw}
            for wid, (writer, wlock) in list(self._worker_conns.items()):
                if wid != relay_from:
                    self._spawn(self._push(wid, writer, wlock, F_RETAIN, body))

    def _on_retain_set(self, topic: str, msg: Optional[Message]) -> None:
        """ctx.retain.on_set hook: replicate a local retained mutation."""
        mw = msg_to_wire(msg) if msg is not None else None
        if self.is_owner:
            self._merge_retain(topic, mw, relay_from=self.worker_id)
            return

        async def push():
            try:
                await self._owner_link.notify(
                    F_RETAIN, {"topic": topic, "msg": mw})
            except FabricUnavailable:
                self.ctx.metrics.drop("retain_sync")

        self._spawn(push())

    # ----------------------------------------------------------- directory
    def directory_entry(self, cid: str) -> Optional[list]:
        table = self.directory if self.is_owner else self.replica
        return table.get(cid)

    def _arbitrate_attach(self, cid: str, new_wid: int) -> None:
        """Owner: two near-simultaneous CONNECTs for one client id can land
        on two workers and BOTH win their directory-miss kick check. The
        owner is the serialization point: an attach that conflicts with a
        live entry on a DIFFERENT worker kicks the earlier copy (arrival
        order at the owner decides — the MQTT newest-wins takeover rule).
        Normal takeovers never get here: their kick+terminate detached the
        old entry before the new attach arrives."""
        old = self.directory.get(cid)
        if old is None or int(old[0]) == new_wid or not old[1]:
            return
        old_wid = int(old[0])
        if old_wid == self.worker_id:
            # stale copy is local to the owner: close it directly
            async def kick_local():
                await self._handle_kick({"cid": cid, "clean_start": True})

            self._spawn(kick_local())
            return

        async def kick_remote():
            try:
                await self.link(old_wid).call(
                    F_KICK, {"cid": cid, "clean_start": True})
            except FabricUnavailable:
                pass  # dead worker: its session is already gone

        self._spawn(kick_remote())
        self.ctx.metrics.inc("fabric.attach_conflicts")

    async def attach(self, cid: str, ver: int, online: bool = True) -> None:
        """Session (re)connected on this worker → directory update."""
        if self.is_owner:
            self._arbitrate_attach(cid, self.worker_id)
            self._dir_mutate([[cid, self.worker_id, online, int(ver)]])
            return
        self.replica[cid] = [self.worker_id, online, int(ver)]
        await self._owner_call_quiet(
            F_ATTACH, {"cid": cid, "wid": self.worker_id,
                       "ver": int(ver), "online": online})

    async def detach(self, cid: str) -> None:
        if self.is_owner:
            self._dir_detach(cid, self.worker_id)
            return
        self.replica.pop(cid, None)
        await self._owner_call_quiet(
            F_DETACH, {"cid": cid, "wid": self.worker_id})

    def _dir_detach(self, cid: str, wid: int) -> None:
        """Owner: drop a directory entry — but only the DETACHING worker's
        own entry. After an attach-conflict arbitration the loser's kick
        fires a detach too; without the wid guard it would erase the
        winner's fresh row."""
        ent = self.directory.get(cid)
        if ent is not None and int(ent[0]) == wid:
            self._dir_mutate([[cid, None, False, 0]])

    async def set_online(self, cid: str, online: bool) -> None:
        if self.is_owner:
            ent = self.directory.get(cid)
            if (ent is not None and int(ent[0]) == self.worker_id
                    and bool(ent[1]) != online):
                self._dir_mutate([[cid, ent[0], online, ent[2]]])
            return
        ent = self.replica.get(cid)
        if ent is not None and int(ent[0]) == self.worker_id:
            ent[1] = online
        await self._owner_call_quiet(
            F_ONLINE, {"cid": cid, "wid": self.worker_id, "online": online})

    async def _owner_call_quiet(self, mtype: str, body) -> None:
        """Directory/subscription bookkeeping call: best-effort — a failure
        means the owner is down, and the re-register replay on reconnect
        restores exactly this state."""
        try:
            await self._owner_link.call(mtype, body)
        except FabricUnavailable:
            self.ctx.metrics.inc("fabric.owner_call_failures")

    def _cid_subs_add(self, cid: str, n: int = 1) -> None:
        cur = self._cid_subs.get(cid, 0) + n
        if cur > 0:
            self._cid_subs[cid] = cur
        else:
            self._cid_subs.pop(cid, None)

    async def sub_add(self, stripped: str, cid: str, opts) -> None:
        if self.is_owner:
            self._cid_subs_add(cid)
            self._bump_gen()  # the local router add WAS the table add
            return
        await self._owner_call_quiet(
            F_SUB_ADD, {"tf": stripped, "cid": cid, "wid": self.worker_id,
                        "opts": opts_to_wire(opts)})

    async def sub_del(self, stripped: str, cid: str) -> None:
        if self.is_owner:
            self._cid_subs_add(cid, -1)
            self._bump_gen()
            return
        await self._owner_call_quiet(
            F_SUB_DEL, {"tf": stripped, "cid": cid, "wid": self.worker_id})

    def _apply_dir_delta(self, body: dict) -> None:
        if int(body.get("prev", -1)) != self.replica_epoch:
            # gap (missed delta): pull the full directory
            self._spawn(self._dir_resync())
            return
        for cid, wid, online, ver in body.get("ops", []):
            if wid is None:
                self.replica.pop(cid, None)
            else:
                self.replica[cid] = [int(wid), bool(online), int(ver)]
        self.replica_epoch = int(body["epoch"])

    async def _dir_resync(self) -> None:
        try:
            reply = await self._owner_link.call(F_DIR_SYNC, {})
        except FabricUnavailable:
            return  # keeper will re-register, which seeds the replica
        self.replica = {cid: list(ent) for cid, ent in
                        (reply.get("directory") or {}).items()}
        self.replica_epoch = int(reply.get("epoch", 0))

    # ----------------------------------------------------------------- kick
    async def kick_via_directory(self, cid: str,
                                 clean_start: bool) -> Optional[dict]:
        """O(1) CONNECT kick: a directory miss is no RPC at all; a hit on
        another worker is ONE targeted kick (never an O(workers) scatter).
        Returns the kick reply (with any transferred session state)."""
        self.kicks_o1 += 1
        ent = self.directory_entry(cid)
        if ent is None or ent[0] == self.worker_id:
            return None  # fresh client or local session: registry handles it
        self.kick_rpcs += 1
        try:
            return await self.link(int(ent[0])).call(
                F_KICK, {"cid": cid, "clean_start": clean_start})
        except FabricUnavailable:
            # owning worker is dead: its session died with it; the owner's
            # purge-on-disconnect removes the stale directory entry
            return None

    async def _handle_kick(self, body: dict) -> dict:
        """Targeted takeover kick (the cluster M.KICK contract: close, wait,
        snapshot resumable state, terminate)."""
        ctx = self.ctx
        session = ctx.registry.get(body["cid"])
        if session is None:
            return {"kicked": False}
        if session.state is not None:
            await session.state.close(kicked=True)
            for _ in range(100):
                if not session.connected:
                    break
                await asyncio.sleep(0.01)
        state = None
        if not body.get("clean_start", True) and session.limits.session_expiry > 0:
            state = session_snapshot(session, max_queue_items=5000)
        await ctx.registry.terminate(session, "cluster-kick")
        return {"kicked": True, "state": state}

    # ------------------------------------------------------------- handlers
    async def _handle(self, mtype: str, body, conn) -> Any:
        if mtype == F_SUBMIT:
            await self.warm_wait()
            self.batches += 1
            items = body.get("items", [])
            self.items += len(items)
            return {"plans": await self._plan_items(items),
                    "gen": self.table_gen}
        if mtype == F_DELIVER:
            return {"count": self._handle_deliver(body)}
        if mtype == F_KICK:
            return await self._handle_kick(body)
        if mtype == F_REGISTER:
            return self._apply_register(body, conn)
        if mtype == F_ATTACH:
            wid = (conn.wid if conn is not None and conn.wid is not None
                   else int(body.get("wid", 0)))
            self._arbitrate_attach(body["cid"], wid)
            self._dir_mutate([[body["cid"], wid, body.get("online", True),
                               int(body.get("ver", 4))]])
            return {"epoch": self.dir_epoch}
        if mtype == F_DETACH:
            wid = (conn.wid if conn is not None and conn.wid is not None
                   else int(body.get("wid", 0)))
            self._dir_detach(body["cid"], wid)
            return {"epoch": self.dir_epoch}
        if mtype == F_ONLINE:
            wid = (conn.wid if conn is not None and conn.wid is not None
                   else int(body.get("wid", 0)))
            ent = self.directory.get(body["cid"])
            if ent is not None and int(ent[0]) == wid:
                self._dir_mutate([[body["cid"], ent[0],
                                   bool(body.get("online", False)), ent[2]]])
            return {"epoch": self.dir_epoch}
        if mtype == F_SUB_ADD:
            wid = (conn.wid if conn is not None and conn.wid is not None
                   else int(body.get("wid", 0)))
            self.ctx.router.add(body["tf"], Id(wid, body["cid"]),
                                opts_from_wire(body["opts"]))
            self._worker_subs.setdefault(wid, set()).add(
                (body["tf"], body["cid"]))
            self._cid_subs_add(body["cid"])
            self._bump_gen()
            return None
        if mtype == F_SUB_DEL:
            wid = (conn.wid if conn is not None and conn.wid is not None
                   else int(body.get("wid", 0)))
            try:
                self.ctx.router.remove(body["tf"], Id(wid, body["cid"]))
            except Exception:
                pass
            self._worker_subs.get(wid, set()).discard(
                (body["tf"], body["cid"]))
            self._cid_subs_add(body["cid"], -1)
            self._bump_gen()
            return None
        if mtype == F_DIR:
            self._apply_dir_delta(body)
            self._observe_gen(body.get("gen"))
            return None
        if mtype == F_GEN:
            self._observe_gen(body.get("gen"))
            return None
        if mtype == F_DIR_SYNC:
            return {"epoch": self.dir_epoch,
                    "directory": {cid: list(ent)
                                  for cid, ent in self.directory.items()}}
        if mtype == F_RETAIN:
            wid = conn.wid if conn is not None and conn.wid else None
            self._merge_retain(body["topic"], body.get("msg"), relay_from=wid)
            return None
        raise ValueError(f"unknown fabric frame {mtype!r}")

    async def _on_client_disconnected(self, _htype, args, _prev):
        sid = args[0]
        s = self.ctx.registry.get(sid.client_id)
        if s is not None and not s.connected and self.running:
            await self.set_online(sid.client_id, False)
        return None

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """/api/v1/fabric body."""
        return {
            "enabled": True,
            "running": self.running,
            "worker_id": self.worker_id,
            "owner_id": self.owner_id,
            "role": "owner" if self.is_owner else "worker",
            "socket": self.sock_path(self.worker_id),
            "owner_up": self.is_owner or self._owner_up.is_set(),
            "directory": {
                "epoch": self.dir_epoch if self.is_owner else self.replica_epoch,
                "size": len(self.directory if self.is_owner else self.replica),
            },
            "table_gen": self.table_gen if self.is_owner else self.remote_gen,
            "plan_cache_size": len(self._plan_cache),
            "links": sorted(
                [wid for wid, lk in self._links.items() if lk.connected]
                + ([self.owner_id] if self._owner_link is not None
                   and self._owner_link.connected else [])),
            "registered_workers": sorted(self._worker_conns)
            if self.is_owner else None,
            "counters": {
                "batches": self.batches,
                "items": self.items,
                "bytes_out": self.bytes_out,
                "deliver_in": self.deliver_in,
                "deliver_out": self.deliver_out,
                "kicks_o1": self.kicks_o1,
                "kick_rpcs": self.kick_rpcs,
                "plan_hits": self.plan_hits,
                "owner_reconnects": self.owner_reconnects,
                "submit_fallbacks": self.submit_fallbacks,
                "submit_ms_total": round(self.submit_ms_total, 3),
                "fanout_ms_total": round(self.fanout_ms_total, 3),
            },
        }


class FabricSessionRegistry(SessionRegistry):
    """Session registry whose cross-worker paths ride the fabric: publishes
    submit to the router owner for one node-wide match, kicks resolve O(1)
    through the directory replica, subscription mutations replicate to the
    owner's table. With the fabric not running (startup, owner outage past
    the deadline) every path degrades to the plain local registry."""

    async def forwards(self, msg: Message) -> int:
        fab = self.ctx.fabric
        if fab is None or not fab.running:
            return await super().forwards(msg)
        trace = CURRENT_TRACE.get() if self.ctx.telemetry.enabled else None
        if msg.target_clientid is not None:
            if self._sessions.get(msg.target_clientid) is not None:
                return await super().forwards(msg)
            ent = fab.directory_entry(msg.target_clientid)
            if ent is None or ent[0] == fab.worker_id:
                return 0
            ok = await fab.deliver_remote(int(ent[0]), msg, [], [],
                                          p2p=msg.target_clientid)
            if not ok:
                self.ctx.metrics.drop("fabric_peer_down")
                return 0
            self._mark_forwarded(msg, msg.target_clientid)
            return 1
        if fab.is_owner:
            # the owner's local router IS the node table: match here, then
            # partition by owning worker (behind the same warm-up gate a
            # submitted batch takes — a just-respawned owner's table may
            # still be missing workers' re-registrations)
            await fab.warm_wait()
            raw = await self.ctx.routing.matches_raw(msg.from_id, msg.topic)
            relmap = self.ctx.router.collapse(raw)
            local, remote, specs = fab.partition_plan(
                relmap, msg.qos, msg.retain, local_wid=fab.worker_id)
        else:
            try:
                plan = await fab.submit_publish(msg)
            except FabricUnavailable:
                # bounded degradation: serve this worker's own subscribers
                # from the local router instead of stalling the publisher
                fab.submit_fallbacks += 1
                self.ctx.metrics.inc("fabric.submit_fallbacks")
                return await super().forwards(msg)
            remote = {int(w): rows for w, rows in
                      (plan.get("rels") or {}).items()}
            local_rows = remote.pop(fab.worker_id, [])
            local = [relation_from_wire(rw) for rw in local_rows]
            specs = plan.get("fspecs") or []
        count = 0
        wire_cache: dict = {}
        frames = fab.encode_frames(msg, specs, wire_cache) if remote else []
        for rel in local:
            count += self._deliver_local(rel.id.client_id, rel.topic_filter,
                                         rel.opts, msg, wire_cache, trace)
        if remote:
            t0 = time.perf_counter()
            mw = msg_to_wire(msg)  # serialized ONCE for every peer worker
            for wid, rows in remote.items():
                fab.deliver_enqueue(wid, {"msg": mw, "rels": rows,
                                          "frames": frames})
                count += len(rows)
                self.ctx.metrics.inc("cluster.forwards")
            fab.fanout_ms_total += (time.perf_counter() - t0) * 1e3
        return count

    async def take_or_create(self, ctx, id: Id, connect_info, limits,
                             clean_start: bool):
        fab = ctx.fabric
        if (fab is not None and fab.running
                and self._sessions.get(id.client_id) is None):
            reply = await fab.kick_via_directory(id.client_id, clean_start)
            if (reply and reply.get("state") and not clean_start
                    and self._sessions.get(id.client_id) is None):
                await restore_session(ctx, reply["state"], node_id=id.node_id)
        session, present = await super().take_or_create(
            ctx, id, connect_info, limits, clean_start)
        if fab is not None and fab.running:
            await fab.attach(id.client_id, ver=connect_info.protocol)
        return session, present

    async def terminate(self, session, reason: str) -> None:
        existed = self._sessions.get(session.client_id) is session
        await super().terminate(session, reason)
        fab = self.ctx.fabric
        if existed and fab is not None and fab.running:
            await fab.detach(session.client_id)

    async def router_add(self, stripped: str, id, opts) -> None:
        await super().router_add(stripped, id, opts)
        fab = self.ctx.fabric
        if fab is not None and fab.running:
            await fab.sub_add(stripped, id.client_id, opts)

    async def router_remove(self, stripped: str, id) -> None:
        await super().router_remove(stripped, id)
        fab = self.ctx.fabric
        if fab is not None and fab.running:
            await fab.sub_del(stripped, id.client_id)
