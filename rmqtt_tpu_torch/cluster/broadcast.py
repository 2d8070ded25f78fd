"""Broadcast (scatter-gather) cluster mode.

Mirrors `rmqtt-plugins/rmqtt-cluster-broadcast` (SURVEY.md §2.3): no shared
route table — each node routes its local subscriptions; a publish is
broadcast to every peer, each matches locally and delivers its non-shared
subscribers, returning its shared-subscription candidates; the publishing
node then performs the *global* shared-group choice and sends targeted
``ForwardsTo`` (`src/shared.rs:367-560`). Session takeover kicks fan out via
``select_ok`` (`src/lib.rs:179-200`); retained messages are broadcast on set
and synced from peers at startup (`src/lib.rs:146-149`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.session import DeliverItem
from rmqtt_tpu_torch.broker.shared import SessionRegistry
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.cluster import messages as M
from rmqtt_tpu_torch.cluster.membership import (
    _SYNC_UNHANDLED,
    Membership,
    handle_sync_message,
    retain_digest,
    routes_digest,
)
from rmqtt_tpu_torch.cluster.transport import (
    Broadcaster,
    ClusterReplyError,
    ClusterServer,
    PeerClient,
    PeerUnavailable,
)
from rmqtt_tpu_torch.router.base import Id, SubRelation

log = logging.getLogger("rmqtt_tpu_torch.cluster")


_UNHANDLED = object()


def _spawn(cluster, coro) -> None:
    """Strong-ref'd fire-and-forget task (asyncio holds tasks weakly — an
    unreferenced task could be GC'd before it runs)."""
    task = asyncio.get_running_loop().create_task(coro)
    cluster._bg_tasks.add(task)
    task.add_done_callback(cluster._bg_tasks.discard)


def _bg_notify(cluster, peer, mtype: str, body) -> None:
    """Fire-and-forget peer notify from a handler."""

    async def push():
        try:
            await peer.notify(mtype, body)
        except PeerUnavailable:
            log.warning("%s to node %s failed", mtype, peer.node_id)

    _spawn(cluster, push())


class ClusterNode:
    """Peer-mesh behavior shared by both cluster modes: the peer table with
    overload-registry breakers, the membership failure detector
    (cluster/membership.py), DEAD-peer filtering for the fan-out paths, and
    the retain-sync push with reason-labeled loss accounting."""

    def _init_mesh(
        self,
        ctx,
        listen: Tuple[str, int],
        peers: List[Tuple[int, str, int]],
        sync_retains: bool,
        retain_sync_mode: str,
        heartbeat_interval: float = 1.0,
        suspect_timeout: float = 3.0,
        dead_timeout: float = 6.0,
        alive_hold: int = 2,
        anti_entropy: bool = True,
    ) -> None:
        self.ctx = ctx
        self.server = ClusterServer(listen[0], listen[1], self._on_message)
        self.peers: Dict[int, PeerClient] = {
            nid: PeerClient(nid, host, port) for nid, host, port in peers
        }
        # per-peer circuit breakers come FROM the overload registry so the
        # [overload] breaker_* knobs apply to cluster transport and a dead
        # peer is visible in /api/v1/overload and $SYS (broker/overload.py)
        for nid, p in self.peers.items():
            p.breaker = ctx.overload.breaker(f"cluster.peer.{nid}")
        self.bcast = Broadcaster(list(self.peers.values()))
        # "full": replicate every retain set + startup pull; "topic_only":
        # no replication, lazy per-filter fetch at subscribe time
        # (retain.rs:162 RetainSyncMode Full vs TopicOnly)
        self.retain_sync_mode = retain_sync_mode
        self.sync_retains = sync_retains and retain_sync_mode == "full"
        # strong refs: asyncio holds tasks weakly — an unreferenced
        # background task could be GC'd before it runs
        self._bg_tasks: set = set()
        # heartbeat failure detector + anti-entropy driver ([cluster]
        # heartbeat/suspect/dead knobs); reads self.peers live, so peers
        # injected after start() (test meshes) are probed too
        self.membership = Membership(
            self, ctx,
            heartbeat_interval=heartbeat_interval,
            suspect_timeout=suspect_timeout,
            dead_timeout=dead_timeout,
            alive_hold=alive_hold,
            anti_entropy=anti_entropy,
        )
        ctx.retain.on_set = self._on_retain_set

    @property
    def bound_port(self) -> int:
        return self.server.bound_port

    def spawn(self, coro) -> None:
        _spawn(self, coro)

    # ----------------------------------------------------- peer filtering
    def live_peers(self) -> List[PeerClient]:
        """Peers worth scattering to: membership says not DEAD. SUSPECT
        peers still get traffic (they may only be slow); DEAD peers are
        skipped immediately instead of paying a per-call timeout."""
        ms = self.membership
        return [p for p in self.peers.values() if not ms.is_dead(p.node_id)]

    def kickable_peers(self) -> List[PeerClient]:
        """Peers a takeover kick must consult: DEAD peers and circuit-open
        peers (breaker OPEN, probe window not yet due) hold no reachable
        session by definition — treating them as "no session there" keeps
        CONNECT latency bounded by the heartbeat window, not the RPC
        timeout."""
        ms = self.membership
        out = []
        for p in self.peers.values():
            if ms.is_dead(p.node_id):
                continue
            b = p.breaker
            if b.state == b.OPEN and b.remaining() > 0:
                continue
            out.append(p)
        return out

    def snapshot(self) -> dict:
        """/api/v1/cluster body: membership + repair state + the digests
        the anti-entropy exchange compares (convergence is observable).
        The retain digest is revision-cached in the store (exact); the
        subscription-directory digest is an O(routes) pass with no cheap
        version key, so it is TTL-cached here — admin polls see at most
        ``heartbeat_interval`` of staleness instead of hashing a 10M-route
        table per request (the repair path always recomputes)."""
        now = time.monotonic()
        cached = getattr(self, "_routes_digest_cache", None)
        if cached is None or now - cached[0] > self.membership.heartbeat_interval:
            cached = (now, routes_digest(self.ctx.router))
            self._routes_digest_cache = cached
        return {
            "mode": getattr(self, "mode", "broadcast"),
            "retain_sync_mode": self.retain_sync_mode,
            "membership": self.membership.snapshot(),
            "digests": {
                "retain": retain_digest(self.ctx.retain),
                "subs": cached[1],
            },
        }

    # ----------------------------------------------------- retain push
    def _on_retain_set(self, topic: str, msg: Optional[Message]) -> None:
        """Replicate a retained set/clear to peers (full mode). Pushes that
        cannot be delivered — peer DEAD, or the notify fails — are counted
        as reason-labeled drops (``messages.dropped.retain_sync``) so
        divergence is visible until anti-entropy heals it on rejoin."""
        if self.retain_sync_mode != "full":
            return  # TopicOnly: peers fetch lazily at subscribe time
        body = {"topic": topic, "msg": M.msg_to_wire(msg) if msg else None}

        async def push():
            ms = self.membership
            targets, dead = [], 0
            for p in self.peers.values():
                if ms.is_dead(p.node_id):
                    dead += 1
                else:
                    targets.append(p)
            if dead:
                self.ctx.metrics.drop("retain_sync", dead)
            if targets:
                errs = await Broadcaster(targets).join_all_notify(
                    M.SET_RETAIN, body)
                failed = sum(1 for e in errs if e is not None)
                if failed:
                    self.ctx.metrics.drop("retain_sync", failed)

        self.spawn(push())


async def handle_common_message(ctx, mtype: str, body, cluster=None, from_node=None) -> object:
    """RPC handlers shared by broadcast and raft modes (ForwardsTo, Kick,
    retain sync, counters, liveness). Returns ``_UNHANDLED`` for
    mode-specific types."""
    if mtype == M.FORWARDS_TO:
        msg = M.msg_from_wire(body["msg"])
        # adopt the publisher's trace context (optional field, absent from
        # untraced publishes): spans recorded here carry the SAME trace id
        # and are stitched back by the trace API's cluster fetch
        trace = ctx.tracer.from_wire(body.get("trace"), topic=msg.topic)
        t_tr = time.perf_counter_ns() if trace is not None else 0
        count = 0
        recipients: List[str] = []
        if body.get("p2p"):
            target = ctx.registry.get(body["p2p"])
            if target is None:
                raise ClusterReplyError("no-such-client")  # select_ok tries next peer
            target.enqueue(DeliverItem(msg=msg, qos=msg.qos, retain=False,
                                       topic_filter="", trace=trace))
            count, recipients = 1, [body["p2p"]]
        else:
            wire_cache: dict = {}  # shared per inbound fan-out
            for rw in body["rels"]:
                rel = M.relation_from_wire(rw)
                if ctx.registry._deliver_local(rel.id.client_id, rel.topic_filter,
                                               rel.opts, msg, wire_cache, trace):
                    count += 1
                    recipients.append(rel.id.client_id)
        if trace is not None:
            trace.add("cluster.remote_deliver", t_tr,
                      time.perf_counter_ns() - t_tr,
                      {"count": count, "node": ctx.node_id})
            ctx.tracer.finish(trace)
        # fire-and-forget mark-forwarded ack back to the publishing node
        # (cluster-raft/src/shared.rs:596-613 ForwardsToAck); the sender's
        # node id rides in the body (the transport has no peer identity)
        sender = body.get("from_node", from_node)
        if msg.stored_id is not None and recipients and cluster is not None:
            peer = cluster.peers.get(sender)
            if peer is not None:
                _bg_notify(cluster, peer, M.FORWARDS_TO_ACK,
                           {"sid": msg.stored_id, "recipients": recipients,
                            "ttl": msg.expiry_interval})
        return {"count": count}
    if mtype == M.FORWARDS_TO_ACK:
        mgr = getattr(ctx, "message_mgr", None)
        if mgr is not None:
            for cid in body.get("recipients", []):
                mgr.mark_forwarded(body["sid"], cid, ttl=body.get("ttl"))
        return None
    if mtype == M.MESSAGE_GET:
        # merge_on_read fetch (cluster-raft/src/shared.rs:665-699): return
        # this node's unforwarded stored matches, marking them so the
        # requesting node's replay can't repeat on a later subscribe
        mgr = getattr(ctx, "message_mgr", None)
        if mgr is None:
            return {"msgs": []}
        if getattr(mgr, "_net", False):
            # network store: the scan is multiple socket RTTs — off-loop
            import asyncio as _aio

            rows = await _aio.get_running_loop().run_in_executor(
                None, mgr.load_unforwarded, body["filter"],
                body["client_id"], True)
        else:
            rows = mgr.load_unforwarded(body["filter"], body["client_id"],
                                        mark=True)
        return {"msgs": [[sid, M.msg_to_wire(m)] for sid, m in rows]}
    if mtype == M.KICK:
        session = ctx.registry.get(body["client_id"])
        if session is not None:
            if session.state is not None:
                await session.state.close(kicked=True)
                # wait (bounded) for the old loop to unwind so the caller's
                # new session starts after this one is dead
                for _ in range(100):
                    if not session.connected:
                        break
                    await asyncio.sleep(0.01)
            # resumable session + resuming client: hand the state to the new
            # owner node (the reference's SessionStateTransfer,
            # session.rs:1374-1427) before dropping the local copy
            state = None
            if not body.get("clean_start", True) and session.limits.session_expiry > 0:
                from rmqtt_tpu_torch.broker.session import session_snapshot

                # cap for the RPC frame; persistence paths snapshot uncapped
                state = session_snapshot(session, max_queue_items=5000)
            await ctx.registry.terminate(session, "cluster-kick")
            return {"kicked": True, "state": state}
        return {"kicked": False}
    if mtype == M.GET_RETAINS:
        # "match" requests MQTT wildcard semantics ($-topics excluded from
        # wildcards, topic.rs:185-210) — the subscribe-time TopicOnly fetch;
        # the bare "#" form is the full-store replication pull (startup
        # sync), which must include $-topics
        filt = body.get("filter", "#")
        if body.get("match"):
            items = ctx.retain.matches(filt)
        else:
            items = ctx.retain.all_items() if filt == "#" else ctx.retain.matches(filt)
        return {"retains": [[topic, M.msg_to_wire(m)] for topic, m in items]}
    if mtype == M.SET_RETAIN:
        mw = body.get("msg")
        if mw is None:
            ctx.retain.remove_local(body["topic"])
        else:
            ctx.retain.set_local(body["topic"], M.msg_from_wire(mw))
        return None
    if mtype == M.NUMBER_OF_CLIENTS:
        return {"count": ctx.registry.connected_count()}
    if mtype == M.NUMBER_OF_SESSIONS:
        return {"count": ctx.registry.session_count()}
    if mtype == M.ONLINE:
        s = ctx.registry.get(body["client_id"])
        return {"online": bool(s and s.connected)}
    if mtype == M.SESSION_STATUS:
        s = ctx.registry.get(body["client_id"])
        if s is None:
            return {"exists": False}
        return {"exists": True, "online": s.connected, "subs": len(s.subscriptions)}
    if mtype == M.SUBSCRIPTIONS_GET:
        from rmqtt_tpu_torch.broker.http_api import subscription_rows

        return {"subscriptions": subscription_rows(ctx, int(body.get("limit", 100)))}
    if mtype == M.SUBSCRIPTIONS_SEARCH:
        from rmqtt_tpu_torch.broker.http_api import subscription_search

        return {"subscriptions": subscription_search(ctx, body or {})}
    if mtype == M.ROUTES_GET:
        return {"routes": ctx.router.gets(int(body.get("limit", 100)))}
    if mtype == M.ROUTES_GET_BY:
        from rmqtt_tpu_torch.broker.http_api import routes_by_topic

        return {"routes": routes_by_topic(ctx, body["topic"])}
    if mtype == M.CLIENTS_GET:
        from rmqtt_tpu_torch.broker.http_api import client_info

        limit = int(body.get("limit", 100))
        return {"clients": [client_info(s) for s in list(ctx.registry.sessions())[:limit]]}
    if mtype == M.STATS_GET:
        return {"node": ctx.node_id, "stats": ctx.stats().to_json()}
    if mtype == M.DATA:
        # opaque data channel (grpc.rs Message::Data); carries the admin
        # API's cluster queries that have no dedicated variant
        what = (body or {}).get("what")
        if what == "metrics":
            return {"metrics": ctx.metrics.to_json()}
        if what == "latency":
            # per-node latency histograms for /api/v1/latency/sum; buckets
            # merge by addition on the requesting node
            return {"latency": ctx.telemetry.snapshot()}
        if what == "slo":
            # per-node SLO snapshot for /api/v1/slo/sum; (good, total)
            # pairs sum per objective on the requesting node
            return {"slo": ctx.slo.snapshot()}
        if what == "device":
            # per-node device-plane profiler snapshot for
            # /api/v1/device/sum (broker/devprof.py merge_snapshots)
            from rmqtt_tpu_torch.broker.devprof import DEVPROF

            return {"device": DEVPROF.snapshot()}
        if what == "autotune":
            # per-node autotuner snapshot for /api/v1/autotune/sum
            # (broker/autotune.py merge_snapshots: counters sum, state
            # merges by worst; journals stay per-node)
            return {"autotune": ctx.autotune.snapshot()}
        if what == "host":
            # per-node host-plane profiler snapshot for /api/v1/host/sum
            # (broker/hostprof.py merge_snapshots: lag histograms
            # bucket-merge, counters sum)
            from rmqtt_tpu_torch.broker.hostprof import HOSTPROF

            return {"host": HOSTPROF.snapshot()}
        if what == "history":
            # per-node telemetry timeline for /api/v1/history/sum
            # (broker/history.py merge_snapshots: step buckets align,
            # counters sum, quantile/rate series average, states worst);
            # the range/series/step params forward so every node answers
            # the same question
            return {"history": ctx.history.query(
                series=body.get("series"), frm=body.get("from"),
                to=body.get("to"), step=body.get("step"))}
        if what == "hotkeys":
            # per-node hot-key sketch snapshot for /api/v1/hotkeys/sum
            # (broker/hotkeys.py merge_snapshots: top-k lists fold under
            # the mergeable-summaries rule, totals/counters sum)
            return {"hotkeys": ctx.hotkeys.snapshot()}
        if what == "traces":
            # trace-API cluster fetch (broker/tracing.py): by id → this
            # node's spans for that trace (the requester stitches);
            # otherwise recent/slow summaries for the merged listings
            tid = body.get("id")
            if tid is not None:
                return {"trace": ctx.tracer.get(str(tid))}
            limit = int(body.get("limit", 50))
            if body.get("slow"):
                return {"traces": ctx.tracer.slow_traces(limit)}
            return {"traces": ctx.tracer.recent(limit)}
        if what == "offlines":
            from rmqtt_tpu_torch.broker.http_api import client_info

            return {"clients": [client_info(s) for s in ctx.registry.sessions()
                                if not s.connected]}
        if what == "purge_offlines":
            offl = [s for s in ctx.registry.sessions() if not s.connected]
            for s in offl:
                await ctx.registry.terminate(s, "api-purge-offline")
            return {"purged": len(offl)}
        return {"data": None}
    if mtype == M.PING:
        return {"pong": True}
    # membership heartbeats + anti-entropy exchange (cluster/membership.py)
    res = await handle_sync_message(ctx, mtype, body, cluster=cluster)
    if res is not _SYNC_UNHANDLED:
        return res
    return _UNHANDLED


class ClusterRegistryBase(SessionRegistry):
    """Shared cluster-registry behavior: the cross-node kick + session-state
    transfer protocol used by both broadcast and raft modes."""

    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self.cluster = None

    async def take_or_create(self, ctx, id: Id, connect_info, limits, clean_start: bool):
        # tell peers to drop any session with this id and WAIT for their
        # confirmation (broadcast-mode kick, src/lib.rs:179-200); a resumable
        # session's state comes back in the reply and is rebuilt locally
        # (the reference's SessionStateTransfer). Peers the membership
        # detector marks DEAD — or whose circuit is open — hold no
        # reachable session by definition: they are skipped outright, so a
        # killed node costs CONNECTs nothing once detected (the heartbeat
        # window, not the RPC timeout, bounds the stall) and the rejoin
        # anti-entropy fence pass cleans up any conflict that slips through
        if self.cluster is not None and self.cluster.peers:
            peers = self.cluster.kickable_peers()
            skipped = len(self.cluster.peers) - len(peers)
            if skipped:
                self.ctx.metrics.inc("cluster.kick_skipped", skipped)
            if peers:
                replies = await Broadcaster(peers).join_all_call(
                    M.KICK,
                    {"client_id": id.client_id, "clean_start": clean_start},
                )
                await self._restore_transferred(ctx, id, clean_start, replies)
        return await super().take_or_create(ctx, id, connect_info, limits, clean_start)

    async def retain_load_with(self, topic_filter: str):
        """TopicOnly retain sync (reference retain.rs:162 `retain_sync_mode`
        + :178 `sync_retain_topic`): with no full-store replication, fetch
        the peers' retained matches for exactly this filter at subscribe
        time and dedup by topic keeping the newest create_time
        (shared.rs:1109-1127 dedup_retains_by_topic)."""
        local = self.ctx.retain.matches(topic_filter)
        c = self.cluster
        if c is None or not c.peers or c.retain_sync_mode != "topic_only":
            return local
        best = {topic: msg for topic, msg in local}
        for _nid, reply in await Broadcaster(c.live_peers()).join_all_call(
            M.GET_RETAINS, {"filter": topic_filter, "match": True}
        ):
            if isinstance(reply, Exception):
                continue
            for topic, mw in reply.get("retains", []):
                msg = M.msg_from_wire(mw)
                if msg.is_expired():
                    continue
                cur = best.get(topic)
                if cur is None or msg.create_time > cur.create_time:
                    best[topic] = msg
        return sorted(best.items())

    async def _restore_transferred(self, ctx, id, clean_start: bool, replies) -> None:
        if clean_start or ctx.registry.get(id.client_id) is not None:
            return
        for _nid, reply in replies:
            if isinstance(reply, Exception) or not isinstance(reply, dict):
                continue
            snap = reply.get("state")
            if snap:
                from rmqtt_tpu_torch.broker.session import restore_session

                await restore_session(ctx, snap, node_id=id.node_id)
                return


def _cands_to_wire(shared) -> list:
    return [
        [group, tf, [[sid.node_id, sid.client_id, M.opts_to_wire(opts), online]
                     for sid, opts, online in cands]]
        for (group, tf), cands in shared.items()
    ]


def _cands_from_wire(rows) -> Dict[Tuple[str, str], list]:
    out: Dict[Tuple[str, str], list] = {}
    for group, tf, cands in rows:
        out[(group, tf)] = [
            (Id(n, c), M.opts_from_wire(o), online) for n, c, o, online in cands
        ]
    return out


class ClusterSessionRegistry(ClusterRegistryBase):
    """Registry whose fan-out scatter-gathers across the cluster."""

    async def forwards(self, msg: Message) -> int:
        cluster = self.cluster
        if cluster is None or not cluster.peers:
            return await super().forwards(msg)
        # trace context set by the publish ingress (broker/tracing.py);
        # rides every peer RPC so remote spans share the trace id
        trace = CURRENT_TRACE.get() if self.ctx.telemetry.enabled else None
        tw = M.trace_to_wire(trace)
        if msg.target_clientid is not None:  # p2p: local first, then peers
            if self._sessions.get(msg.target_clientid) is not None:
                return await super().forwards(msg)
            try:
                await Broadcaster(cluster.live_peers()).select_ok(
                    M.FORWARDS_TO, {
                        "msg": M.msg_to_wire(msg),
                        "rels": [],
                        "p2p": msg.target_clientid,
                        "from_node": self.ctx.node_id,
                        "trace": tw,
                    })
                return 1
            except (PeerUnavailable, ClusterReplyError):
                return 0  # no node owns this client
        # 1) local: deliver non-shared, collect shared candidates
        raw = await self.ctx.routing.matches_raw(msg.from_id, msg.topic)
        relmap, shared = raw
        count, _ = self._deliver_relmap(relmap, msg, trace)
        # 2) scatter: LIVE peers deliver their non-shared and reply
        # candidates; membership-DEAD peers are skipped outright (a dead
        # node must not add a call timeout to every publish)
        scatter = cluster.live_peers()
        t_fw = time.perf_counter_ns() if trace is not None else 0
        replies = await Broadcaster(scatter).join_all_call(
            M.FORWARDS, {"msg": M.msg_to_wire(msg), "trace": tw}
        )
        if trace is not None:
            trace.add("cluster.forward", t_fw, time.perf_counter_ns() - t_fw,
                      {"mode": "broadcast", "peers": len(scatter)})
        mgr = getattr(self.ctx, "message_mgr", None)
        merged: Dict[Tuple[str, str], list] = {k: list(v) for k, v in shared.items()}
        for node_id, reply in replies:
            if isinstance(reply, Exception):
                continue
            count += int(reply.get("count", 0))
            # remote live deliveries count as forwarded in this node's store
            # (the broadcast-mode analogue of ForwardsToAck bookkeeping)
            if mgr is not None and msg.stored_id is not None:
                for cid in reply.get("recipients", []):
                    mgr.mark_forwarded(msg.stored_id, cid, ttl=msg.expiry_interval)
            for key, cands in _cands_from_wire(reply.get("shared", [])).items():
                merged.setdefault(key, []).extend(cands)
        # 3) global shared-group choice (src/shared.rs:516-560)
        remote_targets: Dict[int, List[SubRelation]] = {}
        for (group, tf), cands in merged.items():
            idx = self.ctx.router._shared_choice(group, tf, cands)
            if idx is None:
                continue
            sid, opts, _ = cands[idx]
            rel = SubRelation(tf, sid, opts)
            if trace is not None:
                # zero-duration marker: WHO won the cluster-global
                # round-robin for this publish (the decision, not a stage)
                trace.add_wall("shared.choice", 0, {
                    "group": group, "filter": tf,
                    "node": sid.node_id, "client": sid.client_id})
            if sid.node_id == self.ctx.node_id:
                count += self._deliver_local(sid.client_id, tf, opts, msg,
                                             trace=trace)
            else:
                remote_targets.setdefault(sid.node_id, []).append(rel)
        for node_id, rels in remote_targets.items():
            peer = cluster.peers.get(node_id)
            if peer is None:
                continue
            if cluster.membership.is_dead(node_id):
                # targeted shared-sub deliveries to a DEAD node: lost, but
                # lost FAST and reason-labeled (no per-publish timeout)
                self.ctx.metrics.drop("peer_dead", len(rels))
                continue
            try:
                await peer.notify(M.FORWARDS_TO, {
                    "msg": M.msg_to_wire(msg),
                    "rels": [M.relation_to_wire(r) for r in rels],
                    "p2p": None,
                    "from_node": self.ctx.node_id,
                    "trace": tw,
                })
                count += len(rels)
                self.ctx.metrics.inc("cluster.forwards")
            except PeerUnavailable:
                # the targeted shared-sub deliveries are lost: reason-label
                # them (circuit_open when the breaker is holding the peer
                # off, plain unreachable otherwise)
                reason = ("circuit_open"
                          if peer.breaker.state != peer.breaker.CLOSED
                          else "peer_unreachable")
                self.ctx.metrics.drop(reason, len(rels))
                log.warning("ForwardsTo to node %s failed (%s)", node_id, reason)
        return count

    def _deliver_relmap(self, relmap, msg: Message, trace=None) -> Tuple[int, List[str]]:
        count = 0
        recipients: List[str] = []
        wire_cache: dict = {}  # shared per fan-out (frame reuse)
        for _node, rels in relmap.items():
            for rel in rels:
                if self._deliver_local(rel.id.client_id, rel.topic_filter,
                                       rel.opts, msg, wire_cache, trace):
                    count += 1
                    recipients.append(rel.id.client_id)
        return count, recipients

class BroadcastCluster(ClusterNode):
    mode = "broadcast"

    def __init__(
        self,
        ctx,
        listen: Tuple[str, int],
        peers: List[Tuple[int, str, int]],
        sync_retains: bool = True,
        retain_sync_mode: str = "full",
        **membership_opts,
    ) -> None:
        self._init_mesh(ctx, listen, peers, sync_retains, retain_sync_mode,
                        **membership_opts)
        assert isinstance(ctx.registry, ClusterSessionRegistry), (
            "cluster mode needs ServerContext(registry='cluster')"
        )
        ctx.registry.cluster = self

    async def start(self) -> None:
        await self.server.start()
        self.membership.start()

    async def start_sync(self) -> None:
        """Pull retained messages from peers (startup sync, lib.rs:146-149)."""
        if not self.sync_retains:
            return
        for node_id, reply in await Broadcaster(self.live_peers()).join_all_call(
            M.GET_RETAINS, {"filter": "#"}
        ):
            if isinstance(reply, Exception):
                continue
            for topic, mw in reply.get("retains", []):
                msg = M.msg_from_wire(mw)
                self.ctx.retain.set_local(topic, msg)

    async def stop(self) -> None:
        await self.membership.stop()
        await self.server.stop()
        for p in self.peers.values():
            await p.close()

    # ------------------------------------------------------------ inbound
    async def _on_message(self, mtype: str, body: Any, _from_node) -> Any:
        ctx = self.ctx
        # cluster-RPC arrival hook (hook.rs GrpcMessageReceived — our RPC
        # mesh replaces gRPC but keeps the event)
        await ctx.hooks.fire(HookType.GRPC_MESSAGE_RECEIVED, mtype, _from_node, None)
        if mtype == M.FORWARDS:
            # scatter-gather: deliver local non-shared, reply shared candidates
            msg = M.msg_from_wire(body["msg"])
            # adopt the publisher's trace for THIS node's spans (the
            # contextvar makes the local routing queue/match stages stamp
            # them; trace id comes off the wire, so the publisher's trace
            # API fetch stitches the remote hop in)
            trace = ctx.tracer.from_wire(body.get("trace"), topic=msg.topic)
            tok = CURRENT_TRACE.set(trace) if trace is not None else None
            t_tr = time.perf_counter_ns() if trace is not None else 0
            try:
                raw = await ctx.routing.matches_raw(msg.from_id, msg.topic)
                relmap, shared = raw
                count, recipients = ctx.registry._deliver_relmap(relmap, msg, trace)
            finally:
                if tok is not None:
                    CURRENT_TRACE.reset(tok)
            if trace is not None:
                trace.add("cluster.remote_match", t_tr,
                          time.perf_counter_ns() - t_tr,
                          {"count": count, "node": ctx.node_id})
                ctx.tracer.finish(trace)
            return {"count": count, "shared": _cands_to_wire(shared),
                    "recipients": recipients if msg.stored_id is not None else []}
        res = await handle_common_message(ctx, mtype, body, cluster=self, from_node=_from_node)
        if res is not _UNHANDLED:
            return res
        raise ValueError(f"unknown cluster message {mtype!r}")