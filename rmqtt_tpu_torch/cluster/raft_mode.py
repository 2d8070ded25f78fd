"""Raft cluster mode: strongly-consistent replicated routing.

Mirrors `rmqtt-plugins/rmqtt-cluster-raft` (SURVEY.md §2.3): every node holds
the FULL route table; subscription add/remove go through Raft proposals and
apply on every node (`src/router.rs:146-196, 350-353`), so `matches()` stays
node-local with no per-publish consensus (:199-201). Publish fan-out matches
locally and sends targeted ``ForwardsTo`` to the nodes owning remote
subscribers (`src/shared.rs:454-538`). Cross-node kick and retain sync reuse
the broadcast-mode RPCs.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.session import DeliverItem
from rmqtt_tpu_torch.broker.shared import SessionRegistry
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import HandshakeLockedError, Message
from rmqtt_tpu_torch.cluster import messages as M
from rmqtt_tpu_torch.cluster.broadcast import (
    _UNHANDLED,
    _spawn,
    ClusterNode,
    ClusterRegistryBase,
    handle_common_message,
)
from rmqtt_tpu_torch.cluster.raft import (
    RAFT_APPEND,
    RAFT_PROPOSE,
    RAFT_SNAP,
    RAFT_VOTE,
    RaftNode,
)
from rmqtt_tpu_torch.cluster.transport import (
    Broadcaster,
    ClusterReplyError,
    PeerUnavailable,
)
from rmqtt_tpu_torch.router.base import Id, SubRelation

log = logging.getLogger("rmqtt_tpu_torch.cluster.raft")

# how long a granted handshake lock shields a client id from a competing
# connect on another node (the reference's try-lock timeout,
# cluster-raft/src/shared.rs:71-106)
HS_LOCK_TTL = 10.0


class RaftSessionRegistry(ClusterRegistryBase):
    """Registry whose router mutations go through Raft and whose fan-out
    sends targeted ForwardsTo to subscriber-owning nodes."""

    async def take_or_create(self, ctx, id: Id, connect_info, limits, clean_start: bool):
        """Serialize concurrent connects of the same client id ACROSS nodes
        through a raft-replicated handshake lock (shared.rs:71-106
        HandshakeTryLock) before running the kick/takeover protocol."""
        c = self.cluster
        nonce = None
        if c is not None and c.peers:
            nonce = await c.handshake_try_lock(id.client_id)
            if nonce is None:
                raise HandshakeLockedError(id.client_id)
        try:
            return await super().take_or_create(ctx, id, connect_info, limits, clean_start)
        finally:
            if nonce is not None:
                c.handshake_unlock_bg(id.client_id, nonce)

    # subscription writes → consensus (router.rs:146-196)
    async def router_add(self, stripped: str, id, opts) -> None:
        c = self.cluster
        if c is None or not c.peers:
            self.ctx.router.add(stripped, id, opts)
            return
        ok = await c.raft.propose(
            {"op": "add", "tf": stripped, "node": id.node_id,
             "client": id.client_id, "opts": M.opts_to_wire(opts)}
        )
        if not ok:
            # the entry may still commit later (it stays in the log);
            # compensate so a late commit can't leave a ghost route
            _spawn(c, c.raft.propose({"op": "remove", "tf": stripped,
                                      "node": id.node_id, "client": id.client_id},
                                     timeout=30.0))
            raise ClusterReplyError("raft propose (add) failed")

    def _retry_in_background(self, entry) -> None:
        """Removals must eventually apply — retry with a long deadline when
        consensus is briefly unavailable (no leader / partition)."""
        c = self.cluster
        _spawn(c, c.raft.propose(entry, timeout=120.0))

    async def router_remove(self, stripped: str, id) -> None:
        c = self.cluster
        if c is None or not c.peers:
            self.ctx.router.remove(stripped, id)
            return
        entry = {"op": "remove", "tf": stripped, "node": id.node_id, "client": id.client_id}
        if not await c.raft.propose(entry):
            self._retry_in_background(entry)

    async def router_remove_many(self, items) -> None:
        """One consensus round for a whole session's removals (terminate)."""
        c = self.cluster
        if c is None or not c.peers:
            for stripped, id in items:
                self.ctx.router.remove(stripped, id)
            return
        entry = {
            "op": "remove_many",
            "items": [[stripped, id.node_id, id.client_id] for stripped, id in items],
        }
        if not await c.raft.propose(entry):
            self._retry_in_background(entry)

    async def forwards(self, msg: Message) -> int:
        c = self.cluster
        if c is None or not c.peers:
            return await super().forwards(msg)
        # trace context from the publish ingress (broker/tracing.py); rides
        # the targeted ForwardsTo so the owning nodes' spans stitch back
        trace = CURRENT_TRACE.get() if self.ctx.telemetry.enabled else None
        tw = M.trace_to_wire(trace)
        if msg.target_clientid is not None:
            if self._sessions.get(msg.target_clientid) is not None:
                return await super().forwards(msg)
            try:
                await c.bcast.select_ok(M.FORWARDS_TO, {
                    "msg": M.msg_to_wire(msg), "rels": [], "p2p": msg.target_clientid,
                    "from_node": self.ctx.node_id, "trace": tw,
                })
                return 1
            except (PeerUnavailable, ClusterReplyError):
                return 0
        # match locally over the replicated table (shared.rs:461-467)
        relmap, shared = await self.ctx.routing.matches_raw(msg.from_id, msg.topic)
        count = 0
        remote: Dict[int, List[SubRelation]] = {}
        wire_cache: dict = {}  # shared per fan-out (frame reuse)
        for node_id, rels in relmap.items():
            if node_id == self.ctx.node_id:
                for rel in rels:
                    count += self._deliver_local(rel.id.client_id, rel.topic_filter,
                                                 rel.opts, msg, wire_cache, trace)
            else:
                remote.setdefault(node_id, []).extend(rels)
        # shared groups: all candidates are in the replicated table — choose
        # here, globally (router.rs:236-255 does the choice at match time)
        my_node = self.ctx.node_id
        for (group, tf), cands in shared.items():
            # remote members' liveness is unknown locally — treat them as
            # online so they aren't starved out of the group choice
            cands = [
                (sid, opts, on if sid.node_id == my_node else True)
                for sid, opts, on in cands
            ]
            idx = self.ctx.router._shared_choice(group, tf, cands)
            if idx is None:
                continue
            sid, opts, _ = cands[idx]
            if trace is not None:
                trace.add_wall("shared.choice", 0, {
                    "group": group, "filter": tf,
                    "node": sid.node_id, "client": sid.client_id})
            if sid.node_id == my_node:
                count += self._deliver_local(sid.client_id, tf, opts, msg,
                                             trace=trace)
            else:
                remote.setdefault(sid.node_id, []).append(SubRelation(tf, sid, opts))
        t_fw = time.perf_counter_ns() if (trace is not None and remote) else 0
        for node_id, rels in remote.items():
            peer = c.peers.get(node_id)
            if peer is None:
                continue
            if c.membership.is_dead(node_id):
                # the replicated table still lists the dead node's
                # subscribers; dropping fast + reason-labeled beats paying
                # a breaker-mediated connect attempt per publish
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
                log.warning("raft ForwardsTo to node %s failed", node_id)
        if t_fw:
            trace.add("cluster.forward", t_fw, time.perf_counter_ns() - t_fw,
                      {"mode": "raft", "nodes": sorted(remote)})
        return count


class RaftCluster(ClusterNode):
    """Raft node + cluster RPC server, swapped in like the broadcast mode."""

    mode = "raft"

    def __init__(
        self,
        ctx,
        listen: Tuple[str, int],
        peers: List[Tuple[int, str, int]],
        sync_retains: bool = True,
        raft_db: Optional[str] = None,
        retain_sync_mode: str = "full",
        **membership_opts,
    ) -> None:
        self._init_mesh(ctx, listen, peers, sync_retains, retain_sync_mode,
                        **membership_opts)
        storage = None
        if raft_db:
            from rmqtt_tpu_torch.storage.sqlite import SqliteStore

            storage = SqliteStore(raft_db)
        self.raft = RaftNode(
            ctx.node_id, self.peers, self._apply, storage=storage,
            snapshot_cb=self._snapshot_state, restore_cb=self._restore_state,
        )
        assert isinstance(ctx.registry, RaftSessionRegistry), (
            "raft mode needs ServerContext with registry='raft'"
        )
        ctx.registry.cluster = self
        # distributed handshake-lock table (part of the replicated state):
        # client_id -> [node_id, ts, nonce]
        self.hs_locks: Dict[str, list] = {}
        self._hs_results: Dict[str, bool] = {}
        # nonces a local handshake is still awaiting; _apply only records
        # results for these (a lock entry committing after its proposer gave
        # up must not leave an orphan result behind)
        self._hs_pending: set = set()

    async def start(self) -> None:
        await self.server.start()
        # a storage-loaded snapshot must hit the router BEFORE the log
        # re-applies on top of it
        await self.raft.restore_pending()
        self.raft.start()
        self.membership.start()

    async def start_sync(self) -> None:
        if not self.sync_retains or not self.peers:
            return
        for _nid, reply in await Broadcaster(self.live_peers()).join_all_call(
            M.GET_RETAINS, {"filter": "#"}
        ):
            if isinstance(reply, Exception):
                continue
            for topic, mw in reply.get("retains", []):
                self.ctx.retain.set_local(topic, M.msg_from_wire(mw))

    async def stop(self) -> None:
        await self.membership.stop()
        await self.raft.stop()
        await self.server.stop()
        for p in self.peers.values():
            await p.close()
        if self.raft.storage is not None:
            self.raft.storage.close()

    # ------------------------------------------------------- replicated ops
    async def _apply(self, entry: Any) -> None:
        """Apply a committed routing op to the LOCAL router (Store::apply,
        cluster-raft/src/router.rs:269-364)."""
        op = entry.get("op")
        if op == "add":
            self.ctx.router.add(
                entry["tf"], Id(entry["node"], entry["client"]),
                M.opts_from_wire(entry["opts"]),
            )
        elif op == "remove":
            self.ctx.router.remove(entry["tf"], Id(entry["node"], entry["client"]))
        elif op == "remove_many":
            for tf, node, client in entry["items"]:
                self.ctx.router.remove(tf, Id(node, client))
        elif op == "hs_lock":
            # deterministic across nodes: decided purely from entry fields
            # and the replicated lock table, in log order. The TTL staleness
            # check compares proposer wall clocks — deterministic, but like
            # the reference's timeout-based try-lock it assumes roughly
            # NTP-synced cluster clocks (skew > HS_LOCK_TTL could steal a
            # live lock or delay breaking a dead one).
            cur = self.hs_locks.get(entry["client"])
            granted = (
                cur is None
                or entry["ts"] - cur[1] > HS_LOCK_TTL  # stale holder (crashed mid-handshake)
                or cur[0] == entry["node"]  # re-entrant on the same node
            )
            if granted:
                self.hs_locks[entry["client"]] = [entry["node"], entry["ts"], entry["nonce"]]
            if entry["node"] == self.ctx.node_id and entry["nonce"] in self._hs_pending:
                self._hs_results[entry["nonce"]] = granted
        elif op == "hs_unlock":
            # nonce-scoped: releasing one handshake's lock must not release
            # a newer re-entrant lock for the same client on the same node
            cur = self.hs_locks.get(entry["client"])
            if cur is not None and cur[0] == entry["node"] and cur[2] == entry["nonce"]:
                del self.hs_locks[entry["client"]]
        else:
            log.warning("unknown raft entry %r", op)

    # -------------------------------------------------- snapshot callbacks
    def _snapshot_state(self):
        """Full replicated state for raft compaction (router.rs:387-460
        snapshot of relations + client states): every route edge plus the
        handshake-lock table."""
        routes = [
            [tf, sid.node_id, sid.client_id, M.opts_to_wire(opts)]
            for tf, sid, opts in self.ctx.router.dump_routes()
        ]
        return {
            "routes": routes,
            "hs_locks": {cid: list(v) for cid, v in self.hs_locks.items()},
        }

    async def _restore_state(self, snap) -> None:
        """Replace local replicated state with a snapshot (router.rs:462-580
        restore path): clear relations, re-add every route."""
        router = self.ctx.router
        existing = [(tf, sid) for tf, sid, _o in list(router.dump_routes())]
        for tf, sid in existing:
            router.remove(tf, sid)
        for tf, node, client, opts in snap.get("routes", []):
            router.add(tf, Id(node, client), M.opts_from_wire(opts))
        self.hs_locks = {cid: list(v) for cid, v in snap.get("hs_locks", {}).items()}
        log.info(
            "raft node %s restored snapshot: %s routes, %s handshake locks",
            self.ctx.node_id, len(snap.get("routes", [])), len(self.hs_locks),
        )

    # -------------------------------------------------- handshake lock API
    async def handshake_try_lock(self, client_id: str, timeout: float = 5.0) -> Optional[str]:
        """Raft-replicated HandshakeTryLock (shared.rs:71-106): exactly one
        node in the cluster wins the right to handshake ``client_id``.
        Returns the lock nonce on success (pass it to unlock), else None."""
        import time as _time
        import uuid as _uuid

        nonce = _uuid.uuid4().hex
        entry = {
            "op": "hs_lock", "client": client_id, "node": self.ctx.node_id,
            "nonce": nonce, "ts": _time.time(),
        }
        self._hs_pending.add(nonce)
        try:
            if not await self.raft.propose(entry, timeout=timeout):
                # the entry may still commit later; compensate so an
                # unobserved late grant cannot orphan the lock until TTL
                self._hs_results.pop(nonce, None)
                self.handshake_unlock_bg(client_id, nonce)
                return None
            return nonce if self._hs_results.pop(nonce, False) else None
        finally:
            self._hs_pending.discard(nonce)

    def handshake_unlock_bg(self, client_id: str, nonce: str) -> None:
        entry = {
            "op": "hs_unlock", "client": client_id,
            "node": self.ctx.node_id, "nonce": nonce,
        }
        _spawn(self, self.raft.propose(entry, timeout=30.0))

    # -------------------------------------------------------------- inbound
    async def _on_message(self, mtype: str, body: Any, _from_node) -> Any:
        if mtype in (RAFT_VOTE, RAFT_APPEND, RAFT_PROPOSE, RAFT_SNAP):
            # raft heartbeats are too hot for a hook dispatch per message
            return await self.raft.on_message(mtype, body)
        await self.ctx.hooks.fire(HookType.GRPC_MESSAGE_RECEIVED, mtype, _from_node, None)
        if mtype == M.PING:
            return {"pong": True, "leader": self.raft.leader_id, "term": self.raft.term}
        res = await handle_common_message(
            self.ctx, mtype, body, cluster=self, from_node=_from_node
        )
        if res is not _UNHANDLED:
            return res
        raise ValueError(f"unknown cluster message {mtype!r}")
