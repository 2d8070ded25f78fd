"""Cluster membership: heartbeat failure detector + anti-entropy repair.

The cluster transport (`cluster/transport.py`) already fails *calls* fast
once a peer's circuit breaker opens, but nothing owns the question "is that
node part of the cluster right now?" — so every CONNECT paid a full kick
timeout against a dead peer, a partitioned node missed retain pushes
forever, and a healed partition could leave the same client id alive on two
nodes. This module supplies that missing layer, mirroring the reference's
health surface (`rmqtt/src/node.rs` NodeStatus + the grpc client-status
checks in `grpc.rs:286-354`) with a SWIM-style state machine:

- **Failure detector** (:class:`Membership`): a periodic ``HEARTBEAT``
  call per peer drives ALIVE → SUSPECT → DEAD transitions on *time since
  last contact* (so detection latency is configured, not emergent), with
  the hysteresis idiom in the other direction — a SUSPECT/DEAD peer
  must answer ``alive_hold`` consecutive heartbeats before it is promoted
  back to ALIVE, so a flapping link can't bounce the fan-out path.
- **Incarnations**: every node stamps its heartbeats with a per-process
  incarnation number; a changed incarnation means the peer restarted
  between two heartbeats, which triggers the same rejoin repair as an
  observed outage (a fast restart must not dodge anti-entropy).
- **Fence clock**: a cluster-synced monotonic epoch counter (piggybacked
  on heartbeats, Lamport-style merge) backing the session fencing epochs
  stamped by ``take_or_create`` — see ``broker/shared.py``.
- **Anti-entropy on rejoin**: when a peer transitions DEAD → ALIVE (or
  silently restarts), exchange content digests (retained store +
  subscription directory) and repair only the deltas: newest-wins retained
  pull/push, fence-resolved duplicate-session kicks, and (raft mode) a
  route-table merge if the raft log alone didn't reconverge.

Everything here is advisory plumbing around the existing data plane: the
detector never closes sockets, and with no peers configured it costs one
idle task.
"""

from __future__ import annotations

import asyncio
import enum
import hashlib
import logging
import time
from typing import Dict, List, Optional, Tuple

from rmqtt_tpu_torch.cluster import messages as M
from rmqtt_tpu_torch.cluster.transport import PeerUnavailable

log = logging.getLogger("rmqtt_tpu_torch.cluster.membership")

#: retained topics per SYNC_RETAIN_PULL / SYNC_RETAIN_PUSH frame — keeps
#: repair frames far under transport.MAX_FRAME even with 1MB payloads
SYNC_CHUNK = 64
#: pagination sizes for the metadata exchanges (summaries / fences /
#: routes): every anti-entropy frame stays bounded no matter how many
#: retained topics, live sessions, or route edges a node holds —
#: transport.MAX_FRAME hard-rejects oversized frames, so an unchunked
#: exchange would make repair permanently impossible exactly at scale
SUMMARY_PAGE = 10_000
SESSIONS_PAGE = 2_000
ROUTES_PAGE = 5_000


class PeerState(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DEAD = 2


class PeerHealth:
    """Detector state for one peer (all times are ``time.monotonic``)."""

    __slots__ = ("node_id", "state", "last_seen", "since", "fail_streak",
                 "ok_streak", "incarnation", "transitions")

    def __init__(self, node_id: int, now: float) -> None:
        self.node_id = node_id
        self.state = PeerState.ALIVE  # optimistic until proven otherwise
        self.last_seen = now  # last successful contact (or first sight)
        self.since = now  # when the current state was entered
        self.fail_streak = 0
        self.ok_streak = 0
        self.incarnation: Optional[int] = None  # peer's, from its replies
        self.transitions = 0

    def snapshot(self, now: float) -> dict:
        return {
            "node": self.node_id,
            "state": self.state.name,
            "state_value": int(self.state),
            "last_seen_s": round(max(0.0, now - self.last_seen), 3),
            "in_state_s": round(max(0.0, now - self.since), 3),
            "fail_streak": self.fail_streak,
            "incarnation": self.incarnation,
            "transitions": self.transitions,
        }


# --------------------------------------------------------------- digests

def retain_digest(retain) -> dict:
    """Retained-store content digest (RetainStore.digest)."""
    return retain.digest()


def retain_summary(retain) -> Dict[str, list]:
    """Per-topic repair summary (RetainStore.summary)."""
    return retain.summary()


def retain_delta(mine: Dict[str, list], theirs: Dict[str, list]
                 ) -> Tuple[List[str], List[str]]:
    """Newest-wins reconciliation plan: ``(pull, push)`` topic lists.

    A topic goes on ``pull`` when the peer's copy is missing here or newer
    there; on ``push`` when ours is missing there or newer here. Equal
    create_times with different payload hashes tie-break on the hash (any
    deterministic order works — both sides must just pick the SAME side),
    so two nodes that each ran the exchange converge instead of ping-pong.
    Note the scheme is state-based with no tombstones: a topic *removed* on
    one side during a partition is indistinguishable from one it never had,
    so the surviving copy wins (documented in README "Cluster failure
    domains")."""
    pull: List[str] = []
    push: List[str] = []
    for topic, (ct, hh) in theirs.items():
        ours = mine.get(topic)
        if ours is None or (ct, hh) > (ours[0], ours[1]):
            pull.append(topic)
    for topic, (ct, hh) in mine.items():
        rem = theirs.get(topic)
        if rem is None or (ct, hh) > (rem[0], rem[1]):
            push.append(topic)
    return pull, push


def routes_digest(router) -> dict:
    """Digest of the subscription directory (every route edge). Only
    comparable across nodes when the table is replicated (raft mode); in
    broadcast mode each node's directory is local by design and the digest
    is a per-node fingerprint. The match-cache epoch rides along as a cheap
    local version tag (router/base.py epochs)."""
    h = hashlib.sha1()
    n = 0
    for tf, sid, _opts in sorted(
        ((tf, (sid.node_id, sid.client_id), o)
         for tf, sid, o in router.dump_routes()),
        key=lambda r: (r[0], r[1]),
    ):
        h.update(tf.encode())
        h.update(b"\x00")
        h.update(f"{sid[0]}/{sid[1]}".encode())
        h.update(b"\x00")
        n += 1
    ep = getattr(router, "_sub_epochs", None)
    return {"count": n, "digest": h.hexdigest(),
            "epoch": int(getattr(ep, "wild", 0)) if ep is not None else 0}


class Membership:
    """Per-node failure detector + rejoin repair driver.

    One instance per cluster object (broadcast or raft). Reads the peer set
    live from ``cluster.peers`` each round, so peers injected after
    ``start()`` (the in-process test meshes) are picked up without restart.
    """

    def __init__(
        self,
        cluster,
        ctx,
        heartbeat_interval: float = 1.0,
        suspect_timeout: float = 3.0,
        dead_timeout: float = 6.0,
        alive_hold: int = 2,
        anti_entropy: bool = True,
    ) -> None:
        self.cluster = cluster
        self.ctx = ctx
        self.heartbeat_interval = max(0.02, float(heartbeat_interval))
        self.suspect_timeout = max(self.heartbeat_interval,
                                   float(suspect_timeout))
        self.dead_timeout = max(self.suspect_timeout, float(dead_timeout))
        self.alive_hold = max(1, int(alive_hold))
        self.anti_entropy = bool(anti_entropy)
        #: this node's incarnation: new per process start, so peers can
        #: tell "restarted between heartbeats" from "never went away"
        self.incarnation = time.time_ns()
        self.health: Dict[int, PeerHealth] = {}
        self.transitions = 0
        self.repairs_running: set = set()  # node ids with a repair in flight
        self._task: Optional[asyncio.Task] = None
        # anti-entropy outcome counters (also bumped into ctx.metrics)
        self.repairs = 0
        self.retains_pulled = 0
        self.retains_pushed = 0
        self.sessions_fenced = 0
        self.routes_merged = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    # -------------------------------------------------------------- queries
    def _health(self, node_id: int) -> PeerHealth:
        h = self.health.get(node_id)
        if h is None:
            h = self.health[node_id] = PeerHealth(node_id, time.monotonic())
        return h

    def state_of(self, node_id: int) -> PeerState:
        h = self.health.get(node_id)
        return h.state if h is not None else PeerState.ALIVE

    def is_dead(self, node_id: int) -> bool:
        return self.state_of(node_id) == PeerState.DEAD

    def state_counts(self) -> Dict[str, int]:
        out = {"alive": 0, "suspect": 0, "dead": 0}
        for nid in self.cluster.peers:
            out[self.state_of(nid).name.lower()] += 1
        return out

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {
            "incarnation": self.incarnation,
            "heartbeat_interval": self.heartbeat_interval,
            "suspect_timeout": self.suspect_timeout,
            "dead_timeout": self.dead_timeout,
            "transitions": self.transitions,
            "peers": [self._health(nid).snapshot(now)
                      for nid in sorted(self.cluster.peers)],
            "anti_entropy": {
                "enabled": self.anti_entropy,
                "repairs": self.repairs,
                "running": sorted(self.repairs_running),
                "retains_pulled": self.retains_pulled,
                "retains_pushed": self.retains_pushed,
                "sessions_fenced": self.sessions_fenced,
                "routes_merged": self.routes_merged,
            },
        }

    # ------------------------------------------------------------- inbound
    def on_heartbeat(self, body: dict) -> dict:
        """Serve a peer's HEARTBEAT: merge its fence clock and report ours
        (handled via handle_common_message so both modes answer it)."""
        reg = self.ctx.registry
        observe = getattr(reg, "observe_fence", None)
        if observe is not None:
            observe(int(body.get("fence", 0)))
        return {
            "node": self.ctx.node_id,
            "inc": self.incarnation,
            "fence": getattr(reg, "fence_epoch", 0),
        }

    # ------------------------------------------------------------ detector
    async def _loop(self) -> None:
        while True:
            try:
                peers = list(self.cluster.peers.values())
                if peers:
                    await asyncio.gather(*(self._probe(p) for p in peers))
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("membership round failed")
            await asyncio.sleep(self.heartbeat_interval)

    async def _probe(self, peer) -> None:
        from rmqtt_tpu_torch.cluster.transport import ClusterReplyError

        h = self._health(peer.node_id)
        body = {
            "node": self.ctx.node_id,
            "inc": self.incarnation,
            "fence": getattr(self.ctx.registry, "fence_epoch", 0),
        }
        timeout = max(0.2, min(self.heartbeat_interval, 2.0))
        try:
            reply = await peer.call(M.HEARTBEAT, body, timeout=timeout)
        except ClusterReplyError:
            # the peer ANSWERED (it just doesn't speak HEARTBEAT — a
            # rolling-upgrade older node): liveness yes, no inc/fence info
            self._note_success(h, {})
            return
        except Exception:
            self._note_failure(h)
            return
        self._note_success(h, reply if isinstance(reply, dict) else {})

    def _note_failure(self, h: PeerHealth) -> None:
        h.fail_streak += 1
        h.ok_streak = 0
        now = time.monotonic()
        silent = now - h.last_seen
        if h.state == PeerState.ALIVE and silent >= self.suspect_timeout:
            self._transition(h, PeerState.SUSPECT, now)
        if h.state == PeerState.SUSPECT and silent >= self.dead_timeout:
            self._transition(h, PeerState.DEAD, now)

    def _note_success(self, h: PeerHealth, reply: dict) -> None:
        now = time.monotonic()
        h.last_seen = now
        h.fail_streak = 0
        observe = getattr(self.ctx.registry, "observe_fence", None)
        if observe is not None:
            observe(int(reply.get("fence", 0) or 0))
        inc = reply.get("inc")
        restarted = (inc is not None and h.incarnation is not None
                     and inc != h.incarnation)
        if inc is not None:
            h.incarnation = inc
        if h.state != PeerState.ALIVE:
            h.ok_streak += 1
            if h.ok_streak >= self.alive_hold:
                was_dead = h.state == PeerState.DEAD
                self._transition(h, PeerState.ALIVE, now)
                if was_dead or restarted:
                    self._schedule_repair(h.node_id)
        elif restarted:
            # fast restart between heartbeats: the outage was unobserved
            # but its state loss is just as real
            log.info("peer %s restarted (incarnation changed) — repairing",
                     h.node_id)
            self._schedule_repair(h.node_id)

    def _transition(self, h: PeerHealth, state: PeerState, now: float) -> None:
        prev = h.state
        h.state = state
        h.since = now
        h.ok_streak = 0
        h.transitions += 1
        self.transitions += 1
        self.ctx.metrics.inc("cluster.membership.transitions")
        lvl = logging.WARNING if state != PeerState.ALIVE else logging.INFO
        log.log(lvl, "peer %s: %s -> %s (last seen %.2fs ago)",
                h.node_id, prev.name, state.name, now - h.last_seen)

    # --------------------------------------------------------- anti-entropy
    def _schedule_repair(self, node_id: int) -> None:
        if not self.anti_entropy or node_id in self.repairs_running:
            return
        peer = self.cluster.peers.get(node_id)
        if peer is None:
            return
        self.repairs_running.add(node_id)

        async def run():
            try:
                await self.repair_with(peer)
            except PeerUnavailable as e:
                # the repaired peer died (or was killed) mid-exchange — the
                # EXPECTED outcome of racing a crash; the next incarnation
                # change reschedules the repair. One line, no traceback:
                # chaos harnesses treat logged tracebacks as node failures
                log.warning("anti-entropy with node %s interrupted: %s",
                            node_id, e)
            except Exception:
                log.exception("anti-entropy with node %s failed", node_id)
            finally:
                self.repairs_running.discard(node_id)

        self.cluster.spawn(run())

    async def repair_with(self, peer) -> dict:
        """One anti-entropy exchange with a rejoined peer: digests first,
        deltas only where they differ. Returns a stats row (logged + used
        by tests); every counter also lands in ctx.metrics."""
        ctx = self.ctx
        self.repairs += 1
        ctx.metrics.inc("cluster.anti_entropy.runs")
        t0 = time.monotonic()
        stats = {"peer": peer.node_id, "retains_pulled": 0,
                 "retains_pushed": 0, "sessions_fenced": 0,
                 "routes_merged": 0}
        digest = await peer.call(M.SYNC_DIGEST, {"node": ctx.node_id})
        # --- retained store (skipped in topic_only mode: nothing replicated)
        if (getattr(self.cluster, "retain_sync_mode", "full") == "full"
                and digest.get("retain", {}).get("digest")
                != retain_digest(ctx.retain)["digest"]):
            await self._repair_retains(peer, stats)
        # --- duplicate sessions: fence resolution both ways
        await self._repair_sessions(peer, stats)
        # --- subscription directory (raft mode only: replicated table)
        if getattr(self.cluster, "raft", None) is not None:
            await self._repair_routes(peer, digest, stats)
        log.info("anti-entropy with node %s done in %.3fs: %s",
                 peer.node_id, time.monotonic() - t0, stats)
        return stats

    async def _repair_retains(self, peer, stats: dict) -> None:
        ctx = self.ctx
        theirs: Dict[str, list] = {}
        offset = 0
        while True:  # paged summary fetch (SUMMARY_PAGE topics per frame)
            reply = await peer.call(
                M.SYNC_RETAIN_SUMMARY,
                {"offset": offset, "limit": SUMMARY_PAGE})
            theirs.update(reply.get("topics", {}))
            offset = reply.get("next")
            if offset is None:
                break
        pull, push = retain_delta(retain_summary(ctx.retain), theirs)
        for i in range(0, len(pull), SYNC_CHUNK):
            got = await peer.call(M.SYNC_RETAIN_PULL,
                                  {"topics": pull[i:i + SYNC_CHUNK]})
            for topic, mw in got.get("retains", []):
                msg = M.msg_from_wire(mw)
                if not msg.is_expired():
                    ctx.retain.set_local(topic, msg)
                    stats["retains_pulled"] += 1
        for i in range(0, len(push), SYNC_CHUNK):
            items = []
            for topic in push[i:i + SYNC_CHUNK]:
                m = ctx.retain.get(topic)
                if m is not None:
                    items.append([topic, M.msg_to_wire(m)])
            if items:
                await peer.call(M.SYNC_RETAIN_PUSH, {"items": items})
                stats["retains_pushed"] += len(items)
        self.retains_pulled += stats["retains_pulled"]
        self.retains_pushed += stats["retains_pushed"]
        if stats["retains_pulled"]:
            ctx.metrics.inc("cluster.anti_entropy.retains_pulled",
                            stats["retains_pulled"])
        if stats["retains_pushed"]:
            ctx.metrics.inc("cluster.anti_entropy.retains_pushed",
                            stats["retains_pushed"])

    async def _repair_sessions(self, peer, stats: dict) -> None:
        """Resolve duplicate live sessions with the peer: highest
        (epoch, node_id) fence wins; the stale side self-kicks with the
        session-taken-over disconnect. The handler kicks ITS stale copies;
        the reply tells us which of OURS lost."""
        ctx = self.ctx
        rows = [(s.client_id, list(s.fence))
                for s in ctx.registry.sessions() if s.connected]
        for i in range(0, len(rows), SESSIONS_PAGE):
            mine = dict(rows[i:i + SESSIONS_PAGE])
            reply = await peer.call(M.SYNC_SESSIONS,
                                    {"node": ctx.node_id, "sessions": mine})
            for cid, fence in (reply.get("superseded") or {}).items():
                local = ctx.registry.get(cid)
                if (local is not None and local.connected
                        and tuple(fence) > tuple(local.fence)):
                    await fence_kick(ctx, local)
                    stats["sessions_fenced"] += 1
        self.sessions_fenced += stats["sessions_fenced"]

    async def _repair_routes(self, peer, digest: dict, stats: dict) -> None:
        """Raft-mode directory check: the log/snapshot machinery should
        reconverge a rejoiner by itself — give it a couple of heartbeats,
        then verify digests and pull-merge any routes still missing (the
        belt to raft's suspenders; removals stay raft's job)."""
        ctx = self.ctx
        local = routes_digest(ctx.router)
        remote = digest.get("subs", {})
        if remote.get("digest") == local["digest"]:
            return
        await asyncio.sleep(self.heartbeat_interval * 2)
        fresh = await peer.call(M.SYNC_DIGEST, {"node": ctx.node_id})
        remote = fresh.get("subs", {})
        if remote.get("digest") == routes_digest(ctx.router)["digest"]:
            return
        from rmqtt_tpu_torch.router.base import Id
        have = {(tf, sid.node_id, sid.client_id)
                for tf, sid, _o in ctx.router.dump_routes()}
        merged = 0
        offset = 0
        while True:  # paged route pull (ROUTES_PAGE edges per frame)
            reply = await peer.call(M.SYNC_ROUTES,
                                    {"offset": offset, "limit": ROUTES_PAGE})
            for tf, node, client, ow in reply.get("routes", []):
                if (tf, node, client) not in have:
                    ctx.router.add(tf, Id(node, client), M.opts_from_wire(ow))
                    merged += 1
            offset = reply.get("next")
            if offset is None:
                break
        if merged:
            stats["routes_merged"] = merged
            self.routes_merged += merged
            ctx.metrics.inc("cluster.anti_entropy.routes_merged", merged)


async def fence_kick(ctx, session) -> None:
    """Self-kick the stale side of a fence conflict: reason-labeled,
    session-taken-over on v5, terminated with reason ``fence-stale`` so the
    $SYS disconnected event and hooks say WHY the session died. Idempotent
    per session: the caller-side and handler-side repair paths can race on
    the same conflict (both nodes run anti-entropy on heal), and the loser
    must be kicked — and counted — exactly once."""
    if getattr(session, "_fence_kicked", False):
        return
    session._fence_kicked = True
    ctx.metrics.inc("cluster.fence_kicks")
    log.warning("fencing stale session %r (fence %s)",
                session.client_id, session.fence)
    if session.state is not None:
        await session.state.close(kicked=True)
        for _ in range(100):
            if not session.connected:
                break
            await asyncio.sleep(0.01)
    await ctx.registry.terminate(session, "fence-stale")


#: sentinel mirroring broadcast._UNHANDLED without a circular import
_SYNC_UNHANDLED = object()


async def handle_sync_message(ctx, mtype: str, body, cluster=None):
    """Anti-entropy RPC handlers, shared by both cluster modes (wired into
    handle_common_message). Returns ``None``-able replies like the other
    handlers; unknown types fall through to the caller's _UNHANDLED."""
    if mtype == M.HEARTBEAT:
        ms = getattr(cluster, "membership", None) if cluster else None
        if ms is not None:
            return ms.on_heartbeat(body or {})
        return {"node": ctx.node_id, "inc": 0,
                "fence": getattr(ctx.registry, "fence_epoch", 0)}
    if mtype == M.SYNC_DIGEST:
        return {
            "node": ctx.node_id,
            "retain": retain_digest(ctx.retain),
            "subs": routes_digest(ctx.router),
        }
    if mtype == M.SYNC_RETAIN_SUMMARY:
        # paged: sorted-topic order is stable across pages (mutations that
        # land mid-pull are caught by the digest re-check on the next
        # heartbeat round, not by this snapshot)
        body = body or {}
        offset = int(body.get("offset", 0))
        limit = int(body.get("limit", SUMMARY_PAGE))
        full = retain_summary(ctx.retain)
        keys = sorted(full)[offset:offset + limit]
        nxt = offset + limit if offset + limit < len(full) else None
        return {"topics": {t: full[t] for t in keys}, "next": nxt}
    if mtype == M.SYNC_RETAIN_PULL:
        items = []
        for topic in (body or {}).get("topics", []):
            m = ctx.retain.get(topic)
            if m is not None:
                items.append([topic, M.msg_to_wire(m)])
        return {"retains": items}
    if mtype == M.SYNC_RETAIN_PUSH:
        for topic, mw in (body or {}).get("items", []):
            msg = M.msg_from_wire(mw)
            if not msg.is_expired():
                ctx.retain.set_local(topic, msg)
        return {"ok": True}
    if mtype == M.SYNC_SESSIONS:
        # fence resolution, handler side: kick OUR stale copies, report the
        # client ids where OUR fence is higher so the caller kicks its own
        superseded: Dict[str, list] = {}
        ms = getattr(cluster, "membership", None) if cluster else None
        for cid, fence in (body or {}).get("sessions", {}).items():
            local = ctx.registry.get(cid)
            if local is None or not local.connected:
                continue
            if tuple(fence) > tuple(local.fence):
                await fence_kick(ctx, local)
                if ms is not None:
                    ms.sessions_fenced += 1
            else:
                superseded[cid] = list(local.fence)
        return {"superseded": superseded}
    if mtype == M.SYNC_ROUTES:
        body = body or {}
        offset = int(body.get("offset", 0))
        limit = int(body.get("limit", ROUTES_PAGE))
        rows = sorted(
            ((tf, sid.node_id, sid.client_id, M.opts_to_wire(opts))
             for tf, sid, opts in ctx.router.dump_routes()),
            key=lambda r: (r[0], r[1], r[2]),
        )
        nxt = offset + limit if offset + limit < len(rows) else None
        return {"routes": [list(r) for r in rows[offset:offset + limit]],
                "next": nxt}
    return _SYNC_UNHANDLED
