"""Minimal Raft consensus for replicated routing state.

The reference's raft mode uses the external `rmqtt-raft` crate (SURVEY.md
§2.3); there is no Python/C++ drop-in in this image, so this is an
independent compact Raft: leader election with randomized timeouts,
AppendEntries log replication with commit on majority, leader forwarding for
proposals, and full-log catch-up for (re)joining nodes. Term/vote and the
log persist to SQLite when a storage is attached (cluster.raft_db), so a
restarted node reloads and re-applies its own log instead of refetching it.

Snapshots + log compaction (Raft §7, mirroring the reference's compressed
snapshot/restore in `rmqtt-plugins/rmqtt-cluster-raft/src/router.rs:387-580`):
when the applied prefix exceeds ``compact_threshold`` entries, the node asks
the application for a full-state snapshot (``snapshot_cb``), compresses it
(zlib over the wire encoding), persists it, and discards the covered log
prefix — bounding both the durable log and restart replay. A leader whose
follower has fallen behind the compacted prefix sends ``raft_snap``
(InstallSnapshot) instead of AppendEntries; the follower restores via
``restore_cb`` and resumes replication from the snapshot index.

RPCs ride the cluster transport (`cluster/transport.py`) with message types
``raft_vote`` / ``raft_append`` / ``raft_propose`` / ``raft_snap``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import zlib
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.cluster import wire
from rmqtt_tpu_torch.cluster.transport import ClusterReplyError, PeerClient, PeerUnavailable

log = logging.getLogger("rmqtt_tpu_torch.raft")

RAFT_VOTE = "raft_vote"
RAFT_APPEND = "raft_append"
RAFT_PROPOSE = "raft_propose"
RAFT_SNAP = "raft_snap"


def pack_snapshot(data: Any) -> bytes:
    return zlib.compress(wire.dumps(data))


def unpack_snapshot(blob: bytes) -> Any:
    return wire.loads(zlib.decompress(blob))

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RaftNode:
    def __init__(
        self,
        node_id: int,
        peers: Dict[int, PeerClient],
        apply_cb: Callable[[Any], Awaitable[None]],
        election_timeout: Tuple[float, float] = (0.3, 0.6),
        heartbeat: float = 0.1,
        storage=None,
        snapshot_cb: Optional[Callable[[], Any]] = None,
        restore_cb: Optional[Callable[[Any], Awaitable[None]]] = None,
        compact_threshold: int = 4096,
    ) -> None:
        self.node_id = node_id
        self.peers = peers
        self.apply_cb = apply_cb
        self.election_timeout = election_timeout
        self.heartbeat = heartbeat
        # optional durable state (SqliteStore): term/vote + the log survive
        # restarts, so a rejoining node re-applies its own log instead of
        # refetching everything
        self.storage = storage
        # snapshot_cb (sync) captures the FULL applied state; restore_cb
        # replaces local state with a snapshot. Both unset => no compaction.
        self.snapshot_cb = snapshot_cb
        self.restore_cb = restore_cb
        self.compact_threshold = compact_threshold

        self.term = 0
        self.voted_for: Optional[int] = None
        self.log: List[Tuple[int, Any]] = []  # (term, entry), offset by log_offset
        # log_offset = absolute index of the last snapshot-covered entry;
        # absolute index i lives at self.log[i - log_offset - 1]
        self.log_offset = 0
        self.snap_term = 0  # term at log_offset
        self._snap_blob: Optional[bytes] = None  # latest compressed snapshot
        self._pending_restore: Optional[bytes] = None  # loaded, not yet applied
        if storage is not None:
            meta = storage.get("raft", "meta")
            if meta:
                self.term = int(meta["term"])
                self.voted_for = meta["voted_for"]
            snap = storage.get("raft", "snapshot")
            if snap:
                self.log_offset = int(snap["index"])
                self.snap_term = int(snap["term"])
                self._snap_blob = snap["data"]
                self._pending_restore = snap["data"]
            rows = sorted(
                ((int(k), v) for k, v in storage.scan("raft_log")), key=lambda kv: kv[0]
            )
            self.log = [(int(t), e) for idx, (t, e) in rows if idx > self.log_offset]
        self.commit_index = self.log_offset  # 1-based count of committed entries
        self.last_applied = self.log_offset
        self.state = FOLLOWER
        self.leader_id: Optional[int] = None
        self._next_index: Dict[int, int] = {}
        self._match_index: Dict[int, int] = {}
        self._last_heartbeat = 0.0
        self._tasks: List[asyncio.Task] = []
        self._lead_task: Optional[asyncio.Task] = None
        self._commit_waiters: Dict[int, asyncio.Future] = {}
        self._apply_lock = asyncio.Lock()
        self._snap_inflight: set = set()  # peers with an InstallSnapshot in flight
        self._stopped = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._last_heartbeat = loop.time()
        self._tasks = [loop.create_task(self._election_loop())]

    async def stop(self) -> None:
        self._stopped = True
        tasks = list(self._tasks)
        if self._lead_task is not None:
            tasks.append(self._lead_task)
            self._lead_task = None
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []

    async def restore_pending(self) -> None:
        """Hand a storage-loaded snapshot to the application. Must run (once)
        before ``start()`` so log re-apply happens on top of snapshot state."""
        if self._pending_restore is not None and self.restore_cb is not None:
            await self.restore_cb(unpack_snapshot(self._pending_restore))
        self._pending_restore = None

    # --------------------------------------------------- log index helpers
    def _last_index(self) -> int:
        return self.log_offset + len(self.log)

    def _term_at(self, idx: int) -> int:
        if idx <= self.log_offset:
            return self.snap_term if idx == self.log_offset and idx > 0 else 0
        return self.log[idx - self.log_offset - 1][0]

    def _save_meta(self) -> None:
        if self.storage is not None:
            self.storage.put("raft", "meta", {"term": self.term, "voted_for": self.voted_for})

    def _persist_append(self, start_idx: int) -> None:
        """Persist log entries from 1-based absolute ``start_idx`` to the end
        — one transaction regardless of batch size (a far-behind follower
        receives its whole backlog in one AppendEntries)."""
        if self.storage is not None:
            self.storage.put_many(
                "raft_log",
                [(str(idx), list(self.log[idx - self.log_offset - 1]))
                 for idx in range(start_idx, self._last_index() + 1)],
            )

    def _persist_truncate(self, new_last: int) -> None:
        """Drop persisted entries with absolute index > ``new_last``."""
        if self.storage is not None:
            idx = new_last + 1
            while self.storage.delete("raft_log", str(idx)):
                idx += 1

    # ---------------------------------------------------------- compaction
    def _maybe_compact(self) -> None:
        """Snapshot applied state + discard the covered log prefix once it
        outgrows the threshold (router.rs:387-580 semantics: full-state
        snapshot with compression; filter ids stay stable because the
        snapshot is of APPLICATION state, not physical layout)."""
        if self.snapshot_cb is None:
            return
        if self.last_applied - self.log_offset < self.compact_threshold:
            return
        self.take_snapshot()

    def take_snapshot(self) -> None:
        """Force a snapshot at ``last_applied`` (also used by tests/admin)."""
        if self.snapshot_cb is None or self.last_applied <= self.log_offset:
            return
        idx = self.last_applied
        term = self._term_at(idx)
        blob = pack_snapshot(self.snapshot_cb())
        self.log = self.log[idx - self.log_offset:]
        old_offset = self.log_offset
        self.log_offset = idx
        self.snap_term = term
        self._snap_blob = blob
        if self.storage is not None:
            self.storage.put("raft", "snapshot", {"index": idx, "term": term, "data": blob})
            self.storage.delete_int_upto("raft_log", idx)
        log.info(
            "raft node %s compacted log through %s (%s entries dropped, snapshot %s bytes)",
            self.node_id, idx, idx - old_offset, len(blob),
        )

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    def _quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    # ------------------------------------------------------------- election
    async def _election_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            timeout = random.uniform(*self.election_timeout)
            await asyncio.sleep(timeout / 4)
            if self.state == LEADER:
                continue
            if loop.time() - self._last_heartbeat >= timeout:
                await self._campaign()

    async def _request_votes(self, term: int, prevote: bool):
        last_idx = self._last_index()
        last_term = self._term_at(last_idx)

        async def ask(peer: PeerClient):
            try:
                body = {
                    "term": term, "candidate": self.node_id,
                    "last_log_index": last_idx, "last_log_term": last_term,
                }
                if prevote:
                    body["prevote"] = True
                return await peer.call(RAFT_VOTE, body, timeout=self.election_timeout[0])
            except (PeerUnavailable, ClusterReplyError):
                return None

        return await asyncio.gather(*(ask(p) for p in self.peers.values()))

    def _heard_from_leader_recently(self) -> bool:
        return (
            asyncio.get_running_loop().time() - self._last_heartbeat
            < self.election_timeout[0]
        )

    async def _campaign(self) -> None:
        # PRE-VOTE (Raft §9.6): ask peers whether they WOULD vote for us at
        # term+1 without disturbing anyone's persistent term. Prevents the
        # election storms a partitioned/restarting node causes by endlessly
        # inflating terms it can never win with.
        if self.peers:
            replies = await self._request_votes(self.term + 1, prevote=True)
            # term catch-up: a denial can carry a newer term (e.g. a peer
            # restarted with an inflated persisted term) — adopt it or this
            # node's pre-votes stay permanently too stale to ever pass
            for r in replies:
                if r is not None and r.get("term", 0) > self.term:
                    self._step_down(r["term"])
                    return  # retry next election tick at the caught-up term
            votes = 1 + sum(1 for r in replies if r is not None and r.get("granted"))
            if votes < self._quorum():
                return
            # the pre-vote round took time: if a live leader (or newer term)
            # showed up meanwhile, stand down instead of disrupting it
            if self._heard_from_leader_recently() or self.state == LEADER:
                return
        self.term += 1
        self.state = CANDIDATE
        self.voted_for = self.node_id
        self._save_meta()
        self.leader_id = None
        term = self.term
        votes = 1
        replies = await self._request_votes(term, prevote=False)
        if self.term != term or self.state != CANDIDATE:
            return  # a newer term interrupted the campaign
        for reply in replies:
            if reply is None:
                continue
            if reply["term"] > self.term:
                self._step_down(reply["term"])
                return
            if reply.get("granted"):
                votes += 1
        if votes >= self._quorum():
            self._become_leader()

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.node_id
        # a fresh leader cannot commit prior-term entries by counting
        # replicas (Raft §5.4.2) — append a current-term no-op (entry=None,
        # outside the application payload space) so the whole log prefix
        # commits through it
        self.log.append((self.term, None))
        self._persist_append(self._last_index())
        nxt = self._last_index() + 1
        self._next_index = {nid: nxt for nid in self.peers}
        self._match_index = {nid: 0 for nid in self.peers}
        log.info("raft node %s became leader (term %s)", self.node_id, self.term)
        if self._lead_task is not None:
            self._lead_task.cancel()
        self._lead_task = asyncio.get_running_loop().create_task(self._lead_loop())

    def _step_down(self, term: int) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._save_meta()
        if self.state != FOLLOWER:
            log.info("raft node %s steps down (term %s)", self.node_id, self.term)
        self.state = FOLLOWER

    # ------------------------------------------------------------ leadership
    async def _lead_loop(self) -> None:
        while self.state == LEADER and not self._stopped:
            await self._replicate_all()
            await asyncio.sleep(self.heartbeat)

    async def _replicate_all(self) -> None:
        await asyncio.gather(*(self._replicate(nid) for nid in self.peers))
        self._advance_commit()

    async def _replicate(self, nid: int) -> None:
        if self.state != LEADER:
            return
        peer = self.peers[nid]
        nxt = self._next_index.get(nid, self._last_index() + 1)
        prev_index = nxt - 1
        if prev_index < self.log_offset:
            # follower is behind the compacted prefix: only a snapshot can
            # catch it up (Raft §7 InstallSnapshot)
            await self._send_snapshot(nid)
            return
        prev_term = self._term_at(prev_index)
        entries = self.log[prev_index - self.log_offset:]
        try:
            reply = await peer.call(RAFT_APPEND, {
                "term": self.term, "leader": self.node_id,
                "prev_log_index": prev_index, "prev_log_term": prev_term,
                "entries": [[t, e] for t, e in entries],
                "leader_commit": self.commit_index,
            }, timeout=1.0)
        except (PeerUnavailable, ClusterReplyError):
            return
        if reply["term"] > self.term:
            self._step_down(reply["term"])
            return
        if reply.get("success"):
            self._match_index[nid] = prev_index + len(entries)
            self._next_index[nid] = self._match_index[nid] + 1
        else:
            # follower log diverges/behind: back off (snapshot worst case)
            self._next_index[nid] = max(1, min(nxt - 1, reply.get("match", 0) + 1))

    async def _send_snapshot(self, nid: int) -> None:
        # at most ONE transfer per peer: the heartbeat loop keeps calling
        # _replicate while a big snapshot is still on the wire, and duplicate
        # transfers would multiply bandwidth and re-run restore on the peer
        if self._snap_blob is None or nid in self._snap_inflight:
            return
        self._snap_inflight.add(nid)
        try:
            peer = self.peers[nid]
            body = {
                "term": self.term, "leader": self.node_id,
                "index": self.log_offset, "snap_term": self.snap_term,
                "data": self._snap_blob,
            }
            try:
                reply = await peer.call(RAFT_SNAP, body, timeout=30.0)
            except (PeerUnavailable, ClusterReplyError):
                return
            if reply["term"] > self.term:
                self._step_down(reply["term"])
                return
            if reply.get("success"):
                self._match_index[nid] = max(self._match_index.get(nid, 0), body["index"])
                self._next_index[nid] = self._match_index[nid] + 1
        finally:
            self._snap_inflight.discard(nid)

    def _advance_commit(self) -> None:
        if self.state != LEADER:
            return
        for idx in range(self._last_index(), max(self.commit_index, self.log_offset), -1):
            # only entries from the current term commit by counting (Raft §5.4.2)
            if self._term_at(idx) != self.term:
                break
            votes = 1 + sum(1 for m in self._match_index.values() if m >= idx)
            if votes >= self._quorum():
                self.commit_index = idx
                asyncio.get_running_loop().create_task(self._apply_committed())
                # push the new commit index to followers right away instead
                # of waiting a heartbeat — keeps the replication-visibility
                # window on the routing table tight
                asyncio.get_running_loop().create_task(self._push_commit())
                break

    async def _push_commit(self) -> None:
        if self.state == LEADER:
            await asyncio.gather(*(self._replicate(nid) for nid in self.peers))

    async def _apply_committed(self) -> None:
        async with self._apply_lock:
            while self.last_applied < self.commit_index:
                self.last_applied += 1
                _term, entry = self.log[self.last_applied - self.log_offset - 1]
                if entry is None:
                    pass  # leader-election no-op, not application state
                else:
                    try:
                        await self.apply_cb(entry)
                    except Exception:
                        log.exception("raft apply failed at %s", self.last_applied)
                fut = self._commit_waiters.pop(self.last_applied, None)
                if fut is not None and not fut.done():
                    fut.set_result(True)
            self._maybe_compact()

    # -------------------------------------------------------------- propose
    async def propose(self, entry: Any, timeout: float = 5.0) -> bool:
        """Append via the leader; resolves once the entry is APPLIED locally.
        Followers forward to the leader (reference proposals with retry,
        cluster-raft/src/router.rs:146-196)."""
        deadline = asyncio.get_running_loop().time() + timeout
        backoff = 0.05
        while True:
            if self.state == LEADER:
                self.log.append((self.term, entry))
                idx = self._last_index()
                self._persist_append(idx)
                fut = asyncio.get_running_loop().create_future()
                self._commit_waiters[idx] = fut
                await self._replicate_all()
                try:
                    remaining = deadline - asyncio.get_running_loop().time()
                    await asyncio.wait_for(fut, max(0.05, remaining))
                    return True
                except asyncio.TimeoutError:
                    self._commit_waiters.pop(idx, None)
                    return False
            elif self.leader_id is not None and self.leader_id in self.peers:
                try:
                    reply = await self.peers[self.leader_id].call(
                        RAFT_PROPOSE, {"entry": entry},
                        timeout=max(0.1, deadline - asyncio.get_running_loop().time()),
                    )
                    if reply.get("ok"):
                        try:
                            # wait until the entry reaches *this* node's state
                            await self._wait_applied(reply["index"], deadline)
                            return True
                        except asyncio.TimeoutError:
                            return False  # committed on the leader; local apply lags
                except (PeerUnavailable, ClusterReplyError):
                    pass
            if asyncio.get_running_loop().time() >= deadline:
                return False
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 0.5)

    async def _wait_applied(self, index: int, deadline: float) -> None:
        while self.last_applied < index:
            if asyncio.get_running_loop().time() >= deadline:
                raise asyncio.TimeoutError
            await asyncio.sleep(0.02)

    # ------------------------------------------------------------- handlers
    async def on_message(self, mtype: str, body: Any) -> Optional[dict]:
        """Dispatch raft RPCs (wired into the ClusterServer handler)."""
        if mtype == RAFT_VOTE:
            return self._on_vote(body)
        if mtype == RAFT_APPEND:
            return await self._on_append(body)
        if mtype == RAFT_SNAP:
            return await self._on_snapshot(body)
        if mtype == RAFT_PROPOSE:
            if self.state != LEADER:
                raise ClusterReplyError("not leader")
            self.log.append((self.term, body["entry"]))
            idx = self._last_index()
            self._persist_append(idx)
            fut = asyncio.get_running_loop().create_future()
            self._commit_waiters[idx] = fut
            await self._replicate_all()
            try:
                await asyncio.wait_for(fut, 5.0)
            except asyncio.TimeoutError as e:
                raise ClusterReplyError("commit timeout") from e
            return {"ok": True, "index": idx}
        return None

    def _on_vote(self, body: dict) -> dict:
        # a vote request proves the candidate is up again: close this node's
        # breaker to it. A leader's breaker opens while a peer is down, and
        # each failed probe doubles its cooldown (3 s, 6 s, ...), so a peer
        # restarted with an empty log would hear no heartbeat, know no
        # leader and fail every proposal (a CONNECT's hs_lock) until then
        peer = self.peers.get(body["candidate"])
        if peer is not None:
            peer.breaker.ok()
        term = body["term"]
        my_last_term = self._term_at(self._last_index())
        up_to_date = (body["last_log_term"], body["last_log_index"]) >= (
            my_last_term, self._last_index()
        )
        if body.get("prevote"):
            # pre-vote: no state changes; grant iff we'd grant a real vote
            # at that term AND no leader looks alive — ourselves included
            # (a leader's own _last_heartbeat is not refreshed while leading)
            leader_alive = self.state == LEADER or self._heard_from_leader_recently()
            granted = term >= self.term and up_to_date and not leader_alive
            return {"term": self.term, "granted": granted}
        if term > self.term:
            self._step_down(term)
        granted = False
        if term >= self.term and self.voted_for in (None, body["candidate"]):
            if up_to_date:
                granted = True
                self.voted_for = body["candidate"]
                self._save_meta()
                self._last_heartbeat = asyncio.get_running_loop().time()
        return {"term": self.term, "granted": granted}

    async def _on_append(self, body: dict) -> dict:
        term = body["term"]
        if term < self.term:
            return {"term": self.term, "success": False, "match": self.last_applied}
        if term > self.term:
            self._step_down(term)
        elif self.state != FOLLOWER:
            self.state = FOLLOWER
        self.leader_id = body["leader"]
        self._last_heartbeat = asyncio.get_running_loop().time()
        prev_index = body["prev_log_index"]
        prev_term = body["prev_log_term"]
        entries = body["entries"]
        if prev_index < self.log_offset:
            # the leader's window overlaps our compacted prefix (possible
            # right after an InstallSnapshot): entries up to log_offset are
            # already part of the snapshot — skip them
            skip = self.log_offset - prev_index
            if skip >= len(entries):
                return {"term": self.term, "success": True, "match": self._last_index()}
            entries = entries[skip:]
            prev_index = self.log_offset
            prev_term = self.snap_term
        if prev_index > self._last_index() or self._term_at(prev_index) != prev_term:
            return {"term": self.term, "success": False, "match": self.commit_index}
        # append, truncating only on an actual conflict (Raft §5.3 — a
        # reordered stale AppendEntries must not clobber newer entries)
        appended_from = None
        for i, (t, e) in enumerate(entries):
            pos = prev_index + i  # absolute index of the entry BEFORE this one
            local = pos - self.log_offset
            if local < len(self.log):
                if self.log[local][0] != t:
                    self.log = self.log[:local]
                    self._persist_truncate(pos)
                    self.log.append((t, e))
                    if appended_from is None:
                        appended_from = pos + 1
            else:
                self.log.append((t, e))
                if appended_from is None:
                    appended_from = pos + 1
        if appended_from is not None:
            self._persist_append(appended_from)
        if body["leader_commit"] > self.commit_index:
            self.commit_index = min(body["leader_commit"], self._last_index())
            await self._apply_committed()
        return {"term": self.term, "success": True, "match": self._last_index()}

    async def _on_snapshot(self, body: dict) -> dict:
        """InstallSnapshot (Raft §7): replace local state wholesale."""
        term = body["term"]
        if term < self.term:
            return {"term": self.term, "success": False}
        if term > self.term:
            self._step_down(term)
        elif self.state != FOLLOWER:
            self.state = FOLLOWER
        self.leader_id = body["leader"]
        self._last_heartbeat = asyncio.get_running_loop().time()
        idx, sterm, blob = body["index"], body["snap_term"], body["data"]
        if idx <= self.log_offset:
            return {"term": self.term, "success": True, "match": self._last_index()}
        async with self._apply_lock:
            if self.restore_cb is not None:
                await self.restore_cb(unpack_snapshot(blob))
            if idx < self._last_index() and self._term_at(idx) == sterm:
                # our log extends past the snapshot: keep the suffix (§7)
                self.log = self.log[idx - self.log_offset:]
            else:
                self.log = []
            self.log_offset = idx
            self.snap_term = sterm
            self._snap_blob = blob
            self.last_applied = idx
            self.commit_index = max(self.commit_index, idx)
            if self.storage is not None:
                self.storage.put(
                    "raft", "snapshot", {"index": idx, "term": sterm, "data": blob}
                )
                self.storage.delete_int_upto("raft_log", idx)
                self._persist_truncate(self._last_index())
                self._persist_append(self.log_offset + 1)
        return {"term": self.term, "success": True, "match": self._last_index()}
