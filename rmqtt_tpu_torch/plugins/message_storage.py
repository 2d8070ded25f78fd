"""Stored-message plugin (the `MessageManager` implementation).

Mirrors `rmqtt-plugins/rmqtt-message-storage` + the core ``MessageManager``
trait (`rmqtt/src/message.rs:61-147`): published messages are stored with an
expiry; when a client subscribes, stored messages matching the new filter
are replayed unless already forwarded to that client (``mark_forwarded``,
used by `rmqtt/src/shared.rs:751-760` to prevent redelivery).

Cluster semantics (``merge_on_read``, `rmqtt/src/message.rs:73` +
`rmqtt-cluster-raft/src/shared.rs:665-699`): the store is node-local — a
publish is stored only where it arrived — so ``message_load`` on subscribe
additionally broadcasts ``MessageGet`` to peers and merges their unforwarded
matches. Cross-node live delivery is reconciled by ``ForwardsToAck``
(`shared.rs:596-613`): the receiving node acks (stored_id, recipients) back
to the publishing node, which marks them forwarded here.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from typing import List, Optional, Tuple

import dataclasses as dc

from rmqtt_tpu_torch.broker.hooks import HookResult, HookType
from rmqtt_tpu_torch.broker.session import DeliverItem
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.cluster.messages import msg_from_wire, msg_to_wire
from rmqtt_tpu_torch.core.topic import match_filter, parse_shared
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.storage import make_store

NS_MSG = "msg"
NS_FWD = "msg_fwd"


class MessageStoragePlugin(Plugin):
    name = "rmqtt-message-storage"
    descr = "store published messages; replay to new subscribers (sqlite or redis)"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.store = make_store(self.config)
        # network backends must not run their socket round trips on the
        # event loop (a stalled redis would freeze the whole broker)
        self._net = bool(getattr(self.store, "network", False))
        self.default_expiry = float(self.config.get("expiry", 300.0))
        self.max_stored = int(self.config.get("max_stored", 100_000))
        # merge_on_read (message.rs:73): pull stored messages from peers at
        # subscribe time instead of replicating the store
        self.merge_on_read = bool(self.config.get("merge_on_read", True))
        # node-namespaced sids (node id in the high bits): two nodes can
        # never allocate the same stored id, so a ForwardsToAck arriving at
        # the wrong store could not collide with a local message's id
        self._msg_id = itertools.count(
            (ctx.node_id << 48) + (int(time.time() * 1000) & ((1 << 48) - 1))
        )
        self._unhooks = []
        # buffered forward-marks (see mark_forwarded); writers run on the
        # event loop AND executor threads (network flush, load_unforwarded
        # mark=True), so the swap/merge in flush_forwarded and every write
        # must hold the lock or concurrent marks are silently dropped —
        # and a dropped mark replays as a duplicate QoS1 delivery
        self._fwd_lock = threading.Lock()
        self._fwd_pending: dict = {}
        self._FWD_FLUSH = int(self.config.get("fwd_flush_batch", 256))
        self._flush_task = None
        self._flush_inflight = False  # threshold-flush executor guard

    # ---------------------------------------------- MessageManager surface
    def store_msg(self, msg: Message) -> Optional[int]:
        """Persist one publish; returns its stored id (message.rs `store`)."""
        if self.store.count(NS_MSG) >= self.max_stored:
            return None
        sid = next(self._msg_id)
        ttl = msg.expiry_interval or self.default_expiry
        self.store.put(NS_MSG, str(sid), msg_to_wire(msg), ttl=ttl)
        self.ctx.metrics.inc("storage.messages_stored")
        return sid

    def mark_forwarded(self, stored_id: int, client_id: str,
                       ttl: Optional[float] = None) -> None:
        """Record delivery so subscribe-time replay skips it
        (message.rs `mark_forwarded`; called from the live fan-out like
        shared.rs:751-760, and from cross-node ForwardsToAck). The marker
        must outlive the message it guards, so its TTL is at least the
        message's own expiry when the caller knows it.

        Marks are BUFFERED: the live fan-out calls this once per
        (message, subscriber) on the event-loop hot path, and a synchronous
        store commit per delivery is O(subscribers) blocking writes per
        publish. The buffer is the read-side dedup until flushed (one
        bulk transaction per _FWD_FLUSH marks, plus the 0.5s flush loop
        started in init — which also expire_sweeps the store every ~60s so
        dead marks and the network backend's index are reclaimed). A crash
        loses at most the buffered marks — worst case a QoS1 duplicate
        replay, which MQTT permits."""
        exp = time.time() + max(self.default_expiry, ttl or 0.0)
        with self._fwd_lock:
            self._fwd_pending[f"{stored_id}\x00{client_id}"] = exp
        if len(self._fwd_pending) >= self._FWD_FLUSH:
            if not self._net:
                self.flush_forwarded()  # embedded: one cheap transaction
                return
            # network backend: the threshold flush must NOT run its socket
            # RTT inline (this is the event-loop fan-out hot path when
            # called from _deliver_local); hand it to the executor unless
            # one is already in flight — or flush directly when we are
            # ALREADY on a worker thread (load_unforwarded(mark=True))
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                self.flush_forwarded()
                return
            if not self._flush_inflight:
                self._flush_inflight = True

                def _bg():
                    try:
                        self.flush_forwarded()
                    finally:
                        self._flush_inflight = False

                loop.run_in_executor(None, _bg)

    def flush_forwarded(self) -> None:
        """Drain the buffered forward-marks in one transaction. Marks stay
        VISIBLE in the buffer until the store write has committed — a
        swap-then-write would open a window where a mark is in neither the
        buffer nor the store and a concurrent ``_was_forwarded`` replays a
        duplicate. On a write failure the buffer is simply untouched
        (retry next tick); on success exactly the written marks are
        dropped (same-key marks re-buffered mid-write keep their newer
        expiry)."""
        with self._fwd_lock:
            if not self._fwd_pending:
                return
            pending = dict(self._fwd_pending)
        self.store.put_many_expire(
            NS_FWD, [(k, True, exp) for k, exp in pending.items()]
        )
        with self._fwd_lock:
            for k, exp in pending.items():
                if self._fwd_pending.get(k) == exp:
                    del self._fwd_pending[k]

    def _was_forwarded(self, stored_id, client_id: str) -> bool:
        key = f"{stored_id}\x00{client_id}"
        return (key in self._fwd_pending
                or self.store.get(NS_FWD, key) is not None)

    def load_unforwarded(
        self, stripped_filter: str, client_id: str, mark: bool = False
    ) -> List[Tuple[int, Message]]:
        """Stored, unexpired messages matching ``stripped_filter`` not yet
        forwarded to ``client_id`` (message.rs `get`). With ``mark`` the
        returned batch is immediately marked forwarded — the MessageGet RPC
        handler uses this so a remote replay can't repeat."""
        cands: List[Tuple[int, Message]] = []
        for msg_id, mw in self.store.scan(NS_MSG):
            msg = msg_from_wire(mw)
            # cheap in-memory checks first; the forwarded lookup is a store
            # round trip and most stored messages won't match the filter
            if msg.is_expired() or not match_filter(stripped_filter, msg.topic):
                continue
            cands.append((int(msg_id), msg))
        if not cands:
            return []
        # ONE batched forwarded lookup for the whole candidate set (on the
        # network backend a per-candidate GET would cost one RTT each)
        fwd_keys = [f"{sid}\x00{client_id}" for sid, _ in cands]
        hit = self.store.get_many(NS_FWD, fwd_keys)
        out: List[Tuple[int, Message]] = []
        for (sid, msg), key, marked in zip(cands, fwd_keys, hit):
            if marked is not None or key in self._fwd_pending:
                continue
            out.append((sid, msg))
            if mark:
                self.mark_forwarded(sid, client_id, ttl=msg.expiry_interval)
        return out

    def count(self) -> int:
        return self.store.count(NS_MSG)

    # -------------------------------------------------------------- hooks
    async def init(self) -> None:
        hooks = self.ctx.hooks
        self.ctx.message_mgr = self
        # TTL'd rows/marks are reaped by the ServerContext-wide store
        # sweep task (previously this plugin's flush loop swept, and ONLY
        # its own store — a retainer/session store without this plugin
        # loaded never got reaped)
        self.ctx.add_store(self.store)

        async def on_publish(_ht, args, prev):
            msg = prev if prev is not None else args[1]
            if msg.topic.startswith("$"):
                return None
            if self._net:
                sid = await asyncio.get_running_loop().run_in_executor(
                    None, self.store_msg, msg)
            else:
                sid = self.store_msg(msg)
            if sid is None:
                return None
            # the stored id rides the Message through the fan-out so local
            # delivery and remote acks can mark-forward against this store
            return HookResult(value=dc.replace(msg, stored_id=sid))

        async def on_subscribed(_ht, args, _prev):
            id, full_filter = args[0], args[1]
            session = self.ctx.registry.get(id.client_id)
            if session is None:
                return None
            try:
                _g, stripped = parse_shared(full_filter)
            except ValueError:
                return None
            replay: List[Tuple[int, Message]] = []
            if self._net:
                loaded = await asyncio.get_running_loop().run_in_executor(
                    None, self.load_unforwarded, stripped, id.client_id)
            else:
                loaded = self.load_unforwarded(stripped, id.client_id)
            for sid, msg in loaded:
                replay.append((sid, msg))
                self.mark_forwarded(sid, id.client_id, ttl=msg.expiry_interval)
            # merge_on_read: pull peers' unforwarded stored messages
            # (cluster-raft/src/shared.rs:665-699 broadcast MessageGet)
            cluster = getattr(self.ctx.registry, "cluster", None)
            if self.merge_on_read and cluster is not None and cluster.peers:
                from rmqtt_tpu_torch.cluster import messages as M

                replies = await cluster.bcast.join_all_call(
                    M.MESSAGE_GET,
                    {"filter": stripped, "client_id": id.client_id},
                )
                for _nid, reply in replies:
                    if isinstance(reply, Exception):
                        continue
                    for sid, mw in reply.get("msgs", []):
                        msg = msg_from_wire(mw)
                        if not msg.is_expired():
                            replay.append((sid, msg))
            replay.sort(key=lambda it: it[1].create_time)
            for _sid, msg in replay:
                session.enqueue(
                    DeliverItem(msg=msg, qos=min(msg.qos, 1), retain=False,
                                topic_filter=full_filter)
                )
            return None

        self._unhooks = [
            hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=-50),
            hooks.register(HookType.SESSION_SUBSCRIBED, on_subscribed),
        ]

        async def flush_loop():
            loop = asyncio.get_running_loop()
            while True:
                await asyncio.sleep(0.5)
                try:
                    if self._net:
                        await loop.run_in_executor(None, self.flush_forwarded)
                    else:
                        self.flush_forwarded()
                    # expired rows/marks are reaped by the context-wide
                    # store sweep (ServerContext.sweep_stores_once)
                except Exception:  # failed marks re-buffer; retry next tick
                    pass

        self._flush_task = asyncio.get_running_loop().create_task(flush_loop())

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        if getattr(self.ctx, "message_mgr", None) is self:
            self.ctx.message_mgr = None
        self.ctx.remove_store(self.store)
        try:
            self.flush_forwarded()
        finally:
            self.store.close()
        return True

    def attrs(self):
        return {"stored": self.store.count(NS_MSG),
                "merge_on_read": self.merge_on_read}
