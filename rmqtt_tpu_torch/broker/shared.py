"""Session registry + message fan-out (the `Shared`/`Entry` seam).

Mirrors `rmqtt/src/shared.rs`: the client-id → session
registry with the kick/takeover protocol (``LockEntry`` :337-634, kick via
oneshot :480-506), subscribe/unsubscribe through the router (:555-574), and
``forwards`` — publish → router matches → per-subscriber enqueue with
QoS-min / retain-as-published / subscription-ids (:735-963). p2p publishes
short-circuit the router (:743-769).
"""

from __future__ import annotations

import asyncio
from typing import Dict, Iterable, List, Optional

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.session import DeliverItem, Session
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.router.base import Id, SubscriptionOptions


class SubscriptionLimitExceeded(Exception):
    """$limit/$exclusive cap reached for a filter."""


class SessionRegistry:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self._sessions: Dict[str, Session] = {}
        # session-fence clock (cluster/membership.py): a Lamport-style
        # monotonic epoch counter. Locally it only ever increments; cluster
        # modes merge peers' epochs in via observe_fence (heartbeats +
        # restored snapshots), so a takeover AFTER a partition heals always
        # out-fences both partition-era owners.
        self._fence_epoch = 0

    # ------------------------------------------------------------- fencing
    @property
    def fence_epoch(self) -> int:
        return self._fence_epoch

    def next_fence(self) -> tuple:
        """A fence strictly above every epoch this node has seen; the
        node id tie-breaks concurrent takeovers deterministically."""
        self._fence_epoch += 1
        return (self._fence_epoch, self.ctx.cfg.node_id)

    def observe_fence(self, epoch: int) -> None:
        """Merge a remotely-seen epoch (heartbeat piggyback / restore)."""
        if epoch > self._fence_epoch:
            self._fence_epoch = epoch

    # ------------------------------------------------------------- registry
    def get(self, client_id: str) -> Optional[Session]:
        return self._sessions.get(client_id)

    def sessions(self) -> Iterable[Session]:
        return list(self._sessions.values())

    def session_count(self) -> int:
        return len(self._sessions)

    def connected_count(self) -> int:
        return sum(1 for s in self._sessions.values() if s.connected)

    async def take_or_create(
        self, ctx, id: Id, connect_info, limits, clean_start: bool
    ) -> tuple[Session, bool]:
        """Takeover/kick + create-or-resume (v5.rs:243-299, shared.rs:480-523).

        Returns (session, session_present).
        """
        existing = self._sessions.get(id.client_id)
        if existing is not None:
            if existing.connected and existing.state is not None:
                await existing.state.close(kicked=True)
                # wait briefly for the old loop to unwind
                for _ in range(100):
                    if not existing.connected:
                        break
                    await asyncio.sleep(0.01)
            existing.on_reconnect()
            if not clean_start and existing.limits.session_expiry > 0:
                # resume: keep subscriptions, queue, inflight
                existing.connect_info = connect_info
                existing.limits = limits
                existing.clean_start = clean_start
                existing.will = connect_info.will
                existing.transfer_inflight_to_queue()
                # a resume is a change of ownership too: re-fence so a
                # concurrent owner elsewhere loses the heal-time conflict
                existing.fence = self.next_fence()
                if (ctx.durability is not None
                        and existing.limits.session_expiry > 0):
                    # back online: clear the expiry-countdown anchor and
                    # persist the resume's re-fence
                    ctx.durability.on_session_online(
                        existing.client_id, existing.fence)
                return existing, True
            await self.terminate(existing, "takeover-clean")
        session = Session(ctx, id, connect_info, limits, clean_start)
        session.fence = self.next_fence()
        self._sessions[id.client_id] = session
        # durability plane (broker/durability.py): persistent sessions
        # journal their creation so a kill -9 rebuilds them at boot
        if ctx.durability is not None:
            ctx.durability.on_session_created(session)
        await ctx.hooks.fire(HookType.SESSION_CREATED, id, None, None)
        return session, False

    async def terminate(self, session: Session, reason: str) -> None:
        """Remove the session + its router entries (SessionTerminated path)."""
        cur = self._sessions.get(session.client_id)
        if cur is not session:
            return  # already replaced by a newer session
        del self._sessions[session.client_id]
        # drop the expiry timer so the dead session object is not pinned in
        # memory for the rest of its expiry window (transfer/kick paths)
        current = asyncio.current_task()
        t = session._expiry_task
        if t is not None and t is not current:
            t.cancel()
        session._expiry_task = None
        if reason == "cluster-kick":
            # the client reconnected elsewhere: a pending delayed will from
            # the earlier abnormal disconnect must not fire
            if session._will_task is not None and session._will_task is not current:
                session._will_task.cancel()
            session._will_task = None
        from rmqtt_tpu_torch.core.topic import strip_prefixes

        items = []
        for full_filter, opts in list(session.subscriptions.items()):
            try:
                stripped = strip_prefixes(full_filter)
            except Exception:
                stripped = full_filter
            items.append((stripped, session.id))
        if items:
            await self.router_remove_many(items)
        session.subscriptions.clear()
        if (self.ctx.durability is not None
                and session.limits.session_expiry > 0):
            self.ctx.durability.on_session_terminated(session.client_id)
        await self.ctx.hooks.fire(HookType.SESSION_TERMINATED, session.id, reason, None)

    # ------------------------------------------------------------ sub/unsub
    async def subscribe(
        self, session: Session, full_filter: str, stripped: str, opts: SubscriptionOptions,
        limit: Optional[int] = None,
    ) -> None:
        """Router add + session bookkeeping (shared.rs:555-574). Async so
        cluster modes can await consensus (raft proposals) before SUBACK.

        ``limit`` enforces $limit/$exclusive immediately before the relation
        insert — atomic on this node (no awaits in between); under raft the
        replicated count still has a cross-node race window (PLAN.md).
        """
        if limit is not None and self.ctx.router.subscribers_count(
            stripped, exclude_client=session.client_id
        ) >= limit:
            raise SubscriptionLimitExceeded(stripped)
        await self.router_add(stripped, session.id, opts)
        session.subscriptions[full_filter] = opts
        # durability: subscriptions of persistent sessions journal through
        # the registry chokepoint, so every mode (live SUBSCRIBE, HTTP API,
        # auto-subscription, cluster restore) is covered alike
        if (self.ctx.durability is not None
                and session.limits.session_expiry > 0):
            self.ctx.durability.on_subscribe(
                session.client_id, full_filter, opts)

    async def router_add(self, stripped: str, id, opts) -> None:
        self.ctx.router.add(stripped, id, opts)

    async def router_remove(self, stripped: str, id) -> None:
        self.ctx.router.remove(stripped, id)

    async def router_remove_many(self, items) -> None:
        """Bulk removal (one consensus round in raft mode)."""
        for stripped, id in items:
            await self.router_remove(stripped, id)

    async def unsubscribe(self, session: Session, full_filter: str) -> bool:
        from rmqtt_tpu_torch.core.topic import strip_prefixes

        opts = session.subscriptions.pop(full_filter, None)
        if opts is None:
            return False
        try:
            stripped = strip_prefixes(full_filter)
        except Exception:
            stripped = full_filter
        await self.router_remove(stripped, session.id)
        if (self.ctx.durability is not None
                and session.limits.session_expiry > 0):
            self.ctx.durability.on_unsubscribe(session.client_id, full_filter)
        return True

    async def retain_load_with(self, topic_filter: str):
        """Retained messages matching a new subscription (the reference's
        ``retain_load_with``, shared.rs:290-295): node-local here; cluster
        registries merge peers' stores under TopicOnly sync."""
        return self.ctx.retain.matches(topic_filter)

    # --------------------------------------------------------------- fanout
    async def forwards(self, msg: Message) -> int:
        """Route + deliver; returns the number of target subscribers
        (shared.rs `forwards` :735-820 → `forwards_to` :876-963).

        Latency note: the publish-e2e stage (`publish.e2e`) is recorded at
        the MQTT ingress (`session.py _publish`) rather than here, so the
        cluster registries — which override this method wholesale — share
        the same instrumentation point."""
        # the publish ingress set the trace context for this task
        # (broker/tracing.py); fan-out hands it to each DeliverItem so the
        # per-subscriber deliver loops can stamp their spans
        trace = CURRENT_TRACE.get() if self.ctx.telemetry.enabled else None
        # p2p short-circuit (shared.rs:743-769)
        if msg.target_clientid is not None:
            target = self._sessions.get(msg.target_clientid)
            if target is None:
                return 0
            target.enqueue(
                DeliverItem(msg=msg, qos=msg.qos, retain=False, topic_filter="",
                            trace=trace)
            )
            self._mark_forwarded(msg, msg.target_clientid)
            return 1
        # routed through the epoch-versioned match cache when the topic is
        # hot: the collapsed map comes straight from the cached expansion
        # (shared-group choice still per publish) and never enters the
        # batcher; the QoS0 wire_cache below then reuses encode work WITHIN
        # the fan-out, so a hot topic pays neither match nor re-encode
        relmap, cache_hit = await self.ctx.routing.matches_for_fanout(
            msg.from_id, msg.topic)
        if self.ctx.routing.cache is not None:
            # only meaningful with the cache on — counting misses while
            # disabled would read as a malfunctioning cache (0% hit rate)
            self.ctx.metrics.inc(
                "messages.route_cache_hit" if cache_hit
                else "messages.route_cache_miss")
        count = 0
        wire_cache: dict = {}  # one encoded-frame cache per fan-out
        for node_id, relations in relmap.items():
            # single-node: everything is local; cluster mode dispatches
            # remote nodes over the cluster backend (round 2+)
            for rel in relations:
                count += self._deliver_local(rel.id.client_id, rel.topic_filter,
                                             rel.opts, msg, wire_cache, trace)
        return count

    def _deliver_local(
        self, client_id: str, topic_filter: str, opts: SubscriptionOptions,
        msg: Message, wire_cache: Optional[dict] = None, trace=None,
    ) -> int:
        session = self._sessions.get(client_id)
        if session is None:
            # a relation raced a session termination: the message cannot be
            # delivered — reason-labeled so fan-out loss is observable
            self.ctx.metrics.drop("no_session")
            return 0
        retain = msg.retain if opts.retain_as_published else False
        session.enqueue(
            DeliverItem(
                msg=msg,
                qos=min(opts.qos, msg.qos),
                retain=retain,
                topic_filter=topic_filter,
                sub_ids=opts.subscription_ids,
                wire_cache=wire_cache if wire_cache is not None else {},
                trace=trace,
            )
        )
        self._mark_forwarded(msg, client_id)
        return 1

    def _mark_forwarded(self, msg: Message, client_id: str) -> None:
        """Live delivery counts as forwarded for the message store, so a
        later subscribe-time replay skips it (shared.rs:751-760). Only the
        node that stored the message (its publish-ingress node, from_id)
        marks — a foreign stored_id written into THIS node's store could
        collide with a local sid and suppress a legitimate replay; remote
        deliveries are reconciled by ForwardsToAck instead."""
        if msg.stored_id is None or (
            msg.from_id is not None and msg.from_id.node_id != self.ctx.node_id
        ):
            return
        mgr = getattr(self.ctx, "message_mgr", None)
        if mgr is not None:
            mgr.mark_forwarded(msg.stored_id, client_id, ttl=msg.expiry_interval)
