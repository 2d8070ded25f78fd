"""Per-connection session state machine.

Mirrors `rmqtt/src/session.rs`: the online loop (run_loop
:308-402 — keepalive timer, inflight-retry timer, credit-gated deliver queue,
control messages, socket), publish ingress (:908-1064 — QoS0/1/2 with
in-flight QoS2 dedup, topic-alias resolve, ``$delayed`` parse, hooks, ACL,
retain), the subscribe path (:1276-1371), offline behavior (session expiry +
will-delay timers, :405-494), and takeover transfer (:1374-1427).

The host/TPU split: nothing here touches the device — publishes are handed
to ``SessionRegistry.forwards`` which parks on the micro-batched routing
service (`broker/routing.py`).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

from rmqtt_tpu_torch.broker.codec import MqttCodec, packets as pk, props as P
from rmqtt_tpu_torch.broker.codec.primitives import ProtocolViolation
from rmqtt_tpu_torch.broker.delayed import parse_delayed
from rmqtt_tpu_torch.broker.fitter import Limits
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.inflight import InInflight, MomentStatus, OutEntry, OutInflight
from rmqtt_tpu_torch.broker.queue import DeliverQueue, Policy
from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE
from rmqtt_tpu_torch.broker.types import (
    ConnectInfo,
    Message,
    RC_NOT_AUTHORIZED,
    RC_NO_MATCHING_SUBSCRIBERS,
    RC_PACKET_ID_NOT_FOUND,
    RC_SUCCESS,
    RC_TOPIC_ALIAS_INVALID,
    RC_TOPIC_FILTER_INVALID,
    RC_TOPIC_NAME_INVALID,
    RC_UNSPECIFIED_ERROR,
    now,
)
from rmqtt_tpu_torch.core.topic import (
    InvalidSharedFilter,
    filter_valid,
    parse_limit,
    parse_shared,
    split_levels,
    topic_valid,
)
from rmqtt_tpu_torch.router.base import Id, SubscriptionOptions


@dataclass
class DeliverItem:
    """One queued outbound publish (post-fanout, pre-socket)."""

    msg: Message
    qos: int  # effective = min(sub qos, msg qos)
    retain: bool  # retain-as-published / retained-replay flag
    topic_filter: str
    sub_ids: Tuple[int, ...] = ()
    dup: bool = False
    # durable id (broker/durability.py): the journal seq of this QoS1/2
    # delivery's pending record; 0 = not journaled (durability off, QoS0,
    # or a non-persistent session). Rides into the OutEntry so the
    # subscriber's PUBACK/PUBCOMP can journal the matching ack.
    did: int = 0
    # encoded-frame cache SHARED across one publish's fan-out (the fan-out
    # loop passes one dict per message): QoS0 subscribers on the same
    # protocol version reuse identical wire bytes instead of re-encoding
    wire_cache: dict = field(default_factory=dict)
    # active trace of the publish that fanned this item out
    # (broker/tracing.py): the deliver loop runs in another task, so the
    # context rides the item instead of the contextvar
    trace: object = None


def encode_qos0_frame(msg: Message, version: int, retain: bool, rem) -> bytes:
    """The QoS0 fan-out wire frame for one (protocol version, retain flag,
    remaining expiry) — byte-identical for every same-version subscriber (no
    packet id, no per-subscription props, aliases disabled), so it is
    encoded ONCE per publish and reused across the fan-out via the shared
    ``wire_cache`` dict keyed ``(version, retain, rem)``. Shared by the
    in-session fast path below and the intra-node fabric, which ships these
    frames to peer workers so the whole NODE encodes each variant once."""
    props: Dict[int, object] = {
        k: v
        for k, v in msg.properties.items()
        if k in (P.PAYLOAD_FORMAT_INDICATOR, P.CONTENT_TYPE, P.RESPONSE_TOPIC,
                 P.CORRELATION_DATA, P.USER_PROPERTY)
    }
    if rem is not None:
        props[P.MESSAGE_EXPIRY_INTERVAL] = rem
    pub = pk.Publish(
        topic=msg.topic, payload=msg.payload, qos=0,
        retain=retain, dup=False, packet_id=None,
        properties=props if version == pk.V5 else {},
    )
    return MqttCodec(version).encode(pub)


class Session:
    """Durable session state; survives reconnects when expiry > 0."""

    def __init__(
        self,
        ctx,
        id: Id,
        connect_info: ConnectInfo,
        limits: Limits,
        clean_start: bool,
    ) -> None:
        self.ctx = ctx
        self.id = id
        self.client_id = id.client_id
        self.connect_info = connect_info
        self.limits = limits
        self.clean_start = clean_start
        self.created_at = now()
        # original filter string (incl. $share prefix) → options
        self.subscriptions: Dict[str, SubscriptionOptions] = {}
        self.deliver_queue: DeliverQueue[DeliverItem] = DeliverQueue(limits.max_mqueue)
        self.out_inflight = OutInflight(max_inflight=limits.max_inflight)
        # inbound QoS2 window = our advertised Receive Maximum (MQTT-5 3.3.4)
        self.in_qos2 = InInflight(max_size=limits.max_inflight)
        self.connected = False
        self.state: Optional["SessionState"] = None
        self.will: Optional[pk.Will] = connect_info_will(connect_info)
        self._will_task: Optional[asyncio.Task] = None
        self._expiry_task: Optional[asyncio.Task] = None
        # session fencing epoch (cluster/membership.py): every takeover
        # stamps a monotonic (epoch, node_id) via registry.next_fence(), so
        # a healed partition resolves duplicate sessions deterministically
        # — highest fence wins, the stale side self-kicks (exactly once:
        # _fence_kicked guards the racing repair paths)
        self.fence: tuple = (0, id.node_id)
        self._fence_kicked = False

    # ---------------------------------------------------------------- fanout
    def enqueue(self, item: DeliverItem) -> None:
        """Push into the deliver queue (fan-out target, shared.rs:876-963).

        Overload tier (broker/overload.py): at ELEVATED, QoS0 fan-out to a
        SLOW consumer (queue past the shed fraction) is shed before it ever
        lands in the queue; at CRITICAL any backlogged consumer sheds QoS0.
        QoS1/2 keep their at-least-once path (drop policy below). Every
        drop is reason-labeled and, when the publish is traced, stamped as
        an ``overload.shed`` span so the trace says why it never arrived."""
        if not self.connected and self.limits.session_expiry <= 0:
            self.ctx.metrics.drop("no_session")
            hk = self.ctx.hotkeys
            if hk.enabled:  # reason-labeled drops gain a hot-key dimension
                hk.on_drop("no_session", self.client_id)
            return
        if item.qos == 0 and self.connected and self.ctx.overload.should_shed_qos0(
            self.deliver_queue
        ):
            self.ctx.metrics.drop("shed_qos0")
            hk = self.ctx.hotkeys
            if hk.enabled:
                hk.on_drop("shed_qos0", self.client_id)
            if item.trace is not None:
                item.trace.add_wall("overload.shed", 0, {
                    "client": self.client_id, "reason": "shed_qos0",
                    "queue": len(self.deliver_queue),
                    "state": self.ctx.overload.state.name,
                })
            asyncio.get_running_loop().create_task(
                self.ctx.hooks.fire(HookType.MESSAGE_DROPPED, self.id, item.msg, "shed-qos0")
            )
            return
        # durability plane (broker/durability.py): a QoS1/2 delivery bound
        # for a persistent session journals as pending BEFORE it can be
        # acknowledged anywhere — the publisher's PUBACK barrier then rides
        # the group commit. did != 0 marks an already-journaled item
        # (recovery re-enqueue), which must not double-journal.
        dur = self.ctx.durability
        if (dur is not None and item.qos > 0 and item.did == 0
                and self.limits.session_expiry > 0):
            item.did = dur.on_enqueue(self.client_id, item)
        policy = Policy.DROP_CURRENT if item.qos == 0 and self.connected else Policy.DROP_EARLY
        dropped = self.deliver_queue.push(item, policy)
        if dropped is not None:
            self.ctx.metrics.drop("queue_full")
            hk = self.ctx.hotkeys
            if hk.enabled:
                hk.on_drop("queue_full", self.client_id)
            if dur is not None and dropped.did:
                # a terminal drop resolves the pending record, or recovery
                # would resurrect a message the broker chose to shed
                dur.on_ack(self.client_id, dropped.did)
            asyncio.get_running_loop().create_task(
                self.ctx.hooks.fire(HookType.MESSAGE_DROPPED, self.id, dropped.msg, "queue-full")
            )
        if not self.connected:
            asyncio.get_running_loop().create_task(
                self.ctx.hooks.fire(HookType.OFFLINE_MESSAGE, self.id, item.msg, None)
            )

    # --------------------------------------------------------------- offline
    def on_disconnect(self, clean: bool, kicked: bool = False) -> None:
        """Socket gone: schedule will + expiry (session.rs:405-494)."""
        self.connected = False
        self.state = None
        # durability: anchor the expiry countdown so a broker restart
        # resumes the remaining window instead of a fresh one
        dur = self.ctx.durability
        if dur is not None and self.limits.session_expiry > 0:
            dur.on_session_offline(self.client_id)
        if len(self.out_inflight) and self.limits.session_expiry > 0 and not kicked:
            # unacked QoS1/2 carried into the GENUINE offline path only
            # (hook.rs OfflineInflightMessages; session.rs:277-291): a
            # takeover transfers the window to the new session instead —
            # persisting it too would duplicate deliveries after restart
            inflight_msgs = [e.msg for e in self.out_inflight.entries()]
            asyncio.get_running_loop().create_task(
                self.ctx.hooks.fire(
                    HookType.OFFLINE_INFLIGHT_MESSAGES, self.id, inflight_msgs, None
                )
            )
        if self.will is not None and not clean and not kicked:
            delay = float(self.will.properties.get(P.WILL_DELAY_INTERVAL, 0))
            delay = min(delay, self.limits.session_expiry) if self.limits.session_expiry > 0 else 0.0
            self._will_task = asyncio.get_running_loop().create_task(self._fire_will(delay))
        if self.limits.session_expiry > 0 and not (kicked and self.clean_start):
            self._expiry_task = asyncio.get_running_loop().create_task(
                self._expire(self.limits.session_expiry)
            )
        else:
            asyncio.get_running_loop().create_task(self.ctx.registry.terminate(self, "disconnect"))

    async def _fire_will(self, delay: float) -> None:
        if delay > 0:
            await asyncio.sleep(delay)
        will, self.will = self.will, None
        if will is None:
            return
        msg = Message(
            topic=will.topic,
            payload=will.payload,
            qos=will.qos,
            retain=will.retain,
            properties=dict(will.properties),
            from_id=self.id,
        )
        if will.retain:
            self.ctx.retain.set(will.topic, msg)
        await self.ctx.registry.forwards(msg)

    async def _expire(self, delay: float) -> None:
        await asyncio.sleep(delay)
        await self.ctx.registry.terminate(self, "expired")

    def on_reconnect(self) -> None:
        """Cancel pending offline timers (resumed before expiry)."""
        if self._expiry_task is not None:
            self._expiry_task.cancel()
            self._expiry_task = None
        if self._will_task is not None:
            self._will_task.cancel()
            self._will_task = None

    def transfer_inflight_to_queue(self) -> None:
        """Reconnect redelivery: unacked QoS1/2 → front of queue with DUP
        (session.rs rerelease/reforward :1469-1553)."""
        items = []
        for e in self.out_inflight.drain():
            if e.status is MomentStatus.UNCOMPLETE:
                # QoS2 already PUBREC'd: must resume with PUBREL, keep in window
                self.out_inflight.push(e)
                continue
            items.append(
                DeliverItem(
                    msg=e.msg, qos=e.qos, retain=e.retain, topic_filter="",
                    sub_ids=e.subscription_ids, dup=True, did=e.did,
                )
            )
        q = self.deliver_queue.drain()
        for it in items:
            self.deliver_queue.push(it)
        for it in q:
            self.deliver_queue.push(it)


def connect_info_will(ci: ConnectInfo) -> Optional[pk.Will]:
    return ci.will


def session_snapshot(s: Session, max_queue_items: Optional[int] = None) -> dict:
    """Serializable session state: identity, limits, subscriptions, queued
    AND unacked in-flight messages (the reference's SessionStateTransfer
    payload carries both, session.rs:1374-1427 + OfflineInfo inflight).
    Used by session-storage persistence and cross-node takeover transfer.
    ``max_queue_items`` caps the payload for wire transfer only."""
    from rmqtt_tpu_torch.cluster.messages import msg_to_wire, opts_to_wire

    items = []
    # unacked QoS1/2 go first, flagged DUP for redelivery; QoS2 already
    # PUBREC'd (UNCOMPLETE) would duplicate if replayed — dropped, as the
    # new connection cannot resume the old packet-id handshake
    for e in s.out_inflight.drain():
        if e.status is not MomentStatus.UNCOMPLETE:
            items.append([e.qos, e.retain, "", list(e.subscription_ids), msg_to_wire(e.msg), True])
    for it in s.deliver_queue._q:
        items.append([it.qos, it.retain, it.topic_filter, list(it.sub_ids), msg_to_wire(it.msg), it.dup])
    if max_queue_items is not None:
        items = items[:max_queue_items]
    return {
        "client_id": s.client_id,
        "node_id": s.id.node_id,
        "clean_start": s.clean_start,
        "created_at": s.created_at,
        "session_expiry": s.limits.session_expiry,
        "disconnected_at": time.time(),
        "max_inflight": s.limits.max_inflight,
        "max_mqueue": s.limits.max_mqueue,
        "protocol": s.connect_info.protocol,
        "keepalive": s.connect_info.keepalive,
        "subs": [[tf, opts_to_wire(o)] for tf, o in s.subscriptions.items()],
        "queue": items,
        "fence": list(s.fence),
    }


async def restore_session(ctx, snap: dict, node_id: Optional[int] = None) -> Optional[Session]:
    """Rebuild an OFFLINE session from a snapshot (offline_restart,
    session.rs:516-558): re-registers subscriptions (under ``node_id`` if
    given — the takeover-transfer case re-homes them) and refills the queue.
    Returns None if the snapshot already expired.

    NOTE: broker/durability.py `_restore_sessions` mirrors this for the
    journal-shaped durable state (plus per-item durable ids) — semantic
    fixes here (expiry math, fencing) must propagate there."""
    from rmqtt_tpu_torch.cluster.messages import msg_from_wire, opts_from_wire
    from rmqtt_tpu_torch.core.topic import strip_prefixes

    remaining = snap["session_expiry"] - (time.time() - snap["disconnected_at"])
    if remaining <= 0:
        return None
    sid = Id(node_id if node_id is not None else snap["node_id"], snap["client_id"])
    ci = ConnectInfo(
        id=sid, protocol=snap["protocol"], keepalive=snap["keepalive"], clean_start=False
    )
    limits = Limits(
        keepalive=snap["keepalive"], server_keepalive=False,
        max_inflight=snap["max_inflight"], max_mqueue=snap["max_mqueue"],
        session_expiry=remaining,
        max_message_expiry=ctx.cfg.fitter.max_message_expiry,
        max_topic_aliases_in=0, max_topic_aliases_out=0,
        max_packet_size=ctx.cfg.max_packet_size,
    )
    session = Session(ctx, sid, ci, limits, clean_start=False)
    session.fence = tuple(snap.get("fence", (0, sid.node_id)))
    # the restored fence must also advance the local clock, or the next
    # local takeover could stamp a LOWER fence than the state it resumes
    observe = getattr(ctx.registry, "observe_fence", None)
    if observe is not None:
        observe(session.fence[0])
    ctx.registry._sessions[snap["client_id"]] = session
    for tf, ow in snap["subs"]:
        opts = opts_from_wire(ow)
        try:
            stripped = strip_prefixes(tf)
        except ValueError:
            stripped = tf
        await ctx.registry.subscribe(session, tf, stripped, opts)
    for row in snap["queue"]:
        qos, retain, tf, sub_ids, mw = row[:5]
        dup = bool(row[5]) if len(row) > 5 else False
        msg = msg_from_wire(mw)
        if not msg.is_expired():
            session.deliver_queue.push(
                DeliverItem(msg=msg, qos=qos, retain=retain,
                            topic_filter=tf, sub_ids=tuple(sub_ids), dup=dup)
            )
    session._expiry_task = asyncio.get_running_loop().create_task(session._expire(remaining))
    return session


class SessionState:
    """The online half: socket ↔ session (session.rs run_loop :308-402)."""

    def __init__(self, ctx, session: Session, reader, writer, codec: MqttCodec) -> None:
        self.ctx = ctx
        self.s = session
        self.reader = reader
        self.writer = writer
        self.codec = codec
        self._wlock = asyncio.Lock()
        self._alias_in: Dict[int, str] = {}
        # outbound aliasing (v5): topic → alias, bounded by the client's
        # advertised Topic Alias Maximum (session.rs topic-alias tables)
        self._alias_out: Dict[str, int] = {}
        self._last_packet = time.monotonic()
        self._clean_disconnect = False
        self._kicked = False
        self._closing = asyncio.Event()
        self._disconnect_reason: Optional[int] = None
        # per-stage fast recorder (memoized in the registry; a no-op when
        # telemetry is disabled — the t0 guard means it's never called)
        self._rec_e2e = ctx.telemetry.recorder("publish.e2e")
        # packets a client pipelined behind CONNECT in the same TCP segment
        # (legal without waiting for CONNACK); replayed by _read_loop
        self.early_packets: list = []
        # coalesced egress (broker/egress.py): one vectored send per loop
        # tick instead of one write per frame. buffers_until_drain writers
        # (WsWriter) stay on the legacy path — their transport only
        # flushes on drain(), which the coalescer's tick flush never calls
        self._egress = None
        if (getattr(ctx, "egress_coalesce", False)
                and not getattr(writer, "buffers_until_drain", False)):
            from rmqtt_tpu_torch.broker.egress import EgressBuf

            self._egress = EgressBuf(
                writer, ctx.metrics,
                high_water=getattr(ctx, "egress_high_water", 64 * 1024))

    # ------------------------------------------------------------------ io
    async def send(self, packet) -> None:
        await self.send_raw(self.codec.encode(packet))

    async def send_raw(self, data: bytes) -> None:
        eb = self._egress
        if eb is not None:
            # coalesced path: the frame joins the connection's per-tick
            # vector; one call_soon flush hands everything queued this
            # tick to the transport as a single vectored write. Past the
            # high-water mark flush inline and drain — same backpressure
            # the legacy gate applied, now counting our own pending bytes
            # too (the transport can't see frames still in the vector).
            async with self._wlock:
                eb.feed(data)
                transport = getattr(self.writer, "transport", None)
                if transport is None:
                    eb.flush()
                    await self.writer.drain()
                elif (eb.pending_bytes + transport.get_write_buffer_size()
                      > eb.high_water):
                    eb.flush()
                    self.ctx.metrics.inc("net.egress_drains")
                    await self.writer.drain()
            return
        async with self._wlock:
            self.writer.write(data)
            # drain only under backpressure: an await per delivered message
            # halves throughput, and asyncio buffers safely below the
            # high-water mark (the 64KB gate bounds growth between drains).
            # Writers that only flush ON drain (WsWriter) keep draining
            # every send.
            transport = getattr(self.writer, "transport", None)
            if (
                getattr(self.writer, "buffers_until_drain", False)
                or transport is None
                or transport.get_write_buffer_size() > 64 * 1024
            ):
                await self.writer.drain()

    async def close(self, kicked: bool = False) -> None:
        self._kicked = self._kicked or kicked
        self._closing.set()

    # ---------------------------------------------------------------- loop
    async def run(self) -> None:
        s = self.s
        tasks = [
            asyncio.create_task(self._read_loop(), name=f"read:{s.client_id}"),
            asyncio.create_task(self._deliver_loop(), name=f"deliver:{s.client_id}"),
            asyncio.create_task(self._retry_loop(), name=f"retry:{s.client_id}"),
        ]
        timeout = self.ctx.fitter.keepalive_timeout(s.limits.keepalive)
        wheel = getattr(self.ctx, "keepalive_wheel", None)
        wheel_entry = None
        if timeout > 0:
            if wheel is not None:
                # hashed timer wheel: one ticking task per worker instead
                # of one timer coroutine per connection (broker/egress.py)
                wheel_entry = wheel.arm(self, timeout)
            else:
                tasks.append(asyncio.create_task(self._keepalive_loop(timeout)))
        closer = asyncio.create_task(self._closing.wait())
        try:
            done, pending = await asyncio.wait(
                tasks + [closer], return_when=asyncio.FIRST_COMPLETED
            )
            for t in done:
                if t is not closer and t.exception() is not None and not isinstance(
                    t.exception(), (ConnectionError, asyncio.IncompleteReadError)
                ):
                    self.ctx.metrics.inc("session.loop_errors")
        finally:
            for t in tasks + [closer]:
                t.cancel()
            if wheel_entry is not None:
                wheel.disarm(wheel_entry)
            try:
                if self.s.connect_info.protocol == pk.V5 and self._kicked:
                    from rmqtt_tpu_torch.broker.types import RC_SESSION_TAKEN_OVER

                    await asyncio.wait_for(
                        self.send(pk.Disconnect(RC_SESSION_TAKEN_OVER)), timeout=1.0
                    )
            except Exception:
                pass
            if self._egress is not None:
                # push any still-vectored frames (the kicked DISCONNECT
                # above included) into the transport before close()
                self._egress.flush()
                self._egress.close()
            try:
                self.writer.close()
            except Exception:
                pass
            await self.ctx.hooks.fire(
                HookType.CLIENT_DISCONNECTED, s.id, self._reason_string(), None
            )
            s.on_disconnect(clean=self._clean_disconnect, kicked=self._kicked)

    def _reason_string(self) -> str:
        if self._kicked:
            return "kicked"
        if self._clean_disconnect:
            return "by-client"
        return "socket-closed"

    async def _read_loop(self) -> None:
        early, self.early_packets = self.early_packets, []
        for p in early:
            await self._handle(p)
        if self.codec.pending_error is not None:
            # the pipelined CONNECT burst ended in a malformed frame (even
            # with no valid packets between CONNECT and the bad frame):
            # any valid packets above were processed first, then close
            self.ctx.metrics.inc("protocol.errors")
            await self._disconnect_with(self.codec.pending_error.reason_code)
            return
        while True:
            data = await self.reader.read(65536)
            if not data:
                return
            self._last_packet = time.monotonic()
            try:
                packets = self.codec.feed(data)
            except ProtocolViolation as e:
                self.ctx.metrics.inc("protocol.errors")
                # v5: name the violation before closing (DISCONNECT 0x95
                # packet-too-large / 0x81 malformed; disconnect.rs reasons)
                await self._disconnect_with(e.reason_code)
                return
            for p in packets:
                await self._handle(p)
            if self.codec.pending_error is not None:
                # a later frame in the chunk was malformed; valid packets
                # above were processed first
                self.ctx.metrics.inc("protocol.errors")
                await self._disconnect_with(self.codec.pending_error.reason_code)
                return

    async def _deliver_loop(self) -> None:
        s = self.s
        while True:
            await s.deliver_queue.wait_nonempty()
            await s.deliver_queue.throttle()
            if not s.out_inflight.has_credit():
                # credit-gated (session.rs:362, inflight.rs:319): wake on the
                # ack that frees a slot instead of sleep-polling (which
                # capped QoS1/2 delivery at ~window/10ms per session)
                await s.out_inflight.wait_credit()
                continue
            item = s.deliver_queue.pop()
            if item is None:
                continue
            await self._deliver(item)

    async def _deliver(self, item: DeliverItem) -> None:
        s = self.s
        msg = item.msg
        # per-subscriber delivery span — only when the publish's trace is
        # actually recording (sampled, or already slow-promoted): unsampled
        # and disabled deliveries take no timestamps here
        tr = item.trace
        t_tr = (time.perf_counter_ns()
                if tr is not None and (tr.sampled or tr.slow) else 0)
        expired = await self.ctx.hooks.fire(
            HookType.MESSAGE_EXPIRY_CHECK, s.id, msg, initial=msg.is_expired()
        )
        if expired:
            self.ctx.metrics.inc("messages.expired")
            self.ctx.metrics.drop("expired")
            hk = self.ctx.hotkeys
            if hk.enabled:
                hk.on_drop("expired", s.client_id)
            if item.did and self.ctx.durability is not None:
                self.ctx.durability.on_ack(s.client_id, item.did)
            await self.ctx.hooks.fire(HookType.MESSAGE_DROPPED, s.id, msg, "expired")
            return
        props: Dict[int, object] = {
            k: v
            for k, v in msg.properties.items()
            if k in (P.PAYLOAD_FORMAT_INDICATOR, P.CONTENT_TYPE, P.RESPONSE_TOPIC,
                     P.CORRELATION_DATA, P.USER_PROPERTY)
        }
        rem = msg.remaining_expiry()
        if rem is not None:
            props[P.MESSAGE_EXPIRY_INTERVAL] = rem
        if item.sub_ids:
            props[P.SUBSCRIPTION_IDENTIFIER] = list(item.sub_ids)
        packet_id = None
        if item.qos > 0:
            packet_id = s.out_inflight.alloc_packet_id()
            if packet_id is None:
                if item.did and self.ctx.durability is not None:
                    self.ctx.durability.on_ack(s.client_id, item.did)
                await self.ctx.hooks.fire(HookType.MESSAGE_DROPPED, s.id, msg, "no-packet-id")
                return
            s.out_inflight.push(
                OutEntry(
                    packet_id, msg, item.qos, subscription_ids=item.sub_ids,
                    retain=item.retain, wire_props=dict(props),
                    trace=item.trace, did=item.did,
                )
            )
        # QoS0 fan-out fast path: for subscribers of the same protocol
        # version the wire frame is byte-identical (no packet id, no
        # per-subscription props, alias disabled), so encode ONCE per
        # publish and reuse the bytes across the whole fan-out — the
        # per-delivery encode was the hot loop's dominant cost
        # (shared.rs:876-963's preserialized-clone analogue)
        if (item.qos == 0 and not item.sub_ids and not (
                self.codec.version == pk.V5
                and s.limits.max_topic_aliases_out > 0)):
            key = (self.codec.version, item.retain, rem)
            cache = item.wire_cache
            data = cache.get(key)
            if data is None:
                data = cache[key] = encode_qos0_frame(
                    msg, self.codec.version, item.retain, rem)
            await self.send_raw(data)
            self.ctx.metrics.inc("messages.delivered")
            hk = self.ctx.hotkeys
            if hk.enabled:  # delivering-subscriber attribution seam
                hk.on_deliver(s.client_id)
            if t_tr:
                item.trace.add("deliver.send", t_tr,
                               time.perf_counter_ns() - t_tr,
                               {"client": s.client_id, "qos": 0})
            await self.ctx.hooks.fire(HookType.MESSAGE_DELIVERED, s.id, msg, None)
            return
        # outbound topic alias AFTER the drop checks: an alias must never be
        # registered for a publish that does not reach the wire (the client
        # would see later empty-topic reuses as 0x94 protocol errors)
        topic_out = msg.topic
        if self.codec.version == pk.V5 and s.limits.max_topic_aliases_out > 0:
            alias = self._alias_out.get(msg.topic)
            if alias is not None:
                props[P.TOPIC_ALIAS] = alias
                topic_out = ""  # established alias: omit the topic bytes
            elif len(self._alias_out) < s.limits.max_topic_aliases_out:
                alias = len(self._alias_out) + 1
                self._alias_out[msg.topic] = alias
                props[P.TOPIC_ALIAS] = alias  # first use carries both
        pub = pk.Publish(
            topic=topic_out,
            payload=msg.payload,
            qos=item.qos,
            retain=item.retain,
            dup=item.dup,
            packet_id=packet_id,
            properties=props if self.codec.version == pk.V5 else {},
        )
        await self.send(pub)
        self.ctx.metrics.inc("messages.delivered")
        hk = self.ctx.hotkeys
        if hk.enabled:  # delivering-subscriber attribution seam
            hk.on_deliver(s.client_id)
        if t_tr:
            item.trace.add("deliver.send", t_tr, time.perf_counter_ns() - t_tr,
                           {"client": s.client_id, "qos": item.qos})
        await self.ctx.hooks.fire(HookType.MESSAGE_DELIVERED, s.id, msg, None)

    async def _retry_loop(self) -> None:
        s = self.s
        while True:
            wait = s.out_inflight.next_retry_in()
            if wait is None:
                # empty window: block until a QoS1/2 delivery is in flight
                # instead of waking every retry_interval — at connection
                # scale the idle wakeups alone saturate the core
                await s.out_inflight.wait_nonempty()
                continue
            await asyncio.sleep(wait)
            for e in s.out_inflight.due():
                if not s.out_inflight.mark_retry(e):
                    self.ctx.metrics.drop("retries_exhausted")
                    hk = self.ctx.hotkeys
                    if hk.enabled:
                        hk.on_drop("retries_exhausted", s.client_id)
                    if e.did and self.ctx.durability is not None:
                        # terminal: the broker gave up on this delivery —
                        # recovery must not resurrect it
                        self.ctx.durability.on_ack(s.client_id, e.did)
                    await self.ctx.hooks.fire(
                        HookType.MESSAGE_DROPPED, s.id, e.msg, "retries-exhausted"
                    )
                    continue
                if e.status is MomentStatus.UNCOMPLETE:
                    await self.send(pk.Pubrel(e.packet_id))
                else:
                    # rebuild from the original wire fields; only the expiry
                    # countdown is refreshed
                    props = dict(e.wire_props)
                    rem = e.msg.remaining_expiry()
                    if rem is not None:
                        props[P.MESSAGE_EXPIRY_INTERVAL] = rem
                    await self.send(
                        pk.Publish(
                            topic=e.msg.topic,
                            payload=e.msg.payload,
                            qos=e.qos,
                            dup=True,
                            retain=e.retain,
                            packet_id=e.packet_id,
                            properties=props if self.codec.version == pk.V5 else {},
                        )
                    )

    async def _keepalive_loop(self, timeout: float) -> None:
        while True:
            idle = time.monotonic() - self._last_packet
            if idle >= timeout:
                proceed = await self.ctx.hooks.fire(
                    HookType.CLIENT_KEEPALIVE, self.s.id, idle, initial=True
                )
                if proceed:
                    self.ctx.metrics.inc("keepalive.timeouts")
                    self._closing.set()
                    return
            await asyncio.sleep(max(0.05, timeout - idle))

    # ------------------------------------------------------------- dispatch
    async def _handle(self, p) -> None:
        s = self.s
        if isinstance(p, pk.Publish):
            await self._on_publish(p)
        elif isinstance(p, pk.Puback):
            e = s.out_inflight.ack(p.packet_id)
            if e is not None:
                self._record_ack_rtt(e)
                if e.did and self.ctx.durability is not None:
                    self.ctx.durability.on_ack(s.client_id, e.did)
                await self.ctx.hooks.fire(HookType.MESSAGE_ACKED, s.id, e.msg, None)
        elif isinstance(p, pk.Pubrec):
            e = s.out_inflight.pubrec(p.packet_id)
            if e is not None:
                await self.send(pk.Pubrel(p.packet_id))
            elif self.codec.version == pk.V5:
                await self.send(pk.Pubrel(p.packet_id, RC_PACKET_ID_NOT_FOUND))
        elif isinstance(p, pk.Pubcomp):
            e = s.out_inflight.ack(p.packet_id)
            if e is not None:
                self._record_ack_rtt(e)
                if e.did and self.ctx.durability is not None:
                    self.ctx.durability.on_ack(s.client_id, e.did)
                await self.ctx.hooks.fire(HookType.MESSAGE_ACKED, s.id, e.msg, None)
        elif isinstance(p, pk.Pubrel):
            removed = s.in_qos2.remove(p.packet_id)
            dur = self.ctx.durability
            if (removed and dur is not None
                    and s.limits.session_expiry > 0):
                dur.on_qos2_release(s.client_id, p.packet_id)
                if dur.dirty:
                    # PUBCOMP is the client's license to REUSE this packet
                    # id: the release must be durable first, or a restored
                    # stale window entry would swallow a future publish
                    await dur.barrier()
            await self.send(pk.Pubcomp(p.packet_id))
        elif isinstance(p, pk.Subscribe):
            await self._on_subscribe(p)
        elif isinstance(p, pk.Unsubscribe):
            await self._on_unsubscribe(p)
        elif isinstance(p, pk.Pingreq):
            await self.ctx.hooks.fire(HookType.CLIENT_KEEPALIVE, s.id, 0.0, initial=True)
            await self.send(pk.Pingresp())
        elif isinstance(p, pk.Disconnect):
            from rmqtt_tpu_torch.broker.types import RC_DISCONNECT_WITH_WILL

            self._clean_disconnect = p.reason_code != RC_DISCONNECT_WITH_WILL
            self._disconnect_reason = p.reason_code
            self._closing.set()
        elif isinstance(p, pk.Auth):
            await self._on_auth(p)
        elif isinstance(p, pk.Connect):
            # second CONNECT is a protocol error (MQTT-3.1.0-2)
            self._closing.set()

    def _record_ack_rtt(self, e: OutEntry) -> None:
        """QoS1/2 ack round trip: last (re)delivery → PUBACK/PUBCOMP. Uses
        the inflight entry's ``sent_at`` stamp, so a retried delivery
        measures from its retransmission — the client-visible latency.
        A traced publish gets the same duration as its final span (acks
        land in another task, so the trace ref rides the inflight entry)."""
        tele = self.ctx.telemetry
        if tele.enabled:
            dur = int((time.monotonic() - e.sent_at) * 1e9)
            detail = {"topic": e.msg.topic, "qos": e.qos,
                      "client": self.s.client_id}
            tele.record("deliver.ack_rtt", dur, detail, e.trace)
            if e.trace is not None:
                e.trace.add_wall("deliver.ack_rtt", dur, detail)

    async def _on_auth(self, p: pk.Auth) -> None:
        """v5 re-authentication over the live connection (spec §4.12: client
        AUTH 0x19 starts, 0x18 continues; server answers AUTH until 0x00
        Success or disconnects with the failure code)."""
        from rmqtt_tpu_torch.broker import auth as ea

        s = self.s
        method = p.properties.get(P.AUTHENTICATION_METHOD)
        original = s.connect_info.properties.get(P.AUTHENTICATION_METHOD)
        authenticator = self.ctx.enhanced_auth
        if (
            authenticator is None
            or method is None
            or method != original  # method must not change mid-session (§4.12)
        ):
            await self._disconnect_with(ea.RC_BAD_AUTHENTICATION_METHOD)
            return
        data = p.properties.get(P.AUTHENTICATION_DATA)
        if p.reason_code == ea.RC_RE_AUTHENTICATE:
            rc, out = await authenticator.start(s.connect_info, method, data)
        elif p.reason_code == ea.RC_CONTINUE_AUTHENTICATION:
            rc, out = await authenticator.continue_(s.connect_info, method, data)
        else:
            await self._disconnect_with(0x82)  # protocol error
            return
        if rc in (ea.RC_AUTH_SUCCESS, ea.RC_CONTINUE_AUTHENTICATION):
            props = {P.AUTHENTICATION_METHOD: method}
            if out is not None:
                props[P.AUTHENTICATION_DATA] = out
            await self.send(pk.Auth(rc, props))
        else:
            self.ctx.metrics.inc("auth.failures")
            await self._disconnect_with(rc)

    # -------------------------------------------------------------- publish
    async def _on_publish(self, p: pk.Publish) -> None:
        s = self.s
        self.ctx.metrics.inc("publish.received")
        # v5 topic alias resolution (session.rs:994-998)
        if self.codec.version == pk.V5:
            alias = p.properties.get(P.TOPIC_ALIAS)
            if alias is not None:
                if not (1 <= int(alias) <= s.limits.max_topic_aliases_in):
                    await self._disconnect_with(RC_TOPIC_ALIAS_INVALID)
                    return
                if p.topic:
                    self._alias_in[int(alias)] = p.topic
                else:
                    topic = self._alias_in.get(int(alias))
                    if topic is None:
                        await self._disconnect_with(RC_TOPIC_ALIAS_INVALID)
                        return
                    p.topic = topic
        if p.qos > self.ctx.cfg.max_qos:
            await self._disconnect_with(RC_UNSPECIFIED_ERROR)
            return
        # QoS2 DUP resend of an ALREADY-ACCEPTED publish answers with the
        # dedup PUBREC before admission runs: the retransmit is not new
        # work, and refusing it would strand its in_qos2 entry (the client
        # abandons the flow without PUBREL, shrinking the window forever)
        if p.qos == 2 and p.packet_id in s.in_qos2:
            await self.send(pk.Pubrec(p.packet_id))
            return
        # hot-key attribution ingress seam (broker/hotkeys.py): topic by
        # count AND payload bytes, publishing client. After alias
        # resolution (the key must be the real topic) and the QoS2 dedup
        # check (a DUP resend is not new traffic), BEFORE admission — a
        # rate-limited top talker must still attribute
        hk = self.ctx.hotkeys
        if hk.enabled:
            hk.on_publish(p.topic, s.client_id, len(p.payload))
        # per-client publish admission (broker/overload.py token bucket),
        # AFTER alias resolution (the alias table must stay consistent even
        # across refused publishes) and BEFORE the in_qos2 insert so a
        # refused publish never occupies window state. v5 answers with
        # Quota Exceeded (0x97) on PUBACK/PUBREC; v3 has no per-publish
        # reason code, so the violating connection is closed.
        ov = self.ctx.overload
        if ov.enabled and not ov.admit_publish(s.client_id):
            from rmqtt_tpu_torch.broker.types import RC_QUOTA_EXCEEDED

            self.ctx.metrics.drop("rate_limited")
            if hk.enabled:
                hk.on_drop("rate_limited", s.client_id)
            await self.ctx.hooks.fire(
                HookType.MESSAGE_DROPPED, s.id,
                Message(topic=p.topic, payload=p.payload, qos=p.qos, from_id=s.id),
                "rate-limited",
            )
            if self.codec.version == pk.V5:
                if p.qos == 1:
                    await self.send(pk.Puback(p.packet_id, RC_QUOTA_EXCEEDED))
                elif p.qos == 2:
                    await self.send(pk.Pubrec(p.packet_id, RC_QUOTA_EXCEEDED))
                # QoS0: nothing to answer — the drop is counted and traced
            else:
                self._closing.set()
            return
        # QoS2 ingress window insert (session.rs:908-963)
        if p.qos == 2:
            if not s.in_qos2.add(p.packet_id):
                from rmqtt_tpu_torch.broker.types import RC_RECEIVE_MAX_EXCEEDED

                await self.send(pk.Pubrec(p.packet_id, RC_RECEIVE_MAX_EXCEEDED))
                return
            # durability: a persistent publisher's dedup-window entry is
            # journaled BEFORE the fan-out's own pending records — a
            # timer-driven commit landing mid-publish must never persist
            # the fan-out without the window entry, or a post-crash DUP
            # resend would fan out a second time (dup=False) on top of
            # the recovered redelivery. A refusal resolves it below.
            dur = self.ctx.durability
            if dur is not None and s.limits.session_expiry > 0:
                dur.on_qos2_open(s.client_id, p.packet_id)
        accepted, reason = await self._publish(p)
        if p.qos == 2 and not accepted:
            # refused: clear the dedup entry — in memory AND in the
            # journal (before the barrier), so a restored stale entry can
            # never swallow a future publish reusing this packet id
            s.in_qos2.remove(p.packet_id)
            dur = self.ctx.durability
            if dur is not None and s.limits.session_expiry > 0:
                dur.on_qos2_release(s.client_id, p.packet_id)
        # durability ack barrier (broker/durability.py): everything this
        # publish journaled (retained set, per-subscriber pending records,
        # the QoS2 window entry) must be group-committed BEFORE the
        # publisher sees PUBACK/PUBREC — the zero-acked-loss contract
        # across kill -9. Amortized: every concurrent publisher shares one
        # commit; no-op when nothing is buffered. QoS0 has no ack and
        # rides the flush window instead.
        if p.qos > 0:
            dur = self.ctx.durability
            if dur is not None and dur.dirty:
                await dur.barrier()
        if p.qos == 1:
            await self.send(pk.Puback(p.packet_id, reason if self.codec.version == pk.V5 else 0))
        elif p.qos == 2:
            await self.send(pk.Pubrec(p.packet_id, reason if self.codec.version == pk.V5 else 0))

    async def _publish(self, p: pk.Publish) -> Tuple[bool, int]:
        """The ingress pipeline (session.rs _publish :966-1064).

        Records the ``publish.e2e`` stage: PUBLISH decode handed to the
        pipeline → the last local forward enqueued (cluster scatter
        included for clustered registries) — the broker's dwell time, the
        number every perf PR reports against.

        Tracing (broker/tracing.py) begins here too: the trace context is
        set for the ingress task so routing / fan-out / cluster scatter
        stamp spans onto it, and finish() decides commit (head-sampled or
        slow) after the e2e duration is known — sharing e2e's timestamp
        pair, so tracing adds no clock reads to this path."""
        ctx = self.ctx
        t0 = time.perf_counter_ns() if ctx.telemetry.enabled else 0
        trace = tok = None
        if t0:
            trace = ctx.tracer.begin(p.topic)
            if trace is not None:
                tok = CURRENT_TRACE.set(trace)
        try:
            accepted, reason = await self._publish_inner(p)
        finally:
            if tok is not None:
                CURRENT_TRACE.reset(tok)
        if t0:
            dur = time.perf_counter_ns() - t0
            self._rec_e2e(dur, p.topic, trace)
            if trace is not None:
                trace.add("publish.ingress", t0, dur,
                          {"client": self.s.client_id, "qos": p.qos})
                ctx.tracer.finish(trace)
        return accepted, reason

    async def _publish_inner(self, p: pk.Publish) -> Tuple[bool, int]:
        s = self.s
        delay_secs = None
        topic = p.topic
        try:
            delay_secs, topic = parse_delayed(topic)
        except ValueError:
            return False, RC_TOPIC_NAME_INVALID
        if not topic_valid(topic):
            return False, RC_TOPIC_NAME_INVALID
        msg = Message.from_publish(
            p, from_id=s.id, topic=topic, delay_interval=delay_secs,
            expiry_cap=s.limits.max_message_expiry,
        )
        # hook may transform the message (message_publish, session.rs:1008)
        hooked = await self.ctx.hooks.fire(HookType.MESSAGE_PUBLISH, s.id, msg, initial=msg)
        if hooked is None:
            return False, RC_UNSPECIFIED_ERROR
        msg = hooked
        # ACL (message_publish_check_acl, session.rs:1011-1032)
        from rmqtt_tpu_torch.broker.acl import Action

        acl = self.ctx.acl.check(
            Action.PUBLISH, msg.topic, s.connect_info.username, s.client_id
        )
        allow = await self.ctx.hooks.fire(
            HookType.MESSAGE_PUBLISH_CHECK_ACL, s.id, msg, initial=acl.allow
        )
        if not allow:
            self.ctx.metrics.inc("publish.acl_denied")
            await self.ctx.hooks.fire(HookType.MESSAGE_DROPPED, s.id, msg, "acl-denied")
            return False, RC_NOT_AUTHORIZED
        if msg.retain:
            if not self.ctx.retain.set(msg.topic, msg):
                self.ctx.metrics.inc("retain.refused")
        if delay_secs is not None:
            stripped = replace(msg, retain=False)
            # durability: the PUBACK of a $delayed publish rides the same
            # barrier as everything else, so an acked delayed message
            # survives kill -9 and re-arms with its remaining delay
            dur = self.ctx.durability
            did = dur.on_delayed(delay_secs, stripped) if dur is not None else 0
            if not self.ctx.delayed.push(delay_secs, stripped, did=did):
                if did:
                    dur.on_delayed_done(did)  # refused: resolve the record
                await self.ctx.hooks.fire(HookType.MESSAGE_DROPPED, s.id, msg, "delayed-cap")
                return False, RC_UNSPECIFIED_ERROR
            return True, RC_SUCCESS
        count = await self.ctx.registry.forwards(msg)
        if count == 0:
            await self.ctx.hooks.fire(HookType.MESSAGE_NONSUBSCRIBED, s.id, msg, None)
            return True, RC_NO_MATCHING_SUBSCRIBERS
        return True, RC_SUCCESS

    async def _disconnect_with(self, reason: int) -> None:
        if self.codec.version == pk.V5:
            try:
                await self.send(pk.Disconnect(reason))
            except Exception:
                pass
        self._closing.set()

    # ------------------------------------------------------------ subscribe
    async def _on_subscribe(self, p: pk.Subscribe) -> None:
        s = self.s
        codes = []
        sub_id = None
        if self.codec.version == pk.V5:
            sids = p.properties.get(P.SUBSCRIPTION_IDENTIFIER)
            if sids:
                sub_id = int(sids[0])
        for tf, opts in p.filters:
            code = await self._subscribe_one(tf, opts, sub_id)
            if self.codec.version != pk.V5 and code >= 0x80:
                code = 0x80  # v3.1.1 SUBACK only knows 0x80 for failure
            codes.append(code)
        # durability: a SUBACKed subscription must survive kill -9 — wait
        # for the journaled sub records' group commit (no-op when clean)
        dur = self.ctx.durability
        if dur is not None and dur.dirty:
            await dur.barrier()
        await self.send(pk.Suback(p.packet_id, codes))

    async def _subscribe_one(self, topic_filter: str, opts: pk.SubOpts, sub_id) -> int:
        """session.rs _subscribe :1276-1371."""
        s = self.s
        cfg = self.ctx.cfg
        try:
            if cfg.limit_subscription:
                # $limit/$exclusive prefixes are an opt-in feature, like the
                # reference's limit_subscription listener flag (types.rs:570+)
                limit, unlimited = parse_limit(topic_filter)
            else:
                limit, unlimited = None, topic_filter
            group, stripped = parse_shared(unlimited)
        except InvalidSharedFilter:
            return RC_TOPIC_FILTER_INVALID
        if group is not None and not cfg.shared_subscription:
            from rmqtt_tpu_torch.broker.types import RC_SHARED_SUB_NOT_SUPPORTED

            return RC_SHARED_SUB_NOT_SUPPORTED
        if not filter_valid(stripped):
            return RC_TOPIC_FILTER_INVALID
        if cfg.max_subscriptions and len(s.subscriptions) >= cfg.max_subscriptions:
            from rmqtt_tpu_torch.broker.types import RC_QUOTA_EXCEEDED

            return RC_QUOTA_EXCEEDED
        if cfg.max_topic_levels and len(split_levels(stripped)) > cfg.max_topic_levels:
            return RC_TOPIC_FILTER_INVALID
        # hook + ACL (client_subscribe / client_subscribe_check_acl)
        await self.ctx.hooks.fire(HookType.CLIENT_SUBSCRIBE, s.id, topic_filter, None)
        from rmqtt_tpu_torch.broker.acl import Action

        acl = self.ctx.acl.check(
            Action.SUBSCRIBE, stripped, s.connect_info.username, s.client_id
        )
        allow = await self.ctx.hooks.fire(
            HookType.CLIENT_SUBSCRIBE_CHECK_ACL, s.id, topic_filter, initial=acl.allow
        )
        if not allow:
            return RC_NOT_AUTHORIZED
        qos = min(opts.qos, cfg.max_qos)
        sopts = SubscriptionOptions(
            qos=qos,
            no_local=opts.no_local,
            retain_as_published=opts.retain_as_published,
            retain_handling=opts.retain_handling,
            subscription_ids=(sub_id,) if sub_id is not None else (),
            shared_group=group,
        )
        is_new = topic_filter not in s.subscriptions
        try:
            await self.ctx.registry.subscribe(s, topic_filter, stripped, sopts, limit=limit)
        except Exception as e:
            from rmqtt_tpu_torch.broker.shared import SubscriptionLimitExceeded

            if isinstance(e, SubscriptionLimitExceeded):
                from rmqtt_tpu_torch.broker.types import RC_QUOTA_EXCEEDED

                return RC_QUOTA_EXCEEDED
            # e.g. raft consensus unavailable (no leader / minority partition)
            self.ctx.metrics.inc("subscribe.errors")
            return RC_UNSPECIFIED_ERROR
        await self.ctx.hooks.fire(HookType.SESSION_SUBSCRIBED, s.id, topic_filter, None)
        # retained replay (session.rs:1344-1365; retain-handling v5 3.8.3.1).
        # At ELEVATED+ the retained SCAN fan-out is paused (overload tier:
        # wildcard store scans are deferrable burst work, the live publish
        # path is not) — counted, never silently skipped.
        if group is None and self._should_send_retained(opts, is_new):
            if self.ctx.overload.allow_retained_scan():
                asyncio.get_running_loop().create_task(
                    self._send_retained(stripped, sopts)
                )
            else:
                self.ctx.metrics.inc("overload.retained_scans_paused")
        return qos

    def _should_send_retained(self, opts: pk.SubOpts, is_new: bool) -> bool:
        if not self.ctx.retain.enable:
            return False
        if self.codec.version != pk.V5:
            return True
        if opts.retain_handling == 0:
            return True
        if opts.retain_handling == 1:
            return is_new
        return False

    async def _send_retained(self, topic_filter: str, sopts: SubscriptionOptions) -> None:
        for _topic, msg in await self.ctx.registry.retain_load_with(topic_filter):
            item = DeliverItem(
                msg=msg,
                qos=min(sopts.qos, msg.qos),
                retain=True,  # retained replay always sets RETAIN (3.3.1-8)
                topic_filter=topic_filter,
                sub_ids=sopts.subscription_ids,
            )
            self.s.enqueue(item)

    async def _on_unsubscribe(self, p: pk.Unsubscribe) -> None:
        s = self.s
        codes = []
        for tf in p.filters:
            await self.ctx.hooks.fire(HookType.CLIENT_UNSUBSCRIBE, s.id, tf, None)
            ok = await self.ctx.registry.unsubscribe(s, tf)
            if ok:
                await self.ctx.hooks.fire(HookType.SESSION_UNSUBSCRIBED, s.id, tf, None)
            codes.append(RC_SUCCESS if ok else 0x11)  # 0x11 = no subscription existed
        dur = self.ctx.durability
        if dur is not None and dur.dirty:
            await dur.barrier()
        await self.send(pk.Unsuback(p.packet_id, codes))
