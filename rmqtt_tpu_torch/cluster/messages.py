"""Cluster RPC message vocabulary + (de)serialization of broker DTOs.

Mirrors the reference's 19-variant ``Message`` enum and ``MessageReply``
(`rmqtt/src/grpc.rs:506-535, 616-638`): the same taxonomy —
Forwards / ForwardsTo(+recipient bookkeeping) / Kick / retain sync /
subscription queries / counters / online checks / ping / opaque data —
carried over the asyncio TCP mesh instead of tonic gRPC.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.router.base import Id, SubRelation, SubscriptionOptions

# message type tags (grpc.rs Message variants)
FORWARDS = "forwards"
FORWARDS_TO = "forwards_to"
FORWARDS_TO_ACK = "forwards_to_ack"  # mark-forwarded bookkeeping (shared.rs:596-613)
KICK = "kick"
GET_RETAINS = "get_retains"
SET_RETAIN = "set_retain"
NUMBER_OF_CLIENTS = "number_of_clients"
NUMBER_OF_SESSIONS = "number_of_sessions"
ONLINE = "online"
SESSION_STATUS = "session_status"
SUBSCRIPTIONS_GET = "subscriptions_get"
SUBSCRIPTIONS_SEARCH = "subscriptions_search"  # grpc.rs SubscriptionsSearch
CLIENTS_GET = "clients_get"
STATS_GET = "stats_get"
ROUTES_GET = "routes_get"
ROUTES_GET_BY = "routes_get_by"  # grpc.rs RoutesGetBy(Topic)
MESSAGE_GET = "message_get"  # cross-node stored-message fetch (merge_on_read)
PING = "ping"
DATA = "data"
# membership + anti-entropy vocabulary (cluster/membership.py): the failure
# detector's periodic probe (carries incarnation + fence clock) and the
# rejoin repair protocol — digests first, deltas only where they differ
HEARTBEAT = "heartbeat"
SYNC_DIGEST = "sync_digest"  # retained-store + subscription-directory digests
SYNC_RETAIN_SUMMARY = "sync_retain_summary"  # {topic: [ct, payload_hash]}
SYNC_RETAIN_PULL = "sync_retain_pull"  # fetch named topics' retained msgs
SYNC_RETAIN_PUSH = "sync_retain_push"  # deliver newer-here retained msgs
SYNC_SESSIONS = "sync_sessions"  # duplicate-session fence resolution
SYNC_ROUTES = "sync_routes"  # raft-mode route-table pull (repair fallback)

# reply tags
OK = "ok"
ERROR = "error"


def msg_to_wire(m: Message) -> dict:
    return {
        "topic": m.topic,
        "payload": m.payload,
        "qos": m.qos,
        "retain": m.retain,
        "props": [[k, v] for k, v in m.properties.items()],
        "ct": m.create_time,
        "exp": m.expiry_interval,
        "from": [m.from_id.node_id, m.from_id.client_id] if m.from_id else None,
        "target": m.target_clientid,
        "sid": m.stored_id,
    }


def msg_from_wire(d: dict) -> Message:
    props = {}
    for k, v in d.get("props") or []:
        if isinstance(v, list):
            # repeatable props: user-property pairs come back as 2-lists
            v = [tuple(x) if isinstance(x, list) else x for x in v]
        props[k] = v
    frm = d.get("from")
    return Message(
        topic=d["topic"],
        payload=d["payload"],
        qos=d["qos"],
        retain=d["retain"],
        properties=props,
        create_time=d["ct"],
        expiry_interval=d["exp"],
        from_id=Id(frm[0], frm[1]) if frm else None,
        target_clientid=d.get("target"),
        stored_id=d.get("sid"),
    )


def trace_to_wire(trace) -> Optional[list]:
    """Optional trace-context field riding the FORWARDS / FORWARDS_TO
    bodies (broker/tracing.py): ``[trace_id_hex, sampled]``. ``None`` (or
    an absent key) means "untraced" — receivers MUST treat the field as
    optional so frames from nodes without tracing keep decoding; the
    receiving node adopts the id via ``Tracer.from_wire`` so spans recorded
    there stitch back to the publisher's trace."""
    return None if trace is None else [trace.tid, bool(trace.sampled)]


def opts_to_wire(o: SubscriptionOptions) -> list:
    return [o.qos, o.no_local, o.retain_as_published, o.retain_handling,
            list(o.subscription_ids), o.shared_group]


def opts_from_wire(v: list) -> SubscriptionOptions:
    return SubscriptionOptions(
        qos=v[0], no_local=v[1], retain_as_published=v[2], retain_handling=v[3],
        subscription_ids=tuple(v[4]), shared_group=v[5],
    )


def relation_to_wire(r: SubRelation) -> list:
    return [r.topic_filter, r.id.node_id, r.id.client_id, opts_to_wire(r.opts)]


def relation_from_wire(v: list) -> SubRelation:
    return SubRelation(topic_filter=v[0], id=Id(v[1], v[2]), opts=opts_from_wire(v[3]))
