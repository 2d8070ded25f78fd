"""Hook/event bus: the plugin seam of the broker.

Mirrors the reference hook system (`rmqtt/src/hook.rs`):
the hook ``Type`` catalog (:352-405), priority-ordered handler chains with
short-circuiting (:73-110 — highest priority first; a handler returning
``proceed=False`` stops the chain), and the ``(Parameter, HookResult)``
calling convention (:458-583) flattened into
``async handler(htype, *args, prev) -> HookResult | None``.
"""

from __future__ import annotations

import asyncio
import enum
import itertools
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple


class HookType(enum.Enum):
    # lifecycle (hook.rs:352-405; string names match the reference's From<&str>)
    BEFORE_STARTUP = "before_startup"
    SESSION_CREATED = "session_created"
    SESSION_TERMINATED = "session_terminated"
    SESSION_SUBSCRIBED = "session_subscribed"
    SESSION_UNSUBSCRIBED = "session_unsubscribed"
    CLIENT_AUTHENTICATE = "client_authenticate"
    CLIENT_CONNECT = "client_connect"
    CLIENT_CONNACK = "client_connack"
    CLIENT_CONNECTED = "client_connected"
    CLIENT_DISCONNECTED = "client_disconnected"
    CLIENT_SUBSCRIBE = "client_subscribe"
    CLIENT_UNSUBSCRIBE = "client_unsubscribe"
    CLIENT_SUBSCRIBE_CHECK_ACL = "client_subscribe_check_acl"
    CLIENT_KEEPALIVE = "client_keepalive"
    MESSAGE_PUBLISH_CHECK_ACL = "message_publish_check_acl"
    MESSAGE_PUBLISH = "message_publish"
    MESSAGE_DELIVERED = "message_delivered"
    MESSAGE_ACKED = "message_acked"
    MESSAGE_DROPPED = "message_dropped"
    MESSAGE_EXPIRY_CHECK = "message_expiry_check"
    MESSAGE_NONSUBSCRIBED = "message_nonsubscribed"
    OFFLINE_MESSAGE = "offline_message"
    OFFLINE_INFLIGHT_MESSAGES = "offline_inflight_messages"
    GRPC_MESSAGE_RECEIVED = "grpc_message_received"
    # overload-controller state change (broker/overload.py): fired with
    # (old_state_name, new_state_name, snapshot) on every transition
    SERVER_OVERLOAD = "server_overload"
    # SLO-engine objective state change (broker/slo.py): fired with
    # (objective_name, old_state_name, new_state_name, objective_row) on
    # every burn/exhaustion transition
    SERVER_SLO = "server_slo"
    # telemetry-history anomaly (broker/history.py): fired with
    # (series_name, sample_value, anomaly_row) on every baseline breach
    SERVER_ANOMALY = "server_anomaly"
    # hot-key attribution alert (broker/hotkeys.py): fired with
    # (space_name, key, alert_row) when a key space's top-1 share
    # crosses hotkeys_alert_share (transition-edged: once per episode)
    SERVER_HOTKEY = "server_hotkey"


@dataclass
class HookResult:
    """Outcome of a handler chain (reference HookResult, hook.rs:458-583).

    ``proceed=False`` short-circuits remaining handlers. ``value`` carries the
    type-specific payload (auth result, modified packet, ACL verdict, ...).
    """

    proceed: bool = True
    value: Any = None


# handler(htype, args: tuple, prev) → HookResult | None (None = pass-through).
# `args` arrives as ONE tuple so hook types can carry any payload arity
# without breaking handlers (the reference's typed Parameter enum flattened).
Handler = Callable[[Any, tuple, Any], Awaitable[Optional[HookResult]]]

_seq = itertools.count()


class HookRegistry:
    """Priority-ordered handler chains per hook type (DefaultHookManager,
    hook.rs:621-624). Higher priority runs first; ties break by registration
    order."""

    def __init__(self) -> None:
        self._handlers: Dict[HookType, List[Tuple[int, int, Handler]]] = {}

    def register(self, htype: HookType, handler: Handler, priority: int = 0) -> Callable[[], None]:
        entry = (-priority, next(_seq), handler)
        chain = self._handlers.setdefault(htype, [])
        chain.append(entry)
        chain.sort(key=lambda e: (e[0], e[1]))

        def unregister() -> None:
            try:
                chain.remove(entry)
            except ValueError:
                pass

        return unregister

    def handlers(self, htype: HookType) -> List[Handler]:
        return [h for _, _, h in self._handlers.get(htype, [])]

    async def fire(self, htype: HookType, *args: Any, initial: Any = None) -> Any:
        """Run the chain; returns the final value (hook.rs:73-110 semantics)."""
        value = initial
        for handler in self.handlers(htype):
            res = await handler(htype, args, value)
            if res is None:
                continue
            value = res.value if res.value is not None else value
            if not res.proceed:
                break
        return value
