"""Persistent-session plugin.

Mirrors `rmqtt-plugins/rmqtt-session-storage`: offline sessions (basic info,
subscriptions, queued messages) persist to SQLite; on broker startup they are
rebuilt as offline sessions with expiry timers, the reference's
``offline_restart`` path (`rmqtt/src/session.rs:516-558`), so queued QoS1/2
messages survive a broker restart until the client returns or the session
expires.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.session import Session, restore_session, session_snapshot
from rmqtt_tpu_torch.plugins import Plugin

NS = "session"


class SessionStoragePlugin(Plugin):
    name = "rmqtt-session-storage"
    descr = "persistent sessions + offline queues (sqlite or redis)"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        if getattr(ctx, "durability", None) is not None:
            # two owners of session persistence cannot coexist: this
            # plugin's boot-time restore would land sessions in the
            # registry FIRST, making durability recovery skip them — and
            # silently drop their journaled (publisher-acked) pending
            # QoS1/2 records. The durability plane subsumes this plugin
            # (it also persists live inflight state, which the disconnect
            # hook here never sees), so refuse loudly at load.
            raise ValueError(
                "rmqtt-session-storage cannot combine with [durability]: "
                "the durability plane already persists sessions (and "
                "their unacked windows) — disable one of the two")
        from rmqtt_tpu_torch.storage import make_store

        self.store = make_store(self.config)
        # network backend: connect/disconnect hooks must not run socket
        # round trips on the event loop (same invariant as message_storage)
        self._net = bool(getattr(self.store, "network", False))
        self._unhooks = []

    def _snapshot(self, s: Session) -> dict:
        return session_snapshot(s)

    async def _store_call(self, fn, *args, **kw):
        if self._net:
            import asyncio
            import functools

            return await asyncio.get_running_loop().run_in_executor(
                None, functools.partial(fn, *args, **kw))
        return fn(*args, **kw)

    async def init(self) -> None:
        hooks = self.ctx.hooks
        # expired snapshots are reaped by the context-wide store sweep
        self.ctx.add_store(self.store)

        async def on_disconnected(_ht, args, _prev):
            id = args[0]
            # clean_start only discards the PREVIOUS session at connect time;
            # persistence is governed by the session expiry alone
            s = self.ctx.registry.get(id.client_id)
            if s is not None and s.limits.session_expiry > 0:
                snap = self._snapshot(s)  # snapshot on-loop (consistent view)
                await self._store_call(self.store.put, NS, s.client_id, snap,
                                       ttl=s.limits.session_expiry)
            return None

        async def on_terminated(_ht, args, _prev):
            await self._store_call(self.store.delete, NS, args[0].client_id)
            return None

        async def on_connected(_ht, args, _prev):
            # the live broker now owns this session again
            await self._store_call(self.store.delete, NS, args[0].id.client_id)
            return None

        self._unhooks = [
            hooks.register(HookType.CLIENT_DISCONNECTED, on_disconnected),
            hooks.register(HookType.SESSION_TERMINATED, on_terminated),
            hooks.register(HookType.CLIENT_CONNECTED, on_connected),
        ]

    async def start(self) -> None:
        """Rebuild persisted offline sessions (offline_restart)."""
        ctx = self.ctx
        for client_id, snap in self.store.scan(NS):
            if ctx.registry.get(client_id) is not None:
                continue
            if await restore_session(ctx, snap) is None:
                self.store.delete(NS, client_id)

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        self.ctx.remove_store(self.store)
        self.store.close()
        return True

    def attrs(self):
        return {"stored_sessions": self.store.count(NS)}
