"""P2P (direct client→client) messaging plugin.

Mirrors `rmqtt-plugins/rmqtt-p2p-messaging`: publishes to
``$p2p/<clientid>/<topic>`` are delivered directly to that client, skipping
the router (the reference sets ``publish.target_clientid``, short-circuited
at `rmqtt/src/shared.rs:743-769`). Modes: ``p2p_only`` (default) or
``p2p_and_broker`` (also routed normally).
"""

from __future__ import annotations

import dataclasses

from rmqtt_tpu_torch.broker.hooks import HookResult, HookType
from rmqtt_tpu_torch.plugins import Plugin

PREFIX = "$p2p/"


class P2pPlugin(Plugin):
    name = "rmqtt-p2p-messaging"
    descr = "direct client-to-client publishes via $p2p/<clientid>/<topic>"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.mode = self.config.get("mode", "p2p_only")
        self._unhooks = []

    async def init(self) -> None:
        async def on_publish(_ht, args, prev):
            id, msg = args[0], args[1]
            cur = prev if prev is not None else msg
            if not cur.topic.startswith(PREFIX):
                return None
            rest = cur.topic[len(PREFIX) :]
            target, _, topic = rest.partition("/")
            if not target or not topic:
                return None
            return HookResult(
                value=dataclasses.replace(cur, topic=topic, target_clientid=target)
            )

        self._unhooks = [
            self.ctx.hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=90)
        ]

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True
