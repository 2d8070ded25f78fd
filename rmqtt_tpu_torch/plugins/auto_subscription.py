"""Auto-subscription plugin.

Mirrors `rmqtt-plugins/rmqtt-auto-subscription`: a fixed subscription list
applied to every client at connect (`rmqtt/src/v5.rs:343-356` applies the
``AutoSubscription`` trait). Placeholders ``%c``/``%u`` expand per client.
"""

from __future__ import annotations

from typing import List, Tuple

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.core.topic import filter_valid, parse_shared
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import SubscriptionOptions


class AutoSubscriptionPlugin(Plugin):
    name = "rmqtt-auto-subscription"
    descr = "subscribe clients to fixed filters at connect"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        # [(topic_filter, qos)]
        self.subs: List[Tuple[str, int]] = [tuple(s) for s in self.config.get("subscribes", [])]
        self._unhooks = []

    async def init(self) -> None:
        async def on_connected(_ht, args, _prev):
            ci = args[0]
            session = self.ctx.registry.get(ci.id.client_id)
            if session is None:
                return None
            for tf, qos in self.subs:
                tf = tf.replace("%c", ci.id.client_id).replace("%u", ci.username or "")
                try:
                    group, stripped = parse_shared(tf)
                except ValueError:
                    continue
                if not filter_valid(stripped):
                    continue
                await self.ctx.registry.subscribe(
                    session, tf, stripped, SubscriptionOptions(qos=qos, shared_group=group)
                )
            return None

        self._unhooks = [self.ctx.hooks.register(HookType.CLIENT_CONNECTED, on_connected)]

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True
