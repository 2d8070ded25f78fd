"""Web-hook plugin.

Mirrors `rmqtt-plugins/rmqtt-web-hook`: pushes hook events as JSON to HTTP
endpoints, with a bounded queue and retry/backoff; per-event topic filters
limit message events. HTTP POST is a minimal asyncio client (no external
deps; reference uses reqwest).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import List, Optional
from urllib.parse import urlparse

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin

log = logging.getLogger("rmqtt_tpu_torch.webhook")

# events forwarded by default (reference pushes 20+ hook events)
DEFAULT_EVENTS = [
    "client_connected", "client_disconnected", "session_created",
    "session_terminated", "session_subscribed", "session_unsubscribed",
    "message_publish", "message_delivered", "message_acked", "message_dropped",
]


async def http_post_json(url: str, obj: dict, timeout: float = 5.0) -> int:
    from rmqtt_tpu_torch.utils import httpc

    status, _ = await httpc.request(
        url, "POST", body=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, timeout=timeout,
    )
    return status


class WebHookPlugin(Plugin):
    name = "rmqtt-web-hook"
    descr = "push hook events as JSON to HTTP endpoints"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.urls: List[str] = self.config.get("urls", [])
        self.events: List[str] = self.config.get("events", DEFAULT_EVENTS)
        self.topic_filter: Optional[str] = self.config.get("topic_filter")
        self.max_queue = int(self.config.get("max_queue", 10_000))
        self.retries = int(self.config.get("retries", 3))
        self._q: Optional[asyncio.Queue] = None
        self._pump: Optional[asyncio.Task] = None
        self._unhooks = []

    async def init(self) -> None:
        wanted = {HookType(e) for e in self.events}

        def make(ht: HookType):
            async def push(_ht, args, _prev):
                event = {"action": ht.value, "node": self.ctx.node_id, "ts": time.time()}
                for a in args:
                    if a is None:
                        continue
                    if hasattr(a, "client_id"):
                        event["clientid"] = a.client_id
                    elif hasattr(a, "id") and hasattr(a.id, "client_id"):
                        event["clientid"] = a.id.client_id  # ConnectInfo
                        if getattr(a, "username", None):
                            event["username"] = a.username
                    elif hasattr(a, "topic"):
                        if self.topic_filter and not match_filter(self.topic_filter, a.topic):
                            return None
                        event["topic"] = a.topic
                        event["qos"] = a.qos
                        event["retain"] = a.retain
                    elif isinstance(a, str):
                        event.setdefault("reason", a)
                if self._q is not None:
                    try:
                        self._q.put_nowait(event)
                    except asyncio.QueueFull:
                        self.ctx.metrics.inc("webhook.dropped")
                return None

            return push

        self._unhooks = [
            self.ctx.hooks.register(ht, make(ht), priority=-200) for ht in wanted
        ]

    async def start(self) -> None:
        self._q = asyncio.Queue(maxsize=self.max_queue)
        self._pump = asyncio.get_running_loop().create_task(self._drain())

    async def _drain(self) -> None:
        while True:
            event = await self._q.get()
            for url in self.urls:
                backoff = 0.5
                for attempt in range(self.retries):
                    try:
                        status = await http_post_json(url, event)
                        if status < 500:
                            self.ctx.metrics.inc("webhook.delivered")
                            break
                    except (OSError, asyncio.TimeoutError, ValueError):
                        pass
                    await asyncio.sleep(backoff)
                    backoff *= 2
                else:
                    self.ctx.metrics.inc("webhook.failed")

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        if self._pump is not None:
            self._pump.cancel()
            self._pump = None
        return True
