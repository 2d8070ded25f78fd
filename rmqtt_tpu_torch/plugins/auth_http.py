"""HTTP authentication/ACL plugin.

Mirrors `rmqtt-plugins/rmqtt-auth-http`: authentication and ACL checks
delegate to external HTTP endpoints. Semantics follow the reference:
2xx → allow ("ignore" body falls through to the next handler), 4xx → deny,
unreachable → configurable default. The response body "superuser" marks the
client superuser for later ACL checks.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional
from urllib.parse import urlencode, urlparse

from rmqtt_tpu_torch.broker.hooks import HookResult, HookType
from rmqtt_tpu_torch.plugins import Plugin

log = logging.getLogger("rmqtt_tpu_torch.auth_http")


async def http_post_form(url: str, params: Dict[str, str], timeout: float = 5.0):
    """→ (status, body) with an x-www-form-urlencoded POST (reference default)."""
    from rmqtt_tpu_torch.utils import httpc

    status, payload = await httpc.request(
        url, "POST", body=urlencode(params).encode(),
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        timeout=timeout, read_body=True,
    )
    return status, payload.decode("utf-8", "replace")


class AuthHttpPlugin(Plugin):
    name = "rmqtt-auth-http"
    descr = "delegate authentication and ACL to HTTP endpoints"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.auth_url: Optional[str] = self.config.get("http_auth_req")
        self.acl_url: Optional[str] = self.config.get("http_acl_req")
        self.deny_if_unreachable = bool(self.config.get("deny_if_unreachable", False))
        self._superusers: set = set()
        self._unhooks = []

    async def init(self) -> None:
        hooks = self.ctx.hooks

        async def authenticate(_ht, args, prev):
            if self.auth_url is None:
                return None
            ci = args[0]
            try:
                status, body = await http_post_form(self.auth_url, {
                    "clientid": ci.id.client_id,
                    "username": ci.username or "",
                    "password": (ci.password or b"").decode("utf-8", "replace"),
                })
            except (OSError, asyncio.TimeoutError):
                self.ctx.metrics.inc("auth.http.unreachable")
                return HookResult(proceed=False, value=not self.deny_if_unreachable)
            if 200 <= status < 300:
                if "ignore" in body:
                    return None  # fall through (reference 'ignore')
                if "superuser" in body:
                    self._superusers.add(ci.id.client_id)
                return HookResult(proceed=False, value=True)
            return HookResult(proceed=False, value=False)

        async def check_acl(action: str, id, topic) -> Optional[bool]:
            if self.acl_url is None:
                return None
            if id.client_id in self._superusers:
                return True
            try:
                status, body = await http_post_form(self.acl_url, {
                    "clientid": id.client_id,
                    "access": "2" if action == "publish" else "1",
                    "topic": topic,
                })
            except (OSError, asyncio.TimeoutError):
                return not self.deny_if_unreachable
            if 200 <= status < 300:
                return None if "ignore" in body else True
            return False

        async def pub_acl(_ht, args, prev):
            verdict = await check_acl("publish", args[0], args[1].topic)
            if verdict is None:
                return None
            return HookResult(proceed=False, value=verdict)

        async def sub_acl(_ht, args, prev):
            verdict = await check_acl("subscribe", args[0], args[1])
            if verdict is None:
                return None
            return HookResult(proceed=False, value=verdict)

        async def terminated(_ht, args, _prev):
            self._superusers.discard(args[0].client_id)
            return None

        self._unhooks = [
            hooks.register(HookType.CLIENT_AUTHENTICATE, authenticate, priority=50),
            hooks.register(HookType.MESSAGE_PUBLISH_CHECK_ACL, pub_acl, priority=50),
            hooks.register(HookType.CLIENT_SUBSCRIBE_CHECK_ACL, sub_acl, priority=50),
            hooks.register(HookType.SESSION_TERMINATED, terminated),
        ]

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True
