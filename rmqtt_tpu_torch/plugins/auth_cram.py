"""Enhanced-authentication plugin (MQTT 5 AUTH exchange, CRAM-SHA256).

Installs a ``CramSha256Authenticator`` (broker/auth.py) as the server's
enhanced-auth seam. The reference drives the AUTH packet flow from its v5
front-end (`rmqtt-codec/src/v5/packet/auth.rs` + session); the pluggable
method implementation is this module's addition.

Config::

    [plugins.rmqtt-auth-cram]
    users = { alice = "wonderland", bob = "builder" }  # user -> shared secret
"""

from __future__ import annotations

from rmqtt_tpu_torch.broker.auth import CramSha256Authenticator
from rmqtt_tpu_torch.plugins import Plugin


class AuthCramPlugin(Plugin):
    name = "rmqtt-auth-cram"
    descr = "MQTT5 enhanced auth: CRAM-SHA256 challenge-response"

    async def start(self) -> None:
        self.ctx.enhanced_auth = CramSha256Authenticator(self.config.get("users", {}))

    async def stop(self) -> bool:
        if isinstance(self.ctx.enhanced_auth, CramSha256Authenticator):
            self.ctx.enhanced_auth = None
        return True

    def attrs(self):
        auth = self.ctx.enhanced_auth
        return {"users": len(auth.secrets) if isinstance(auth, CramSha256Authenticator) else 0}
