"""MQTT 5 enhanced authentication (AUTH packet exchange, spec §4.12).

The reference implements the AUTH codec in
`rmqtt-codec/src/v5/packet/auth.rs` and drives the exchange from its v5
session front-end; here the server side is a pluggable seam on the
``ServerContext`` (``ctx.enhanced_auth``):

- CONNECT carrying an Authentication Method property starts an exchange:
  the server may answer with AUTH (0x18 Continue authentication) challenges
  until the authenticator returns success (CONNACK, echoing the method) or
  failure (refusal CONNACK).
- A connected client may re-authenticate with AUTH (0x19 Re-authenticate);
  the same challenge loop runs over the live connection and ends with a
  server AUTH (0x00 Success) or a DISCONNECT carrying the failure code.

``CramSha256Authenticator`` is the bundled implementation (method
``CRAM-SHA256``): the server challenges with a random nonce, the client
answers ``HMAC-SHA256(secret, nonce)``.
"""

from __future__ import annotations

import hmac
import hashlib
import os
from typing import Dict, Optional, Tuple

# AUTH / CONNACK reason codes (mqtt5 spec; types.py holds the common ones)
RC_AUTH_SUCCESS = 0x00
RC_CONTINUE_AUTHENTICATION = 0x18
RC_RE_AUTHENTICATE = 0x19
RC_NOT_AUTHORIZED = 0x87
RC_BAD_AUTHENTICATION_METHOD = 0x8C


class EnhancedAuthenticator:
    """Server-side enhanced-auth driver. Implementations are stateful per
    in-flight exchange (keyed by client id) and must be safe to call from
    concurrent handshakes."""

    async def start(self, ci, method: str, data: Optional[bytes]) -> Tuple[int, Optional[bytes]]:
        """Begin an exchange (CONNECT or AUTH 0x19). Returns
        (reason_code, server_data): 0x18 to challenge, 0x00 to accept,
        anything else to refuse with that code."""
        raise NotImplementedError

    async def continue_(self, ci, method: str, data: Optional[bytes]) -> Tuple[int, Optional[bytes]]:
        """Process the client's AUTH 0x18 answer; same return contract."""
        raise NotImplementedError


class CramSha256Authenticator(EnhancedAuthenticator):
    """Challenge-response over a shared secret (method ``CRAM-SHA256``)."""

    METHOD = "CRAM-SHA256"

    def __init__(self, secrets: Dict[str, bytes]) -> None:
        # username (falling back to client id) → shared secret
        self.secrets = {
            k: v.encode() if isinstance(v, str) else bytes(v) for k, v in secrets.items()
        }
        self._pending: Dict[str, bytes] = {}

    def _secret_for(self, ci) -> Optional[bytes]:
        if ci.username and ci.username in self.secrets:
            return self.secrets[ci.username]
        return self.secrets.get(ci.id.client_id)

    # abandoned exchanges (challenge sent, socket dropped) never reach
    # continue_(), so the pending table is FIFO-capped — attacker-controlled
    # client ids must not grow broker memory unboundedly
    MAX_PENDING = 4096

    async def start(self, ci, method, data):
        if method != self.METHOD:
            return RC_BAD_AUTHENTICATION_METHOD, None
        nonce = os.urandom(16)
        while len(self._pending) >= self.MAX_PENDING:
            self._pending.pop(next(iter(self._pending)))
        self._pending[ci.id.client_id] = nonce
        return RC_CONTINUE_AUTHENTICATION, nonce

    async def continue_(self, ci, method, data):
        nonce = self._pending.pop(ci.id.client_id, None)
        secret = self._secret_for(ci)
        if nonce is None or secret is None or not data:
            return RC_NOT_AUTHORIZED, None
        expect = hmac.new(secret, nonce, hashlib.sha256).digest()
        if not hmac.compare_digest(expect, bytes(data)):
            return RC_NOT_AUTHORIZED, None
        return RC_AUTH_SUCCESS, None


def cram_response(secret: bytes, nonce: bytes) -> bytes:
    """Client-side answer for CRAM-SHA256 (used by tests/bridges)."""
    return hmac.new(secret, nonce, hashlib.sha256).digest()
