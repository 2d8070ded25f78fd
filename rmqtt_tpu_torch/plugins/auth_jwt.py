"""JWT authentication plugin.

Mirrors `rmqtt-plugins/rmqtt-auth-jwt`: the client's password carries a JWT.
HS256/384/512 verify with the configured shared secret (stdlib hmac);
RS256/384/512 verify with a configured RSA public key — signature
VERIFICATION is one modular exponentiation (``pow(sig, e, n)``) plus
PKCS#1 v1.5 / DigestInfo checking, all stdlib (the public key is given as
a JWK dict ``{n, e}`` or a PEM SubjectPublicKeyInfo, parsed with a minimal
DER reader). ES256/384/512 verify via ``rmqtt_tpu_torch.utils.ec`` (pure-Python
NIST-curve ECDSA; key = JWK ``{x, y}`` or an EC SubjectPublicKeyInfo PEM).
Claims honored: ``exp`` (reject expired), optional ``%c``/``%u`` matching
claims, ``superuser``, and ``acl`` pub/sub filter lists enforced on the
ACL hooks.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Dict, Optional

from rmqtt_tpu_torch.broker.hooks import HookResult, HookType
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin

_ALGS = {"HS256": hashlib.sha256, "HS384": hashlib.sha384, "HS512": hashlib.sha512}


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


_RS_ALGS = {"RS256": hashlib.sha256, "RS384": hashlib.sha384, "RS512": hashlib.sha512}

# DigestInfo DER prefixes for EMSA-PKCS1-v1_5 (RFC 8017 §9.2 notes)
_DIGEST_INFO = {
    "RS256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "RS384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "RS512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


def _der_read(buf: bytes, pos: int):
    """→ (tag, content, next_pos) for one DER TLV."""
    tag = buf[pos]
    length = buf[pos + 1]
    pos += 2
    if length & 0x80:
        nbytes = length & 0x7F
        length = int.from_bytes(buf[pos : pos + nbytes], "big")
        pos += nbytes
    return tag, buf[pos : pos + length], pos + length


def _spki_bitstring(pem: str) -> bytes:
    """SubjectPublicKeyInfo PEM → BIT STRING content (unused-bits stripped).
    Shared prefix walk for the RSA and EC key parsers."""
    body = "".join(
        line for line in pem.strip().splitlines() if not line.startswith("-----")
    )
    der = base64.b64decode(body)
    _, spki, _ = _der_read(der, 0)  # SEQUENCE SubjectPublicKeyInfo
    _, _alg, after_alg = _der_read(spki, 0)  # SEQUENCE AlgorithmIdentifier
    tag, bitstr, _ = _der_read(spki, after_alg)  # BIT STRING
    if tag != 0x03 or not bitstr:
        raise ValueError("not a SubjectPublicKeyInfo key")
    return bitstr[1:]  # skip unused-bits byte


def rsa_public_key_from_pem(pem: str):
    """SubjectPublicKeyInfo PEM → (n, e). Minimal DER walk, stdlib only."""
    content = _spki_bitstring(pem)
    if not content or content[0] != 0x30:
        # RSA keys carry a DER SEQUENCE here; anything else (e.g. an EC
        # point, incl. compressed 0x02/0x03 forms) must fail loudly, not
        # be walked as garbage TLVs
        raise ValueError("not an RSA SubjectPublicKeyInfo key")
    _, rsa_seq, _ = _der_read(content, 0)  # SEQUENCE
    _, n_bytes, after_n = _der_read(rsa_seq, 0)  # INTEGER n
    _, e_bytes, _ = _der_read(rsa_seq, after_n)  # INTEGER e
    return int.from_bytes(n_bytes, "big"), int.from_bytes(e_bytes, "big")


def verify_rs_signature(alg: str, signed: bytes, sig: bytes, n: int, e: int) -> bool:
    """RSASSA-PKCS1-v1_5 verification: pow + exact EM comparison."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    em = pow(int.from_bytes(sig, "big"), e, n).to_bytes(k, "big")
    digest = _RS_ALGS[alg](signed).digest()
    t = _DIGEST_INFO[alg] + digest
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, expected)


def ec_public_key_from_pem(pem: str):
    """EC SubjectPublicKeyInfo PEM → (x, y) of the uncompressed point.
    Compressed points (0x02/0x03 marker) are rejected with a clear error —
    re-export with ``openssl ec -pubout`` (uncompressed is its default)."""
    content = _spki_bitstring(pem)
    if not content or content[0] in (0x02, 0x03):
        raise ValueError(
            "compressed EC public key unsupported; re-export uncompressed"
        )
    if content[0] != 0x04:
        raise ValueError("not an uncompressed EC SubjectPublicKeyInfo key")
    point = content[1:]
    half = len(point) // 2
    return int.from_bytes(point[:half], "big"), int.from_bytes(point[half:], "big")


def verify_hs_jwt(token: str, secret: bytes, rsa_key=None, ec_key=None) -> Optional[dict]:
    """→ claims dict, or None if invalid/expired. ``rsa_key`` is (n, e) for
    the RS* algorithms, ``ec_key`` is the (x, y) public point for ES*;
    HS* verify against ``secret``."""
    from rmqtt_tpu_torch.utils import ec

    try:
        head_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(head_b64))
        alg = header.get("alg", "")
        signed = f"{head_b64}.{payload_b64}".encode()
        if alg in _ALGS:
            if not secret:
                # RS-only deployments must not accept HS tokens signed with
                # the empty default secret (algorithm-downgrade bypass)
                return None
            expect = hmac.new(secret, signed, _ALGS[alg]).digest()
            if not hmac.compare_digest(expect, _b64url_decode(sig_b64)):
                return None
        elif alg in _RS_ALGS and rsa_key is not None:
            if not verify_rs_signature(alg, signed, _b64url_decode(sig_b64), *rsa_key):
                return None
        elif alg in ec.CURVES and ec_key is not None:
            if not ec.verify(alg, signed, _b64url_decode(sig_b64), ec_key):
                return None
        else:
            return None
        claims = json.loads(_b64url_decode(payload_b64))
    except (ValueError, KeyError, IndexError):
        return None
    exp = claims.get("exp")
    if exp is not None and float(exp) <= time.time():
        return None
    return claims


class AuthJwtPlugin(Plugin):
    name = "rmqtt-auth-jwt"
    descr = "JWT (HMAC) authentication + claim-based ACL"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        secret = self.config.get("secret", "")
        self.secret = secret.encode() if isinstance(secret, str) else bytes(secret)
        self.from_field = self.config.get("from", "password")  # password | username
        # RS*: public key as JWK {n, e}; ES*: JWK {x, y}; either as PEM
        self.rsa_key = None
        self.ec_key = None
        jwk = self.config.get("jwk")
        if jwk and "n" in jwk:
            self.rsa_key = (
                int.from_bytes(_b64url_decode(jwk["n"]), "big"),
                int.from_bytes(_b64url_decode(jwk["e"]), "big"),
            )
        elif jwk and "x" in jwk:
            self.ec_key = (
                int.from_bytes(_b64url_decode(jwk["x"]), "big"),
                int.from_bytes(_b64url_decode(jwk["y"]), "big"),
            )
        elif self.config.get("public_key_pem"):
            pem = self.config["public_key_pem"]
            # RSA keys carry a DER SEQUENCE (0x30) in the SPKI BIT STRING;
            # EC keys carry a raw point — dispatch on that, so a compressed
            # EC key surfaces ec_public_key_from_pem's clear error instead
            # of an RSA misparse
            if _spki_bitstring(pem)[:1] == b"\x30":
                self.rsa_key = rsa_public_key_from_pem(pem)
            else:
                self.ec_key = ec_public_key_from_pem(pem)
        self._claims: Dict[str, dict] = {}
        self._unhooks = []

    async def init(self) -> None:
        hooks = self.ctx.hooks

        async def authenticate(_ht, args, prev):
            ci = args[0]
            token = (
                (ci.password or b"").decode("utf-8", "replace")
                if self.from_field == "password"
                else (ci.username or "")
            )
            if not token:
                return None  # not a JWT client; fall through
            claims = verify_hs_jwt(token, self.secret, rsa_key=self.rsa_key,
                                   ec_key=self.ec_key)
            if claims is None:
                return HookResult(proceed=False, value=False)
            # optional identity-claim checks (reference %c/%u placeholders)
            if "clientid" in claims and claims["clientid"] != ci.id.client_id:
                return HookResult(proceed=False, value=False)
            if "username" in claims and claims["username"] != (ci.username or ""):
                return HookResult(proceed=False, value=False)
            self._claims[ci.id.client_id] = claims
            return HookResult(proceed=False, value=True)

        async def pub_acl(_ht, args, prev):
            claims = self._claims.get(args[0].client_id)
            if claims is None:
                return None
            if claims.get("superuser"):
                return HookResult(proceed=False, value=True)
            acl = claims.get("acl")
            if not acl:
                return None
            allowed = acl.get("pub", [])
            ok = any(match_filter(f, args[1].topic) for f in allowed)
            return HookResult(proceed=False, value=ok)

        async def sub_acl(_ht, args, prev):
            claims = self._claims.get(args[0].client_id)
            if claims is None:
                return None
            if claims.get("superuser"):
                return HookResult(proceed=False, value=True)
            acl = claims.get("acl")
            if not acl:
                return None
            allowed = acl.get("sub", [])
            ok = args[1] in allowed or any(match_filter(f, args[1]) for f in allowed)
            return HookResult(proceed=False, value=ok)

        async def terminated(_ht, args, _prev):
            self._claims.pop(args[0].client_id, None)
            return None

        self._unhooks = [
            hooks.register(HookType.CLIENT_AUTHENTICATE, authenticate, priority=60),
            hooks.register(HookType.MESSAGE_PUBLISH_CHECK_ACL, pub_acl, priority=60),
            hooks.register(HookType.CLIENT_SUBSCRIBE_CHECK_ACL, sub_acl, priority=60),
            hooks.register(HookType.SESSION_TERMINATED, terminated),
        ]

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True
