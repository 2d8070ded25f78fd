"""Minimal ECDSA (NIST P-256/384/521) for JWT ES* verification.

The reference's rmqtt-auth-jwt accepts ES-family tokens; this image has no
asymmetric-crypto library, so verification is implemented directly: affine
short-Weierstrass point arithmetic over the NIST primes with stdlib big
ints (``pow(x, -1, p)`` modular inverse). Verification-only in the broker;
``sign`` exists for the test suite (round-trip + tamper vectors) — it uses
RFC-6979-style deterministic nonces derived with HMAC so tests never need
an RNG. One verify is a handful of milliseconds in CPython — fine for the
once-per-CONNECT auth path, not a bulk-data primitive.

Curve constants are validated by tests/test_plugins2.py
(test_ec_curve_constants_and_roundtrip): G must satisfy the curve equation
and n·G must be the point at infinity; ES256 additionally verifies a token
signed independently by openssl.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import NamedTuple, Optional, Tuple


class Curve(NamedTuple):
    p: int  # field prime
    b: int  # y^2 = x^3 - 3x + b
    n: int  # group order
    gx: int
    gy: int
    size: int  # byte length of a coordinate / signature half


P256 = Curve(
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    size=32,
)

P384 = Curve(
    p=int(
        "fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffe"
        "ffffffff0000000000000000ffffffff", 16
    ),
    b=int(
        "b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
        "c656398d8a2ed19d2a85c8edd3ec2aef", 16
    ),
    n=int(
        "ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372ddf"
        "581a0db248b0a77aecec196accc52973", 16
    ),
    gx=int(
        "aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a38"
        "5502f25dbf55296c3a545e3872760ab7", 16
    ),
    gy=int(
        "3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c0"
        "0a60b1ce1d7e819d7a431d7c90ea0e5f", 16
    ),
    size=48,
)

P521 = Curve(
    p=(1 << 521) - 1,
    b=int(
        "0051953eb9618e1c9a1f929a21a0b68540eea2da725b99b315f3b8b489918ef1"
        "09e156193951ec7e937b1652c0bd3bb1bf073573df883d2c34f1ef451fd46b50"
        "3f00", 16
    ),
    n=int(
        "01ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
        "fffa51868783bf2f966b7fcc0148f709a5d03bb5c9b8899c47aebb6fb71e9138"
        "6409", 16
    ),
    gx=int(
        "00c6858e06b70404e9cd9e3ecb662395b4429c648139053fb521f828af606b4d"
        "3dbaa14b5e77efe75928fe1dc127a2ffa8de3348b3c1856a429bf97e7e31c2e5"
        "bd66", 16
    ),
    gy=int(
        "011839296a789a3bc0045c8a5fb42c7d1bd998f54449579b446817afbd17273e"
        "662c97ee72995ef42640c550b9013fad0761353c7086a272c24088be94769fd1"
        "6650", 16
    ),
    size=66,
)

CURVES = {"ES256": P256, "ES384": P384, "ES512": P521}
HASHES = {"ES256": hashlib.sha256, "ES384": hashlib.sha384, "ES512": hashlib.sha512}

# the point at infinity
_INF: Optional[Tuple[int, int]] = None


def on_curve(c: Curve, pt) -> bool:
    if pt is _INF:
        return True
    x, y = pt
    return (y * y - (x * x * x - 3 * x + c.b)) % c.p == 0


def _add(c: Curve, p1, p2):
    if p1 is _INF:
        return p2
    if p2 is _INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % c.p == 0:
            return _INF
        # doubling: s = (3x^2 - 3) / 2y
        s = (3 * x1 * x1 - 3) * pow(2 * y1, -1, c.p) % c.p
    else:
        s = (y2 - y1) * pow(x2 - x1, -1, c.p) % c.p
    x3 = (s * s - x1 - x2) % c.p
    return x3, (s * (x1 - x3) - y1) % c.p


def _mul(c: Curve, k: int, pt):
    acc = _INF
    while k:
        if k & 1:
            acc = _add(c, acc, pt)
        pt = _add(c, pt, pt)
        k >>= 1
    return acc


def _hash_to_int(c: Curve, h: bytes) -> int:
    e = int.from_bytes(h, "big")
    extra = len(h) * 8 - c.n.bit_length()
    return e >> extra if extra > 0 else e


def verify(alg: str, signed: bytes, sig: bytes, pub: Tuple[int, int]) -> bool:
    """JWT ES* verify: ``sig`` is the raw r||s concatenation."""
    c = CURVES.get(alg)
    if c is None or len(sig) != 2 * c.size:
        return False
    r = int.from_bytes(sig[: c.size], "big")
    s = int.from_bytes(sig[c.size :], "big")
    if not (0 < r < c.n and 0 < s < c.n) or not on_curve(c, pub):
        return False
    e = _hash_to_int(c, HASHES[alg](signed).digest())
    w = pow(s, -1, c.n)
    u1 = e * w % c.n
    u2 = r * w % c.n
    pt = _add(c, _mul(c, u1, (c.gx, c.gy)), _mul(c, u2, pub))
    if pt is _INF:
        return False
    return pt[0] % c.n == r


def sign(alg: str, signed: bytes, priv: int) -> bytes:
    """Deterministic-nonce ECDSA sign (tests only; HMAC-derived k)."""
    c = CURVES[alg]
    e = _hash_to_int(c, HASHES[alg](signed).digest())
    kseed = hmac.new(priv.to_bytes(c.size, "big"),
                     HASHES[alg](signed).digest(), hashlib.sha512).digest()
    k = int.from_bytes(kseed * ((2 * c.size) // len(kseed) + 1), "big") % c.n
    while True:
        k = k or 1
        x, _y = _mul(c, k, (c.gx, c.gy))
        r = x % c.n
        s = pow(k, -1, c.n) * (e + r * priv) % c.n
        if r and s:
            return r.to_bytes(c.size, "big") + s.to_bytes(c.size, "big")
        k = (k + 1) % c.n


def public_key(alg: str, priv: int) -> Tuple[int, int]:
    c = CURVES[alg]
    pt = _mul(c, priv, (c.gx, c.gy))
    assert pt is not _INF
    return pt
