"""Pure-Python Ed25519 (RFC 8032) — verify-first fallback for signed policy
bundles.

The safety kernel's signed-policy path normally verifies with the
``cryptography`` backend; on hosts without it (minimal TPU worker images),
verification must still be possible — otherwise "library missing" silently
degrades into deny-all forever even when a valid signed policy is present.
This module is stdlib-only (``hashlib`` + big ints) and fast enough for the
kernel's cold reload path (~1 ms/verify on CPython 3.10).

Signing support exists for tests and tooling; production signing should use
the ``cryptography`` backend or an external signer.
"""
from __future__ import annotations

import hashlib
import os

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = -121665 * pow(121666, _P - 2, _P) % _P
_I = pow(2, (_P - 1) // 4, _P)

Point = tuple[int, int, int, int]  # extended homogeneous (X, Y, Z, T)


def _inv(x: int) -> int:
    return pow(x, _P - 2, _P)


def _xrecover(y: int) -> int:
    xx = (y * y - 1) * _inv(_D * y * y + 1) % _P
    x = pow(xx, (_P + 3) // 8, _P)
    if (x * x - xx) % _P != 0:
        x = x * _I % _P
    if (x * x - xx) % _P != 0:
        raise ValueError("point not on curve")
    if x % 2 != 0:
        x = _P - x
    return x


_BY = 4 * _inv(5) % _P
_BX = _xrecover(_BY)
_BASE: Point = (_BX, _BY, 1, _BX * _BY % _P)
_ZERO: Point = (0, 1, 1, 0)


def _add(p: Point, q: Point) -> Point:
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = t1 * 2 * _D % _P * t2 % _P
    d = z1 * 2 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _scalarmult(p: Point, e: int) -> Point:
    q = _ZERO
    while e:
        if e & 1:
            q = _add(q, p)
        p = _add(p, p)
        e >>= 1
    return q


def _compress(p: Point) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x, y = x * zi % _P, y * zi % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _on_curve(p: Point) -> bool:
    x, y, z, t = p
    return (
        z % _P != 0
        and x * y % _P == z * t % _P
        and (y * y - x * x - z * z - _D * t * t) % _P == 0
    )


def _decompress(s: bytes) -> Point:
    if len(s) != 32:
        raise ValueError("point must be 32 bytes")
    n = int.from_bytes(s, "little")
    y = n & ((1 << 255) - 1)
    if y >= _P:
        raise ValueError("y coordinate out of range")
    x = _xrecover(y)
    if x & 1 != n >> 255:
        x = _P - x
    pt: Point = (x, y, 1, x * y % _P)
    if not _on_curve(pt):
        raise ValueError("point not on curve")
    return pt


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def _hint(*chunks: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(chunks)).digest(), "little")


def public_key(seed: bytes) -> bytes:
    """Derive the 32-byte public key from a 32-byte seed."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    return _compress(_scalarmult(_BASE, _clamp(h[:32])))


def sign(seed: bytes, message: bytes) -> bytes:
    """Detached 64-byte Ed25519 signature of ``message`` under ``seed``."""
    h = hashlib.sha512(seed).digest()
    a, prefix = _clamp(h[:32]), h[32:]
    pub = _compress(_scalarmult(_BASE, a))
    r = _hint(prefix, message) % _L
    r_enc = _compress(_scalarmult(_BASE, r))
    k = _hint(r_enc, pub, message) % _L
    s = (r + k * a) % _L
    return r_enc + s.to_bytes(32, "little")


def verify(public_key_bytes: bytes, signature: bytes, message: bytes) -> bool:
    """True iff ``signature`` is a valid Ed25519 signature of ``message``.

    Malformed keys/signatures return False (never raise): callers treat any
    verification problem as fail-closed.
    """
    try:
        if len(signature) != 64:
            return False
        a_pt = _decompress(public_key_bytes)
        r_pt = _decompress(signature[:32])
        s = int.from_bytes(signature[32:], "little")
        if s >= _L:
            return False
        k = _hint(signature[:32], _compress(a_pt), message) % _L
        lhs = _scalarmult(_BASE, s)
        rhs = _add(r_pt, _scalarmult(a_pt, k))
        return _compress(lhs) == _compress(rhs)
    except ValueError:
        return False


class SigningKey:
    """Minimal stand-in for ``cryptography``'s Ed25519PrivateKey (tests/tools)."""

    def __init__(self, seed: bytes | None = None):
        self._seed = seed if seed is not None else os.urandom(32)
        if len(self._seed) != 32:
            raise ValueError("seed must be 32 bytes")

    def sign(self, message: bytes) -> bytes:
        return sign(self._seed, message)

    def public_key_bytes(self) -> bytes:
        return public_key(self._seed)
