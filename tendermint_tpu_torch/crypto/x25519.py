"""X25519 Diffie-Hellman (RFC 7748) — SecretConnection handshake.

Pure Python (bigint montgomery ladder): the handshake happens once per
peer connection, so this is nowhere near a hot path (the per-packet AEAD
is the native part — crypto/aead.py).
"""

from __future__ import annotations

import os

P = 2**255 - 19
A24 = 121665


def _decode_scalar(k: bytes) -> int:
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def _decode_u(u: bytes) -> int:
    a = bytearray(u)
    a[31] &= 127
    return int.from_bytes(a, "little") % P


def scalar_mult(k: bytes, u: bytes) -> bytes:
    """RFC 7748 X25519 function."""
    kn = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (kn >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * z3 * z3 % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


BASEPOINT = (9).to_bytes(32, "little")


def generate_keypair(rng=os.urandom) -> tuple[bytes, bytes]:
    """(private, public)."""
    priv = rng(32)
    return priv, scalar_mult(priv, BASEPOINT)


def shared_secret(priv: bytes, peer_pub: bytes) -> bytes:
    secret = scalar_mult(priv, peer_pub)
    if secret == bytes(32):
        raise ValueError("x25519: low-order point")
    return secret
