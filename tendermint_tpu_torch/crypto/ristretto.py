"""ristretto255 group encoding (RFC 9496) on the host curve (int math).

sr25519 public keys and signature R points are ristretto255 elements; the
reference reaches this through go-schnorrkel -> ristretto255 (crypto/
sr25519/pubkey.go:43-51 in the reference). Implemented from RFC 9496
§4.3 on top of the extended-coordinate point type in crypto/ed25519.py.

Validated against the RFC 9496 §A small-multiples-of-B vectors
(tests/test_sr25519.py).
"""

from __future__ import annotations

from .ed25519 import D, P, Point

SQRT_M1 = pow(2, (P - 1) // 4, P)
# 1 / sqrt(a - d) with a = -1 (constant from RFC 9496 §4.1)
_A_MINUS_D = (-1 - D) % P


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, r): r = sqrt(u/v) if square else sqrt(SQRT_M1*u/v);
    r is non-negative. RFC 9496 §4.2."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u = u % P
    correct = check == u
    flipped = check == (-u) % P
    flipped_i = check == (-u) % P * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return (correct or flipped, _abs(r))


_ok, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, _A_MINUS_D)
assert _ok


def decode(s_bytes: bytes) -> Point | None:
    """32-byte ristretto255 string -> extended point, or None if invalid."""
    if len(s_bytes) != 32:
        return None
    s = int.from_bytes(s_bytes, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p: Point) -> bytes:
    """Extended point -> canonical 32-byte ristretto255 string."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) % P * ((z0 - y0) % P) % P
    u2 = x0 * y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_negative(t0 * z_inv % P):
        x, y = y0 * SQRT_M1 % P, x0 * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (-y) % P
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return s.to_bytes(32, "little")


def equal(p: Point, q: Point) -> bool:
    """Ristretto group equality (RFC 9496 §4.5):
    x1*y2 == y1*x2 or y1*y2 == x1*x2 (Z-independent)."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return x1 * y2 % P == y1 * x2 % P or y1 * y2 % P == x1 * x2 % P
