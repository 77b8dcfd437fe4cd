"""Pure-Python ed25519 (RFC 8032) — the host reference implementation.

Role in the framework (cf. SURVEY.md §2.2): the reference repo leans on
``golang.org/x/crypto/ed25519`` (crypto/ed25519/ed25519.go:148-162 in
/root/reference) for both signing and per-vote serial verification. Here the
host implementation covers key generation and signing (cold path: one
signature per validator per consensus step) and serves as the oracle for
differential tests of the batched TPU verifier (``tendermint_tpu_torch.ops``).

Semantics match Go x/crypto ed25519 `Verify`:
- reject signatures with non-canonical / out-of-range s (s >= L),
- reject public keys that fail point decompression (including non-canonical
  y >= p encodings),
- check [s]B == R + [k]A with k = SHA-512(R || A || M) mod L, by comparing
  the canonical encoding of [s]B + [k](-A) against the R bytes.

Everything here is arbitrary-precision Python ints; no external deps.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass

# --- field and group parameters -------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

PUBKEY_SIZE = 32
PRIVKEY_SEED_SIZE = 32
SIGNATURE_SIZE = 64


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


# Base point: y = 4/5, x recovered with even sign.
def _recover_x(y: int, sign: int) -> int | None:
    """Recover x from y and the sign bit; None if y is not on the curve."""
    if y >= P:
        return None
    x2 = (y * y - 1) * _inv(D * y * y + 1) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


BY = 4 * _inv(5) % P
BX = _recover_x(BY, 0)
assert BX is not None


# --- point arithmetic (extended homogeneous coordinates) ------------------


Point = tuple[int, int, int, int]  # (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z

IDENTITY: Point = (0, 1, 1, 0)
BASEPOINT: Point = (BX, BY, 1, BX * BY % P)


def point_add(p: Point, q: Point) -> Point:
    # add-2008-hwcd-3 (complete for a=-1, d non-square)
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * D * T1 * T2 % P
    Dd = 2 * Z1 * Z2 % P
    E, F, G, H = B - A, Dd - C, Dd + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p: Point) -> Point:
    return point_add(p, p)


def point_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def scalar_mult(s: int, p: Point) -> Point:
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_double(p)
        s >>= 1
    return q


# --- fast scalar multiplication (PERF_ANALYSIS §22) -----------------------
#
# The generic double-and-add `scalar_mult` above stays as the oracle for
# the device kernels (ops/curve25519) and sr25519; the hot consensus
# paths — one sign per validator per step, three verifies per vote in a
# 4-node net — go through windowed variants. A fixed-base comb table
# (64 nibble windows x 15 multiples of B) turns [s]B into <=63 adds with
# zero doublings; variable-base [k]A uses a 4-bit MSB-first window
# (256 doublings + <=64 adds + 14 table adds ~ half the generic cost).

_BASE_COMB: list[list[Point]] | None = None


def _base_comb() -> list[list[Point]]:
    global _BASE_COMB
    if _BASE_COMB is None:
        comb = []
        g = BASEPOINT
        for _ in range(64):
            row = [IDENTITY, g]
            for _ in range(14):
                row.append(point_add(row[-1], g))
            comb.append(row)
            g = point_add(row[-1], g)  # 16 * window base
        _BASE_COMB = comb
    return _BASE_COMB


def scalar_mult_base(s: int) -> Point:
    """[s]B via the fixed-base comb (s reduced mod L by all callers)."""
    comb = _base_comb()
    q = IDENTITY
    i = 0
    while s > 0:
        nib = s & 0xF
        if nib:
            q = point_add(q, comb[i][nib])
        s >>= 4
        i += 1
    return q


def _window_mult(k: int, p: Point) -> Point:
    """[k]P for variable P, 4-bit fixed window, MSB first."""
    if k == 0:
        return IDENTITY
    tbl = [IDENTITY, p]
    for _ in range(14):
        tbl.append(point_add(tbl[-1], p))
    nibbles = []
    while k > 0:
        nibbles.append(k & 0xF)
        k >>= 4
    q = tbl[nibbles[-1]]
    for nib in reversed(nibbles[:-1]):
        q = point_add(q, q)
        q = point_add(q, q)
        q = point_add(q, q)
        q = point_add(q, q)
        if nib:
            q = point_add(q, tbl[nib])
    return q


def point_equal(p: Point, q: Point) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def point_compress(p: Point) -> bytes:
    X, Y, Z, _ = p
    zinv = _inv(Z)
    x = X * zinv % P
    y = Y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes) -> Point | None:
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


# --- keys / sign / verify --------------------------------------------------


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


@functools.lru_cache(maxsize=128)
def _expand_seed(seed: bytes) -> tuple[int, bytes, bytes]:
    """(clamped scalar, prefix, compressed pubkey) for a seed. A validator
    signs with one key thousands of times per run; the SHA-512 expansion
    and the [a]B pubkey derivation are loop-invariant."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return a, h[32:], point_compress(scalar_mult_base(a))


@functools.lru_cache(maxsize=1024)
def _decompress_cached(pubkey: bytes) -> Point | None:
    """Committee pubkeys recur on every vote; decompression costs a
    field sqrt (one ~256-bit modpow). Points are immutable tuples, safe
    to share across verifies."""
    return point_decompress(pubkey)


@dataclass(frozen=True)
class PrivKey:
    """Expanded ed25519 private key (32-byte seed).

    Mirrors the reference `crypto.PrivKey` surface (crypto/crypto.go:30-36):
    sign, derive public key.
    """

    seed: bytes

    type_name = "ed25519"

    def __post_init__(self):
        if len(self.seed) != PRIVKEY_SEED_SIZE:
            raise ValueError("ed25519 seed must be 32 bytes")

    @classmethod
    def generate(cls, rng=os.urandom) -> "PrivKey":
        return cls(rng(PRIVKEY_SEED_SIZE))

    @classmethod
    def from_secret(cls, secret: bytes) -> "PrivKey":
        """Deterministic key from arbitrary secret (test helper, mirrors
        GenPrivKeyFromSecret in the reference crypto/ed25519/ed25519.go)."""
        return cls(hashlib.sha256(secret).digest())

    def public_key(self) -> "PubKey":
        return PubKey(_expand_seed(self.seed)[2])

    def sign(self, msg: bytes) -> bytes:
        a, prefix, A = _expand_seed(self.seed)
        r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
        R = point_compress(scalar_mult_base(r))
        k = int.from_bytes(hashlib.sha512(R + A + msg).digest(), "little") % L
        s = (r + k * a) % L
        return R + int.to_bytes(s, 32, "little")


@dataclass(frozen=True)
class PubKey:
    data: bytes

    type_name = "ed25519"

    def __post_init__(self):
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("ed25519 pubkey must be 32 bytes")

    def address(self) -> bytes:
        """First 20 bytes of SHA-256, as the reference (crypto/crypto.go:18)."""
        return hashlib.sha256(self.data).digest()[:20]

    def verify(self, msg: bytes, sig: bytes) -> bool:
        return verify(self.data, msg, sig)


def challenge(r_bytes: bytes, pubkey: bytes, msg: bytes) -> int:
    """k = SHA-512(R || A || M) mod L — the verification challenge scalar.
    Shared by the host oracle and the TPU batch pipeline (which hashes on
    host until the device SHA-512 kernel takes over)."""
    return (
        int.from_bytes(hashlib.sha512(r_bytes + pubkey + msg).digest(), "little")
        % L
    )


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Single-signature verification; the oracle for the TPU batch kernel."""
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    A = _decompress_cached(pubkey)
    if A is None:
        return False
    Rs, ss = sig[:32], sig[32:]
    s = int.from_bytes(ss, "little")
    if s >= L:  # malleability check, per RFC 8032 §5.1.7 / Go x/crypto
        return False
    k = challenge(Rs, pubkey, msg)
    # [s]B + [k](-A) must encode to exactly the R bytes.
    Q = point_add(scalar_mult_base(s), _window_mult(k, point_neg(A)))
    return point_compress(Q) == Rs
