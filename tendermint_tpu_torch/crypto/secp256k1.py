"""secp256k1 ECDSA: Tendermint validator keys + eth-style sequencer signing.

Host reference implementation (the batched TPU verify kernel partitions
mixed-key commits and routes secp256k1 rows here until the device kernel
lands — SURVEY.md §2.2 row "secp256k1 ECDSA").

Mirrors the reference semantics exactly:
- crypto/secp256k1/secp256k1.go:126-143 (Sign): deterministic RFC 6979
  ECDSA over SHA-256(msg), serialized as 64-byte R||S with low-S.
- crypto/secp256k1/secp256k1.go:190-215 (VerifySignature): R||S form,
  rejects high-S (malleable) signatures, verifies over SHA-256(msg).
- crypto/secp256k1/secp256k1.go:155-167 (Address): RIPEMD160(SHA256(pub)),
  33-byte compressed pubkey.
- types/block_v2.go:80-93 (RecoverBlockV2Signer): eth-style 65-byte
  recoverable signature [R || S || v] over a 32-byte digest (no prehash),
  signer address = keccak256(uncompressed_pub[1:])[12:].
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from .keccak import keccak256

# Curve parameters (SEC 2).
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
A = 0
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_HALF_N = N // 2

# Jacobian point: (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z == 0 => infinity.
_JINF = (0, 1, 0)


def _inv(x: int, m: int) -> int:
    return pow(x, m - 2, m)


def _jdouble(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return _JINF
    S = (4 * X * Y * Y) % P
    M = (3 * X * X) % P  # a = 0
    X3 = (M * M - 2 * S) % P
    Y3 = (M * (S - X3) - 8 * Y * Y * Y * Y) % P
    Z3 = (2 * Y * Z) % P
    return (X3, Y3, Z3)


def _jadd(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return _JINF
        return _jdouble(p)
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - S1 * HHH) % P
    Z3 = Z1 * Z2 * H % P
    return (X3, Y3, Z3)


def _jmul(k: int, p) -> tuple:
    k %= N
    acc = _JINF
    add = p
    while k:
        if k & 1:
            acc = _jadd(acc, add)
        add = _jdouble(add)
        k >>= 1
    return acc


def _to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = _inv(Z, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


_JG = (GX, GY, 1)


def _double_mul(u1: int, u2: int, q) -> tuple | None:
    """u1*G + u2*Q (Shamir's trick), affine result or None (infinity)."""
    acc = _JINF
    jq = q
    gq = _jadd(_JG, jq)
    bits = max(u1.bit_length(), u2.bit_length())
    for i in range(bits - 1, -1, -1):
        acc = _jdouble(acc)
        b1 = (u1 >> i) & 1
        b2 = (u2 >> i) & 1
        if b1 and b2:
            acc = _jadd(acc, gq)
        elif b1:
            acc = _jadd(acc, _JG)
        elif b2:
            acc = _jadd(acc, jq)
    return _to_affine(acc)


def _lift_x(x: int, odd: int) -> tuple | None:
    """Affine point with given x and y parity, or None."""
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if y & 1 != odd:
        y = P - y
    return (x, y)


# --- encoding -------------------------------------------------------------


def compress_point(pt: tuple) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def decompress_point(data: bytes) -> tuple | None:
    if len(data) == 33 and data[0] in (2, 3):
        return _lift_x(int.from_bytes(data[1:], "big"), data[0] & 1)
    if len(data) == 65 and data[0] == 4:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        if x >= P or y >= P or (y * y - pow(x, 3, P) - B) % P != 0:
            return None
        return (x, y)
    return None


def uncompressed(pt: tuple) -> bytes:
    x, y = pt
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


# --- RFC 6979 deterministic nonce ----------------------------------------


def _rfc6979_k(digest: bytes, secret: int) -> int:
    """Deterministic nonce per RFC 6979 §3.2 (HMAC-SHA256)."""
    h1 = digest
    x = secret.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        t = int.from_bytes(v, "big")
        if 1 <= t < N:
            return t
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# --- core ECDSA over a 32-byte digest -------------------------------------


def sign_digest(digest: bytes, secret: int, recoverable: bool = False) -> bytes:
    """ECDSA sign a 32-byte digest; low-S; RFC 6979 nonce.

    Returns R||S (64 bytes), or R||S||v (65 bytes, v in {0,1}) when
    `recoverable` (go-ethereum crypto.Sign convention used by the sequencer,
    types/block_v2.go:85).
    """
    z = int.from_bytes(digest, "big") % N
    while True:
        k = _rfc6979_k(digest, secret)
        pt = _to_affine(_jmul(k, _JG))
        if pt is None:
            continue
        r = pt[0] % N
        if r == 0:
            continue
        s = _inv(k, N) * (z + r * secret) % N
        if s == 0:
            continue
        # standard recid: bit 0 = parity of the nonce point's y, bit 1 =
        # x overflowed the group order (recover lifts x = r + N*(v>>1))
        rec_id = (pt[1] & 1) | (2 if pt[0] >= N else 0)
        if s > _HALF_N:
            s = N - s
            rec_id ^= 1  # negating s flips only the y parity
        out = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        if recoverable:
            out += bytes([rec_id])
        return out


def verify_digest(digest: bytes, sig64: bytes, pub_point: tuple) -> bool:
    """Verify R||S over a digest; rejects high-S (reference's malleability
    check, crypto/secp256k1/secp256k1.go:199-210)."""
    if len(sig64) != 64:
        return False
    r = int.from_bytes(sig64[:32], "big")
    s = int.from_bytes(sig64[32:], "big")
    if not (1 <= r < N and 1 <= s <= _HALF_N):
        return False
    z = int.from_bytes(digest, "big") % N
    si = _inv(s, N)
    u1 = z * si % N
    u2 = r * si % N
    pt = _double_mul(u1, u2, (pub_point[0], pub_point[1], 1))
    return pt is not None and pt[0] % N == r


def recover_digest(digest: bytes, sig65: bytes) -> tuple | None:
    """Recover the public key point from a 65-byte [R||S||v] signature
    (go-ethereum crypto.SigToPub semantics; types/block_v2.go:86)."""
    if len(sig65) != 65:
        return None
    r = int.from_bytes(sig65[:32], "big")
    s = int.from_bytes(sig65[32:64], "big")
    v = sig65[64]
    if not (1 <= r < N and 1 <= s < N) or v > 3:
        return None
    x = r + N * (v >> 1)
    rp = _lift_x(x, v & 1)
    if rp is None:
        return None
    z = int.from_bytes(digest, "big") % N
    ri = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    u1 = (-z * ri) % N
    u2 = s * ri % N
    return _double_mul(u1, u2, (rp[0], rp[1], 1))


# --- Tendermint key objects (crypto/secp256k1/secp256k1.go) ---------------

KEY_TYPE = "secp256k1"
PUB_KEY_SIZE = 33


def _address(pub33: bytes) -> bytes:
    sha = hashlib.sha256(pub33).digest()
    return hashlib.new("ripemd160", sha).digest()


@dataclass(frozen=True)
class PubKey:
    data: bytes  # 33-byte compressed

    type_name = KEY_TYPE

    def address(self) -> bytes:
        return _address(self.data)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        pt = decompress_point(self.data)
        if pt is None:
            return False
        return verify_digest(hashlib.sha256(msg).digest(), sig, pt)

    # interface parity with ed25519.PubKey
    verify_signature = verify


@dataclass(frozen=True)
class PrivKey:
    secret: int

    type_name = KEY_TYPE

    @classmethod
    def generate(cls, rng=None) -> "PrivKey":
        import secrets

        while True:
            d = secrets.randbelow(N)
            if d > 0:
                return cls(d)

    @classmethod
    def from_secret(cls, seed: bytes) -> "PrivKey":
        """Deterministic key from a seed (test factories)."""
        d = int.from_bytes(hashlib.sha256(seed).digest(), "big") % N
        return cls(d or 1)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivKey":
        d = int.from_bytes(data, "big")
        if not (0 < d < N):
            raise ValueError("invalid secp256k1 scalar")
        return cls(d)

    def bytes(self) -> bytes:
        return self.secret.to_bytes(32, "big")

    def public_key(self) -> PubKey:
        pt = _to_affine(_jmul(self.secret, _JG))
        return PubKey(compress_point(pt))

    def sign(self, msg: bytes) -> bytes:
        """64-byte R||S over SHA-256(msg) — validator-key signing."""
        return sign_digest(hashlib.sha256(msg).digest(), self.secret)


# --- eth-style helpers (sequencer; types/block_v2.go) ---------------------


def eth_address(pub_point: tuple) -> bytes:
    """keccak256(uncompressed[1:])[12:] — go-ethereum PubkeyToAddress."""
    return keccak256(uncompressed(pub_point)[1:])[12:]


def eth_sign(digest: bytes, secret: int) -> bytes:
    """65-byte recoverable signature over a 32-byte digest."""
    return sign_digest(digest, secret, recoverable=True)


def eth_recover_address(digest: bytes, sig65: bytes) -> bytes | None:
    pt = recover_digest(digest, sig65)
    return None if pt is None else eth_address(pt)
