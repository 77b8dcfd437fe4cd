"""sr25519 (schnorrkel) signatures: Schnorr over ristretto255 + Merlin.

The reference supports sr25519 validator keys through ChainSafe/
go-schnorrkel (crypto/sr25519/privkey.go:25-43, pubkey.go:34-58 in
the reference). This is a from-scratch host implementation of the same
scheme on the repo's primitives (crypto/merlin.py transcripts over
keccak-f[1600], crypto/ristretto.py group, crypto/ed25519.py curve):

- key expansion `ExpandEd25519`: scalar = clamp(SHA-512(mini)[:32]) / 8,
  nonce = SHA-512(mini)[32:] (go-schnorrkel mini_secret.go semantics);
- signing context: Transcript("SigningContext") absorbing an empty ctx
  label and the message under "sign-bytes" (pubkey.go:51);
- sign/verify transcript: "proto-name"=Schnorr-sig, "sign:pk", "sign:R",
  challenge scalar at "sign:c" (64 PRF bytes mod L);
- signature wire form: R_ristretto(32) || s(32) with bit 255 of s set as
  the schnorrkel marker; s must be canonical (< L) on decode.

SURVEY.md §2.2 marks sr25519 as CPU-fallback-acceptable; there is no
device kernel. Sign-side nonces are deterministic (transcript witness
bound to the expanded nonce), which verifies identically but does not
reproduce go-schnorrkel's randomized signatures byte-for-byte.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import ristretto
from .ed25519 import BASEPOINT as _BASEPOINT
from .ed25519 import L, point_add, point_neg, scalar_mult
from .merlin import Transcript

KEY_TYPE = "sr25519"
PUB_KEY_SIZE = 32
SIGNATURE_SIZE = 64


def _signing_context(msg: bytes) -> Transcript:
    """schnorrkel.NewSigningContext([]byte{}, msg) (pubkey.go:51)."""
    t = Transcript(b"SigningContext")
    t.append_message(b"", b"")
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge_scalar(t: Transcript, label: bytes) -> int:
    return int.from_bytes(t.challenge_bytes(label, 64), "little") % L


def expand_ed25519(mini: bytes) -> tuple[int, bytes]:
    """Mini secret -> (scalar, nonce), go-schnorrkel ExpandEd25519."""
    h = hashlib.sha512(mini).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    scalar = int.from_bytes(bytes(key), "little") >> 3  # divide by cofactor
    return scalar, h[32:]


@dataclass(frozen=True)
class PubKey:
    data: bytes  # 32-byte ristretto255 encoding

    type_name = KEY_TYPE

    def address(self) -> bytes:
        from .tmhash import sum_truncated

        return sum_truncated(self.data)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE or len(self.data) != PUB_KEY_SIZE:
            return False
        if sig[63] & 0x80 == 0:
            return False  # not marked as a schnorrkel signature
        a = ristretto.decode(self.data)
        r_bytes = sig[:32]
        if a is None or ristretto.decode(r_bytes) is None:
            return False
        s_arr = bytearray(sig[32:])
        s_arr[31] &= 0x7F
        s = int.from_bytes(bytes(s_arr), "little")
        if s >= L:
            return False
        t = _signing_context(msg)
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", self.data)
        t.append_message(b"sign:R", r_bytes)
        k = _challenge_scalar(t, b"sign:c")
        # R == [s]B - [k]A  <=>  encode([s]B + [k](-A)) == R_bytes
        q = point_add(
            scalar_mult(s, _BASEPOINT), scalar_mult(k, point_neg(a))
        )
        return ristretto.encode(q) == r_bytes

    # interface parity with ed25519.PubKey
    verify_signature = verify


@dataclass(frozen=True)
class PrivKey:
    mini: bytes  # 32-byte mini secret (the reference's PrivKey bytes)

    type_name = KEY_TYPE

    @classmethod
    def generate(cls) -> "PrivKey":
        """Canonical 32-byte secret (< L): a uniform 512-bit value reduced
        mod L, encoded little-endian. Raw token_bytes would be >= L with
        ~94% probability and be rejected by reference-compatible software
        (go-schnorrkel NewMiniSecretKeyFromRaw canonical decode; the
        reference's genPrivKey emits ExpandEd25519().Encode(), also a
        canonical scalar — crypto/sr25519/privkey.go:83-97)."""
        import secrets

        k = int.from_bytes(secrets.token_bytes(64), "little") % L
        return cls(k.to_bytes(32, "little"))

    @classmethod
    def from_secret(cls, seed: bytes) -> "PrivKey":
        """Deterministic key from a seed (test factories)."""
        return cls(hashlib.sha256(b"sr25519:" + seed).digest())

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivKey":
        if len(data) != 32:
            raise ValueError("sr25519 mini secret must be 32 bytes")
        return cls(data)

    def bytes(self) -> bytes:
        return self.mini

    def public_key(self) -> PubKey:
        scalar, _ = expand_ed25519(self.mini)
        return PubKey(ristretto.encode(scalar_mult(scalar, _BASEPOINT)))

    def sign(self, msg: bytes) -> bytes:
        scalar, nonce = expand_ed25519(self.mini)
        pub = ristretto.encode(scalar_mult(scalar, _BASEPOINT))
        t = _signing_context(msg)
        t.append_message(b"proto-name", b"Schnorr-sig")
        t.append_message(b"sign:pk", pub)
        # deterministic witness: transcript state bound to the secret nonce
        wt = t.clone()
        wt.append_message(b"signing-nonce", nonce)
        r = int.from_bytes(wt.challenge_bytes(b"witness", 64), "little") % L
        r_point = scalar_mult(r, _BASEPOINT)
        r_bytes = ristretto.encode(r_point)
        t.append_message(b"sign:R", r_bytes)
        k = _challenge_scalar(t, b"sign:c")
        s = (k * scalar + r) % L
        s_arr = bytearray(s.to_bytes(32, "little"))
        s_arr[31] |= 0x80  # schnorrkel marker bit
        return r_bytes + bytes(s_arr)
