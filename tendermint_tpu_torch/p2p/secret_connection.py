"""SecretConnection — authenticated encryption for every peer link.

Reference: p2p/conn/secret_connection.go:63-182 — Station-to-Station over
X25519 ECDH: exchange ephemeral pubkeys, HKDF-SHA256 the shared secret
into directional ChaCha20-Poly1305 keys + a challenge, then prove node
identity by signing the challenge with the node's ed25519 key (exchanged
encrypted). Frames: 1024-byte payload chunks (:455), 4-byte little-endian
length inside the sealed frame, 12-byte little-endian nonce counter per
direction.

Security argument (why the HKDF challenge binds like the reference's
Merlin-transcript STS, secret_connection.go:92-182):

  challenge = HKDF-SHA256(dh_secret || eph_lo || eph_hi)[64:96]

1. The challenge is a PRF output over BOTH ephemeral public keys and the
   DH secret. An in-path attacker running two separate DH exchanges (its
   own ephemeral with each honest side) induces different
   (dh_secret, eph pair) tuples on each leg, hence — HKDF being a PRF —
   different challenges ch_A != ch_B except with negligible probability.
2. Identity is proven by an ed25519 signature OVER the challenge. The
   attacker holds both legs' symmetric keys (it can decrypt and
   re-encrypt the auth messages), but to impersonate node B toward node
   A it must present a signature by B over ch_A; B only ever signs its
   own leg's ch_B. EUF-CMA of ed25519 closes the argument. Substituting
   EITHER ephemeral key changes the challenge, so there is no
   key-substitution path around the binding
   (tests/test_p2p.py::test_secretconn_mitm_eph_substitution_fails).
3. Differences from the reference are conservative: Merlin hashes the
   sorted ephemeral keys into a transcript BEFORE key derivation and
   signs the transcript hash; here the challenge additionally depends on
   the DH secret itself, a strict superset of bound material, with
   domain separation via HKDF_INFO.
4. Cross-protocol signing: the node key signs raw 32-byte challenges
   here and length-prefixed canonical protos for consensus
   (types/vote.py sign_bytes — never 32 raw bytes), so a challenge can
   never collide with a vote/proposal signing payload.

Async over asyncio streams; the AEAD itself is the native C++ library
(crypto/aead.py).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import struct
from typing import Optional

from ..crypto import aead, ed25519, x25519

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + aead.TAG_SIZE

HKDF_INFO = b"TENDERMINT_TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


def _hkdf_sha256(secret: bytes, info: bytes, length: int) -> bytes:
    prk = hmac.new(b"\x00" * 32, secret, hashlib.sha256).digest()
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


class _Nonce:
    """96-bit little-endian counter nonce (reference incrNonce :455)."""

    def __init__(self):
        self._n = 0

    def use(self) -> bytes:
        v = struct.pack("<Q", self._n) + b"\x00\x00\x00\x00"
        self._n += 1
        if self._n >= 1 << 64:
            raise OverflowError("nonce exhausted")
        return v


class SecretConnection:
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send_key: bytes,
        recv_key: bytes,
        remote_pubkey: ed25519.PubKey,
    ):
        self._reader = reader
        self._writer = writer
        self._send_key = send_key
        self._recv_key = recv_key
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()
        self._recv_buf = b""
        self.remote_pubkey = remote_pubkey

    # --- handshake --------------------------------------------------------

    @classmethod
    async def make(
        cls,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        local_priv: ed25519.PrivKey,
    ) -> "SecretConnection":
        """MakeSecretConnection (reference :92-182). Symmetric protocol —
        both sides run the same code."""
        eph_priv, eph_pub = x25519.generate_keypair()
        writer.write(eph_pub)
        await writer.drain()
        remote_eph = await reader.readexactly(32)

        shared = x25519.shared_secret(eph_priv, remote_eph)
        lo, hi = sorted([eph_pub, remote_eph])
        material = _hkdf_sha256(shared + lo + hi, HKDF_INFO, 96)
        key_a, key_b = material[:32], material[32:64]
        challenge = material[64:96]
        # the side with the smaller ephemeral key sends with key_a
        if eph_pub == lo:
            send_key, recv_key = key_a, key_b
        else:
            send_key, recv_key = key_b, key_a

        conn = cls(
            reader, writer, send_key, recv_key, remote_pubkey=None  # type: ignore
        )
        # exchange (pubkey, sig(challenge)) over the now-encrypted link
        sig = local_priv.sign(challenge)
        auth = local_priv.public_key().data + sig
        await conn.write(auth)
        remote_auth = await conn.read_exactly(32 + 64)
        remote_pub = ed25519.PubKey(remote_auth[:32])
        if not remote_pub.verify(challenge, remote_auth[32:]):
            raise ValueError("secret connection: challenge auth failed")
        conn.remote_pubkey = remote_pub
        return conn

    # --- framed io --------------------------------------------------------

    async def write(self, data: bytes) -> None:
        """Chunk into ≤1024-byte sealed frames."""
        while True:
            chunk = data[:DATA_MAX_SIZE]
            data = data[DATA_MAX_SIZE:]
            frame = struct.pack("<I", len(chunk)) + chunk
            frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
            sealed = aead.seal(self._send_key, self._send_nonce.use(), frame)
            self._writer.write(sealed)
            if not data:
                break
        await self._writer.drain()

    async def _read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
        frame = aead.open_(self._recv_key, self._recv_nonce.use(), sealed)
        (n,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
        if n > DATA_MAX_SIZE:
            raise ValueError("invalid frame length")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + n]

    async def read(self) -> bytes:
        """One frame's payload (possibly less than a full message)."""
        if self._recv_buf:
            buf, self._recv_buf = self._recv_buf, b""
            return buf
        return await self._read_frame()

    async def read_exactly(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = await self.read()
            out += chunk
        if len(out) > n:
            self._recv_buf = out[n:] + self._recv_buf
            out = out[:n]
        return out

    def close(self) -> None:
        self._writer.close()
