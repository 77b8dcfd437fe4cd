"""XChaCha20-Poly1305 + armored key-at-rest encryption.

Reference: crypto/xchacha20poly1305/xchachapoly.go (24-byte-nonce AEAD via
HChaCha20 subkey derivation, draft-irtf-cfrg-xchacha) and the armored
encrypted-key format the Cosmos keyring layers on top of it. The AEAD
composes with the existing ChaCha20-Poly1305 (crypto/aead.py — native C++
fast path with Python fallback):

    subkey = HChaCha20(key, nonce[:16])
    seal   = chacha20poly1305(subkey, b"\\x00"*4 + nonce[16:24], ...)

Key-at-rest: `encrypt_key` derives the AEAD key from a passphrase with
scrypt (stdlib; documented divergence — the reference chain uses bcrypt,
which this image does not ship; parameters follow the scrypt RFC 7914
interactive profile) and wraps the ciphertext in ASCII armor with the kdf
recorded in the header, so the format is self-describing.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct

from . import aead

NONCE_SIZE = 24
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """32 pseudo-random bytes from a 256-bit key + 128-bit nonce
    (xchachapoly.go:130-169)."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20 needs 32-byte key, 16-byte nonce")
    x = list(_SIGMA)
    x += list(struct.unpack("<8I", key))
    x += list(struct.unpack("<4I", nonce16))

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF
        x[d] = aead._rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF
        x[b] = aead._rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF
        x[d] = aead._rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF
        x[b] = aead._rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    out = x[0:4] + x[12:16]
    return struct.pack("<8I", *out)


def _subparts(key: bytes, nonce: bytes) -> tuple[bytes, bytes]:
    if len(nonce) != NONCE_SIZE:
        raise ValueError("xchacha nonce must be 24 bytes")
    subkey = hchacha20(key, nonce[:16])
    subnonce = b"\x00" * 4 + nonce[16:24]
    return subkey, subnonce


def seal(key: bytes, nonce: bytes, plaintext: bytes, ad: bytes = b"") -> bytes:
    subkey, subnonce = _subparts(key, nonce)
    return aead.seal(subkey, subnonce, plaintext, ad)


def open_(key: bytes, nonce: bytes, ciphertext: bytes, ad: bytes = b"") -> bytes:
    subkey, subnonce = _subparts(key, nonce)
    return aead.open_(subkey, subnonce, ciphertext, ad)


# --- ASCII armor ----------------------------------------------------------

_ARMOR_TYPE = "TENDERMINT PRIVATE KEY"


def _crc24(data: bytes) -> int:
    """OpenPGP armor checksum (RFC 4880 §6.1)."""
    crc = 0xB704CE
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= 0x1864CFB
    return crc & 0xFFFFFF


def armor_encode(payload: bytes, headers: dict[str, str]) -> str:
    lines = [f"-----BEGIN {_ARMOR_TYPE}-----"]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    lines.append("")
    b64 = base64.b64encode(payload).decode()
    lines.extend(b64[i : i + 64] for i in range(0, len(b64), 64))
    crc = base64.b64encode(_crc24(payload).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {_ARMOR_TYPE}-----")
    return "\n".join(lines) + "\n"


def armor_decode(text: str) -> tuple[bytes, dict[str, str]]:
    lines = [ln.strip() for ln in text.strip().splitlines()]
    if (
        not lines
        or lines[0] != f"-----BEGIN {_ARMOR_TYPE}-----"
        or lines[-1] != f"-----END {_ARMOR_TYPE}-----"
    ):
        raise ValueError("malformed armor")
    headers: dict[str, str] = {}
    i = 1
    while i < len(lines) and lines[i]:
        if ":" not in lines[i]:
            break
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    body = []
    crc = None
    for ln in lines[i:-1]:
        if not ln:
            continue
        if ln.startswith("="):
            crc = ln[1:]
        else:
            body.append(ln)
    payload = base64.b64decode("".join(body))
    if crc is not None:
        want = int.from_bytes(base64.b64decode(crc), "big")
        if _crc24(payload) != want:
            raise ValueError("armor checksum mismatch")
    return payload, headers


# --- passphrase encryption (key-at-rest) ----------------------------------

_KDF = "scrypt"
_SCRYPT_N, _SCRYPT_R, _SCRYPT_P = 32768, 8, 1


def _derive(passphrase: str, salt: bytes) -> bytes:
    return hashlib.scrypt(
        passphrase.encode(),
        salt=salt,
        n=_SCRYPT_N,
        r=_SCRYPT_R,
        p=_SCRYPT_P,
        maxmem=64 * 1024 * 1024,
        dklen=32,
    )


def encrypt_key(priv_bytes: bytes, passphrase: str) -> str:
    """Armored, passphrase-encrypted private key material."""
    salt = os.urandom(16)
    nonce = os.urandom(NONCE_SIZE)
    key = _derive(passphrase, salt)
    ct = seal(key, nonce, priv_bytes)
    return armor_encode(
        salt + nonce + ct,
        {"kdf": _KDF, "type": "xchacha20poly1305"},
    )


def decrypt_key(armored: str, passphrase: str) -> bytes:
    payload, headers = armor_decode(armored)
    if headers.get("kdf", _KDF) != _KDF:
        raise ValueError(f"unsupported kdf {headers.get('kdf')!r}")
    if len(payload) < 16 + NONCE_SIZE + 16:
        raise ValueError("truncated encrypted key")
    salt, nonce = payload[:16], payload[16 : 16 + NONCE_SIZE]
    ct = payload[16 + NONCE_SIZE :]
    key = _derive(passphrase, salt)
    try:
        return open_(key, nonce, ct)
    except Exception:
        raise ValueError("invalid passphrase or corrupted key") from None
