"""ChaCha20-Poly1305 AEAD: native C++ fast path + pure-Python fallback.

The native library (native/chacha20poly1305.cpp) is compiled on first use
with g++ into the port's build directory, _kbuild/, and loaded via ctypes —
the framework's native equivalent of x/crypto's assembly AEAD (SURVEY.md
§2.2). The Python
fallback implements RFC 8439 directly; it is slow but keeps everything
working where no compiler exists.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

from ._native_build import NativeLoader

KEY_SIZE = 32
NONCE_SIZE = 12
TAG_SIZE = 16

_loader = NativeLoader(
    "_tmcrypto.so",
    "chacha20poly1305.cpp",
    funcs=("tm_aead_seal", "tm_aead_open"),
    timeout=120,
)


def _native_lib() -> Optional[ctypes.CDLL]:
    return _loader.get()


# --- pure-python fallback (RFC 8439) --------------------------------------


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _chacha_block(key_words, counter, nonce_words):
    state = (
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
        + key_words
        + [counter]
        + nonce_words
    )
    x = list(state)
    for _ in range(10):
        for a, b, c, d in (
            (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
        ):
            x[a] = (x[a] + x[b]) & 0xFFFFFFFF; x[d] = _rotl(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & 0xFFFFFFFF; x[b] = _rotl(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & 0xFFFFFFFF; x[d] = _rotl(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & 0xFFFFFFFF; x[b] = _rotl(x[b] ^ x[c], 7)
    return struct.pack(
        "<16I", *[(a + b) & 0xFFFFFFFF for a, b in zip(x, state)]
    )


def _chacha20_xor(key: bytes, nonce: bytes, counter: int, data: bytes) -> bytes:
    kw = list(struct.unpack("<8I", key))
    nw = list(struct.unpack("<3I", nonce))
    out = bytearray()
    for i in range(0, len(data), 64):
        block = _chacha_block(kw, counter + i // 64, nw)
        chunk = data[i : i + 64]
        out += bytes(a ^ b for a, b in zip(chunk, block))
    return bytes(out)


def _poly1305(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16] + b"\x01"
        acc = (acc + int.from_bytes(block, "little")) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _py_tag(key, nonce, ad, ct) -> bytes:
    polykey = _chacha_block(
        list(struct.unpack("<8I", key)), 0, list(struct.unpack("<3I", nonce))
    )[:32]
    mac_data = (
        ad + _pad16(ad) + ct + _pad16(ct)
        + struct.pack("<QQ", len(ad), len(ct))
    )
    return _poly1305(polykey, mac_data)


# --- public API -----------------------------------------------------------


def seal(key: bytes, nonce: bytes, plaintext: bytes, ad: bytes = b"") -> bytes:
    lib = _native_lib()
    if lib is not None:
        out = ctypes.create_string_buffer(len(plaintext) + TAG_SIZE)
        lib.tm_aead_seal(
            key, nonce, plaintext, len(plaintext), ad, len(ad), out
        )
        return out.raw
    ct = _chacha20_xor(key, nonce, 1, plaintext)
    return ct + _py_tag(key, nonce, ad, ct)


def open_(key: bytes, nonce: bytes, sealed: bytes, ad: bytes = b"") -> bytes:
    """Raises ValueError on authentication failure."""
    if len(sealed) < TAG_SIZE:
        raise ValueError("ciphertext too short")
    lib = _native_lib()
    if lib is not None:
        out = ctypes.create_string_buffer(max(1, len(sealed) - TAG_SIZE))
        rc = lib.tm_aead_open(
            key, nonce, sealed, len(sealed), ad, len(ad), out
        )
        if rc != 0:
            raise ValueError("aead authentication failed")
        return out.raw[: len(sealed) - TAG_SIZE]
    ct, tag = sealed[:-TAG_SIZE], sealed[-TAG_SIZE:]
    want = _py_tag(key, nonce, ad, ct)
    import hmac as _hmac

    if not _hmac.compare_digest(tag, want):
        raise ValueError("aead authentication failed")
    return _chacha20_xor(key, nonce, 1, ct)


def using_native() -> bool:
    return _native_lib() is not None
