"""Batched native secp256k1 ECDSA verification (BASELINE config 4).

The reference verifies secp256k1 validator signatures through native btcec
(crypto/secp256k1/secp256k1.go:190-215); the framework's pure-Python path
(crypto/secp256k1.py) is correct but ~8 ms per signature. This module
keeps the cheap scalar/parse work in CPython (bignum pow/invert are
C-speed) and hands the expensive double scalar multiplication
R = u1*G + u2*Q to native/secp256k1.cpp per batch.

Falls back to the pure-Python verify when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Optional

from ._native_build import NativeLoader
from .secp256k1 import N, _HALF_N, decompress_point, verify_digest

_loader = NativeLoader(
    "_tmsecp.so", "secp256k1.cpp", funcs=("tmsecp_shamir_batch",)
)


def native_lib() -> Optional[ctypes.CDLL]:
    return _loader.get()


def verify_msgs_batch(
    pub33s: list[bytes], msgs: list[bytes], sigs: list[bytes]
) -> list[bool]:
    """Per-item verdicts for (compressed pubkey, message, 64-byte R||S)
    triples — PubKey.verify semantics (sha256 digest, low-S enforced)."""
    digests = [hashlib.sha256(m).digest() for m in msgs]
    return verify_digest_batch(pub33s, digests, sigs)


def prep_digest_item(pub33: bytes, digest: bytes, sig: bytes):
    """The consensus-critical host half shared by BOTH batched backends
    (this native path and the TM_TPU_SECP_DEVICE kernel route in
    crypto/batch_verifier.py): signature parse, r/s range + low-S
    malleability check (reference crypto/secp256k1/secp256k1.go:199-210),
    pubkey decompression, and u1/u2. Returns (r, point, u1, u2) or None
    for a row that is definitively invalid. ONE implementation — a
    divergence between backends would be a consensus split."""
    if len(sig) != 64:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s <= _HALF_N):
        return None
    pt = decompress_point(pub33)
    if pt is None:
        return None
    z = int.from_bytes(digest, "big") % N
    si = pow(s, -1, N)
    u1 = z * si % N
    u2 = r * si % N
    if u1 == 0 and u2 == 0:
        # R would be the point at infinity: never a valid signature
        # (the device kernel reaches the same verdict via its is_inf
        # mask; rejected here so both backends share the decision)
        return None
    return r, pt, u1, u2


def verify_digest_batch(
    pub33s: list[bytes], digests: list[bytes], sigs: list[bytes]
) -> list[bool]:
    n = len(pub33s)
    out = [False] * n
    lib = native_lib()
    if lib is None:
        for i in range(n):
            pt = decompress_point(pub33s[i])
            if pt is not None:
                out[i] = verify_digest(digests[i], sigs[i], pt)
        return out

    # python-side cheap work: parse/range-check, decompress, u1/u2
    idx = []
    pub_buf = bytearray()
    u1_buf = bytearray()
    u2_buf = bytearray()
    rs: list[int] = []
    for i in range(n):
        prep = prep_digest_item(pub33s[i], digests[i], sigs[i])
        if prep is None:
            continue
        r, pt, u1, u2 = prep
        idx.append(i)
        rs.append(r)
        pub_buf += pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
        u1_buf += u1.to_bytes(32, "big")
        u2_buf += u2.to_bytes(32, "big")
    if not idx:
        return out
    out_x = ctypes.create_string_buffer(33 * len(idx))
    rc = lib.tmsecp_shamir_batch(
        bytes(pub_buf), bytes(u1_buf), bytes(u2_buf), out_x, len(idx)
    )
    if rc != 0:  # malformed input slipped through: python fallback
        for k, i in enumerate(idx):
            pt = decompress_point(pub33s[i])
            out[i] = pt is not None and verify_digest(
                digests[i], sigs[i], pt
            )
        return out
    for k, i in enumerate(idx):
        rec = out_x.raw[33 * k : 33 * (k + 1)]
        if rec[0] != 1:
            continue  # infinity
        x = int.from_bytes(rec[1:], "big")
        out[i] = (x % N) == rs[k]
    return out
