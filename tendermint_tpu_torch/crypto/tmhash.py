"""tmhash = SHA-256 (reference crypto/tmhash/hash.go)."""

from __future__ import annotations

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum(data: bytes) -> bytes:  # noqa: A001 - mirrors reference name
    return hashlib.sha256(data).digest()


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
