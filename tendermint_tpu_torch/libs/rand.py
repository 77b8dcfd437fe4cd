"""Seedable randomness helpers (reference libs/rand/random.go).

The reference exposes a global seeded source with Str/Bytes/Int*/Perm
helpers used by tests and the p2p layer (dial jitter, nonce padding).
Security-sensitive randomness (keys, nonces) does NOT come from here —
that is `secrets`/OS entropy at the call sites.
"""

from __future__ import annotations

import random
import threading

_ALPHANUM = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"

_lock = threading.Lock()
_rng = random.Random()


def seed(n: int) -> None:
    with _lock:
        _rng.seed(n)


def rand_str(length: int) -> str:
    """Random alphanumeric string (reference Str, random.go:52)."""
    with _lock:
        return "".join(_rng.choice(_ALPHANUM) for _ in range(length))


def rand_bytes(n: int) -> bytes:
    with _lock:
        return _rng.randbytes(n)


def rand_intn(n: int) -> int:
    """Uniform in [0, n) (reference Intn)."""
    with _lock:
        return _rng.randrange(n)


def rand_uint64() -> int:
    with _lock:
        return _rng.getrandbits(64)


# reference Int63n: same contract as Intn for Python ints
rand_int63n = rand_intn


def rand_perm(n: int) -> list[int]:
    """Random permutation of range(n) (reference Perm)."""
    with _lock:
        idx = list(range(n))
        _rng.shuffle(idx)
        return idx


def rand_float64() -> float:
    with _lock:
        return _rng.random()
