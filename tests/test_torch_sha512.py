"""The port's SHA-512 and mod-L reduction against the JAX package's
``ops/sha512.py``, hashlib and Python integers.

On the CPU ``challenge_batch`` and ``reduce_mod_l`` run their plain
versions (no launch is counted); the JAX side runs its jitted functions on
the CPU backend. Tolerance: exact bytes.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops import sha512 as jsha
from tendermint_tpu_torch import ops
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import sha512

L = host.L
# one ragged buffer: the padding edges 111/112 and 239/240 bytes, block
# edges 127/128, and a 2000-byte message (16 blocks)
LENGTHS = [0, 1, 111, 112, 127, 128, 239, 240, 2000]
# adversarial digests for the reduction
DIGEST_VALUES = [
    2**512 - 1, L - 1, L, L + 1, 2 * L, 2**252, 0, 1, 2 * L - 1,
    2**256 - 1, (2**512 - 1) // L * L, (2**512 - 1) // L * L - 1,
]


def _msgs():
    rng = np.random.default_rng(512)
    return [rng.bytes(n) for n in LENGTHS]


def _digests() -> np.ndarray:
    return np.stack(
        [np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in DIGEST_VALUES]
    )


@pytest.fixture(scope="module")
def jax_fns():
    return {
        "reduce": jax.jit(jsha.reduce_mod_l),
        "sha": jsha.sha512_batch_jit,
        "challenge": jsha.challenge_batch_jit,
    }


def test_pad_messages_matches_reference():
    msgs = _msgs()
    prefixes = [bytes([i]) * 64 for i in range(len(msgs))]
    for kw in ({}, {"prefix_pairs": prefixes}):
        buf, counts = sha512.pad_messages(msgs, **kw)
        jbuf, jcounts = jsha.pad_messages(msgs, **kw)
        np.testing.assert_array_equal(buf, jbuf)
        np.testing.assert_array_equal(counts, jcounts)
    assert buf.shape == (len(msgs), 32 * 128)  # 2064 bytes -> 17 -> 32 blocks


def test_sha512_batch_matches_jax_and_hashlib(jax_fns):
    msgs = _msgs()
    buf, counts = sha512.pad_messages(msgs)
    got = sha512.sha512_batch(torch.from_numpy(buf), torch.from_numpy(counts))
    want = np.asarray(jax_fns["sha"](jnp.asarray(buf), jnp.asarray(counts)))
    np.testing.assert_array_equal(got.numpy(), want)
    for row, m in zip(got.numpy(), msgs):
        assert row.tobytes() == hashlib.sha512(m).digest(), len(m)


def test_reduce_mod_l_matches_jax_and_int(jax_fns):
    d = _digests()
    before = ops.kernel_launches()
    got = sha512.reduce_mod_l(torch.from_numpy(d))
    assert ops.kernel_launches() == before  # CPU tensor: plain version
    want = np.asarray(jax_fns["reduce"](jnp.asarray(d)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [int.from_bytes(r.tobytes(), "little") for r in got.numpy()] == [
        v % L for v in DIGEST_VALUES
    ]


def test_challenge_batch_matches_jax_and_host_oracle(jax_fns):
    rng = np.random.default_rng(7)
    rows = []
    for n in (0, 13, 120, 121, 200, 2000):
        rows.append((rng.bytes(32), rng.bytes(32), rng.bytes(n)))
    buf, counts = sha512.pad_messages(
        [m for _, _, m in rows], prefix_pairs=[r + a for r, a, _ in rows]
    )
    got = sha512.challenge_batch(torch.from_numpy(buf), torch.from_numpy(counts))
    want = np.asarray(jax_fns["challenge"](jnp.asarray(buf), jnp.asarray(counts)))
    np.testing.assert_array_equal(got.numpy(), want)
    for row, (r, a, m) in zip(got.numpy(), rows):
        assert row.tobytes() == host.challenge(r, a, m).to_bytes(32, "little")
    assert torch.equal(
        got, sha512.challenge_batch_plain(torch.from_numpy(buf), torch.from_numpy(counts))
    )


def test_challenge_batch_rows_keep_state_past_their_count(jax_fns):
    """A row whose count is below the buffer's blocks (and a zero count)
    hashes only its own blocks, as the masked JAX loop does."""
    msgs = [b"x" * 300, b"y" * 5, b""]
    buf, counts = sha512.pad_messages(msgs)
    counts = counts.copy()
    counts[2] = 0
    got = sha512.sha512_batch(torch.from_numpy(buf), torch.from_numpy(counts))
    want = np.asarray(jax_fns["sha"](jnp.asarray(buf), jnp.asarray(counts)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_unsupported_devices():
    """Neither CPU nor CUDA: raise, never fall back to a plain version."""
    with pytest.raises(ValueError, match="unsupported device"):
        sha512.reduce_mod_l(torch.zeros((2, 64), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sha512.challenge_batch(
            torch.zeros((2, 100), dtype=torch.uint8, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
        )
