"""The port's SHA-256 (ops/sha256.py) and device merkle-leaf route
(crypto/merkle.py) against the JAX package's.

The same seeded ragged messages go through the JAX package's padding and
jitted ``sha256_batch`` and the port's padding and plain version (the
wrapper's CPU route), and through hashlib; the RFC 6962 helpers and
``Data.hash()`` with the device gate on go through both packages' merkle
modules. Tolerance: exact (bytes).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.ops import sha256 as jsha
from tendermint_tpu.types.block import Data as JData
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.ops import sha256 as tsha
from tendermint_tpu_torch.types.block import Data as TData

_J_LEAF = jax.jit(jsha.merkle_leaf_hash)
_J_INNER = jax.jit(jsha.merkle_inner_hash)
_J_ROOT = jax.jit(jsha.merkle_root_pow2)


def _ragged(seed: int, n: int, hi: int = 300) -> list[bytes]:
    rng = np.random.default_rng(seed)
    msgs = [rng.bytes(int(k)) for k in rng.integers(0, hi, n)]
    # the padding's edges: 55 and 56 bytes (one or two blocks), 64
    return msgs + [b"", b"a" * 55, b"b" * 56, b"c" * 64, b"d" * 119, b"e" * 120]


@pytest.mark.parametrize("prefix", [b"", b"\x00"])
def test_pad_messages_matches_jax_byte_for_byte(prefix):
    msgs = _ragged(1, 40)
    got, got_n = tsha.pad_messages(msgs, prefix=prefix)
    want, want_n = jsha.pad_messages(msgs, prefix=prefix)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    assert got.dtype == want.dtype and got_n.dtype == want_n.dtype


def test_sha256_batch_matches_jax_and_hashlib_on_ragged_rows():
    """Ragged rows, and block counts the kernel must clamp: 0 (the initial
    state), more than the buffer holds, negative."""
    msgs = _ragged(2, 60)
    buf, counts = jsha.pad_messages(msgs)
    counts = counts.copy()
    counts[[3, 4, 5]] = [0, 50, -2]
    got = tsha.sha256_batch(torch.from_numpy(buf), torch.from_numpy(counts)).numpy()
    want = np.asarray(jsha.sha256_batch_jit(jnp.asarray(buf), jnp.asarray(counts)))
    np.testing.assert_array_equal(got, want)
    for i, m in enumerate(msgs):
        if i not in (3, 4, 5):
            assert got[i].tobytes() == hashlib.sha256(m).digest(), i


def test_merkle_helpers_match_jax():
    rng = np.random.default_rng(3)
    leaves = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    right = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    t = torch.from_numpy
    got_leaf = tsha.merkle_leaf_hash(t(leaves)).numpy()
    np.testing.assert_array_equal(got_leaf, np.asarray(_J_LEAF(jnp.asarray(leaves))))
    for row, x in zip(got_leaf, leaves):
        assert row.tobytes() == tmerkle.leaf_hash(x.tobytes())
    np.testing.assert_array_equal(
        tsha.merkle_inner_hash(t(leaves), t(right)).numpy(),
        np.asarray(_J_INNER(jnp.asarray(leaves), jnp.asarray(right))),
    )
    root = tsha.merkle_root_pow2(t(leaves)).numpy().tobytes()
    assert root == np.asarray(_J_ROOT(jnp.asarray(leaves))).tobytes()
    assert root == tmerkle.hash_from_byte_slices([x.tobytes() for x in leaves])
    with pytest.raises(ValueError, match="power-of-two"):
        tsha.merkle_root_pow2(t(leaves[:12]))
    with pytest.raises(ValueError, match="one block"):
        tsha.merkle_leaf_hash(t(np.zeros((2, 55), np.uint8)))


@pytest.fixture
def cpu_gate(monkeypatch):
    """Both packages' device gate at 8 leaves; the port's process verifier
    on the CPU (the SHA-256 kernel's plain version)."""
    monkeypatch.setattr(bv, "_default", bv.BatchVerifier(device="cpu"))
    monkeypatch.setattr(tmerkle, "DEVICE_LEAF_MIN", 8)
    monkeypatch.setattr(jmerkle, "DEVICE_LEAF_MIN", 8)


def _block(seed: int, n_txs: int, hi: int = 1025) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        txs=[rng.bytes(int(k)) for k in rng.integers(100, hi, n_txs)],
        l2_block_meta=rng.bytes(64),
        l2_batch_header=rng.bytes(32),
    )


def test_data_hash_with_the_device_gate_matches_jax(cpu_gate, monkeypatch):
    """An L2 block of 70 transactions of 100-1024 bytes (72 leaves: the 256
    bucket, the block axis rounded up to a power of two) hashes its leaves
    on the port's device route; the root equals the JAX package's device
    route and the host tree."""
    calls = []
    route = tmerkle._device_leaf_hashes
    monkeypatch.setattr(tmerkle, "_device_leaf_hashes",
                        lambda items: calls.append(len(items)) or route(items))
    block = _block(4, 70)
    got = TData(**block).hash()
    assert calls == [72]
    assert got == JData(**block).hash()
    monkeypatch.setattr(tmerkle, "DEVICE_LEAF_MIN", 0)
    assert got == TData(**block).hash()  # the host tree


def test_device_gate_bounds_match_jax(cpu_gate, monkeypatch):
    """Below the gate, and with one leaf over DEVICE_LEAF_MAX_BYTES, the
    leaves hash on the host (the JAX package's gate); at the gate the
    device route's leaves equal leaf_hash."""
    def no_device(items):
        raise AssertionError("device route taken")

    route = tmerkle._device_leaf_hashes
    monkeypatch.setattr(tmerkle, "_device_leaf_hashes", no_device)
    small = _block(5, 5)  # 7 leaves
    long_leaf = _block(6, 9)
    long_leaf["txs"][3] = b"x" * (tmerkle.DEVICE_LEAF_MAX_BYTES + 1)
    assert tmerkle.DEVICE_LEAF_MAX_BYTES == jmerkle.DEVICE_LEAF_MAX_BYTES
    for block in (small, long_leaf):
        assert TData(**block).hash() == JData(**block).hash()
    items = [b"leaf-%d" % i for i in range(8)]
    assert route(items) == [tmerkle.leaf_hash(x) for x in items]
