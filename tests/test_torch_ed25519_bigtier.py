"""Parity of the port's big-tier ed25519 functions with the JAX package.

The big tier's 64 x 16 fixed-window table (``neg_pubkey_bigtable``) and
its verifies against a shared store (``verify_prehashed_bigcache``, the
one-hot-gather ``_mxu`` form, and ``verify_msgs_bigcache`` with the
challenges hashed by ``ops/sha512``). On the CPU each wrapper runs its
plain PyTorch version; the JAX side runs ``neg_pubkey_bigtable`` and the
batch verifier's ``_verify_cached_big``/``_mxu``/``_msgs`` programs,
which take the same operands, jitted on the CPU backend. Inputs: the rows and adversarial
keys of ``test_torch_ed25519_batch`` (small-order and non-canonical keys,
s >= L, wrong message, zero R, random key bytes), padding rows, a
corrupted row and an index past the store. Tolerance: exact equality of
table bytes and bitmaps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu_torch import ops
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import ed25519_batch as eb

from .test_torch_ed25519_batch import _arrays, _rows, _t


# the slice-1 adversarial keys beyond those of _rows(): y = 0 (order 4),
# y = 1 with the sign bit, y = p + 1, y = 2^255 - 1, y = -1 (order 2)
_BIG_EXTRA_KEYS = [
    bytes(32),
    ((1 << 255) | 1).to_bytes(32, "little"),
    (host.P + 1).to_bytes(32, "little"),
    (2**255 - 1).to_bytes(32, "little"),
    (host.P - 1).to_bytes(32, "little"),
]


@pytest.fixture(scope="module")
def big():
    """A big-tier store of 10 keys built by JAX, stored in reverse order
    of first use, and the rows of _rows() plus two padding rows (idx -1)."""
    from tendermint_tpu.crypto import batch_verifier as jbv

    rows = _rows()
    pubs, r, s, k, s_ok = _arrays(rows)
    want = [host.verify(p, m, sig) for p, m, sig in rows]
    store_keys = list(dict.fromkeys(bytes(p) for p in pubs)) + _BIG_EXTRA_KEYS
    store_keys = store_keys[::-1]
    store = np.array([list(p) for p in store_keys], dtype=np.uint8)
    jt, jv = jax.jit(jeb.neg_pubkey_bigtable)(jnp.asarray(store))
    idx = np.array(
        [store_keys.index(bytes(p)) for p in pubs] + [-1, -1], dtype=np.int32
    )
    pad = np.zeros((2, 32), dtype=np.uint8)
    args = (
        np.concatenate([r, pad]), np.concatenate([s, pad]),
        np.concatenate([k, pad]), np.concatenate([s_ok, [False, False]]),
    )
    fns = {
        "big": jax.jit(jbv._verify_cached_big),
        "mxu": jax.jit(jbv._verify_cached_big_mxu),
        "msgs": jax.jit(jbv._verify_cached_msgs),
    }
    return rows, store, (np.array(jt), np.array(jv)), idx, args, want + [False, False], fns


def test_neg_pubkey_bigtable_bytes_match_jax(big):
    _, store, (jt, jv), *_ = big
    before = ops.kernel_launches()
    tables, valid = eb.neg_pubkey_bigtable(torch.from_numpy(store))
    assert ops.kernel_launches() == before  # CPU tensors: plain version
    assert tables.dtype == torch.uint8 and tables.shape == (10, 64, 16, 4, 32)
    np.testing.assert_array_equal(tables.numpy(), jt)
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert valid.tolist() == [host.point_decompress(bytes(p)) is not None for p in store]


@pytest.mark.parametrize(
    "name, port_fn",
    [("big", eb.verify_prehashed_bigcache), ("mxu", eb.verify_prehashed_bigcache_mxu)],
)
def test_verify_prehashed_bigcache_bitmap_matches_jax(big, name, port_fn):
    """Rows gather their table from a permuted store by idx; padding rows
    (idx -1), s >= L, a wrong message, zero R and bad keys reject."""
    _, _, (jt, jv), idx, (r, s, k, s_ok), want, fns = big
    jgot = np.asarray(
        fns[name](jnp.asarray(jt), jnp.asarray(jv), jnp.asarray(idx),
                  *map(jnp.asarray, (r, s, k, s_ok)))
    )
    got = port_fn(*_t(jt, jv, idx, r, s, k, s_ok))
    assert got.tolist() == jgot.tolist() == want
    # a corrupted row, and an idx past the store (rejected without a read)
    s2 = s.copy()
    s2[0, 3] ^= 1
    idx2 = idx.copy()
    idx2[6] = jt.shape[0]
    got = port_fn(*_t(jt, jv, idx2, r, s2, k, s_ok))
    assert got.tolist() == [w and i not in (0, 6) for i, w in enumerate(want)]



def test_verify_msgs_bigcache_matches_jax(big):
    from tendermint_tpu_torch.ops import sha512

    rows, _, (jt, jv), idx, (r, s, k, s_ok), want, fns = big
    msgs = [m for _, m, _ in rows] + [b"", b""]
    prefixes = [sig[:32] + p for p, _, sig in rows] + [b"", b""]
    buf, counts = sha512.pad_messages(msgs, prefix_pairs=prefixes)
    jgot = np.asarray(
        fns["msgs"](jnp.asarray(jt), jnp.asarray(jv), jnp.asarray(idx),
                    jnp.asarray(r), jnp.asarray(s), jnp.asarray(buf),
                    jnp.asarray(counts), jnp.asarray(s_ok))
    )
    got = eb.verify_msgs_bigcache(*_t(jt, jv, idx, r, s, buf, counts, s_ok))
    assert got.tolist() == jgot.tolist() == want
