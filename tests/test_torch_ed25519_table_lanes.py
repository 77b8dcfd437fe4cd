"""The four-lane table build of kernel 2 (``tm_neg_pubkey_table``) on the
CPU.

The kernel runs only on the card, but its key code is plain C++:
``neg_pubkey_table_x4`` of ``ops/csrc/ed25519_device.cuh``, which runs
kernel 4's table build (``neg_table_x4``) into canonical bytes. The host
harness ``tests/ed25519_lanes_host.cpp`` (built by the fixture of
``test_torch_ed25519_lanes.py``) runs the 4 lanes of a group in lock-step
through that source, with the tagged exchange that fails a call whose
lanes disagree. Every byte of every lane's component and the validity
flags are held against the one-thread build of the same header
(``tm_host_neg_pubkey_table_1t``, the order of the one-thread kernel it
replaced), the port's plain version (``eb.neg_pubkey_table_plain``), the
JAX package's ``neg_pubkey_table`` and the host oracle's decompression.
Keys: seeded valid keys, the smoke's adversarial keys (the identity, y =
0, y = 1 with the sign set, y = p, y = p + 1, 2^255 - 1, y = -1) and key
bytes with no square root, whose tables are the formulas' points byte for
byte. Tolerance: exact.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import ed25519_batch as eb

from .test_torch_ed25519_lanes import _kbytes, _ptr, _u8, lib  # noqa: F401

P = host.P
ADVERSARIAL = [
    (1).to_bytes(32, "little"),  # identity (small order)
    bytes(32),  # y = 0: order-4 point
    ((1 << 255) | 1).to_bytes(32, "little"),  # y = 1, x = 0, sign set
    P.to_bytes(32, "little"),  # y = p, non-canonical
    (P + 1).to_bytes(32, "little"),  # y = p + 1, non-canonical
    (2**255 - 1).to_bytes(32, "little"),  # y = 2^255 - 1
    (P - 1).to_bytes(32, "little"),  # y = -1: order-2 point
]
N_KEYS = 150


@pytest.fixture(scope="module")
def tlib(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_host_neg_pubkey_table.argtypes = [vp, vp, vp, vp, i]
    lib.tm_host_neg_pubkey_table.restype = i
    lib.tm_host_neg_pubkey_table_1t.argtypes = [vp, vp, vp, vp, i]
    lib.tm_host_neg_pubkey_table_1t.restype = None
    return lib


@pytest.fixture(scope="module")
def keys() -> np.ndarray:
    """N_KEYS key byte strings: a valid key, the adversarial keys, three
    with no square root, then valid keys and random bytes (about half of
    them with no square root) alternating."""
    rng = np.random.default_rng(2027)
    pubs = [host.PrivKey(rng.bytes(32)).public_key().data] + ADVERSARIAL
    while len(pubs) < 11:
        cand = rng.bytes(32)
        if host.point_decompress(cand) is None:
            pubs.append(cand)
    while len(pubs) < N_KEYS:
        pubs.append(host.PrivKey(rng.bytes(32)).public_key().data
                    if len(pubs) % 2 else rng.bytes(32))
    return _u8(pubs)


def host_tables(tlib, pubs: np.ndarray, entry: str = "tm_host_neg_pubkey_table"):
    """The harness's build of [n, 32] key bytes: (tables [n, 16, 4, 32],
    valid [n] bool), written over a pattern no build leaves."""
    n = pubs.shape[0]
    tables = np.full((n, 16, 4, 32), 0xAB, dtype=np.uint8)
    valid = np.full(n, 7, dtype=np.uint8)
    rc = getattr(tlib, entry)(
        _ptr(np.ascontiguousarray(pubs)), _ptr(tables), _ptr(valid), _ptr(_kbytes()), n)
    assert rc in (None, 0), "the 4 lanes fell out of lock-step"
    assert set(valid.tolist()) <= {0, 1}, "a key's validity was not written"
    return tables, valid.astype(bool)


@pytest.mark.parametrize("n", [1, 23, N_KEYS])
def test_table_lanes_equal_one_thread_and_plain(tlib, keys, n):
    """At 1, 23 and 150 keys (one group; a partial last warp on the card;
    the commit path's validator count): every lane's bytes and the
    validity flags equal the one-thread build and the plain version, and
    the flags the host oracle."""
    pubs = keys[:n]
    got, valid = host_tables(tlib, pubs)
    one, one_valid = host_tables(tlib, pubs, "tm_host_neg_pubkey_table_1t")
    plain, plain_valid = eb.neg_pubkey_table_plain(torch.from_numpy(pubs))
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(got, plain.numpy())
    want = [host.point_decompress(bytes(p)) is not None for p in pubs]
    assert valid.tolist() == one_valid.tolist() == plain_valid.tolist() == want


def test_table_lanes_equal_jax(tlib, keys):
    """The first 23 keys (a valid key, every adversarial key, keys with no
    square root): the four-lane build equals the JAX package's
    neg_pubkey_table byte for byte, its validity flags too."""
    pubs = keys[:23]
    got, valid = host_tables(tlib, pubs)
    jt, jv = jax.jit(jeb.neg_pubkey_table)(jnp.asarray(pubs))
    np.testing.assert_array_equal(got, np.asarray(jt))
    assert valid.tolist() == np.asarray(jv).tolist()
    assert not all(valid) and any(valid)


def test_table_lanes_invalid_keys_keep_the_formulas_points(tlib, keys):
    """A key that fails to decompress still gets the table the formulas
    give, with no early exit: entry 0 is cached(identity) = (1, 1, 0, 2),
    no entry is left at the harness's 0xAB pattern, and the 14 entries
    that cached adds make differ from entry 0 and from each other
    (projective points: even the identity's multiples carry growing Z)."""
    got, valid = host_tables(tlib, keys)
    ident = np.zeros((4, 32), dtype=np.uint8)
    ident[0, 0] = ident[1, 0] = 1
    ident[3, 0] = 2
    bad = np.flatnonzero(~valid)
    assert bad.size >= 10
    for i in bad:
        np.testing.assert_array_equal(got[i, 0], ident)
        added = {got[i, j].tobytes() for j in range(2, 16)}
        assert len(added) == 14 and got[i, 0].tobytes() not in added, i
        assert not any((got[i, j] == 0xAB).all(-1).any() for j in range(16)), i


def test_smoke_key_sets_hold_adversarial_keys(keys):
    """chip_smoke.py's kernel 2 shapes: 1, 23, 150 and 256 keys, the 23
    and 150 with invalid keys among valid ones; its critical path is the
    decompression and the four-lane table (275 + 1 + 14 x 2 + 16)."""
    import chip_smoke

    pub_d = torch.from_numpy(np.concatenate([keys, keys[:106]]))
    sets = chip_smoke.kernel2_key_sets(torch, pub_d, 1)
    assert list(sets) == [1, 23, 150, 256]
    for n, (pk, order) in sets.items():
        assert pk.shape == (n, 32) and order[0] == 0
        valid = [host.point_decompress(bytes(p)) is not None for p in pk.numpy()]
        assert valid[0] and (n == 1 or not all(valid)), n
    assert chip_smoke.FE_TABLE_PATH == chip_smoke.FE_DECOMPRESS + 45 == 320
