"""The four-lane big tier on the CPU: kernel 6 (``tm_verify_bigcache``)
and kernel 5 (``tm_neg_pubkey_bigtable``).

Both kernels run only on the card, but their row code is plain C++:
``verify_bigcache_x4``, ``bigcache_points_x4`` and
``neg_pubkey_bigtable_x4`` of ``ops/csrc/ed25519_device.cuh``. The host
harness ``tests/ed25519_lanes_host.cpp`` (built by the fixture of
``test_torch_ed25519_lanes.py``) runs the 4 lanes of a group in lock-step
through that source, with the tagged exchange that fails a call whose
lanes disagree. The verify's verdicts are held against the port's plain
version (``eb.verify_prehashed_bigcache_plain``), the JAX package's
``verify_prehashed_bigcache`` with ``_verify_cached_big``'s masking, and
the host oracle; its points (the window sum, [s]B and their sum) limb for
limb against the one-thread ``ge_add_cached`` chain and as canonical
bytes against the plain PyTorch ``scalar_mult_var_bigcache``,
``scalar_mult_base`` and ``add``. The table build's bytes are held
against ``eb.neg_pubkey_bigtable_plain`` and the JAX package's
``neg_pubkey_bigtable``. Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import curve25519 as curve
from tendermint_tpu_torch.ops import ed25519_batch as eb
from tendermint_tpu_torch.ops import field25519 as fe

from .test_torch_ed25519_lanes import (  # noqa: F401 (lib is a fixture)
    _kbytes, _limbs_to_int, _ptr, _rows, _u8, host_verify_table, lib,
)

VERIFY = "tm_host_verify_bigcache"


@pytest.fixture(scope="module")
def big_batch():
    """The 64 rows of _rows() over a big-tier store of its 16 keys (12
    valid, the identity, y = p, two with no square root), built by the
    plain version."""
    pubs, items, idx, want = _rows()
    tables, tvalid = eb.neg_pubkey_bigtable_plain(torch.from_numpy(_u8(pubs)))
    r = _u8(sg[:32] for _, _, sg in items)
    s = _u8(sg[32:] for _, _, sg in items)
    k = _u8(host.challenge(sg[:32], p, m).to_bytes(32, "little") for p, m, sg in items)
    s_ok = np.array([int.from_bytes(sg[32:], "little") < host.L for _, _, sg in items])
    return tables.numpy(), tvalid.numpy(), idx, r, s, k, s_ok, want, pubs


def test_big_lanes_verdicts_match_plain_jax_and_oracle(lib, big_batch):
    tables, tvalid, idx, r, s, k, s_ok, want, _ = big_batch
    got = host_verify_table(lib, tables, tvalid, idx, r, s, k, s_ok, entry=VERIFY)
    plain = eb.verify_prehashed_bigcache_plain(
        *map(torch.from_numpy, (tables, tvalid, idx, r, s, k, s_ok))
    ).tolist()
    # the JAX package's big tier, masked as _verify_cached_big does (a row
    # past the store masked the same way as idx -1)
    live = (idx >= 0) & (idx < tables.shape[0])
    safe = np.where(live, idx, 0)
    jgot = np.asarray(jax.jit(jeb.verify_prehashed_bigcache)(
        jnp.asarray(tables), jnp.asarray(tvalid[safe] & live), jnp.asarray(safe),
        *map(jnp.asarray, (r, s, k, s_ok)),
    )).tolist()
    assert got == plain == jgot == want
    kinds = {i % 8 for i, w in enumerate(want) if w}
    assert kinds == {0, 6, 7}, kinds  # the identity key's signature verifies


@pytest.mark.parametrize("b", [1, 23, 40])
def test_big_lanes_verdicts_on_row_prefixes(lib, big_batch, b):
    """Batches of 1, 23 and 40 rows (one row group; a partial last warp on
    the card; more than a warp's 8 rows) give each row its verdict in the
    64-row batch."""
    tables, tvalid, idx, r, s, k, s_ok, want, _ = big_batch
    ops = (idx[:b], r[:b], s[:b], k[:b], s_ok[:b])
    got = host_verify_table(lib, tables, tvalid, *ops, entry=VERIFY)
    plain = eb.verify_prehashed_bigcache_plain(
        *map(torch.from_numpy, (tables, tvalid, *ops))
    ).tolist()
    assert got == plain == want[:b]


def test_big_lanes_reject_one_flipped_challenge_alone(lib, big_batch):
    tables, tvalid, idx, r, s, k, s_ok, want, _ = big_batch
    k_bad = k.copy()
    k_bad[0, 0] ^= 1
    assert want[0]
    got = host_verify_table(lib, tables, tvalid, idx, r, s, k_bad, s_ok, entry=VERIFY)
    assert got == [False] + want[1:]


def _canon(limbs: np.ndarray) -> np.ndarray:
    """[..., 4, 5] uint64 limbs of a point -> [..., 4, 32] canonical bytes."""
    flat = limbs.reshape(-1, 5)
    out = [list(_limbs_to_int(v).to_bytes(32, "little")) for v in flat]
    return np.array(out, dtype=np.uint8).reshape(limbs.shape[:-1] + (32,))


def test_big_lanes_points_equal_one_thread_limb_for_limb(lib, big_batch):
    """On every row whose idx lies in the store (invalid keys' tables
    too), each lane's window sum, [s]B and final point equal the
    one-thread chain's limbs, and those equal the plain PyTorch points."""
    tables, _, idx, _, s, k, *_ = big_batch
    rows = np.flatnonzero((idx >= 0) & (idx < tables.shape[0]))
    idx_l, s_l, k_l = (np.ascontiguousarray(a[rows]) for a in (idx, s, k))
    b = rows.size
    out = np.zeros((b, 15, 4, 5), dtype=np.uint64)
    base = curve.base_table_bytes()
    kb = _kbytes()
    rc = lib.tm_host_bigcache_points(
        _ptr(tables), _ptr(idx_l), _ptr(s_l), _ptr(k_l), _ptr(base), _ptr(kb),
        _ptr(out), b,
    )
    assert rc == 0, "the 4 lanes fell out of lock-step"
    for lane in range(4):
        np.testing.assert_array_equal(out[:, 3 + 3 * lane : 6 + 3 * lane], out[:, :3])
    acc = curve.scalar_mult_var_bigcache(
        torch.from_numpy(k_l), torch.from_numpy(tables), torch.from_numpy(idx_l))
    sb = curve.scalar_mult_base(torch.from_numpy(s_l))
    q = curve.add(sb, acc)
    for slot, val in ((0, acc), (1, sb), (2, q)):
        np.testing.assert_array_equal(_canon(out[:, slot]), fe.to_bytes(val).numpy())


def host_bigtable(lib, pubs: np.ndarray):
    """The harness's four-lane table build of [n, 32] key bytes."""
    n = pubs.shape[0]
    tables = np.full((n, 64, 16, 4, 32), 0xAB, dtype=np.uint8)
    valid = np.full(n, 7, dtype=np.uint8)
    rc = lib.tm_host_neg_pubkey_bigtable(
        _ptr(np.ascontiguousarray(pubs)), _ptr(tables), _ptr(valid), _ptr(_kbytes()), n)
    assert rc != -1, "the 4 lanes fell out of lock-step"
    assert rc == 0
    assert set(valid.tolist()) <= {0, 1}, "a key's validity was not written"
    return tables, valid.astype(bool)


def test_big_lanes_table_build_equals_plain(lib, big_batch):
    """The 16-key store of big_batch (valid keys, the identity, y = p,
    keys with no square root): every byte of every entry, and validity."""
    tables, tvalid, *_, pubs = big_batch
    got, valid = host_bigtable(lib, _u8(pubs))
    np.testing.assert_array_equal(got, tables)
    np.testing.assert_array_equal(valid, tvalid)
    assert valid.tolist() == [host.point_decompress(p) is not None for p in pubs]


def test_big_lanes_table_build_equals_jax(lib):
    """A valid key, a key with no square root, the all-zero key bytes (y =
    0, a point of order 4) and y = p + 1 (non-canonical): the four-lane
    build, the plain version and the JAX package's neg_pubkey_bigtable
    give the same bytes."""
    rng = np.random.default_rng(10)
    pubs = [host.PrivKey(rng.bytes(32)).public_key().data]
    while len(pubs) < 2:
        cand = rng.bytes(32)
        if host.point_decompress(cand) is None:
            pubs.append(cand)
    pubs += [bytes(32), (host.P + 1).to_bytes(32, "little")]
    keys = _u8(pubs)
    got, valid = host_bigtable(lib, keys)
    plain, pvalid = eb.neg_pubkey_bigtable_plain(torch.from_numpy(keys))
    jt, jv = jax.jit(jeb.neg_pubkey_bigtable)(jnp.asarray(keys))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, np.asarray(jt))
    assert valid.tolist() == pvalid.tolist() == np.asarray(jv).tolist() == [
        True, False, True, False]
