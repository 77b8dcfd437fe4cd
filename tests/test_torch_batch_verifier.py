"""The port's BatchVerifier (device="cpu": plain kernel versions) against
the JAX package's BatchVerifier on the CPU backend.

Covered: the host path (n < min_device_batch), the generic path at
buckets 8 and 32 (a table cache too small for the batch), the small tier
on tables that JAX built and crypto/convert carried over, the snapshot
retry, cache reset, the mixed-key partition, and the features this slice
does not have, which must raise NotImplementedError. Tolerance: exact
bitmap equality.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.batch_verifier import BatchVerifier as JaxVerifier
from tendermint_tpu.crypto.batch_verifier import SigItem as JaxItem
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import convert
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry


def _items(n: int, seed: int) -> list[bv.SigItem]:
    """n rows over n//2 + 1 keys: valid, tampered, s >= L, bad keys."""
    rng = np.random.default_rng(seed)
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(n // 2 + 1)]
    out = []
    for i in range(n):
        k = keys[i % len(keys)]
        msg = b"precommit-%d-%d" % (seed, i)
        sig = k.sign(msg)
        pub = k.public_key().data
        kind = i % 6
        if kind == 1:
            sig = sig[:9] + bytes([sig[9] ^ 0x10]) + sig[10:]
        elif kind == 2:
            s = int.from_bytes(sig[32:], "little") + host.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 3 and i % 12 == 3:
            pub = host.P.to_bytes(32, "little")  # non-canonical key
        elif kind == 3:
            pub = (1).to_bytes(32, "little")  # small-order key
        out.append(bv.SigItem(pub, msg, sig))
    return out


def _jax_items(items):
    return [JaxItem(it.pubkey, it.msg, it.sig, it.key_type) for it in items]


def _oracle(items):
    return [host.verify(it.pubkey, it.msg, it.sig) for it in items]


def _port(**kw) -> bv.BatchVerifier:
    kw.setdefault("shape_registry", ShapeRegistry())
    return bv.BatchVerifier(device="cpu", **kw)


def test_host_path_matches_reference():
    items = _items(5, seed=1)
    port = _port()
    got = port.verify(items)
    want = JaxVerifier().verify(_jax_items(items))
    assert got.tolist() == want.tolist() == _oracle(items)
    assert port._registry.dispatch_count() == 0  # n < 8: never dispatched


@pytest.mark.parametrize("n, bucket", [(7, 8), (20, 32)])
def test_generic_path_matches_reference(n, bucket):
    items = _items(n, seed=n)
    port = _port(min_device_batch=0, table_cache_capacity=2)
    got = port.verify(items)
    ref = JaxVerifier(min_device_batch=0, table_cache_capacity=2)
    want = ref.verify(_jax_items(items))
    assert got.tolist() == want.tolist() == _oracle(items)
    assert any(got) and not all(got)
    assert port._registry.buckets_by_tier() == {"generic": (bucket,)}


def test_small_tier_on_tables_jax_built():
    """The reference verifier builds its tables; convert carries its store
    into the port, which then verifies on it without building a table."""
    items = _items(7, seed=3)
    ref = JaxVerifier(min_device_batch=0)
    want = ref.verify(_jax_items(items))
    assert want.tolist() == _oracle(items)
    port = _port(min_device_batch=0)
    cache = ref._small
    convert.install_table_cache(
        port, dict(cache._idx), np.asarray(cache.tables), np.asarray(cache.valid)
    )
    port._small._build_fn = None  # any table build would fail loudly
    got = port.verify(items)
    assert got.tolist() == want.tolist()
    assert port._registry.buckets_by_tier() == {"small": (8,)}
    assert torch.equal(port._small.tables, torch.from_numpy(np.array(cache.tables)))


def test_small_tier_builds_and_matches_oracle():
    items = _items(20, seed=4)
    port = _port(min_device_batch=0)
    assert port.verify(items).tolist() == _oracle(items)
    assert port._small.tables.shape == (128, 16, 4, 32)
    assert len(port._small._idx) == len({it.pubkey for it in items})


def test_snapshot_retry_then_generic(monkeypatch):
    items = _items(9, seed=5)
    want = _oracle(items)
    port = _port(min_device_batch=0)
    real = port._small.snapshot
    calls = []

    def once(*a):  # the first snapshot misses, as after a concurrent reset
        calls.append(a)
        return None if len(calls) == 1 else real(*a)

    monkeypatch.setattr(port._small, "snapshot", once)
    assert port.verify(items).tolist() == want
    assert len(calls) == 2
    tiers = port._registry.buckets_by_tier()
    assert tiers["small"] == (32,) and "generic" not in tiers
    monkeypatch.setattr(port._small, "snapshot", lambda *a: None)
    assert port.verify(items).tolist() == want
    assert port._registry.buckets_by_tier()["generic"] == (32,)


def test_cache_resets_when_full():
    a, b = _items(8, seed=6), _items(8, seed=7)
    port = _port(min_device_batch=0, table_cache_capacity=6)
    assert port.verify(a).tolist() == _oracle(a)
    first = dict(port._small._idx)
    assert port.verify(b).tolist() == _oracle(b)
    b_keys = {it.pubkey for it in b}
    assert set(port._small._idx) == b_keys
    assert not (set(first) - b_keys) & set(port._small._idx)


def test_mixed_key_partition_and_malformed_rows():
    items = _items(8, seed=8)
    mixed = items[:4] + [bv.SigItem(b"k" * 32, b"m", b"s" * 64, "foo")] + items[4:]
    mixed.append(bv.SigItem(b"\x00" * 31, b"short key", b"\x00" * 64))
    port = _port(min_device_batch=0)
    got = port.verify(mixed)
    ref = JaxVerifier(min_device_batch=0, table_cache_capacity=2)
    assert got.tolist() == _oracle(items[:4]) + [False] + _oracle(items[4:]) + [False]
    assert got.tolist() == ref.verify(_jax_items(mixed)).tolist()


def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        bv.BatchVerifier(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        bv.BatchVerifier(devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="SHA-512"):
        bv.BatchVerifier(device_challenge_min=2048, device="cpu")
    port = _port(min_device_batch=0)
    with pytest.raises(NotImplementedError, match="big tier"):
        port.prepare(_items(1, seed=9) * 600)
    with pytest.raises(NotImplementedError, match="big tier"):
        _port(min_device_batch=0, bigtable_min=32).verify(_items(20, seed=10))
    with pytest.raises(NotImplementedError, match="big tier"):
        port.warm([b"\x01" * 32], bulk=True)
    secp = bv.SigItem(b"\x02" * 33, b"m", b"s" * 64, "secp256k1")
    with pytest.raises(NotImplementedError, match="secp256k1"):
        port.verify([secp])


def test_default_verifier_device_and_env(monkeypatch):
    monkeypatch.setattr(bv, "_default", None)
    if torch.cuda.is_available():
        assert bv.default_verifier().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bv.default_verifier()
    monkeypatch.setattr(bv, "_default", None)
    assert bv.default_verifier(device="cpu").device.type == "cpu"
    monkeypatch.setattr(bv, "_default", None)
    monkeypatch.setenv("TM_TPU_DEVICE_CHALLENGE_MIN", "2048")
    with pytest.raises(NotImplementedError):
        bv.default_verifier(device="cpu")
    monkeypatch.delenv("TM_TPU_DEVICE_CHALLENGE_MIN")
    monkeypatch.setenv("TM_TPU_ICI_PARALLELISM", "4")
    with pytest.raises(NotImplementedError):
        bv.default_verifier(device="cpu")
