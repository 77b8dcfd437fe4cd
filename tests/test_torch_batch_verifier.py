"""The port's BatchVerifier (device="cpu": plain kernel versions) against
the JAX package's BatchVerifier on the CPU backend.

Covered: the host path (n < min_device_batch), the generic path at
buckets 8 and 32 (a table cache too small for the batch), the small tier
on tables that JAX built and crypto/convert carried over, the snapshot
retry, cache reset, the mixed-key partition, the big tier's switches
(``TM_TPU_MXU_GATHER``, the bulk warm, the 2 KiB device-hash cap, the
generic fallback with host challenges; its parity with the reference is in
``test_torch_batch_verifier_big.py``), a mesh verifier and the mesh knobs
of ``default_verifier`` (the mesh path in full is in
``test_torch_mesh.py``); secp256k1 and sr25519 rows of a mixed batch on
the host (the secp256k1 kernel route is in
``test_torch_secp_verify.py``). Tolerance: exact bitmap equality.
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


def test_mesh_verifier_matches_reference():
    """BatchVerifier(mesh=...) verifies: over 8 CPU shards a round of
    mesh_min_rows rows shards over every shard and one row fewer stays on
    one device, both with the JAX package's (meshless) verdicts, the host
    oracle's and the port's 1-device verifier's; a device other than the
    mesh's first raises."""
    from tendermint_tpu_torch.parallel import build_mesh

    mesh = build_mesh(8, 1, "cpu")
    items = _items(16, seed=30)
    port = _port(mesh=mesh, min_device_batch=0, mesh_min_rows=16)
    assert port.device == torch.device("cpu") and port.mesh_devices == 8
    prep = port.prepare(items)
    assert prep.devices == 8 and port.prepare(items[:15]).devices == 1
    got = prep.run().tolist()
    want = JaxVerifier(min_device_batch=0).verify(_jax_items(items)).tolist()
    assert got == want == _oracle(items) == _port(min_device_batch=0).verify(items).tolist()
    assert port._registry.shapes_by_tier()["small"] == ((32, 128, 8),)
    with pytest.raises(ValueError, match="first"):
        bv.BatchVerifier(mesh=mesh, device="meta")


def _other_key_rows(key_type: str) -> list[bv.SigItem]:
    """A valid row, a wrong-message row and a malformed key of key_type."""
    if key_type == "secp256k1":
        from tendermint_tpu_torch.crypto import secp256k1 as mod
    else:
        from tendermint_tpu_torch.crypto import sr25519 as mod
    k = mod.PrivKey.from_secret(b"other-" + key_type.encode())
    pub, sig = k.public_key().data, k.sign(b"m")
    bad_pub = b"\x02" * 33 if key_type == "secp256k1" else b"\x05" * 32
    return [bv.SigItem(pub, b"m", sig, key_type), bv.SigItem(pub, b"m!", sig, key_type),
            bv.SigItem(bad_pub, b"m", b"s" * 64, key_type)]


@pytest.mark.parametrize("key_type", ["secp256k1", "sr25519"])
def test_secp256k1_and_sr25519_rows_match_reference(key_type):
    """secp256k1 and sr25519 rows verify on the host, alone and mixed into
    an ed25519 device batch, with the JAX package's verdicts."""
    port = _port(min_device_batch=0)
    ref = JaxVerifier(min_device_batch=100)
    rows = _other_key_rows(key_type)
    eds = _items(8, seed=9)
    for batch in (rows, eds[:4] + rows + eds[4:]):
        got = port.verify(batch).tolist()
        assert got == ref.verify(_jax_items(batch)).tolist()
    assert got[4:7] == [True, False, False]
    assert got[:4] + got[7:] == _oracle(eds)


def test_mxu_gather_selected_once(monkeypatch):
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    items = _items(9, seed=22)
    monkeypatch.setenv("TM_TPU_MXU_GATHER", "1")
    port = _port(min_device_batch=0, bigtable_min=8)
    monkeypatch.delenv("TM_TPU_MXU_GATHER")
    assert port._big_verify is eb.verify_prehashed_bigcache_mxu
    assert port.verify(items).tolist() == _oracle(items)
    assert _port(bigtable_min=8)._big_verify is eb.verify_prehashed_bigcache


def test_warm_bulk_builds_both_tiers():
    items = _items(9, seed=23)
    keys = list(dict.fromkeys(it.pubkey for it in items))
    port = _port(min_device_batch=0, bigtable_min=8)
    port.warm(keys + [b"\x00" * 31], bulk=True)
    assert set(port._small._idx) == set(port._big._idx) == set(keys)
    port._big._build_fn = None  # warmed: the verify builds nothing
    assert port.verify(items).tolist() == _oracle(items)
    tiers = port._registry.buckets_by_tier()
    assert tiers["build_big"] == (8,) and tiers["big"] == (32,)
    aborted = _port(bigtable_min=8)
    aborted.shutdown_event.set()
    aborted.warm(keys, bulk=True)
    assert not aborted._small._idx and not aborted._big._idx


def test_device_hash_cap_and_generic_fallback():
    """One message past the 2 KiB cap keeps the batch on host hashing; a
    store too small for the batch takes the generic kernel with host
    challenges."""
    items = _items(9, seed=24)
    k = host.PrivKey(b"\x07" * 32)
    long_msg = b"L" * (2048 - 64 + 1)
    items.append(bv.SigItem(k.public_key().data, long_msg, k.sign(long_msg)))
    port = _port(min_device_batch=0, bigtable_min=8, device_challenge_min=0)
    assert port.verify(items).tolist() == _oracle(items)
    assert "big_msgs" not in port._registry.buckets_by_tier()
    assert port.verify(items[:9]).tolist() == _oracle(items[:9])
    assert port._registry.buckets_by_tier()["big_msgs"] == (32,)
    small = _port(min_device_batch=0, bigtable_min=8, device_challenge_min=0,
                  table_cache_capacity=2)
    assert small.verify(items[:9]).tolist() == _oracle(items[:9])
    assert small._registry.buckets_by_tier() == {"generic": (32,)}


def test_is_default_verifier(monkeypatch):
    monkeypatch.setattr(bv, "_default", None)
    port = bv.default_verifier(device="cpu")
    assert bv.is_default_verifier(port) and bv.is_default_verifier(None)
    assert not bv.is_default_verifier(_port())


def test_default_verifier_device_and_env(monkeypatch):
    monkeypatch.setattr(bv, "_default", None)
    if torch.cuda.is_available():
        assert bv.default_verifier().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bv.default_verifier()
    monkeypatch.setattr(bv, "_default", None)
    assert bv.default_verifier(device="cpu").device.type == "cpu"
    assert bv.default_verifier()._device_challenge_min is None
    monkeypatch.setattr(bv, "_default", None)
    monkeypatch.setenv("TM_TPU_DEVICE_CHALLENGE_MIN", "2048")
    assert bv.default_verifier(device="cpu")._device_challenge_min == 2048
    monkeypatch.setattr(bv, "_default", None)
    monkeypatch.delenv("TM_TPU_DEVICE_CHALLENGE_MIN")
    monkeypatch.setenv("TM_TPU_ICI_PARALLELISM", "4")
    monkeypatch.setenv("TM_TPU_MESH_BACKEND", "cpu")
    v = bv.default_verifier(device="cpu")
    assert v.mesh_devices == 4 and v._mesh.axis_names == ("batch",)
    monkeypatch.setattr(bv, "_default", None)
    monkeypatch.setenv("TM_TPU_ICI_PARALLELISM", "16")
    with pytest.raises(ValueError, match="16x1"):
        bv.default_verifier(device="cpu")


def test_warm_validator_sets_in_executor(monkeypatch):
    """The bulk warm of validator sets runs on an executor thread and
    fills the big tier; TM_TPU_SKIP_WARM and empty sets warm nothing."""
    import asyncio

    from tendermint_tpu_torch import types

    monkeypatch.delenv("TM_TPU_SKIP_WARM", raising=False)
    keys = [host.PrivKey(bytes([i + 1]) * 32) for i in range(3)]
    vset = types.ValidatorSet([types.Validator(k.public_key(), 10) for k in keys])
    port = _port()

    async def run():
        fut = bv.warm_validator_sets_in_executor([vset, None], verifier=port)
        await fut
        return bv.warm_validator_sets_in_executor([None], verifier=port)

    assert asyncio.run(run()) is None
    assert set(port._big._idx) == {k.public_key().data for k in keys}
    monkeypatch.setenv("TM_TPU_SKIP_WARM", "1")
    assert bv.warm_validator_sets_in_executor([vset], verifier=_port()) is None
