"""The port's mesh path on the CPU: ``parallel/mesh`` against the JAX
package's ``build_mesh``, and the port's mesh ``BatchVerifier`` (8 CPU
shards, the kernels' plain versions) against the JAX package's host
oracles, its meshless verifier and the port's own 1-device verifier.

Counterparts of ``tests/test_multichip.py`` (``test_build_mesh_axes``,
the mesh verifier's small and big tiers, the cache reset under rotation,
the dcn mesh, the sharded secp256k1 launch) and of
``tests/test_mesh_sharding.py`` (``mesh_min_rows``, uneven tails, a
sharded scheduler round) on small buckets, plus ``TM_TPU_ICI_PARALLELISM=0``
and ``prewarm_buckets``. The JAX package's own mesh programs compile for
minutes on the CPU; they are compared in the slow-marked test at the end
(its ``test_multichip.py`` holds them to the same host oracles).
Tolerance: exact for every verdict and bitmap.
"""

import asyncio
import hashlib
import threading

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519 as jax_ed25519
from tendermint_tpu.crypto import secp256k1 as jax_secp
from tendermint_tpu.crypto.batch_verifier import BatchVerifier as JaxVerifier
from tendermint_tpu.crypto.batch_verifier import SigItem as JaxItem
from tendermint_tpu.parallel import build_mesh as jax_build_mesh
from tendermint_tpu.parallel import mesh_from_env as jax_mesh_from_env
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
from tendermint_tpu_torch.parallel import build_mesh, mesh_from_env
from tendermint_tpu_torch.parallel.mesh import Mesh, shard_rows

N_BASE = 32


def _sig_items(n: int, corrupt=()) -> list[bv.SigItem]:
    """n well-formed rows over distinct keys (the reference test's
    helper), chosen rows' signatures bit-flipped."""
    items = []
    for i in range(n):
        sk = host.PrivKey(bytes([i + 1]) * 32)
        msg = b"mesh-vote-%d" % i
        sig = sk.sign(msg)
        if i in corrupt:
            sig = sig[:50] + bytes([sig[50] ^ 1]) + sig[51:]
        items.append(bv.SigItem(sk.public_key().data, msg, sig))
    return items


_BASE: list = []


def _items(n: int, corrupt=()) -> list[bv.SigItem]:
    """n rows tiled from N_BASE signed rows (test_mesh_sharding's
    helper), chosen rows' signatures bit-flipped."""
    if not _BASE:
        for i in range(N_BASE):
            sk = host.PrivKey.from_secret(b"meshshard-%d" % i)
            msg = b"mesh-vote-%d" % i
            _BASE.append(bv.SigItem(sk.public_key().data, msg, sk.sign(msg)))
    out = list((_BASE * (n // N_BASE + 1))[:n])
    for i in corrupt:
        it = out[i]
        bad = it.sig[:50] + bytes([it.sig[50] ^ 1]) + it.sig[51:]
        out[i] = bv.SigItem(it.pubkey, it.msg, bad)
    return out


def _oracle(items) -> list[bool]:
    """The JAX package's host oracle."""
    return [jax_ed25519.verify(it.pubkey, it.msg, it.sig) for it in items]


def _mesh(n: int = 8) -> Mesh:
    return build_mesh(n, 1, "cpu")


def _verifier(mesh=None, **kw) -> bv.BatchVerifier:
    kw.setdefault("shape_registry", ShapeRegistry())
    kw.setdefault("min_device_batch", 0)
    return bv.BatchVerifier(mesh=mesh, device="cpu", **kw)


def _check(v_mesh, items, want, **solo_kw) -> list[bool]:
    """The mesh verifier's bitmap: the wanted one, the JAX host oracle's
    and the port's 1-device verifier's."""
    got = v_mesh.verify(items).tolist()
    assert got == want == _oracle(items)
    assert got == _verifier(**solo_kw).verify(items).tolist()
    return got


def test_build_mesh_axes():
    """build_mesh on the CPU backend: the JAX package's shapes and axes,
    and its error on an unsatisfiable request."""
    assert build_mesh(1, 1, "cpu") is None and jax_build_mesh(1, 1, "cpu") is None
    for ici, dcn in ((8, 1), (4, 2), (0, 2), (0, 1), (2, 1)):
        m, ref = build_mesh(ici, dcn, "cpu"), jax_build_mesh(ici, dcn, "cpu")
        assert m.axis_names == ref.axis_names
        assert m.devices.shape == ref.devices.shape
        assert m.shape == dict(ref.shape)
        assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert build_mesh(8, 1, "cpu").axis_names == ("batch",)
    assert build_mesh(4, 2, "cpu").devices.shape == (2, 4)
    for args in ((16, 4, "cpu"), (16, 1, "cpu")):
        with pytest.raises(ValueError):
            jax_build_mesh(*args)
        with pytest.raises(ValueError):
            build_mesh(*args)
    with pytest.raises(ValueError):
        build_mesh(2, 1, "tpu")
    # the cuda backend counts real cards and never repeats one
    n = torch.cuda.device_count()
    with pytest.raises(ValueError):
        build_mesh(n + 2, 1, "cuda")
    m = build_mesh(0, 1, "cuda")
    assert (m is None) == (n <= 1)
    # a mesh by hand may repeat a device; its grid must match its axes
    m = Mesh(["cpu"] * 8)
    assert m.size == 8 and m.shape == {"batch": 8}
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 8, ("dcn", "batch"))


def test_ici_zero_means_every_device(monkeypatch):
    """TM_TPU_ICI_PARALLELISM=0 (what [scheduler] mesh_enable exports)
    builds a mesh over every visible device, as the JAX package's
    mesh_from_env does; unset axes build none."""
    for var in ("TM_TPU_ICI_PARALLELISM", "TM_TPU_DCN_PARALLELISM", "TM_TPU_MESH_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_from_env() is None and jax_mesh_from_env() is None
    monkeypatch.setenv("TM_TPU_MESH_BACKEND", "cpu")
    monkeypatch.setenv("TM_TPU_ICI_PARALLELISM", "0")
    m, ref = mesh_from_env(), jax_mesh_from_env()
    assert m.devices.shape == ref.devices.shape == (8,)
    monkeypatch.setenv("TM_TPU_DCN_PARALLELISM", "2")
    m, ref = mesh_from_env(), jax_mesh_from_env()
    assert m.devices.shape == ref.devices.shape == (2, 4)
    assert m.axis_names == ref.axis_names == ("dcn", "batch")
    # one visible card: ici=0 is the 1-device path, not a 1-entry mesh
    monkeypatch.setenv("TM_TPU_DCN_PARALLELISM", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("TM_TPU_MESH_BACKEND", "cuda")
    assert mesh_from_env() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = mesh_from_env()
    assert [str(d) for d in m.devices.flat] == [f"cuda:{i}" for i in range(4)]


def test_batch_verifier_mesh_small_tier():
    """Small tier over 8 shards, replicated (below mesh_min_rows, the
    reference's default) and sharded, twice each (the second on cached
    tables)."""
    items = _sig_items(16, corrupt=(2, 9))
    want = [i not in (2, 9) for i in range(16)]
    for rows, devices in ((1024, 1), (1, 8)):
        v = _verifier(_mesh(), mesh_min_rows=rows)
        assert v.prepare(items).devices == devices
        _check(v, items, want)
        assert v.verify(items).tolist() == want
        assert v._registry.shapes_by_tier()["small"] == ((32, 128, devices),)
        assert v._registry.shapes_by_tier()["build_small"] == ((32, 0, 8),)


def test_batch_verifier_mesh_bigcache_tier():
    """The big tier sharded (bigtable_min lowered to 8) after a bulk
    warm: the tables are built over the 8 shards and installed in one
    store (one distinct device)."""
    items = _sig_items(16, corrupt=(5,))
    v = _verifier(_mesh(), bigtable_min=8, mesh_min_rows=1)
    v.warm([it.pubkey for it in items], bulk=True)
    assert len(v._big.stores()) == 1 and v._big.tables.shape == (128, 64, 16, 4, 32)
    _check(v, items, [i != 5 for i in range(16)], bigtable_min=8)
    tiers = v._registry.shapes_by_tier()
    assert tiers["big"] == ((32, 128, 8),) and tiers["build_big"] == ((32, 0, 8),)


def test_table_copies_per_distinct_device():
    """A mesh over two distinct devices keeps one full store per device,
    equal byte for byte, through growth and a reset; the table rows are
    those of a meshless build."""
    def build(pub):  # shards on "meta" hold no data: build on the CPU
        return torch.full((pub.shape[0], 2), 7, dtype=torch.uint8), torch.ones(
            pub.shape[0], dtype=torch.bool)

    mesh = Mesh([torch.device("cpu"), torch.device("meta")] * 2)
    cache = bv._TableCache(threading.Lock(), build, (2,), 8, torch.device("cpu"), mesh=mesh)
    assert cache._devices == [torch.device("cpu"), torch.device("meta")]
    keys = [bytes([i + 1]) * 32 for i in range(5)]
    assert cache.ensure(keys)
    stores = cache.stores()
    assert stores[torch.device("meta")][0].shape == stores[torch.device("cpu")][0].shape
    assert cache.tables.shape == (8, 2) and cache.valid[:5].all()
    assert (cache.tables[:5] == 7).all() and not cache.valid[5:].any()
    fresh = [bytes([9 + i]) * 32 for i in range(4)]
    assert cache.ensure(fresh)  # past capacity: reset
    assert list(cache._idx) == fresh
    assert all(t.shape == (8, 2) for t, _ in cache.stores().values())


def test_batch_verifier_mesh_cache_reset_rotation():
    """Rotation past capacity resets the store while another thread
    warms, without a wrong verdict; the first set still verifies."""
    v = _verifier(_mesh(), table_cache_capacity=16, mesh_min_rows=1)
    gen1 = _sig_items(12)
    gen2 = _sig_items(24, corrupt=(20,))[12:]  # 12 fresh keys, one bad row
    assert v.verify(gen1).all()
    errs = []

    def _warm():
        try:
            v.warm([it.pubkey for it in gen2])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=_warm)
    t.start()
    out = v.verify(gen2)
    t.join()
    assert not errs
    want = [i != 8 for i in range(12)]
    assert out.tolist() == want == _oracle(gen2)
    _check(v, gen1, [True] * 12)


def test_batch_verifier_dcn_mesh():
    """A 2-axis ("dcn", "batch") mesh shards over every axis."""
    mesh = build_mesh(4, 2, "cpu")
    v = _verifier(mesh, mesh_min_rows=1)
    assert v._nshards == v.mesh_devices == 8
    items = _sig_items(16, corrupt=(1, 14))
    _check(v, items, [i not in (1, 14) for i in range(16)])


def test_mesh_min_rows_keeps_small_rounds_single_device(monkeypatch):
    """Below mesh_min_rows a round prepares with devices=1, at or above it
    with the whole mesh; TM_TPU_MESH_MIN_ROWS sets the default, unset or
    0 the built-in one."""
    monkeypatch.delenv("TM_TPU_MESH_MIN_ROWS", raising=False)
    v = _verifier(_mesh(4), bigtable_min=1 << 30, mesh_min_rows=1024)
    assert v.mesh_devices == 4
    assert [v.shards_for(n) for n in (1, 1023, 1024)] == [1, 1, 4]
    assert v.prepare(_items(16)).devices == 1
    assert v.prepare(_items(1024)).devices == 4
    monkeypatch.setenv("TM_TPU_MESH_MIN_ROWS", "64")
    v2 = _verifier(_mesh(4))
    assert v2.shards_for(63) == 1 and v2.shards_for(64) == 4
    for raw in ("0", ""):
        monkeypatch.setenv("TM_TPU_MESH_MIN_ROWS", raw)
        assert _verifier(_mesh(4))._mesh_min_rows == bv.DEFAULT_MESH_MIN_ROWS
    monkeypatch.delenv("TM_TPU_MESH_MIN_ROWS")
    v3 = _verifier(_mesh(4))
    assert v3._mesh_min_rows == bv.DEFAULT_MESH_MIN_ROWS and v3.shards_for(16) == 1
    assert _verifier().shards_for(1 << 20) == 1  # meshless


def test_uneven_tail_pads_per_device():
    """n not a multiple of the shard count: the bucket rounds up to a
    multiple of 4 and the padding never moves a real verdict."""
    v = _verifier(_mesh(4), bigtable_min=1 << 30, mesh_min_rows=1)
    solo = _verifier(bigtable_min=1 << 30)
    for n in (9, 13, 35):
        corrupt = sorted({0, n // 2, n - 1})
        items = _items(n, corrupt=corrupt)
        got = v.verify(items).tolist()
        assert got == [i not in corrupt for i in range(n)] == _oracle(items)
        assert got == solo.verify(items).tolist()
        b = v._registry.bucket_for(n, multiple_of=4)
        assert b % 4 == 0 and b >= n
    assert {d for _, _, d in v._registry.shapes_by_tier()["small"]} == {4}


def test_scheduler_round_dispatches_sharded():
    """Two classes' submissions coalesce into one sharded round: the
    dispatch log, the ledger and the metrics carry sharded/devices, and
    the verify_mesh_devices gauge reads the mesh."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel.scheduler import VerifyScheduler

    v = _verifier(_mesh(4), bigtable_min=1 << 30, mesh_min_rows=1)
    v.warm([it.pubkey for it in _items(N_BASE)])
    metrics = SchedulerMetrics(Registry("mesh_test"))
    ledger = DispatchLedger()
    s = VerifyScheduler(v, max_batch=16384, metrics=metrics, ledger=ledger)
    items_a = _items(48)
    items_b = _items(16, corrupt=(3,))

    async def run():
        await s.start()
        # occupy the device so the next two coalesce into one round
        first = asyncio.create_task(s.submit(_items(8), "consensus"))
        await asyncio.sleep(0.01)
        a, b = await asyncio.gather(
            s.submit(items_a, "consensus"), s.submit(items_b, "blocksync")
        )
        await first
        await s.stop()
        return a, b

    a, b = asyncio.run(run())
    assert np.asarray(a).all() and _oracle(items_a) == [True] * 48
    assert np.asarray(b).tolist() == [i != 3 for i in range(16)] == _oracle(items_b)
    assert metrics.mesh_devices.value() == 4
    sharded = [d for d in s.dispatch_log if d.get("sharded")]
    assert sharded and sharded[-1]["devices"] == 4
    assert metrics.dispatch_sharded.value() >= 1
    rounds = [e for e in ledger.entries() if e["sharded"]]
    assert rounds and all(e["devices"] == 4 for e in rounds)
    coalesced = [e for e in rounds if len(e["classes"]) == 2]
    assert coalesced and coalesced[0]["rows"] == {"consensus": 48, "blocksync": 16}


def test_prewarm_buckets_per_device_variant():
    """prewarm_buckets launches each rung once per reachable device
    variant, allocates every store, and returns the reference's entries;
    the meshless verifier prewarms devices=1 only."""
    reg = ShapeRegistry(ladder=(8, 16))
    v = _verifier(_mesh(4), mesh_min_rows=16, shape_registry=reg)
    out = v.prewarm_buckets()
    assert [(e["tier"], e["bucket"], e["devices"]) for e in out] == [
        ("small", 8, 1), ("generic", 8, 1),
        ("small", 16, 1), ("generic", 16, 1),
        ("small", 16, 4), ("generic", 16, 4),
    ]
    assert all(set(e) == {"tier", "bucket", "rows", "devices", "seconds"} for e in out)
    assert {e["rows"] for e in out if e["tier"] == "small"} == {128}
    assert v._small.tables.shape[0] == v._big.tables.shape[0] == 128
    solo = _verifier(shape_registry=ShapeRegistry(ladder=(8,)))
    assert [(e["tier"], e["devices"]) for e in solo.prewarm_buckets()] == [
        ("small", 1), ("generic", 1)]
    aborted = _verifier(_mesh(4), shape_registry=ShapeRegistry(ladder=(8,)))
    aborted.shutdown_event.set()
    assert aborted.prewarm_buckets() == []
    with pytest.raises(ValueError):
        solo.prewarm_buckets(tiers=("nope",))


def _secp_rows(n: int, bad: int):
    """n prepared secp256k1 rows (test_multichip's), row `bad` checked
    against another message's digest; and the JAX host oracle's verdicts."""
    from tendermint_tpu_torch.crypto import secp256k1 as secp
    from tendermint_tpu_torch.crypto.secp_native import prep_digest_item
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk

    fe = sk.fe
    qx = np.zeros((n, fe.NLIMBS), dtype=np.int32)
    qy = np.zeros((n, fe.NLIMBS), dtype=np.int32)
    u1, u2, rb = (np.zeros((n, 32), dtype=np.uint8) for _ in range(3))
    ok = np.zeros(n, dtype=bool)
    want = []
    for i in range(n):
        pv = secp.PrivKey.from_secret(b"mesh-secp-%d" % i)
        msg = b"mesh-msg-%d" % i
        sig = pv.sign(msg)
        if i == bad:
            msg = b"mesh-msg-tampered"
        want.append(jax_secp.PubKey(pv.public_key().data).verify(msg, sig))
        _r, pt, u1v, u2v = prep_digest_item(
            pv.public_key().data, hashlib.sha256(msg).digest(), sig)
        qx[i], qy[i] = fe.from_int(pt[0]), fe.from_int(pt[1])
        u1[i] = np.frombuffer(u1v.to_bytes(32, "big"), np.uint8)
        u2[i] = np.frombuffer(u2v.to_bytes(32, "big"), np.uint8)
        rb[i] = np.frombuffer(sig[:32], np.uint8)
        ok[i] = True
    return (qx, qy, u1, u2, rb, ok), want


def test_secp_verify_sharded():
    """The secp256k1 kernel's wrapper over 4 shards (shard_rows, as the
    mesh verify families launch; each shard costs a full plain ladder on
    the CPU, so 4 and not 8): the JAX host oracle's bitmap and the
    unsharded launch's."""
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk

    torch.set_num_threads(1)  # thousands of small tensor operations
    arrays, want = _secp_rows(8, bad=6)
    assert want == [i != 6 for i in range(8)]
    got = shard_rows(sk.verify_prehashed, _mesh(4), arrays)
    assert got.tolist() == want
    assert sk.verify_prehashed(*(torch.from_numpy(a) for a in arrays)).tolist() == want
    with pytest.raises(ValueError, match="split"):
        shard_rows(sk.verify_prehashed, _mesh(4), tuple(a[:7] for a in arrays))


@pytest.mark.slow
def test_mesh_verifier_matches_jax_mesh_programs():
    """Against the JAX package's mesh programs on its 8-device CPU mesh:
    its sharded BatchVerifier (small tier, mesh_min_rows=1) and its
    sharded secp256k1 jit equal the port's 8-shard results."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tendermint_tpu.ops import secp256k1_kernel as jsk
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk

    jmesh = JaxMesh(np.array(jax.devices("cpu")[:8]), ("batch",))
    items = _sig_items(16, corrupt=(2, 9))
    ref = JaxVerifier(mesh=jmesh, min_device_batch=0, mesh_min_rows=1)
    want = ref.verify([JaxItem(it.pubkey, it.msg, it.sig) for it in items]).tolist()
    assert _verifier(_mesh(), mesh_min_rows=1).verify(items).tolist() == want
    arrays, _ = _secp_rows(8, bad=6)
    sh = NamedSharding(jmesh, P("batch"))
    fn = jax.jit(jsk.verify_prehashed, in_shardings=(sh,) * 6,
                 out_shardings=NamedSharding(jmesh, P()))
    jax_out = np.asarray(fn(*(jax.device_put(a, sh) for a in arrays)))
    assert shard_rows(sk.verify_prehashed, _mesh(), arrays).tolist() == jax_out.tolist()
