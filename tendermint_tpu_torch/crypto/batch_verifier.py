"""Host orchestration of batched ed25519 verification on the CUDA kernels.

Counterpart of ``tendermint_tpu/crypto/batch_verifier.py``: call sites push
(pubkey, msg, sig) triples and get an accept bitmap back. What carries
over unchanged:

- per-item host work: the challenge k = SHA-512(R || A || M) mod L and the
  s < L range check; bulk batches (``device_challenge_min``) instead hash
  on the card (``ops/sha512.challenge_batch``, fused before the verify);
- shape discipline: batches pad to the bucket ladder of
  ``crypto/shape_registry`` (padding rows have ``s_ok`` False and
  ``idx = -1``, so they are rejected without a table read);
- the validator-table cache, in two tiers with separate locks. Small
  (vote-sized) batches use radix-16 window tables (2 KiB of canonical
  bytes per key) built by ``neg_pubkey_table``; batches whose bucket
  reaches ``bigtable_min`` use doubling-free 64 x 16 fixed-window tables
  (128 KiB per key) built by ``neg_pubkey_bigtable`` in chunks of 512
  keys. Each store is kept on the card, grown in powers of two, reset when
  full; a batch a store cannot hold takes the generic kernel (with host
  challenges), and a row evicted between ``ensure`` and ``snapshot`` by a
  concurrent verify gets one retry first;
- ``TM_TPU_MXU_GATHER=1`` selects ``verify_prehashed_bigcache_mxu`` for
  the big tier, read once at construction;
- the ``prepare()``/``run()`` split: ``prepare`` is host-only (no tensor
  reaches the card before ``run``), so the dispatch scheduler's prep
  thread overlaps its dispatch thread;
- the host crossover ``min_device_batch`` and the mixed-key partition:
  ed25519 rows ride the device batch; secp256k1 rows go to the secp256k1
  kernel (``ops/secp256k1_kernel``, host prep by
  ``secp_native.prep_digest_item``) when ``TM_TPU_SECP_DEVICE=1`` and
  there are at least 32 of them, else to the native host batch
  (``secp_native.verify_msgs_batch``), as in the JAX package; sr25519
  rows verify on the host;
- an optional device mesh (``parallel/mesh.Mesh``): rounds of at least
  ``mesh_min_rows`` rows are row-sharded over every mesh device (the
  bucket rounded up to a multiple of the device count, the pad rows
  verdict-inert), chunk i launched on ``mesh.devices.flat[i]`` against
  that device's copy of the table store, every shard launched before any
  verdict is read, the verdicts gathered in shard order
  (``parallel/mesh.shard_rows``); smaller rounds run on the mesh's first
  device alone, as without a mesh. Table builds always shard over the
  mesh, and their rows go to one store per distinct device.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..obs import default_tracer
from ..ops import ed25519_batch
from .ed25519 import L, challenge
from .shape_registry import ShapeRegistry, default_shape_registry

# max rows of each device-resident table store (small tier 2 KiB/key, big
# tier 128 KiB/key; both grow lazily, so the cap bounds only the worst case)
TABLE_CACHE_CAPACITY = 4096

# batches whose bucket reaches this size use the big (doubling-free) tier
BIGTABLE_MIN = 512

# batches below this row count stay on one device even under a mesh: a
# sharded round pays its split and gather, which only bulk rounds repay.
# 1024 keeps every vote-path bucket (8..512) on one device and shards the
# bulk rungs (2048+). Override with TM_TPU_MESH_MIN_ROWS.
DEFAULT_MESH_MIN_ROWS = 1024

# initial allocated rows of the lazy table stores
_TABLE_ROWS_MIN = 128

# one message longer than this (with R || A) keeps the batch on host
# hashing: the device buffer pads every row to the longest one's blocks
_DEVICE_HASH_MAX_BYTES = 2048

# secp256k1 rows of a mixed batch take the kernel under TM_TPU_SECP_DEVICE=1
# from this many rows on (the JAX package's gate)
SECP_DEVICE_MIN = 32


@dataclass(frozen=True)
class SigItem:
    pubkey: bytes  # 32 bytes (ed25519) or 33 bytes (secp256k1 compressed)
    msg: bytes
    sig: bytes  # 64 bytes
    key_type: str = "ed25519"


class _PreparedBatch:
    """Host-assembled batch whose device dispatch is deferred; ``run()``
    blocks for the verdict bitmap (len == n). ``devices`` is the mesh
    shard count of the dispatch (1 = one device); the scheduler stamps
    its round with it."""

    __slots__ = ("n", "run", "devices")

    def __init__(self, n: int, run, devices: int = 1):
        self.n = n
        self.run = run
        self.devices = devices


def _use_mxu_gather() -> bool:
    """TM_TPU_MXU_GATHER=1 selects the big tier's one-hot-gather variant.
    Read once, at BatchVerifier construction."""
    return os.environ.get("TM_TPU_MXU_GATHER") == "1"


def _store_rows(stores: dict) -> int:
    """The allocated rows of a table store (every copy has the same)."""
    return int(next(iter(stores.values()))[0].shape[0])


class _TableCache:
    """One device-resident table store (pubkey -> row), lazily grown.

    Under a mesh, builds shard the pubkeys over every shard device and
    their rows are installed in one full copy of the store per distinct
    device (``stores()``), kept in step through growth and resets;
    ``tables``/``valid`` are the first device's copy.

    All methods take the store's lock: a vote micro-batcher may call
    verify() from an executor thread while the event loop verifies."""

    def __init__(self, lock, build_fn, entry_shape, capacity, device,
                 registry=None, tier="build", mesh=None):
        self._lock = lock
        self._build_fn = build_fn
        self._entry_shape = tuple(entry_shape)  # per-key dims after the row
        self._capacity = capacity
        self._registry = registry or default_shape_registry()
        self._tier = tier
        self._shards = [device] if mesh is None else list(mesh.devices.flat)
        self._devices = list(dict.fromkeys(self._shards))
        self._idx: dict[bytes, int] = {}
        # per distinct device: [tables [rows, *entry_shape] u8, valid [rows]]
        self._copies: list[list] = [[None, None] for _ in self._devices]

    @property
    def tables(self) -> torch.Tensor | None:
        return self._copies[0][0]

    @tables.setter
    def tables(self, t) -> None:
        self._copies[0][0] = t

    @property
    def valid(self) -> torch.Tensor | None:
        return self._copies[0][1]

    @valid.setter
    def valid(self, v) -> None:
        self._copies[0][1] = v

    def stores(self) -> dict:
        """device -> (tables, valid) of each copy."""
        return {d: tuple(c) for d, c in zip(self._devices, self._copies)}

    def _grow(self, needed_rows: int) -> None:
        rows = _TABLE_ROWS_MIN
        while rows < needed_rows:
            rows *= 2
        rows = min(rows, max(1, self._capacity))
        cur = 0 if self.tables is None else self.tables.shape[0]
        if rows <= cur:
            return
        for d, copy in zip(self._devices, self._copies):
            tables = torch.zeros(
                (rows, *self._entry_shape), dtype=torch.uint8, device=d
            )
            valid = torch.zeros(rows, dtype=torch.bool, device=d)
            if cur:
                tables[:cur] = copy[0]
                valid[:cur] = copy[1]
            copy[:] = [tables, valid]

    def allocate(self) -> None:
        """Allocate every copy at its initial size (prewarm)."""
        with self._lock:
            self._grow(_TABLE_ROWS_MIN)

    def _build(self, chunk: list[bytes]):
        """Build a chunk's tables sharded over the shard devices; returns
        per-shard (tables, valid), each shard launched before any is read."""
        nshards = len(self._shards)
        b = self._registry.bucket_for(len(chunk), multiple_of=nshards)
        self._registry.record_dispatch(self._tier, b, devices=nshards)
        arr = np.zeros((b, 32), dtype=np.uint8)
        for i, pk in enumerate(chunk):
            arr[i] = np.frombuffer(pk, dtype=np.uint8)
        c = b // nshards
        return [
            self._build_fn(torch.from_numpy(arr[i * c : (i + 1) * c]).to(d))
            for i, d in enumerate(self._shards)
        ]

    def ensure(self, pubkeys: list[bytes], abort=None) -> bool:
        """Build + install tables for unseen pubkeys. Returns False when
        the batch alone exceeds capacity; resets the store when full.
        `abort` (threading.Event) stops between 512-key chunks."""
        with self._lock:
            new = list(dict.fromkeys(pk for pk in pubkeys if pk not in self._idx))
            if not new:
                return True
            if len(self._idx) + len(new) > self._capacity:
                uniq = list(dict.fromkeys(pubkeys))
                if len(uniq) > self._capacity:
                    return False
                # fresh tensors, not an in-place wipe: a concurrent verify
                # may still hold a snapshot of the old store
                self._idx.clear()
                self._copies = [[None, None] for _ in self._devices]
                new = uniq
            self._grow(len(self._idx) + len(new))
            # chunked builds: a big-tier chunk of 512 keys is 64 MiB of table
            for lo in range(0, len(new), 512):
                if abort is not None and abort.is_set():
                    return True  # partial warm is fine; ensure is idempotent
                chunk = new[lo : lo + 512]
                parts = self._build(chunk)
                rows = []
                for pk in chunk:
                    self._idx[pk] = len(self._idx)
                    rows.append(self._idx[pk])
                for d, copy in zip(self._devices, self._copies):
                    rows_t = torch.tensor(rows, dtype=torch.int64, device=d)
                    for k in (0, 1):
                        piece = [part[k].to(d) for part in parts]
                        whole = piece[0] if len(piece) == 1 else torch.cat(piece)
                        copy[k][rows_t] = whole[: len(chunk)]
            return True

    def snapshot(self, row_pubkeys: list[tuple[int, bytes]], b: int):
        """(stores, idx[b]) for the (row, pubkey) pairs, or None if a
        pubkey was concurrently evicted (the caller retries)."""
        with self._lock:
            idx = np.full(b, -1, dtype=np.int32)
            for i, pk in row_pubkeys:
                row = self._idx.get(pk)
                if row is None:
                    return None
                idx[i] = row
            return self.stores(), idx


class BatchVerifier:
    """Batched ed25519 verifier on one CUDA device or a mesh of them (or,
    with ``device="cpu"``, on the kernels' plain PyTorch versions)."""

    def __init__(
        self,
        mesh=None,
        min_device_batch: int = 8,
        table_cache_capacity: int = TABLE_CACHE_CAPACITY,
        device_challenge_min: int | None = None,
        bigtable_min: int = BIGTABLE_MIN,
        shape_registry: ShapeRegistry | None = None,
        mesh_min_rows: int | None = None,
        device: str | torch.device | None = None,
    ):
        """min_device_batch: below this size the host verifies serially.
        device_challenge_min: big-tier batches of at least this many rows
        hash their challenges on the card (None: always on the host).
        bigtable_min: buckets at or above it use the big tier.
        mesh: a ``parallel.mesh.Mesh``; rounds of at least mesh_min_rows
        rows (None reads TM_TPU_MESH_MIN_ROWS, unset or 0 meaning
        DEFAULT_MESH_MIN_ROWS) shard over it.
        device: "cuda" (default) or "cpu"; CUDA absent raises. Under a
        mesh it defaults to the mesh's first device, and another raises."""
        if mesh is not None:
            first = mesh.devices.flat[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first, {first}")
            device = first
        self.device = resolve(device)
        self._mesh = mesh
        self._nshards = 1 if mesh is None else mesh.size
        if mesh_min_rows is None:
            raw = os.environ.get("TM_TPU_MESH_MIN_ROWS", "")
            mesh_min_rows = (
                int(raw) if raw.strip() and int(raw) > 0 else DEFAULT_MESH_MIN_ROWS
            )
        self._mesh_min_rows = max(1, int(mesh_min_rows))
        self._min_device_batch = min_device_batch
        self._registry = shape_registry or default_shape_registry()
        self._device_challenge_min = device_challenge_min
        self._bigtable_min = bigtable_min
        self._big_verify = (
            ed25519_batch.verify_prehashed_bigcache_mxu
            if _use_mxu_gather()
            else ed25519_batch.verify_prehashed_bigcache
        )
        # set by the node on stop: the default abort of every warm
        self.shutdown_event = threading.Event()
        # independent locks: a big-tier build must not stall small-tier
        # vote-path verifies
        self._small = _TableCache(
            threading.Lock(),
            ed25519_batch.neg_pubkey_table,
            (16, 4, 32),
            table_cache_capacity,
            self.device,
            registry=self._registry,
            tier="build_small",
            mesh=mesh,
        )
        self._big = _TableCache(
            threading.Lock(),
            ed25519_batch.neg_pubkey_bigtable,
            (64, 16, 4, 32),
            table_cache_capacity,
            self.device,
            registry=self._registry,
            tier="build_big",
            mesh=mesh,
        )

    # --- mesh topology -----------------------------------------------------

    @property
    def mesh_devices(self) -> int:
        """Devices in the verifier's mesh (1 = meshless)."""
        return self._nshards

    def shards_for(self, n: int) -> int:
        """Devices a batch of `n` rows shards over: the whole mesh from
        mesh_min_rows rows on, else 1 (the round stays on one device). The
        scheduler stamps rounds `sharded` by it; prewarm_buckets
        enumerates the reachable variants with it."""
        if self._nshards <= 1 or n < self._mesh_min_rows:
            return 1
        return self._nshards

    # --- table cache -------------------------------------------------------

    def warm(
        self,
        pubkeys: list[bytes],
        bulk: bool = False,
        key_types: list[str] | None = None,
        abort=None,
    ) -> None:
        """Pre-build tables for a validator set; bulk=True also builds the
        big tier ahead of a known replay. key_types (aligned with pubkeys)
        filters to ed25519 rows; `abort` stops between chunks."""
        if key_types is not None:
            eds = [
                pk
                for pk, t in zip(pubkeys, key_types)
                if t == "ed25519" and len(pk) == 32
            ]
        else:
            eds = [pk for pk in pubkeys if len(pk) == 32]
        if abort is None:
            abort = self.shutdown_event
        self._small.ensure(eds, abort=abort)
        if bulk and not abort.is_set():
            self._big.ensure(eds, abort=abort)

    def prewarm_buckets(
        self,
        buckets=None,
        tiers: tuple[str, ...] = ("small", "big", "generic"),
        abort=None,
    ) -> list[dict]:
        """Pay the first-use costs ahead of a (re)started node's first
        rounds: the kernels' first build, each table store allocated on
        each device, and one launch per (tier, bucket, devices) that
        steady state can dispatch, on all-rejected rows (zeros, ``s_ok``
        False). The small/big split follows ``bigtable_min``; the cached
        tiers launch against the live stores. Under a mesh each rung
        launches once per reachable device variant: devices=1 where a
        batch below mesh_min_rows can land in it, devices=N where one at
        or above it can. The big_msgs tier (device_challenge_min) is also
        shaped by message length and is not prewarmed.

        Returns one {tier, bucket, rows, devices, seconds} entry per
        launch. `abort` (default: the shutdown flag) stops between
        launches."""
        if abort is None:
            abort = self.shutdown_event
        ladder = tuple(buckets) if buckets else self._registry.ladder
        for cache in (self._small, self._big):
            cache.allocate()
        stores = {"small": self._small.stores(), "big": self._big.stores()}
        kernels = {
            "small": ed25519_batch.verify_prehashed_table,
            "big": self._big_verify,
            "generic": ed25519_batch.verify_prehashed,
        }
        out: list[dict] = []
        seen: set[tuple[str, int, int]] = set()
        rungs = sorted({int(b) for b in ladder})
        for i, raw_b in enumerate(rungs):
            prev_rung = rungs[i - 1] if i else 0
            # a batch of n rows lands on this rung when prev_rung < n <=
            # raw_b: one device is reachable iff some such n is below
            # mesh_min_rows, the whole mesh iff some such n reaches it
            variants = []
            if self._nshards <= 1 or prev_rung + 1 < self._mesh_min_rows:
                variants.append(1)
            if self._nshards > 1 and raw_b >= self._mesh_min_rows:
                variants.append(self._nshards)
            for devs in variants:
                b = self._registry.bucket_for(raw_b, multiple_of=devs)
                zeros32 = np.zeros((b, 32), dtype=np.uint8)
                idx = np.zeros(b, dtype=np.int32)
                s_ok = np.zeros(b, dtype=bool)
                bucket_tier = "big" if b >= self._bigtable_min else "small"
                for tier in tiers:
                    if abort.is_set():
                        return out
                    if tier not in kernels:
                        raise ValueError(f"unknown prewarm tier {tier!r}")
                    if tier != "generic" and tier != bucket_tier:
                        continue  # steady state never runs this shape
                    if (tier, b, devs) in seen:
                        continue  # rungs that collapse after rounding
                    seen.add((tier, b, devs))
                    # the generic kernel takes pubkeys where the cached
                    # tiers take the store and row indices
                    generic = tier == "generic"
                    t0 = time.perf_counter()
                    self._dispatch(
                        kernels[tier], tier, b, b,
                        None if generic else stores[tier],
                        (zeros32 if generic else idx, zeros32, zeros32, zeros32, s_ok),
                        devices=devs,
                    )
                    rows = 0 if generic else _store_rows(stores[tier])
                    out.append({
                        "tier": tier,
                        "bucket": int(b),
                        "rows": rows,
                        "devices": devs,
                        "seconds": round(time.perf_counter() - t0, 3),
                    })
        return out

    # --- verification ------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dispatch(self, fn, tier: str, b: int, n: int, stores, rows,
                  devices: int = 1) -> np.ndarray:
        """Run one kernel wrapper over a round's `rows` (numpy operands
        with the batch axis first) and block for the verdicts, traced as
        ``crypto.device_execute``. `stores` (device -> (tables, valid))
        precede the rows for the cached tiers, None for the generic one.
        devices=1 launches on this verifier's device; devices=N shards the
        rows over the mesh (``parallel/mesh.shard_rows``)."""
        from ..parallel.mesh import shard_rows

        table_rows = 0 if stores is None else _store_rows(stores)
        self._registry.record_dispatch(tier, b, table_rows, devices=devices)
        targets = list(self._mesh.devices.flat) if devices > 1 else [self.device]
        tracer = default_tracer()
        t0 = time.perf_counter()
        # blocks until every shard's verdicts are on the host
        out = shard_rows(
            fn, targets, rows, None if stores is None else stores.__getitem__
        )
        if tracer.enabled:
            tracer.add_span(
                "crypto.device_execute",
                t0,
                time.perf_counter() - t0,
                batch=n,
                bucket=b,
                tier=tier,
                devices=devices,
            )
        return out

    def verify(self, items: list[SigItem]) -> np.ndarray:
        """Bool accept bitmap aligned with `items`."""
        return self.prepare(items).run()

    def _verify_mixed(self, items: list[SigItem], other_idx: list[int]):
        """Mixed-key partition (a validator set of ed25519 and secp256k1
        keys, reference crypto/secp256k1/secp256k1.go:192): ed25519 rows
        ride the device batch, secp256k1 rows the secp256k1 kernel or the
        native host batch, other types verify on the host, and the bitmap
        is re-interleaved."""
        out = np.zeros(len(items), dtype=bool)
        ed_idx = [i for i, it in enumerate(items) if it.key_type == "ed25519"]
        if ed_idx:
            out[ed_idx] = self.verify([items[i] for i in ed_idx])
        secp_idx = [i for i in other_idx if items[i].key_type == "secp256k1"]
        if secp_idx:
            secp = [items[i] for i in secp_idx]
            if (
                os.environ.get("TM_TPU_SECP_DEVICE") == "1"
                and len(secp) >= SECP_DEVICE_MIN
            ):
                out[secp_idx] = self._verify_secp_device(secp)
            else:
                from . import secp_native

                out[secp_idx] = secp_native.verify_msgs_batch(
                    [it.pubkey for it in secp],
                    [it.msg for it in secp],
                    [it.sig for it in secp],
                )
        for i in other_idx:
            if items[i].key_type != "secp256k1":
                out[i] = self._verify_host_other(items[i])
        return out

    def _verify_secp_device(self, items: list[SigItem]) -> np.ndarray:
        """secp256k1 rows on the kernel: the host does parse, low-S,
        u1/u2 and decompression (``secp_native.prep_digest_item``, the half
        both routes share), the card the joint ladder, on this verifier's
        device. Rows pad to the shape registry's ladder; a row the host
        rejects, and every padding row, has ``ok_in`` False."""
        import hashlib

        from ..ops import secp256k1_kernel as sk
        from . import secp_native

        n = len(items)
        b = self._registry.bucket_for(n)
        qx = np.zeros((b, sk.NLIMBS), dtype=np.int32)
        qy = np.zeros((b, sk.NLIMBS), dtype=np.int32)
        u1 = np.zeros((b, 32), dtype=np.uint8)
        u2 = np.zeros((b, 32), dtype=np.uint8)
        rb = np.zeros((b, 32), dtype=np.uint8)
        ok = np.zeros(b, dtype=bool)
        for i, it in enumerate(items):
            prep = secp_native.prep_digest_item(
                it.pubkey, hashlib.sha256(it.msg).digest(), it.sig
            )
            if prep is None:
                continue
            _r, pt, u1v, u2v = prep
            qx[i] = sk.fe.from_int(pt[0])
            qy[i] = sk.fe.from_int(pt[1])
            u1[i] = np.frombuffer(u1v.to_bytes(32, "big"), np.uint8)
            u2[i] = np.frombuffer(u2v.to_bytes(32, "big"), np.uint8)
            rb[i] = np.frombuffer(it.sig[:32], np.uint8)
            ok[i] = True
        out = sk.verify_prehashed(
            *(self._to_device(a) for a in (qx, qy, u1, u2, rb, ok))
        )
        return out.cpu().numpy()[:n]

    def prepare(self, items: list[SigItem]) -> _PreparedBatch:
        """Host-side assembly of one batch (partition, padding, array
        fills, challenge hashing or message padding); ``run()`` on the
        handle does the cache ensure/snapshot, the copies to the card and
        the kernel launches."""
        n = len(items)
        if n == 0:
            return _PreparedBatch(0, lambda: np.zeros(0, dtype=bool))
        other_idx = [
            i for i, it in enumerate(items) if it.key_type != "ed25519"
        ]
        if other_idx:
            return _PreparedBatch(
                n, lambda: self._verify_mixed(items, other_idx)
            )
        if n < self._min_device_batch:

            def _run_host() -> np.ndarray:
                from . import ed25519 as host

                return np.array(
                    [host.verify(it.pubkey, it.msg, it.sig) for it in items],
                    dtype=bool,
                )

            return _PreparedBatch(n, _run_host)
        # bulk rounds shard over the mesh (the bucket rounded up so the
        # rows split evenly; the tail is verdict-inert padding)
        devs = self.shards_for(n)
        b = self._registry.bucket_for(n, multiple_of=devs)
        big = b >= self._bigtable_min
        device_hash = (
            big
            and self._device_challenge_min is not None
            and n >= self._device_challenge_min
            and all(
                len(it.msg) + 64 <= _DEVICE_HASH_MAX_BYTES
                for it in items
                if len(it.pubkey) == 32 and len(it.sig) == 64
            )
        )
        rb = np.zeros((b, 32), dtype=np.uint8)
        sb = np.zeros((b, 32), dtype=np.uint8)
        kb = None if device_hash else np.zeros((b, 32), dtype=np.uint8)
        msgs = [b""] * b if device_hash else None
        prefixes = [b""] * b if device_hash else None
        s_ok = np.zeros(b, dtype=bool)
        well_formed = []
        for i, it in enumerate(items):
            if len(it.pubkey) != 32 or len(it.sig) != 64:
                continue  # row stays zeroed; s_ok False -> reject
            r, s = it.sig[:32], it.sig[32:]
            if device_hash:
                msgs[i] = it.msg
                prefixes[i] = r + it.pubkey
            else:
                k = challenge(r, it.pubkey, it.msg)
                kb[i] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
            rb[i] = np.frombuffer(r, dtype=np.uint8)
            sb[i] = np.frombuffer(s, dtype=np.uint8)
            s_ok[i] = int.from_bytes(s, "little") < L
            well_formed.append(i)

        if not well_formed:
            return _PreparedBatch(n, lambda: np.zeros(n, dtype=bool))

        if device_hash:
            from ..ops import sha512

            msg_buf, n_blocks = sha512.pad_messages(msgs, prefix_pairs=prefixes)
        else:
            msg_buf = n_blocks = None

        def _run_device() -> np.ndarray:
            cache = self._big if big else self._small
            row_pubkeys = [(i, items[i].pubkey) for i in well_formed]
            # Two attempts: a concurrent verify() can reset the store
            # between ensure() and snapshot(), evicting our rows; a second
            # miss takes the generic kernel rather than mis-rejecting.
            for _ in range(2):
                if not cache.ensure([pk for _, pk in row_pubkeys]):
                    break  # the store cannot hold this batch
                snap = cache.snapshot(row_pubkeys, b)
                if snap is None:
                    continue
                stores, idx = snap
                if device_hash:
                    out = self._dispatch(
                        ed25519_batch.verify_msgs_bigcache, "big_msgs", b, n,
                        stores, (idx, rb, sb, msg_buf, n_blocks, s_ok),
                        devices=devs,
                    )
                elif big:
                    out = self._dispatch(
                        self._big_verify, "big", b, n,
                        stores, (idx, rb, sb, kb, s_ok), devices=devs,
                    )
                else:
                    out = self._dispatch(
                        ed25519_batch.verify_prehashed_table, "small", b, n,
                        stores, (idx, rb, sb, kb, s_ok), devices=devs,
                    )
                return out[:n]
            # the store cannot hold the batch: the generic kernel, with
            # host challenges for a device-hash batch (the validator-churn
            # edge, not the bulk path)
            gkb = kb
            if gkb is None:
                gkb = np.zeros((b, 32), dtype=np.uint8)
                for i in well_formed:
                    it = items[i]
                    k = challenge(it.sig[:32], it.pubkey, it.msg)
                    gkb[i] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
            pub = np.zeros((b, 32), dtype=np.uint8)
            for i in well_formed:
                pub[i] = np.frombuffer(items[i].pubkey, dtype=np.uint8)
            out = self._dispatch(
                ed25519_batch.verify_prehashed, "generic", b, n,
                None, (pub, rb, sb, gkb, s_ok), devices=devs,
            )
            return out[:n]

        return _PreparedBatch(n, _run_device, devices=devs)

    @staticmethod
    def _verify_host_other(it: SigItem) -> bool:
        """Host verify for the key types other than ed25519 and secp256k1
        (which _verify_mixed batches): sr25519; unknown types reject."""
        if it.key_type == "sr25519":
            from . import sr25519

            return sr25519.PubKey(it.pubkey).verify(it.msg, it.sig)
        return False

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        return bool(self.verify([SigItem(pubkey, msg, sig)])[0])


_default: BatchVerifier | None = None


def default_verifier(device: str | torch.device | None = None) -> BatchVerifier:
    """Process-wide verifier, built on first call.

    Reads the JAX package's environment knobs: TM_TPU_MIN_DEVICE_BATCH
    (host crossover), TM_TPU_DEVICE_CHALLENGE_MIN (big-tier batches of at
    least that many rows hash on the card; unset or 0 keeps host hashing),
    TM_TPU_{ICI,DCN}_PARALLELISM and TM_TPU_MESH_BACKEND (the mesh,
    ``parallel.mesh_from_env``) and TM_TPU_MESH_MIN_ROWS. `device` applies
    to the first call only."""
    global _default
    if _default is None:
        from ..parallel import mesh_from_env

        dcm = int(os.environ.get("TM_TPU_DEVICE_CHALLENGE_MIN", "0") or 0)
        mdb = int(os.environ.get("TM_TPU_MIN_DEVICE_BATCH", "8") or 8)
        _default = BatchVerifier(
            mesh=mesh_from_env(),
            min_device_batch=mdb,
            device_challenge_min=dcm if dcm > 0 else None,
            device=device,
        )
    return _default


def is_default_verifier(verifier) -> bool:
    """True iff `verifier` is the process-wide default instance (or None).
    The dispatch scheduler only takes over callers bound to the shared
    verifier; an explicitly injected one keeps its private path."""
    return verifier is None or verifier is _default


def warm_validator_sets_in_executor(
    validator_sets, logger=None, verifier: BatchVerifier | None = None
):
    """Bulk-warm the big-tier tables for validator sets off the event loop
    (blocksync start and rotation, light-client bisection). Returns the
    executor future, or None when there was nothing to warm or
    TM_TPU_SKIP_WARM is set. Failures are logged and re-raised into the
    future; ensure() is idempotent, so a later retry re-warms."""
    import asyncio

    if os.environ.get("TM_TPU_SKIP_WARM"):
        return None
    verifier = verifier or default_verifier()
    pubkeys: list[bytes] = []
    key_types: list[str] = []
    for vals in validator_sets:
        if vals is None:
            continue
        for v in vals.validators:
            pubkeys.append(v.pub_key.data)
            key_types.append(getattr(v.pub_key, "type_name", "ed25519"))
    if not pubkeys:
        return None

    def _warm():
        try:
            verifier.warm(pubkeys, bulk=True, key_types=key_types)
        except Exception as e:  # warming is best-effort
            if logger is not None:
                logger.error("table warm failed", err=repr(e))
            raise

    fut = asyncio.get_running_loop().run_in_executor(None, _warm)
    # the re-raise above is for callers awaiting the future; a
    # fire-and-forget caller must not leave it unretrieved
    fut.add_done_callback(lambda f: f.exception())
    return fut
