"""Host orchestration of batched ed25519 verification on the CUDA kernels.

Counterpart of ``tendermint_tpu/crypto/batch_verifier.py``: call sites push
(pubkey, msg, sig) triples and get an accept bitmap back. What carries
over unchanged:

- per-item host work: the challenge k = SHA-512(R || A || M) mod L and the
  s < L range check;
- shape discipline: batches pad to the bucket ladder of
  ``crypto/shape_registry`` (padding rows have ``s_ok`` False and
  ``idx = -1``, so they are rejected without a table read);
- the small-tier validator-table cache: each pubkey's negated radix-16
  window table (2 KiB of canonical bytes) is built once by the
  ``neg_pubkey_table`` kernel and kept on the card, in a store grown in
  powers of two that resets when full; a batch that the store cannot hold
  takes the generic kernel, and a row evicted between ``ensure`` and
  ``snapshot`` by a concurrent verify gets one retry first;
- the host crossover ``min_device_batch`` and the mixed-key partition.

Not in this slice, and raising ``NotImplementedError`` (a missing feature,
never a quiet fallback to the small tier or the host): a mesh or more than
one device, the big tier (buckets >= ``bigtable_min``), the on-device
SHA-512 challenges (``device_challenge_min``), and host verification of
secp256k1 / sr25519 rows.
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

# max rows of the device-resident small-tier table store (2 KiB/key)
TABLE_CACHE_CAPACITY = 4096

# batches whose bucket reaches this size belong to the big (doubling-free)
# tier of the JAX package, which is not ported yet
BIGTABLE_MIN = 512

# initial allocated rows of the lazy table store
_TABLE_ROWS_MIN = 128

_ROADMAP_BIG = "ROADMAP slice 2: big tier (kernels 5-7)"
_ROADMAP_SHA = "ROADMAP slice 2: fused SHA-512 challenges (kernel 8)"
_ROADMAP_MESH = "ROADMAP multi-GPU slice (kernel 13)"
_ROADMAP_KEYS = "ROADMAP gated kernels: secp256k1 / sr25519 host verify"


@dataclass(frozen=True)
class SigItem:
    pubkey: bytes  # 32 bytes (ed25519) or 33 bytes (secp256k1 compressed)
    msg: bytes
    sig: bytes  # 64 bytes
    key_type: str = "ed25519"


class _PreparedBatch:
    """Host-assembled batch whose device dispatch is deferred; ``run()``
    blocks for the verdict bitmap (len == n)."""

    __slots__ = ("n", "run")

    def __init__(self, n: int, run):
        self.n = n
        self.run = run


class _TableCache:
    """The device-resident table store (pubkey -> row), lazily grown.

    All methods take the verifier's lock: a vote micro-batcher may call
    verify() from an executor thread while the event loop verifies."""

    def __init__(self, lock, build_fn, capacity, device, registry=None,
                 tier="build_small"):
        self._lock = lock
        self._build_fn = build_fn
        self._capacity = capacity
        self._device = device
        self._registry = registry or default_shape_registry()
        self._tier = tier
        self._idx: dict[bytes, int] = {}
        self.tables: torch.Tensor | None = None  # [rows, 16, 4, 32] u8
        self.valid: torch.Tensor | None = None  # [rows] bool

    def _grow(self, needed_rows: int) -> None:
        rows = _TABLE_ROWS_MIN
        while rows < needed_rows:
            rows *= 2
        rows = min(rows, max(1, self._capacity))
        cur = 0 if self.tables is None else self.tables.shape[0]
        if rows <= cur:
            return
        tables = torch.zeros(
            (rows, 16, 4, 32), dtype=torch.uint8, device=self._device
        )
        valid = torch.zeros(rows, dtype=torch.bool, device=self._device)
        if cur:
            tables[:cur] = self.tables
            valid[:cur] = self.valid
        self.tables, self.valid = tables, valid

    def ensure(self, pubkeys: list[bytes], abort=None) -> bool:
        """Build + install tables for unseen pubkeys. Returns False when
        the batch alone exceeds capacity; resets the store when full."""
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
                self.tables = self.valid = None
                new = uniq
            self._grow(len(self._idx) + len(new))
            for lo in range(0, len(new), 512):
                if abort is not None and abort.is_set():
                    return True  # partial warm is fine; ensure is idempotent
                chunk = new[lo : lo + 512]
                b = self._registry.bucket_for(len(chunk))
                self._registry.record_dispatch(self._tier, b)
                arr = np.zeros((b, 32), dtype=np.uint8)
                for i, pk in enumerate(chunk):
                    arr[i] = np.frombuffer(pk, dtype=np.uint8)
                tables, valid = self._build_fn(
                    torch.from_numpy(arr).to(self._device)
                )
                rows = []
                for pk in chunk:
                    self._idx[pk] = len(self._idx)
                    rows.append(self._idx[pk])
                rows_t = torch.tensor(rows, dtype=torch.int64, device=self._device)
                self.tables[rows_t] = tables[: len(chunk)]
                self.valid[rows_t] = valid[: len(chunk)]
            return True

    def snapshot(self, row_pubkeys: list[tuple[int, bytes]], b: int):
        """(tables, valid, idx[b]) for the (row, pubkey) pairs, or None if
        a pubkey was concurrently evicted (the caller retries)."""
        with self._lock:
            idx = np.full(b, -1, dtype=np.int32)
            for i, pk in row_pubkeys:
                row = self._idx.get(pk)
                if row is None:
                    return None
                idx[i] = row
            return self.tables, self.valid, idx


class BatchVerifier:
    """Batched ed25519 verifier on one CUDA device (or, with
    ``device="cpu"``, on the kernels' plain PyTorch versions)."""

    def __init__(
        self,
        mesh=None,
        min_device_batch: int = 8,
        table_cache_capacity: int = TABLE_CACHE_CAPACITY,
        device_challenge_min: int | None = None,
        bigtable_min: int = BIGTABLE_MIN,
        shape_registry: ShapeRegistry | None = None,
        devices: int = 1,
        device: str | torch.device | None = None,
    ):
        """min_device_batch: below this size the host verifies serially.
        bigtable_min: buckets at or above it belong to the big tier, which
        raises here. mesh / devices > 1 / device_challenge_min raise too.
        device: "cuda" (default) or "cpu"; CUDA absent raises."""
        if mesh is not None or devices != 1:
            raise NotImplementedError(f"sharded verification: {_ROADMAP_MESH}")
        if device_challenge_min is not None:
            raise NotImplementedError(
                f"device_challenge_min: {_ROADMAP_SHA}"
            )
        self.device = resolve(device)
        self._min_device_batch = min_device_batch
        self._registry = shape_registry or default_shape_registry()
        self._bigtable_min = bigtable_min
        self.shutdown_event = threading.Event()
        self._small = _TableCache(
            threading.Lock(),
            ed25519_batch.neg_pubkey_table,
            table_cache_capacity,
            self.device,
            registry=self._registry,
        )

    # --- table cache -------------------------------------------------------

    def warm(
        self,
        pubkeys: list[bytes],
        bulk: bool = False,
        key_types: list[str] | None = None,
        abort=None,
    ) -> None:
        """Pre-build small-tier tables for a validator set. bulk=True
        (the big-tier warm) raises: the big tier is not ported yet."""
        if bulk:
            raise NotImplementedError(f"bulk warm: {_ROADMAP_BIG}")
        if key_types is not None:
            eds = [
                pk
                for pk, t in zip(pubkeys, key_types)
                if t == "ed25519" and len(pk) == 32
            ]
        else:
            eds = [pk for pk in pubkeys if len(pk) == 32]
        self._small.ensure(eds, abort=abort or self.shutdown_event)

    # --- verification ------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dispatch(self, fn, tier: str, b: int, n: int, *args) -> np.ndarray:
        """Run one kernel wrapper and block for the verdicts, traced as
        ``crypto.device_execute``."""
        rows = int(args[0].shape[0]) if tier == "small" else 0
        self._registry.record_dispatch(tier, b, rows)
        tracer = default_tracer()
        t0 = time.perf_counter()
        out = fn(*args).cpu().numpy()  # blocks until the card is done
        if tracer.enabled:
            tracer.add_span(
                "crypto.device_execute",
                t0,
                time.perf_counter() - t0,
                batch=n,
                bucket=b,
                tier=tier,
            )
        return out

    def verify(self, items: list[SigItem]) -> np.ndarray:
        """Bool accept bitmap aligned with `items`."""
        return self.prepare(items).run()

    def _verify_mixed(self, items: list[SigItem], other_idx: list[int]):
        """ed25519 rows ride the device batch, other types verify on the
        host, and the bitmap is re-interleaved."""
        out = np.zeros(len(items), dtype=bool)
        ed_idx = [i for i, it in enumerate(items) if it.key_type == "ed25519"]
        if ed_idx:
            out[ed_idx] = self.verify([items[i] for i in ed_idx])
        for i in other_idx:
            out[i] = self._verify_host_other(items[i])
        return out

    def prepare(self, items: list[SigItem]) -> _PreparedBatch:
        """Host-side assembly of one batch; ``run()`` on the handle does
        the cache ensure/snapshot and the kernel launch."""
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
        b = self._registry.bucket_for(n)
        if b >= self._bigtable_min:
            raise NotImplementedError(
                f"batch of {n} (bucket {b} >= bigtable_min "
                f"{self._bigtable_min}): {_ROADMAP_BIG}"
            )
        rb = np.zeros((b, 32), dtype=np.uint8)
        sb = np.zeros((b, 32), dtype=np.uint8)
        kb = np.zeros((b, 32), dtype=np.uint8)
        s_ok = np.zeros(b, dtype=bool)
        well_formed = []
        for i, it in enumerate(items):
            if len(it.pubkey) != 32 or len(it.sig) != 64:
                continue  # row stays zeroed; s_ok False -> reject
            r, s = it.sig[:32], it.sig[32:]
            k = challenge(r, it.pubkey, it.msg)
            kb[i] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
            rb[i] = np.frombuffer(r, dtype=np.uint8)
            sb[i] = np.frombuffer(s, dtype=np.uint8)
            s_ok[i] = int.from_bytes(s, "little") < L
            well_formed.append(i)

        if not well_formed:
            return _PreparedBatch(n, lambda: np.zeros(n, dtype=bool))

        def _run_device() -> np.ndarray:
            r_t, s_t, k_t = (self._to_device(a) for a in (rb, sb, kb))
            ok_t = self._to_device(s_ok)
            row_pubkeys = [(i, items[i].pubkey) for i in well_formed]
            # Two attempts: a concurrent verify() can reset the store
            # between ensure() and snapshot(), evicting our rows; a second
            # miss takes the generic kernel rather than mis-rejecting.
            for _ in range(2):
                if not self._small.ensure([pk for _, pk in row_pubkeys]):
                    break  # the store cannot hold this batch
                snap = self._small.snapshot(row_pubkeys, b)
                if snap is None:
                    continue
                tables, tvalid, idx = snap
                out = self._dispatch(
                    ed25519_batch.verify_prehashed_table, "small", b, n,
                    tables, tvalid, self._to_device(idx), r_t, s_t, k_t, ok_t,
                )
                return out[:n]
            pub = np.zeros((b, 32), dtype=np.uint8)
            for i in well_formed:
                pub[i] = np.frombuffer(items[i].pubkey, dtype=np.uint8)
            out = self._dispatch(
                ed25519_batch.verify_prehashed, "generic", b, n,
                self._to_device(pub), r_t, s_t, k_t, ok_t,
            )
            return out[:n]

        return _PreparedBatch(n, _run_device)

    @staticmethod
    def _verify_host_other(it: SigItem) -> bool:
        """Host verify for non-ed25519 key types; unknown types reject."""
        if it.key_type in ("secp256k1", "sr25519"):
            raise NotImplementedError(f"{it.key_type} rows: {_ROADMAP_KEYS}")
        return False

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        return bool(self.verify([SigItem(pubkey, msg, sig)])[0])


_default: BatchVerifier | None = None


def default_verifier(device: str | torch.device | None = None) -> BatchVerifier:
    """Process-wide single-device verifier, built on first call.

    Reads the JAX package's environment knobs: TM_TPU_MIN_DEVICE_BATCH
    (host crossover), and TM_TPU_DEVICE_CHALLENGE_MIN and
    TM_TPU_{ICI,DCN}_PARALLELISM, which ask for features this slice does
    not have and so raise. `device` applies to the first call only."""
    global _default
    if _default is None:
        dcm = int(os.environ.get("TM_TPU_DEVICE_CHALLENGE_MIN", "0") or 0)
        mdb = int(os.environ.get("TM_TPU_MIN_DEVICE_BATCH", "8") or 8)
        devices = int(os.environ.get("TM_TPU_ICI_PARALLELISM", "1") or 1) * int(
            os.environ.get("TM_TPU_DCN_PARALLELISM", "1") or 1
        )
        _default = BatchVerifier(
            min_device_batch=mdb,
            device_challenge_min=dcm if dcm > 0 else None,
            devices=devices,
            device=device,
        )
    return _default
