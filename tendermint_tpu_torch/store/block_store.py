"""BlockStore — the durable chain: blocks as parts + metas + commits.

Reference: store/store.go:33-546 (SaveBlock :446, LoadBlock :93,
PruneBlocks :268, PruneBlocksSince :346). Layout mirrors the reference's
key scheme: per-height meta, per-(height,part) part payloads, commits and
seen-commits, plus a base/height range record.
"""

from __future__ import annotations

import queue
import struct
import threading
import time
from typing import Optional

from ..libs import protoio as pio
from ..types.block import Block, Commit
from ..types.block_id import BlockID
from ..types.block_meta import BlockMeta
from ..types.part_set import Part, PartSet
from .kv import KV


def _h(prefix: bytes, height: int, extra: int = -1) -> bytes:
    key = prefix + struct.pack(">q", height)
    if extra >= 0:
        key += struct.pack(">i", extra)
    return key


_META = b"H:"
_PART = b"P:"
_COMMIT = b"C:"
_SEEN = b"SC:"
_QC = b"QC:"  # quorum certificate for height (from block height+1)
_STATE = b"BSS"  # block store state: base/height


class BlockStore:
    def __init__(self, db: KV):
        self._db = db
        self._mtx = threading.Lock()
        raw = db.get(_STATE)
        if raw:
            f = pio.decode_fields(raw)
            self._base = f.get(1, [0])[0]
            self._height = f.get(2, [0])[0]
        else:
            self._base = 0
            self._height = 0

    # --- range ------------------------------------------------------------

    @property
    def base(self) -> int:
        with self._mtx:
            return self._base

    @property
    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return self._height - self._base + 1 if self._height > 0 else 0

    def _save_state(self) -> None:
        self._db.set(
            _STATE,
            pio.field_varint(1, self._base) + pio.field_varint(2, self._height),
        )

    # --- writes -----------------------------------------------------------

    @staticmethod
    def _block_sets(
        block: Block, part_set: PartSet, seen_commit: Commit
    ) -> list[tuple[bytes, bytes]]:
        """The KV batch for one block save (meta, parts, commits)."""
        height = block.header.height
        sets: list[tuple[bytes, bytes]] = []
        meta = BlockMeta.from_block(block, part_set)
        sets.append((_h(_META, height), meta.encode()))
        for i in range(part_set.total):
            part = part_set.get_part(i)
            sets.append((_h(_PART, height, i), part.encode()))
        if block.last_commit is not None:
            sets.append(
                (_h(_COMMIT, height - 1), block.last_commit.encode())
            )
        if block.last_qc is not None:
            # the QC plane's canonical record for height-1, next to the
            # commit it compresses (lightserve serves it as the proof)
            sets.append((_h(_QC, height - 1), block.last_qc.encode()))
        sets.append((_h(_SEEN, height), seen_commit.encode()))
        return sets

    def save_block(
        self, block: Block, part_set: PartSet, seen_commit: Commit
    ) -> None:
        """SaveBlock (reference store/store.go:446): persists the block's
        parts, meta, its LastCommit (for height-1) and the seen commit."""
        height = block.header.height
        with self._mtx:
            if self._height > 0 and height != self._height + 1:
                raise ValueError(
                    f"cannot save block at height {height}, "
                    f"store is at {self._height}"
                )
            self._db.write_batch(
                self._block_sets(block, part_set, seen_commit), []
            )
            if self._base == 0:
                self._base = height
            self._height = height
            self._save_state()

    def save_seen_commit(self, height: int, seen_commit: Commit) -> None:
        self._db.set(_h(_SEEN, height), seen_commit.encode())

    # --- reads ------------------------------------------------------------

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(_h(_META, height))
        return BlockMeta.decode(raw) if raw else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        ps = PartSet(meta.block_id.part_set_header)
        for i in range(ps.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            ps.add_part(part)
        return Block.decode(ps.get_bytes())

    def load_block_by_hash(self, block_hash: bytes) -> Optional[Block]:
        # linear scan over metas (the reference keeps a hash->height index;
        # do the same here lazily if it ever shows up in profiles)
        for h in range(self.base, self.height + 1):
            meta = self.load_block_meta(h)
            if meta and meta.block_id.hash == block_hash:
                return self.load_block(h)
        return None

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(_h(_PART, height, index))
        return Part.decode(raw) if raw else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The canonical commit for `height` (stored with block height+1)."""
        raw = self._db.get(_h(_COMMIT, height))
        return Commit.decode(raw) if raw else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self._db.get(_h(_SEEN, height))
        return Commit.decode(raw) if raw else None

    def load_block_qc(self, height: int):
        """The canonical QuorumCertificate for `height` (carried by
        block height+1, like the canonical commit) — None on legacy
        heights."""
        from ..types.quorum_cert import QuorumCertificate

        raw = self._db.get(_h(_QC, height))
        return QuorumCertificate.decode(raw) if raw else None

    # --- pruning ----------------------------------------------------------

    def prune_blocks(self, retain_height: int) -> int:
        """Removes blocks below retain_height (reference :268); returns the
        number pruned."""
        with self._mtx:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height:
                raise ValueError("cannot prune beyond store height")
            pruned = 0
            deletes = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_h(_META, h))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_h(_PART, h, i))
                deletes.append(_h(_COMMIT, h - 1))
                deletes.append(_h(_QC, h - 1))
                deletes.append(_h(_SEEN, h))
                pruned += 1
            self._base = retain_height
            self._db.write_batch([], deletes)
            self._save_state()
            return pruned

    def wait_durable(
        self, height: Optional[int] = None, timeout: Optional[float] = None
    ) -> None:
        """Durability barrier: returns once every save up to `height`
        (default: everything enqueued so far) has hit the KV store. The
        synchronous store is always durable — a no-op here; the
        write-behind subclass blocks on its save queue."""

    def stop(self) -> None:
        """Drain/stop background persistence (no-op for the sync store)."""

    def prune_blocks_since(self, height: int) -> int:
        """Removes blocks ABOVE height — rollback support (reference :346,
        used by the rewind/rollback tooling)."""
        with self._mtx:
            if height >= self._height:
                return 0
            if height < self._base:
                raise ValueError("cannot rewind below store base")
            pruned = 0
            deletes = []
            for h in range(height + 1, self._height + 1):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_h(_META, h))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_h(_PART, h, i))
                if h - 1 > height:
                    # keep the canonical commit/QC for the retained head
                    deletes.append(_h(_COMMIT, h - 1))
                    deletes.append(_h(_QC, h - 1))
                deletes.append(_h(_SEEN, h))
                pruned += 1
            self._height = height
            self._db.write_batch([], deletes)
            self._save_state()
            return pruned


class WriteBehindBlockStore(BlockStore):
    """BlockStore with an async save queue — the commit pipeline's
    write-behind stage.

    `save_block` enqueues the block and returns immediately; a dedicated
    worker thread performs the KV batch off the consensus critical path.
    The store's logical height advances at enqueue time (consensus and
    gossip read `height`/`load_*` and must see the block the instant the
    commit decides it — pending saves are served from an in-memory
    overlay), while the on-disk base/height record only ever advances to
    the last DURABLY saved height, so a crash mid-queue looks exactly
    like the pre-pipeline crash-before-save window WAL replay already
    recovers (consensus/replay.py).

    `wait_durable(height)` is the barrier the pipeline (and node stop)
    uses; a failed background save latches an error that every later
    barrier and save raises.

    Reference counterpart: none — reference SaveBlock is synchronous on
    the commit path (store/store.go:446 inside finalizeCommit).
    """

    def __init__(
        self,
        db: KV,
        max_inflight: int = 8,
        metrics=None,
        tracer=None,
    ):
        super().__init__(db)
        # reentrant: prune paths hold the lock while load_* overrides
        # consult the pending overlay
        self._mtx = threading.RLock()
        self._pending: dict[int, tuple[Block, PartSet, Commit]] = {}
        self._save_q: queue.Queue = queue.Queue(maxsize=max(1, max_inflight))
        self._durable_height = self._height
        self._durable_cv = threading.Condition()
        self._save_error: Optional[BaseException] = None
        self._metrics = metrics
        self._tracer = tracer
        self._worker = threading.Thread(
            target=self._drain, name="blockstore-writebehind", daemon=True
        )
        self._worker.start()

    # --- writes -------------------------------------------------------------

    def _save_state(self) -> None:
        # write-behind invariant: the on-disk range record never covers
        # enqueued-but-unsaved heights — a crash must reopen a store
        # whose recorded range is fully readable (otherwise handshake
        # replay hits 'missing block' forever). Every writer of the
        # record (worker, prune paths via the base class) routes here.
        with self._durable_cv:
            durable = self._durable_height
        self._db.set(
            _STATE,
            pio.field_varint(1, self._base)
            + pio.field_varint(2, min(self._height, durable)),
        )

    def save_block(
        self, block: Block, part_set: PartSet, seen_commit: Commit
    ) -> None:
        """Enqueue the save and return; backpressure (max_inflight full
        queue) blocks, bounding how far disk may fall behind consensus."""
        height = block.header.height
        with self._mtx:
            if self._save_error is not None:
                raise RuntimeError(
                    "write-behind block store failed"
                ) from self._save_error
            if self._height > 0 and height != self._height + 1:
                raise ValueError(
                    f"cannot save block at height {height}, "
                    f"store is at {self._height}"
                )
            if self._base == 0:
                self._base = height
            self._height = height
            self._pending[height] = (block, part_set, seen_commit)
        self._save_q.put((height, block, part_set, seen_commit))

    def _drain(self) -> None:
        while True:
            item = self._save_q.get()
            if item is None:
                return
            if self._save_error is not None:
                # never persist heights PAST a failed one: advancing the
                # durable range over a hole would wedge handshake replay
                # ('missing block during replay') forever
                continue
            height, block, part_set, seen_commit = item
            t0 = time.perf_counter()
            try:
                sets = self._block_sets(block, part_set, seen_commit)
                self._db.write_batch(sets, [])
            except BaseException as e:  # latch: the store is now wedged
                with self._durable_cv:
                    self._save_error = e
                    self._durable_cv.notify_all()
                continue
            dur = time.perf_counter() - t0
            with self._mtx:
                self._pending.pop(height, None)
            with self._durable_cv:
                self._durable_height = max(self._durable_height, height)
                self._durable_cv.notify_all()
            # advance the durable range record (the override pins it to
            # the durable height, and reads base under the lock — never
            # stale against a concurrent prune)
            with self._mtx:
                self._save_state()
            if self._metrics is not None:
                self._metrics.block_store_save_seconds.observe(dur)
            if self._tracer is not None:
                self._tracer.add_span(
                    "store.save_block_async", t0, dur, height=height
                )

    def wait_durable(
        self, height: Optional[int] = None, timeout: Optional[float] = None
    ) -> None:
        with self._durable_cv:
            target = self._height if height is None else height
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            while (
                self._durable_height < target and self._save_error is None
            ):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"block save for height {target} not durable"
                        )
                self._durable_cv.wait(remaining)
            if self._save_error is not None:
                raise RuntimeError(
                    "write-behind block store failed"
                ) from self._save_error

    @property
    def durable_height(self) -> int:
        with self._durable_cv:
            return self._durable_height

    @property
    def save_queue_depth(self) -> int:
        with self._mtx:
            return len(self._pending)

    def stop(self) -> None:
        """Drain every queued save, then stop the worker."""
        self._save_q.put(None)
        self._worker.join(timeout=30.0)

    # --- reads (pending overlay) --------------------------------------------

    def _pending_for(self, height: int):
        with self._mtx:
            return self._pending.get(height)

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        p = self._pending_for(height)
        if p is not None:
            return BlockMeta.from_block(p[0], p[1])
        return super().load_block_meta(height)

    def load_block(self, height: int) -> Optional[Block]:
        p = self._pending_for(height)
        if p is not None:
            return p[0]
        return super().load_block(height)

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        p = self._pending_for(height)
        if p is not None:
            return p[1].get_part(index)
        return super().load_block_part(height, index)

    def load_block_commit(self, height: int) -> Optional[Commit]:
        p = self._pending_for(height + 1)
        if p is not None and p[0].last_commit is not None:
            return p[0].last_commit
        return super().load_block_commit(height)

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        p = self._pending_for(height)
        if p is not None:
            return p[2]
        return super().load_seen_commit(height)

    def load_block_qc(self, height: int):
        p = self._pending_for(height + 1)
        if p is not None:
            return p[0].last_qc
        return super().load_block_qc(height)

    # --- pruning ------------------------------------------------------------

    def prune_blocks(self, retain_height: int) -> int:
        # saves are FIFO, so durability up to the prune boundary is all
        # pruning needs — those heights are normally long durable, so
        # this does not stall the caller (the background finalization
        # task) behind the whole save queue; the bound is the enqueued
        # height, so the target is always reachable
        with self._mtx:
            enqueued = self._height
        self.wait_durable(min(retain_height - 1, enqueued))
        return super().prune_blocks(retain_height)

    def prune_blocks_since(self, height: int) -> int:
        # rollback rewinds ABOVE `height`: pending saves up there would
        # resurrect rewound blocks — this rare offline op drains fully
        self.wait_durable()
        n = super().prune_blocks_since(height)
        with self._durable_cv:
            self._durable_height = min(self._durable_height, height)
        # re-pin the range record now that the watermark moved down
        with self._mtx:
            self._save_state()
        return n
