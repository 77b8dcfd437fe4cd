"""Snapshot syncer — restore app state from peer-served snapshots.

Reference: statesync/syncer.go. `sync_any` (:141) picks the best
discovered snapshot; `sync` (:237): verify the app hash via the state
provider → OfferSnapshot to the app (:318) → fetch chunks from peers in
parallel (:411) while applying them in order (:354) → verify the restored
app hash → hand back (state, commit) for node bootstrap.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..abci.types import Snapshot
from ..libs.log import Logger, nop_logger
from .chunks import Chunk, ChunkQueue
from .stateprovider import StateProvider


class SyncError(Exception):
    pass


class ErrNoSnapshots(SyncError):
    pass


class ErrAbort(SyncError):
    pass


class _RetrySnapshot(SyncError):
    pass


class _RejectSnapshot(SyncError):
    pass


class _RejectFormat(SyncError):
    pass


class _RejectSender(SyncError):
    pass


CHUNK_FETCH_TIMEOUT = 10.0
CHUNK_REQUEST_FANOUT = 4
# a peer whose chunks keep failing is dropped from the snapshot's pool
# after this many strikes — the statesync mirror of the blocksync
# request-timeout ban (blocksync/pool.py _timeout_peer)
CHUNK_PEER_MAX_FAILURES = 3
# how many CHUNK_FETCH_TIMEOUT expiries to ride through (rotating the
# stalled chunk to another peer each time) before giving up on the
# snapshot — one silent peer must not sink an otherwise healthy pool
CHUNK_FETCH_MAX_TIMEOUTS = 4


@dataclass
class _DiscoveredSnapshot:
    snapshot: Snapshot
    peers: list = field(default_factory=list)  # peers advertising it
    trusted_app_hash: bytes = b""

    def key(self):
        s = self.snapshot
        return (s.height, s.format, s.hash)


class Syncer:
    def __init__(
        self,
        app_snapshot_conn,  # abci client (snapshot connection)
        state_provider: StateProvider,
        request_chunk: Callable,  # (peer, height, format, index) -> None
        logger: Optional[Logger] = None,
    ):
        self._app = app_snapshot_conn
        self._provider = state_provider
        self._request_chunk = request_chunk
        self.logger = logger or nop_logger()
        self._snapshots: dict = {}  # key -> _DiscoveredSnapshot
        self._rejected: set = set()
        self._rejected_formats: set = set()
        self._rejected_peers: set = set()
        self._chunks: Optional[ChunkQueue] = None
        self._current: Optional[_DiscoveredSnapshot] = None
        self._new_snapshot = asyncio.Event()

    # --- discovery (reference snapshots.go pool) ----------------------------

    def add_snapshot(self, peer, snapshot: Snapshot) -> bool:
        if peer.id in self._rejected_peers:
            return False
        if snapshot.format in self._rejected_formats:
            return False
        key = (snapshot.height, snapshot.format, snapshot.hash)
        if key in self._rejected:
            return False
        d = self._snapshots.get(key)
        if d is None:
            d = _DiscoveredSnapshot(snapshot)
            self._snapshots[key] = d
            self._new_snapshot.set()
        if peer not in d.peers:
            d.peers.append(peer)
        return True

    def add_chunk(self, chunk: Chunk) -> bool:
        if self._chunks is None or self._current is None:
            return False
        s = self._current.snapshot
        if (chunk.height, chunk.format) != (s.height, s.format):
            return False
        return self._chunks.add(chunk)

    def _best(self) -> Optional[_DiscoveredSnapshot]:
        """Highest height, then most peers (reference snapshots.go Best)."""
        candidates = [
            d
            for k, d in self._snapshots.items()
            if k not in self._rejected
            and d.snapshot.format not in self._rejected_formats
        ]
        if not candidates:
            return None
        return max(
            candidates, key=lambda d: (d.snapshot.height, len(d.peers))
        )

    # --- main loop (reference SyncAny :141) ----------------------------------

    async def sync_any(self, discovery_time: float = 2.0):
        """Returns (state, commit). Raises ErrNoSnapshots/ErrAbort."""
        snapshot: Optional[_DiscoveredSnapshot] = None
        chunks: Optional[ChunkQueue] = None
        while True:
            if snapshot is None:
                snapshot = self._best()
                chunks = None
            if snapshot is None:
                if discovery_time <= 0:
                    raise ErrNoSnapshots()
                self.logger.info("discovering snapshots", t=discovery_time)
                try:
                    await asyncio.wait_for(
                        self._new_snapshot.wait(), discovery_time
                    )
                except asyncio.TimeoutError:
                    pass
                self._new_snapshot.clear()
                continue
            if chunks is None:
                chunks = ChunkQueue(snapshot.snapshot.chunks)
            try:
                return await self.sync(snapshot, chunks)
            except _RetrySnapshot:
                self.logger.info("retrying snapshot")
                continue
            except (_RejectSnapshot, asyncio.TimeoutError):
                self._rejected.add(snapshot.key())
            except _RejectFormat:
                self._rejected_formats.add(snapshot.snapshot.format)
            except _RejectSender:
                for p in snapshot.peers:
                    self._rejected_peers.add(p.id)
                    if self._chunks:
                        self._chunks.discard_sender(p.id)
                self._rejected.add(snapshot.key())
            chunks.close()
            snapshot = None
            chunks = None

    # --- one snapshot (reference Sync :237) -----------------------------------

    async def sync(self, d: _DiscoveredSnapshot, chunks: ChunkQueue):
        self._current = d
        self._chunks = chunks
        chunks.metrics.syncing.set(1)
        chunks.metrics.snapshot_height.set(d.snapshot.height)
        try:
            # trusted app hash from the light-client state provider
            d.trusted_app_hash = await self._provider.app_hash(
                d.snapshot.height
            )
            await self._offer_snapshot(d)
            fetcher = asyncio.create_task(self._fetch_chunks(d, chunks))
            try:
                await self._apply_chunks(d, chunks)
            finally:
                fetcher.cancel()
                try:
                    await fetcher
                except (asyncio.CancelledError, Exception):
                    pass
            # verify the restored app against the trusted hash
            info = await self._app_info()
            if info.last_block_app_hash != d.trusted_app_hash:
                raise _RejectSnapshot(
                    "restored app hash does not match trusted hash"
                )
            if info.last_block_height != d.snapshot.height:
                raise _RejectSnapshot("restored app at wrong height")
            state = await self._provider.state(d.snapshot.height)
            commit = await self._provider.commit(d.snapshot.height)
            self.logger.info(
                "snapshot restored", height=d.snapshot.height
            )
            return state, commit
        finally:
            chunks.metrics.syncing.set(0)
            self._current = None
            self._chunks = None

    async def _app_info(self):
        res = self._app.info()
        if asyncio.iscoroutine(res):
            res = await res
        return res

    async def _offer_snapshot(self, d: _DiscoveredSnapshot) -> None:
        res = self._app.offer_snapshot(d.snapshot, d.trusted_app_hash)
        if asyncio.iscoroutine(res):
            res = await res
        result = res.result
        if result == "ACCEPT":
            return
        if result == "ABORT":
            raise ErrAbort()
        if result == "REJECT":
            raise _RejectSnapshot()
        if result == "REJECT_FORMAT":
            raise _RejectFormat()
        if result == "REJECT_SENDER":
            raise _RejectSender()
        raise SyncError(f"unknown offer result {result}")

    async def _fetch_chunks(
        self, d: _DiscoveredSnapshot, chunks: ChunkQueue
    ) -> None:
        """Request chunk allocations from peers round-robin (:411),
        rotating a retried chunk away from the peer whose copy failed."""
        next_peer = 0
        failures: dict[str, int] = {}
        while not chunks.complete:
            index = chunks.allocate()
            if index is None:
                await asyncio.sleep(0.05)
                continue
            avoid = chunks.last_sender(index)
            if avoid:
                # one strike per failed fetch, charged to the peer whose
                # copy failed (NOT the chunk's cumulative retry count —
                # that would charge every earlier peer's failure to
                # whichever peer failed last)
                failures[avoid] = failures.get(avoid, 0) + 1
                if failures[avoid] >= CHUNK_PEER_MAX_FAILURES and len(
                    d.peers
                ) > 1:
                    d.peers = [p for p in d.peers if p.id != avoid]
                    self.logger.info(
                        "dropping failing statesync peer", peer=avoid
                    )
            candidates = [
                p for p in d.peers if p.id not in self._rejected_peers
            ] or d.peers
            pool = [p for p in candidates if p.id != avoid] or candidates
            peer = pool[next_peer % len(pool)]
            next_peer += 1
            chunks.note_request(index, peer.id)
            self._request_chunk(
                peer, d.snapshot.height, d.snapshot.format, index
            )
            await asyncio.sleep(0)

    async def _apply_chunks(
        self, d: _DiscoveredSnapshot, chunks: ChunkQueue
    ) -> None:
        """Apply in order, honoring the app's retry/reject verdicts (:354)."""
        applied = 0
        timeouts = 0
        while applied < chunks.num_chunks:
            chunk = chunks.get(applied)
            if chunk is None:
                if not await chunks.wait_for_chunk(CHUNK_FETCH_TIMEOUT):
                    # the peer holding the next needed chunk went silent:
                    # put the chunk back for refetch (charged to the peer
                    # note_request recorded) so the fetcher rotates to
                    # another peer, instead of one dead peer sinking the
                    # whole snapshot
                    timeouts += 1
                    if timeouts > CHUNK_FETCH_MAX_TIMEOUTS:
                        raise asyncio.TimeoutError("chunk fetch timed out")
                    self.logger.info(
                        "chunk fetch timed out; rotating", chunk=applied
                    )
                    chunks.retry(applied)
                continue
            res = self._app.apply_snapshot_chunk(
                chunk.index, chunk.chunk, chunk.sender
            )
            if asyncio.iscoroutine(res):
                res = await res
            for idx in res.refetch_chunks:
                chunks.retry(idx)
            for sender in res.reject_senders:
                if sender:
                    self._rejected_peers.add(sender)
                    for idx in chunks.discard_sender(sender):
                        chunks.retry(idx, sender)
            result = res.result
            if result == "ACCEPT":
                applied += 1
            elif result == "ABORT":
                raise ErrAbort()
            elif result == "RETRY":
                chunks.retry(chunk.index, chunk.sender)
            elif result == "RETRY_SNAPSHOT":
                raise _RetrySnapshot()
            elif result == "REJECT_SNAPSHOT":
                raise _RejectSnapshot()
            else:
                raise SyncError(f"unknown apply result {result}")
