"""Chunk queue for an in-flight snapshot restore.

Reference: statesync/chunks.go — the reference spools chunks to a temp
dir; chunks here are small enough to keep in memory (the app re-chunks
however it likes). Tracks allocation (which chunk is being fetched from
which peer), arrival, and retry/refetch.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Optional

from ..libs.metrics import StateSyncMetrics, default_metrics
from ..obs import default_tracer

# per-chunk refetch backoff: the seed refetched immediately from the same
# pool, hammering a bad peer in a tight loop; failed chunks now wait
# BASE·2ⁿ (capped) before they are allocatable again, mirroring the
# blocksync peer-ban escalation (blocksync/pool.py _timeout_peer)
RETRY_BACKOFF_BASE = 0.1
RETRY_BACKOFF_CAP = 5.0


@dataclass
class Chunk:
    height: int
    format: int
    index: int
    chunk: bytes
    sender: str = ""


class ChunkQueue:
    def __init__(self, num_chunks: int, now=time.monotonic):
        self.num_chunks = num_chunks
        self._now = now
        self._chunks: dict[int, Chunk] = {}
        self._allocated: dict[int, str] = {}  # index -> peer fetching it
        self._retries: dict[int, int] = {}  # index -> failed attempts
        self._retry_at: dict[int, float] = {}  # index -> earliest refetch
        self._last_sender: dict[int, str] = {}  # index -> last failing peer
        self._requested_at: dict[int, float] = {}  # index -> request time
        self.metrics = default_metrics(StateSyncMetrics)
        self._event = asyncio.Event()
        self._closed = False

    def allocate(self) -> Optional[int]:
        """Next chunk index to fetch, or None if all allocated/done/
        backing off."""
        now = self._now()
        for i in range(self.num_chunks):
            if i in self._chunks or i in self._allocated:
                continue
            if self._retry_at.get(i, 0.0) > now:
                continue
            self._allocated[i] = ""
            return i
        return None

    def note_request(self, index: int, peer_id: str) -> None:
        """Record which peer was asked for an allocated chunk, so a
        timeout-driven retry can rotate away from it."""
        if index in self._allocated:
            self._allocated[index] = peer_id
            self._requested_at[index] = self._now()

    def add(self, chunk: Chunk) -> bool:
        """Returns False for duplicates/out-of-range."""
        if self._closed:
            return False
        if not (0 <= chunk.index < self.num_chunks):
            return False
        if chunk.index in self._chunks:
            return False
        self._chunks[chunk.index] = chunk
        self._allocated.pop(chunk.index, None)
        self.metrics.chunks_fetched.inc()
        req_t = self._requested_at.pop(chunk.index, 0.0)
        if req_t:
            latency = self._now() - req_t
            self.metrics.chunk_response_seconds.observe(latency)
            default_tracer().event(
                "statesync.chunk_received",
                index=chunk.index,
                peer=chunk.sender[:12],
                latency_ms=round(latency * 1e3, 2),
            )
        self._event.set()
        return True

    def get(self, index: int) -> Optional[Chunk]:
        return self._chunks.get(index)

    def retry(self, index: int, sender: str = "") -> None:
        """Put a chunk back for refetching (app asked for a refetch,
        or the fetch timed out) with exponential backoff. `sender` is
        the peer the failed copy came from; the fetcher rotates away
        from it on the refetch."""
        failing = sender or (
            self._chunks[index].sender
            if index in self._chunks
            else self._allocated.get(index, "")
        )
        self._chunks.pop(index, None)
        self._allocated.pop(index, None)
        self._requested_at.pop(index, None)
        self.metrics.chunk_retries.inc()
        n = self._retries.get(index, 0)
        self._retries[index] = n + 1
        self._retry_at[index] = self._now() + min(
            RETRY_BACKOFF_CAP, RETRY_BACKOFF_BASE * (2**n)
        )
        if failing:
            self._last_sender[index] = failing

    def retries(self, index: int) -> int:
        return self._retries.get(index, 0)

    def last_sender(self, index: int) -> str:
        """The peer whose copy of this chunk last failed ("" if none)."""
        return self._last_sender.get(index, "")

    def discard_sender(self, peer_id: str) -> list[int]:
        """Drop all chunks from a rejected sender; returns their indexes."""
        dropped = []
        for i, c in list(self._chunks.items()):
            if c.sender == peer_id:
                del self._chunks[i]
                dropped.append(i)
        return dropped

    @property
    def complete(self) -> bool:
        return len(self._chunks) == self.num_chunks

    async def wait_for_chunk(self, timeout: float = 10.0) -> bool:
        """Wait until some chunk arrives (or timeout); clears the event."""
        try:
            await asyncio.wait_for(self._event.wait(), timeout)
            self._event.clear()
            return True
        except asyncio.TimeoutError:
            return False

    def close(self) -> None:
        self._closed = True
