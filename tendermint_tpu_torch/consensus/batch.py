"""BatchCache — L2 batch-point state across heights and restarts.

Reference: consensus/batch.go:17-99. Caches the blocks since the last
batch point plus a blockHash -> (batchHash, batchHeader) map so (a) a
proposal's batch decision is computed once (decideBatchPointWithProposedBlock
:1365-1377), (b) batch points survive restarts: `get_batch_start` walks
the block store backwards to the last batch-point block and rebuilds the
cache (:67-99), so a node rejoining mid-batch makes interval/timeout
decisions against the true batch start, not its own uptime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.block import Block


@dataclass
class _BatchData:
    batch_hash: bytes
    batch_header: bytes


@dataclass
class BatchCache:
    batch_start_height: int = 0
    batch_start_time_ns: int = 0
    parent_batch_header: bytes = b""
    blocks_since_last_batch_point: list[Block] = field(default_factory=list)
    batch_hashes: dict[bytes, _BatchData] = field(default_factory=dict)

    def update_start_point(self, block: Block) -> None:
        self.batch_start_height = block.header.height
        self.batch_start_time_ns = block.header.time_ns
        self.parent_batch_header = block.data.l2_batch_header
        self.blocks_since_last_batch_point = [block]

    def append_block(self, block: Block) -> None:
        self.blocks_since_last_batch_point.append(block)

    def store_batch_data(
        self, block_hash: bytes, batch_hash: bytes, batch_header: bytes
    ) -> None:
        self.batch_hashes[bytes(block_hash)] = _BatchData(
            batch_hash, batch_header
        )

    def clear_batch_data(self) -> None:
        self.batch_hashes.clear()

    def batch_data(self, block_hash: bytes) -> Optional[_BatchData]:
        return self.batch_hashes.get(bytes(block_hash))

    # --- finalize-time update (reference state.go:1902-1910) ----------------

    def on_block_committed(self, block: Block) -> None:
        self.clear_batch_data()
        if block.is_batch_point():
            self.update_start_point(block)
        else:
            self.append_block(block)


def get_batch_start(
    cache: BatchCache,
    height: int,
    initial_height: int,
    last_block_time_ns: int,
    block_store,
) -> tuple[int, int]:
    """(batch_start_height, batch_start_time_ns); rebuilds the cache from
    the block store after a restart (reference getBatchStart :67-99)."""
    if cache.batch_start_height != 0:
        return cache.batch_start_height, cache.batch_start_time_ns
    if height == initial_height:
        # genesis is the first batch point
        return 0, last_block_time_ns
    blocks_desc: list[Block] = []
    for h in range(height - 1, initial_height - 1, -1):
        block = block_store.load_block(h)
        if block is None:
            break
        if block.is_batch_point() or h == initial_height:
            cache.update_start_point(block)
            break
        blocks_desc.append(block)
    for block in reversed(blocks_desc):
        cache.append_block(block)
    return cache.batch_start_height, cache.batch_start_time_ns
