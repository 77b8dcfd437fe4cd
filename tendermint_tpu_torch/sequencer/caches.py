"""Bounded caches for sequencer-mode gossip and sync.

Reference: sequencer/block_cache.go (BlockRingBuffer), pending_cache.go
(PendingBlockCache with longest-chain selection), hash_set.go (HashSet /
PeerHashSet dedupe with FIFO eviction). Capacities mirror
broadcast_reactor.go:29-34.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..types.block_v2 import BlockV2

MAX_PENDING_BLOCKS = 500
MAX_PENDING_HEIGHT_AHEAD = 100
MAX_PENDING_HEIGHT_BEHIND = 20


class BlockRingBuffer:
    """Fixed-capacity ring of recently applied blocks, indexed by height
    (reference sequencer/block_cache.go)."""

    def __init__(self, capacity: int = 1000):
        self._capacity = capacity
        self._by_height: OrderedDict[int, BlockV2] = OrderedDict()

    def add(self, block: BlockV2) -> None:
        self._by_height[block.number] = block
        self._by_height.move_to_end(block.number)
        while len(self._by_height) > self._capacity:
            self._by_height.popitem(last=False)

    def get_by_height(self, height: int) -> Optional[BlockV2]:
        return self._by_height.get(height)

    def __len__(self) -> int:
        return len(self._by_height)


class HashSet:
    """Bounded seen-set with FIFO eviction (reference sequencer/hash_set.go)."""

    def __init__(self, capacity: int = 2000):
        self._capacity = capacity
        self._items: OrderedDict[bytes, None] = OrderedDict()

    def add(self, h: bytes) -> bool:
        """Add; returns True if it was ALREADY present (duplicate)."""
        if h in self._items:
            return True
        self._items[h] = None
        while len(self._items) > self._capacity:
            self._items.popitem(last=False)
        return False

    def discard(self, h: bytes) -> None:
        self._items.pop(h, None)

    def __contains__(self, h: bytes) -> bool:
        return h in self._items

    def __len__(self) -> int:
        return len(self._items)


class PeerHashSet:
    """Per-peer bounded sent-set (reference sequencer/hash_set.go
    PeerHashSet; capacity per broadcast_reactor.go:33)."""

    def __init__(self, capacity_per_peer: int = 500):
        self._capacity = capacity_per_peer
        self._peers: dict[str, HashSet] = {}

    def add_peer(self, peer_id: str) -> None:
        self._peers.setdefault(peer_id, HashSet(self._capacity))

    def remove_peer(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)

    def add(self, peer_id: str, h: bytes) -> None:
        self._peers.setdefault(peer_id, HashSet(self._capacity)).add(h)

    def contains(self, peer_id: str, h: bytes) -> bool:
        s = self._peers.get(peer_id)
        return s is not None and h in s


class PendingBlockCache:
    """Blocks that cannot be applied yet: future blocks, unverified-signer
    blocks, and recent past blocks for reorg (reference
    sequencer/pending_cache.go)."""

    def __init__(self):
        self._blocks: dict[bytes, BlockV2] = {}
        self._by_parent: dict[bytes, list[BlockV2]] = {}

    def add(self, block: BlockV2, local_height: int) -> bool:
        min_h = max(0, local_height - MAX_PENDING_HEIGHT_BEHIND)
        max_h = local_height + MAX_PENDING_HEIGHT_AHEAD
        if not (min_h <= block.number <= max_h):
            return False
        if len(self._blocks) >= MAX_PENDING_BLOCKS:
            return False
        if block.hash in self._blocks:
            return False
        self._blocks[block.hash] = block
        self._by_parent.setdefault(block.parent_hash, []).append(block)
        return True

    def get(self, h: bytes) -> Optional[BlockV2]:
        return self._blocks.get(h)

    def get_children(self, parent_hash: bytes) -> list[BlockV2]:
        return list(self._by_parent.get(parent_hash, ()))

    def get_longest_chain(
        self, parent_hash: bytes, _visited: Optional[set] = None
    ) -> list[BlockV2]:
        """Longest pending chain rooted at parent_hash, in apply order
        (reference pending_cache.go GetLongestChain). Hash/parent links are
        attacker-controlled wire fields, so traversal carries a visited set
        — a crafted 2-block cycle must not recurse unboundedly."""
        visited = _visited if _visited is not None else {parent_hash}
        longest: list[BlockV2] = []
        for child in self._by_parent.get(parent_hash, ()):
            if child.hash in visited:
                continue
            chain = [child] + self.get_longest_chain(
                child.hash, visited | {child.hash}
            )
            if len(chain) > len(longest):
                longest = chain
        return longest

    def remove(self, h: bytes) -> None:
        """Drop one pending block by hash (a forged copy that failed
        signature/apply must free its slot, or the genuine block of the
        same hash could never re-enter — add() dedupes by hash)."""
        block = self._blocks.pop(h, None)
        if block is None:
            return
        sibs = self._by_parent.get(block.parent_hash)
        if sibs:
            sibs[:] = [b for b in sibs if b.hash != h]
            if not sibs:
                del self._by_parent[block.parent_hash]

    def prune_below(self, height: int) -> None:
        for h, block in list(self._blocks.items()):
            if block.number <= height:
                del self._blocks[h]
                sibs = self._by_parent.get(block.parent_hash)
                if sibs:
                    sibs[:] = [b for b in sibs if b.hash != h]
                    if not sibs:
                        del self._by_parent[block.parent_hash]

    def size(self) -> int:
        return len(self._blocks)
