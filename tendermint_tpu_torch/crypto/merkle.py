"""RFC 6962 Merkle tree (host) — block/header/txs/validator-set hashing.

Reference: crypto/merkle/tree.go:9-93 (HashFromByteSlices), proof.go:52
(Merkle proofs). Leaf/inner prefixing per RFC 6962 prevents second-preimage
attacks: leaf = SHA-256(0x00 || data), inner = SHA-256(0x01 || l || r),
empty tree hash = SHA-256("").

With TM_TPU_DEVICE_MERKLE_MIN set, a batch of at least that many leaves,
none longer than DEVICE_LEAF_MAX_BYTES, hashes its LEAVES as one batch on
the process verifier's device (the SHA-256 kernel, ops/sha256.py; its
plain version when that verifier runs on the CPU); the fold stays on the
host. The JAX package's gate, with one difference: where its device path
fails it warns and hashes on the host, and here the failure is raised.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(data: bytes) -> bytes:
    return _sha256(b"\x00" + data)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(b"\x01" + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


# Batches >= this many leaves hash their leaves on the device; 0 (the
# default) keeps every batch on the host
DEVICE_LEAF_MIN = int(os.environ.get("TM_TPU_DEVICE_MERKLE_MIN", "0") or 0)
# one oversized leaf would pad EVERY row's buffer to its length class
# (the same cap as the device SHA-512 path, batch_verifier.py)
DEVICE_LEAF_MAX_BYTES = 2048


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _sha256(b"")
    if (
        DEVICE_LEAF_MIN
        and n >= DEVICE_LEAF_MIN
        and max(len(x) for x in items) <= DEVICE_LEAF_MAX_BYTES
    ):
        leaves = _device_leaf_hashes(items)
    else:
        leaves = [leaf_hash(x) for x in items]
    return _root_from_leaf_hashes(leaves)


# shape buckets of the leaf batch: a handful of shapes, not one per
# (batch, length-class) pair, as in the JAX package
_LEAF_BATCH_BUCKETS = (64, 256, 1024, 4096, 16384)


def _device_leaf_hashes(items: list[bytes]) -> list[bytes]:
    """All RFC 6962 leaf hashes as ONE device batch (0x00-prefixed, ragged
    lengths padded on the host by ops/sha256.pad_messages), the batch and
    block-count axes padded up to buckets."""
    import numpy as np
    import torch

    from ..ops import sha256 as dsha
    from .batch_verifier import default_verifier

    n = len(items)
    b = next((x for x in _LEAF_BATCH_BUCKETS if x >= n), None)
    if b is None:
        q = _LEAF_BATCH_BUCKETS[-1]
        b = ((n + q - 1) // q) * q
    buf, counts = dsha.pad_messages(items + [b""] * (b - n), prefix=b"\x00")
    # round the block axis up to a power of two (length classes)
    nblk = buf.shape[1] // 64
    nblk_b = 1 << (nblk - 1).bit_length()
    if nblk_b != nblk:
        buf = np.pad(buf, ((0, 0), (0, (nblk_b - nblk) * 64)))
    dev = default_verifier().device
    out = dsha.sha256_batch(
        torch.from_numpy(buf).to(dev), torch.from_numpy(counts).to(dev)
    ).cpu().numpy()
    return [bytes(row) for row in out[:n]]


def _root_from_leaf_hashes(leaves: list[bytes]) -> bytes:
    """RFC 6962 fold over precomputed leaf hashes (n >= 1)."""
    n = len(leaves)
    if n == 1:
        return leaves[0]
    k = _split_point(n)
    return inner_hash(
        _root_from_leaf_hashes(leaves[:k]), _root_from_leaf_hashes(leaves[k:])
    )


@dataclass
class Proof:
    """Merkle inclusion proof (reference crypto/merkle/proof.go:52)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def compute_root(self) -> bytes:
        return _compute_from_aunts(
            self.index, self.total, self.leaf_hash, self.aunts
        )

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        try:
            return self.compute_root() == root
        except ValueError:
            return False


def _compute_from_aunts(
    index: int, total: int, leaf: bytes, aunts: list[bytes]
) -> bytes:
    if total == 0:
        raise ValueError("empty tree")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts")
        return leaf
    if not aunts:
        raise ValueError("missing aunts")
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, leaf, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, leaf, aunts[:-1])
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(
    items: list[bytes],
) -> tuple[bytes, list[Proof]]:
    """Root + one inclusion proof per item (reference ProofsFromByteSlices)."""
    trails, root_node = _trails_from_byte_slices(items)
    root = root_node.hash if root_node else _sha256(b"")
    proofs = []
    for i, trail in enumerate(trails):
        proofs.append(
            Proof(
                total=len(items),
                index=i,
                leaf_hash=trail.hash,
                aunts=trail.flatten_aunts(),
            )
        )
    return root, proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = self.left = self.right = None

    def flatten_aunts(self) -> list[bytes]:
        aunts = []
        node = self
        while node.parent is not None:
            sibling = (
                node.parent.right
                if node.parent.left is node
                else node.parent.left
            )
            if sibling is not None:
                aunts.append(sibling.hash)
            node = node.parent
        return aunts


def _trails_from_byte_slices(items: list[bytes]):
    if len(items) == 0:
        return [], None
    if len(items) == 1:
        node = _Node(leaf_hash(items[0]))
        return [node], node
    k = _split_point(len(items))
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    root.left, root.right = left_root, right_root
    left_root.parent = right_root.parent = root
    return lefts + rights, root
