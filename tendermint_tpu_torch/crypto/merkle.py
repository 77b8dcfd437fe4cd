"""RFC 6962 Merkle tree (host) — block/header/txs/validator-set hashing.

Reference: crypto/merkle/tree.go:9-93 (HashFromByteSlices), proof.go:52
(Merkle proofs). Leaf/inner prefixing per RFC 6962 prevents second-preimage
attacks: leaf = SHA-256(0x00 || data), inner = SHA-256(0x01 || l || r),
empty tree hash = SHA-256("").

All hashing is on the host. The device leaf-hash branch of the JAX package
(gated by TM_TPU_DEVICE_MERKLE_MIN) is not ported: it waits on the SHA-256
kernel (ROADMAP "gated kernels"). Until then a batch that the gate would
send to the device raises instead of quietly hashing somewhere else.
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


DEVICE_LEAF_MIN = int(os.environ.get("TM_TPU_DEVICE_MERKLE_MIN", "0") or 0)


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _sha256(b"")
    if DEVICE_LEAF_MIN and n >= DEVICE_LEAF_MIN:
        raise NotImplementedError(
            "TM_TPU_DEVICE_MERKLE_MIN: device merkle leaves wait on the "
            "SHA-256 kernel (ROADMAP: gated kernels)"
        )
    leaves = [leaf_hash(x) for x in items]
    return _root_from_leaf_hashes(leaves)


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
