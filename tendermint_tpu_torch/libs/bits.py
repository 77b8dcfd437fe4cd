"""BitArray — vote-presence bitmaps for gossip.

Reference: libs/bits (444 LoC, `bits.BitArray`), used by the consensus
reactor's per-peer bookkeeping (consensus/reactor.go PeerState) and
VoteSetBits messages. Backed by a Python int (arbitrary-precision bitmask)
instead of []uint64 — simpler and fast enough on the host plane; the device
plane uses numpy bool arrays and converts at the edge.

Committee-scale note (PERF_ANALYSIS §16): the boolean algebra (`sub`,
`or_`, `and_`, `not_`) was always word-wise — Python big-int ops work a
machine word at a time — but the *enumeration* paths (`ones`,
`pick_random`, `num_set`, `from_indices`) used to walk every bit position
through `get(i)`, costing O(size) Python-level operations per call. The
vote-gossip loop calls them once per peer per tick, so a 200-validator
committee paid 200 attribute lookups + shifts per tick per peer just to
pick one vote. They now run word-wise too: `num_set` is one
`int.bit_count()`, `ones`/`pick_random`/`pick_chunk` extract set bits a
64-bit word at a time (O(words + popcount)), and `from_indices` folds
shifts into one accumulator. Semantics are pinned bit-for-bit against a
per-bit reference implementation by property tests
(tests/test_committee_scale.py).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

# word width for set-bit extraction; matches the []uint64 the reference
# backs BitArray with, and CPython's big-int ops are cheapest at or
# above this granularity
_WORD = 64
_WORD_MASK = (1 << _WORD) - 1


@dataclass
class BitArray:
    size: int
    _bits: int = 0

    @classmethod
    def from_indices(cls, size: int, indices) -> "BitArray":
        ba = cls(size)
        acc = 0
        for i in indices:
            if 0 <= i < size:
                acc |= 1 << i
        ba._bits = acc
        return ba

    @classmethod
    def from_bools(cls, bools) -> "BitArray":
        ba = cls(len(bools))
        acc = 0
        for i, v in enumerate(bools):
            if v:
                acc |= 1 << i
        ba._bits = acc
        return ba

    def get(self, i: int) -> bool:
        if not 0 <= i < self.size:
            return False
        return bool((self._bits >> i) & 1)

    def set(self, i: int, v: bool) -> bool:
        if not 0 <= i < self.size:
            return False
        if v:
            self._bits |= 1 << i
        else:
            self._bits &= ~(1 << i)
        return True

    def _mask(self) -> int:
        return (1 << self.size) - 1

    def copy(self) -> "BitArray":
        return BitArray(self.size, self._bits)

    def or_(self, other: "BitArray") -> "BitArray":
        size = max(self.size, other.size)
        return BitArray(size, self._bits | other._bits)

    def and_(self, other: "BitArray") -> "BitArray":
        size = min(self.size, other.size)
        return BitArray(size, self._bits & other._bits & ((1 << size) - 1))

    def not_(self) -> "BitArray":
        return BitArray(self.size, ~self._bits & self._mask())

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (reference `Sub`)."""
        return BitArray(self.size, self._bits & ~other._bits & self._mask())

    def is_empty(self) -> bool:
        return self._bits == 0

    def is_full(self) -> bool:
        return self.size > 0 and self._bits == self._mask()

    def merge(self, other: "BitArray") -> None:
        """In-place OR of `other`'s bits (clipped to our size) — a
        possession digest folds into the stored per-peer bitmap without
        replacing the object other code holds a reference to."""
        self._bits |= other._bits & self._mask()

    def update(self, indices) -> None:
        """Set every index in `indices` (word-wise batch of `set(i, True)`
        — the gossip send path marks a whole shipped chunk at once)."""
        acc = 0
        size = self.size
        for i in indices:
            if 0 <= i < size:
                acc |= 1 << i
        self._bits |= acc

    def pick_random(self) -> tuple[int, bool]:
        """A uniformly random set bit (reference PickRandom) — used by vote
        gossip to choose which missing vote to send."""
        n = self.num_set()
        if n == 0:
            return 0, False
        return self._select(secrets.randbelow(n)), True

    def pick_chunk(self, limit: int) -> list[int]:
        """Up to `limit` set-bit indices, starting at a uniformly random
        set bit and wrapping — the batched-gossip analog of pick_random:
        every set bit is equally likely to lead the chunk, so concurrent
        peers don't all ship the same prefix, and `limit >= num_set()`
        returns every set bit."""
        ones = self.ones()
        n = len(ones)
        if n == 0 or limit <= 0:
            return []
        if limit >= n:
            return ones
        start = secrets.randbelow(n)
        take = ones[start:] + ones[:start]
        return take[:limit]

    def _select(self, k: int) -> int:
        """Index of the k-th set bit (0-based), word-wise: skip whole
        words by popcount, then walk the one word that holds it."""
        bits = self._bits & self._mask()
        base = 0
        while True:
            word = bits & _WORD_MASK
            c = word.bit_count()
            if k < c:
                while True:
                    lsb = word & -word
                    if k == 0:
                        return base + lsb.bit_length() - 1
                    word ^= lsb
                    k -= 1
            k -= c
            bits >>= _WORD
            base += _WORD

    def ones(self) -> list[int]:
        """Sorted indices of every set bit, extracted a word at a time
        (O(words + popcount), not O(size) Python ops)."""
        out: list[int] = []
        bits = self._bits & self._mask()
        base = 0
        while bits:
            word = bits & _WORD_MASK
            while word:
                lsb = word & -word
                out.append(base + lsb.bit_length() - 1)
                word ^= lsb
            bits >>= _WORD
            base += _WORD
        return out

    def num_set(self) -> int:
        return (self._bits & self._mask()).bit_count()

    def to_bytes(self) -> bytes:
        nbytes = (self.size + 7) // 8
        return self._bits.to_bytes(nbytes, "little")

    @classmethod
    def from_bytes(cls, size: int, data: bytes) -> "BitArray":
        ba = cls(size)
        ba._bits = int.from_bytes(data, "little") & ba._mask()
        return ba

    def __str__(self) -> str:
        bits = self._bits
        return "".join(
            "x" if (bits >> i) & 1 else "_" for i in range(self.size)
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.size == other.size
            and self._bits == other._bits
        )
