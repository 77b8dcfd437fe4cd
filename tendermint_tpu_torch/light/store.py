"""Trusted light-block store (reference light/store/db/db.go).

KV-backed, height-indexed, pruned to a bounded size. The store IS the
light client's checkpoint: restart resumes from the latest trusted block.
The height index is cached in memory (one scan at construction) so
latest()/prune() on the verify hot path don't re-scan the KV range —
the bisection bulk workload calls them per verified height.
"""

from __future__ import annotations

from typing import Optional

from .types import LightBlock

_PREFIX = b"lb/"
_END = _PREFIX + b"\xff" * 9


def _key(height: int) -> bytes:
    return _PREFIX + height.to_bytes(8, "big")


class LightStore:
    def __init__(self, kv):
        self._kv = kv
        self._heights: list[int] = sorted(
            int.from_bytes(k[len(_PREFIX):], "big")
            for k, _v in kv.iterate(_PREFIX, _END)
        )

    def save(self, lb: LightBlock) -> None:
        self._kv.set(_key(lb.height), lb.encode())
        if not self._heights or lb.height > self._heights[-1]:
            self._heights.append(lb.height)
        elif lb.height not in self._heights:
            import bisect

            bisect.insort(self._heights, lb.height)

    def get(self, height: int) -> Optional[LightBlock]:
        data = self._kv.get(_key(height))
        return LightBlock.decode(data) if data is not None else None

    def latest(self) -> Optional[LightBlock]:
        return self.get(self._heights[-1]) if self._heights else None

    def first(self) -> Optional[LightBlock]:
        return self.get(self._heights[0]) if self._heights else None

    def heights(self) -> list[int]:
        return list(self._heights)

    def delete(self, height: int) -> None:
        self._kv.delete(_key(height))
        try:
            self._heights.remove(height)
        except ValueError:
            pass

    def prune(self, keep: int) -> None:
        """Delete oldest blocks beyond `keep` (reference Prune). The
        latest trusted block is the client's verification anchor — a
        mid-bisection prune (the client prunes per verified height)
        must never evict it, so `keep` is clamped to >= 1."""
        excess = len(self._heights) - max(1, keep)
        for h in list(self._heights[:max(0, excess)]):
            self.delete(h)

    def delete_after(self, height: int) -> None:
        """Remove all blocks above `height` (fork cleanup)."""
        for h in [h for h in self._heights if h > height]:
            self.delete(h)
