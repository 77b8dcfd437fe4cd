"""LightBlockCache — assemble each height's proof once, serve it to all.

A light client's `light_block(h)` costs the serving node three store
reads (meta, commit, validator set) plus the LightBlock assembly; a
thousand clients bisecting the same chain would repeat that work per
client per height. This cache does the assembly once per height and
serves the shared object.

Admission is pinned to the DURABLE height of the block store:

- the canonical commit for height h lives in block h+1's LastCommit, so
  an entry is only cacheable once h+1 exists — the seen commit at the
  tip may still be superseded by the canonical one and is served fresh,
  never cached;
- under the write-behind store "exists" means DURABLY saved:
  `durable_height` trails the logical height, and a crash replays from
  the durable range — an entry cached above it could outlive a rewind.
  Serving (not caching) reads the pending overlay like every other
  consumer;
- a rollback (`prune_blocks_since`) moves the durable height down;
  cached entries at/above it are dropped on next access instead of
  served stale (the "invalidation pinned to the durable height" rule).

Reference counterpart: none — the reference assembles commit+validators
per RPC request (rpc/core/blocks.go, consensus.go) with no cache.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from ..libs.metrics import LightServeMetrics, default_metrics
from ..light.types import LightBlock

DEFAULT_CACHE_SIZE = 1024


class LightBlockCache:
    def __init__(
        self,
        block_store,
        state_store,
        chain_id: str = "",
        max_entries: int = DEFAULT_CACHE_SIZE,
        metrics: Optional[LightServeMetrics] = None,
    ):
        self._block_store = block_store
        self._state_store = state_store
        self.chain_id = chain_id
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[int, LightBlock]" = OrderedDict()
        # RPC handlers run on the event loop, the swarm harness and the
        # write-behind worker touch stores from threads — cheap lock
        self._lock = threading.Lock()
        self.metrics = metrics or default_metrics(LightServeMetrics)
        # rollback detector: the durable watermark only ever moves up in
        # normal operation — observing it move DOWN means a rollback
        # happened, and every entry at/above the new watermark may no
        # longer match what the store will re-sync (see get())
        self._durable_seen = 0
        self.hits = 0
        self.misses = 0
        self.assembled = 0

    # --- durability pin -----------------------------------------------------

    def _durable_height(self) -> int:
        """Last height the store guarantees survives a crash: the
        write-behind store's durable watermark, or the plain store's
        height (synchronous saves are always durable)."""
        d = getattr(self._block_store, "durable_height", None)
        return int(d) if d is not None else self._block_store.height

    # --- the one entry point ------------------------------------------------

    def get_compressed(self, height: int = 0) -> Optional[LightBlock]:
        """The QC-compressed proof for `height`: header + validator set
        + QuorumCertificate, NO CommitSigs — the N-CommitSig payload a
        million-client read plane should not be shipping per request
        drops to ~100 bytes + signer bitset. Falls back to the full
        proof on heights without a canonical QC (legacy blocks, the
        tip). Shares the full-proof cache entry: the compressed view is
        a cheap per-request reshape, never a second assembly."""
        lb = self.get(height)
        if lb is None or lb.qc is None:
            return lb
        return LightBlock(lb.header, None, lb.validators, qc=lb.qc)

    def get(self, height: int = 0) -> Optional[LightBlock]:
        """The LightBlock for `height` (0 = the store head), cached when
        its canonical commit is durable, assembled fresh otherwise."""
        h = int(height) or self._block_store.height
        if h <= 0:
            return None
        durable = self._durable_height()
        with self._lock:
            if durable < self._durable_seen:
                # rollback observed: entries at/above the new watermark
                # could outlive a re-synced (different) chain, and once
                # the watermark recovers the per-entry `h < durable`
                # guard below can't tell — drop them now. (A rollback
                # whose dip-and-recover happens with NO intervening
                # access is not observable here; prune_blocks_since is
                # an offline op in practice, where the process restart
                # empties the cache anyway.)
                for stale in [k for k in self._entries if k >= durable]:
                    del self._entries[stale]
                self.metrics.cache_size.set(len(self._entries))
            self._durable_seen = durable
            lb = self._entries.get(h)
            if lb is not None:
                if h < durable:
                    self._entries.move_to_end(h)
                    self.hits += 1
                    self.metrics.cache_hits.inc()
                    return lb
                # rollback below the entry: never serve a proof the
                # store no longer stands behind
                del self._entries[h]
                self.metrics.cache_size.set(len(self._entries))
            self.misses += 1
            self.metrics.cache_misses.inc()
        lb = self._assemble(h)
        if lb is None:
            return None
        # cacheable iff the canonical commit (block h+1) is durable
        if h < durable:
            with self._lock:
                self._entries[h] = lb
                self._entries.move_to_end(h)
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                self.metrics.cache_size.set(len(self._entries))
        return lb

    def _assemble(self, h: int) -> Optional[LightBlock]:
        t0 = time.perf_counter()
        meta = self._block_store.load_block_meta(h)
        if meta is None:
            return None
        # canonical commit first (block h+1's LastCommit); the seen
        # commit only serves the tip, where no canonical one exists yet
        commit = self._block_store.load_block_commit(h)
        if commit is None:
            commit = self._block_store.load_seen_commit(h)
        if commit is None:
            return None
        vals = self._state_store.load_validators(h)
        if vals is None:
            return None
        # canonical QC (block h+1's last_qc) rides the same entry; None
        # on legacy heights and at the tip
        qc = None
        load_qc = getattr(self._block_store, "load_block_qc", None)
        if load_qc is not None:
            qc = load_qc(h)
        self.assembled += 1
        self.metrics.cache_assemble_seconds.observe(
            time.perf_counter() - t0
        )
        return LightBlock(meta.header, commit, vals, qc=qc)

    # --- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        with self._lock:
            size = len(self._entries)
        return {
            "hits": self.hits,
            "misses": self.misses,
            "assembled": self.assembled,
            "hit_rate": round(self.hit_rate(), 4),
            "size": size,
            "durable_height": self._durable_height(),
        }
