"""Self-clocking micro-batcher for batch-point BLS signature checks.

The reference verifies each batch-point precommit's BLS signature serially
inside addVote (consensus/state.go:2362-2379) — fine in native Go, but a
pairing per vote. Built on consensus/microbatch.py: checks that accumulate
while the previous verification is in flight form the next batch, grouped
by message (a consensus round produces a burst of signatures over ONE
batch hash), and each group verifies as a single random-linear-combination
aggregate — 2 pairings per burst instead of 2 per vote (via the L2 node's
verify_signatures port, crypto/bls_signatures.verify_batch_same_message).

Verdicts are tri-state: True/False are definitive; None means the
verifier itself failed (L2 connection error, shutdown) — the reactor then
falls back to the state machine's serial check instead of punishing the
peer for an infrastructure problem.
"""

from __future__ import annotations

from typing import Optional

from ..libs.log import Logger
from .microbatch import MicroBatcher


class BLSBatcher(MicroBatcher):
    def __init__(self, l2_node, max_batch: int = 4096,
                 logger: Optional[Logger] = None):
        super().__init__(max_batch=max_batch, logger=logger,
                         error_verdict=None)
        self.l2 = l2_node

    async def submit(self, tm_pubkey: bytes, message_hash: bytes,
                     sig: bytes) -> Optional[bool]:
        """True/False = signature verdict; None = could not verify."""
        return await self.submit_item(
            (bytes(tm_pubkey), bytes(message_hash), bytes(sig))
        )

    async def submit_many(self, checks: list) -> list:
        """Queue a whole batch-point chunk — `checks` is (tm_pubkey,
        message_hash, sig) tuples — as ONE submission. A committee-scale
        burst (100-200 dual-signs over one batch hash) then verifies as
        a single fn-lane round: one random-linear-combination aggregate,
        2 pairings, O(1) dispatch rounds per batch point regardless of
        committee size."""
        return await self.submit_items(
            [
                (bytes(pk), bytes(mh), bytes(sig))
                for pk, mh, sig in checks
            ]
        )

    def _verify_items(self, batch: list) -> list:
        """Route the grouped pairing checks through the process dispatch
        scheduler's private-engine lane when one is running (consensus
        priority — BLS rounds then serialize with ed25519 device rounds
        instead of contending for the backend), else verify directly.
        Runs in an executor thread, so the blocking bridge is safe."""
        from ..parallel.engines import _bls_agg_rows
        from ..parallel.scheduler import default_scheduler

        sched = default_scheduler()
        if sched is not None:
            # labeled bls_agg with the true internal bucket exposed:
            # items share the (pk, msg, sig) wire shape, so the engine
            # table's grouping math prices this closure's round too
            def run(items):
                return self._verify_groups(items)

            run.internal_rows = _bls_agg_rows
            return sched.submit_fn_sync(
                batch, run, "consensus", engine="bls_agg"
            )
        return self._verify_groups(batch)

    def _verify_groups(self, batch: list) -> list:
        """Group by message hash, batch-verify each group."""
        from ..crypto.shape_registry import default_shape_registry

        groups: dict[bytes, list[int]] = {}
        for i, (_, msg, _) in enumerate(batch):
            groups.setdefault(msg, []).append(i)
        verdicts: list = [None] * len(batch)
        # fn-lane rounds are program-shaped too: each same-message group
        # is one aggregate verification whose cost scales with the
        # committee-scale bucket it pads to, so the registry counts them
        # under their own tier — bench artifacts then show batch-point
        # aggregation staying O(1) rounds per batch point as the
        # committee grows (the 256 rung is the 100-200 signer home)
        reg = default_shape_registry()
        for msg, idxs in groups.items():
            reg.record_dispatch("bls_agg", reg.bucket_for(len(idxs)))
            pks = [batch[i][0] for i in idxs]
            sigs = [batch[i][2] for i in idxs]
            try:
                batch_fn = getattr(self.l2, "verify_signatures", None)
                if batch_fn is not None:
                    ok = batch_fn(pks, msg, sigs)
                else:
                    ok = [
                        self.l2.verify_signature(pk, msg, s)
                        for pk, s in zip(pks, sigs)
                    ]
            except Exception as e:  # L2 unavailable: unknown, not invalid
                self.logger.error("bls group verify failed", err=repr(e))
                ok = [None] * len(idxs)
            for i, v in zip(idxs, ok):
                verdicts[i] = None if v is None else bool(v)
        return verdicts
