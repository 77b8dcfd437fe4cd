"""Adaptive vote micro-batcher — the consensus-latency/TPU-batching bridge.

SURVEY.md §7.3 hard part 3: consensus wants per-vote latency (votes arrive
one at a time through gossip — §3.3), the device wants batches. Built on
the shared self-clocking machinery in consensus/microbatch.py; under light
load a vote is verified almost immediately (batch of 1 → host fast path
inside BatchVerifier), under load batches grow to the device's appetite.

Reference counterpart: none — the reference verifies serially inside
addVote under the consensus mutex (consensus/state.go:2274-2519,
types/vote_set.go:205). The reactor calls `submit()` BEFORE enqueueing the
vote to the state machine, making types/vote_set.py's "through the TPU
micro-batcher before insertion" contract true.
"""

from __future__ import annotations

from typing import Optional

from ..crypto.batch_verifier import (
    BatchVerifier,
    SigItem,
    default_verifier,
    is_default_verifier,
)
from ..libs.log import Logger
from .microbatch import MicroBatcher


class VoteBatcher(MicroBatcher):
    def __init__(
        self,
        verifier: Optional[BatchVerifier] = None,
        max_batch: int = 8192,
        logger: Optional[Logger] = None,
    ):
        # an ed25519 rejection only drops the one vote — False is safe
        super().__init__(max_batch=max_batch, logger=logger,
                         error_verdict=False)
        # bound to the shared verifier (the common case) the batcher
        # routes through the process dispatch scheduler, so vote batches
        # coalesce with blocksync/light/evidence work under consensus
        # priority; an explicitly-injected verifier (tests) keeps its
        # private path
        self._route_scheduler = is_default_verifier(verifier)
        self.verifier = verifier or default_verifier()

    async def submit(self, pubkey: bytes, msg: bytes, sig: bytes,
                     key_type: str = "ed25519") -> bool:
        """Queue one signature; resolves to its verdict."""
        verdict = await self.submit_item(SigItem(pubkey, msg, sig, key_type))
        return bool(verdict)

    async def submit_many(self, sigs: list) -> list[bool]:
        """Queue a whole vote-batch chunk — `sigs` is (pubkey, msg, sig,
        key_type) tuples — as ONE submission: the chunk rides a single
        _verify_items call and therefore a single scheduler dispatch
        round, instead of N per-vote submits trickling into whatever
        batch windows happen to be open."""
        verdicts = await self.submit_items(
            [SigItem(pk, msg, sig, kt) for pk, msg, sig, kt in sigs]
        )
        return [bool(v) for v in verdicts]

    def _verify_items(self, items: list) -> list:
        # runs in an executor thread (microbatch.py) — the scheduler's
        # blocking bridge is safe here and keeps the loop live
        if self._route_scheduler:
            from ..parallel.scheduler import default_dispatch

            return [
                bool(v)
                for v in default_dispatch("consensus").verify(items)
            ]
        return [bool(v) for v in self.verifier.verify(items)]
