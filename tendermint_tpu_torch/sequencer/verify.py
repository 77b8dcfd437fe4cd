"""Off-loop, coalesced BlockV2 signature verification.

Follower-side ECDSA checks (recover the eth address from the 65-byte
signature over the 32-byte block hash, membership-check it against the
sequencer set) used to run synchronously inside `_on_block_v2` — ON the
event loop, one recover per block. A burst of incoming BlockV2s (catchup
windows, post-heal floods) paid one loop stall per block.

`SequencerVerifyBatcher` rides the shared MicroBatcher machinery: the
burst accumulates while the previous round is in flight, and each round
runs as ONE fn-lane submission through `parallel/scheduler.py` under the
`sequencer` priority class — off the event loop, serialized against the
device rounds of every other verify caller, visible in the scheduler's
dispatch log/round spans like any other class.

Reference counterpart: none — the reference recovers serially inside
onBlockV2 (sequencer/broadcast_reactor.go:251-316).
"""

from __future__ import annotations

from typing import Optional

from ..consensus.microbatch import MicroBatcher
from ..libs.log import Logger


class SequencerVerifyBatcher(MicroBatcher):
    """Verdicts are booleans: True = signed by an allowed sequencer.
    error_verdict=False — a verifier failure rejects the block, which
    only drops the message (the block stays re-receivable; the seen-set
    un-poisoning in the reactor covers the retry)."""

    def __init__(
        self,
        verifier,
        logger: Optional[Logger] = None,
        max_batch: int = 256,
    ):
        super().__init__(
            max_batch=max_batch, logger=logger, error_verdict=False
        )
        self.verifier = verifier

    def _verify_items(self, blocks: list) -> list[bool]:
        # runs on the micro-batcher's executor thread: submit the whole
        # chunk as one scheduler round of the named secp_recover engine,
        # which a remote scheduler ships to the verify service (a closure
        # would run here); the membership check stays on this side, the
        # allowed set being this node's. Degrades to a direct call when
        # no scheduler is installed/running
        from ..parallel.engines import BUILTIN_ENGINES
        from ..parallel.scheduler import default_scheduler

        verifier = self.verifier
        if verifier is None:
            return [False] * len(blocks)
        pairs = [(b.hash, b.signature) for b in blocks]
        recover = BUILTIN_ENGINES["secp_recover"]
        sched = default_scheduler()
        if sched is not None:
            addrs = sched.submit_wire_fn_sync(
                "secp_recover", pairs, klass="sequencer",
                fallback=lambda: recover(pairs),
            )
        else:
            addrs = recover(pairs)
        return [bool(a) and verifier.is_sequencer(a) for a in addrs]
