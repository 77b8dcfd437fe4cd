"""Commit pipeline — finalization I/O off the consensus critical path.

PERF_ANALYSIS §12: with device verification dispatch-floor-bound behind
the unified scheduler (§11), the remaining per-height latency is host
finalization — `_finalize_commit` serialized block-store save, WAL
end-height fsync, ABCI/L2 apply and state save before the node could
enter height H+1. This module coordinates the overlapped version:

- block save rides the write-behind store's queue
  (store/block_store.WriteBehindBlockStore),
- the WAL end-height barrier rides the group-commit flush thread
  (consensus/wal.GroupCommitWAL) and is awaited, not blocked on,
- apply_block + state save run as a background *finalization task*
  whose result — the fully-applied State, carrying the next app hash —
  is exposed as a future. The state machine enters NewHeight/Propose
  for H+1 immediately on a provisional state (validators for H+1 are
  known before apply: State.validators(H+1) = next_validators(H));
  only the places that truly consume apply results await the future:
  proposal header construction, header validation at prevote, the
  next finalize, and the sequencer/upgrade switch.

Crash semantics are preserved by construction: the durable state store
only ever advances when apply completes, so WAL catchup replay
(consensus/replay.py) starts from the last *applied* height and
re-drives anything the pipeline had in flight. The new windows —
"WAL end-height written, block save queued but lost" and "block saved,
apply not finished" — land exactly on replay paths that already exist
(crash-before-save and handshake final-block apply respectively);
tests/test_commit_pipeline.py kills a node at each stage boundary and
pins convergence against the serial path.

Reference counterpart: none — reference finalizeCommit is fully
sequential (consensus/state.go:1785-1948).
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Optional

from ..libs.log import Logger, nop_logger
from ..obs import default_tracer


class CommitPipeline:
    """Tracks the one in-flight background finalization task.

    Depth is intentionally 1 for the apply stage: consensus for H+1
    cannot *decide* until H is applied (the proposal header needs H's
    app hash), so deeper apply pipelining buys nothing — the deep
    queues live in the WAL flush thread and the block-store save queue,
    which this object does not own.
    """

    def __init__(
        self,
        metrics=None,
        tracer=None,
        logger: Optional[Logger] = None,
    ):
        self.metrics = metrics
        # is-None check: an empty Tracer is falsy (it has __len__)
        self.tracer = default_tracer() if tracer is None else tracer
        self.logger = logger or nop_logger()
        self._task: Optional[asyncio.Task] = None
        self._height: int = 0
        self.error: Optional[BaseException] = None
        # heights whose apply completed through this pipeline (test /
        # bench introspection)
        self.applied_heights: int = 0

    # --- producer side (the state machine's finalize) -----------------------

    def begin(
        self,
        height: int,
        apply_fn: Callable[[], Awaitable],
        barrier: Optional[Callable[[], Awaitable]] = None,
    ) -> asyncio.Task:
        """Spawn the background finalization task for `height`. The
        caller must have awaited `wait_applied()` first, so at most one
        task is ever in flight.

        `barrier` (QC-chained height pipelining, PERF_ANALYSIS §22)
        chains the apply behind a durability boundary: it is awaited
        BEFORE apply_fn, so nothing this task persists can outrun the
        height's decision record — while the state machine, which no
        longer waits for that fsync inline, is already proposing H+1. A
        barrier failure latches the pipeline error exactly like a failed
        apply: un-durable decisions must wedge, not apply."""
        if self._task is not None and not self._task.done():
            raise RuntimeError(
                f"finalization for height {self._height} still in flight"
            )
        self._height = height
        self._task = asyncio.get_running_loop().create_task(
            self._run(height, apply_fn, barrier),
            name=f"consensus/finalize-{height}",
        )
        return self._task

    async def _run(self, height: int, apply_fn, barrier=None):
        gauge = getattr(self.metrics, "commit_pipeline_depth", None)
        try:
            if barrier is not None:
                await barrier()
            if gauge is not None:
                with gauge.track_inprogress():
                    out = await apply_fn()
            else:
                out = await apply_fn()
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            # a failed apply wedges the pipeline: consumers awaiting the
            # app-hash future re-raise, and no further height may begin
            self.error = e
            self.logger.error(
                "background finalization failed", height=height, err=repr(e)
            )
            raise
        self.applied_heights += 1  # successes only — the counter's contract
        return out

    # --- consumer side (app-hash future) ------------------------------------

    @property
    def inflight_height(self) -> int:
        """Height being applied, or 0 when quiesced."""
        if self._task is not None and not self._task.done():
            return self._height
        return 0

    def pending(self) -> Optional[asyncio.Task]:
        if self._task is not None and not self._task.done():
            return self._task
        return None

    async def wait_applied(self):
        """Await the in-flight finalization (the app-hash future).

        Returns the applied State (or None when quiesced). Callers that
        consume apply results — proposal construction, header
        validation, the next finalize, upgrade switch — sit behind this
        barrier; everything else proceeds on the provisional state. The
        wait is the pipeline's *observable* critical-path cost and is
        recorded as the `commit.pipeline_wait` span."""
        if self.error is not None:
            raise RuntimeError("commit pipeline failed") from self.error
        task = self.pending()
        if task is None:
            t = self._task
            # surface an already-failed apply even when nobody raced it
            if t is not None and t.done() and not t.cancelled():
                if t.exception() is not None:
                    raise RuntimeError(
                        "commit pipeline failed"
                    ) from t.exception()
            return None
        t0 = time.perf_counter()
        try:
            return await asyncio.shield(task)
        finally:
            dur = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.commit_pipeline_wait_seconds.observe(dur)
            self.tracer.add_span(
                "commit.pipeline_wait", t0, dur, height=self._height
            )

    async def drain(self) -> None:
        """Stop-path barrier: wait out the in-flight apply, swallowing
        its error (already latched in `self.error`/logged)."""
        task = self.pending()
        if task is not None:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
