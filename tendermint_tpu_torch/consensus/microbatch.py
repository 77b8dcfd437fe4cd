"""Shared self-clocking micro-batcher machinery.

The consensus-latency/device-batching bridge used by both the ed25519
vote batcher and the BLS batch-point batcher (SURVEY.md §7.3 hard part
3): whatever work accumulates while the previous verification is in
flight forms the next batch — under light load an item is verified almost
immediately (batch of 1), under load batches grow to the verifier's
appetite with no fixed timer adding latency.

Ordering contract (SURVEY.md §2.3 "asynchronous but order-preserving"):
verdicts resolve strictly in submission order.

Reference counterpart: none — the reference verifies serially inside
addVote under the consensus mutex (consensus/state.go:2274-2519).
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional

from ..libs.log import Logger, nop_logger


class MicroBatcher:
    """Subclasses implement _verify_items(items) -> list of verdicts
    (runs off-loop in an executor thread).

    `error_verdict` is what submitters receive when the verifier raises
    or the batcher stops mid-flight: False means "treat as rejected"
    (safe when rejection only drops a message), None means "unknown —
    fall back to a serial path" (safe when rejection would punish a
    peer for an infrastructure error).
    """

    def __init__(self, max_batch: int = 8192,
                 logger: Optional[Logger] = None,
                 error_verdict=False):
        self.max_batch = max_batch
        self.logger = logger or nop_logger()
        self.error_verdict = error_verdict
        self._queue: list[tuple[object, asyncio.Future]] = []
        self._inflight: list[tuple[object, asyncio.Future]] = []
        self._wakeup: Optional[asyncio.Event] = None
        self._worker: Optional[asyncio.Task] = None
        # telemetry: recent batch sizes (bounded; metrics hook + tests)
        self.batch_sizes: deque[int] = deque(maxlen=1024)

    def _verify_items(self, items: list) -> list:
        raise NotImplementedError

    def _ensure_worker(self) -> None:
        if self._worker is None or self._worker.done():
            self._wakeup = asyncio.Event()
            self._worker = asyncio.create_task(self._run())

    async def submit_item(self, item):
        """Queue one item; resolves to its verdict. Batches form from
        everything queued while the verifier is busy."""
        self._ensure_worker()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._queue.append((item, fut))
        self._wakeup.set()
        return await fut

    async def submit_items(self, items: list) -> list:
        """Queue a whole chunk under ONE wakeup; resolves to the aligned
        verdict list. A committee-sized vote batch lands in the worker's
        next batch as a unit — one _verify_items call (one scheduler
        dispatch round) instead of N trickled submits racing the
        batch-formation window."""
        if not items:
            return []
        self._ensure_worker()
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in items]
        self._queue.extend(zip(items, futs))
        self._wakeup.set()
        return list(await asyncio.gather(*futs))

    async def _run(self) -> None:
        while True:
            if not self._queue:
                self._wakeup.clear()
                await self._wakeup.wait()
            batch, self._queue = (
                self._queue[: self.max_batch],
                self._queue[self.max_batch :],
            )
            items = [it for it, _ in batch]
            self.batch_sizes.append(len(items))
            self._inflight = batch
            try:
                # the verify call blocks; run it off-loop so more items
                # can queue meanwhile (they become the next batch)
                verdicts = await asyncio.get_running_loop().run_in_executor(
                    None, self._verify_items, items
                )
            except asyncio.CancelledError:
                # stop() cancelled us mid-verify: resolve the dequeued
                # batch before unwinding, or its submitters hang forever
                self._resolve_error(batch)
                self._inflight = []
                raise
            except Exception as e:  # verifier failure: don't crash the loop
                self.logger.error("micro-batch verify failed", err=repr(e))
                verdicts = [self.error_verdict] * len(items)
            self._inflight = []
            for (_, fut), valid in zip(batch, verdicts):
                if not fut.cancelled():
                    fut.set_result(valid)

    def _resolve_error(self, batch: list) -> None:
        for _, fut in batch:
            if not fut.done():
                fut.set_result(self.error_verdict)

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            self._worker = None
        # resolve the in-flight batch and anything still queued so
        # awaiting submitters don't hang through shutdown (they see the
        # error verdict, which is safe)
        inflight, self._inflight = self._inflight, []
        self._resolve_error(inflight)
        pending, self._queue = self._queue, []
        self._resolve_error(pending)
