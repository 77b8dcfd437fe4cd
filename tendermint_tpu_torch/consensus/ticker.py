"""Timeout ticker — schedules round-step timeouts into the consensus loop.

Reference: consensus/ticker.go (timeoutTicker :31): one scheduling routine;
a newer schedule replaces an older one (only the latest timeout can fire).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: int  # Step enum value

    def __repr__(self) -> str:
        return f"TO{{{self.duration_s}s {self.height}/{self.round}/{self.step}}}"


class TimeoutTicker:
    def __init__(self, scale: float = 1.0, on_fire=None):
        self._out: asyncio.Queue[TimeoutInfo] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        # clock skew: every scheduled duration is multiplied by this —
        # chaos scenarios skew a node's timeout clock (>1 = slow ticker,
        # <1 = eager) to model drifting local clocks without touching
        # the consensus state machine (chaos/scenario.py "clock_skew")
        self._scale = scale
        # fired-timeout observer (adaptive pacing bookkeeping): called
        # with the TimeoutInfo whenever a schedule actually EXPIRES —
        # replaced/cancelled schedules never reach it, so the callback
        # sees exactly the expiries the state machine will dequeue
        self._on_fire = on_fire

    @property
    def tock_queue(self) -> asyncio.Queue:
        return self._out

    def set_scale(self, scale: float) -> None:
        if scale <= 0:
            raise ValueError("ticker scale must be positive")
        self._scale = scale

    def set_on_fire(self, cb) -> None:
        self._on_fire = cb

    def schedule(self, ti: TimeoutInfo) -> None:
        """Replaces any pending timeout (the reference stops the old timer
        before starting the new one)."""
        if self._task is not None:
            self._task.cancel()
        self._task = asyncio.get_running_loop().create_task(self._fire(ti))

    async def _fire(self, ti: TimeoutInfo) -> None:
        try:
            await asyncio.sleep(ti.duration_s * self._scale)
            if self._on_fire is not None:
                try:
                    self._on_fire(ti)
                except Exception:
                    pass  # an observer must never kill the tick
            self._out.put_nowait(ti)
        except asyncio.CancelledError:
            pass

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
