"""ThrottleTimer — burst-coalescing timer (reference libs/timer/
throttle_timer.go).

Fires at most once per `dur` no matter how many Set() calls arrive: a
burst of sets produces one fire `dur` later (throttle_timer.go:10-14).
The reference feeds a channel; here the fire invokes an async callback
on the event loop (the host plane is asyncio, not goroutines).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional


class ThrottleTimer:
    def __init__(
        self,
        name: str,
        dur: float,
        callback: Callable[[], Awaitable[None]],
    ):
        self.name = name
        self.dur = dur
        self._callback = callback
        self._handle: Optional[asyncio.TimerHandle] = None
        self._stopped = False

    def set(self) -> None:
        """Schedule a fire `dur` from now unless one is already pending."""
        if self._stopped or self._handle is not None:
            return
        loop = asyncio.get_running_loop()
        self._handle = loop.call_later(self.dur, self._fire)

    def unset(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def _fire(self) -> None:
        self._handle = None
        if not self._stopped:
            asyncio.get_running_loop().create_task(
                self._callback(), name=f"throttle-timer/{self.name}"
            )

    def stop(self) -> None:
        self._stopped = True
        self.unset()
