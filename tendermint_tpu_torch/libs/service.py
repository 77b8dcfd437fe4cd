"""Service lifecycle — start/stop/quit contract for every long-lived component.

Reference: libs/service/service.go:24-97 (`Service`/`BaseService`): idempotent
Start/Stop, a Quit channel, Reset. Here the same contract on asyncio: a
Service owns a set of tasks; `stop()` cancels them and awaits; `wait_stopped`
is the Quit channel analog.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .log import Logger, default_logger


class Service:
    """Base lifecycle. Subclasses override on_start/on_stop."""

    def __init__(self, name: str, logger: Optional[Logger] = None):
        self.name = name
        self.logger = (logger or default_logger()).with_fields(module=name)
        self._running = False
        self._stopped_ev: Optional[asyncio.Event] = None
        self._tasks: list[asyncio.Task] = []

    @property
    def is_running(self) -> bool:
        return self._running

    async def start(self) -> None:
        if self._running:
            raise RuntimeError(f"service {self.name} already started")
        self._stopped_ev = asyncio.Event()
        self._running = True
        self.logger.info("service start")
        try:
            await self.on_start()
        except BaseException:
            self._running = False
            self._stopped_ev.set()
            raise

    async def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self.logger.info("service stop")
        await self.on_stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self._stopped_ev:
            self._stopped_ev.set()

    async def wait_stopped(self) -> None:
        if self._stopped_ev:
            await self._stopped_ev.wait()

    def spawn(self, coro, name: str = "") -> asyncio.Task:
        """Track a routine whose lifetime is bounded by this service
        (the goroutine-per-concern pattern, SURVEY.md §2.3)."""
        task = asyncio.get_running_loop().create_task(
            coro, name=f"{self.name}/{name}"
        )
        self._tasks.append(task)
        task.add_done_callback(self._on_task_done)
        return task

    def _on_task_done(self, task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None and self._running:
            self.logger.error(
                "service routine died", routine=task.get_name(), err=repr(exc)
            )

    async def on_start(self) -> None:  # pragma: no cover - override point
        pass

    async def on_stop(self) -> None:  # pragma: no cover - override point
        pass
