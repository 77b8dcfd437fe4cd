"""Deadlock-detecting synchronization (reference libs/sync/deadlock.go).

The reference swaps every mutex for go-deadlock's checking variant when
built with `-tags deadlock` (deadlock.go:1-18): lock acquisitions that
wait longer than a threshold dump all goroutine stacks and abort. The
host runtime here is asyncio + a few worker threads, so the analog is:

- `Lock` / `RLock`: threading locks that, when `TM_DEADLOCK` is set (the
  build-tag analog — an env var, checked once at import), raise
  `DeadlockError` with a full thread-stack dump if an acquisition stalls
  past the threshold.
- `watchdog()`: an asyncio task that detects a stalled event loop (the
  asyncio equivalent of a deadlock: a coroutine hogging or blocking the
  loop) and dumps every task's stack.

This is also the repo's race/sanitizer infra (SURVEY.md §5): tests run
with TM_DEADLOCK=1 to turn silent stalls into loud failures.
"""

from __future__ import annotations

import asyncio
import faulthandler
import os
import sys
import threading
import traceback
from typing import Optional

DEADLOCK_ENABLED = bool(os.environ.get("TM_DEADLOCK"))
DEFAULT_TIMEOUT = float(os.environ.get("TM_DEADLOCK_TIMEOUT", "30"))


class DeadlockError(Exception):
    pass


def dump_all_stacks(header: str = "") -> str:
    """Every thread's stack (shared by the watchdog and the node's
    /debug/pprof/goroutine route)."""
    import threading

    names = {t.ident: t.name for t in threading.enumerate()}
    lines = [header] if header else []
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        lines.extend(traceback.format_stack(frame))
    return "\n".join(lines)


_dump_all_stacks = dump_all_stacks  # historical internal name


class Lock:
    """threading.Lock that detects stalled acquisitions when enabled."""

    def __init__(self, timeout: float = DEFAULT_TIMEOUT):
        self._lock = threading.Lock()
        self._timeout = timeout

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not DEADLOCK_ENABLED or not blocking:
            return self._lock.acquire(blocking, timeout)
        if 0 <= timeout < self._timeout:
            # caller's timed acquire is shorter than the deadlock window:
            # preserve the timed-API contract (may return False)
            return self._lock.acquire(True, timeout)
        got = self._lock.acquire(True, self._timeout)
        if not got:
            raise DeadlockError(
                _dump_all_stacks(
                    f"lock not acquired within {self._timeout}s — "
                    "probable deadlock; thread stacks:"
                )
            )
        return True

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class EventLoopWatchdog:
    """Detects a blocked asyncio loop and dumps stacks (aux row: race/
    deadlock detection).

    A daemon thread expects a heartbeat flag flipped by a loop task every
    `interval`; if the loop misses `misses` beats the watchdog dumps all
    thread + task stacks to stderr (via faulthandler, signal-safe).
    """

    def __init__(self, interval: float = 5.0, misses: int = 3):
        self._interval = interval
        self._misses = misses
        self._beat = 0
        self._task: Optional[asyncio.Task] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    async def _heartbeat(self) -> None:
        while not self._stop.is_set():
            self._beat += 1
            await asyncio.sleep(self._interval)

    def _watch(self) -> None:
        last, stalls = -1, 0
        while not self._stop.wait(self._interval):
            if self._beat == last:
                stalls += 1
                if stalls >= self._misses:
                    sys.stderr.write(
                        f"watchdog: event loop stalled "
                        f">{self._interval * self._misses:.0f}s; stacks:\n"
                    )
                    try:
                        faulthandler.dump_traceback(file=sys.stderr)
                    except Exception:
                        # non-fd stderr (captured): python-level dump
                        sys.stderr.write(_dump_all_stacks(""))
                    stalls = 0
            else:
                stalls = 0
            last = self._beat

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._heartbeat(), name="sync/watchdog-heartbeat"
        )
        self._thread = threading.Thread(
            target=self._watch, name="sync/watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._task:
            self._task.cancel()
