"""Crash-point injection for crash-consistency tests.

Reference: libs/fail/fail.go:27-39 — `fail.Fail()` call sites between every
step of finalizeCommit/ApplyBlock (consensus/state.go:1823,1838,1861,1887,
1914; state/execution.go:273,281), armed by the FAIL_TEST_INDEX env var.
Same mechanism: the Nth `fail_point()` call os._exit(1)s the process, so
tests can kill a node at every interleaving and assert WAL replay recovers.
"""

from __future__ import annotations

import os

_counter = 0


def _target() -> int:
    v = os.environ.get("FAIL_TEST_INDEX")
    return int(v) if v is not None else -1


def fail_point() -> None:
    global _counter
    t = _target()
    if t < 0:
        return
    if _counter == t:
        # hard exit: no atexit, no flushing — simulates a crash
        os._exit(1)
    _counter += 1


def reset() -> None:
    global _counter
    _counter = 0
