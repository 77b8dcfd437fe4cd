"""Structured key-value logging with lazy evaluation.

Reference: libs/log (672 LoC) — tmfmt/json loggers, `With(keyvals...)`,
lazy values (log.NewLazyBlockHash, consensus/state.go:1817). Same surface,
stdlib-only: a Logger carries bound fields; values that are callables are
evaluated only when the record is actually emitted.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Optional, TextIO

LEVELS = {"debug": 10, "info": 20, "error": 40, "none": 100}


class Logger:
    def __init__(
        self,
        sink: Optional[TextIO] = None,
        level: str = "info",
        fmt: str = "plain",
        fields: Optional[dict] = None,
    ):
        # None = resolve sys.stderr at emit time (a bound stream may be
        # closed later, e.g. pytest's per-test capture)
        self._sink = sink
        self._level = LEVELS.get(level, 20)
        self._fmt = fmt
        self._fields = fields or {}

    def with_fields(self, **fields: Any) -> "Logger":
        merged = {**self._fields, **fields}
        lg = Logger(self._sink, fmt=self._fmt, fields=merged)
        lg._level = self._level
        return lg

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if LEVELS[level] < self._level:
            return
        record = {**self._fields, **fields}
        # lazy values: only computed when actually logging
        record = {
            k: (v() if callable(v) else v) for k, v in record.items()
        }
        ts = time.strftime("%H:%M:%S", time.localtime())
        sink = self._sink if self._sink is not None else sys.stderr
        try:
            if self._fmt == "json":
                record = {"ts": ts, "level": level, "msg": msg, **record}
                sink.write(json.dumps(record, default=str) + "\n")
            else:
                kvs = " ".join(f"{k}={v}" for k, v in record.items())
                sink.write(f"{level[0].upper()}[{ts}] {msg} {kvs}\n")
        except ValueError:
            pass  # sink closed (interpreter/test teardown): drop the line

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit("info", msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._emit("error", msg, fields)


_default: Optional[Logger] = None


def default_logger() -> Logger:
    global _default
    if _default is None:
        _default = Logger()
    return _default


def nop_logger() -> Logger:
    return Logger(level="none")
