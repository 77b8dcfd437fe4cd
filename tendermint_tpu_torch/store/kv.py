"""Minimal ordered KV port (the reference's tm-db interface shape:
Get/Set/Delete/Iterator/Batch) with sqlite3 and in-memory engines."""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator, Optional, Protocol


class KV(Protocol):
    def get(self, key: bytes) -> Optional[bytes]: ...

    def set(self, key: bytes, value: bytes) -> None: ...

    def delete(self, key: bytes) -> None: ...

    def iterate(
        self, start: bytes = b"", end: Optional[bytes] = None
    ) -> Iterator[tuple[bytes, bytes]]: ...

    def write_batch(self, sets: list[tuple[bytes, bytes]], deletes: list[bytes]) -> None: ...

    def close(self) -> None: ...


class MemKV:
    """Dict-backed KV for tests (tm-db memdb analog)."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._d.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self._d[key] = value

    def delete(self, key: bytes) -> None:
        self._d.pop(key, None)

    def iterate(self, start: bytes = b"", end: Optional[bytes] = None):
        for k in sorted(self._d):
            if k < start:
                continue
            if end is not None and k >= end:
                break
            yield k, self._d[k]

    def write_batch(self, sets, deletes) -> None:
        for k, v in sets:
            self._d[k] = v
        for k in deletes:
            self._d.pop(k, None)

    def close(self) -> None:
        pass


class SqliteKV:
    """sqlite3-backed KV. WAL journal mode: consensus needs durable,
    crash-consistent writes (the analog of goleveldb's fsync writes)."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv"
                " (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)
            ).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value)
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def iterate(self, start: bytes = b"", end: Optional[bytes] = None):
        with self._lock:
            if end is None:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (start,)
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                    (start, end),
                ).fetchall()
        yield from rows

    def write_batch(self, sets, deletes) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", sets
            )
            if deletes:
                self._conn.executemany(
                    "DELETE FROM kv WHERE k = ?", [(k,) for k in deletes]
                )
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def open_kv(backend: str, path: str = "") -> KV:
    if backend == "memdb":
        return MemKV()
    if backend == "sqlite":
        return SqliteKV(path)
    raise ValueError(f"unknown db backend {backend!r}")
