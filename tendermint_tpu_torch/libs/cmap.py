"""CMap — thread-safe map (reference libs/cmap/cmap.go). Peer scratch
state and reactor bookkeeping use it from both the event loop and
executor threads."""

from __future__ import annotations

import threading
from typing import Any, Optional


class CMap:
    def __init__(self):
        self._d: dict = {}
        self._lock = threading.Lock()

    def set(self, key, value) -> None:
        with self._lock:
            self._d[key] = value

    def get(self, key) -> Optional[Any]:
        with self._lock:
            return self._d.get(key)

    def has(self, key) -> bool:
        with self._lock:
            return key in self._d

    def delete(self, key) -> None:
        with self._lock:
            self._d.pop(key, None)

    def size(self) -> int:
        with self._lock:
            return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def keys(self) -> list:
        with self._lock:
            return list(self._d.keys())

    def values(self) -> list:
        with self._lock:
            return list(self._d.values())
