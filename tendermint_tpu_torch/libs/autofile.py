"""Size-rotated file groups — durable append logs under the consensus WAL.

Reference: libs/autofile (859 LoC, `autofile.Group` group.go:54): an
append-only "head" file plus rotated chunks `<path>.000`, `<path>.001`, …
with a total-size cap that prunes oldest chunks first. Synchronous file IO
(the WAL fsyncs on the consensus hot path deliberately — see
consensus/state.go:821-828); callers run it in a thread if they need async.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator, Optional


class Group:
    def __init__(
        self,
        head_path: str,
        group_check_duration_s: float = 60.0,
        head_size_limit: int = 10 * 1024 * 1024,
        total_size_limit: int = 1024 * 1024 * 1024,
    ):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self._head = open(head_path, "ab")

    # --- writing ----------------------------------------------------------

    def write(self, data: bytes) -> None:
        self._head.write(data)

    def flush(self) -> None:
        self._head.flush()

    def sync(self) -> None:
        self._head.flush()
        os.fsync(self._head.fileno())

    def close(self) -> None:
        self._head.flush()
        self._head.close()

    # --- rotation ---------------------------------------------------------

    def check_head_size_limit(self) -> None:
        if self.head_size_limit <= 0:
            return
        if self._head.tell() >= self.head_size_limit:
            self.rotate_file()
        self._enforce_total_size()

    def rotate_file(self) -> None:
        self._head.flush()
        os.fsync(self._head.fileno())
        self._head.close()
        idx = self.max_index() + 1
        os.rename(self.head_path, f"{self.head_path}.{idx:03d}")
        self._head = open(self.head_path, "ab")

    def _chunk_files(self) -> list[tuple[int, str]]:
        d = os.path.dirname(self.head_path) or "."
        base = os.path.basename(self.head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        out = []
        for name in os.listdir(d):
            m = pat.fullmatch(name)
            if m:
                out.append((int(m.group(1)), os.path.join(d, name)))
        return sorted(out)

    def min_index(self) -> int:
        chunks = self._chunk_files()
        return chunks[0][0] if chunks else -1

    def max_index(self) -> int:
        chunks = self._chunk_files()
        return chunks[-1][0] if chunks else -1

    def _enforce_total_size(self) -> None:
        if self.total_size_limit <= 0:
            return
        chunks = self._chunk_files()
        total = sum(os.path.getsize(p) for _, p in chunks)
        total += os.path.getsize(self.head_path)
        while total > self.total_size_limit and chunks:
            _, path = chunks.pop(0)
            total -= os.path.getsize(path)
            os.remove(path)

    # --- reading ----------------------------------------------------------

    def read_all(self) -> bytes:
        """All group content oldest-first (chunks then head)."""
        self._head.flush()
        out = bytearray()
        for _, path in self._chunk_files():
            with open(path, "rb") as f:
                out += f.read()
        with open(self.head_path, "rb") as f:
            out += f.read()
        return bytes(out)

    def head_size(self) -> int:
        return self._head.tell()
