"""FuzzedConnection — probabilistic delay/drop wrapper for testing.

Reference: p2p/fuzz.go:14 (FuzzedConnection over net.Conn with
mode drop/delay, probability, and max-delay knobs; used by the e2e
harness to perturb gossip). Wraps the asyncio (reader, writer) pair the
transport hands to the secret connection.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass


@dataclass
class FuzzConnConfig:
    """Reference config.FuzzConnConfig defaults."""

    mode: str = "drop"  # "drop" | "delay"
    prob_drop_rw: float = 0.01
    prob_drop_conn: float = 0.0
    max_delay: float = 0.3  # seconds ("delay" mode)


class FuzzedWriter:
    def __init__(self, writer, cfg: FuzzConnConfig, rng=None):
        self._w = writer
        self._cfg = cfg
        self._rng = rng or random.Random()
        self.dropped = 0

    def write(self, data: bytes) -> None:
        if self._cfg.mode == "drop" and self._rng.random() < self._cfg.prob_drop_rw:
            self.dropped += 1
            return  # swallow the write
        self._w.write(data)

    async def drain(self) -> None:
        if self._cfg.mode == "delay" and self._rng.random() < self._cfg.prob_drop_rw:
            await asyncio.sleep(self._rng.random() * self._cfg.max_delay)
        await self._w.drain()

    def close(self) -> None:
        self._w.close()

    def __getattr__(self, name):
        return getattr(self._w, name)


class FuzzedReader:
    def __init__(self, reader, cfg: FuzzConnConfig, rng=None):
        self._r = reader
        self._cfg = cfg
        self._rng = rng or random.Random()

    async def readexactly(self, n: int) -> bytes:
        if self._cfg.mode == "delay" and self._rng.random() < self._cfg.prob_drop_rw:
            await asyncio.sleep(self._rng.random() * self._cfg.max_delay)
        return await self._r.readexactly(n)

    def __getattr__(self, name):
        return getattr(self._r, name)


def fuzz_conn(reader, writer, cfg: FuzzConnConfig | None = None):
    """Wrap an asyncio stream pair (reference FuzzConnFromConfig)."""
    cfg = cfg or FuzzConnConfig()
    return FuzzedReader(reader, cfg), FuzzedWriter(writer, cfg)
