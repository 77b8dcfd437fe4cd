"""Notifier — wakes consensus when the L2 node has transactions.

Reference: l2node/notifier.go:25-107 — implements the old txNotifier
interface (consensus/state.go:71-74) the mempool used to provide: consensus
blocks on TxsAvailable() before proposing; the notifier polls the L2 node.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.service import Service
from .l2node import BlockData, L2Node


class Notifier(Service):
    def __init__(self, l2: L2Node, poll_interval: float = 0.05, logger=None):
        super().__init__("l2notifier", logger)
        self._l2 = l2
        self._poll = poll_interval
        self._available = asyncio.Event()
        self._height = 0

    async def on_start(self) -> None:
        self.spawn(self._poll_routine(), "poll")

    def enable_for_height(self, height: int) -> None:
        """Consensus signals which height it wants data for; the event
        resets (reference notifier.go EnableTxsAvailable pattern)."""
        self._height = height
        self._available.clear()

    async def txs_available(self) -> None:
        """Blocks until the L2 node reports block data is ready."""
        await self._available.wait()

    def get_block_data(self, height: int) -> BlockData:
        return self._l2.request_block_data(height)

    async def _poll_routine(self) -> None:
        while True:
            has = getattr(self._l2, "has_txs", None)
            ready = has() if has is not None else True
            if ready and not self._available.is_set():
                self._available.set()
            await asyncio.sleep(self._poll)
