"""StateV2 — centralized sequencer block production after the upgrade.

Reference: sequencer/state_v2.go — timer-driven `produceBlockRoutine`
(:127-206): RequestBlockDataV2(parent) → sign(block.Hash) → ApplyBlockV2 →
queue for broadcast. The asyncio shape replaces the goroutine+ticker with
one production task; `apply_block` stays the single serialized entry point
for both self-produced and gossiped blocks (:229-243).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.log import Logger
from ..libs.service import Service
from ..types.block_v2 import BlockV2
from .signer import Signer

DEFAULT_BLOCK_INTERVAL = 3.0  # seconds (state_v2.go:16)


class StateV2(Service):
    def __init__(
        self,
        l2_node,
        block_interval: float = DEFAULT_BLOCK_INTERVAL,
        signer: Optional[Signer] = None,
        verifier=None,
        logger: Optional[Logger] = None,
    ):
        super().__init__("stateV2", logger)
        self.l2_node = l2_node
        self.signer = signer
        self.verifier = verifier
        self.block_interval = (
            block_interval if block_interval > 0 else DEFAULT_BLOCK_INTERVAL
        )
        self.sequencer_mode = signer is not None
        self.latest_block: Optional[BlockV2] = None
        self._apply_lock = asyncio.Lock()
        self.broadcast_queue: asyncio.Queue[BlockV2] = asyncio.Queue(100)

    # --- lifecycle ----------------------------------------------------------

    async def on_start(self) -> None:
        self.latest_block = self.l2_node.get_latest_block_v2()
        active = (
            self.sequencer_mode and self.signer.is_active_sequencer()
        )
        self.logger.info(
            "StateV2 initialized",
            latest_height=self.latest_block.number,
            sequencer_mode=self.sequencer_mode,
            is_active_sequencer=active,
        )
        if active:
            self.spawn(self._produce_block_routine())

    async def on_stop(self) -> None:
        pass

    # --- block production (state_v2.go:127-206) ------------------------------

    async def _produce_block_routine(self) -> None:
        self.logger.info(
            "starting block production", interval=self.block_interval
        )
        while self.is_running:
            await asyncio.sleep(self.block_interval)
            try:
                await self.produce_block()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.logger.error("failed to produce block", err=str(e))

    async def produce_block(self) -> Optional[BlockV2]:
        parent_hash = self.latest_block.hash
        block, _collected_l1 = self.l2_node.request_block_data_v2(parent_hash)
        block.signature = self.signer.sign(block.hash)
        await self.apply_block(block)
        try:
            self.broadcast_queue.put_nowait(block)
        except asyncio.QueueFull:
            self.logger.error(
                "broadcast queue full, dropping block", number=block.number
            )
        self.logger.debug(
            "block produced", number=block.number, txs=len(block.transactions)
        )
        return block

    # --- application (unified entry point, state_v2.go:229-243) --------------

    async def apply_block(self, block: BlockV2) -> None:
        async with self._apply_lock:
            self.l2_node.apply_block_v2(block)
            self.latest_block = block

    # --- queries -------------------------------------------------------------

    def latest_height(self) -> int:
        return self.latest_block.number if self.latest_block else 0

    def get_block_by_number(self, number: int) -> Optional[BlockV2]:
        return self.l2_node.get_block_by_number(number)

    def is_sequencer_mode(self) -> bool:
        return self.sequencer_mode
