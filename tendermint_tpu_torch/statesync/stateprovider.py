"""State provider — trusted state for a snapshot height.

Reference: statesync/stateprovider.go:39-205. The light client verifies
headers at H, H+1, H+2 and the provider assembles the consensus State the
node resumes from (validators at H+1, next validators from H+2, app hash
from H+1 — the snapshot height mapping at :150-175).
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import asyncio

from ..light.client import ErrNoProviderBlock, LightClient
from ..state.state import State
from ..types.block import Commit
from ..types.params import ConsensusParams


@runtime_checkable
class StateProvider(Protocol):
    async def app_hash(self, height: int) -> bytes: ...

    async def commit(self, height: int) -> Commit: ...

    async def state(self, height: int) -> State: ...


class LightClientStateProvider:
    def __init__(
        self,
        light_client: LightClient,
        initial_height: int = 1,
        consensus_params: Optional[ConsensusParams] = None,
    ):
        self._lc = light_client
        self._initial_height = initial_height
        # the reference fetches consensus params over RPC from the primary
        # (:185-200); here they are supplied by the caller (genesis doc or
        # RPC-backed provider)
        self._params = consensus_params or ConsensusParams()

    async def _verify_retry(self, height: int):
        """verify_light_block_at_height with a bounded wait for heights
        the chain hasn't produced YET: verifying the freshest snapshot at
        H needs headers H+1 and H+2, which land one block interval later.
        The reference's light provider blocks until the primary has the
        height (light/provider/http retry loop); here: up to ~20 s.
        Genuine verification failures re-raise immediately."""
        delay = 0.5
        for _ in range(10):
            try:
                return await self._lc.verify_light_block_at_height(height)
            except ErrNoProviderBlock:
                await asyncio.sleep(delay)
                delay = min(delay * 1.5, 4.0)
        return await self._lc.verify_light_block_at_height(height)

    async def app_hash(self, height: int) -> bytes:
        """App hash FOR height lives in the header at height+1 (:100-120).
        Also pre-verifies height+2, needed by state() later."""
        header = await self._verify_retry(height + 1)
        await self._verify_retry(height + 2)
        return header.header.app_hash

    async def commit(self, height: int) -> Commit:
        lb = await self._verify_retry(height)
        return lb.commit

    async def state(self, height: int) -> State:
        """Assemble State for resuming after the snapshot (:135-205)."""
        last = await self._verify_retry(height)
        current = await self._verify_retry(height + 1)
        nxt = await self._verify_retry(height + 2)
        return State(
            chain_id=self._lc.chain_id,
            initial_height=self._initial_height,
            last_block_height=last.height,
            last_block_time_ns=last.header.time_ns,
            last_block_id=last.commit.block_id,
            app_hash=current.header.app_hash,
            last_results_hash=current.header.last_results_hash,
            last_validators=last.validators,
            validators=current.validators,
            next_validators=nxt.validators,
            last_height_validators_changed=nxt.height,
            consensus_params=self._params,
            last_height_consensus_params_changed=current.height,
        )
