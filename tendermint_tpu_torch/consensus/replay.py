"""Crash recovery: WAL catchup replay + the app/L2 handshake.

Reference: consensus/replay.go — catchupReplay :95-173 (re-feed WAL
messages for the in-progress height through the state machine) and
Handshaker :202-498 (on startup, compare the app's height against the
block store and replay stored blocks into the app AND the L2 node until
everyone agrees).
"""

from __future__ import annotations

from io import BytesIO
from typing import Optional

from ..abci import types as abci
from ..libs import protoio as pio
from ..libs.log import Logger, nop_logger
from ..state.execution import BlockExecutor
from ..state.state import State
from ..state.store import StateStore
from ..store.block_store import BlockStore
from ..types.block_id import BlockID
from ..types.genesis import GenesisDoc
from .messages import decode_msg
from .wal import KIND_END_HEIGHT, WAL


async def catchup_replay(cs, wal: WAL) -> int:
    """Re-process WAL messages logged after the last committed height
    (reference catchupReplay). Returns the number of messages replayed.
    Must run before the receive routine starts.

    Pipelined-heights boundary semantics: peers running one height
    ahead interleave H+1 traffic into the WAL BEFORE end_height(H), so
    a replayed message stream can contain future-height messages — the
    state machine's next-height buffer holds them exactly as it would
    live ones, and they drain when the replayed quorum closes H. Our
    OWN H+1 messages can never precede end_height(H) in the file: they
    are only created after the height transition, which happens after
    the end-height record was written, and the group-commit WAL
    preserves write order — that ordering (plus the background
    finalization task refusing to persist state before its end-height
    barrier, CommitPipeline.begin) is what makes a crash between H+1's
    propose and H's durable decision replay without double-sign or
    height skip. Peer H+1 messages lost with a torn tail re-arrive via
    gossip catchup."""
    committed = cs.state.last_block_height
    msgs = wal.search_for_end_height(committed)
    if msgs is None:
        if committed > 0 and wal.search_for_end_height(0):
            # the WAL has records but no end-height barrier for the
            # committed height: the lock-tracking state for the in-flight
            # height is unrecoverable — fatal, as in the reference
            # (consensus/replay.go: "cannot replay height ... WAL does not
            # contain #ENDHEIGHT")
            raise RuntimeError(
                f"WAL has no end-height record for {committed}; "
                "refusing to start without replay (run repair/reset)"
            )
        msgs = []
    count = 0
    for m in msgs:
        if m.kind == KIND_END_HEIGHT:
            continue
        if m.kind != "consensus":
            continue
        try:
            msg = decode_msg(m.data)
        except ValueError:
            continue
        await cs._handle_msg(msg, "replay")
        count += 1
    return count


class Handshaker:
    """Syncs app + L2 node with the block store on startup
    (reference Handshaker :202, Handshake :243, ReplayBlocks :284)."""

    def __init__(
        self,
        state_store: StateStore,
        block_store: BlockStore,
        genesis: GenesisDoc,
        executor: BlockExecutor,
        logger: Optional[Logger] = None,
    ):
        self._state_store = state_store
        self._block_store = block_store
        self._genesis = genesis
        self._executor = executor
        self.logger = logger or nop_logger()
        self.n_blocks_replayed = 0

    async def handshake(self, state: State) -> State:
        app = self._executor._app
        info = await app.info()
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        self.logger.info(
            "handshake", app_height=app_height, store_height=self._block_store.height
        )
        return await self.replay_blocks(state, app_height, app_hash)

    async def replay_blocks(
        self, state: State, app_height: int, app_hash: bytes
    ) -> State:
        store_height = self._block_store.height
        state_height = state.last_block_height

        if app_height == 0:
            # fresh app: init chain with genesis validators
            validators = [
                abci.ValidatorUpdate("ed25519", v.pub_key_data, v.power)
                for v in self._genesis.validators
            ]
            res = await self._executor._app.init_chain(
                self._genesis.chain_id,
                self._genesis.consensus_params.to_json(),
                validators,
                self._genesis.app_state,
                self._genesis.initial_height,
            )
            if state_height == 0:
                if res.app_hash:
                    state.app_hash = res.app_hash
                self._state_store.bootstrap(state)
            app_hash = res.app_hash

        if store_height == 0:
            return state

        # replay stored blocks the app hasn't seen; all but possibly the
        # last go through ExecCommitBlock (no state bookkeeping)
        replay_to = store_height if state_height == store_height else store_height - 1
        for h in range(app_height + 1, replay_to + 1):
            block = self._block_store.load_block(h)
            if block is None:
                raise RuntimeError(f"missing block {h} during replay")
            self.logger.info("replaying block into app", height=h)
            app_hash = await self._executor.exec_commit_block(state, block)
            # keep the L2 node in sync too (reference replays into l2node)
            self._executor._exec_block_on_l2(block, [])
            self.n_blocks_replayed += 1

        if state_height < store_height:
            block = self._block_store.load_block(store_height)
            meta = self._block_store.load_block_meta(store_height)
            if app_height == store_height:
                # pipeline crash window: the background apply got through
                # ABCI Commit but died before the state save. The app
                # (and L2 — delivery precedes app commit in apply order)
                # already executed this block; rebuild the state record
                # from the saved responses instead of double-executing.
                blob = self._state_store.load_abci_responses(store_height)
                if blob is None:
                    # apply_block persists the responses BEFORE the app
                    # commit, so app==store without a blob means a
                    # pre-reorder crash image or a tampered store.
                    # Falling through would re-execute block H against
                    # an app that already committed it — silent app-hash
                    # divergence. Refuse loudly instead.
                    raise RuntimeError(
                        f"app is at height {store_height} but no ABCI "
                        "responses are stored for it; cannot rebuild "
                        "state without double-executing the block — "
                        "reset the app state (or restore a snapshot) "
                        "and re-run"
                    )
                from ..state.execution import ABCIResponses

                self.logger.info(
                    "restoring state from saved responses",
                    height=store_height,
                )
                self.n_blocks_replayed += 1
                return self._executor.update_state_from_responses(
                    state,
                    meta.block_id,
                    block,
                    ABCIResponses.decode(blob),
                    app_hash,
                )
            # the final block updates consensus state via the full pipeline
            self.logger.info("applying final block", height=store_height)
            state = await self._executor.apply_block(
                state, meta.block_id, block
            )
            self.n_blocks_replayed += 1
        return state
