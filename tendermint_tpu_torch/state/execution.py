"""BlockExecutor — proposal creation and the ApplyBlock pipeline.

Reference: state/execution.go — CreateProposalBlock :107 (txs pulled from
the L2 node via the notifier; no mempool), ProcessProposal/ValidateBlock
:179/:207, ApplyBlock :220-288 (validate → ABCI exec → ExecBlockOnL2Node
:390-429 → updateState :590 → ABCI Commit :363 → evidence update → save),
and the L2-driven validator-set diffing :309-360.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Optional

from ..abci import types as abci
from ..crypto import merkle
from ..l2node.l2node import BlockData, BlsData, L2Node
from ..libs import fail
from ..libs.log import Logger, nop_logger
from ..store.block_store import BlockStore
from ..types.block import Block, BlockIDFlag, Commit, Data, Header
from ..types.block_id import BlockID
from ..types.evidence import evidence_hash
from ..types.validator import Validator, pubkey_from_type
from .state import State
from .store import StateStore


@dataclass
class ABCIResponses:
    """Per-height execution results (reference state/execution.go
    ABCIResponses): deliver_tx results feed last_results_hash."""

    deliver_txs: list[abci.ResponseDeliverTx] = field(default_factory=list)
    end_block: Optional[abci.ResponseEndBlock] = None
    begin_block: Optional[abci.ResponseBeginBlock] = None
    # the MERGED (L2-over-app) validator updates apply_block actually
    # used — round-tripped so crash recovery from a saved-responses
    # record rebuilds the identical next validator set
    val_updates: list = field(default_factory=list)
    param_updates: Optional[dict] = None

    def results_hash(self) -> bytes:
        leaves = [
            bytes([r.code & 0xFF]) + r.data for r in self.deliver_txs
        ]
        return merkle.hash_from_byte_slices(leaves)

    def encode(self) -> bytes:
        return json.dumps(
            {
                "deliver_txs": [
                    {
                        "code": r.code,
                        "data": r.data.hex(),
                        "log": r.log,
                        "events": [
                            {"type": e.type, "attributes": e.attributes}
                            for e in r.events
                        ],
                    }
                    for r in self.deliver_txs
                ],
                "val_updates": [
                    # 4th column (BLS pubkey) only when carried, so
                    # pre-QC records decode byte-identically
                    [u[0], u[1].hex(), u[2]]
                    + ([u[3].hex()] if len(u) > 3 and u[3] else [])
                    for u in self.val_updates
                ],
                "param_updates": self.param_updates,
            }
        ).encode()

    @classmethod
    def decode(cls, data: bytes) -> "ABCIResponses":
        obj = json.loads(data.decode())
        out = cls()
        for r in obj.get("deliver_txs", []):
            out.deliver_txs.append(
                abci.ResponseDeliverTx(
                    code=r.get("code", 0),
                    data=bytes.fromhex(r.get("data", "")),
                    log=r.get("log", ""),
                    events=[
                        abci.Event(e["type"], e.get("attributes", {}))
                        for e in r.get("events", [])
                    ],
                )
            )
        out.val_updates = [
            (row[0], bytes.fromhex(row[1]), row[2], bytes.fromhex(row[3]))
            if len(row) > 3
            else (row[0], bytes.fromhex(row[1]), row[2])
            for row in obj.get("val_updates", [])
        ]
        out.param_updates = obj.get("param_updates")
        if out.param_updates is not None:
            # _update_state reads param updates off end_block
            out.end_block = abci.ResponseEndBlock(
                consensus_param_updates=out.param_updates
            )
        return out


class BlockExecutor:
    def __init__(
        self,
        state_store: StateStore,
        block_store: BlockStore,
        proxy_app_consensus,  # abci client (consensus connection)
        l2_node: L2Node,
        event_bus=None,
        evidence_pool=None,
        logger: Optional[Logger] = None,
        qc_enabled: bool = False,
    ):
        self._state_store = state_store
        self._block_store = block_store
        self._app = proxy_app_consensus
        self._l2 = l2_node
        self._event_bus = event_bus
        self._evpool = evidence_pool
        self.logger = logger or nop_logger()
        # QC plane ([consensus] quorum_certificates): blocks carrying a
        # QuorumCertificate validate their LastCommit with one aggregate
        # pairing check — live validation, blocksync revalidation and
        # WAL-replay apply all funnel through validate_block
        self.qc_enabled = qc_enabled

    # --- proposal ---------------------------------------------------------

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Commit | None,
        proposer_address: bytes,
        block_data: BlockData,
        time_ns: int,
    ) -> Block:
        """Builds the proposal from L2-provided block data
        (reference CreateProposalBlock :107)."""
        evidence = (
            self._evpool.pending_evidence(
                state.consensus_params.evidence.max_bytes
            )
            if self._evpool
            else []
        )
        header = Header(
            chain_id=state.chain_id,
            height=height,
            time_ns=time_ns,
            last_block_id=state.last_block_id,
            validators_hash=state.validators.hash(),
            next_validators_hash=state.next_validators.hash(),
            consensus_hash=state.consensus_params.hash(),
            app_hash=state.app_hash,
            last_results_hash=state.last_results_hash,
            proposer_address=proposer_address,
        )
        block = Block(
            header=header,
            data=Data(
                txs=list(block_data.txs),
                l2_block_meta=block_data.l2_block_meta,
                l2_batch_header=block_data.l2_batch_header,
            ),
            evidence=evidence,
            last_commit=last_commit,
        )
        block.fill_header()
        return block

    # --- validation -------------------------------------------------------

    def validate_block(
        self, state: State, block: Block, verifier=None, qc_engine=None
    ) -> None:
        """Stateful validation incl. evidence (reference ValidateBlock :207)."""
        state.make_block_validate(
            block,
            verifier=verifier,
            use_qc=self.qc_enabled,
            qc_engine=qc_engine,
        )
        if self._evpool:
            for ev in block.evidence:
                self._evpool.check_evidence(ev, state)

    async def validate_block_off_loop(
        self, state: State, block: Block, klass: str = "consensus"
    ) -> None:
        """validate_block with its LastCommit device verify moved OFF
        the event loop: the check runs in an
        executor thread against a scheduler-classed adapter, so a
        proposal's commit-light dispatch coalesces with in-flight vote
        rounds instead of stalling the consensus loop for a full device
        round (as the vote path does). `klass` is the
        caller's priority class — the live consensus path uses the
        default, blocksync backfill passes "blocksync" so a catchup
        flood never queues at live-vote priority. Raises exactly what
        validate_block raises."""
        from ..parallel.scheduler import default_dispatch
        from ..types.quorum_cert import qc_dispatch

        verifier = default_dispatch(klass)
        qc_engine = qc_dispatch(klass) if self.qc_enabled else None
        await asyncio.get_running_loop().run_in_executor(
            None, self.validate_block, state, block, verifier, qc_engine
        )

    def process_proposal(self, state: State, block: Block) -> bool:
        """CheckBlockData against the L2 node (reference ProcessProposal
        :179 → l2.CheckBlockData — the prevote gate)."""
        return self._l2.check_block_data(
            block.data.txs, block.data.l2_block_meta
        )

    # --- apply ------------------------------------------------------------

    async def apply_block(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        bls_datas: Optional[list[BlsData]] = None,
        verify_klass: str = "consensus",
    ) -> State:
        """The commit pipeline (reference ApplyBlock :220-288)."""
        await self.validate_block_off_loop(state, block, klass=verify_klass)

        abci_responses = await self._exec_block_on_app(state, block)
        fail.fail_point()  # crash between app exec and L2 delivery

        val_updates = self._exec_block_on_l2(block, bls_datas or [])
        fail.fail_point()  # crash between L2 delivery and state update

        # merge validator updates: L2-driven (morph) takes precedence,
        # else the app's end_block updates (upstream behavior)
        if not val_updates and abci_responses.end_block is not None:
            val_updates = [
                (
                    u.pub_key_type,
                    u.pub_key_data,
                    u.power,
                    getattr(u, "bls_pub_key", b""),
                )
                for u in abci_responses.end_block.validator_updates
            ]

        new_state = self._update_state(
            state, block_id, block, abci_responses, val_updates
        )

        # persist the responses — WITH the merged validator/param
        # updates — BEFORE the app commit: if the (possibly background,
        # commit-pipelined) apply crashes after the app commits but
        # before the state save, the handshake rebuilds the identical
        # state record from these instead of double-executing the block
        # (Handshaker → update_state_from_responses)
        abci_responses.val_updates = list(val_updates)
        if (
            abci_responses.end_block is not None
            and abci_responses.end_block.consensus_param_updates
        ):
            abci_responses.param_updates = (
                abci_responses.end_block.consensus_param_updates
            )
        self._state_store.save_abci_responses(
            block.header.height, abci_responses.encode()
        )
        # durable block BEFORE app commit: with the write-behind store,
        # block H's save may still be queued — if the app committed
        # while the block was lost in a crash, restart would see
        # app_height > store_height, a state no replay path can fill
        # (re-driving H would double-execute it on the app). After this
        # barrier the durable order is always block >= app >= state,
        # and every crash window lands on an existing recovery path.
        # Normally a no-op (the save landed while txs executed); awaited
        # off-loop so a backlogged disk never stalls the event loop.
        await asyncio.get_running_loop().run_in_executor(
            None, self._block_store.wait_durable, block.header.height
        )
        # ABCI Commit → app hash for the NEXT block
        res = await self._app.commit()
        fail.fail_point()  # crash after app commit, before state save
        new_state.app_hash = res.data

        self._state_store.save(new_state)
        fail.fail_point()  # crash after state save

        if self._evpool:
            self._evpool.update(new_state, block.evidence)
        if res.retain_height > 0:
            try:
                # off-loop: pruning scans/deletes KV ranges and (on the
                # write-behind store) barriers on queued saves
                def _prune(h=res.retain_height):
                    self._block_store.prune_blocks(h)
                    self._state_store.prune_states(h)

                await asyncio.get_running_loop().run_in_executor(
                    None, _prune
                )
            except ValueError:
                pass

        if self._event_bus is not None:
            await self._event_bus.publish_new_block(block)
            await self._event_bus.publish_new_block_header(block.header)
            for i, tx in enumerate(block.data.txs):
                from ..crypto import tmhash

                r = abci_responses.deliver_txs[i]
                await self._event_bus.publish_tx(
                    block.header.height,
                    tmhash.sum(tx),
                    tx,
                    {
                        f"{e.type}.{k}": [v]
                        for e in r.events
                        for k, v in e.attributes.items()
                    },
                )
        return new_state

    async def _exec_block_on_app(
        self, state: State, block: Block
    ) -> ABCIResponses:
        last_commit_info = self._make_last_commit_info(state, block)
        byz = [
            {"height": ev.height(), "type": type(ev).__name__}
            for ev in block.evidence
        ]
        responses = ABCIResponses()
        responses.begin_block = await self._app.begin_block(
            block.header, last_commit_info, byz
        )
        for tx in block.data.txs:
            responses.deliver_txs.append(await self._app.deliver_tx(tx))
        responses.end_block = await self._app.end_block(block.header.height)
        return responses

    def _make_last_commit_info(self, state: State, block: Block):
        if block.last_commit is None or block.header.height == state.initial_height:
            return {"round": 0, "votes": []}
        # the signers are the validators of height-1 — during handshake
        # replay that is NOT state.last_validators (the handshake-time
        # set), so prefer the height-indexed store record
        vals = self._state_store.load_validators(block.header.height - 1)
        if vals is None:
            vals = state.last_validators
        votes = []
        for i, cs in enumerate(block.last_commit.signatures):
            val = vals.get_by_index(i) if vals else None
            if val is None:
                continue
            votes.append(
                {
                    "address": val.address,
                    "power": val.voting_power,
                    "signed_last_block": not cs.is_absent(),
                }
            )
        return {"round": block.last_commit.round, "votes": votes}

    def _exec_block_on_l2(
        self, block: Block, bls_datas: list[BlsData]
    ) -> list:
        """DeliverBlock + CommitBatch/PackCurrentBlock
        (reference ExecBlockOnL2Node :390-429)."""
        val_updates, _param_updates = self._l2.deliver_block(
            block.header.height,
            block.hash(),
            block.data.txs,
            block.data.l2_block_meta,
        )
        block_bytes = block.encode()
        if block.header.batch_hash:
            self._l2.commit_batch(block_bytes, bls_datas)
        else:
            self._l2.pack_current_block(block_bytes)
        return val_updates or []

    def _update_state(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        abci_responses: ABCIResponses,
        val_updates: list,
    ) -> State:
        """Builds the next State value (reference updateState :590)."""
        next_validators = state.next_validators.copy()
        last_height_vals_changed = state.last_height_validators_changed
        if val_updates:
            # rows are (type, data, power) or, QC plane, a 4th element:
            # the BLS pubkey riding the L2/end_block rotation
            changes = [
                Validator(
                    pubkey_from_type(u[0], u[1]),
                    u[2],
                    bls_pub_key=u[3] if len(u) > 3 else b"",
                )
                for u in val_updates
            ]
            next_validators.update_with_change_set(changes)
            last_height_vals_changed = block.header.height + 1 + 1

        params = state.consensus_params
        last_height_params_changed = state.last_height_consensus_params_changed
        if (
            abci_responses.end_block is not None
            and abci_responses.end_block.consensus_param_updates
        ):
            params = params.update(
                abci_responses.end_block.consensus_param_updates
            )
            last_height_params_changed = block.header.height + 1

        next_validators.increment_proposer_priority(1)
        return State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=block.header.height,
            last_block_id=block_id,
            last_block_time_ns=block.header.time_ns,
            validators=state.next_validators.copy(),
            next_validators=next_validators,
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=abci_responses.results_hash(),
            app_hash=state.app_hash,  # replaced after ABCI Commit
        )

    def update_state_from_responses(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        responses: ABCIResponses,
        app_hash: bytes,
    ) -> State:
        """Handshake path for 'app committed, state save lost' (the
        window the pipelined background apply widens): rebuild and
        persist the state record from the height's SAVED ABCI responses
        and the app's reported hash, without double-executing the block
        against the app or re-delivering it to the L2 node (both already
        have it — apply order puts app commit after L2 delivery). The
        responses blob carries the merged validator/param updates apply
        actually used (saved pre-commit), so validator-change heights
        rebuild the identical next set (reference analog: mock-app
        replayBlock, replay.go:414-440)."""
        new_state = self._update_state(
            state, block_id, block, responses, responses.val_updates
        )
        new_state.app_hash = app_hash
        self._state_store.save(new_state)
        return new_state

    async def exec_commit_block(self, state: State, block: Block) -> bytes:
        """Replay helper: execute a stored block against the app without
        state bookkeeping (reference ExecCommitBlock :715)."""
        await self._exec_block_on_app(state, block)
        res = await self._app.commit()
        return res.data
