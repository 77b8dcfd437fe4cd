"""State — the deterministic per-height consensus state value.

Reference: state/state.go (`State` struct): everything needed to validate
and execute the next block — last block info, three validator-set
generations (last/current/next), consensus params, app hash. Immutable by
convention: `next_state` in the executor builds a fresh copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ..libs import protoio as pio
from ..types.block import Block
from ..types.block_id import BlockID
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet

INIT_STATE_VERSION = 1


@dataclass
class State:
    chain_id: str = ""
    initial_height: int = 1

    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0

    # validators[h] signs block h; next_validators is for h+1
    # (reference state.go: NextValidators / Validators / LastValidators)
    validators: Optional[ValidatorSet] = None
    next_validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def is_empty(self) -> bool:
        return self.validators is None

    def copy(self) -> "State":
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time_ns=self.last_block_time_ns,
            validators=self.validators.copy() if self.validators else None,
            next_validators=(
                self.next_validators.copy() if self.next_validators else None
            ),
            last_validators=(
                self.last_validators.copy() if self.last_validators else None
            ),
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=(
                self.last_height_consensus_params_changed
            ),
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
        )

    @classmethod
    def from_genesis(cls, genesis: GenesisDoc) -> "State":
        """MakeGenesisState (reference state.go)."""
        val_set = genesis.validator_set()
        return cls(
            chain_id=genesis.chain_id,
            initial_height=genesis.initial_height,
            last_block_height=0,
            last_block_id=BlockID(),
            last_block_time_ns=genesis.genesis_time_ns,
            validators=val_set,
            next_validators=val_set.copy_increment_proposer_priority(1),
            last_validators=ValidatorSet.empty(),
            last_height_validators_changed=genesis.initial_height,
            consensus_params=genesis.consensus_params,
            last_height_consensus_params_changed=genesis.initial_height,
            app_hash=genesis.app_hash,
        )

    def make_block_validate(
        self, block: Block, verifier=None, use_qc=False, qc_engine=None
    ) -> None:
        """Stateful block validation (reference state/validation.go
        validateBlock): header fields must chain from this state.
        `verifier` routes the LastCommit signature check (a device
        dispatch) — callers off the event loop pass a scheduler-classed
        adapter so the dispatch coalesces instead of stalling the
        consensus loop. With `use_qc` ([consensus] quorum_certificates)
        a block carrying a QuorumCertificate proves its LastCommit with
        ONE aggregate pairing check instead of N signature rows — the
        WAL-replay and blocksync revalidation paths ride this same
        method, so catchup replay gets the flat-cost check too."""
        block.validate_basic()
        h = block.header
        if h.chain_id != self.chain_id:
            raise ValueError("wrong chain id")
        expected_height = (
            self.initial_height
            if self.last_block_height == 0
            else self.last_block_height + 1
        )
        if h.height != expected_height:
            raise ValueError(
                f"wrong height: got {h.height}, want {expected_height}"
            )
        if h.last_block_id != self.last_block_id:
            raise ValueError("wrong last block id")
        if h.validators_hash != self.validators.hash():
            raise ValueError("wrong validators hash")
        if h.next_validators_hash != self.next_validators.hash():
            raise ValueError("wrong next validators hash")
        if h.consensus_hash != self.consensus_params.hash():
            raise ValueError("wrong consensus params hash")
        if h.app_hash != self.app_hash:
            raise ValueError("wrong app hash")
        if h.last_results_hash != self.last_results_hash:
            raise ValueError("wrong last results hash")
        if not self.validators.has_address(h.proposer_address):
            raise ValueError("proposer not in validator set")
        if self.last_block_height > 0:
            # LastCommit must verify against the validators of height-1
            if block.last_commit is None:
                raise ValueError("nil last commit")
            if (
                use_qc
                and block.last_qc is not None
                and self.last_validators.qc_capable()
            ):
                # the carried commit must still be the SHAPE legacy
                # consumers will verify — size/height/block_id against
                # the certified decision (a byzantine proposer pairing
                # a valid aggregate with a malformed commit would
                # otherwise split the chain from every full-commit
                # verifier); the signature ROWS are what the aggregate
                # replaces (trust model: PERF_ANALYSIS §21)
                self.last_validators._check_commit_shape(
                    self.last_block_id,
                    self.last_block_height,
                    block.last_commit,
                )
                self.last_validators.verify_commit_qc(
                    self.chain_id,
                    self.last_block_id,
                    self.last_block_height,
                    block.last_qc,
                    engine=qc_engine,
                )
            else:
                self.last_validators.verify_commit_light(
                    self.chain_id,
                    self.last_block_id,
                    self.last_block_height,
                    block.last_commit,
                    verifier=verifier,
                )
        if h.time_ns <= self.last_block_time_ns and self.last_block_height > 0:
            raise ValueError("block time must be monotonically increasing")

    # --- encoding ---------------------------------------------------------

    def encode(self) -> bytes:
        import json
        from dataclasses import asdict

        params_blob = json.dumps(
            self.consensus_params.to_json(), sort_keys=True
        ).encode()
        return b"".join(
            [
                pio.field_varint(1, INIT_STATE_VERSION),
                pio.field_bytes(2, self.chain_id.encode()),
                pio.field_varint(3, self.initial_height),
                pio.field_varint(4, self.last_block_height),
                pio.field_message(5, self.last_block_id.encode()),
                pio.field_varint(6, self.last_block_time_ns),
                pio.field_message(7, self.validators.encode()),
                pio.field_message(8, self.next_validators.encode()),
                pio.field_message(9, self.last_validators.encode()),
                pio.field_varint(10, self.last_height_validators_changed),
                pio.field_bytes(11, params_blob),
                pio.field_varint(
                    12, self.last_height_consensus_params_changed
                ),
                pio.field_bytes(13, self.last_results_hash),
                pio.field_bytes(14, self.app_hash),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "State":
        import json

        f = pio.decode_fields(data)
        params = ConsensusParams.from_json(
            json.loads(f.get(11, [b"{}"])[0].decode())
        )
        return cls(
            chain_id=f.get(2, [b""])[0].decode(),
            initial_height=f.get(3, [1])[0],
            last_block_height=f.get(4, [0])[0],
            last_block_id=BlockID.decode(f.get(5, [b""])[0]),
            last_block_time_ns=f.get(6, [0])[0],
            validators=ValidatorSet.decode(f[7][0]),
            next_validators=ValidatorSet.decode(f[8][0]),
            last_validators=ValidatorSet.decode(f[9][0]),
            last_height_validators_changed=f.get(10, [0])[0],
            consensus_params=params,
            last_height_consensus_params_changed=f.get(12, [0])[0],
            last_results_hash=f.get(13, [b""])[0],
            app_hash=f.get(14, [b""])[0],
        )
