"""StateStore — durable state, validator sets and params keyed by height.

Reference: state/store.go:50 (Store iface: state, ABCI responses,
validator sets, consensus params) + rollback support (state/rollback.go,
rewind.go).
"""

from __future__ import annotations

import json
import struct
from typing import Optional

from ..libs import protoio as pio
from ..store.kv import KV
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet
from .state import State

_STATE = b"stateKey"
_VALS = b"validatorsKey:"
_PARAMS = b"consensusParamsKey:"
_ABCI = b"abciResponsesKey:"


def _hk(prefix: bytes, height: int) -> bytes:
    return prefix + struct.pack(">q", height)


class StateStore:
    """Persists state at each height. Validator sets are stored at the
    height they become effective (validators for height h stored at h)."""

    def __init__(self, db: KV):
        self._db = db

    # --- state ------------------------------------------------------------

    def load(self) -> Optional[State]:
        raw = self._db.get(_STATE)
        return State.decode(raw) if raw else None

    def save(self, state: State) -> None:
        """Persist state + the validator/params records for the upcoming
        height (reference state/store.go save)."""
        next_height = (
            state.initial_height
            if state.last_block_height == 0
            else state.last_block_height + 1
        )
        sets = [
            (_STATE, state.encode()),
            (
                _hk(_VALS, next_height + 1),
                state.next_validators.encode(),
            ),
            (
                _hk(_PARAMS, next_height),
                json.dumps(
                    state.consensus_params.to_json(), sort_keys=True
                ).encode(),
            ),
        ]
        if state.last_block_height == 0:
            # bootstrap: validators for the initial height
            sets.append((_hk(_VALS, next_height), state.validators.encode()))
        self._db.write_batch(sets, [])

    def bootstrap(self, state: State) -> None:
        self.save(state)

    # --- validator sets ---------------------------------------------------

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        raw = self._db.get(_hk(_VALS, height))
        return ValidatorSet.decode(raw) if raw else None

    # --- consensus params -------------------------------------------------

    def load_consensus_params(self, height: int) -> Optional[ConsensusParams]:
        raw = self._db.get(_hk(_PARAMS, height))
        return ConsensusParams.from_json(json.loads(raw.decode())) if raw else None

    # --- abci responses (results) ----------------------------------------

    def save_abci_responses(self, height: int, responses_blob: bytes) -> None:
        self._db.set(_hk(_ABCI, height), responses_blob)

    def load_abci_responses(self, height: int) -> Optional[bytes]:
        return self._db.get(_hk(_ABCI, height))

    # --- pruning / rollback ----------------------------------------------

    def prune_states(self, retain_height: int, from_height: int = 1) -> None:
        deletes = []
        for h in range(from_height, retain_height):
            deletes.append(_hk(_VALS, h))
            deletes.append(_hk(_PARAMS, h))
            deletes.append(_hk(_ABCI, h))
        self._db.write_batch([], deletes)

    def rollback(self, block_store) -> State:
        """Roll the state back one height (reference state/rollback.go):
        reconstruct state at height-1 from the stores. Requires the block
        store to still have the block at the rollback height."""
        cur = self.load()
        if cur is None:
            raise ValueError("no state to roll back")
        rollback_height = cur.last_block_height
        if rollback_height <= 0:
            raise ValueError("cannot roll back genesis state")
        prev_height = rollback_height - 1
        block = block_store.load_block_meta(rollback_height)
        if block is None:
            raise ValueError("block at rollback height not found")
        prev_block = block_store.load_block_meta(prev_height)
        if prev_block is None and prev_height > 0:
            raise ValueError("block before rollback height not found")

        validators = self.load_validators(rollback_height)
        next_validators = self.load_validators(rollback_height + 1)
        last_validators = self.load_validators(prev_height)
        params = self.load_consensus_params(rollback_height)
        if validators is None or next_validators is None:
            raise ValueError("validator sets for rollback not found")

        rolled = State(
            chain_id=cur.chain_id,
            initial_height=cur.initial_height,
            last_block_height=prev_height,
            last_block_id=block.header.last_block_id,
            last_block_time_ns=(
                prev_block.header.time_ns if prev_block else 0
            ),
            validators=validators,
            next_validators=next_validators,
            last_validators=(
                last_validators
                if last_validators is not None
                else ValidatorSet.empty()
            ),
            last_height_validators_changed=cur.last_height_validators_changed,
            consensus_params=params or cur.consensus_params,
            last_height_consensus_params_changed=(
                cur.last_height_consensus_params_changed
            ),
            last_results_hash=block.header.last_results_hash,
            app_hash=block.header.app_hash,
        )
        self._db.set(_STATE, rolled.encode())
        return rolled
