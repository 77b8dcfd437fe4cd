"""Vote — a signed prevote/precommit, optionally BLS dual-signed.

Reference: types/vote.go. The morph fork adds `BLSSignature` (vote.go:59):
at batch points, precommits carry a second BLS12-381 signature over the
batch hash, verified through the L2 node in the consensus vote path
(consensus/state.go:2362-2379) and aggregated for L1 submission.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from ..libs import protoio as pio
from . import canonical
from .block_id import BlockID


class VoteType(enum.IntEnum):
    PREVOTE = canonical.PREVOTE_TYPE
    PRECOMMIT = canonical.PRECOMMIT_TYPE


# canonical display names: the cluster-trace merge joins `type` fields
# across quorum.* (height_vote_set.py) and gossip.* (consensus/
# reactor.py) events, so every emitter must use this one map
VOTE_TYPE_NAMES = {
    int(VoteType.PREVOTE): "prevote",
    int(VoteType.PRECOMMIT): "precommit",
}


MAX_VOTE_BYTES = 2048  # generous bound incl. BLS signature


@dataclass
class Vote:
    type: int
    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""
    bls_signature: bytes = b""  # morph: set on batch-point precommits
    # QC plane: BLS signature over the canonical QC message
    # (types/quorum_cert.qc_sign_bytes) — set on every non-nil precommit
    # when [consensus] quorum_certificates is on, aggregated at +2/3
    qc_signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(chain_id, self)

    def verify(self, chain_id: str, pub_key) -> bool:
        """Serial one-vote verify (reference types/vote.go:149-158). The
        consensus path batches instead — see crypto.batch_verifier."""
        if pub_key.address() != self.validator_address:
            return False
        return pub_key.verify(self.sign_bytes(chain_id), self.signature)

    def validate_basic(self) -> None:
        if self.type not in (VoteType.PREVOTE, VoteType.PRECOMMIT):
            raise ValueError("invalid vote type")
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError("vote block_id must be nil or complete")
        if len(self.validator_address) != 20:
            raise ValueError("wrong validator address size")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature:
            raise ValueError("vote missing signature")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.type),
                pio.field_varint(2, self.height),
                pio.field_varint(3, self.round),
                pio.field_message(4, self.block_id.encode()),
                pio.field_message(
                    5, canonical.encode_timestamp(self.timestamp_ns)
                ),
                pio.field_bytes(6, self.validator_address),
                pio.field_varint(7, self.validator_index + 1),  # 0 is valid
                pio.field_bytes(8, self.signature),
                pio.field_bytes(9, self.bls_signature),
                pio.field_bytes(10, self.qc_signature),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        f = pio.decode_fields(data)
        return cls(
            type=f.get(1, [0])[0],
            height=f.get(2, [0])[0],
            round=f.get(3, [0])[0],
            block_id=BlockID.decode(f.get(4, [b""])[0]),
            timestamp_ns=canonical.decode_timestamp(f.get(5, [b""])[0]),
            validator_address=f.get(6, [b""])[0],
            validator_index=f.get(7, [1])[0] - 1,
            signature=f.get(8, [b""])[0],
            bls_signature=f.get(9, [b""])[0],
            qc_signature=f.get(10, [b""])[0],
        )

    def __repr__(self) -> str:
        t = "Prevote" if self.type == VoteType.PREVOTE else "Precommit"
        tgt = self.block_id.hash.hex()[:12] if not self.is_nil() else "nil"
        return (
            f"Vote{{{self.validator_index}:"
            f"{self.validator_address.hex()[:12]} {self.height}/"
            f"{self.round} {t} {tgt}}}"
        )
