"""Proposal — a proposer's signed block proposal for a round.

Reference: types/proposal.go. POLRound points at the round of the proof-of-
lock the proposer is re-proposing from (-1 when none).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protoio as pio
from . import canonical
from .block_id import BlockID


@dataclass
class Proposal:
    height: int
    round: int
    pol_round: int
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(chain_id, self)

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.pol_round < -1 or (
            self.pol_round >= 0 and self.pol_round >= self.round
        ):
            raise ValueError("invalid POL round")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError("proposal block_id must be complete")
        if not self.signature or len(self.signature) > 64:
            raise ValueError("bad proposal signature")

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.pol_round + 2),  # -1 encodes as 1
                pio.field_message(4, self.block_id.encode()),
                pio.field_varint(5, self.timestamp_ns),
                pio.field_bytes(6, self.signature),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            pol_round=f.get(3, [2])[0] - 2,
            block_id=BlockID.decode(f.get(4, [b""])[0]),
            timestamp_ns=f.get(5, [0])[0],
            signature=f.get(6, [b""])[0],
        )
