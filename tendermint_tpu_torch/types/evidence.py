"""Evidence of byzantine behavior.

Reference: types/evidence.go — DuplicateVoteEvidence (two conflicting votes
by one validator at the same H/R/type) and LightClientAttackEvidence (a
conflicting light block + the byzantine validators behind it). Conflicting
votes are captured in VoteSet.addVote (types/vote_set.go:209-213) and
verified in evidence/verify.go:162 / :113.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..crypto import merkle
from ..libs import protoio as pio
from .vote import Vote


@dataclass
class DuplicateVoteEvidence:
    vote_a: Vote  # lexicographically smaller block key
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = 0

    TYPE = 1

    @classmethod
    def from_votes(
        cls, vote1: Vote, vote2: Vote, total_power: int, val_power: int, ts: int
    ) -> "DuplicateVoteEvidence":
        a, b = sorted(
            (vote1, vote2), key=lambda v: v.block_id.key()
        )
        return cls(a, b, total_power, val_power, ts)

    def height(self) -> int:
        return self.vote_a.height

    def validate_basic(self) -> None:
        a, b = self.vote_a, self.vote_b
        a.validate_basic()
        b.validate_basic()
        if (a.height, a.round, a.type) != (b.height, b.round, b.type):
            raise ValueError("votes are not for the same H/R/type")
        if a.validator_address != b.validator_address:
            raise ValueError("votes from different validators")
        if a.block_id.key() == b.block_id.key():
            raise ValueError("votes for the same block — not conflicting")
        if a.block_id.key() > b.block_id.key():
            raise ValueError("votes out of canonical order")

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.TYPE),
                pio.field_message(2, self.vote_a.encode()),
                pio.field_message(3, self.vote_b.encode()),
                pio.field_varint(4, self.total_voting_power),
                pio.field_varint(5, self.validator_power),
                pio.field_varint(6, self.timestamp_ns),
            ]
        )

    def hash(self) -> bytes:
        return merkle.leaf_hash(self.encode())

    @classmethod
    def decode_body(cls, f: dict) -> "DuplicateVoteEvidence":
        return cls(
            vote_a=Vote.decode(f[2][0]),
            vote_b=Vote.decode(f[3][0]),
            total_voting_power=f.get(4, [0])[0],
            validator_power=f.get(5, [0])[0],
            timestamp_ns=f.get(6, [0])[0],
        )


@dataclass
class LightClientAttackEvidence:
    """A conflicting (signed but forked) light block.

    conflicting_block is kept encoded: (header bytes, commit bytes,
    validator-set bytes) — the evidence module decodes as needed.
    """

    conflicting_header: bytes
    conflicting_commit: bytes
    conflicting_validators: bytes
    common_height: int
    byzantine_validators: list[bytes] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp_ns: int = 0

    TYPE = 2

    def height(self) -> int:
        return self.common_height

    def validate_basic(self) -> None:
        if self.common_height <= 0:
            raise ValueError("invalid common height")
        if not self.conflicting_header:
            raise ValueError("missing conflicting header")

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.TYPE),
                pio.field_bytes(2, self.conflicting_header),
                pio.field_bytes(3, self.conflicting_commit),
                pio.field_bytes(4, self.conflicting_validators),
                pio.field_varint(5, self.common_height),
            ]
            + [
                pio.field_bytes(6, a) for a in self.byzantine_validators
            ]
            + [
                pio.field_varint(7, self.total_voting_power),
                pio.field_varint(8, self.timestamp_ns),
            ]
        )

    def hash(self) -> bytes:
        return merkle.leaf_hash(self.encode())

    @classmethod
    def decode_body(cls, f: dict) -> "LightClientAttackEvidence":
        return cls(
            conflicting_header=f.get(2, [b""])[0],
            conflicting_commit=f.get(3, [b""])[0],
            conflicting_validators=f.get(4, [b""])[0],
            common_height=f.get(5, [0])[0],
            byzantine_validators=f.get(6, []),
            total_voting_power=f.get(7, [0])[0],
            timestamp_ns=f.get(8, [0])[0],
        )


def decode_evidence(data: bytes):
    f = pio.decode_fields(data)
    t = f.get(1, [0])[0]
    if t == DuplicateVoteEvidence.TYPE:
        return DuplicateVoteEvidence.decode_body(f)
    if t == LightClientAttackEvidence.TYPE:
        return LightClientAttackEvidence.decode_body(f)
    raise ValueError(f"unknown evidence type {t}")


def encode_evidence_list(evs: list) -> bytes:
    return b"".join(pio.field_message(1, ev.encode()) for ev in evs)


def decode_evidence_list(data: bytes) -> list:
    if not data:
        return []
    f = pio.decode_fields(data)
    return [decode_evidence(d) for d in f.get(1, [])]


def evidence_hash(evs: list) -> bytes:
    return merkle.hash_from_byte_slices([ev.encode() for ev in evs])
