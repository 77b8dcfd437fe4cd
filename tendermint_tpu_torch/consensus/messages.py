"""Consensus messages — the 9 wire messages of the consensus reactor.

Reference: consensus/reactor.go:1473-1732 (NewRoundStep, NewValidBlock,
Proposal, ProposalPOL, BlockPart, Vote, HasVote, VoteSetMaj23,
VoteSetBits). Each encodes with protoio field primitives; the reactor
frames them with a type tag.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..libs import protoio as pio
from ..libs.bits import BitArray
from ..types.block_id import BlockID
from ..types.part_set import Part, PartSetHeader
from ..types.proposal import Proposal
from ..types.vote import Vote


@dataclass
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = -1

    TAG = 1

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.step),
                pio.field_varint(4, self.seconds_since_start_time + 1),
                pio.field_varint(5, self.last_commit_round + 2),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "NewRoundStepMessage":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            step=f.get(3, [0])[0],
            seconds_since_start_time=f.get(4, [1])[0] - 1,
            last_commit_round=f.get(5, [2])[0] - 2,
        )


@dataclass
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: PartSetHeader
    block_parts: BitArray
    is_commit: bool

    TAG = 2

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_message(3, self.block_part_set_header.encode()),
                pio.field_varint(4, self.block_parts.size),
                pio.field_bytes(5, self.block_parts.to_bytes()),
                pio.field_varint(6, 1 if self.is_commit else 0),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "NewValidBlockMessage":
        f = pio.decode_fields(data)
        size = f.get(4, [0])[0]
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            block_part_set_header=PartSetHeader.decode(f.get(3, [b""])[0]),
            block_parts=BitArray.from_bytes(size, f.get(5, [b""])[0]),
            is_commit=bool(f.get(6, [0])[0]),
        )


@dataclass
class ProposalMessage:
    proposal: Proposal

    TAG = 3

    def encode(self) -> bytes:
        return self.proposal.encode()

    @classmethod
    def decode(cls, data: bytes) -> "ProposalMessage":
        return cls(Proposal.decode(data))


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray

    TAG = 4

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.proposal_pol_round + 1),
                pio.field_varint(3, self.proposal_pol.size),
                pio.field_bytes(4, self.proposal_pol.to_bytes()),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "ProposalPOLMessage":
        f = pio.decode_fields(data)
        size = f.get(3, [0])[0]
        return cls(
            height=f.get(1, [0])[0],
            proposal_pol_round=f.get(2, [1])[0] - 1,
            proposal_pol=BitArray.from_bytes(size, f.get(4, [b""])[0]),
        )


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part

    TAG = 5

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_message(3, self.part.encode()),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockPartMessage":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            part=Part.decode(f[3][0]),
        )


@dataclass
class VoteMessage:
    vote: Vote
    # in-process only (never wire-encoded): the reactor's micro-batcher
    # already verified this vote's signature on the device, so the state
    # machine can insert without re-verifying (SURVEY.md §7.3 hard part 3)
    pre_verified: bool = False
    # in-process only: the batch-point BLS signature already passed the
    # reactor's aggregate micro-batcher (consensus/bls_batcher.py)
    bls_pre_verified: bool = False

    TAG = 6

    def encode(self) -> bytes:
        return self.vote.encode()

    @classmethod
    def decode(cls, data: bytes) -> "VoteMessage":
        return cls(Vote.decode(data))


@dataclass
class VoteBatchMessage:
    """A chunk of votes for one (height, round, type) vote set — the
    committee-scale replacement for trickling one VoteMessage per gossip
    tick. Gossiped on VOTE_BATCH_CHANNEL, which only batch-capable peers
    advertise (legacy peers keep receiving single VoteMessages). Each
    vote still carries its own full identity; the envelope fields are
    the sender's bookkeeping hint, not trusted routing."""

    height: int
    round: int
    type: int
    votes: list[Vote] = field(default_factory=list)
    # in-proc only (never wire-encoded): per-vote verdicts from the
    # reactor's micro-batchers, aligned with `votes` — the state machine
    # skips its serial checks for pre-verified entries (same contract as
    # VoteMessage.pre_verified, per element)
    pre_verified: Optional[list[bool]] = None
    bls_pre_verified: Optional[list[bool]] = None

    TAG = 10

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.type),
            ]
            + [pio.field_message(4, v.encode()) for v in self.votes]
        )

    @classmethod
    def decode(cls, data: bytes) -> "VoteBatchMessage":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            type=f.get(3, [0])[0],
            votes=[Vote.decode(d) for d in f.get(4, [])],
        )

    def iter_flags(self):
        """(vote, pre_verified, bls_pre_verified) triples; wire-decoded
        batches (flags None) yield False — the state machine then runs
        its serial checks exactly as for a plain VoteMessage."""
        pre = self.pre_verified or (False,) * len(self.votes)
        bls = self.bls_pre_verified or (False,) * len(self.votes)
        return zip(self.votes, pre, bls)


@dataclass
class HasVotesMessage:
    """Aggregate possession digest: 'I hold exactly these votes for
    (height, round, type)' as one bitmap — the committee-scale
    replacement for per-vote HasVote floods between batch-capable
    peers. Rides VOTE_BATCH_CHANNEL (legacy peers never see it; they
    keep receiving per-vote HasVote). Receivers OR it into their view
    of the peer, so relays stop re-shipping votes the peer already
    got from another path."""

    height: int
    round: int
    type: int
    votes: BitArray = field(default_factory=lambda: BitArray(0))

    TAG = 11

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.type),
                pio.field_varint(4, self.votes.size),
                pio.field_bytes(5, self.votes.to_bytes()),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "HasVotesMessage":
        f = pio.decode_fields(data)
        size = f.get(4, [0])[0]
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            type=f.get(3, [0])[0],
            votes=BitArray.from_bytes(size, f.get(5, [b""])[0]),
        )


@dataclass
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int

    TAG = 7

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.type),
                pio.field_varint(4, self.index + 1),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "HasVoteMessage":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            type=f.get(3, [0])[0],
            index=f.get(4, [1])[0] - 1,
        )


@dataclass
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID

    TAG = 8

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.type),
                pio.field_message(4, self.block_id.encode()),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "VoteSetMaj23Message":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            type=f.get(3, [0])[0],
            block_id=BlockID.decode(f.get(4, [b""])[0]),
        )


@dataclass
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID
    votes: BitArray

    TAG = 9

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_varint(3, self.type),
                pio.field_message(4, self.block_id.encode()),
                pio.field_varint(5, self.votes.size),
                pio.field_bytes(6, self.votes.to_bytes()),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "VoteSetBitsMessage":
        f = pio.decode_fields(data)
        size = f.get(5, [0])[0]
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            type=f.get(3, [0])[0],
            block_id=BlockID.decode(f.get(4, [b""])[0]),
            votes=BitArray.from_bytes(size, f.get(6, [b""])[0]),
        )


_BY_TAG = {
    m.TAG: m
    for m in (
        NewRoundStepMessage,
        NewValidBlockMessage,
        ProposalMessage,
        ProposalPOLMessage,
        BlockPartMessage,
        VoteMessage,
        HasVoteMessage,
        VoteSetMaj23Message,
        VoteSetBitsMessage,
        VoteBatchMessage,
        HasVotesMessage,
    )
}


def encode_msg(msg) -> bytes:
    return bytes([msg.TAG]) + msg.encode()


def decode_msg(data: bytes):
    if not data:
        raise ValueError("empty consensus message")
    cls = _BY_TAG.get(data[0])
    if cls is None:
        raise ValueError(f"unknown consensus message tag {data[0]}")
    return cls.decode(data[1:])
