"""VoteSet — tallies one (height, round, type) of votes toward 2/3.

Reference: types/vote_set.go (VoteSet:63, addVote:156, the conflicting-vote
capture :209-213 that feeds duplicate-vote evidence, and 2/3 bookkeeping).
Signature verification is injectable: the consensus path verifies votes
through the TPU micro-batcher *before* insertion (add_vote(verified=True));
standalone callers keep the serial host check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..libs.bits import BitArray
from .block_id import BlockID
from .block import BlockIDFlag, Commit, CommitSig
from .validator_set import ValidatorSet
from .vote import Vote, VoteType


class ConflictingVoteError(Exception):
    def __init__(self, existing: Vote, new: Vote):
        super().__init__(
            f"conflicting votes from validator {new.validator_address.hex()}"
        )
        self.existing = existing
        self.new = new


@dataclass
class _BlockVotes:
    peer_maj23: bool
    bit_array: BitArray
    votes: list[Optional[Vote]]
    sum: int = 0

    @classmethod
    def new(cls, peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return cls(
            peer_maj23, BitArray(num_validators), [None] * num_validators
        )

    def add_verified_vote(self, vote: Vote, power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set(idx, True)
            self.votes[idx] = vote
            self.sum += power


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: int,
        val_set: ValidatorSet,
    ):
        if height == 0:
            raise ValueError("cannot make VoteSet for height 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: list[Optional[Vote]] = [None] * val_set.size()
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    # --- adding votes -----------------------------------------------------

    def add_vote(self, vote: Optional[Vote], verified: bool = False) -> bool:
        """Returns True if the vote was added, False if it was a duplicate.
        Raises ValueError for invalid votes, ConflictingVoteError for
        equivocation (captured for evidence, reference vote_set.go:209-213).
        """
        if vote is None:
            raise ValueError("nil vote")
        val_index = vote.validator_index
        if val_index < 0:
            raise ValueError("vote has negative validator index")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            raise ValueError(
                f"vote H/R/T {vote.height}/{vote.round}/{vote.type} does not "
                f"match VoteSet {self.height}/{self.round}/{self.signed_msg_type}"
            )
        val = self.val_set.get_by_index(val_index)
        if val is None:
            raise ValueError(f"validator index {val_index} out of range")
        if val.address != vote.validator_address:
            raise ValueError("vote validator address does not match index")

        # dedupe / conflict detection before paying for verification
        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                if existing.signature != vote.signature and not verified:
                    # same vote, different signature: only the first counts
                    raise ValueError("non-deterministic signature")
                return False  # duplicate

        if not verified:
            if not vote.verify(self.chain_id, val.pub_key):
                raise ValueError("invalid vote signature")

        block_key = vote.block_id.key()
        by_block_existing = self.votes_by_block.get(block_key)
        if (
            by_block_existing is not None
            and by_block_existing.votes[val_index] is not None
        ):
            return False  # already tracked for this block (duplicate)
        if existing is not None and existing.block_id.key() != block_key:
            if by_block_existing is None or not by_block_existing.peer_maj23:
                # equivocation — surfaced for duplicate-vote evidence; the
                # conflicting vote is NOT tallied (reference vote_set.go:209)
                raise ConflictingVoteError(existing, vote)
            # tracked because a peer claimed 2/3 for this block; fall through

        by_block = self.votes_by_block.get(block_key)
        if by_block is None:
            by_block = _BlockVotes.new(False, self.size())
            self.votes_by_block[block_key] = by_block

        if existing is None:
            self.votes[val_index] = vote
            self.votes_bit_array.set(val_index, True)
            self.sum += val.voting_power

        before = by_block.sum
        by_block.add_verified_vote(vote, val.voting_power)
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        if before < quorum <= by_block.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # promote this block's votes into the canonical list
            for i, v in enumerate(by_block.votes):
                if v is not None:
                    self.votes[i] = v
        return existing is None or existing.block_id.key() != block_key

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims to have seen 2/3 for block_id; start tracking its
        votes even if they conflict with this node's view
        (reference vote_set.go SetPeerMaj23)."""
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing != block_id:
                raise ValueError("conflicting maj23 claim from peer")
            return
        self.peer_maj23s[peer_id] = block_id
        key = block_id.key()
        if key not in self.votes_by_block:
            self.votes_by_block[key] = _BlockVotes.new(True, self.size())
        else:
            self.votes_by_block[key].peer_maj23 = True

    # --- queries ----------------------------------------------------------

    def get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        v = (
            self.votes[val_index]
            if 0 <= val_index < len(self.votes)
            else None
        )
        if v is not None and v.block_id.key() == block_key:
            return v
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.votes[val_index]
        return None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        return self.votes[val_index]

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv else None

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def two_thirds_majority(self) -> tuple[BlockID, bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return BlockID(), False

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    # --- commit construction ---------------------------------------------

    def make_commit(self) -> Commit:
        if self.signed_msg_type != VoteType.PRECOMMIT:
            raise ValueError("cannot make commit from non-precommit VoteSet")
        if self.maj23 is None:
            raise ValueError("cannot make commit: no 2/3 majority")
        if self.maj23.is_zero():
            raise ValueError("cannot make commit: 2/3 majority is for nil")
        sigs = []
        for v in self.votes:
            if v is not None and v.block_id == self.maj23:
                flag = BlockIDFlag.COMMIT
            elif v is not None and v.is_nil():
                flag = BlockIDFlag.NIL
            else:
                sigs.append(CommitSig.absent())
                continue
            sigs.append(
                CommitSig(
                    block_id_flag=flag,
                    validator_address=v.validator_address,
                    timestamp_ns=v.timestamp_ns,
                    signature=v.signature,
                    bls_signature=v.bls_signature,
                    qc_signature=v.qc_signature,
                )
            )
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.maj23,
            signatures=sigs,
        )

    def __repr__(self) -> str:
        return (
            f"VoteSet{{H:{self.height} R:{self.round} T:{self.signed_msg_type}"
            f" {self.votes_bit_array}}}"
        )
