"""PrivValidator — the signing interface consensus talks to.

Reference: types/priv_validator.go (PrivValidator iface: GetPubKey,
SignVote, SignProposal) + MockPV for tests. File-backed and remote-socket
implementations live in tendermint_tpu_torch/privval/.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

from ..crypto import ed25519
from .proposal import Proposal
from .vote import Vote


@runtime_checkable
class PrivValidator(Protocol):
    def get_pub_key(self): ...

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sets vote.signature (and may adjust timestamp on re-sign)."""
        ...

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None: ...


class MockPV:
    """In-memory signer for tests (reference types/priv_validator.go MockPV).
    No double-sign protection — that's FilePV's job."""

    def __init__(self, priv_key: ed25519.PrivKey | None = None):
        self.priv_key = priv_key or ed25519.PrivKey.generate()

    @classmethod
    def from_secret(cls, secret: bytes) -> "MockPV":
        return cls(ed25519.PrivKey.from_secret(secret))

    def get_pub_key(self):
        return self.priv_key.public_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        vote.signature = self.priv_key.sign(vote.sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        proposal.signature = self.priv_key.sign(
            proposal.sign_bytes(chain_id)
        )
