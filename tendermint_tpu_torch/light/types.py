"""LightBlock — signed header + validator set (reference types/light.go)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

from ..libs import protoio as pio
from ..types.block import Commit, Header
from ..types.quorum_cert import QuorumCertificate
from ..types.validator_set import ValidatorSet


@dataclass
class LightBlock:
    """Signed header + validator set. The proof is EITHER the full
    commit (N CommitSigs — the legacy shape), a QuorumCertificate
    (~100 bytes + signer bitset — the QC-compressed shape the million-
    client plane serves), or both (full proofs on QC chains carry the
    qc alongside so verifiers pick the one-pairing path)."""

    header: Header
    commit: Optional[Commit]
    validators: ValidatorSet
    qc: Optional[QuorumCertificate] = None

    @property
    def height(self) -> int:
        return self.header.height

    def validate_basic(self, chain_id: str) -> None:
        if self.header.chain_id != chain_id:
            raise ValueError("light block from wrong chain")
        if self.commit is None and self.qc is None:
            raise ValueError("light block carries neither commit nor qc")
        if self.commit is not None:
            self.commit.validate_basic()
            if self.commit.height != self.header.height:
                raise ValueError("commit height != header height")
            if self.commit.block_id.hash != self.header.hash():
                raise ValueError("commit is not for this header")
        if self.qc is not None:
            self.qc.validate_basic()
            if self.qc.height != self.header.height:
                raise ValueError("qc height != header height")
            if self.qc.block_id.hash != self.header.hash():
                raise ValueError("qc is not for this header")
        if self.header.validators_hash != self.validators.hash():
            raise ValueError("validator set does not match header")

    def encode(self) -> bytes:
        return (
            pio.field_message(1, self.header.encode())
            + (
                pio.field_message(2, self.commit.encode())
                if self.commit is not None
                else b""
            )
            + pio.field_message(3, self.validators.encode())
            + (
                pio.field_message(4, self.qc.encode())
                if self.qc is not None
                else b""
            )
        )

    def proof_bytes(self) -> int:
        """Wire size of the commit proof alone (what the QC plane
        compresses): commit + qc bytes, excluding header/valset."""
        n = 0
        if self.commit is not None:
            n += len(self.commit.encode())
        if self.qc is not None:
            n += len(self.qc.encode())
        return n

    @classmethod
    def decode(cls, data: bytes) -> "LightBlock":
        f = pio.decode_fields(data)
        return cls(
            header=Header.decode(f[1][0]),
            commit=Commit.decode(f[2][0]) if 2 in f else None,
            validators=ValidatorSet.decode(f[3][0]),
            qc=QuorumCertificate.decode(f[4][0]) if 4 in f else None,
        )


@runtime_checkable
class Provider(Protocol):
    """Light block source (reference light/provider/provider.go)."""

    async def light_block(self, height: int) -> Optional[LightBlock]:
        """height=0 means latest. None if not found."""
        ...

    def id(self) -> str: ...
