"""Validator — address, pubkey, voting power, proposer priority.

Reference: types/validator.go. Key-type agnostic: pubkey is any object with
`.data: bytes`, `.address() -> bytes`, `.verify(msg, sig) -> bool` and a
`.type_name` ("ed25519" / "secp256k1" / "sr25519" / "bls12-381").
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ..libs import protoio as pio
from ..crypto import ed25519


def pubkey_from_type(type_name: str, data: bytes):
    if type_name == "ed25519":
        return ed25519.PubKey(data)
    if type_name == "secp256k1":
        from ..crypto import secp256k1

        return secp256k1.PubKey(data)
    if type_name == "sr25519":
        from ..crypto import sr25519

        return sr25519.PubKey(data)
    raise ValueError(f"unknown pubkey type {type_name!r}")


def pubkey_type_name(pubkey) -> str:
    return getattr(pubkey, "type_name", "ed25519")


@dataclass
class Validator:
    pub_key: object  # crypto pubkey
    voting_power: int
    proposer_priority: int = 0
    _address: Optional[bytes] = None
    # morph QC plane: the validator's BLS12-381 public key (uncompressed
    # G2 wire, 192 bytes) — committed into the validator-set hash when
    # present, so a hash-verified set pins the keys a QuorumCertificate
    # aggregate verifies against. Empty = not QC-capable (legacy sets
    # hash identically: the field is omitted from the encoding).
    bls_pub_key: bytes = b""

    @property
    def address(self) -> bytes:
        if self._address is None:
            object.__setattr__(self, "_address", self.pub_key.address())
        return self._address

    def copy(self) -> "Validator":
        return Validator(
            self.pub_key, self.voting_power, self.proposer_priority,
            bls_pub_key=self.bls_pub_key,
        )

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break to the lower address
        (reference types/validator.go CompareProposerPriority)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        return self if self.address < other.address else other

    def encode(self) -> bytes:
        """Deterministic encoding for validator-set hashing
        (reference types/validator.go Bytes: pubkey + voting power)."""
        return (
            pio.field_bytes(1, pubkey_type_name(self.pub_key).encode())
            + pio.field_bytes(2, self.pub_key.data)
            + pio.field_varint(3, self.voting_power)
            # field 5 (4 is the set-level priority field, validator_set
            # encode): only present for QC-capable validators, so legacy
            # sets keep their exact hash
            + (
                pio.field_bytes(5, self.bls_pub_key)
                if self.bls_pub_key
                else b""
            )
        )

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator has nil pubkey")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("wrong validator address size")
        if self.bls_pub_key and len(self.bls_pub_key) != 192:
            raise ValueError("wrong bls pubkey size (uncompressed G2)")

    def __repr__(self) -> str:
        return (
            f"Validator{{{self.address.hex()[:12]} "
            f"VP:{self.voting_power} A:{self.proposer_priority}}}"
        )
