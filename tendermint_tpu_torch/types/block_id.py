"""BlockID — block hash + part-set header (reference types/block.go BlockID)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protoio as pio
from .part_set import PartSetHeader


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == 32
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == 32
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != 32:
            raise ValueError("wrong block hash size")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key for vote tallies (reference BlockID.Key)."""
        return self.hash + self.part_set_header.encode()

    def encode(self) -> bytes:
        return pio.field_bytes(1, self.hash) + pio.field_message(
            2, self.part_set_header.encode()
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        if not data:
            return cls()
        f = pio.decode_fields(data)
        return cls(
            hash=f.get(1, [b""])[0],
            part_set_header=PartSetHeader.decode(f.get(2, [b""])[0]),
        )

    def __repr__(self) -> str:
        if self.is_zero():
            return "BlockID{nil}"
        return f"BlockID{{{self.hash.hex()[:12]}}}"
