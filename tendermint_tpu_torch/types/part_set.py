"""Block part sets — blocks gossiped as merkle-proven 64KB chunks.

Reference: types/part_set.go (`Part`, `PartSetHeader`, `PartSet`). Blocks
are serialized, split into BlockPartSizeBytes chunks, and each part carries
a merkle proof against the PartSetHeader hash that rides in the BlockID.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..crypto import merkle
from ..libs import protoio as pio
from ..libs.bits import BitArray

BLOCK_PART_SIZE_BYTES = 65536


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative part set total")
        if self.hash and len(self.hash) != 32:
            raise ValueError("wrong part set hash size")

    def encode(self) -> bytes:
        return pio.field_varint(1, self.total) + pio.field_bytes(2, self.hash)

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        f = pio.decode_fields(data)
        return cls(total=f.get(1, [0])[0], hash=f.get(2, [b""])[0])


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof
    # memoized wire encoding: a part is immutable after construction and
    # is re-encoded per gossip send AND per block-store save on the host
    # hot path — §10-style cache, ~64KB copied instead of re-framed
    _encoded: Optional[bytes] = field(
        default=None, compare=False, repr=False
    )

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError("part too big")

    def encode(self) -> bytes:
        if self._encoded is not None:
            return self._encoded
        proof = (
            pio.field_varint(1, self.proof.total)
            + pio.field_varint(2, self.proof.index)
            + pio.field_bytes(3, self.proof.leaf_hash)
            + b"".join(pio.field_bytes(4, a) for a in self.proof.aunts)
        )
        self._encoded = (
            pio.field_varint(1, self.index)
            + pio.field_bytes(2, self.bytes_)
            + pio.field_message(3, proof)
        )
        return self._encoded

    @classmethod
    def decode(cls, data: bytes) -> "Part":
        f = pio.decode_fields(data)
        pf = pio.decode_fields(f[3][0])
        proof = merkle.Proof(
            total=pf.get(1, [0])[0],
            index=pf.get(2, [0])[0],
            leaf_hash=pf.get(3, [b""])[0],
            aunts=pf.get(4, []),
        )
        return cls(
            index=f.get(1, [0])[0], bytes_=f.get(2, [b""])[0], proof=proof
        )


class PartSet:
    """Either built complete from a block's bytes (proposer side) or
    assembled incrementally from gossiped parts (receiver side)."""

    def __init__(self, header: PartSetHeader):
        self._header = header
        self._parts: list[Optional[Part]] = [None] * header.total
        self._bit_array = BitArray(header.total)
        self._count = 0
        self._byte_size = 0

    @classmethod
    def from_data(
        cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES
    ) -> "PartSet":
        chunks = [
            data[i : i + part_size] for i in range(0, len(data), part_size)
        ] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            part = Part(index=i, bytes_=chunk, proof=proof)
            ps._parts[i] = part
            ps._bit_array.set(i, True)
            ps._count += 1
            ps._byte_size += len(chunk)
        return ps

    @property
    def header(self) -> PartSetHeader:
        return self._header

    def has_header(self, h: PartSetHeader) -> bool:
        return self._header == h

    @property
    def bit_array(self) -> BitArray:
        return self._bit_array.copy()

    @property
    def byte_size(self) -> int:
        return self._byte_size

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> int:
        return self._header.total

    def is_complete(self) -> bool:
        return self._count == self._header.total

    def get_part(self, index: int) -> Optional[Part]:
        if 0 <= index < len(self._parts):
            return self._parts[index]
        return None

    def add_part(self, part: Part) -> bool:
        """Returns True if added; raises on invalid proof (the reference's
        ErrPartSetInvalidProof)."""
        if part.index >= self._header.total:
            raise ValueError("part index out of bounds")
        if self._parts[part.index] is not None:
            return False
        if not part.proof.verify(self._header.hash, part.bytes_):
            raise ValueError("invalid part proof")
        if part.proof.index != part.index or part.proof.total != self.total:
            raise ValueError("part proof index mismatch")
        self._parts[part.index] = part
        self._bit_array.set(part.index, True)
        self._count += 1
        self._byte_size += len(part.bytes_)
        return True

    def get_bytes(self) -> bytes:
        if not self.is_complete():
            raise ValueError("part set incomplete")
        return b"".join(p.bytes_ for p in self._parts)  # type: ignore
