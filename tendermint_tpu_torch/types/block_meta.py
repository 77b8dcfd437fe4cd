"""BlockMeta — header + block id + sizes, the block-store index record
(reference types/block_meta.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protoio as pio
from .block import Block, Header
from .block_id import BlockID
from .part_set import PartSet


@dataclass
class BlockMeta:
    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    @classmethod
    def from_block(cls, block: Block, part_set: PartSet) -> "BlockMeta":
        return cls(
            block_id=BlockID(block.hash(), part_set.header),
            block_size=sum(
                len(part_set.get_part(i).bytes_) for i in range(part_set.total)
            ),
            header=block.header,
            num_txs=len(block.data.txs),
        )

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_message(1, self.block_id.encode()),
                pio.field_varint(2, self.block_size),
                pio.field_message(3, self.header.encode()),
                pio.field_varint(4, self.num_txs + 1),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockMeta":
        f = pio.decode_fields(data)
        return cls(
            block_id=BlockID.decode(f[1][0]),
            block_size=f.get(2, [0])[0],
            header=Header.decode(f[3][0]),
            num_txs=f.get(4, [1])[0] - 1,
        )
