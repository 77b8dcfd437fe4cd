"""BlockV2 — the post-upgrade centralized-sequencer block format.

Reference: types/block_v2.go:15-42 (ExecutableL2Data-shaped block with an
ECDSA sequencer signature over the 32-byte block hash) and :80-93
(RecoverBlockV2Signer via eth-style recoverable signatures). The wire format
mirrors proto/tendermint/sequencer BlockV2 field numbering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..crypto import secp256k1
from ..libs import protoio as pio

# process-wide count of ACTUAL wire serializations (memo misses): the
# encode-once fan-out bench asserts one serialization per broadcast
# block regardless of subscriber count (tests/bench read the delta)
_SERIALIZATIONS = 0


def serializations() -> int:
    """Total BlockV2 cache-miss serializations this process."""
    return _SERIALIZATIONS


@dataclass
class BlockV2:
    parent_hash: bytes = b"\x00" * 32
    miner: bytes = b"\x00" * 20
    number: int = 0
    gas_limit: int = 0
    base_fee: int = 0
    timestamp: int = 0
    transactions: list[bytes] = field(default_factory=list)
    state_root: bytes = b"\x00" * 32
    gas_used: int = 0
    receipt_root: bytes = b"\x00" * 32
    logs_bloom: bytes = b""
    withdraw_trie_root: bytes = b"\x00" * 32
    next_l1_message_index: int = 0
    hash: bytes = b"\x00" * 32
    signature: bytes = b""
    # memoized wire encoding (the Part.encode pattern): a sequencer
    # gossips one block to N subscriber peers and serves it again on the
    # 0x51 sync channel — one serialization, N framed copies. Field
    # assignment invalidates (__setattr__ below); in-place mutation of
    # `transactions` after an encode does not, same immutability
    # contract as Part.bytes_.
    _encoded: Optional[bytes] = field(default=None, compare=False, repr=False)

    def __setattr__(self, name, value):
        if name != "_encoded":
            object.__setattr__(self, "_encoded", None)
        object.__setattr__(self, name, value)

    # --- SyncableBlock interface (types/block_v2.go:57-63) ----------------

    def get_height(self) -> int:
        return self.number

    def get_hash(self) -> bytes:
        return self.hash

    # --- signatures --------------------------------------------------------

    def recover_signer(self) -> Optional[bytes]:
        """Eth address of the signer, or None (RecoverBlockV2Signer,
        types/block_v2.go:80-93)."""
        if not self.signature:
            return None
        return secp256k1.eth_recover_address(self.hash, self.signature)

    # --- wire (proto field numbering of seqproto.BlockV2) -------------------

    def encode(self) -> bytes:
        if self._encoded is not None:
            return self._encoded
        global _SERIALIZATIONS
        _SERIALIZATIONS += 1
        out = b""
        out += pio.field_bytes(1, self.parent_hash)
        out += pio.field_bytes(2, self.miner)
        out += pio.field_varint(3, self.number)
        out += pio.field_varint(4, self.gas_limit)
        out += pio.field_bytes(
            5,
            self.base_fee.to_bytes((self.base_fee.bit_length() + 7) // 8, "big")
            if self.base_fee
            else b"",
        )
        out += pio.field_varint(6, self.timestamp)
        for tx in self.transactions:
            out += pio.field_bytes(7, tx)
        out += pio.field_bytes(8, self.state_root)
        out += pio.field_varint(9, self.gas_used)
        out += pio.field_bytes(10, self.receipt_root)
        out += pio.field_bytes(11, self.logs_bloom)
        out += pio.field_bytes(12, self.withdraw_trie_root)
        out += pio.field_varint(13, self.next_l1_message_index)
        out += pio.field_bytes(14, self.hash)
        out += pio.field_bytes(15, self.signature)
        # assign via object.__setattr__: a plain assignment would
        # immediately invalidate the cache it is trying to fill
        object.__setattr__(self, "_encoded", out)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "BlockV2":
        b = cls()
        b.transactions = []
        for num, wire, val in pio.iter_fields(data):
            if num == 1:
                b.parent_hash = val
            elif num == 2:
                b.miner = val
            elif num == 3:
                b.number = val
            elif num == 4:
                b.gas_limit = val
            elif num == 5:
                b.base_fee = int.from_bytes(val, "big") if val else 0
            elif num == 6:
                b.timestamp = val
            elif num == 7:
                b.transactions.append(val)
            elif num == 8:
                b.state_root = val
            elif num == 9:
                b.gas_used = val
            elif num == 10:
                b.receipt_root = val
            elif num == 11:
                b.logs_bloom = val
            elif num == 12:
                b.withdraw_trie_root = val
            elif num == 13:
                b.next_l1_message_index = val
            elif num == 14:
                b.hash = val
            elif num == 15:
                b.signature = val
        if len(b.parent_hash) != 32:
            raise ValueError("invalid parent hash length")
        if len(b.hash) != 32:
            raise ValueError("invalid block hash length")
        return b
