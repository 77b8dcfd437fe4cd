"""Ethereum interop utilities: RLP + legacy transactions.

Reference: ethutil/ (util.go EncodeTransactions/DecodeTxs,
transaction.go GetSender/RlpFieldsToLegacyTx, hex/). The L2 bridge moves
RLP-encoded legacy txs between the consensus node and the execution
node; sender recovery uses EIP-155 v-values with keccak + secp256k1
public-key recovery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .crypto import secp256k1
from .crypto.keccak import keccak256

# --- RLP -------------------------------------------------------------------


def rlp_encode(item) -> bytes:
    """item: bytes | int | list (nested)."""
    if isinstance(item, int):
        if item == 0:
            payload = b""
        else:
            payload = item.to_bytes((item.bit_length() + 7) // 8, "big")
        return rlp_encode(payload)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_len(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        body = b"".join(rlp_encode(x) for x in item)
        return _rlp_len(len(body), 0xC0) + body
    raise TypeError(f"cannot rlp-encode {type(item)}")


def _rlp_len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def rlp_decode(data: bytes):
    """Returns (item, remaining). Raises ValueError on malformed input."""
    if not data:
        raise ValueError("empty rlp")
    b0 = data[0]
    if b0 < 0x80:
        return data[:1], data[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        if len(data) < 1 + n:
            raise ValueError("truncated rlp string")
        return data[1 : 1 + n], data[1 + n :]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(data[1 : 1 + ln], "big")
        start = 1 + ln
        if len(data) < start + n:
            raise ValueError("truncated rlp long string")
        return data[start : start + n], data[start + n :]
    if b0 < 0xF8:
        n = b0 - 0xC0
        body, rest = data[1 : 1 + n], data[1 + n :]
        if len(body) < n:
            raise ValueError("truncated rlp list")
        return _decode_list(body), rest
    ln = b0 - 0xF7
    n = int.from_bytes(data[1 : 1 + ln], "big")
    start = 1 + ln
    body, rest = data[start : start + n], data[start + n :]
    if len(body) < n:
        raise ValueError("truncated rlp long list")
    return _decode_list(body), rest


def _decode_list(body: bytes) -> list:
    out = []
    while body:
        item, body = rlp_decode(body)
        out.append(item)
    return out


def _to_int(b: bytes) -> int:
    return int.from_bytes(b, "big") if b else 0


# --- legacy transactions ----------------------------------------------------


@dataclass
class LegacyTx:
    """Pre-EIP-1559 transaction (reference RlpFieldsToLegacyTx,
    transaction.go:35)."""

    nonce: int = 0
    gas_price: int = 0
    gas: int = 0
    to: bytes = b""  # 20 bytes or empty (contract creation)
    value: int = 0
    data: bytes = b""
    v: int = 0
    r: int = 0
    s: int = 0

    def encode(self) -> bytes:
        return rlp_encode(
            [
                self.nonce,
                self.gas_price,
                self.gas,
                self.to,
                self.value,
                self.data,
                self.v,
                self.r,
                self.s,
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> tuple["LegacyTx", bytes]:
        fields, rest = rlp_decode(data)
        if not isinstance(fields, list) or len(fields) != 9:
            raise ValueError("not a legacy tx")
        return (
            cls(
                nonce=_to_int(fields[0]),
                gas_price=_to_int(fields[1]),
                gas=_to_int(fields[2]),
                to=fields[3],
                value=_to_int(fields[4]),
                data=fields[5],
                v=_to_int(fields[6]),
                r=_to_int(fields[7]),
                s=_to_int(fields[8]),
            ),
            rest,
        )

    def chain_id(self) -> int:
        """EIP-155 chain id from v (0 for pre-155 txs)."""
        if self.v in (27, 28):
            return 0
        return (self.v - 35) // 2

    def signing_hash(self) -> bytes:
        cid = self.chain_id()
        if cid == 0:
            payload = [
                self.nonce, self.gas_price, self.gas,
                self.to, self.value, self.data,
            ]
        else:
            payload = [
                self.nonce, self.gas_price, self.gas,
                self.to, self.value, self.data, cid, 0, 0,
            ]
        return keccak256(rlp_encode(payload))

    def hash(self) -> bytes:
        return keccak256(self.encode())

    def sender(self) -> Optional[bytes]:
        """Recover the 20-byte sender address (reference GetSender,
        transaction.go:11)."""
        if self.v in (27, 28):
            rec_id = self.v - 27
        else:
            rec_id = (self.v - 35) % 2
        sig65 = (
            self.r.to_bytes(32, "big")
            + self.s.to_bytes(32, "big")
            + bytes([rec_id])
        )
        return secp256k1.eth_recover_address(self.signing_hash(), sig65)

    def sign(self, secret: int, chain_id: int) -> None:
        """EIP-155 sign in place."""
        self.v = 35 + 2 * chain_id  # placeholder for hash computation
        payload = [
            self.nonce, self.gas_price, self.gas,
            self.to, self.value, self.data, chain_id, 0, 0,
        ]
        digest = keccak256(rlp_encode(payload))
        sig = secp256k1.eth_sign(digest, secret)
        self.r = int.from_bytes(sig[:32], "big")
        self.s = int.from_bytes(sig[32:64], "big")
        self.v = 35 + 2 * chain_id + sig[64]


def encode_transactions(txs: list[LegacyTx]) -> bytes:
    """Concatenated RLP (reference EncodeTransactions, util.go:22)."""
    return b"".join(tx.encode() for tx in txs)


def decode_txs(data: bytes) -> list[LegacyTx]:
    """Parse concatenated RLP txs (reference DecodeTxs, util.go:116)."""
    out = []
    while data:
        tx, data = LegacyTx.decode(data)
        out.append(tx)
    return out
