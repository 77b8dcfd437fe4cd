"""MockL2Node — complete in-memory L2 execution node fake.

Reference: l2node/mock.go:22-41 — the full in-mem fake including batch
encoding and validator-set-update injection, which is what makes the
consensus net testable without a real execution node.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..libs import protoio as pio
from .l2node import BlockData, BlsData


class MockL2Node:
    def __init__(
        self,
        txs_per_block: int = 2,
        batch_blocks_interval: int = 0,
        bls_verifier: Optional[Callable[[bytes, bytes, bytes], bool]] = None,
        bls_batch_verifier: Optional[
            Callable[[list, bytes, list], list]
        ] = None,
        max_block_txs: int = 0,
    ):
        self._lock = threading.Lock()
        self.txs_per_block = txs_per_block
        # gas-limit analog for the sustained-load harness: a V2 block
        # takes at most this many injected txs per pull, the remainder
        # stays pending for the next block (0 = unbounded, the original
        # drain-everything behavior)
        self.max_block_txs = max_block_txs
        self.batch_blocks_interval = batch_blocks_interval
        self._bls_verifier = bls_verifier
        self._bls_batch_verifier = bls_batch_verifier
        # injected pending validator updates: height -> list[(type,pub,power)]
        self.validator_updates: dict[int, list] = {}
        # executed chain
        self.delivered: list[tuple[int, bytes]] = []  # (height, block_hash)
        # batching state
        self.open_batch_blocks: list[bytes] = []
        self.sealed: Optional[tuple[bytes, bytes]] = None  # (hash, header)
        self.committed_batches: list[tuple[bytes, list[BlsData]]] = []
        self.bls_appended: list[tuple[int, bytes, BlsData]] = []
        # externally injectable txs (else deterministic synthetic txs)
        self.pending_txs: list[bytes] = []

    # --- block production -------------------------------------------------

    def inject_txs(self, txs: list[bytes]) -> None:
        with self._lock:
            self.pending_txs.extend(txs)

    def has_txs(self) -> bool:
        return True  # synthetic txs are always available

    def request_block_data(self, height: int) -> BlockData:
        with self._lock:
            if self.pending_txs:
                txs, self.pending_txs = self.pending_txs, []
            else:
                txs = [
                    b"tx-%d-%d=v%d" % (height, i, i)
                    for i in range(self.txs_per_block)
                ]
            meta = b"l2meta:" + pio.write_uvarint(height)
            return BlockData(txs=txs, l2_block_meta=meta)

    def check_block_data(self, txs: list[bytes], l2_block_meta: bytes) -> bool:
        return l2_block_meta.startswith(b"l2meta:")

    def deliver_block(self, height, block_hash, txs, l2_block_meta):
        with self._lock:
            self.delivered.append((height, block_hash))
            updates = self.validator_updates.pop(height, [])
            return updates, None

    def encode_txs(self, txs: list[bytes]) -> bytes:
        return b"".join(pio.field_bytes(1, tx) for tx in txs)

    def request_height(self, tm_height: int) -> int:
        return tm_height

    # --- BLS --------------------------------------------------------------

    def verify_signature(self, tm_pubkey, message_hash, signature):
        if self._bls_verifier is not None:
            return self._bls_verifier(tm_pubkey, message_hash, signature)
        # No registry configured: verdict is unknown (None), never a
        # cryptographic rejection — callers drop the vote (falsy) but
        # don't disconnect the relaying peer over a wiring gap; see
        # crypto/bls_signatures.BLSKeyRegistry for the real wiring.
        return None

    def verify_signatures(self, tm_pubkeys, message_hash, signatures):
        if self._bls_batch_verifier is not None:
            return self._bls_batch_verifier(
                tm_pubkeys, message_hash, signatures
            )
        return [
            self.verify_signature(pk, message_hash, sig)
            for pk, sig in zip(tm_pubkeys, signatures)
        ]

    def append_bls_data(self, height, batch_hash, data: BlsData) -> None:
        with self._lock:
            self.bls_appended.append((height, batch_hash, data))

    # --- batching ---------------------------------------------------------

    def calculate_batch_size_with_proposal_block(
        self, proposal_block_bytes: bytes, get_from_cache: bool
    ) -> bool:
        if self.batch_blocks_interval <= 0:
            return False
        with self._lock:
            return (
                len(self.open_batch_blocks) + 1 >= self.batch_blocks_interval
            )

    def seal_batch(self) -> tuple[bytes, bytes]:
        with self._lock:
            return self._seal_locked()

    def _seal_locked(self) -> tuple[bytes, bytes]:
        header = b"batch:" + pio.write_uvarint(
            len(self.open_batch_blocks)
        ) + b"".join(
            hashlib.sha256(b).digest() for b in self.open_batch_blocks
        )
        h = hashlib.sha256(header).digest()
        self.sealed = (h, header)
        return h, header

    def commit_batch(self, current_block_bytes, bls_datas) -> None:
        with self._lock:
            if self.sealed is None:
                # replay paths (blocksync, WAL handshake) commit batch-point
                # blocks without a preceding consensus-time seal; derive the
                # batch from our own packed state, as the real L2 node does
                self._seal_locked()
            self.committed_batches.append((self.sealed[0], list(bls_datas)))
            self.sealed = None
            self.open_batch_blocks = [current_block_bytes]

    def pack_current_block(self, current_block_bytes) -> None:
        with self._lock:
            self.open_batch_blocks.append(current_block_bytes)

    def batch_hash(self, batch_header: bytes) -> bytes:
        return hashlib.sha256(batch_header).digest()

    # --- V2 (sequencer mode) ------------------------------------------------
    # In-memory execution engine for BlockV2 (reference l2node.go:65-84).
    # Blocks form a hash-linked chain; "execution" is deterministic hashing.

    def _ensure_v2_genesis(self):
        if not hasattr(self, "v2_chain"):
            from ..types.block_v2 import BlockV2

            genesis = BlockV2(number=0)
            genesis.hash = hashlib.sha256(b"mock-l2-genesis").digest()
            # chain by number; index by hash
            self.v2_chain: list = [genesis]
            self.v2_by_hash = {genesis.hash: genesis}

    def seed_v2_height(self, height: int) -> None:
        """Test helper: advance the mock chain to `height` with unsigned
        linked blocks (simulates the pre-upgrade L2 state). Injected
        pending txs are stashed across the seed: they belong to the
        POST-upgrade blocks, and consuming them here would fork this
        node's deterministic seed chain away from every peer's."""
        self._ensure_v2_genesis()
        with self._lock:
            stash, self.pending_txs = self.pending_txs, []
        try:
            while self.v2_chain[-1].number < height:
                parent = self.v2_chain[-1]
                b, _ = self.request_block_data_v2(parent.hash)
                self.apply_block_v2(b)
        finally:
            with self._lock:
                self.pending_txs = stash + self.pending_txs

    def request_block_data_v2(self, parent_hash: bytes):
        self._ensure_v2_genesis()
        from ..types.block_v2 import BlockV2

        with self._lock:
            parent = self.v2_by_hash.get(bytes(parent_hash))
            if parent is None:
                raise ValueError("unknown parent hash")
            if self.pending_txs:
                cut = self.max_block_txs or len(self.pending_txs)
                txs, self.pending_txs = (
                    self.pending_txs[:cut],
                    self.pending_txs[cut:],
                )
            else:
                txs = [
                    b"v2tx-%d-%d" % (parent.number + 1, i)
                    for i in range(self.txs_per_block)
                ]
            block = BlockV2(
                parent_hash=parent.hash,
                number=parent.number + 1,
                gas_limit=30_000_000,
                timestamp=parent.timestamp + 1,
                transactions=txs,
                gas_used=21_000 * len(txs),
            )
            block.state_root = hashlib.sha256(
                b"state" + parent.state_root + b"".join(txs)
            ).digest()
            block.receipt_root = hashlib.sha256(
                b"receipts" + block.state_root
            ).digest()
            block.hash = hashlib.sha256(
                block.parent_hash
                + block.number.to_bytes(8, "big")
                + block.state_root
            ).digest()
            return block, False

    def apply_block_v2(self, block) -> None:
        self._ensure_v2_genesis()
        with self._lock:
            head = self.v2_chain[-1]
            if block.parent_hash != head.hash:
                raise ValueError("apply_block_v2: parent mismatch")
            if block.number != head.number + 1:
                raise ValueError("apply_block_v2: height mismatch")
            # Content integrity: the sequencer signature covers only the
            # 32-byte hash, so the execution layer must recompute the hash
            # from the block contents and reject tampering (the real geth
            # re-executes; reference l2node.go:72-76 ApplyBlockV2 via
            # Engine API NewL2Block).
            expect_state = hashlib.sha256(
                b"state" + head.state_root + b"".join(block.transactions)
            ).digest()
            expect_hash = hashlib.sha256(
                block.parent_hash
                + block.number.to_bytes(8, "big")
                + expect_state
            ).digest()
            if block.state_root != expect_state or block.hash != expect_hash:
                raise ValueError("apply_block_v2: content/hash mismatch")
            self.v2_chain.append(block)
            self.v2_by_hash[block.hash] = block

    def get_block_by_number(self, height: int):
        self._ensure_v2_genesis()
        with self._lock:
            if 0 <= height < len(self.v2_chain):
                return self.v2_chain[height]
            return None

    def get_latest_block_v2(self):
        self._ensure_v2_genesis()
        with self._lock:
            return self.v2_chain[-1]
