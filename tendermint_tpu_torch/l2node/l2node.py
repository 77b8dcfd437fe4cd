"""The L2Node port — consensus's window into the execution node.

Reference: l2node/l2node.go:13-84 (L2Node: RequestBlockData /
CheckBlockData / DeliverBlock / EncodeTxs / VerifySignature /
RequestHeight) + the Batcher surface :87-117 (CalculateCap / SealBatch /
CommitBatch / PackCurrentBlock / AppendBlsData / BatchHash) + BlsData :130.

The consensus engine is execution-agnostic: everything L2-specific
(tx pooling, batch economics, BLS key mapping) lives behind this port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable


@dataclass
class BlockData:
    """What the L2 node hands the proposer for one block
    (reference RequestBlockData returns txs + l2 metadata)."""

    txs: list[bytes] = field(default_factory=list)
    l2_block_meta: bytes = b""
    # set by consensus at batch points after SealBatch:
    l2_batch_header: bytes = b""


@dataclass
class BlsData:
    """One validator's BLS contribution at a batch point
    (reference l2node/l2node.go:130)."""

    signer: bytes  # tendermint validator address
    signature: bytes  # BLS12-381 signature over the batch hash


@runtime_checkable
class L2Node(Protocol):
    # --- block production / validation -----------------------------------

    def request_block_data(self, height: int) -> BlockData:
        """Pull txs + metadata for the next proposal
        (reference l2node.go:29-36)."""
        ...

    def check_block_data(self, txs: list[bytes], l2_block_meta: bytes) -> bool:
        """Validate a proposed block's L2 payload (prevote gate)."""
        ...

    def deliver_block(
        self, height: int, block_hash: bytes, txs: list[bytes], l2_block_meta: bytes
    ) -> tuple[list, Optional[dict]]:
        """Execute the decided block on the L2 node. Returns
        (validator_updates, consensus_param_updates) — the L2 node drives
        the validator set in the morph fork
        (reference state/execution.go:309-360 GetValidatorUpdates)."""
        ...

    def encode_txs(self, txs: list[bytes]) -> bytes: ...

    def request_height(self, tm_height: int) -> int:
        """Map a tendermint height to the L2 chain height."""
        ...

    # --- BLS dual-signing -------------------------------------------------

    def verify_signature(
        self, tm_pubkey: bytes, message_hash: bytes, signature: bytes
    ) -> "bool | None":
        """Verify a validator's BLS signature over a batch hash
        (reference l2node.go VerifySignature; called per precommit in
        consensus/state.go:2362-2379).

        Tri-state verdict: True/False are definitive cryptographic
        verdicts; None means the verifier could not decide (tm key not
        yet in the BLS registry, L2 unreachable). Callers reject the
        vote on None (falsy) but must not punish the relaying peer —
        only False justifies a disconnect."""
        ...

    def verify_signatures(
        self, tm_pubkeys: list[bytes], message_hash: bytes,
        signatures: list[bytes],
    ) -> "list[bool | None]":
        """Batched form of verify_signature over ONE message: per-index
        verdicts. TPU-framework extension of the reference port (which
        only verifies serially, l2node.go VerifySignature): the consensus
        round produces a burst of signatures over the same batch hash, and
        an implementation can verify the burst as a random-linear-
        combination aggregate in 2 pairings (crypto/bls_signatures.
        verify_batch_same_message) instead of 2 per vote."""
        ...

    def append_bls_data(self, height: int, batch_hash: bytes, data: BlsData) -> None:
        """Hand an aggregatable BLS signature to the L2 node for L1
        submission (reference AppendBlsData)."""
        ...

    # --- batching ---------------------------------------------------------

    def calculate_batch_size_with_proposal_block(
        self, proposal_block_bytes: bytes, get_from_cache: bool
    ) -> bool:
        """True if adding this block would exceed batch capacity — i.e.
        this block is a batch point (reference CalculateCapWithProposalBlock,
        consensus/state.go:1318 decideBatchPoint)."""
        ...

    def seal_batch(self) -> tuple[bytes, bytes]:
        """Seal the current batch: returns (batch_hash, batch_header)."""
        ...

    def commit_batch(
        self, current_block_bytes: bytes, bls_datas: list[BlsData]
    ) -> None:
        """Commit the sealed batch (+ the block that sealed it) with the
        aggregated BLS data (reference CommitBatch; called from
        state/execution.go:390-429 ExecBlockOnL2Node)."""
        ...

    def pack_current_block(self, current_block_bytes: bytes) -> None:
        """Append a non-batch-point block to the open batch
        (reference PackCurrentBlock)."""
        ...

    def batch_hash(self, batch_header: bytes) -> bytes:
        """Recompute a batch hash from its header (blocksync replay check,
        reference blocksync/reactor.go:558-600)."""
        ...

    # --- V2 methods for sequencer mode (reference l2node.go:65-84) --------

    def request_block_data_v2(self, parent_hash: bytes):
        """Assemble the next BlockV2 on top of `parent_hash` via the
        engine API. Returns (BlockV2, collected_l1_msgs: bool)."""
        ...

    def apply_block_v2(self, block) -> None:
        """Apply a BlockV2 to the L2 execution layer (NewL2Block)."""
        ...

    def get_block_by_number(self, height: int):
        """BlockV2 by number, or None (eth_getBlockByNumber)."""
        ...

    def get_latest_block_v2(self):
        """The latest BlockV2 (eth_blockNumber + eth_getBlockByNumber)."""
        ...
