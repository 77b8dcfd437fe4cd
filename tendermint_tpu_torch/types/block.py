"""Block, Header, Commit, CommitSig, Data.

Reference: types/block.go (Block:43, Header:338, CommitSig:623, Commit:657).
Morph-specific capabilities reproduced here:
- `Header.batch_hash` (types/block.go:366) — the L2 batch hash at batch
  points,
- `CommitSig.bls_signature` (types/block.go:628) — BLS12-381 dual signature
  carried in commits,
- `Data.l2_block_meta` / `Data.l2_batch_header` (types/block.go:1037-1038)
  — opaque L2 payloads produced by the execution node and committed with
  the block.

Hashes are RFC 6962 merkle roots of deterministic field encodings
(spec/core/encoding.md shape); this framework defines its own wire, it does
not chase the reference's protobuf bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..crypto import merkle
from ..libs import protoio as pio
from . import canonical
from .block_id import BlockID
from .part_set import PartSet, PartSetHeader
from .quorum_cert import QuorumCertificate

BLOCK_PROTOCOL_VERSION = 11  # reference version/version.go block protocol


class BlockIDFlag:
    ABSENT = 1
    COMMIT = 2
    NIL = 3


# --- header ---------------------------------------------------------------


@dataclass
class Header:
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    batch_hash: bytes = b""  # morph: L2 batch hash (types/block.go:366)
    version_block: int = BLOCK_PROTOCOL_VERSION
    version_app: int = 0
    _hash: Optional[bytes] = field(default=None, compare=False, repr=False)

    def hash(self) -> bytes:
        """Merkle root over the 15 encoded header fields (the reference
        hashes 14, types/block.go:494; batch_hash is the 15th here).
        Cached — the consensus hot path compares header hashes per vote;
        mutators (fill_header, the batch-point edit) must reset `_hash`."""
        if not self.validators_hash:
            return b""
        if self._hash is not None:
            return self._hash
        fields = [
            pio.field_varint(1, self.version_block)
            + pio.field_varint(2, self.version_app),
            self.chain_id.encode(),
            pio.write_varint(self.height),
            canonical.encode_timestamp(self.time_ns),
            self.last_block_id.encode(),
            self.last_commit_hash,
            self.data_hash,
            self.validators_hash,
            self.next_validators_hash,
            self.consensus_hash,
            self.app_hash,
            self.last_results_hash,
            self.evidence_hash,
            self.proposer_address,
            self.batch_hash,
        ]
        self._hash = merkle.hash_from_byte_slices(fields)
        return self._hash

    def validate_basic(self) -> None:
        if not self.chain_id or len(self.chain_id) > 50:
            raise ValueError("bad chain id")
        if self.height < 0:
            raise ValueError("negative height")
        self.last_block_id.validate_basic()
        for name in (
            "last_commit_hash",
            "data_hash",
            "validators_hash",
            "next_validators_hash",
            "consensus_hash",
            "last_results_hash",
            "evidence_hash",
        ):
            v = getattr(self, name)
            if v and len(v) != 32:
                raise ValueError(f"wrong {name} size")
        if self.proposer_address and len(self.proposer_address) != 20:
            raise ValueError("wrong proposer address size")

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_bytes(1, self.chain_id.encode()),
                pio.field_varint(2, self.height),
                pio.field_varint(3, self.time_ns),
                pio.field_message(4, self.last_block_id.encode()),
                pio.field_bytes(5, self.last_commit_hash),
                pio.field_bytes(6, self.data_hash),
                pio.field_bytes(7, self.validators_hash),
                pio.field_bytes(8, self.next_validators_hash),
                pio.field_bytes(9, self.consensus_hash),
                pio.field_bytes(10, self.app_hash),
                pio.field_bytes(11, self.last_results_hash),
                pio.field_bytes(12, self.evidence_hash),
                pio.field_bytes(13, self.proposer_address),
                pio.field_bytes(14, self.batch_hash),
                pio.field_varint(15, self.version_block),
                pio.field_varint(16, self.version_app),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        f = pio.decode_fields(data)

        def g(n, d=b""):
            return f.get(n, [d])[0]

        return cls(
            chain_id=g(1).decode(),
            height=f.get(2, [0])[0],
            time_ns=f.get(3, [0])[0],
            last_block_id=BlockID.decode(g(4)),
            last_commit_hash=g(5),
            data_hash=g(6),
            validators_hash=g(7),
            next_validators_hash=g(8),
            consensus_hash=g(9),
            app_hash=g(10),
            last_results_hash=g(11),
            evidence_hash=g(12),
            proposer_address=g(13),
            batch_hash=g(14),
            version_block=f.get(15, [0])[0],
            version_app=f.get(16, [0])[0],
        )


# --- commit ---------------------------------------------------------------


@dataclass
class CommitSig:
    block_id_flag: int
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""
    bls_signature: bytes = b""  # morph: types/block.go:628
    # QC plane: the per-vote BLS signature over the canonical QC message
    # — retained in the commit so a QuorumCertificate can be assembled
    # on demand from any stored commit (types/quorum_cert.assemble_qc)
    qc_signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(block_id_flag=BlockIDFlag.ABSENT)

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def is_absent(self) -> bool:
        return self.block_id_flag == BlockIDFlag.ABSENT

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BlockIDFlag.ABSENT,
            BlockIDFlag.COMMIT,
            BlockIDFlag.NIL,
        ):
            raise ValueError("unknown block id flag")
        if self.is_absent():
            if self.validator_address or self.signature:
                raise ValueError("absent commit sig with data")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("wrong validator address size")
            if not self.signature or len(self.signature) > 64:
                raise ValueError("bad signature size")

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this signature actually signed over."""
        if self.for_block():
            return commit_block_id
        return BlockID()

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.block_id_flag),
                pio.field_bytes(2, self.validator_address),
                pio.field_message(
                    3, canonical.encode_timestamp(self.timestamp_ns)
                ),
                pio.field_bytes(4, self.signature),
                pio.field_bytes(5, self.bls_signature),
                pio.field_bytes(6, self.qc_signature),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "CommitSig":
        f = pio.decode_fields(data)
        return cls(
            block_id_flag=f.get(1, [0])[0],
            validator_address=f.get(2, [b""])[0],
            timestamp_ns=canonical.decode_timestamp(f.get(3, [b""])[0]),
            signature=f.get(4, [b""])[0],
            bls_signature=f.get(5, [b""])[0],
            qc_signature=f.get(6, [b""])[0],
        )


@dataclass
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: list[CommitSig] = field(default_factory=list)
    _hash: Optional[bytes] = field(default=None, compare=False, repr=False)
    _sb_parts: Optional[dict] = field(default=None, compare=False, repr=False)

    def size(self) -> int:
        return len(self.signatures)

    def _sign_bytes_parts(
        self, chain_id: str, for_block: bool
    ) -> tuple[bytes, bytes]:
        """Cached (prefix, suffix) of the canonical precommit around the
        timestamp field: within one commit every counted signature signs
        the same type/height/round/block_id/chain_id — only field 5 (the
        per-vote timestamp) differs. Batch verification encodes O(vals)
        sign-bytes per commit, and the full encode was the measured host
        bottleneck of the blocksync bulk path (~70 us/sig in r5).

        Like `_hash`, the cache assumes the commit is immutable after
        construction: any mutator of height/round/block_id must reset
        both `_hash` and `_sb_parts` (none exists today)."""
        cache = self._sb_parts
        if cache is None:
            cache = self._sb_parts = {}
        parts = cache.get((chain_id, for_block))
        if parts is None:
            bid = self.block_id if for_block else BlockID()
            parts = canonical.CanonicalVoteEncoder.vote_parts(
                canonical.PRECOMMIT_TYPE,
                self.height,
                self.round,
                canonical.canonical_block_id(
                    bid.hash,
                    bid.part_set_header.total,
                    bid.part_set_header.hash,
                ),
                chain_id,
            )
            cache[(chain_id, for_block)] = parts
        return parts

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Reconstructs the canonical precommit message signer idx signed
        (reference types/block.go Commit.VoteSignBytes) — the per-signer
        message fed to the TPU batch kernel during commit verification.
        Byte-identical to CanonicalVoteEncoder.vote (pinned by
        tests/test_types.py) but assembled from per-commit cached parts."""
        cs = self.signatures[idx]
        prefix, suffix = self._sign_bytes_parts(chain_id, cs.for_block())
        return canonical.CanonicalVoteEncoder.vote_from_parts(
            prefix, suffix, cs.timestamp_ns
        )

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [cs.encode() for cs in self.signatures]
            )
        return self._hash

    def bit_array(self):
        from ..libs.bits import BitArray

        return BitArray.from_bools(
            [not cs.is_absent() for cs in self.signatures]
        )

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_message(3, self.block_id.encode()),
            ]
            + [pio.field_message(4, cs.encode()) for cs in self.signatures]
        )

    @classmethod
    def decode(cls, data: bytes) -> "Commit":
        f = pio.decode_fields(data)
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            block_id=BlockID.decode(f.get(3, [b""])[0]),
            signatures=[CommitSig.decode(d) for d in f.get(4, [])],
        )


# --- data (txs + L2 payloads) ---------------------------------------------


@dataclass(frozen=True)
class L2BlockMeta:
    """Opaque per-block metadata from the L2 execution node
    (reference types/block.go:1037 L2BlockMeta)."""

    raw: bytes = b""


@dataclass(frozen=True)
class L2BatchHeader:
    """Opaque sealed-batch header from the L2 node at batch points
    (reference types/block.go:1038 L2BatchHeader)."""

    raw: bytes = b""


@dataclass
class Data:
    txs: list[bytes] = field(default_factory=list)
    l2_block_meta: bytes = b""
    l2_batch_header: bytes = b""
    _hash: Optional[bytes] = field(default=None, compare=False, repr=False)

    def hash(self) -> bytes:
        # domain-separated leaves: txs are \x00-prefixed, the two L2
        # payload leaves always present with their own prefixes — so no
        # tx list can collide with an L2 payload under the same root
        if self._hash is None:
            leaves = [b"\x00" + tx for tx in self.txs] + [
                b"\x01" + self.l2_block_meta,
                b"\x02" + self.l2_batch_header,
            ]
            self._hash = merkle.hash_from_byte_slices(leaves)
        return self._hash

    def encode(self) -> bytes:
        return (
            b"".join(pio.field_bytes(1, b"\x00" + tx) for tx in self.txs)
            + pio.field_bytes(2, self.l2_block_meta)
            + pio.field_bytes(3, self.l2_batch_header)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Data":
        f = pio.decode_fields(data)
        return cls(
            txs=[t[1:] for t in f.get(1, [])],
            l2_block_meta=f.get(2, [b""])[0],
            l2_batch_header=f.get(3, [b""])[0],
        )


# --- block ----------------------------------------------------------------


@dataclass
class Block:
    header: Header
    data: Data = field(default_factory=Data)
    evidence: list = field(default_factory=list)
    last_commit: Optional[Commit] = None
    # QC plane: the aggregate certificate for last_commit's height,
    # carried NEXT TO the full commit (never instead of it on the block
    # wire — legacy consumers keep verifying the N-sig commit; QC
    # consumers verify one pairing). Not covered by any header hash: a
    # QC is self-certifying against the validator set the certified
    # header commits to.
    last_qc: Optional["QuorumCertificate"] = None
    # memoized (part_size, PartSet): chunking + merkle-proving the
    # encoded block is the priciest host hash on the commit/gossip path
    # and callers re-derive it per call (blocksync window + fallback,
    # block_id()); mutators (fill_header, set_batch_point) invalidate
    _part_set: Optional[tuple[int, PartSet]] = field(
        default=None, compare=False, repr=False
    )

    def hash(self) -> bytes:
        return self.header.hash()

    def is_batch_point(self) -> bool:
        """True if this block seals an L2 batch (reference
        types/block.go IsBatchPoint: non-empty BatchHash)."""
        return bool(self.header.batch_hash)

    def set_batch_point(self, batch_hash: bytes, batch_header: bytes) -> None:
        """Mark this block as a batch point (morph decideBatchPoint):
        mutates header.batch_hash + data.l2_batch_header and keeps the
        hash caches coherent — the only sanctioned post-fill mutation."""
        self.header.batch_hash = batch_hash
        self.data.l2_batch_header = batch_header
        self.data._hash = None
        self.header._hash = None
        self._part_set = None
        self.header.data_hash = self.data.hash()

    def fill_header(self) -> None:
        """Computes the derived header hashes from contents
        (reference Block.fillHeader, types/block.go)."""
        self.header._hash = None
        self._part_set = None
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = merkle.hash_from_byte_slices(
                [ev.encode() for ev in self.evidence]
            )

    def make_part_set(self, part_size: int = 65536) -> PartSet:
        cached = self._part_set
        if cached is not None and cached[0] == part_size:
            return cached[1]
        ps = PartSet.from_data(self.encode(), part_size)
        self._part_set = (part_size, ps)
        return ps

    def block_id(self, part_set: Optional[PartSet] = None) -> BlockID:
        ps = part_set or self.make_part_set()
        return BlockID(hash=self.hash(), part_set_header=ps.header)

    def validate_basic(self) -> None:
        self.header.validate_basic()
        if self.header.height > 1:
            if self.last_commit is None:
                raise ValueError("nil last commit")
            self.last_commit.validate_basic()
        if (
            self.last_commit is not None
            and self.header.last_commit_hash != self.last_commit.hash()
        ):
            raise ValueError("wrong last commit hash")
        if self.last_qc is not None:
            self.last_qc.validate_basic()
            if self.last_qc.height != self.header.height - 1:
                raise ValueError("last qc height mismatch")
            if self.last_qc.block_id != self.header.last_block_id:
                raise ValueError("last qc block id mismatch")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong data hash")

    def encode(self) -> bytes:
        from .evidence import encode_evidence_list

        return b"".join(
            [
                pio.field_message(1, self.header.encode()),
                pio.field_message(2, self.data.encode()),
                pio.field_message(3, encode_evidence_list(self.evidence)),
                (
                    pio.field_message(4, self.last_commit.encode())
                    if self.last_commit is not None
                    else b""
                ),
                (
                    pio.field_message(5, self.last_qc.encode())
                    if self.last_qc is not None
                    else b""
                ),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        from .evidence import decode_evidence_list

        f = pio.decode_fields(data)
        last_commit = None
        if 4 in f:
            last_commit = Commit.decode(f[4][0])
        last_qc = None
        if 5 in f:
            last_qc = QuorumCertificate.decode(f[5][0])
        return cls(
            header=Header.decode(f[1][0]),
            data=Data.decode(f.get(2, [b""])[0]),
            evidence=decode_evidence_list(f.get(3, [b""])[0]),
            last_commit=last_commit,
            last_qc=last_qc,
        )

    def __repr__(self) -> str:
        return (
            f"Block{{h={self.header.height} "
            f"hash={self.hash().hex()[:12]} txs={len(self.data.txs)}}}"
        )
