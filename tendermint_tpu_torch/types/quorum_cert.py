"""QuorumCertificate — one BLS aggregate per commit instead of N sigs.

The paper's defining crypto delta is the BLS12-381 dual-sign plane: every
validator carries a BLS key next to its ed25519 consensus key and
dual-signs batch-point precommits for L1 aggregation. This module points
that plane at the OTHER cost center ("Performance of EdDSA and BLS
Signatures in Committee-Based Consensus", PAPERS.md): a commit ships and
re-verifies N ed25519 signatures in every blocksync/light/replay consumer,
so catchup and light-proof verification scale linearly in committee size.

With `[consensus] quorum_certificates` on, validators additionally
BLS-sign every non-nil precommit over a canonical QC message — one shared
message per (chain, height, round, block_id), unlike the ed25519 sign
bytes whose per-vote timestamp makes every message unique. At +2/3 the
per-vote contributions aggregate (G1 point sum) into a single
`QuorumCertificate`: a 96-byte aggregate signature plus a signer bitset
(`libs/bits.py` word-wise words on the wire). Consumers then verify ONE
aggregate pairing check against the signers' BLS keys (committed in the
validator set via `Validator.bls_pub_key`, so `validators_hash` pins
them) instead of N ed25519 rows — verify cost flat in committee size,
and a light proof collapses from N CommitSigs to ~100 bytes + bitset.

Verification routes through the `qc_verify` engine
(crypto/bls_signatures.verify_qc_items) — registered in both the in-proc
scheduler's wire-engine table and the verify-service's, so aggregate
checks coalesce into shared rounds (and one round's many QCs verify as a
single random-linear-combination multi-pairing) exactly like ed25519
batches.

Reference counterpart: none — the reference ships full commits
everywhere; the QC plane is the aggregate-signature round compression
the committee-crypto papers motivate (ROADMAP item 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..libs import protoio as pio
from ..libs.bits import BitArray
from . import canonical
from .block_id import BlockID

# domain prefix: a QC message can never collide with a batch hash (the
# dual-sign plane's other message family, raw 32-byte hashes) nor with
# the key-validation padding domain inside hash_to_g1
QC_DOMAIN = b"tm-tpu/qc/v1\x00"

# aggregate signature is one uncompressed G1 point
QC_SIG_BYTES = 96


def qc_sign_bytes(
    chain_id: str, height: int, round_: int, block_id: BlockID
) -> bytes:
    """The ONE message every QC contribution at (height, round, block)
    signs: the canonical precommit body WITHOUT the per-signer timestamp
    field, under the QC domain prefix. Same layout source of truth as
    the ed25519 sign bytes (CanonicalVoteEncoder), so the QC commits to
    exactly what the precommit committed to."""
    prefix, suffix = canonical.CanonicalVoteEncoder.vote_parts(
        canonical.PRECOMMIT_TYPE,
        height,
        round_,
        canonical.canonical_block_id(
            block_id.hash,
            block_id.part_set_header.total,
            block_id.part_set_header.hash,
        ),
        chain_id,
    )
    return QC_DOMAIN + prefix + suffix


@dataclass
class QuorumCertificate:
    """Aggregate precommit proof: `signers` indexes into the validator
    set at `height` (the set whose hash the certified header carries),
    `agg_signature` is the G1 sum of their per-vote QC signatures."""

    height: int
    round: int
    block_id: BlockID
    signers: BitArray
    agg_signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return qc_sign_bytes(chain_id, self.height, self.round, self.block_id)

    def num_signers(self) -> int:
        return self.signers.num_set()

    def proof_bytes(self) -> int:
        """Wire size of this proof — the number the light plane's
        compression claim is measured in."""
        return len(self.encode())

    def validate_basic(self) -> None:
        if self.height < 1:
            raise ValueError("qc height must be >= 1")
        if self.round < 0:
            raise ValueError("negative qc round")
        if self.block_id.is_zero():
            raise ValueError("qc cannot certify a nil block")
        if len(self.agg_signature) != QC_SIG_BYTES:
            raise ValueError(
                f"qc aggregate signature must be {QC_SIG_BYTES} bytes"
            )
        if self.signers.size <= 0 or self.signers.num_set() == 0:
            raise ValueError("qc has no signers")

    def encode(self) -> bytes:
        return b"".join(
            [
                pio.field_varint(1, self.height),
                pio.field_varint(2, self.round + 1),
                pio.field_message(3, self.block_id.encode()),
                pio.field_varint(4, self.signers.size),
                pio.field_bytes(5, self.signers.to_bytes()),
                pio.field_bytes(6, self.agg_signature),
            ]
        )

    @classmethod
    def decode(cls, data: bytes) -> "QuorumCertificate":
        f = pio.decode_fields(data)
        size = f.get(4, [0])[0]
        return cls(
            height=f.get(1, [0])[0],
            round=f.get(2, [1])[0] - 1,
            block_id=BlockID.decode(f.get(3, [b""])[0]),
            signers=BitArray.from_bytes(size, f.get(5, [b""])[0]),
            agg_signature=f.get(6, [b""])[0],
        )

    def __repr__(self) -> str:
        return (
            f"QC{{h={self.height}/{self.round} "
            f"signers={self.num_signers()}/{self.signers.size} "
            f"block={self.block_id.hash.hex()[:12]}}}"
        )


# --- assembly from retained CommitSigs -------------------------------------


def assemble_qc(chain_id: str, commit, val_set) -> Optional["QuorumCertificate"]:
    """Build a QuorumCertificate from a full Commit's retained
    CommitSigs (the on-demand path: proposers compress their seen
    commit; a store can compress any retained canonical commit).

    Counts ForBlock rows that carry a `qc_signature` AND whose validator
    has a registered BLS key. The aggregate is verified before it is
    returned — a byzantine validator's garbage contribution (its ed25519
    vote was valid, its QC dual-sign was not) is isolated by the
    random-linear-combination bisect and dropped. Returns None when the
    surviving signers hold <= 2/3 of the set's power: the commit stays
    servable as a full commit, it just cannot compress."""
    from ..crypto import bls_signatures as bls

    n = val_set.size()
    if commit is None or commit.size() != n:
        return None
    msg = qc_sign_bytes(chain_id, commit.height, commit.round, commit.block_id)
    idxs: list[int] = []
    pubs: list = []
    sigs: list = []
    for i, cs in enumerate(commit.signatures):
        if not cs.for_block() or not getattr(cs, "qc_signature", b""):
            continue
        val = val_set.get_by_index(i)
        if val is None or not val.bls_pub_key:
            continue
        try:
            # _qc_signer_key: the verify plane's once-per-distinct-key
            # parse cache — assembly re-runs per height on the proposer
            # and must not re-pay the subgroup check for a static set
            pub = bls.new_trusted_public_key(
                bls._qc_signer_key(val.bls_pub_key)
            )
            sig = bls.g1_from_bytes(cs.qc_signature)
        except bls.BLSError:
            continue  # unparseable contribution: neither list grows
        pubs.append(pub)
        sigs.append(sig)
        idxs.append(i)
    if not idxs:
        return None
    verdicts = bls.verify_batch_same_message(msg, pubs, sigs)
    good = [
        (i, s) for i, s, ok in zip(idxs, sigs, verdicts) if ok
    ]
    if not good:
        return None
    tallied = sum(
        val_set.get_by_index(i).voting_power for i, _ in good
    )
    if tallied <= val_set.total_voting_power() * 2 // 3:
        return None
    agg = bls.aggregate_signatures([s for _, s in good])
    return QuorumCertificate(
        height=commit.height,
        round=commit.round,
        block_id=commit.block_id,
        signers=BitArray.from_indices(n, [i for i, _ in good]),
        agg_signature=bls.g1_to_bytes(agg),
    )


# --- dispatch --------------------------------------------------------------


def qc_verify_items_direct(items: list[tuple]) -> list:
    """Direct (schedulerless) engine call — the fallback every dispatch
    path degrades to."""
    from ..crypto.bls_signatures import verify_qc_items

    return verify_qc_items(items)


def qc_dispatch(klass: str = "blocksync"):
    """items -> verdicts through the process verify scheduler's
    `qc_verify` engine under `klass` priority when one is installed
    (in-proc scheduler or the remote verify-service client — both carry
    the wire-fn surface, so cross-process coalescing is free), else the
    direct check. The returned callable is safe from worker threads; on
    an event-loop thread the scheduler self-degrades to direct."""

    def _verify(items: list[tuple]) -> list:
        from ..parallel.scheduler import default_scheduler

        sched = default_scheduler()
        if sched is None:
            return qc_verify_items_direct(items)
        return sched.submit_wire_fn_sync(
            "qc_verify",
            items,
            klass,
            fallback=lambda: qc_verify_items_direct(items),
        )

    return _verify
