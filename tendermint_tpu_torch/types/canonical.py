"""Canonical sign-bytes for votes and proposals.

Reference: types/canonical.go:18,57 + types/vote.go:95-103 — sign-bytes are
`protoio.MarshalDelimited(CanonicalVote{...})` where CanonicalVote uses
sfixed64 height/round (fixed-width so signing devices can parse offsets) and
a trailing chain_id. The per-vote timestamp makes every vote's message
unique — which is why the TPU verifier takes ragged per-vote messages
(SURVEY.md §7.3 hard part 4).

Timestamps are integer nanoseconds since the Unix epoch throughout the
framework; they encode here as protobuf Timestamp (seconds + nanos).
"""

from __future__ import annotations

from ..libs import protoio as pio

# SignedMsgType values (reference types/signed_msg_type.go)
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


def encode_timestamp(ns: int) -> bytes:
    seconds, nanos = divmod(ns, 1_000_000_000)
    return pio.field_varint(1, seconds) + pio.field_varint(2, nanos)


def decode_timestamp(data: bytes) -> int:
    fields = pio.decode_fields(data)
    seconds = fields.get(1, [0])[0]
    nanos = fields.get(2, [0])[0]
    return seconds * 1_000_000_000 + nanos


def _canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    return pio.field_varint(1, total) + pio.field_bytes(2, hash_)


def canonical_block_id(hash_: bytes, psh_total: int, psh_hash: bytes) -> bytes:
    """CanonicalBlockID; empty when the block id is nil (returns b'')."""
    if not hash_ and psh_total == 0 and not psh_hash:
        return b""
    return pio.field_bytes(1, hash_) + pio.field_message(
        2, _canonical_part_set_header(psh_total, psh_hash)
    )


class CanonicalVoteEncoder:
    """Stateless canonical encoders, exposed for privval/remote-signer
    compatibility checks."""

    @staticmethod
    def vote_parts(
        msg_type: int,
        height: int,
        round_: int,
        block_id_bytes: bytes,
        chain_id: str,
    ) -> tuple[bytes, bytes]:
        """(prefix, suffix) of the canonical vote body around its only
        per-signer field — the timestamp (field 5):
        vote(...) == marshal_delimited(prefix + field_message(5,
        encode_timestamp(ts)) + suffix). Exposed so batch commit
        verification can encode O(validators) sign-bytes per commit
        without re-encoding the shared fields (types/block.py caches
        these parts per commit); `vote` below composes the same parts,
        keeping one source of truth for the layout."""
        prefix = b"".join(
            [
                pio.field_varint(1, msg_type),
                pio.field_sfixed64(2, height),
                pio.field_sfixed64(3, round_),
                (
                    pio.field_message(4, block_id_bytes)
                    if block_id_bytes
                    else b""
                ),
            ]
        )
        return prefix, pio.field_bytes(6, chain_id.encode())

    @staticmethod
    def vote_from_parts(
        prefix: bytes, suffix: bytes, timestamp_ns: int
    ) -> bytes:
        """Assemble the final sign-bytes from vote_parts output — the
        ONLY place the timestamp field number and the delimited framing
        live, so cached-parts callers cannot drift from `vote`."""
        return pio.marshal_delimited(
            prefix
            + pio.field_message(5, encode_timestamp(timestamp_ns))
            + suffix
        )

    @staticmethod
    def vote(
        msg_type: int,
        height: int,
        round_: int,
        block_id_bytes: bytes,
        timestamp_ns: int,
        chain_id: str,
    ) -> bytes:
        prefix, suffix = CanonicalVoteEncoder.vote_parts(
            msg_type, height, round_, block_id_bytes, chain_id
        )
        return CanonicalVoteEncoder.vote_from_parts(
            prefix, suffix, timestamp_ns
        )

    @staticmethod
    def proposal(
        height: int,
        round_: int,
        pol_round: int,
        block_id_bytes: bytes,
        timestamp_ns: int,
        chain_id: str,
    ) -> bytes:
        body = b"".join(
            [
                pio.field_varint(1, PROPOSAL_TYPE),
                pio.field_sfixed64(2, height),
                pio.field_sfixed64(3, round_),
                pio.field_sfixed64(4, pol_round),
                (
                    pio.field_message(5, block_id_bytes)
                    if block_id_bytes
                    else b""
                ),
                pio.field_message(6, encode_timestamp(timestamp_ns)),
                pio.field_bytes(7, chain_id.encode()),
            ]
        )
        return pio.marshal_delimited(body)


def vote_sign_bytes(chain_id: str, vote) -> bytes:
    """The message the TPU verifier checks per vote
    (reference types/vote.go:95 VoteSignBytes)."""
    bid = vote.block_id
    return CanonicalVoteEncoder.vote(
        vote.type,
        vote.height,
        vote.round,
        canonical_block_id(
            bid.hash, bid.part_set_header.total, bid.part_set_header.hash
        ),
        vote.timestamp_ns,
        chain_id,
    )


def proposal_sign_bytes(chain_id: str, proposal) -> bytes:
    bid = proposal.block_id
    return CanonicalVoteEncoder.proposal(
        proposal.height,
        proposal.round,
        proposal.pol_round,
        canonical_block_id(
            bid.hash, bid.part_set_header.total, bid.part_set_header.hash
        ),
        proposal.timestamp_ns,
        chain_id,
    )
