"""Evidence verification rules.

Reference: evidence/verify.go — `verify` (:19, age/time checks + dispatch),
`VerifyDuplicateVote` (:162), `VerifyLightClientAttack` (:113). Signature
checks ride the TPU batch verifier (both conflicting votes in one batch;
the reference verifies them serially one at a time).
"""

from __future__ import annotations

from typing import Optional

from ..crypto.batch_verifier import BatchVerifier, SigItem
from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types.validator_set import ValidatorSet


def _evidence_dispatch(verifier):
    """Default evidence signature checks onto the process dispatch
    scheduler under the evidence class (just below consensus priority —
    conflicting votes are consensus-relevant but must not delay live
    vote rounds)."""
    if verifier is not None:
        return verifier
    from ..parallel.scheduler import default_dispatch

    return default_dispatch("evidence")


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence,
    chain_id: str,
    val_set: ValidatorSet,
    verifier: Optional[BatchVerifier] = None,
) -> None:
    """Raises on invalid evidence (reference VerifyDuplicateVote :162)."""
    idx, val = val_set.get_by_address(ev.vote_a.validator_address)
    if val is None:
        raise ValueError(
            f"address {ev.vote_a.validator_address.hex()} was not a "
            f"validator at height {ev.height()}"
        )
    a, b = ev.vote_a, ev.vote_b
    if (a.height, a.round, a.type) != (b.height, b.round, b.type):
        raise ValueError("h/r/s does not match")
    if a.validator_address != b.validator_address:
        raise ValueError("validator addresses do not match")
    if a.block_id.key() == b.block_id.key():
        raise ValueError("block IDs are the same — not a real duplicate vote")
    if val.pub_key.address() != a.validator_address:
        raise ValueError("address doesn't match pubkey")
    if val.voting_power != ev.validator_power:
        raise ValueError("validator power does not match")
    if val_set.total_voting_power() != ev.total_voting_power:
        raise ValueError("total voting power does not match")

    verifier = _evidence_dispatch(verifier)
    key_type = getattr(val.pub_key, "type_name", "ed25519")
    ok = verifier.verify(
        [
            SigItem(
                val.pub_key.data, a.sign_bytes(chain_id), a.signature,
                key_type=key_type,
            ),
            SigItem(
                val.pub_key.data, b.sign_bytes(chain_id), b.signature,
                key_type=key_type,
            ),
        ]
    )
    if not ok[0]:
        raise ValueError("invalid signature on vote A")
    if not ok[1]:
        raise ValueError("invalid signature on vote B")


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    common_vals: ValidatorSet,
    trusted_header_hash: bytes,
    chain_id: str,
    verifier: Optional[BatchVerifier] = None,
) -> None:
    """Reference VerifyLightClientAttack (:113):
    - >1/3 of the common validator set signed the conflicting block
      (VerifyCommitLightTrusting),
    - 2/3+ of the conflicting set signed it (VerifyCommitLight),
    - the conflicting header hash differs from our trusted one.
    """
    from ..types.block import Commit, Header

    try:
        header = Header.decode(ev.conflicting_header)
        commit = Commit.decode(ev.conflicting_commit)
        conflicting_vals = ValidatorSet.decode(ev.conflicting_validators)
    except Exception as e:
        # decode failures (EOFError from truncated protos, etc.) must surface
        # as invalid-evidence ValueErrors: this path is reachable from a
        # byzantine proposer via block validation and must never crash the
        # consensus step
        raise ValueError(f"malformed light-client-attack evidence: {e}") from e

    # the commit must actually be FOR the conflicting header — otherwise a
    # real commit for the canonical block + a fabricated header would pass
    # (the reference binds them via SignedHeader.ValidateBasic)
    if commit.block_id.hash != header.hash():
        raise ValueError("conflicting commit does not sign the conflicting header")
    if commit.height != header.height:
        raise ValueError("conflicting commit height mismatch")

    if header.hash() == trusted_header_hash:
        raise ValueError("conflicting block matches the trusted header")

    verifier = _evidence_dispatch(verifier)
    common_vals.verify_commit_light_trusting(
        chain_id, commit, 1, 3, verifier=verifier
    )
    conflicting_vals.verify_commit_light(
        chain_id, commit.block_id, header.height, commit, verifier=verifier
    )
