"""Stateless light verification.

Reference: light/verifier.go — VerifyAdjacent :93 (hash-chain via
NextValidatorsHash :117) and VerifyNonAdjacent :32 (≥1/3 trusted overlap
via VerifyCommitLightTrusting :58, then 2/3 of the new set :73). Both
commit verifications run as single TPU batches (types/validator_set.py).
"""

from __future__ import annotations

from ..types.block_id import BlockID
from .types import LightBlock

DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * 1_000_000_000


def _light_dispatch(verifier):
    """Default the commit verifies onto the process dispatch scheduler
    under the light class: bisection batches then coalesce with (and
    yield priority to) consensus/blocksync work instead of owning a
    private path to the device."""
    if verifier is not None:
        return verifier
    from ..parallel.scheduler import default_dispatch

    return default_dispatch("light")


def _qc_usable(lb: LightBlock) -> bool:
    """A light block proves itself by QC when it carries one and its
    (hash-pinned) validator set carries the BLS keys — the one-pairing
    path, flat in committee size. Full-commit blocks (or blocks whose
    set predates the QC plane) take the N-row batch path."""
    return lb.qc is not None and lb.validators.qc_capable()


def _light_qc_engine():
    from ..types.quorum_cert import qc_dispatch

    return qc_dispatch("light")


class VerificationError(Exception):
    pass


class ErrNewHeaderTooFarAhead(VerificationError):
    """Non-adjacent verify failed the trust threshold — bisect."""


def _common_checks(
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    if untrusted.header.chain_id != trusted.header.chain_id:
        raise VerificationError("chain id mismatch")
    if untrusted.height <= trusted.height:
        raise VerificationError("new header height must increase")
    if trusted.header.time_ns + trusting_period_ns < now_ns:
        raise VerificationError("trusted header expired (outside trusting period)")
    if untrusted.header.time_ns <= trusted.header.time_ns:
        raise VerificationError("new header time must be after trusted header")
    if untrusted.header.time_ns > now_ns + max_clock_drift_ns:
        raise VerificationError("new header is from the future")


def verify_adjacent(
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    verifier=None,
) -> None:
    """untrusted.height == trusted.height + 1 (reference :93)."""
    if untrusted.height != trusted.height + 1:
        raise VerificationError("headers must be adjacent")
    _common_checks(trusted, untrusted, trusting_period_ns, now_ns, max_clock_drift_ns)
    # the hash chain pins the next validator set (reference :117)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise VerificationError(
            "untrusted validators hash != trusted next validators hash"
        )
    untrusted.validate_basic(trusted.header.chain_id)
    _verify_commit_full_power(untrusted, verifier=verifier)


def verify_non_adjacent(
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int,
    trust_numerator: int = 1,
    trust_denominator: int = 3,
    max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    verifier=None,
) -> None:
    """Skipping verification (reference :32): enough of the OLD set still
    signs the new header, and the new set has 2/3 on it."""
    if untrusted.height == trusted.height + 1:
        return verify_adjacent(
            trusted, untrusted, trusting_period_ns, now_ns,
            max_clock_drift_ns, verifier=verifier,
        )
    _common_checks(trusted, untrusted, trusting_period_ns, now_ns, max_clock_drift_ns)
    untrusted.validate_basic(trusted.header.chain_id)
    if _qc_usable(untrusted):
        # ONE aggregate check proves BOTH halves of skipping
        # verification: _qc_item tallies >2/3 of the NEW set's power
        # in the signer bitset (the _verify_commit_full_power half)
        # before the pairing check, and the address-overlap tally
        # proves the >1/3 trusted half by set algebra — so the full-
        # power pass below is skipped, never paid twice.
        try:
            trusted.validators.verify_commit_qc_trusting(
                trusted.header.chain_id,
                untrusted.qc,
                untrusted.validators,
                trust_numerator,
                trust_denominator,
                engine=_light_qc_engine(),
            )
        except ValueError as e:
            # only a thin trusted OVERLAP means "bisect" — a bad
            # aggregate / sub-quorum certificate is a verification
            # failure, not a too-far-ahead signal
            if "trusted voting power" in str(e):
                raise ErrNewHeaderTooFarAhead(str(e)) from e
            raise VerificationError(f"invalid commit: {e}") from e
        return
    try:
        if untrusted.commit is None:
            raise ValueError("no commit and no usable qc")
        trusted.validators.verify_commit_light_trusting(
            trusted.header.chain_id,
            untrusted.commit,
            trust_numerator,
            trust_denominator,
            verifier=_light_dispatch(verifier),
        )
    except ValueError as e:
        raise ErrNewHeaderTooFarAhead(str(e)) from e
    _verify_commit_full_power(untrusted, verifier=verifier)


def _verify_commit_full_power(lb: LightBlock, verifier=None) -> None:
    try:
        if _qc_usable(lb):
            lb.validators.verify_commit_qc(
                lb.header.chain_id,
                lb.qc.block_id,
                lb.height,
                lb.qc,
                engine=_light_qc_engine(),
            )
            if lb.qc.block_id.hash != lb.header.hash():
                raise ValueError("qc is not for this header")
            return
        if lb.commit is None:
            raise ValueError("no commit and no usable qc")
        lb.validators.verify_commit_light(
            lb.header.chain_id,
            BlockID(lb.header.hash(), lb.commit.block_id.part_set_header),
            lb.height,
            lb.commit,
            verifier=_light_dispatch(verifier),
        )
    except ValueError as e:
        raise VerificationError(f"invalid commit: {e}") from e


def verify(
    trusted: LightBlock,
    untrusted: LightBlock,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    verifier=None,
) -> None:
    """Dispatch (reference Verify :135)."""
    if untrusted.height == trusted.height + 1:
        verify_adjacent(
            trusted, untrusted, trusting_period_ns, now_ns,
            max_clock_drift_ns, verifier=verifier,
        )
    else:
        verify_non_adjacent(
            trusted,
            untrusted,
            trusting_period_ns,
            now_ns,
            max_clock_drift_ns=max_clock_drift_ns,
            verifier=verifier,
        )
