"""EvidencePool — pending/committed evidence over a KV store.

Reference: evidence/pool.go. Lifecycle: AddEvidence (verify + persist
pending, :134) → PendingEvidence (proposal inclusion, :87) → Update on
commit (mark committed + expire old, :105) → gossiped by the reactor via
the pending list. ReportConflictingVotes (:179) receives equivocations
straight from the consensus vote path through a buffer that is drained on
the next Update (processConsensusBuffer :459) so evidence construction
uses the post-commit state.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..libs.log import Logger, nop_logger
from ..libs.metrics import EvidenceMetrics, default_metrics
from ..obs import default_tracer
from ..state.state import State
from ..types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
    decode_evidence,
)
from ..types.vote import Vote
from .verify import verify_duplicate_vote, verify_light_client_attack

_PENDING = b"\x00"
_COMMITTED = b"\x01"


class BenignEvidenceError(ValueError):
    """Evidence we cannot judge or no longer care about — NOT an attack.

    Raised when verification fails for reasons local to this node (missing
    historical data because we are behind or pruned, or the evidence aged
    out between the sender's sweep and ours). The reactor must not punish
    peers for these (reference evidence/reactor.go only disconnects on
    ErrInvalidEvidence)."""


def _key(prefix: bytes, height: int, ev_hash: bytes) -> bytes:
    return prefix + height.to_bytes(8, "big") + ev_hash


class EvidencePool:
    def __init__(
        self,
        kv,
        state_store,
        block_store,
        verifier=None,
        logger: Optional[Logger] = None,
    ):
        self._kv = kv
        self._state_store = state_store
        self._block_store = block_store
        self._verifier = verifier
        self.logger = logger or nop_logger()
        self._lock = threading.Lock()
        self._state: Optional[State] = state_store.load()
        # (voteA, voteB) equivocations reported by consensus, drained on
        # the next Update (reference consensusBuffer, pool.go:459-541)
        self._consensus_buffer: list[tuple[Vote, Vote]] = []
        # in-order pending cache for gossip/proposal (reference clist)
        self._pending: dict[bytes, object] = {}
        self.metrics = default_metrics(EvidenceMetrics)
        self._load_pending()
        self.metrics.pool_size.set(len(self._pending))

    # --- queries ------------------------------------------------------------

    def pending_evidence(self, max_bytes: int = 1 << 20) -> list:
        """Evidence for proposal inclusion, size-capped (reference :87)."""
        out, total = [], 0
        with self._lock:
            for ev in self._pending.values():
                sz = len(ev.encode())
                if total + sz > max_bytes:
                    break
                out.append(ev)
                total += sz
        return out

    def size(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def state(self) -> Optional[State]:
        return self._state

    # --- ingestion ----------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """Verify + persist pending evidence (reference AddEvidence :134).
        Idempotent: pending/committed duplicates are no-ops."""
        with self._lock:
            if ev.hash() in self._pending:
                return
            if self._is_committed(ev):
                return
        ev.validate_basic()
        self.verify(ev)
        self._add_pending(ev)
        self.logger.info("verified new evidence", height=ev.height())

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """Equivocation from the consensus vote path (reference :179)."""
        with self._lock:
            self._consensus_buffer.append((vote_a, vote_b))

    def check_evidence(self, ev, state: Optional[State] = None) -> None:
        """Validate committed-block evidence (reference CheckEvidence :192):
        already-pending evidence is known-good; otherwise verify now —
        against the caller's state when given (block validation/replay must
        judge age relative to the block being validated, not the pool's
        possibly-newer head)."""
        with self._lock:
            if ev.hash() in self._pending:
                return
            if self._is_committed(ev):
                raise ValueError("evidence was already committed")
        ev.validate_basic()
        self.verify(ev, state=state)

    # --- verification (reference verify.go:19-117) ---------------------------

    def verify(self, ev, state: Optional[State] = None) -> None:
        state = state if state is not None else self._state
        if state is None:
            raise ValueError("evidence pool has no state")
        height = state.last_block_height
        params = state.consensus_params.evidence
        age_blocks = height - ev.height()

        meta = self._block_store.load_block_meta(ev.height())
        if meta is None:
            raise BenignEvidenceError(f"don't have header #{ev.height()}")
        ev_time = meta.header.time_ns
        if ev.timestamp_ns != ev_time:
            raise ValueError(
                "evidence time differs from the block it is associated with"
            )
        age_ns = state.last_block_time_ns - ev_time
        if (
            age_ns > params.max_age_duration_ns
            and age_blocks > params.max_age_num_blocks
        ):
            raise BenignEvidenceError(f"evidence from height {ev.height()} is too old")

        if isinstance(ev, DuplicateVoteEvidence):
            vals = self._state_store.load_validators(ev.height())
            if vals is None:
                raise BenignEvidenceError(f"no validator set at height {ev.height()}")
            verify_duplicate_vote(
                ev, state.chain_id, vals, verifier=self._verifier
            )
        elif isinstance(ev, LightClientAttackEvidence):
            common_vals = self._state_store.load_validators(ev.height())
            if common_vals is None:
                raise BenignEvidenceError(f"no validator set at height {ev.height()}")
            # the trusted header to differ from is the one at the
            # CONFLICTING block's height (lunatic attacks have
            # common_height < conflicting height; reference verify.go:60-90)
            from ..types.block import Header

            try:
                conflict_header = Header.decode(ev.conflicting_header)
            except Exception as e:
                raise ValueError(
                    f"malformed light-client-attack evidence: {e}"
                ) from e
            conflict_h = conflict_header.height
            trusted = (
                meta
                if conflict_h == ev.height()
                else self._block_store.load_block_meta(conflict_h)
            )
            if trusted is None:
                # forward lunatic attack: the forged header sits above our
                # head (or at a pruned height) — judge against our latest
                # header instead (reference verify.go:76-90)
                latest_h = self._block_store.height()
                trusted = self._block_store.load_block_meta(latest_h)
                if trusted is None:
                    raise BenignEvidenceError(f"don't have header #{conflict_h}")
                if trusted.header.time_ns < conflict_header.time_ns:
                    raise ValueError(
                        "latest block time is before conflicting block time"
                    )
            verify_light_client_attack(
                ev,
                common_vals,
                trusted.block_id.hash,
                state.chain_id,
                verifier=self._verifier,
            )
        else:
            raise ValueError(f"unrecognized evidence type {type(ev)}")

    # --- commit-time update (reference Update :105) --------------------------

    def update(self, state: State, committed_evidence: list) -> None:
        self._state = state
        self._mark_committed(committed_evidence)
        self._process_consensus_buffer(state)
        self._remove_expired(state)

    def _process_consensus_buffer(self, state: State) -> None:
        with self._lock:
            buf, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buf:
            vals = self._state_store.load_validators(vote_a.height)
            meta = self._block_store.load_block_meta(vote_a.height)
            if vals is None or meta is None:
                self.logger.error(
                    "dropping equivocation: missing historical data",
                    height=vote_a.height,
                )
                continue
            _, val = vals.get_by_address(vote_a.validator_address)
            if val is None:
                continue
            ev = DuplicateVoteEvidence.from_votes(
                vote_a,
                vote_b,
                vals.total_voting_power(),
                val.voting_power,
                meta.header.time_ns,
            )
            try:
                self.add_evidence(ev)
            except ValueError as e:
                self.logger.error("dropping equivocation", err=str(e))

    # --- storage ------------------------------------------------------------

    def _add_pending(self, ev) -> None:
        with self._lock:
            self._kv.set(_key(_PENDING, ev.height(), ev.hash()), ev.encode())
            self._pending[ev.hash()] = ev
            self.metrics.pool_added.inc()
            self.metrics.pool_size.set(len(self._pending))
        default_tracer().event(
            "evidence.added", height=ev.height(), type=type(ev).__name__
        )

    def _mark_committed(self, evs: list) -> None:
        with self._lock:
            for ev in evs:
                self._kv.set(_key(_COMMITTED, ev.height(), ev.hash()), b"\x01")
                self._kv.delete(_key(_PENDING, ev.height(), ev.hash()))
                self._pending.pop(ev.hash(), None)
            if evs:
                self.metrics.pool_committed.inc(len(evs))
            self.metrics.pool_size.set(len(self._pending))

    def _is_committed(self, ev) -> bool:
        return self._kv.get(_key(_COMMITTED, ev.height(), ev.hash())) is not None

    def _remove_expired(self, state: State) -> None:
        params = state.consensus_params.evidence
        with self._lock:
            for h, ev in list(self._pending.items()):
                age_blocks = state.last_block_height - ev.height()
                age_ns = state.last_block_time_ns - ev.timestamp_ns
                if (
                    age_ns > params.max_age_duration_ns
                    and age_blocks > params.max_age_num_blocks
                ):
                    self._kv.delete(_key(_PENDING, ev.height(), ev.hash()))
                    del self._pending[h]
            self.metrics.pool_size.set(len(self._pending))

    def _load_pending(self) -> None:
        for k, v in self._kv.iterate(_PENDING, _COMMITTED):
            ev = decode_evidence(v)
            self._pending[ev.hash()] = ev
