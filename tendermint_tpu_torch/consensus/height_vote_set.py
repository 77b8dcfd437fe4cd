"""HeightVoteSet — all VoteSets (prevote+precommit per round) of one height.

Reference: consensus/types/height_vote_set.go: lazily creates round vote
sets; tracks which rounds a peer has claimed catch-up majorities for
(SetPeerMaj23); surfaces equivocation as ErrVoteConflictingVotes.

This is also the quorum-latency attribution seam (obs/cluster.py): every
ACCEPTED vote records its arrival lag behind the round's first vote of
the same type, and the vote that flips a VoteSet to 2/3 records a
`quorum.close` event naming the closing validator — the single number
that says which straggler the committee was waiting on.
"""

from __future__ import annotations

import time
from typing import Optional

from ..libs.metrics import bounded_label
from ..obs import default_tracer
from ..types.validator_set import ValidatorSet
from ..types.vote import VOTE_TYPE_NAMES, Vote, VoteType
from ..types.vote_set import ConflictingVoteError, VoteSet


class HeightVoteSet:
    MAX_CATCHUP_ROUNDS = 2  # peer-triggered rounds beyond current

    def __init__(
        self,
        chain_id: str,
        height: int,
        val_set: ValidatorSet,
        tracer=None,
        metrics=None,
        pacing=None,
        health=None,
    ):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self.tracer = default_tracer() if tracer is None else tracer
        self.metrics = metrics
        # consensus/pacing.PacingController: arrival lags feed it
        # SYNCHRONOUSLY on the accept path (not via metrics scrape) so
        # the adaptive timeout controllers see every sample even with
        # metrics/tracing off
        self.pacing = pacing
        # obs/health.HealthMonitor: the quorum-lag anomaly detector
        # rides the same synchronous accept-path feed as pacing
        self.health = health
        self._rounds: dict[int, dict[int, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        # (round, type) -> perf_counter of the first accepted vote; lag
        # attribution is relative to this
        self._first_arrival: dict[tuple[int, int], float] = {}
        # (round, type) -> perf_counter of the 2/3-closing vote; votes
        # accepted after this are the stragglers timeout_commit covers
        self._quorum_closed_at: dict[tuple[int, int], float] = {}
        self.set_round(0)

    def set_round(self, round_: int) -> None:
        """Ensure vote sets exist up to round_ + 1 (reference SetRound)."""
        for r in range(self.round, round_ + 2):
            self._ensure_round(r)
        self.round = round_

    def _ensure_round(self, round_: int) -> None:
        if round_ in self._rounds:
            return
        self._rounds[round_] = {
            VoteType.PREVOTE: VoteSet(
                self.chain_id, self.height, round_, VoteType.PREVOTE, self.val_set
            ),
            VoteType.PRECOMMIT: VoteSet(
                self.chain_id,
                self.height,
                round_,
                VoteType.PRECOMMIT,
                self.val_set,
            ),
        }

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._rounds.get(round_, {}).get(VoteType.PREVOTE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._rounds.get(round_, {}).get(VoteType.PRECOMMIT)

    def add_vote(
        self, vote: Vote, peer_id: str = "", verified: bool = False
    ) -> bool:
        """Returns True if added. A round beyond current+1 is GRANTED on
        first vote arrival, up to MAX_CATCHUP_ROUNDS per peer (reference
        height_vote_set.go addVote: peerCatchupRounds — this is how a
        restarted node at round 0 accepts the commit's round-2 precommits
        during gossip catchup; requiring a prior maj23 claim here deadlocks
        exactly that recovery path)."""
        if vote.round > self.round + 1:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if vote.round not in rounds:
                if len(rounds) >= self.MAX_CATCHUP_ROUNDS:
                    raise ValueError(
                        "peer sent votes for too many catchup rounds"
                    )
                rounds.append(vote.round)
        self._ensure_round(vote.round)
        vs = self._rounds[vote.round][vote.type]
        had_quorum = vs.has_two_thirds_majority()
        added = vs.add_vote(vote, verified=verified)
        if added:
            self._attribute_arrival(vote, vs, had_quorum, peer_id)
        return added

    # --- quorum-latency attribution --------------------------------------

    def _attribute_arrival(
        self, vote: Vote, vs: VoteSet, had_quorum: bool, peer_id: str
    ) -> None:
        """Record arrival lag for an accepted vote and, when it flipped
        the set to 2/3, the quorum-close attribution. Pacing samples are
        fed regardless of metrics/tracer state — the controllers are a
        control loop, not telemetry."""
        tracer = self.tracer
        metrics = self.metrics
        pacing = self.pacing
        health = self.health
        if (
            pacing is None
            and health is None
            and metrics is None
            and not tracer.enabled
        ):
            return
        now = time.perf_counter()
        key = (vote.round, vote.type)
        first = self._first_arrival.setdefault(key, now)
        lag = now - first
        tname = VOTE_TYPE_NAMES.get(vote.type, str(vote.type))
        if pacing is not None:
            if had_quorum:
                closed_at = self._quorum_closed_at.get(key)
                if closed_at is not None:
                    pacing.observe_post_quorum_straggler(
                        vote.type, now - closed_at
                    )
            else:
                pacing.observe_vote_arrival(vote.type, lag)
        if health is not None and not had_quorum:
            health.observe_vote_arrival(vote.type, lag)
        if metrics is not None:
            metrics.vote_arrival_lag.observe(lag, type=tname)
        if tracer.enabled:
            tracer.event(
                "quorum.vote",
                height=vote.height,
                round=vote.round,
                type=tname,
                val=vote.validator_index,
                peer=peer_id,
                lag_ms=round(lag * 1e3, 3),
            )
        if had_quorum or not vs.has_two_thirds_majority():
            return
        # this vote closed the 2/3 quorum
        self._quorum_closed_at[key] = now
        if metrics is not None:
            metrics.quorum_close_lag.observe(lag, type=tname)
            metrics.quorum_closer.inc(
                validator=bounded_label(
                    "quorum_closer", str(vote.validator_index), 64
                ),
                type=tname,
            )
        if tracer.enabled:
            tracer.event(
                "quorum.close",
                height=vote.height,
                round=vote.round,
                type=tname,
                closer=vote.validator_index,
                peer=peer_id,
                lag_ms=round(lag * 1e3, 3),
            )

    def quorum_closed_at(
        self, round_: int, vote_type: int
    ) -> Optional[float]:
        """perf_counter of the vote that closed this set's 2/3, or None.
        The state machine stashes the commit round's value across the
        height transition so straggler precommits arriving into
        LastCommit still feed the pacing controller's commit sketch."""
        return self._quorum_closed_at.get((round_, vote_type))

    def set_peer_maj23(
        self, round_: int, vote_type: int, peer_id: str, block_id
    ) -> None:
        self._ensure_round(round_)
        rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
        if round_ not in rounds:
            if len(rounds) >= self.MAX_CATCHUP_ROUNDS:
                raise ValueError("peer has too many catchup rounds")
            rounds.append(round_)
        self._rounds[round_][vote_type].set_peer_maj23(peer_id, block_id)

    def pol_info(self) -> tuple[int, object]:
        """(round, blockID) of the most recent prevote polka, or (-1, None)
        (reference POLInfo)."""
        for r in range(self.round, -1, -1):
            pv = self.prevotes(r)
            if pv is not None:
                bid, ok = pv.two_thirds_majority()
                if ok:
                    return r, bid
        return -1, None
