"""Adaptive trace-driven consensus pacing — close the loop from the
quorum-lag sensors to the timeout controllers.

PERF_ANALYSIS §12: the pipelined commit path cut the finalize critical
path to ~2 ms/height, yet wall-per-height sits an order of magnitude
above it because the static `timeout_commit`/`timeout_propose` floors —
not compute — dominate. The cluster tracer already measures
exactly the thing a static floor is a worst-case guess for: the live
per-validator vote-arrival and quorum-close lag distributions.
"Performance of EdDSA and BLS Signatures in Committee-Based Consensus"
(PAPERS.md) models committee latency as an arrival-tail distribution;
this module makes the timeouts COVER that measured tail instead of a
configured ceiling.

One `_StepController` per step kind learns the arrival tail from a
streaming quantile sketch (obs/quantile.py, fed synchronously from
HeightVoteSet and the state machine):

- `propose`   <- proposal-complete delay behind propose-step entry
                 (non-proposer heights only; our own proposal is local)
- `prevote`   <- prevote arrival lag behind the round's first prevote
- `precommit` <- precommit arrival lag behind the round's first precommit
- `commit`    <- post-quorum straggler lag: precommits arriving AFTER
                 the 2/3-closing vote (what timeout_commit exists for)

The effective timeout interpolates between the learned tail and the
static config value with an AIMD back-off level b in [0, 1]:

    learned   = clamp(tail(q) * safety_margin + headroom,
                      min_factor * static, static)
    effective = learned + b * (static - learned)

Safety argument (the reason this cannot break consensus):

- the static config value remains the HARD CEILING — the controller can
  only ever schedule a timeout <= the one the operator configured, so
  no schedule the static system would have met is missed by more than
  the static system would miss it;
- `min_factor * static` is the floor of last resort — the controller
  cannot collapse a timeout to zero on a sleepy-but-healthy net;
- any timeout that actually FIRES, and any round > 0, is evidence the
  pacing was too aggressive (or the net degraded): b jumps
  multiplicatively toward 1 (static behavior restored within one or
  two bad heights), while clean round-0 commits decrease b additively
  — slow to re-tighten, fast to back off, the classic AIMD asymmetry.
  Tendermint's liveness never depended on timeouts being tight, only
  on them eventually being long enough; the ceiling + back-off give
  exactly that, while the tail coverage gives speed when the committee
  is fast.

Everything here is deterministic in the fed sample/event stream — no
clock reads, no randomness — so two nodes observing identical streams
derive identical schedules (tested).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from ..obs.quantile import StreamingQuantile
from ..types.vote import VoteType

# persisted pacing-tail schema (save_tails/load_tails): the learned
# arrival-tail windows + per-step AIMD back-off, written next to the WAL
# so a restarting validator re-enters the committee with the tails it
# had already learned instead of paying min_samples heights of static
# schedules per step
PACING_STATE_SCHEMA = "tm-tpu/pacing-tails/v1"

# step kinds, in schedule order; these are the `step=` label values of
# consensus_adaptive_timeout_seconds and the pacing.decision trace events
STEP_PROPOSE = "propose"
STEP_PREVOTE = "prevote"
STEP_PRECOMMIT = "precommit"
STEP_COMMIT = "commit"
PACING_STEPS = (STEP_PROPOSE, STEP_PREVOTE, STEP_PRECOMMIT, STEP_COMMIT)


@dataclass
class PacingConfig:
    """Controller knobs (the `[consensus] adaptive_*` config block)."""

    # arrival-tail coverage: the learned timeout covers this quantile of
    # the observed lag distribution...
    tail_quantile: float = 0.99
    # ...scaled by this margin plus a fixed headroom (scheduler jitter,
    # event-loop latency) on top
    safety_margin: float = 1.25
    headroom_s: float = 0.002
    # floor of last resort: effective timeout never drops below
    # min_factor * the static config value
    min_factor: float = 0.05
    # quantile-sketch window (samples) per step controller
    window: int = 256
    # stay on the static value until a controller has this many samples
    min_samples: int = 8
    # AIMD: on a fired timeout / round > 0 the back-off level jumps
    # b <- min(1, max(2b, backoff_step)); on a clean round-0 commit it
    # decays b <- max(0, b - recover_step)
    backoff_step: float = 0.5
    recover_step: float = 0.1

    @classmethod
    def from_knobs(cls, knobs) -> "PacingConfig":
        """Build from any object carrying the `adaptive_*` attributes
        (state_machine.ConsensusConfig, config.ConsensusTimeoutsConfig)
        — the ONE mapping both the config validator and the controller
        constructor use, so a future knob cannot be wired into one and
        silently defaulted in the other."""
        return cls(
            tail_quantile=knobs.adaptive_tail_quantile,
            safety_margin=knobs.adaptive_safety_margin,
            headroom_s=knobs.adaptive_headroom,
            min_factor=knobs.adaptive_min_factor,
            window=knobs.adaptive_window,
            min_samples=knobs.adaptive_min_samples,
            backoff_step=knobs.adaptive_backoff_step,
            recover_step=knobs.adaptive_recover_step,
        )

    def validate(self) -> None:
        if not 0.0 < self.tail_quantile <= 1.0:
            raise ValueError("adaptive tail_quantile must be in (0, 1]")
        if self.safety_margin < 1.0:
            raise ValueError("adaptive safety_margin must be >= 1")
        if self.headroom_s < 0:
            raise ValueError("adaptive headroom cannot be negative")
        if not 0.0 < self.min_factor <= 1.0:
            raise ValueError("adaptive min_factor must be in (0, 1]")
        if self.window < 2:
            raise ValueError("adaptive window must be >= 2")
        if self.min_samples < 1:
            raise ValueError("adaptive min_samples must be >= 1")
        if not 0.0 < self.backoff_step <= 1.0:
            raise ValueError("adaptive backoff_step must be in (0, 1]")
        if not 0.0 < self.recover_step <= 1.0:
            raise ValueError("adaptive recover_step must be in (0, 1]")


class _StepController:
    """One step kind's learned tail + AIMD back-off level."""

    __slots__ = (
        "name",
        "static_s",
        "cfg",
        "sketch",
        "backoff",
        "failed_since_commit",
    )

    def __init__(self, name: str, static_s: float, cfg: PacingConfig):
        self.name = name
        self.static_s = static_s
        self.cfg = cfg
        self.sketch = StreamingQuantile(cfg.window)
        # start fully backed off (= static behavior): the controller
        # must EARN tightness from observed samples and clean commits
        self.backoff = 1.0
        # set on a failure, cleared at the next commit: a height whose
        # timeout fired must not ALSO count as a success for this step
        self.failed_since_commit = False

    def observe(self, lag_s: float) -> None:
        self.sketch.add(lag_s)

    def learned(self) -> float:
        """The tail-coverage timeout, clamped to [floor, static]."""
        cfg = self.cfg
        floor = cfg.min_factor * self.static_s
        if len(self.sketch) < cfg.min_samples:
            return self.static_s
        raw = (
            self.sketch.quantile(cfg.tail_quantile) * cfg.safety_margin
            + cfg.headroom_s
        )
        return min(self.static_s, max(floor, raw))

    def effective(self) -> float:
        learned = self.learned()
        return learned + self.backoff * (self.static_s - learned)

    def on_failure(self) -> None:
        # multiplicative increase of conservatism
        self.backoff = min(
            1.0, max(self.backoff * 2.0, self.cfg.backoff_step)
        )
        self.failed_since_commit = True

    def on_commit(self, clean_round0: bool) -> None:
        """Height decided: additive decay toward the learned tail, but
        only when this STEP saw no failure since the last commit (a
        fired timeout that still committed at round 0 must not cancel
        half its own back-off the instant it happened — per step, so a
        flapping propose schedule cannot freeze the commit controller's
        recovery)."""
        if clean_round0 and not self.failed_since_commit:
            self.backoff = max(0.0, self.backoff - self.cfg.recover_step)
        self.failed_since_commit = False

    def snapshot(self) -> dict:
        return {
            "static_s": self.static_s,
            "learned_s": self.learned(),
            "effective_s": self.effective(),
            "backoff": round(self.backoff, 6),
            "samples": self.sketch.count,
        }


class PacingController:
    """Per-step adaptive timeout controllers for one ConsensusState.

    Sensor feeds (synchronous, from HeightVoteSet / the state machine)
    go in through observe_*; schedule queries (propose/prevote/
    precommit/commit_wait) come out clamped to the static config; AIMD
    events (on_timeout_fired / on_round_advance / on_height_committed)
    move the back-off level. For rounds > 0 every query returns the
    static schedule — a non-zero round already IS the failure signal,
    and the reference's per-round delta escalation must keep its exact
    semantics there.
    """

    def __init__(
        self,
        static_config,
        cfg: Optional[PacingConfig] = None,
        metrics=None,
        tracer=None,
    ):
        from ..obs import default_tracer

        self.static = static_config
        self.cfg = cfg or PacingConfig()
        self.cfg.validate()
        self.metrics = metrics
        self.tracer = default_tracer() if tracer is None else tracer
        self._steps = {
            STEP_PROPOSE: _StepController(
                STEP_PROPOSE, static_config.timeout_propose, self.cfg
            ),
            STEP_PREVOTE: _StepController(
                STEP_PREVOTE, static_config.timeout_prevote, self.cfg
            ),
            STEP_PRECOMMIT: _StepController(
                STEP_PRECOMMIT, static_config.timeout_precommit, self.cfg
            ),
            STEP_COMMIT: _StepController(
                STEP_COMMIT, static_config.timeout_commit, self.cfg
            ),
        }
        # persistence target (node assembly points this next to the WAL
        # file; None = in-memory only, the harness default)
        self.persist_path: Optional[str] = None
        # fired-timeout tallies (ticker wiring; staleness-unfiltered).
        # Only the steps that CAN fire as failures: the commit wait's
        # NEW_HEIGHT expiry fires every healthy height by design, so a
        # tally for it would be noise pretending to be signal
        self.fired: dict[str, int] = {
            s: 0 for s in (STEP_PROPOSE, STEP_PREVOTE, STEP_PRECOMMIT)
        }

    @classmethod
    def from_config(cls, config, metrics=None, tracer=None):
        """Build from a state_machine.ConsensusConfig carrying the
        adaptive_* knobs (config/config.py threads them through)."""
        return cls(
            config,
            PacingConfig.from_knobs(config),
            metrics=metrics,
            tracer=tracer,
        )

    # --- sensor feeds -----------------------------------------------------

    def observe_vote_arrival(self, vote_type: int, lag_s: float) -> None:
        """Pre-quorum arrival lag behind the round's first vote of the
        same type (HeightVoteSet feeds every accepted vote)."""
        if vote_type == VoteType.PREVOTE:
            self._steps[STEP_PREVOTE].observe(lag_s)
        elif vote_type == VoteType.PRECOMMIT:
            self._steps[STEP_PRECOMMIT].observe(lag_s)

    def observe_post_quorum_straggler(
        self, vote_type: int, lag_s: float
    ) -> None:
        """A vote accepted AFTER its set already had 2/3: its lag behind
        the quorum-closing vote is exactly the straggler window
        timeout_commit exists to cover."""
        if vote_type == VoteType.PRECOMMIT:
            self._steps[STEP_COMMIT].observe(lag_s)

    def observe_proposal_complete(self, delay_s: float) -> None:
        """Propose-step entry to complete proposal (header + all parts)
        on a height where we are NOT the proposer."""
        self._steps[STEP_PROPOSE].observe(delay_s)

    # --- AIMD events ------------------------------------------------------

    def on_timeout_fired(self, step: str) -> None:
        """A scheduled step timeout actually expired (staleness-filtered
        by the state machine): the learned schedule did not cover the
        committee this time — back off."""
        ctl = self._steps.get(step)
        if ctl is None:
            return
        ctl.on_failure()
        if self.metrics is not None:
            self.metrics.pacing_timeouts_fired.inc(step=step)
        self.tracer.event("pacing.backoff", step=step, cause="timeout")

    def on_ticker_fired(self, step: str) -> None:
        """Raw ticker expiry (before the state machine's staleness
        filter) — bookkeeping only, no back-off."""
        if step in self.fired:
            self.fired[step] += 1

    def on_round_advance(self, round_: int) -> None:
        """Entering any round > 0 means the committee failed to decide
        inside round 0's schedule — back everything off."""
        if round_ <= 0:
            return
        for ctl in self._steps.values():
            ctl.on_failure()
        self.tracer.event("pacing.backoff", round=round_, cause="round_advance")

    def on_height_committed(self, height: int, round_: int) -> None:
        """Height decided. Per step, a round-0 decision with no failure
        for THAT step since the last commit is the success signal that
        decays its back-off (a step whose timeout fired must not cancel
        half its own failure signal by riding the height's success,
        while an unrelated flapping step cannot freeze the others'
        recovery); the decision event records learned-vs-static for the
        height either way."""
        for ctl in self._steps.values():
            ctl.on_commit(round_ == 0)
        if self.tracer.enabled:
            for name, ctl in self._steps.items():
                s = ctl.snapshot()
                self.tracer.event(
                    "pacing.decision",
                    height=height,
                    round=round_,
                    step=name,
                    learned_ms=round(s["learned_s"] * 1e3, 3),
                    static_ms=round(s["static_s"] * 1e3, 3),
                    effective_ms=round(s["effective_s"] * 1e3, 3),
                    backoff=s["backoff"],
                    samples=s["samples"],
                )
        if self.metrics is not None:
            for name, ctl in self._steps.items():
                self.metrics.pacing_backoff.set(ctl.backoff, step=name)

    # --- schedule queries (the ConsensusConfig surface) -------------------

    def _query(self, step: str) -> float:
        eff = self._steps[step].effective()
        return self._export(step, eff)

    def _export(self, step: str, value: float) -> float:
        # the gauge tracks the schedule actually IN EFFECT — including
        # the static per-round escalation during rounds > 0, so an
        # operator reading /metrics during a liveness incident sees the
        # real (escalated) timeout, not a stale round-0 learned value
        if self.metrics is not None:
            self.metrics.adaptive_timeout.set(value, step=step)
        return value

    def propose(self, round_: int) -> float:
        if round_ > 0:
            return self._export(STEP_PROPOSE, self.static.propose(round_))
        return self._query(STEP_PROPOSE)

    def prevote(self, round_: int) -> float:
        if round_ > 0:
            return self._export(STEP_PREVOTE, self.static.prevote(round_))
        return self._query(STEP_PREVOTE)

    def precommit(self, round_: int) -> float:
        if round_ > 0:
            return self._export(
                STEP_PRECOMMIT, self.static.precommit(round_)
            )
        return self._query(STEP_PRECOMMIT)

    def commit_wait(self) -> float:
        """The adaptive timeout_commit: how long the next height's start
        is delayed to collect straggler precommits for LastCommit."""
        return self._query(STEP_COMMIT)

    def reset_learning(self) -> None:
        """Drop every learned distribution (back-off levels keep their
        value, schedules return to static until min_samples fresh
        samples arrive). Called after WAL catchup replay: replayed
        votes arrive at replay speed, and their near-zero lags would
        teach the controller a committee that doesn't exist."""
        for ctl in self._steps.values():
            ctl.sketch.reset()

    # --- persistence (learned-tail warm starts) ---------------------------

    def state_dict(self) -> dict:
        """The restorable learning state: per step, the windowed lag
        samples (arrival order), lifetime count, and back-off level.
        Static values ride along as a sanity cross-check only — lags
        are properties of the committee, not of the configured ceiling,
        so a config change does not invalidate them."""
        return {
            "schema": PACING_STATE_SCHEMA,
            "steps": {
                name: {
                    "static_s": ctl.static_s,
                    "backoff": round(ctl.backoff, 6),
                    "count": ctl.sketch.count,
                    "samples": [
                        round(x, 6) for x in ctl.sketch.to_list()
                    ],
                }
                for name, ctl in self._steps.items()
            },
        }

    def load_state(self, blob) -> bool:
        """Restore a state_dict. Tolerant by design — a missing step,
        wrong schema, or junk shape loads nothing (False) rather than
        poisoning a running controller: the worst outcome of a bad
        tails file must be 'start static', never 'start wrong'."""
        if (
            not isinstance(blob, dict)
            or blob.get("schema") != PACING_STATE_SCHEMA
            or not isinstance(blob.get("steps"), dict)
        ):
            return False
        loaded = False
        for name, ctl in self._steps.items():
            row = blob["steps"].get(name)
            if not isinstance(row, dict):
                continue
            samples = row.get("samples")
            if not isinstance(samples, list):
                continue
            try:
                ctl.sketch.load(
                    (float(x) for x in samples),
                    int(row.get("count", 0)),
                )
            except (TypeError, ValueError):
                ctl.sketch.reset()
                continue
            b = row.get("backoff")
            if isinstance(b, (int, float)):
                ctl.backoff = min(1.0, max(0.0, float(b)))
            loaded = True
        return loaded

    def save_tails(self, path: Optional[str] = None) -> bool:
        """Atomically persist the learning state to `path` (default:
        persist_path). Write-to-temp + rename so a crash mid-save
        leaves the previous file intact. False when unconfigured or
        the write fails — persistence is best-effort, never fatal."""
        path = path or self.persist_path
        if not path:
            return False
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.state_dict(), f)
            os.replace(tmp, path)
            return True
        except OSError:
            return False

    def load_tails(self, path: Optional[str] = None) -> bool:
        """Reload persisted tails (default path: persist_path). Called
        AFTER WAL catchup replay's reset_learning so the warm start —
        tails learned live before the restart — survives while the
        replay-speed contamination does not."""
        path = path or self.persist_path
        if not path:
            return False
        try:
            with open(path, encoding="utf-8") as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return False
        return self.load_state(blob)

    # --- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        """Per-step controller state (tests, RPC/debug surface)."""
        return {
            "steps": {n: c.snapshot() for n, c in self._steps.items()},
            "fired": dict(self.fired),
        }
