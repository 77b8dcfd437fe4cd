"""Live health plane — streaming SLO monitors over the recording seams.

The *recording* stack (flight ring, cluster tracing,
quorum/wall attribution) exists, but nothing watches those streams while the
node runs: the `health` RPC was a stub returning `{}`, and "which plane
degraded" stayed an archaeology question over dump files. This module
closes the loop in-process:

- **Detectors** turn the existing metric/trace seams into boolean
  good/bad event streams: consensus round churn and stalled rounds
  (commit cadence vs the static-timeout ceiling), quorum-lag anomalies
  (the arrival-lag sensor vs a good-sample baseline tail),
  scheduler saturation (queue depth vs dispatch progress), WAL fsync
  latency drift, the sequencer receipt->applied SLO (a measured 96 ms p95
  as the default target), the lightserve cache hit-rate floor, peer
  flap, an event-loop lag probe (a monotonic heartbeat task — the
  finding that live nets go event-loop-bound above ~32 validators,
  measured instead of inferred), and the dark_time conservation
  watchdog (per-height wall time with NO instrumented owner, from
  obs.report.wall_conservation over the bound flight ring).

- **Burn-rate SLOs** (the SRE multiwindow pattern) roll each detector's
  event stream into ok/warn/critical: burn = bad_fraction /
  error_budget over a short and a long window; warn/critical require
  BOTH windows above threshold, so a single bad sample can't page and a
  recovered incident un-pages as the short window drains.

- **Incidents**: every verdict transition lands a `health.incident`
  event in the tracer ring — a flight dump now carries *why* (detector,
  threshold, observed value) next to *what* (the step timeline) — and
  increments `tm_health_incidents_total`.

- **Gauges**: `tm_health_status{subsystem=}` (0/1/2) and
  `tm_slo_burn_rate{slo=}` export the rolled-up state for scraping.

Determinism: every feed and every verdict takes an explicit event-time
`t`; nothing in the detector/SLO math reads a clock. The async runtime
(`HealthMonitor.start`) is a thin driver that samples the bound seams
on an interval and stamps `time.monotonic()` — unit tests feed
synthetic streams with synthetic clocks and get identical state.
Stdlib only, like the rest of `obs/`.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Callable, Optional

from .quantile import StreamingQuantile
from .tracer import default_tracer

# verdict levels (gauge values of tm_health_status)
OK, WARN, CRITICAL = 0, 1, 2
VERDICT_NAMES = {OK: "ok", WARN: "warn", CRITICAL: "critical"}

# incident event name in the tracer ring (rides dump_traces unchanged)
INCIDENT_EVENT = "health.incident"


class BurnRateSLO:
    """Multi-window error-budget burn over a timestamped event stream.

    `objective` is the target good fraction (0.99 -> 1% error budget);
    `burn(t, w)` = bad_fraction_in_window / (1 - objective), so 1.0
    means the budget is being consumed exactly at its sustainable rate.
    The verdict requires BOTH the short and the long window to burn
    past the threshold: the long window carries severity, the short
    window confirms the problem is still live (the standard multiwindow
    multi-burn-rate alerting shape)."""

    __slots__ = (
        "name",
        "objective",
        "short_window",
        "long_window",
        "warn_burn",
        "crit_burn",
        "min_events",
        "_events",
        "_bad",
        "_total",
        "_short",
        "_sbad",
        "_stotal",
    )

    def __init__(
        self,
        name: str,
        objective: float = 0.99,
        short_window: float = 30.0,
        long_window: float = 300.0,
        warn_burn: float = 1.0,
        crit_burn: float = 6.0,
        min_events: int = 4,
    ):
        if not (0.0 < objective < 1.0):
            raise ValueError("slo objective must be in (0, 1)")
        if short_window <= 0 or long_window < short_window:
            raise ValueError("slo windows must satisfy 0 < short <= long")
        self.name = name
        self.objective = objective
        self.short_window = short_window
        self.long_window = long_window
        self.warn_burn = warn_burn
        self.crit_burn = crit_burn
        self.min_events = max(1, min_events)
        # (t, bad_count, total_count), pruned past the long window;
        # rolling (bad, total) sums per window keep burn()/verdict()
        # O(1) — these run synchronously in the consensus commit path,
        # and at committee scale the long deque holds tens of
        # thousands of per-vote entries a rescan per commit can't
        # afford (the event loop is the scarce resource)
        self._events: deque[tuple[float, int, int]] = deque()
        self._bad = 0
        self._total = 0
        self._short: deque[tuple[float, int, int]] = deque()
        self._sbad = 0
        self._stotal = 0

    def observe(self, t: float, bad: int, total: int = 1) -> None:
        """Record `bad` failures out of `total` events at time t."""
        if total <= 0:
            return
        b, n = max(0, int(bad)), int(total)
        self._events.append((t, b, n))
        self._bad += b
        self._total += n
        self._short.append((t, b, n))
        self._sbad += b
        self._stotal += n
        self._prune(t)

    def _prune(self, t: float) -> None:
        horizon = t - self.long_window
        ev = self._events
        while ev and ev[0][0] < horizon:
            _, b, n = ev.popleft()
            self._bad -= b
            self._total -= n
        horizon = t - self.short_window
        ev = self._short
        while ev and ev[0][0] < horizon:
            _, b, n = ev.popleft()
            self._sbad -= b
            self._stotal -= n

    def _window(self, t: float, window: float) -> tuple[int, int]:
        self._prune(t)
        if window >= self.long_window:
            return self._bad, self._total
        if window == self.short_window:
            return self._sbad, self._stotal
        lo = t - window
        bad = total = 0
        for ts, b, n in self._events:
            if ts >= lo:
                bad += b
                total += n
        return bad, total

    def burn(self, t: float, window: Optional[float] = None) -> float:
        """Error-budget burn rate over the window (long by default)."""
        bad, total = self._window(t, window or self.long_window)
        if total == 0:
            return 0.0
        budget = 1.0 - self.objective
        return (bad / total) / budget

    def verdict(self, t: float) -> int:
        self._prune(t)
        _, long_total = self._window(t, self.long_window)
        if long_total < self.min_events:
            return OK
        long_burn = self.burn(t, self.long_window)
        short_burn = self.burn(t, self.short_window)
        if long_burn >= self.crit_burn and short_burn >= self.crit_burn:
            return CRITICAL
        if long_burn >= self.warn_burn and short_burn >= self.warn_burn:
            return WARN
        return OK

    def snapshot(self, t: float) -> dict:
        bad, total = self._window(t, self.long_window)
        return {
            "objective": self.objective,
            "events": total,
            "bad": bad,
            "burn_long": round(self.burn(t, self.long_window), 3),
            "burn_short": round(self.burn(t, self.short_window), 3),
        }


class Detector:
    """One named failure mode of one subsystem. Subclasses feed their
    SLO from seam-specific samples; `verdict(t)` combines the SLO state
    with any direct condition (`_direct(t)`, e.g. a hard stall)."""

    subsystem = "node"
    name = "detector"

    def __init__(self, slo: BurnRateSLO):
        self.slo = slo
        # last observed value + the threshold it was judged against,
        # for incident payloads; last_bad is the most recent OFFENDING
        # observation — an escalating incident must carry the value
        # that tripped it, not whatever good sample arrived after
        self.last_value: float = 0.0
        self.last_bad: float = 0.0
        self.last_threshold: float = 0.0

    def _direct(self, t: float) -> int:
        """Directly-observable verdict floor (no burn math); OK default."""
        return OK

    def verdict(self, t: float) -> int:
        return max(self._direct(t), self.slo.verdict(t))

    def snapshot(self, t: float) -> dict:
        out = self.slo.snapshot(t)
        out["value"] = round(self.last_value, 6)
        out["last_bad"] = round(self.last_bad, 6)
        out["threshold"] = round(self.last_threshold, 6)
        return out

    def _observe(self, t: float, value: float, bad: bool) -> None:
        """Book one judged sample: SLO event + value/last_bad fields."""
        self.last_value = value
        if bad:
            self.last_bad = value
        self.slo.observe(t, bad=1 if bad else 0)


class RoundChurnDetector(Detector):
    """Consensus heights that needed rounds > 0. A healthy committee
    commits at round 0; churn means timeouts fired or the proposer was
    partitioned — exactly the pacing back-off signal, now rolled into a
    verdict instead of a controller nudge."""

    subsystem = "consensus"
    name = "round_churn"

    def observe_height(self, t: float, round_: int) -> None:
        self._observe(t, float(round_), bad=round_ > 0)


class StalledRoundDetector(Detector):
    """No height committed within the ceiling — the one condition that
    must page directly (a burn window over zero events never fires).
    `ceiling_s` defaults to stall_factor x the static round-0 schedule
    (propose + prevote + precommit + commit waits): the adaptive
    controllers only ever tighten BELOW that, so a net that blows past
    it is stalled regardless of pacing state. Also feeds the SLO with
    per-height commit intervals judged against near_stall_fraction x
    the ceiling — a lower bar than the page, so repeated near-stalls
    warn BEFORE the hard stall pages (at the ceiling itself the direct
    check is already critical and the SLO tier would be redundant)."""

    subsystem = "consensus"
    name = "stalled_round"

    def __init__(
        self,
        slo: BurnRateSLO,
        ceiling_s: float,
        near_stall_fraction: float = 0.5,
    ):
        super().__init__(slo)
        self.ceiling_s = ceiling_s
        self.near_stall_fraction = near_stall_fraction
        self.last_threshold = ceiling_s
        self._last_commit_t: Optional[float] = None

    def arm(self, t: float) -> None:
        """Start the stall clock (monitor start / consensus start)."""
        if self._last_commit_t is None:
            self._last_commit_t = t

    def observe_height(self, t: float) -> None:
        if self._last_commit_t is not None:
            interval = t - self._last_commit_t
            near = self.ceiling_s * self.near_stall_fraction
            self._observe(t, interval, bad=interval > near)
        self._last_commit_t = t

    def _direct(self, t: float) -> int:
        if self._last_commit_t is None:
            return OK
        elapsed = t - self._last_commit_t
        if elapsed > self.ceiling_s:
            self.last_value = elapsed
            self.last_bad = elapsed
            return CRITICAL
        return OK


class QuorumLagDetector(Detector):
    """Arrival-lag anomaly: each accepted vote's lag behind the round's
    first vote (the arrival-lag sensor, fed synchronously from HeightVoteSet)
    is judged against a learned good-sample tail. Two asymmetries keep
    the baseline honest:

    - the first `min_baseline` samples are LEARNING-ONLY (admitted,
      never judged): an anomaly call needs a baseline first, and the
      in-proc gossip plane's genuine clean tail is ~100 ms p95
      (tick-paced vote trickle, measured on the 4-validator harness) —
      judging against the static floor during warmup false-flags half
      the clean stream;
    - after warmup the baseline only ingests samples BELOW the current
      threshold — a persistent straggler keeps flagging instead of
      teaching the detector that its lag is normal (the pacing
      controller intentionally learns that tail; the health plane's
      job is to say it changed)."""

    subsystem = "consensus"
    name = "quorum_lag"

    def __init__(
        self,
        slo: BurnRateSLO,
        floor_s: float = 0.025,
        margin: float = 2.0,
        baseline_window: int = 512,
        min_baseline: int = 32,
    ):
        super().__init__(slo)
        self.floor_s = floor_s
        self.margin = margin
        self.min_baseline = min_baseline
        self._baseline = StreamingQuantile(window=baseline_window)

    def threshold(self) -> float:
        if len(self._baseline) < self.min_baseline:
            return self.floor_s
        return max(self.floor_s, self.margin * self._baseline.quantile(0.95))

    def observe_lag(self, t: float, lag_s: float) -> None:
        if len(self._baseline) < self.min_baseline:
            # warmup: learn the committee's clean arrival spread before
            # judging anything against it
            self._baseline.add(lag_s)
            self.last_value = lag_s
            return
        thr = self.threshold()
        self.last_threshold = thr
        bad = lag_s > thr
        self._observe(t, lag_s, bad=bad)
        if not bad:
            self._baseline.add(lag_s)

    def snapshot(self, t: float) -> dict:
        out = super().snapshot(t)
        out["baseline_p95"] = round(self._baseline.quantile(0.95), 6)
        return out


class SchedulerSaturationDetector(Detector):
    """Verify-scheduler saturation: a queue that stays deep across
    samples while dispatch rounds keep filling their buckets means the
    device can't drain the offered load (the r04-class symptom from the
    inside). One sample per monitor tick: bad when depth >= the
    saturation floor AND the interval made no dispatch progress or the
    last dispatch was essentially full."""

    subsystem = "scheduler"
    name = "scheduler_saturation"

    def __init__(
        self,
        slo: BurnRateSLO,
        depth_floor: int = 256,
        fill_floor: float = 0.95,
    ):
        super().__init__(slo)
        self.depth_floor = depth_floor
        self.fill_floor = fill_floor
        self.last_threshold = float(depth_floor)

    def observe_sample(
        self,
        t: float,
        queue_depth: float,
        fill_ratio: float,
        dispatches_delta: int,
    ) -> None:
        saturated = queue_depth >= self.depth_floor and (
            dispatches_delta == 0 or fill_ratio >= self.fill_floor
        )
        self._observe(t, queue_depth, bad=saturated)


class FillEfficiencyDetector(Detector):
    """Dispatch fill-efficiency floor over the device-cost ledger
    (obs/ledger.py): each monitor tick with meaningful dispatch volume
    computes interval fill = rows-requested / rows-dispatched; fill
    under the floor is a bad event. A scheduler sustaining 10%-full
    buckets is paying the device for padding — a ladder/mesh_min_rows/
    max_batch misconfiguration the health plane should page on, not a
    bench-archaeology finding. `min_rows` gates the judgement: a small
    committee's vote rounds (a handful of rows padded to the 8-bucket)
    are a latency choice, not waste worth paging over."""

    subsystem = "scheduler"
    name = "fill_efficiency"

    def __init__(
        self,
        slo: BurnRateSLO,
        floor: float = 0.1,
        min_rows: int = 256,
    ):
        super().__init__(slo)
        self.floor = floor
        self.min_rows = min_rows
        self.last_threshold = floor

    def observe_interval(
        self, t: float, rows_requested: float, rows_dispatched: float
    ) -> None:
        if rows_dispatched < self.min_rows:
            return  # idle / small-round interval: nothing to judge
        fill = rows_requested / rows_dispatched
        self._observe(t, fill, bad=fill < self.floor)


class LatencyDriftDetector(Detector):
    """Latency drift against a learned good baseline (WAL fsync is the
    canonical instance: a degrading disk shows up as the interval-mean
    fsync latency drifting off its long-run median). Fed interval
    means derived from histogram deltas; bad when the mean exceeds
    drift_factor x the baseline median AND an absolute floor (noise on
    an idle WAL can't flag)."""

    subsystem = "wal"
    name = "wal_fsync_drift"

    def __init__(
        self,
        slo: BurnRateSLO,
        drift_factor: float = 4.0,
        abs_floor_s: float = 0.001,
        baseline_window: int = 256,
        min_baseline: int = 8,
    ):
        super().__init__(slo)
        self.drift_factor = drift_factor
        self.abs_floor_s = abs_floor_s
        self.min_baseline = min_baseline
        self._baseline = StreamingQuantile(window=baseline_window)

    def threshold(self) -> float:
        if len(self._baseline) < self.min_baseline:
            return float("inf")
        return max(
            self.abs_floor_s,
            self.drift_factor * self._baseline.quantile(0.5),
        )

    def observe_mean(self, t: float, mean_s: float) -> None:
        thr = self.threshold()
        self.last_threshold = thr if thr != float("inf") else 0.0
        bad = mean_s > thr
        self._observe(t, mean_s, bad=bad)
        if not bad:
            self._baseline.add(mean_s)


class IpcRoundTripDetector(Detector):
    """Verify-service IPC health ([scheduler] remote_socket nodes): the
    RemoteVerifyScheduler's cumulative submit->verdict accounting
    (`ipc_stats()`) is pulled per tick and judged two ways:

    - the interval-mean round trip drifts off a learned good-sample
      median (same asymmetry as the WAL fsync detector: bad intervals
      never teach the baseline) — a wedged-but-open service, a
      saturated device plane, or a socket path rerouted through a slow
      filesystem all show up here BEFORE heights visibly inflate;
    - every local-degrade fallback in the interval is a bad event
      outright: the client never hangs and never drops a verdict, so
      degrades are invisible to liveness — burn-rate on them is how a
      dying service pages instead of silently billing every verify to
      the local CPU."""

    subsystem = "scheduler"
    name = "ipc_round_trip"

    def __init__(
        self,
        slo: BurnRateSLO,
        drift_factor: float = 4.0,
        abs_floor_s: float = 0.002,
        baseline_window: int = 256,
        min_baseline: int = 8,
    ):
        super().__init__(slo)
        self.drift_factor = drift_factor
        self.abs_floor_s = abs_floor_s
        self.min_baseline = min_baseline
        self._baseline = StreamingQuantile(window=baseline_window)

    def threshold(self) -> float:
        if len(self._baseline) < self.min_baseline:
            return float("inf")
        return max(
            self.abs_floor_s,
            self.drift_factor * self._baseline.quantile(0.5),
        )

    def observe_interval(
        self,
        t: float,
        mean_rtt_s: Optional[float] = None,
        degrades: int = 0,
    ) -> None:
        if degrades > 0:
            # degraded submissions carry no RTT — each is its own bad
            # event (last_bad stays the offending RTT if one was seen)
            self.slo.observe(t, bad=degrades, total=degrades)
        if mean_rtt_s is None:
            return
        thr = self.threshold()
        self.last_threshold = thr if thr != float("inf") else 0.0
        bad = mean_rtt_s > thr
        self._observe(t, mean_rtt_s, bad=bad)
        if not bad:
            self._baseline.add(mean_rtt_s)


class LatencySLODetector(Detector):
    """Fixed-target latency SLO over histogram-delta observations: the
    sequencer receipt->applied plane targets a measured 96 ms p95
    (objective 0.95 with target_s 0.1 == "95% of applies inside
    100 ms"). `target_s` snaps to the histogram's nearest bucket
    boundary >= the configured target, since bucket counts are the
    only resolution a pull seam has."""

    subsystem = "sequencer"
    name = "sequencer_apply_slo"

    def __init__(self, slo: BurnRateSLO, target_s: float = 0.1):
        super().__init__(slo)
        self.target_s = target_s
        self.last_threshold = target_s

    def observe_counts(self, t: float, bad: int, total: int) -> None:
        if total <= 0:
            return
        self.last_value = bad / total
        if bad:
            self.last_bad = self.last_value
        self.slo.observe(t, bad=bad, total=total)


class HitRateFloorDetector(Detector):
    """Cache hit-rate floor (lightserve proof cache: measured
    0.998 at 1000 clients; sustained misses mean the durable pin is
    regressing heights or clients outrun the chain). Fed hit/miss
    COUNT DELTAS per sample; the SLO objective IS the floor."""

    subsystem = "lightserve"
    name = "lightserve_hit_rate"

    def __init__(self, slo: BurnRateSLO):
        super().__init__(slo)
        # the objective IS the floor — incidents must carry the bar
        self.last_threshold = slo.objective

    def observe_counts(self, t: float, hits: int, misses: int) -> None:
        total = hits + misses
        if total <= 0:
            return
        self.last_value = hits / total
        if misses:
            self.last_bad = self.last_value
        self.slo.observe(t, bad=misses, total=total)


class PeerFlapDetector(Detector):
    """Peer-count churn: each monitor tick where the connected-peer
    count DROPPED is a bad event. Steady shrinkage or connect/drop
    cycling both show up; a stable (even small) peer set stays ok."""

    subsystem = "p2p"
    name = "peer_flap"

    def __init__(self, slo: BurnRateSLO):
        super().__init__(slo)
        self._last_count: Optional[int] = None

    def observe_count(self, t: float, count: int) -> None:
        prev = self._last_count
        self._last_count = count
        if prev is None:
            self.last_value = float(count)
            return
        # the bar a drop violated is the peer count it dropped FROM;
        # like last_bad, it must survive recovery ticks so a later
        # incident carries the offending pair
        if count < prev:
            self.last_threshold = float(prev)
        self._observe(t, float(count), bad=count < prev)


class DarkTimeDetector(Detector):
    """Wall-clock conservation watchdog: every committed height's wall
    time decomposes into named buckets (obs.report.wall_conservation —
    step compute, gossip wait, timeout floor, verify IPC/queue/device,
    WAL fsync, commit pipeline) with the residue booked as `dark_time`.
    A height whose dark fraction exceeds the floor is a bad event: some
    slice of latency has NO instrumented owner — a new blocking seam, a
    starved event loop between step transitions, a span that stopped
    being recorded. The whole point of the conservation invariant is
    that such time can no longer hide; this detector is the part that
    pages about it. Fed per-height from the bound tracer's ring on the
    monitor tick (skipping heights already judged)."""

    subsystem = "consensus"
    name = "dark_time"

    def __init__(self, slo: BurnRateSLO, floor: float = 0.05):
        super().__init__(slo)
        self.floor = floor
        self.last_threshold = floor

    def observe_height(self, t: float, dark_fraction: float) -> None:
        self._observe(t, dark_fraction, bad=dark_fraction > self.floor)


class EventLoopLagDetector(Detector):
    """Event-loop scheduling lag: the heartbeat task measures how late
    the loop runs a due callback. Live nets above ~32
    validators saturate the loop long before the CPU — this makes that
    regime a verdict (warn at sustained lag over the threshold) rather
    than an inference from wall-clock anomalies."""

    subsystem = "runtime"
    name = "event_loop_lag"

    def __init__(self, slo: BurnRateSLO, lag_warn_s: float = 0.05):
        super().__init__(slo)
        self.lag_warn_s = lag_warn_s
        self.last_threshold = lag_warn_s

    def observe_lag(self, t: float, lag_s: float) -> None:
        self._observe(t, lag_s, bad=lag_s > self.lag_warn_s)


class HealthMonitor:
    """The node's live health plane: owns the detectors, samples the
    bound pull seams on a tick, receives the consensus push seams
    (HeightVoteSet/state machine feed it like they feed the pacing
    controller), rolls verdicts up per subsystem, and emits incidents
    into the tracer ring + the tm_health_* gauges.

    Wiring: node assembly constructs one from `[health]` config and
    binds seams (`bind_*`); the in-proc harnesses construct one
    directly and drive `sample(t)` by hand. All feeds accept an
    explicit `t`; when omitted the monitor stamps `self.clock()`
    (time.monotonic)."""

    def __init__(
        self,
        interval: float = 1.0,
        heartbeat_interval: float = 0.25,
        short_window: float = 30.0,
        long_window: float = 300.0,
        stall_ceiling_s: float = 60.0,
        quorum_lag_floor_s: float = 0.025,
        quorum_lag_margin: float = 2.0,
        scheduler_depth_floor: int = 256,
        fill_floor: float = 0.1,
        fill_min_rows: int = 256,
        fsync_drift_factor: float = 4.0,
        ipc_drift_factor: float = 4.0,
        sequencer_apply_target_s: float = 0.1,
        cache_hit_floor: float = 0.9,
        loop_lag_warn_s: float = 0.05,
        dark_time_floor: float = 0.05,
        tracer=None,
        metrics=None,
        process_metrics=None,
        logger=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.tracer = default_tracer() if tracer is None else tracer
        self.metrics = metrics  # libs.metrics.HealthMetrics or None
        self.process_metrics = process_metrics  # ProcessMetrics or None
        self.logger = logger
        self.clock = clock
        self.interval = interval
        self.heartbeat_interval = heartbeat_interval

        def slo(name, objective, **kw):
            kw.setdefault("short_window", short_window)
            kw.setdefault("long_window", long_window)
            return BurnRateSLO(name, objective=objective, **kw)

        self.round_churn = RoundChurnDetector(
            # 1 churned height in 10 burns the budget at exactly 1x
            slo("round_churn", objective=0.9)
        )
        self.stalled_round = StalledRoundDetector(
            slo("stalled_round", objective=0.9), ceiling_s=stall_ceiling_s
        )
        self.quorum_lag = QuorumLagDetector(
            # the signal is SPARSE: a straggling validator's lag is
            # phase-absorbed on the vote types where the whole
            # committee waited on it (everyone's precommit shifts
            # together when its prevote was the late one), so one
            # straggler of 4 shows up on ~10% of pre-quorum arrivals
            # (measured on the chaos harness) — a 5% budget puts that
            # at ~2x burn -> warn, far under the 6x critical gate,
            # while the clean stream (bounded tick-quantized spread,
            # zero samples past 2x its own p95) burns ~0
            slo("quorum_lag", objective=0.95, min_events=8),
            floor_s=quorum_lag_floor_s,
            margin=quorum_lag_margin,
        )
        self.scheduler_saturation = SchedulerSaturationDetector(
            slo("scheduler_saturation", objective=0.8),
            depth_floor=scheduler_depth_floor,
        )
        self.fill_efficiency = FillEfficiencyDetector(
            slo("fill_efficiency", objective=0.8),
            floor=fill_floor,
            min_rows=fill_min_rows,
        )
        self.wal_fsync_drift = LatencyDriftDetector(
            slo("wal_fsync_drift", objective=0.8),
            drift_factor=fsync_drift_factor,
        )
        self.ipc_round_trip = IpcRoundTripDetector(
            slo("ipc_round_trip", objective=0.8),
            drift_factor=ipc_drift_factor,
        )
        self.sequencer_apply = LatencySLODetector(
            slo("sequencer_apply_slo", objective=0.95, min_events=16),
            target_s=sequencer_apply_target_s,
        )
        self.lightserve_hit_rate = HitRateFloorDetector(
            slo(
                "lightserve_hit_rate",
                objective=cache_hit_floor,
                min_events=32,
            )
        )
        self.peer_flap = PeerFlapDetector(
            slo("peer_flap", objective=0.8)
        )
        self.event_loop_lag = EventLoopLagDetector(
            slo("event_loop_lag", objective=0.9, min_events=8),
            lag_warn_s=loop_lag_warn_s,
        )
        self.dark_time = DarkTimeDetector(
            # 1 unconserved height in 10 burns the budget at exactly 1x
            slo("dark_time", objective=0.9, min_events=4),
            floor=dark_time_floor,
        )
        self.detectors: dict[str, Detector] = {
            d.name: d
            for d in (
                self.round_churn,
                self.stalled_round,
                self.dark_time,
                self.quorum_lag,
                self.scheduler_saturation,
                self.fill_efficiency,
                self.wal_fsync_drift,
                self.ipc_round_trip,
                self.sequencer_apply,
                self.lightserve_hit_rate,
                self.peer_flap,
                self.event_loop_lag,
            )
        }
        self._last_verdicts: dict[str, int] = {
            name: OK for name in self.detectors
        }
        self.incidents: deque[dict] = deque(maxlen=256)
        # pull-seam bindings + last-seen cumulative counts for deltas
        self._scheduler_metrics = None
        self._ledger = None
        self._remote_scheduler = None
        self._wal_hist = None
        self._sequencer_hist = None
        self._lightserve_metrics = None
        self._switch = None
        self._conservation_tracer = None
        self._dark_seen_height = 0
        self._cum: dict[str, float] = {}
        self._tasks: list[asyncio.Task] = []
        self._running = False

    @classmethod
    def from_config(cls, hc, stall_ceiling_s: float, **kw) -> "HealthMonitor":
        """Build from a config.HealthConfig section; `stall_ceiling_s`
        comes from the consensus timeouts (the caller knows the static
        round-0 schedule)."""
        return cls(
            interval=hc.interval,
            heartbeat_interval=hc.heartbeat_interval,
            short_window=hc.short_window,
            long_window=hc.long_window,
            stall_ceiling_s=stall_ceiling_s,
            quorum_lag_floor_s=hc.quorum_lag_floor,
            quorum_lag_margin=hc.quorum_lag_margin,
            scheduler_depth_floor=hc.scheduler_depth_floor,
            fill_floor=hc.fill_floor,
            fill_min_rows=hc.fill_min_rows,
            fsync_drift_factor=hc.fsync_drift_factor,
            ipc_drift_factor=getattr(hc, "ipc_drift_factor", 4.0),
            sequencer_apply_target_s=hc.sequencer_apply_target,
            cache_hit_floor=hc.cache_hit_floor,
            loop_lag_warn_s=hc.loop_lag_warn,
            dark_time_floor=getattr(hc, "dark_time_floor", 0.05),
            **kw,
        )

    # --- push seams (consensus, same shape as the pacing feeds) ----------

    def observe_vote_arrival(
        self, vote_type: int, lag_s: float, t: Optional[float] = None
    ) -> None:
        """Fed synchronously by HeightVoteSet on every accepted
        pre-quorum vote (the arrival-lag sensor)."""
        self.quorum_lag.observe_lag(
            self.clock() if t is None else t, lag_s
        )

    def observe_round_advance(
        self, height: int, round_: int, t: Optional[float] = None
    ) -> None:
        # round advances are judged at commit time (observe_height_
        # committed carries the final round); nothing to book here yet,
        # but the hook keeps the seam symmetric with PacingController
        # for harnesses that want to drive churn directly
        del height, round_, t

    def observe_height_committed(
        self, height: int, round_: int, t: Optional[float] = None
    ) -> None:
        now = self.clock() if t is None else t
        self.round_churn.observe_height(now, round_)
        self.stalled_round.observe_height(now)
        self._evaluate(now)

    def observe_loop_lag(
        self, lag_s: float, t: Optional[float] = None
    ) -> None:
        self.event_loop_lag.observe_lag(
            self.clock() if t is None else t, lag_s
        )
        if self.process_metrics is not None:
            self.process_metrics.event_loop_lag.observe(lag_s)

    # --- pull-seam bindings ----------------------------------------------

    def bind_scheduler(self, scheduler_metrics) -> None:
        self._scheduler_metrics = scheduler_metrics

    def bind_ledger(self, ledger) -> None:
        """obs.ledger.DispatchLedger (or anything with totals()): the
        fill-efficiency floor detector reads interval deltas of
        rows-requested/rows-dispatched."""
        self._ledger = ledger

    def bind_remote_scheduler(self, remote) -> None:
        """parallel.verify_service.RemoteVerifyScheduler (or anything
        with `ipc_stats()` returning cumulative rtt_count/rtt_sum_s/
        degrades): the ipc_round_trip detector reads interval deltas —
        mean RTT judged vs a learned baseline, degrades bad outright."""
        self._remote_scheduler = remote

    def bind_wal(self, fsync_histogram) -> None:
        """consensus_metrics.wal_fsync_seconds (or any Histogram)."""
        self._wal_hist = fsync_histogram

    def bind_sequencer(self, apply_latency_histogram) -> None:
        self._sequencer_hist = apply_latency_histogram

    def bind_lightserve(self, lightserve_metrics) -> None:
        self._lightserve_metrics = lightserve_metrics

    def bind_switch(self, switch) -> None:
        self._switch = switch

    def bind_tracer(self, tracer) -> None:
        """obs.tracer.Tracer (the node's flight ring): each tick the
        dark_time detector runs the wall-conservation audit
        (obs.report.wall_conservation) over recent records and judges
        every COMPLETED height not yet seen — the in-progress height's
        window is still growing, so it is never judged early. No-ops
        while the tracer is disabled (no records, nothing to conserve)."""
        self._conservation_tracer = tracer

    # --- sampling ---------------------------------------------------------

    def _delta(self, key: str, cum: float) -> Optional[float]:
        """Interval delta of a cumulative counter; None on the FIRST
        sample (no baseline yet — callers must skip the observation, a
        fabricated 0.0 reads as "no progress" and false-flags, e.g. a
        legitimately busy scheduler queue on the first tick)."""
        prev = self._cum.get(key)
        self._cum[key] = cum
        if prev is None:
            return None
        return max(0.0, cum - prev)

    @staticmethod
    def _hist_above(series: dict, threshold: float) -> tuple[int, int]:
        """(count_above_threshold, total) from one Histogram.series()
        snapshot, using the nearest bucket boundary >= threshold."""
        total = series["count"]
        below = 0
        for b, c in zip(series["buckets"], series["counts"]):
            if b >= threshold:
                below = c  # cumulative count <= b
                break
        else:
            below = total
        return max(0, total - below), total

    def sample(self, t: Optional[float] = None) -> None:
        """One pull pass over every bound seam, then re-evaluate. Each
        seam pull is guarded independently: one bad seam (a bound
        metrics object changing shape) must not starve the seams bound
        after it — or the end-of-tick evaluation — while the RPC keeps
        saying monitored:true."""
        now = self.clock() if t is None else t
        for seam, pull in (
            ("scheduler", self._pull_scheduler),
            ("ledger", self._pull_ledger),
            ("remote_scheduler", self._pull_remote_scheduler),
            ("wal", self._pull_wal),
            ("sequencer", self._pull_sequencer),
            ("lightserve", self._pull_lightserve),
            ("p2p", self._pull_switch),
            ("conservation", self._pull_conservation),
        ):
            try:
                pull(now)
            except Exception as e:
                if self.logger is not None:
                    self.logger.error(
                        "health seam pull failed", seam=seam, err=str(e)
                    )
        self._evaluate(now)

    def _pull_scheduler(self, now: float) -> None:
        sm = self._scheduler_metrics
        if sm is None:
            return
        depth = sm.queue_depth.total()
        fill = sm.batch_fill_ratio.value()
        ddisp = self._delta("sched_dispatches", sm.dispatches.value())
        if ddisp is not None:
            self.scheduler_saturation.observe_sample(
                now, depth, fill, int(ddisp)
            )

    def _pull_ledger(self, now: float) -> None:
        led = self._ledger
        if led is None:
            return
        totals = led.totals()
        dreq = self._delta("ledger_req", totals["rows_requested"])
        ddisp = self._delta("ledger_disp", totals["rows_dispatched"])
        if dreq is not None and ddisp is not None and ddisp > 0:
            self.fill_efficiency.observe_interval(now, dreq, ddisp)

    def _pull_remote_scheduler(self, now: float) -> None:
        remote = self._remote_scheduler
        if remote is None:
            return
        stats = remote.ipc_stats()
        dcount = self._delta("ipc_rtt_count", stats["rtt_count"])
        dsum = self._delta("ipc_rtt_sum", stats["rtt_sum_s"])
        ddeg = self._delta("ipc_degrades", stats["degrades"])
        if dcount is None or dsum is None or ddeg is None:
            return  # first sample: baseline only
        self.ipc_round_trip.observe_interval(
            now,
            mean_rtt_s=(dsum / dcount) if dcount > 0 else None,
            degrades=int(ddeg),
        )

    def _pull_wal(self, now: float) -> None:
        if self._wal_hist is None:
            return
        s = self._wal_hist.series()
        dcount = self._delta("wal_count", s["count"])
        dsum = self._delta("wal_sum", s["sum"])
        if dcount is not None and dsum is not None and dcount > 0:
            self.wal_fsync_drift.observe_mean(now, dsum / dcount)

    def _pull_sequencer(self, now: float) -> None:
        if self._sequencer_hist is None:
            return
        s = self._sequencer_hist.series()
        bad, total = self._hist_above(s, self.sequencer_apply.target_s)
        dbad = self._delta("seq_bad", bad)
        dtotal = self._delta("seq_total", total)
        if dbad is not None and dtotal is not None and dtotal > 0:
            self.sequencer_apply.observe_counts(
                now, int(dbad), int(dtotal)
            )

    def _pull_lightserve(self, now: float) -> None:
        lm = self._lightserve_metrics
        if lm is None:
            return
        dh = self._delta("ls_hits", lm.cache_hits.value())
        dm = self._delta("ls_misses", lm.cache_misses.value())
        if dh is not None and dm is not None and (dh or dm):
            self.lightserve_hit_rate.observe_counts(
                now, int(dh), int(dm)
            )

    def _pull_switch(self, now: float) -> None:
        if self._switch is not None:
            self.peer_flap.observe_count(now, len(self._switch.peers))

    def _pull_conservation(self, now: float) -> None:
        tr = self._conservation_tracer
        if tr is None or not getattr(tr, "enabled", False):
            return
        from .report import wall_conservation

        # SpanRecords pass straight through (no to_json round trip on
        # the tick path), pre-filtered to heights not yet judged —
        # heightless records (WAL fsyncs, scheduler rounds) are kept
        # for window binning; ones belonging to already-judged heights
        # find no window in the filtered set and drop out
        seen = self._dark_seen_height
        cons = wall_conservation(
            [
                r
                for r in tr.records()
                if r.height == 0 or r.height > seen
            ],
            n_heights=8,
        )
        heights = cons.get("heights") or {}
        if not heights:
            return
        tip = max(heights)
        for h in sorted(heights):
            # the tip height's window is still growing — judge only
            # completed heights, each exactly once
            if h >= tip or h <= self._dark_seen_height:
                continue
            self._dark_seen_height = h
            self.dark_time.observe_height(
                now, heights[h]["dark_fraction"]
            )

    # --- verdict roll-up + incident emission ------------------------------

    def _evaluate(self, t: float) -> None:
        # self-arm the stall clock on the first evaluation pass: the
        # harnesses (soak/chaos) never call start(), and a node that
        # stalls before its first commit must still page once the
        # ceiling elapses from when the plane first looked
        self.stalled_round.arm(t)
        for name, det in self.detectors.items():
            v = det.verdict(t)
            prev = self._last_verdicts[name]
            if v != prev:
                self._last_verdicts[name] = v
                self._incident(t, det, prev, v)
        if self.metrics is not None:
            for sub, v in self._rollup().items():
                self.metrics.status.set(v, subsystem=sub)
            for name, det in self.detectors.items():
                self.metrics.burn_rate.set(det.slo.burn(t), slo=name)

    def _incident(self, t: float, det: Detector, prev: int, new: int) -> None:
        snap = det.snapshot(t)
        # an escalation carries the OFFENDING observation; a recovery
        # carries the current (healthy) reading
        value = snap["last_bad"] if new > prev else snap["value"]
        rec = {
            "t": round(t, 3),
            "detector": det.name,
            "subsystem": det.subsystem,
            "from": VERDICT_NAMES[prev],
            "to": VERDICT_NAMES[new],
            "value": value,
            "threshold": snap["threshold"],
            "burn": snap["burn_long"],
        }
        self.incidents.append(rec)
        self.tracer.event(
            INCIDENT_EVENT,
            subsystem=det.subsystem,
            slo=det.name,
            to=VERDICT_NAMES[new],
            value=value,
            threshold=snap["threshold"],
            burn=snap["burn_long"],
            # same key as the dump_health incident list — a tool
            # joining the two surfaces must not need two spellings
            **{"from": VERDICT_NAMES[prev]},
        )
        if self.metrics is not None:
            self.metrics.incidents.inc(subsystem=det.subsystem)
        if self.logger is not None:
            log = (
                self.logger.error
                if new == CRITICAL
                else self.logger.info
            )
            log(
                "health verdict transition",
                detector=det.name,
                subsystem=det.subsystem,
                to=VERDICT_NAMES[new],
            )

    def _rollup(self) -> dict:
        """subsystem -> max CACHED verdict over its detectors (no
        re-evaluation; _evaluate's gauge pass rides this)."""
        out: dict[str, int] = {}
        for name, det in self.detectors.items():
            v = self._last_verdicts[name]
            out[det.subsystem] = max(out.get(det.subsystem, OK), v)
        return out

    def subsystem_verdicts(self, t: Optional[float] = None) -> dict:
        """subsystem -> max verdict over its detectors, re-evaluated at
        `t` (clock() when omitted) so direct conditions — a hard stall
        emits no events for the cached state to have seen — surface on
        every query, not just after the next feed."""
        self._evaluate(self.clock() if t is None else t)
        return self._rollup()

    def status(self, t: Optional[float] = None) -> int:
        subs = self.subsystem_verdicts(t)
        return max(subs.values()) if subs else OK

    def verdict(self, t: Optional[float] = None) -> dict:
        """The structured verdict the health/dump_health RPCs serve."""
        now = self.clock() if t is None else t
        # re-check direct conditions (a stall must surface even when
        # nothing feeds events)
        self._evaluate(now)
        subs: dict[str, dict] = {}
        for name, det in self.detectors.items():
            entry = subs.setdefault(
                det.subsystem, {"status": VERDICT_NAMES[OK], "detectors": {}}
            )
            v = self._last_verdicts[name]
            entry["detectors"][name] = {
                "status": VERDICT_NAMES[v],
                **det.snapshot(now),
            }
        rollup = self._rollup()
        for sub, v in rollup.items():
            subs[sub]["status"] = VERDICT_NAMES[v]
        code = max(rollup.values()) if rollup else OK
        return {
            "status": VERDICT_NAMES[code],
            "code": code,
            "subsystems": subs,
            "incidents": list(self.incidents)[-32:],
        }

    # --- async runtime ----------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.stalled_round.arm(self.clock())
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._run(), name="health/sample"),
            loop.create_task(self._heartbeat(), name="health/heartbeat"),
        ]

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception as e:
                # a crashed watchdog task must not fail dark
                if self.logger is not None:
                    self.logger.error(
                        "health task died", task=t.get_name(), err=str(e)
                    )
        self._tasks.clear()

    def _sample_guarded(self) -> None:
        # seam pulls are individually guarded inside sample(); this
        # outer guard keeps an _evaluate/rollup crash from killing the
        # sampling loop — the watchdog plane failing dark while the
        # RPC keeps saying monitored:true is the exact failure mode
        # it exists to prevent
        try:
            self.sample()
        except Exception as e:
            if self.logger is not None:
                self.logger.error("health sample failed", err=str(e))

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self._sample_guarded()

    async def _heartbeat(self) -> None:
        """The event-loop lag probe: schedule a sleep, measure the
        overshoot. Lag is how late the loop got back to a due callback
        — the direct observable of an event-loop-bound node."""
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.heartbeat_interval)
            lag = max(0.0, loop.time() - t0 - self.heartbeat_interval)
            try:
                self.observe_loop_lag(lag)
            except Exception as e:
                if self.logger is not None:
                    self.logger.error("health heartbeat failed", err=str(e))
