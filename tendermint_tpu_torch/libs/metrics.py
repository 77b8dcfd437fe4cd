"""Prometheus-style metrics: counters/gauges/histograms + text exposition.

Reference: the metricsgen-generated structs (consensus/metrics.go:23,
p2p/metrics.go, blocksync/metrics.go, statesync/metrics.go,
state/metrics.go, proxy/metrics.go:16) served at
InstrumentationConfig.PrometheusListenAddr (node/node.go:1062-1065).
No external client library: the registry renders the text exposition
format (v0.0.4) itself and a tiny asyncio HTTP server exposes /metrics.

Histograms support labels (one bucket series per label-value tuple) so
`consensus_step_duration_seconds{step=...}` is ONE histogram object, not
one per step. Registering the same name under a different metric kind
raises TypeError — a silent kind collision returns an object whose API
doesn't match what the second caller asked for.

Label cardinality is bounded: every labeled family caps its distinct
label-value tuples at `max_series` (default MAX_LABEL_SERIES) and raises
`MetricCardinalityError` past the cap — an unbounded label (peer id,
validator address) would otherwise grow the exposition without limit.
Callers that genuinely label by peer/validator go through
`bounded_label()`, a per-family top-K admission filter that maps the
long tail to "_other" so the cap is never hit in practice.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Optional

from .service import Service

# default cap on distinct label-value tuples per metric family; far
# above every legitimate family (chID/step/method are all < 32) and far
# below where a leaked unbounded label would hurt the exposition
MAX_LABEL_SERIES = 512


class MetricCardinalityError(RuntimeError):
    """A labeled metric family exceeded its max_series cap."""

    def __init__(self, name: str, cap: int, key: tuple):
        super().__init__(
            f"metric family {name!r} exceeded its label-cardinality cap "
            f"({cap} series) adding {key!r}; bound the label with "
            f"bounded_label() or raise max_series explicitly"
        )


# --- top-K label admission (bounded_label) ---------------------------------

_label_sets: dict[str, set] = {}
_label_sets_lock = threading.Lock()

# overflow bucket for values past the per-family top-K
OTHER_LABEL = "_other"


def bounded_label(family: str, value: str, k: int = 32) -> str:
    """Admit the first `k` distinct values of `family` verbatim; map
    everything after to OTHER_LABEL. First-come-first-kept: in a stable
    deployment the long-lived peers/validators claim the slots, and churn
    lands in the overflow bucket instead of new series. Counters and
    histograms may aggregate into OTHER_LABEL (additive semantics);
    GAUGE callers should skip recording when they get OTHER_LABEL back —
    a last-write-wins series shared by unrelated values flaps."""
    value = str(value)
    with _label_sets_lock:
        seen = _label_sets.setdefault(family, set())
        if value in seen:
            return value
        if len(seen) < k:
            seen.add(value)
            return value
    return OTHER_LABEL


def _escape_label(v) -> str:
    """Label-value escaping per the text exposition format v0.0.4:
    backslash, double-quote, and newline must be escaped."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(names, values, extra: str = "") -> str:
    pairs = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    )
    if extra:
        pairs = f"{pairs},{extra}" if pairs else extra
    if not pairs:
        return ""
    return "{%s}" % pairs


class Counter:
    def __init__(
        self,
        name: str,
        help_: str,
        labels: tuple[str, ...] = (),
        max_series: int = MAX_LABEL_SERIES,
    ):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self.max_series = max_series
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _admit(self, key: tuple) -> None:
        """Under self._lock: refuse a NEW label tuple past the cap."""
        if (
            self.label_names
            and key not in self._values
            and len(self._values) >= self.max_series
        ):
            raise MetricCardinalityError(self.name, self.max_series, key)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(k, "") for k in self.label_names)
        with self._lock:
            self._admit(key)
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(labels.get(k, "") for k in self.label_names)
        return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum across every label series (the health monitor reads a
        labeled gauge family — e.g. verify_queue_depth{klass=} — as one
        scalar)."""
        with self._lock:
            return sum(self._values.values())

    def render(self) -> list[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} counter",
        ]
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(self.label_names, key)} {v}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class _InProgress:
    """Context manager behind Gauge.track_inprogress: inc on enter, dec
    on exit — replaces hand-rolled try/inc/finally/dec blocks around
    in-flight work (scheduler queue, commit-pipeline depth)."""

    __slots__ = ("_gauge", "_amount", "_labels")

    def __init__(self, gauge: "Gauge", amount: float, labels: dict):
        self._gauge = gauge
        self._amount = amount
        self._labels = labels

    def __enter__(self) -> "_InProgress":
        self._gauge.inc(self._amount, **self._labels)
        return self

    def __exit__(self, *exc) -> None:
        self._gauge.dec(self._amount, **self._labels)


class Gauge(Counter):
    def set(self, value: float, **labels) -> None:
        key = tuple(labels.get(k, "") for k in self.label_names)
        with self._lock:
            self._admit(key)
            self._values[key] = value

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def track_inprogress(
        self, amount: float = 1.0, **labels
    ) -> _InProgress:
        """Count work in flight for the duration of a with-block."""
        return _InProgress(self, amount, labels)

    def render(self) -> list[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} gauge",
        ]
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(self.label_names, key)} {v}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out


class _Series:
    __slots__ = ("counts", "sum", "total")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.total = 0


class Histogram:
    """Histogram, optionally labeled: one cumulative-bucket series per
    label-value tuple (`consensus_step_duration_seconds{step="propose"}`
    and {step="prevote"} share this object)."""

    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, float("inf")
    )

    def __init__(
        self,
        name: str,
        help_: str,
        buckets=None,
        labels: tuple[str, ...] = (),
        max_series: int = MAX_LABEL_SERIES,
    ):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.label_names = tuple(labels)
        self.max_series = max_series
        self._series: dict[tuple, _Series] = {}
        self._lock = threading.Lock()
        if not self.label_names:
            # unlabeled histograms expose zeroed buckets before the first
            # observation (back-compat with the original single-series
            # render)
            self._series[()] = _Series(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(k, "") for k in self.label_names)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if (
                    self.label_names
                    and len(self._series) >= self.max_series
                ):
                    raise MetricCardinalityError(
                        self.name, self.max_series, key
                    )
                s = self._series[key] = _Series(len(self.buckets))
            s.sum += value
            s.total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s.counts[i] += 1

    def count(self, **labels) -> int:
        """Observation count for one series ("" defaults per label)."""
        key = tuple(labels.get(k, "") for k in self.label_names)
        s = self._series.get(key)
        return s.total if s is not None else 0

    def series(self, **labels) -> dict:
        """Snapshot of one label series: cumulative bucket counts, sum,
        total. The health monitor (obs/health.py) reads interval DELTAS
        of these to turn a histogram into an SLO event stream (fraction
        of observations above a bucket boundary) without a per-sample
        push seam."""
        key = tuple(labels.get(k, "") for k in self.label_names)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return {
                    "buckets": self.buckets,
                    "counts": [0] * len(self.buckets),
                    "count": 0,
                    "sum": 0.0,
                }
            return {
                "buckets": self.buckets,
                "counts": list(s.counts),
                "count": s.total,
                "sum": s.sum,
            }

    def total_count(self) -> int:
        """Observation count across ALL label series."""
        with self._lock:
            return sum(s.total for s in self._series.values())

    def sum_value(self, **labels) -> float:
        key = tuple(labels.get(k, "") for k in self.label_names)
        s = self._series.get(key)
        return s.sum if s is not None else 0.0

    def time(self, **labels):
        """Context manager observing elapsed seconds."""
        h = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                h.observe(time.perf_counter() - self.t0, **labels)

        return _T()

    def render(self) -> list[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            for key in sorted(self._series):
                s = self._series[key]
                for b, c in zip(self.buckets, s.counts):
                    le = "+Inf" if b == float("inf") else repr(b)
                    le_pair = 'le="%s"' % le
                    out.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(self.label_names, key, le_pair)} {c}"
                    )
                lbl = _fmt_labels(self.label_names, key)
                out.append(f"{self.name}_sum{lbl} {s.sum}")
                out.append(f"{self.name}_count{lbl} {s.total}")
        return out


class Registry:
    def __init__(self, namespace: str = "tendermint"):
        self.namespace = namespace
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()
        # render-time refresh hooks: process-level gauges (RSS, fds,
        # threads) are point-in-time reads, so they refresh at scrape
        # instead of on a sampling loop (the prometheus-client
        # collector pattern). A raising collector is dropped from the
        # render, never propagated — /metrics must not 500 because
        # /proc grew a new format.
        self._collectors: list = []

    def add_collector(self, fn) -> None:
        """Register fn() to run at the start of every render()."""
        with self._lock:
            self._collectors.append(fn)

    def counter(self, name, help_="", labels=(), raw=False) -> Counter:
        return self._get(
            name, Counter, lambda n: Counter(n, help_, labels), raw=raw
        )

    def gauge(self, name, help_="", labels=(), raw=False) -> Gauge:
        return self._get(
            name, Gauge, lambda n: Gauge(n, help_, labels), raw=raw
        )

    def histogram(
        self, name, help_="", buckets=None, labels=(), raw=False
    ) -> Histogram:
        return self._get(
            name, Histogram, lambda n: Histogram(n, help_, buckets, labels),
            raw=raw,
        )

    def _get(self, name, kind, factory, raw=False):
        # raw=True skips the namespace prefix: cross-ecosystem
        # conventional names (process_*, tm_health_status) must render
        # verbatim or dashboards/alert rules built against the
        # convention miss them
        full = name if raw else f"{self.namespace}_{name}"
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = self._metrics[full] = factory(full)
            elif type(m) is not kind:
                # exact-type check: Gauge subclasses Counter, so an
                # isinstance test would silently hand a Gauge to a
                # counter("x") call (and the original dict.get handed
                # ANY prior registrant to ANY later kind)
                raise TypeError(
                    f"metric {full!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}"
                )
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


_registry: Optional[Registry] = None


def default_registry() -> Registry:
    global _registry
    if _registry is None:
        _registry = Registry()
    return _registry


# --- the standard node metric set (consensus/metrics.go:23 et al.) --------


class ConsensusMetrics:
    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.height = reg.gauge("consensus_height", "Current block height")
        self.rounds = reg.counter(
            "consensus_rounds", "Rounds entered beyond round 0"
        )
        self.round_gauge = reg.gauge(
            "consensus_round", "Current consensus round"
        )
        self.validators = reg.gauge(
            "consensus_validators", "Validator set size"
        )
        self.block_interval = reg.histogram(
            "consensus_block_interval_seconds",
            "Time between this and the last block",
        )
        self.total_txs = reg.counter("consensus_total_txs", "Committed txs")
        self.votes_verified = reg.counter(
            "consensus_votes_verified", "Vote signatures verified", ("path",)
        )
        self.verify_batch_size = reg.histogram(
            "consensus_verify_batch_size",
            "Signatures per device verify batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 512, 2048, float("inf")),
        )
        # --- the per-step latency surface (reference metricsgen
        # StepDurationSeconds) -------------------------------------------
        self.step_duration = reg.histogram(
            "consensus_step_duration_seconds",
            "Time at each consensus step before transitioning",
            labels=("step",),
        )
        self.proposal_create_seconds = reg.histogram(
            "consensus_proposal_create_seconds",
            "Time building + sealing a proposal block",
        )
        self.commit_seconds = reg.histogram(
            "consensus_commit_seconds",
            "finalizeCommit wall time (save + WAL barrier + apply)",
        )
        self.block_store_save_seconds = reg.histogram(
            "consensus_block_store_save_seconds",
            "Block-store save_block wall time at commit",
        )
        self.wal_fsync_seconds = reg.histogram(
            "consensus_wal_fsync_seconds",
            "WAL fsync wall time",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                     float("inf")),
        )
        self.block_size_bytes = reg.histogram(
            "consensus_block_size_bytes",
            "Committed block size",
            buckets=(1024, 4096, 16384, 65536, 262144, 1048576, 4194304,
                     float("inf")),
        )
        self.block_parts = reg.counter(
            "consensus_block_parts", "Block parts received"
        )
        self.quorum_prevote_delay = reg.histogram(
            "consensus_quorum_prevote_delay_seconds",
            "Prevote-step start to +2/3 prevotes observed",
        )
        # --- commit pipeline (consensus/commit_pipeline.py) --------------
        self.commit_pipeline_depth = reg.gauge(
            "consensus_commit_pipeline_depth",
            "Background finalizations in flight (0 or 1)",
        )
        self.commit_pipeline_wait_seconds = reg.histogram(
            "consensus_commit_pipeline_wait_seconds",
            "Time consumers of apply results waited on the app-hash "
            "future (the pipeline's observable critical-path cost)",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                     1.0, float("inf")),
        )
        self.wal_group_fsync_records = reg.histogram(
            "consensus_wal_group_fsync_records",
            "WAL records covered per group-commit fsync",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, float("inf")),
        )
        # --- quorum-latency attribution (obs/cluster.py) ------------------
        # arrival lag is measured from the ROUND'S FIRST VOTE of that
        # type, so it isolates vote-spread from proposal latency
        self.vote_arrival_lag = reg.histogram(
            "consensus_vote_arrival_lag_seconds",
            "Per-vote arrival lag behind the round's first vote of the "
            "same type",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, float("inf")),
            labels=("type",),
        )
        self.quorum_close_lag = reg.histogram(
            "consensus_quorum_close_lag_seconds",
            "First vote of the round to the vote that closed 2/3",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, float("inf")),
            labels=("type",),
        )
        self.quorum_closer = reg.counter(
            "consensus_quorum_closer_total",
            "Times a validator's vote closed the 2/3 quorum",
            ("validator", "type"),
        )
        # --- adaptive pacing (consensus/pacing.py) ------------------------
        self.adaptive_timeout = reg.gauge(
            "consensus_adaptive_timeout_seconds",
            "Per-step timeout schedule in effect (learned-or-backed-off "
            "at round 0, the static escalation at rounds > 0); only "
            "exported while adaptive pacing is enabled",
            ("step",),
        )
        self.pacing_backoff = reg.gauge(
            "consensus_pacing_backoff",
            "AIMD back-off level per step: 0 = fully on the learned "
            "arrival tail, 1 = static config schedule",
            ("step",),
        )
        self.pacing_timeouts_fired = reg.counter(
            "consensus_pacing_timeouts_fired_total",
            "Non-stale step timeouts that actually expired (each one is "
            "a pacing failure signal that backs the controller off)",
            ("step",),
        )
        # --- committee-scale vote plane (consensus/reactor.py) ------------
        # gossip efficiency: ticks that shipped >= 1 vote, and votes
        # shipped — votes/tick is the one-vote-per-tick baseline's 1.0
        # lifted toward vote_batch_max by VoteBatchMessage chunks
        self.vote_gossip_ticks = reg.counter(
            "consensus_vote_gossip_ticks_total",
            "Vote-gossip loop passes that sent at least one vote",
        )
        self.vote_gossip_votes = reg.counter(
            "consensus_vote_gossip_votes_total",
            "Votes shipped by the vote-gossip routines (all peers)",
        )
        self.vote_batch_size = reg.histogram(
            "consensus_vote_batch_size",
            "Votes per VoteBatchMessage chunk shipped",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, float("inf")),
        )
        self.proposal_gossip_seconds = reg.histogram(
            "consensus_proposal_gossip_seconds",
            "Proposer's proposal timestamp to our receipt, per sending "
            "peer (includes the proposer-peer clock offset; read with "
            "p2p_peer_clock_offset_seconds)",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     float("inf")),
            labels=("peer",),
        )


class P2PMetrics:
    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.peers = reg.gauge("p2p_peers", "Connected peers")
        self.message_receive_bytes = reg.counter(
            "p2p_message_receive_bytes_total", "Bytes received", ("chID",)
        )
        self.message_send_bytes = reg.counter(
            "p2p_message_send_bytes_total", "Bytes sent", ("chID",)
        )
        self.send_queue_depth = reg.gauge(
            "p2p_send_queue_depth", "Per-channel send-queue depth", ("chID",)
        )
        self.send_queue_full = reg.counter(
            "p2p_send_queue_full_total",
            "Messages rejected by a full send queue",
            ("chID",),
        )
        self.send_stall_seconds = reg.counter(
            "p2p_send_stall_seconds_total",
            "Time the send routine spent rate-throttled",
        )
        # NTP-style estimates from the timestamped ping/pong keepalive
        # (mconn.py); peer labels go through bounded_label()
        self.peer_clock_offset = reg.gauge(
            "p2p_peer_clock_offset_seconds",
            "Estimated peer wall-clock offset (peer minus us), EWMA",
            ("peer",),
        )
        self.peer_rtt = reg.gauge(
            "p2p_peer_rtt_seconds",
            "Estimated peer round-trip time, EWMA",
            ("peer",),
        )


class BlocksyncMetrics:
    """blocksync/metrics.go: Syncing, LatestBlockHeight + the pool's
    request/response health."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.syncing = reg.gauge(
            "blocksync_syncing", "1 while block-syncing, else 0"
        )
        self.latest_block_height = reg.gauge(
            "blocksync_latest_block_height", "Height of the latest applied block"
        )
        self.blocks_applied = reg.counter(
            "blocksync_blocks_applied_total", "Blocks applied by blocksync"
        )
        self.block_response_seconds = reg.histogram(
            "blocksync_block_response_seconds",
            "Block request to response latency",
        )
        self.request_timeouts = reg.counter(
            "blocksync_request_timeouts_total", "Block requests that timed out"
        )
        self.peers_banned = reg.counter(
            "blocksync_peers_banned_total", "Peers banned by the pool"
        )


class StateSyncMetrics:
    """statesync/metrics.go: Syncing, SnapshotHeight, chunk health."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.syncing = reg.gauge(
            "statesync_syncing", "1 while state-syncing, else 0"
        )
        self.snapshot_height = reg.gauge(
            "statesync_snapshot_height", "Height of the snapshot being restored"
        )
        self.chunks_fetched = reg.counter(
            "statesync_chunks_fetched_total", "Snapshot chunks received"
        )
        self.chunk_retries = reg.counter(
            "statesync_chunk_retries_total", "Snapshot chunk refetches"
        )
        self.chunk_response_seconds = reg.histogram(
            "statesync_chunk_response_seconds",
            "Chunk request to response latency",
        )


class RPCMetrics:
    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.requests = reg.counter(
            "rpc_requests_total", "JSON-RPC requests served", ("method",)
        )
        self.request_errors = reg.counter(
            "rpc_request_errors_total", "JSON-RPC error responses", ("method",)
        )
        self.request_duration = reg.histogram(
            "rpc_request_duration_seconds",
            "JSON-RPC handler wall time",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                     float("inf")),
            labels=("method",),
        )


class SchedulerMetrics:
    """parallel/scheduler.py — the unified verification dispatch
    scheduler's queue/coalescing health, so the flight recorder and
    Prometheus can attribute queue wait vs device time."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.queue_depth = reg.gauge(
            "verify_queue_depth",
            "Signature items in flight in the dispatch scheduler "
            "(submitted, verdicts not yet resolved)",
            ("klass",),
        )
        self.batch_fill_ratio = reg.gauge(
            "verify_batch_fill_ratio",
            "items/bucket of the most recent coalesced device dispatch",
        )
        self.dispatches = reg.counter(
            "verify_dispatches_total",
            "Device verify rounds dispatched by the scheduler",
        )
        self.dispatch_coalesced = reg.counter(
            "verify_dispatch_coalesced_total",
            "Dispatches that merged >= 2 submissions into one batch",
        )
        self.queue_wait_seconds = reg.histogram(
            "verify_queue_wait_seconds",
            "Submission enqueue to device-dispatch wait",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                     float("inf")),
        )
        self.mesh_devices = reg.gauge(
            "verify_mesh_devices",
            "Devices in the verify mesh the scheduler dispatches over "
            "(1 = single-device / no mesh)",
        )
        self.dispatch_sharded = reg.counter(
            "verify_dispatch_sharded_total",
            "Device verify rounds row-sharded across > 1 mesh device",
        )
        # --- device-cost ledger surface (obs/ledger.py): raw tm_* names
        # are the contract the capacity dashboards key on — per-class
        # device-time shares and fill efficiency are the numbers that
        # price the accelerator (the verify-as-a-service billing seam)
        self.device_seconds = reg.counter(
            "tm_scheduler_device_seconds_total",
            "Device-execute seconds attributed per submitter class "
            "(a coalesced round's wall splits by row share)",
            ("klass",),
            raw=True,
        )
        self.fill_ratio = reg.gauge(
            "tm_scheduler_fill_ratio",
            "rows-requested / rows-dispatched of the most recent round "
            "that carried this class (1.0 = no padding waste); sig-plane "
            "rounds only — fn engines report tm_scheduler_fn_fill_ratio",
            ("klass",),
            raw=True,
        )
        self.fn_fill_ratio = reg.gauge(
            "tm_scheduler_fn_fill_ratio",
            "items / true internal bucket of the most recent fn-lane "
            "round per engine (fn engines pad internally; kept off "
            "tm_scheduler_fill_ratio so the two planes never blend)",
            ("engine",),
            raw=True,
        )
        self.padding_rows = reg.counter(
            "tm_scheduler_padding_rows_total",
            "Padded bucket rows dispatched beyond the rows requested "
            "(device work bought by shape discipline and discarded)",
            raw=True,
        )


class RemoteSchedulerMetrics:
    """parallel/verify_service.py — the RemoteVerifyScheduler client's
    IPC health: how much verify work went over the wire, how often the
    client fell back to local dispatch (the degradation contract made
    countable), and the submit->verdict round-trip distribution the
    ipc_round_trip health detector judges for drift. Raw tm_* names
    like the device-cost surface — the verify-service capacity
    dashboards key on them."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.submissions = reg.counter(
            "tm_verify_remote_submissions_total",
            "Submissions shipped to the verify service over IPC",
            ("klass",),
            raw=True,
        )
        self.degrades = reg.counter(
            "tm_verify_remote_degrades_total",
            "Submissions resolved by the LOCAL fallback verifier "
            "(service unreachable or socket died mid-flight)",
            raw=True,
        )
        self.reconnects = reg.counter(
            "tm_verify_remote_reconnects_total",
            "Successful (re)attachments to the verify service socket",
            raw=True,
        )
        self.rtt_seconds = reg.histogram(
            "tm_verify_remote_rtt_seconds",
            "Submit->verdict IPC round trip (queue wait + device round "
            "+ wire overhead as the client experiences it)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                     float("inf")),
            raw=True,
        )


class LightServeMetrics:
    """tendermint_tpu_torch/lightserve — the light-client serving plane's
    proof-cache and shared-verify health (hit rate and dedup rate are
    the two numbers that say whether a thousand clients cost a thousand
    assemblies/verifies or a handful)."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.cache_hits = reg.counter(
            "lightserve_cache_hits_total",
            "Light-block proof-cache hits",
        )
        self.cache_misses = reg.counter(
            "lightserve_cache_misses_total",
            "Light-block proof-cache misses (fresh assembly)",
        )
        self.cache_size = reg.gauge(
            "lightserve_cache_size", "Cached light-block proofs"
        )
        self.cache_assemble_seconds = reg.histogram(
            "lightserve_cache_assemble_seconds",
            "LightBlock assembly from the block/state stores",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                     float("inf")),
        )
        self.verify_requests = reg.counter(
            "lightserve_verify_requests_total",
            "Client verification requests into the serve verifier",
            ("kind",),
        )
        self.verify_deduped = reg.counter(
            "lightserve_verify_deduped_total",
            "Requests that rode an in-flight or recent identical "
            "verification instead of running their own",
            ("kind",),
        )
        self.verify_executed = reg.counter(
            "lightserve_verify_executed_total",
            "Distinct verifications actually executed",
            ("kind",),
        )


class SequencerMetrics:
    """tendermint_tpu_torch/sequencer — the post-upgrade BlockV2 streaming
    plane. Apply latency (receipt -> applied) is the number that says
    whether the plane is event-driven or riding the polling fallback;
    the fanout counters say whether a slow subscriber defers (healthy)
    or stalls (regression) the broadcast drain."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.height = reg.gauge(
            "sequencer_height", "Latest applied BlockV2 height"
        )
        self.blocks_applied = reg.counter(
            "sequencer_blocks_applied_total", "BlockV2s applied"
        )
        self.blocks_broadcast = reg.counter(
            "sequencer_blocks_broadcast_total",
            "Origin broadcasts drained from the production queue",
        )
        self.apply_latency = reg.histogram(
            "sequencer_apply_latency_seconds",
            "Gossip/sync receipt to local apply (the event-driven plane "
            "replaces the 10 s polling floor here)",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                     5.0, 15.0, float("inf")),
        )
        self.fanout_sends = reg.counter(
            "sequencer_fanout_sends_total",
            "Block gossip messages accepted into peer send queues",
        )
        self.fanout_deferred = reg.counter(
            "sequencer_fanout_deferred_total",
            "Fan-out sends skipped on a full 0x50 send queue and queued "
            "for revisit (backpressure, not blocking)",
        )
        self.fanout_dropped = reg.counter(
            "sequencer_fanout_dropped_total",
            "Deferred fan-out entries dropped (revisit budget exceeded "
            "or peer departed; the peer catches up on the sync channel)",
        )
        self.pending_blocks = reg.gauge(
            "sequencer_pending_blocks", "Blocks parked in the pending cache"
        )
        self.catchup_requests = reg.counter(
            "sequencer_catchup_requests_total",
            "Missing-height requests sent on the 0x51 sync channel",
        )
        self.requests_expired = reg.counter(
            "sequencer_requests_expired_total",
            "Requested heights expired (NoBlockResponse, peer departure, "
            "or TTL) and made re-requestable",
        )


class HealthMetrics:
    """tendermint_tpu_torch/obs/health.py — the live health plane's verdict
    surface. Raw names (no namespace prefix): `tm_health_status` and
    `tm_slo_burn_rate` are the contract alert rules key on."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.status = reg.gauge(
            "tm_health_status",
            "Per-subsystem health verdict: 0 = ok, 1 = warn, 2 = critical",
            ("subsystem",),
            raw=True,
        )
        self.burn_rate = reg.gauge(
            "tm_slo_burn_rate",
            "Long-window error-budget burn rate per SLO (1.0 = burning "
            "exactly the budget; sustained > 1 exhausts it)",
            ("slo",),
            raw=True,
        )
        self.incidents = reg.counter(
            "tm_health_incidents_total",
            "Health-detector verdict transitions (any direction)",
            ("subsystem",),
            raw=True,
        )


class ProcessMetrics:
    """Process-level runtime gauges (prometheus process_* conventions)
    plus the event-loop-lag histogram fed by the health monitor's
    heartbeat probe. The gauges refresh at scrape time via a registry
    collector — /proc/self reads on Linux, best-effort elsewhere."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.rss_bytes = reg.gauge(
            "process_resident_memory_bytes",
            "Resident set size of this process",
            raw=True,
        )
        self.open_fds = reg.gauge(
            "process_open_fds",
            "Open file descriptors held by this process",
            raw=True,
        )
        self.threads = reg.gauge(
            "process_threads", "Live threads in this process", raw=True
        )
        self.event_loop_lag = reg.histogram(
            "tm_event_loop_lag_seconds",
            "Scheduling overshoot of the health monitor's monotonic "
            "heartbeat task (how late the event loop runs a due "
            "callback; the event-loop-bound regime made visible)",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, float("inf")),
            raw=True,
        )
        reg.add_collector(self.collect)

    def collect(self) -> None:
        """Refresh the point-in-time gauges (called at render)."""
        self.threads.set(threading.active_count())
        try:
            import os as _os

            self.open_fds.set(len(_os.listdir("/proc/self/fd")))
        except OSError:
            pass
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            import resource as _resource

            self.rss_bytes.set(pages * _resource.getpagesize())
        except (OSError, ValueError, ImportError, IndexError):
            try:
                import resource as _resource
                import sys as _sys

                # ru_maxrss is KiB on Linux but bytes on macOS; a peak,
                # not current — the fallback when /proc is unavailable
                scale = 1 if _sys.platform == "darwin" else 1024
                self.rss_bytes.set(
                    _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
                    * scale
                )
            except Exception:
                pass


class EvidenceMetrics:
    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or default_registry()
        self.pool_size = reg.gauge(
            "evidence_pool_size", "Pending evidence in the pool"
        )
        self.pool_added = reg.counter(
            "evidence_pool_added_total", "Evidence verified into the pool"
        )
        self.pool_committed = reg.counter(
            "evidence_pool_committed_total", "Evidence marked committed"
        )


# one shared instance per metric-set class on the default registry, for
# seams (p2p conn, blocksync pool, chunk queue, evidence pool) that are
# constructed far from node assembly and aren't handed a registry
_default_sets: dict[type, object] = {}
_default_sets_lock = threading.Lock()


def default_metrics(cls):
    inst = _default_sets.get(cls)
    if inst is None:
        with _default_sets_lock:
            inst = _default_sets.get(cls)
            if inst is None:
                inst = _default_sets[cls] = cls(default_registry())
    return inst


class MetricsServer(Service):
    """Serves GET/HEAD /metrics in the text exposition format; anything
    else is 404 (the original served the registry for EVERY path and
    verb)."""

    def __init__(self, registry: Registry, host: str, port: int):
        super().__init__("metrics")
        self.registry = registry
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def on_start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def on_stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            req_line = await reader.readline()
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            try:
                method, target, _ = req_line.decode().strip().split(" ", 2)
            except (ValueError, UnicodeDecodeError):
                return
            path = target.split("?", 1)[0]
            if path != "/metrics":
                self._respond(writer, 404, b"not found\n")
            elif method == "GET":
                self._respond(writer, 200, self.registry.render().encode())
            elif method == "HEAD":
                self._respond(
                    writer, 200, self.registry.render().encode(), head=True
                )
            else:
                self._respond(writer, 405, b"method not allowed\n")
            await writer.drain()
        finally:
            writer.close()

    @staticmethod
    def _respond(writer, status: int, body: bytes, head: bool = False) -> None:
        reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed"}[
            status
        ]
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            "Content-Type: text/plain; version=0.0.4\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n".encode() + (b"" if head else body)
        )
