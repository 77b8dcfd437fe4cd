"""Observability: span tracing, flight recorder, latency attribution.

The layer every perf PR is judged against. Stdlib only. Module map —
the end-to-end trace path runs top to bottom:

- `tracer.py` — the recording seam: thread-safe span ring over
  perf_counter with a wall anchor, process default via
  `default_tracer()`, plus the consensus `set_height_hint` the remote
  verify client reads when stamping wire trace context.
- `report.py` — single-node analysis over record dicts: per-span
  `attribution`, step-bucket `wall_attribution`, and the exhaustive
  `wall_conservation` audit (every height's wall decomposed into
  mutually-exclusive named buckets — step compute / gossip / timeout
  floor / verify IPC·queue·device / WAL fsync / commit pipeline — with
  the residue booked as `dark_time`).
- `parallel/verify_service.py` (not in this package, but on the path):
  node processes stamp span context onto each UDS submission; the
  service records `verify.queue`/`verify.device`/`verify.service`
  sub-spans under it into its OWN ring, served at GET /dump_traces on
  the stats port.
- `cluster.py` — the merge: per-validator `dump_traces` dumps (NTP
  peer-graph offsets, wall-anchor fallback for nodes — and the verify
  service — outside the graph) onto one timeline; `verify_flow` joins
  client round trips to service sub-spans across the process split.
- `health.py` — live verdicts over the same seams, including the
  `dark_time` detector that pages when conservation finds unowned wall
  time.
- `ledger.py` / `quantile.py` / `profiler.py` — device-cost
  accounting, the streaming quantile sketch, on-demand profiling.
"""

from .cluster import (
    cluster_report,
    estimate_offsets,
    link_latencies,
    merge_records,
    normalize_dump,
    report_text,
    verify_flow,
)
from .health import (
    CRITICAL,
    OK,
    VERDICT_NAMES,
    WARN,
    BurnRateSLO,
    HealthMonitor,
)
from .ledger import (
    DispatchLedger,
    default_ledger,
    set_default_ledger,
)
from .profiler import ProfileCapture, ProfilerUnavailable
from .quantile import StreamingQuantile
from .report import (
    CONSERVATION_BUCKETS,
    CONSERVATION_SCHEMA,
    FAMILY_WALL_SPANS,
    ascii_timeline,
    attribution,
    attribution_table,
    check_conservation,
    conservation_table,
    pacing_decisions,
    side_by_side_timeline,
    wall_attribution,
    wall_conservation,
)
from .tracer import (
    DEFAULT_RING_SIZE,
    SpanRecord,
    Tracer,
    default_tracer,
    flight_snapshot,
    height_hint,
    set_default_tracer,
    set_height_hint,
)

__all__ = [
    "CONSERVATION_BUCKETS",
    "CONSERVATION_SCHEMA",
    "CRITICAL",
    "DEFAULT_RING_SIZE",
    "FAMILY_WALL_SPANS",
    "OK",
    "VERDICT_NAMES",
    "WARN",
    "BurnRateSLO",
    "DispatchLedger",
    "HealthMonitor",
    "ProfileCapture",
    "ProfilerUnavailable",
    "SpanRecord",
    "StreamingQuantile",
    "Tracer",
    "ascii_timeline",
    "attribution",
    "attribution_table",
    "check_conservation",
    "cluster_report",
    "conservation_table",
    "default_ledger",
    "default_tracer",
    "estimate_offsets",
    "flight_snapshot",
    "height_hint",
    "link_latencies",
    "merge_records",
    "normalize_dump",
    "pacing_decisions",
    "report_text",
    "set_default_ledger",
    "set_default_tracer",
    "set_height_hint",
    "side_by_side_timeline",
    "verify_flow",
    "wall_attribution",
    "wall_conservation",
]
