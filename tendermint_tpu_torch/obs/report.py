"""Latency attribution + ASCII timelines over tracer dumps.

`attribution` answers "where does a height's time go" in aggregate
(p50/p95 per span name); `ascii_timeline` renders one run's flight
recorder as a per-height step table — the artifact soak.py ships with a
diverging seed and tools/trace_report.py renders from a dump file.

Operates on plain record dicts (`SpanRecord.to_json()` shape) so it can
consume a `dump_traces` RPC response or a JSON file equally.
"""

from __future__ import annotations

from .tracer import SpanRecord, flight_snapshot

# consensus step spans in canonical order (state_machine Step enum)
STEP_ORDER = (
    "cs.new_height",
    "cs.new_round",
    "cs.propose",
    "cs.prevote",
    "cs.prevote_wait",
    "cs.precommit",
    "cs.precommit_wait",
    "cs.commit",
)


def pct(xs: list[float], q: float) -> float:
    """Index-based percentile (0 on empty) — the one implementation the
    attribution tables, cluster reports, and bench artifacts share."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


_pct = pct


def attribution(records: list[dict]) -> dict:
    """Per-span-name p50/p95/max duration (ms) + count over span records.
    The bench/soak artifacts attach this so a throughput scalar comes
    with its breakdown."""
    durs: dict[str, list[float]] = {}
    heights = set()
    for r in records:
        if r.get("kind") != "span":
            continue
        durs.setdefault(r["name"], []).append(r.get("dur", 0.0) * 1e3)
        if r.get("height"):
            heights.add(r["height"])

    def key(name: str):
        return (
            STEP_ORDER.index(name) if name in STEP_ORDER else len(STEP_ORDER),
            name,
        )

    return {
        "heights": len(heights),
        "steps": {
            name: {
                "count": len(ds),
                "p50_ms": round(_pct(ds, 0.5), 3),
                "p95_ms": round(_pct(ds, 0.95), 3),
                "max_ms": round(max(ds), 3),
            }
            for name, ds in sorted(durs.items(), key=lambda kv: key(kv[0]))
        },
    }


# wall-per-height attribution buckets (tools/pacing_report.py + the
# consensus_pacing/committee_scale/sequencer_stream bench families).
# For the consensus family the cs.* step spans partition a height's
# wall clock by construction (each closes at the transition to the
# next), so bucketing THEM — not the nested exec/store spans, which
# would double-count — splits wall time into:
#   floor   — steps that exist to wait out a timeout window
#   gossip  — steps spent waiting on peers (proposal parts, votes)
#   compute — the decision/finalize step itself
# The sequencer family maps the post-upgrade streaming plane's seq.*
# spans (broadcast_reactor.py) the same way: parked fallback waits are
# the floor, catchup/fan-out the gossip bucket, apply/verify compute.
# committee_scale nets run the same cs.* state machine, so they share
# the consensus classification.
WALL_FLOOR_SPANS = frozenset(
    {"cs.new_height", "cs.prevote_wait", "cs.precommit_wait"}
)
WALL_GOSSIP_SPANS = frozenset({"cs.propose", "cs.prevote", "cs.precommit"})
WALL_COMPUTE_SPANS = frozenset({"cs.commit", "cs.new_round"})

# family name -> (floor, gossip, compute) span sets. "consensus" also
# serves the committee_scale bench family; "sequencer" covers the
# BlockV2 streaming plane (heights there are V2/L2 heights).
FAMILY_WALL_SPANS: dict[str, tuple[frozenset, frozenset, frozenset]] = {
    "consensus": (WALL_FLOOR_SPANS, WALL_GOSSIP_SPANS, WALL_COMPUTE_SPANS),
    "sequencer": (
        frozenset({"seq.park"}),
        frozenset({"seq.broadcast", "seq.sync_gap"}),
        frozenset({"seq.apply"}),
    ),
}


def wall_attribution(
    records: list[dict], n_heights: int = 64, family: str = "consensus"
) -> dict:
    """Per-height wall-clock attribution: how much of each height went
    to the timeout floor vs gossip waits vs compute, from one node's
    trace records (SpanRecord.to_json dicts). `family` selects the span
    classification (FAMILY_WALL_SPANS); `other` is the residue of
    the height window not covered by step spans (ring-boundary effects,
    records from other subsystems widening the window)."""
    try:
        floor_spans, gossip_spans, compute_spans = FAMILY_WALL_SPANS[family]
    except KeyError:
        raise ValueError(
            f"unknown wall-attribution family {family!r}; known: "
            f"{sorted(FAMILY_WALL_SPANS)}"
        ) from None
    recs = [SpanRecord.from_json(r) for r in records]
    flight = flight_snapshot(recs, n_heights)
    heights: dict[int, dict] = {}
    for h, rows in flight.items():
        t0 = min(r["t0"] for r in rows)
        t1 = max(r["t0"] + r.get("dur", 0.0) for r in rows)
        wall = t1 - t0
        buckets = {"floor": 0.0, "gossip": 0.0, "compute": 0.0}
        for r in rows:
            if r["kind"] != "span":
                continue
            name = r["name"]
            if name in floor_spans:
                buckets["floor"] += r.get("dur", 0.0)
            elif name in gossip_spans:
                buckets["gossip"] += r.get("dur", 0.0)
            elif name in compute_spans:
                buckets["compute"] += r.get("dur", 0.0)
        covered = sum(buckets.values())
        heights[h] = {
            "wall_ms": round(wall * 1e3, 3),
            "floor_ms": round(buckets["floor"] * 1e3, 3),
            "gossip_ms": round(buckets["gossip"] * 1e3, 3),
            "compute_ms": round(buckets["compute"] * 1e3, 3),
            "other_ms": round(max(0.0, wall - covered) * 1e3, 3),
        }
    if not heights:
        return {"heights": {}, "aggregate": {}}
    walls = [v["wall_ms"] for v in heights.values()]
    floor = sum(v["floor_ms"] for v in heights.values())
    gossip = sum(v["gossip_ms"] for v in heights.values())
    compute = sum(v["compute_ms"] for v in heights.values())
    total = sum(walls)
    return {
        "heights": heights,
        "aggregate": {
            "n_heights": len(heights),
            "wall_ms_p50": round(pct(walls, 0.5), 3),
            "wall_ms_p95": round(pct(walls, 0.95), 3),
            "wall_ms_max": round(max(walls), 3),
            "floor_share": round(floor / total, 4) if total else 0.0,
            "gossip_share": round(gossip / total, 4) if total else 0.0,
            "compute_share": round(compute / total, 4) if total else 0.0,
        },
    }


# --- wall-clock conservation ------------------------------------------------
#
# wall_attribution above answers "how do the STEP spans split a height";
# wall_conservation answers the stricter question ROADMAP item 4 needs:
# does EVERY slice of a height's measured wall clock have a name? The
# decomposition is mutually exclusive and exhaustive by construction —
# each elementary time segment of the height window is assigned to
# exactly one bucket by a priority sweep — so the buckets plus the
# `dark_time` residue sum to the measured wall exactly (plus the
# explicitly booked `pipeline_overlap_ms` under height pipelining), and
# unexplained latency can never hide inside an "other" that also
# absorbs known overlap error.

CONSERVATION_SCHEMA = "tm-tpu/wall-conservation/v1"

# carve buckets, HIGHEST priority first: a segment covered by several
# span families is charged to the first bucket here that claims it.
# Device time outranks queue wait (the queue_wait span of a round ends
# where its device span begins, but service-side merges can overlap),
# and the client-observed IPC round trip ranks below both so that when
# service sub-spans are present (one merged timeline) the RTT only
# keeps the wire/serialization slice the service can't see.
CONSERVATION_CARVES: tuple[tuple[str, frozenset], ...] = (
    ("verify_device", frozenset({"scheduler.device_round", "verify.device"})),
    ("verify_queue", frozenset({"scheduler.queue_wait", "verify.queue"})),
    ("verify_ipc", frozenset({"verify.ipc"})),
    ("wal_fsync", frozenset({"wal.fsync", "wal.group_fsync"})),
    (
        "commit_pipeline",
        frozenset({"commit.pipeline_wait", "store.save_block"}),
    ),
)

CONSERVATION_BUCKETS = tuple(
    [name for name, _ in CONSERVATION_CARVES]
    + ["floor", "gossip", "compute", "dark_time"]
)

# QC-chained height pipelining (PERF_ANALYSIS §22): height H's
# background finalization — the durability barrier, the apply, the block
# save, the QC pre-assembly, and any consumer blocking on them — runs
# while the state machine's step spans already tile height H+1. Those
# H-tagged spans fall OUTSIDE H's own step window; their out-of-window
# portions are still charged to their carve bucket AND booked as
# `pipeline_overlap_ms`, so per height sum(buckets) == wall + overlap
# (shared wall is attributed to exactly ONE height — the one whose step
# spans tile it — and the overlap credit names the work that rode along
# under it).
OVERLAP_CARVE_OF: dict[str, str] = {
    "wal.pipeline_barrier": "wal_fsync",
    "commit.pipeline_wait": "commit_pipeline",
    "store.save_block": "commit_pipeline",
    "exec.apply_block": "commit_pipeline",
    "commit.qc_assemble": "commit_pipeline",
}

_STEP_SPANS = frozenset(STEP_ORDER)

# derived lookups for the sweep (pure functions of the carve table)
_CARVE_PRIO = {name: i for i, (name, _) in enumerate(CONSERVATION_CARVES)}
_CARVE_OF = {
    span: name for name, spans in CONSERVATION_CARVES for span in spans
}


def _step_bucket(name: str) -> str:
    if name in WALL_FLOOR_SPANS:
        return "floor"
    if name in WALL_GOSSIP_SPANS:
        return "gossip"
    return "compute"


def wall_conservation(records: list[dict], n_heights: int = 64) -> dict:
    """Per-height exhaustive wall-clock decomposition. The height window
    is the span of its cs.* step records (they tile the height by
    construction: `_new_step` closes each at the transition to the
    next); carve spans — verify IPC/queue/device, WAL fsync, the commit
    pipeline wait — claim their segments out of the containing step's
    bucket, the step classification (floor/gossip/compute) takes what
    remains, and any segment covered by NO span at all lands in
    `dark_time`. Out-of-window portions of the height's own background
    spans (OVERLAP_CARVE_OF — pipelined finalization running under a
    neighbor height) are charged to their bucket and booked as
    `pipeline_overlap_ms`. Invariant: sum(buckets) == wall +
    pipeline_overlap per height (float eps; overlap is 0 without
    pipelining, restoring the strict identity); the `conserved` flag in
    the aggregate attests it was checked.
    Accepts record dicts (dump files, RPC responses) or SpanRecord
    objects directly (the health plane's per-tick pull skips the
    serialize/deserialize round trip)."""
    recs = [
        r if isinstance(r, SpanRecord) else SpanRecord.from_json(r)
        for r in records
    ]
    flight = flight_snapshot(recs, n_heights)
    heights: dict[int, dict] = {}
    conserved = True
    for h, rows in flight.items():
        steps = [
            r
            for r in rows
            if r["kind"] == "span" and r["name"] in _STEP_SPANS
        ]
        if not steps:
            continue
        w0 = min(r["t0"] for r in steps)
        w1 = max(r["t0"] + r.get("dur", 0.0) for r in steps)
        wall = w1 - w0
        if wall <= 0:
            continue
        # (start, end, bucket, priority) clipped to the window
        intervals: list[tuple[float, float, str, int]] = []
        for r in rows:
            if r["kind"] != "span":
                continue
            bucket = _CARVE_OF.get(r["name"])
            if bucket is None:
                continue
            s = max(w0, r["t0"])
            e = min(w1, r["t0"] + r.get("dur", 0.0))
            if e > s:
                intervals.append((s, e, bucket, _CARVE_PRIO[bucket]))
        base = len(CONSERVATION_CARVES)
        for r in steps:
            s = max(w0, r["t0"])
            e = min(w1, r["t0"] + r.get("dur", 0.0))
            if e > s:
                intervals.append((s, e, _step_bucket(r["name"]), base))
        # priority sweep over elementary segments: every edge point
        # starts a segment owned by the highest-priority cover (or dark)
        edges = sorted(
            {w0, w1}
            | {iv[0] for iv in intervals}
            | {iv[1] for iv in intervals}
        )
        buckets = {name: 0.0 for name in CONSERVATION_BUCKETS}
        for a, b in zip(edges, edges[1:]):
            cover = [iv for iv in intervals if iv[0] <= a and iv[1] >= b]
            if cover:
                buckets[min(cover, key=lambda iv: iv[3])[2]] += b - a
            else:
                buckets["dark_time"] += b - a
        # out-of-window portions of this height's background spans:
        # pipelined finalization running under a neighbor height's wall.
        # Same priority-sweep discipline so overlapping background spans
        # (pipeline_wait covering apply_block) book each slice once.
        over_iv: list[tuple[float, float, str, int]] = []
        for r in rows:
            if r["kind"] != "span":
                continue
            bucket = OVERLAP_CARVE_OF.get(r["name"])
            if bucket is None:
                continue
            s, e = r["t0"], r["t0"] + r.get("dur", 0.0)
            for os_, oe in ((s, min(e, w0)), (max(s, w1), e)):
                if oe > os_:
                    over_iv.append((os_, oe, bucket, _CARVE_PRIO[bucket]))
        overlap = 0.0
        if over_iv:
            oedges = sorted(
                {iv[0] for iv in over_iv} | {iv[1] for iv in over_iv}
            )
            for a, b in zip(oedges, oedges[1:]):
                cover = [iv for iv in over_iv if iv[0] <= a and iv[1] >= b]
                if cover:
                    buckets[min(cover, key=lambda iv: iv[3])[2]] += b - a
                    overlap += b - a
        total = sum(buckets.values())
        if abs(total - (wall + overlap)) > 1e-6 * max(1.0, wall):
            conserved = False
        heights[h] = {
            "wall_ms": round(wall * 1e3, 3),
            **{
                f"{name}_ms": round(v * 1e3, 3)
                for name, v in buckets.items()
            },
            "pipeline_overlap_ms": round(overlap * 1e3, 3),
            "dark_fraction": round(buckets["dark_time"] / wall, 4),
        }
    if not heights:
        return {
            "schema": CONSERVATION_SCHEMA,
            "heights": {},
            "aggregate": {},
        }
    walls = [v["wall_ms"] for v in heights.values()]
    total_wall = sum(walls)
    shares = {
        f"{name}_share": round(
            sum(v[f"{name}_ms"] for v in heights.values()) / total_wall, 4
        )
        for name in CONSERVATION_BUCKETS
    }
    return {
        "schema": CONSERVATION_SCHEMA,
        "heights": heights,
        "aggregate": {
            "n_heights": len(heights),
            "wall_ms_p50": round(pct(walls, 0.5), 3),
            "wall_ms_p95": round(pct(walls, 0.95), 3),
            "wall_ms_max": round(max(walls), 3),
            **shares,
            "pipeline_overlap_share": round(
                sum(v["pipeline_overlap_ms"] for v in heights.values())
                / total_wall,
                4,
            ),
            "dark_fraction": shares["dark_time_share"],
            "dark_fraction_max": max(
                v["dark_fraction"] for v in heights.values()
            ),
            "conserved": conserved,
        },
    }


def check_conservation(block: dict, tolerance: float = 0.002) -> list[str]:
    """Schema validation for a wall_conservation block (bench artifacts,
    tools/bench_trend.py): every height's buckets must sum to its wall
    within `tolerance` (fractional), and the aggregate must carry the
    dark_fraction fields. Under height pipelining buckets may exceed the
    wall, but only by the explicitly booked `pipeline_overlap_ms` —
    unbooked excess is still a violation. Pre-pipelining artifacts carry
    no overlap key, which reads as 0.0: their check is unchanged.
    Returns a list of violation strings (empty = valid)."""
    errs: list[str] = []
    if not isinstance(block, dict):
        return ["wall_conservation is not an object"]
    agg = block.get("aggregate")
    if not isinstance(agg, dict):
        return ["wall_conservation.aggregate missing"]
    if not agg:
        return []  # empty capture: nothing to conserve
    for key in ("dark_fraction", "n_heights"):
        if key not in agg:
            errs.append(f"aggregate.{key} missing")
    for h, row in (block.get("heights") or {}).items():
        wall = row.get("wall_ms")
        if wall is None:
            errs.append(f"height {h}: wall_ms missing")
            continue
        covered = sum(
            row.get(f"{name}_ms", 0.0) for name in CONSERVATION_BUCKETS
        )
        expected = wall + row.get("pipeline_overlap_ms", 0.0)
        if wall > 0 and abs(covered - expected) > tolerance * wall:
            errs.append(
                f"height {h}: buckets sum to {covered:.3f} ms != wall "
                f"{wall:.3f} ms + overlap "
                f"{row.get('pipeline_overlap_ms', 0.0):.3f} ms"
            )
    return errs


def conservation_table(cons: dict) -> str:
    """The wall_conservation dict as an aligned text table."""
    agg = cons.get("aggregate") or {}
    if not agg:
        return "(no step spans in dump — conservation needs cs.* records)"
    overlap_share = agg.get("pipeline_overlap_share", 0.0)
    head = (
        f"wall-clock conservation over {agg['n_heights']} heights "
        f"(dark {agg['dark_fraction']:.1%}, worst height "
        f"{agg['dark_fraction_max']:.1%}"
    )
    head += (
        f", pipelined overlap {overlap_share:.1%})" if overlap_share else ")"
    )
    cols = list(CONSERVATION_BUCKETS) + ["pipeline_overlap"]
    lines = [
        head,
        "  shares: "
        + "  ".join(
            f"{name} {agg.get(f'{name}_share', 0.0):.1%}"
            for name in cols
        ),
        f"  {'height':>8} {'wall_ms':>9} "
        + " ".join(f"{n[:9]:>9}" for n in cols),
    ]
    for h in sorted(cons.get("heights") or {}, key=int):
        v = cons["heights"][h]
        lines.append(
            f"  {h:>8} {v['wall_ms']:>9.2f} "
            + " ".join(f"{v.get(f'{n}_ms', 0.0):>9.2f}" for n in cols)
        )
    return "\n".join(lines)


def pacing_decisions(records: list[dict]) -> dict:
    """Per-step learned-vs-static summary from `pacing.decision` trace
    events (consensus/pacing.py emits one per step per height)."""
    by_step: dict[str, list[dict]] = {}
    for r in records:
        if r.get("name") != "pacing.decision":
            continue
        f = r.get("fields") or {}
        step = f.get("step")
        if step:
            by_step.setdefault(step, []).append(f)
    out = {}
    for step, rows in by_step.items():
        eff = [float(x.get("effective_ms", 0.0)) for x in rows]
        learned = [float(x.get("learned_ms", 0.0)) for x in rows]
        out[step] = {
            "decisions": len(rows),
            "static_ms": float(rows[-1].get("static_ms", 0.0)),
            "learned_ms_last": learned[-1] if learned else 0.0,
            "effective_ms_p50": round(pct(eff, 0.5), 3),
            "effective_ms_last": eff[-1] if eff else 0.0,
            "backoff_last": float(rows[-1].get("backoff", 0.0)),
        }
    return out


def ascii_timeline(records: list[dict], n_heights: int = 16) -> str:
    """Per-height step-timeline table. Spans show offset + duration from
    the height's first record; events render as `!` annotations at their
    offset — a chaos partition lands visibly inside the height it hit."""
    recs = [SpanRecord.from_json(r) for r in records]
    flight = flight_snapshot(recs, n_heights)
    if not flight:
        return "(no trace records)"
    lines = []
    for h in sorted(flight):
        rows = flight[h]
        t_base = min(r["t0"] for r in rows)
        t_end = max(r["t0"] + r.get("dur", 0.0) for r in rows)
        lines.append(
            f"height {h}  ({(t_end - t_base) * 1e3:.1f} ms, "
            f"{len(rows)} records)"
        )
        lines.append(f"  {'span':<28} {'t+ms':>9} {'dur_ms':>9}")
        for r in rows:
            off = (r["t0"] - t_base) * 1e3
            if r["kind"] == "span":
                lines.append(
                    f"  {r['name']:<28} {off:>9.2f} "
                    f"{r.get('dur', 0.0) * 1e3:>9.2f}"
                )
            else:
                extra = ""
                if r.get("fields"):
                    extra = " " + ",".join(
                        f"{k}={v}" for k, v in sorted(r["fields"].items())
                    )
                lines.append(f"  ! {r['name']:<26} {off:>9.2f}{extra}")
    return "\n".join(lines)


def side_by_side_timeline(
    named_records: dict[str, list[dict]], n_heights: int = 16
) -> str:
    """Multi-node rendering: per height, one row per span name with one
    duration column per node — a slow step on ONE validator stands out
    against the same step's duration on its peers. Events render as a
    per-node annotation count. `named_records` maps a display name (file
    stem, moniker) to that node's record-dict list."""
    nodes = list(named_records)
    flights = {
        n: flight_snapshot(
            [SpanRecord.from_json(r) for r in named_records[n]], n_heights
        )
        for n in nodes
    }
    heights = sorted(set().union(*(set(f) for f in flights.values())))[
        -n_heights:
    ]
    if not heights:
        return "(no trace records)"
    w = max(9, max(len(n) for n in nodes) + 1)
    lines = []
    for h in heights:
        lines.append(f"height {h}")
        lines.append(
            f"  {'span (dur_ms)':<28} "
            + " ".join(f"{n:>{w}}" for n in nodes)
        )
        # span rows: union of names, ordered by first appearance time
        order: dict[str, float] = {}
        durs: dict[str, dict[str, float]] = {}
        events: dict[str, int] = {n: 0 for n in nodes}
        for n in nodes:
            for r in flights[n].get(h, []):
                if r["kind"] != "span":
                    events[n] += 1
                    continue
                order.setdefault(r["name"], r["t0"])
                # a repeated span name (round retries) sums its durations
                durs.setdefault(r["name"], {}).setdefault(n, 0.0)
                durs[r["name"]][n] += r.get("dur", 0.0)
        for name in sorted(order, key=order.get):
            cells = [
                (
                    f"{durs[name][n] * 1e3:>{w}.2f}"
                    if n in durs.get(name, {})
                    else f"{'-':>{w}}"
                )
                for n in nodes
            ]
            lines.append(f"  {name:<28} " + " ".join(cells))
        if any(events.values()):
            cells = [f"{events[n]:>{w}}" for n in nodes]
            lines.append(f"  {'! annotations':<28} " + " ".join(cells))
    return "\n".join(lines)


def attribution_table(records: list[dict]) -> str:
    """The attribution dict rendered as an aligned text table."""
    att = attribution(records)
    lines = [
        f"latency attribution over {att['heights']} heights",
        f"  {'span':<28} {'count':>6} {'p50_ms':>9} {'p95_ms':>9} "
        f"{'max_ms':>9}",
    ]
    for name, s in att["steps"].items():
        lines.append(
            f"  {name:<28} {s['count']:>6} {s['p50_ms']:>9.2f} "
            f"{s['p95_ms']:>9.2f} {s['max_ms']:>9.2f}"
        )
    return "\n".join(lines)
