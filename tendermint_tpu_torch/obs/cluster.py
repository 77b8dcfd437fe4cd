"""Cluster-wide causal trace merge + quorum-latency attribution.

A single node's flight recorder answers "where did height H's time go
HERE"; consensus latency is a distributed property — a slow height is a
slow proposer, a laggy gossip link, or one straggler validator closing
the 2/3 quorum late. This module joins per-validator `dump_traces`
dumps into one timeline and names that bottleneck:

- `estimate_offsets` turns the per-peer NTP tables (timestamped
  ping/pong, p2p/mconn.py) into one clock offset per node relative to a
  reference node. Offsets are summed along the MINIMUM-RTT path through
  the peer graph (Dijkstra), not read off the direct edge: an
  asymmetric-delay link biases its own NTP estimate by delay/2, but a
  clean two-hop path through a third validator doesn't — so one bad
  link can't skew the merge. Nodes with no usable path fall back to the
  raw wall anchors (`epoch_wall_ns`).
- `merge_records` rebases every node's records onto the reference
  node's tracer timeline (annotating each with its node name) so a
  receive on B is directly comparable to the send on A.
- `link_latencies` joins `gossip.send`/`gossip.recv` pairs (matched on
  height/round/type/index + sender) into per-directed-link one-way
  latency estimates.
- `cluster_report` builds the per-height "slowest path" report:
  proposer → proposal gossip per node → per-validator vote arrivals →
  the quorum-closing vote, plus a straggler ranking across heights.

All functions operate on plain dicts (the `dump_traces` response shape)
so they consume RPC responses and JSON files equally. Stdlib only.
"""

from __future__ import annotations

import heapq

from .report import pct

REPORT_SCHEMA = "tm-tpu/cluster-report/v2"

# dumps whose offset came from the NTP peer graph vs the raw wall clock
SOURCE_NTP = "ntp_graph"
SOURCE_WALL = "wall_anchor"
SOURCE_REFERENCE = "reference"


def normalize_dump(doc, name: str = "") -> dict:
    """Accept a `dump_traces` response (optionally wrapped in a JSON-RPC
    {"result": ...} envelope) or a pre-built dump dict and return the
    canonical shape used by every function here."""
    if isinstance(doc, dict) and "result" in doc and isinstance(
        doc["result"], dict
    ):
        doc = doc["result"]
    if not isinstance(doc, dict) or "records" not in doc:
        raise ValueError("unrecognized trace dump shape (no records)")
    node_id = doc.get("node_id", "") or ""
    return {
        "node_id": node_id,
        "name": name or doc.get("moniker") or node_id[:12] or "node",
        "epoch_wall_ns": int(doc.get("epoch_wall_ns", 0)),
        "records": doc["records"],
        "peer_clock": doc.get("peer_clock") or {},
    }


# --- clock-offset estimation ----------------------------------------------


def estimate_offsets(dumps: list[dict], reference: str = "") -> dict:
    """Per-node clock offset (node wall clock minus reference wall
    clock, seconds) via minimum-RTT paths through the peer NTP graph.

    Returns {node_id: {"offset_s", "rtt_s", "hops", "source"}}. The
    reference is `reference` (a node_id) or the first dump's node.
    """
    ids = [d["node_id"] for d in dumps]
    ref = reference or (ids[0] if ids else "")
    # directed measurement edges: A's table entry for B estimates
    # offset(B-A) with confidence ~rtt; B's own table supplies the
    # reverse measurement, and we mirror each edge so a one-sided table
    # (short run, asymmetric sampling) still connects the graph
    edges: dict[str, list[tuple[str, float, float]]] = {i: [] for i in ids}
    known = set(ids)
    for d in dumps:
        src = d["node_id"]
        for dst, info in d["peer_clock"].items():
            if dst not in known or not info:
                continue
            # prefer the min-RTT sample (NTP clock filter: queueing only
            # ever inflates a sample, so the fastest round trip carries
            # the sharpest offset); fall back to the EWMA
            off = info.get("min_rtt_offset_s")
            rtt = info.get("min_rtt_s")
            if off is None or rtt is None:
                off = info.get("offset_s")
                rtt = info.get("rtt_s")
            if off is None or rtt is None or not info.get("samples"):
                continue
            edges[src].append((dst, float(off), max(1e-9, float(rtt))))
            edges[dst].append((src, -float(off), max(1e-9, float(rtt))))

    out = {
        ref: {
            "offset_s": 0.0,
            "rtt_s": 0.0,
            "hops": 0,
            "source": SOURCE_REFERENCE,
        }
    }
    # Dijkstra over cumulative RTT from the reference
    dist: dict[str, float] = {ref: 0.0}
    heap: list[tuple[float, str, float, int]] = [(0.0, ref, 0.0, 0)]
    done: set[str] = set()
    while heap:
        d_rtt, node, off_sum, hops = heapq.heappop(heap)
        if node in done:
            continue
        done.add(node)
        if node != ref:
            out[node] = {
                "offset_s": round(off_sum, 9),
                "rtt_s": round(d_rtt, 9),
                "hops": hops,
                "source": SOURCE_NTP,
            }
        for dst, off, rtt in edges.get(node, ()):
            nd = d_rtt + rtt
            if dst not in dist or nd < dist[dst]:
                dist[dst] = nd
                heapq.heappush(heap, (nd, dst, off_sum + off, hops + 1))
    for i in ids:
        if i not in out:
            # no NTP path: trust the node's wall clock as-is
            out[i] = {
                "offset_s": 0.0,
                "rtt_s": 0.0,
                "hops": 0,
                "source": SOURCE_WALL,
            }
    return out


# --- merge ----------------------------------------------------------------


def merge_records(
    dumps: list[dict], offsets=None, reference: str = ""
) -> tuple[str, dict, list[dict]]:
    """Rebase every dump's records onto the reference node's tracer
    timeline. Returns (reference_node_id, offsets, merged_records);
    each merged record gains `node` (display name) and `node_id`, with
    `t0` in seconds on the reference timeline."""
    if not dumps:
        return "", {}, []
    # display names key the report's offsets/links sections; duplicate
    # monikers (fleet config templates) would silently overwrite one
    # another and pool distinct links' stats — suffix them unique.
    # (In-place: the names are baked into the merged records and must
    # match what cluster_report later reads off the dumps.)
    seen: dict[str, int] = {}
    for d in dumps:
        n = seen.get(d["name"], 0)
        seen[d["name"]] = n + 1
        if n:
            d["name"] = f"{d['name']}#{n + 1}"
    ids = [d["node_id"] for d in dumps]
    ref = reference or ids[0]
    if ref not in ids:
        raise ValueError(
            f"reference {ref!r} is not among the dumps' node ids {ids}"
        )
    if offsets is None:
        offsets = estimate_offsets(dumps, ref)
    ref_dump = next(d for d in dumps if d["node_id"] == ref)
    ref_epoch = ref_dump["epoch_wall_ns"]
    merged = []
    for d in dumps:
        off_ns = offsets.get(d["node_id"], {}).get("offset_s", 0.0) * 1e9
        # node wall = epoch_wall + t0; reference clock = wall - offset
        shift_s = (d["epoch_wall_ns"] - off_ns - ref_epoch) / 1e9
        for r in d["records"]:
            m = dict(r)
            m["t0"] = r.get("t0", 0.0) + shift_s
            m["node"] = d["name"]
            m["node_id"] = d["node_id"]
            merged.append(m)
    merged.sort(key=lambda r: r["t0"])
    return ref, offsets, merged


def to_chrome_trace(merged: list[dict], dumps: list[dict]) -> dict:
    """Chrome trace_event JSON over a merged record list: one pid per
    node (named via process_name metadata), one tid per height — load in
    Perfetto for the cluster-wide timeline."""
    pids = {d["node_id"]: i + 1 for i, d in enumerate(dumps)}
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pids[d["node_id"]],
            "args": {"name": d["name"]},
        }
        for d in dumps
    ]
    for r in merged:
        ev = {
            "name": r.get("name", ""),
            "ph": "X" if r.get("kind") == "span" else "i",
            "ts": round(r["t0"] * 1e6, 1),
            "pid": pids.get(r.get("node_id"), 0),
            "tid": r.get("height", 0),
            "args": {
                "height": r.get("height", 0),
                "round": r.get("round", 0),
                "node": r.get("node", ""),
                **(r.get("fields") or {}),
            },
        }
        if r.get("kind") == "span":
            ev["dur"] = round(r.get("dur", 0.0) * 1e6, 1)
        else:
            ev["s"] = "g"
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --- causal joins ---------------------------------------------------------


def _gossip_key(r: dict):
    f = r.get("fields") or {}
    return (
        r.get("height", 0),
        r.get("round", 0),
        f.get("type", ""),
        f.get("val", f.get("part", -1)),
    )


def link_latencies(merged: list[dict], dumps: list[dict]) -> list[dict]:
    """Per-directed-link one-way latency from matched gossip send/recv
    pairs, ranked slowest first. A send with peer="*" (broadcast) joins
    every receive that names its node as the source."""
    by_id = {d["node_id"]: d["name"] for d in dumps}
    # first send per (src_node, key); a receive joins on (key, src).
    # Both sides dedup to the FIRST occurrence: gossip re-sends (and the
    # receiver's record of a duplicate arrival) measure retry cadence,
    # not link latency
    sends: dict[tuple, float] = {}
    recvs: dict[tuple, tuple[float, str, str]] = {}
    for r in merged:
        if r.get("name") == "gossip.send":
            k = (r["node_id"], _gossip_key(r))
            if k not in sends or r["t0"] < sends[k]:
                sends[k] = r["t0"]
        elif r.get("name") == "gossip.recv":
            src_id = (r.get("fields") or {}).get("peer", "")
            k = (r["node_id"], src_id, _gossip_key(r))
            if k not in recvs or r["t0"] < recvs[k][0]:
                recvs[k] = (r["t0"], src_id, r["node"])
    pair_lags: dict[tuple[str, str], list[float]] = {}
    for (_, src_id, key), (t_recv, src, dst_name) in recvs.items():
        t_send = sends.get((src_id, key))
        if t_send is None:
            continue
        lag = t_recv - t_send
        if lag < -0.025:
            # the original send predates the ring (evicted/cleared) and
            # this "send" is a later re-gossip of the same message —
            # joining it would count a large negative lag. The cutoff
            # sits beyond any plausible clock-rebase error (the offset
            # estimator is good to ~±10 ms worst-case), so moderately
            # negative lags on fast links survive into the stats
            # instead of silently deleting the link.
            continue
        pair_lags.setdefault(
            (by_id.get(src, src[:12]), dst_name), []
        ).append(lag)
    out = []
    for (src, dst), lags in pair_lags.items():
        out.append(
            {
                "src": src,
                "dst": dst,
                # min is the propagation-delay estimate (the NTP filter
                # trick: queueing and receiver-side processing only ever
                # ADD to a sample); median/p95 fold congestion in
                "min_lag_ms": round(min(lags) * 1e3, 3),
                "median_lag_ms": round(pct(lags, 0.5) * 1e3, 3),
                "p95_lag_ms": round(pct(lags, 0.95) * 1e3, 3),
                "samples": len(lags),
            }
        )
    out.sort(key=lambda e: (-e["min_lag_ms"], -e["median_lag_ms"]))
    return out


# --- the per-height slowest path ------------------------------------------


def height_paths(merged: list[dict], n_heights: int = 16) -> dict[int, dict]:
    """Per-height slowest-path decomposition over merged records:
    proposer send -> per-node proposal receipt -> per-node precommit
    quorum close (with the closing validator)."""
    heights: dict[int, list[dict]] = {}
    for r in merged:
        h = r.get("height", 0)
        if h > 0:
            heights.setdefault(h, []).append(r)
    out: dict[int, dict] = {}
    for h in sorted(heights)[-n_heights:]:
        rows = heights[h]
        prop_sends = [
            r
            for r in rows
            if r["name"] == "gossip.send"
            and (r.get("fields") or {}).get("type") == "proposal"
        ]
        prop_recvs = [
            r
            for r in rows
            if r["name"] == "gossip.recv"
            and (r.get("fields") or {}).get("type") == "proposal"
        ]
        t_prop = min(
            (r["t0"] for r in prop_sends),
            default=min((r["t0"] for r in prop_recvs), default=None),
        )
        proposer = min(prop_sends, key=lambda r: r["t0"])["node"] if (
            prop_sends
        ) else ""
        gossip = {}
        for r in prop_recvs:
            if t_prop is None:
                break
            lag = round((r["t0"] - t_prop) * 1e3, 3)
            if r["node"] not in gossip or lag < gossip[r["node"]]:
                gossip[r["node"]] = lag
        closes = [
            r
            for r in rows
            if r["name"] == "quorum.close"
            and (r.get("fields") or {}).get("type") == "precommit"
        ]
        quorum = {}
        for r in closes:
            f = r.get("fields") or {}
            cur = quorum.get(r["node"])
            if cur is None or r["t0"] > cur["t"]:
                quorum[r["node"]] = {
                    "t": r["t0"],
                    "closer_index": f.get("closer", -1),
                    "close_lag_ms": f.get("lag_ms", 0.0),
                    "round": r.get("round", 0),
                }
        slowest = None
        if quorum:
            name = max(quorum, key=lambda n: quorum[n]["t"])
            q = quorum[name]
            slowest = {
                "node": name,
                "closer_index": q["closer_index"],
                "close_lag_ms": q["close_lag_ms"],
                "commit_wait_ms": (
                    round((q["t"] - t_prop) * 1e3, 3)
                    if t_prop is not None
                    else None
                ),
            }
        out[h] = {
            "proposer": proposer,
            "proposal_gossip_ms": gossip,
            "quorum_close": {
                n: {k: v for k, v in q.items() if k != "t"}
                for n, q in quorum.items()
            },
            "slowest": slowest,
        }
    return out


def straggler_ranking(merged: list[dict]) -> list[dict]:
    """Across all heights: which validator's vote closes the precommit
    quorum, how often, and with what lag — the committee's stragglers,
    worst first."""
    closed: dict[int, list[float]] = {}
    arrivals: dict[int, list[float]] = {}
    n_closes = 0
    for r in merged:
        f = r.get("fields") or {}
        if f.get("type") != "precommit":
            continue
        if r.get("name") == "quorum.close":
            closed.setdefault(int(f.get("closer", -1)), []).append(
                float(f.get("lag_ms", 0.0))
            )
            n_closes += 1
        elif r.get("name") == "quorum.vote":
            arrivals.setdefault(int(f.get("val", -1)), []).append(
                float(f.get("lag_ms", 0.0))
            )
    out = []
    for val in sorted(set(closed) | set(arrivals)):
        lags = closed.get(val, [])
        out.append(
            {
                "validator_index": val,
                "quorum_closes": len(lags),
                "close_share": round(len(lags) / max(1, n_closes), 3),
                "median_close_lag_ms": round(pct(lags, 0.5), 3),
                "median_arrival_lag_ms": round(
                    pct(arrivals.get(val, []), 0.5), 3
                ),
            }
        )
    out.sort(
        key=lambda e: (-e["quorum_closes"], -e["median_arrival_lag_ms"])
    )
    return out


def verify_flow(merged: list[dict]) -> dict:
    """Cross-process verify attribution: join each node's client-side
    `verify.ipc` round-trip span with the verify-SERVICE's
    `verify.queue`/`verify.device`/`verify.service` sub-spans recorded
    under the same wire trace context (matched on origin + request id).
    The service dump merges on the raw-wall-anchor fallback (it sits
    outside the p2p NTP graph), so the join uses DURATIONS, never
    cross-ring timestamps: wire overhead = client RTT minus the
    service-observed handle time, which both clocks agree on.

    Returns per-height rows plus an aggregate — the verify slice of the
    wall-conservation story across the process split."""
    svc: dict[tuple, dict] = {}
    for r in merged:
        name = r.get("name", "")
        if name not in ("verify.queue", "verify.device", "verify.service"):
            continue
        f = r.get("fields") or {}
        key = (f.get("origin", ""), f.get("req", -1))
        sub = svc.setdefault(key, {})
        # ACCUMULATE: a submission larger than the scheduler's
        # max_batch dispatches as several device rounds, each recording
        # its own queue/device sub-span under the same (origin, req) —
        # last-write-wins would drop all but one round's time
        sub[name] = sub.get(name, 0.0) + r.get("dur", 0.0)
    heights: dict[int, dict] = {}
    joined = 0
    for r in merged:
        if r.get("name") != "verify.ipc":
            continue
        f = r.get("fields") or {}
        key = (f.get("origin", ""), f.get("req", -1))
        sub = svc.get(key, {})
        rtt = r.get("dur", 0.0)
        service = sub.get("verify.service", 0.0)
        row = heights.setdefault(
            r.get("height", 0),
            {
                "submissions": 0,
                "joined": 0,
                "rows": 0,
                "ipc_ms": 0.0,
                "queue_ms": 0.0,
                "device_ms": 0.0,
                "wire_ms": 0.0,
            },
        )
        row["submissions"] += 1
        row["rows"] += int(f.get("n", 0))
        row["ipc_ms"] += rtt * 1e3
        if sub:
            joined += 1
            row["joined"] += 1
            row["queue_ms"] += sub.get("verify.queue", 0.0) * 1e3
            row["device_ms"] += sub.get("verify.device", 0.0) * 1e3
            row["wire_ms"] += max(0.0, rtt - service) * 1e3
    for row in heights.values():
        for k in ("ipc_ms", "queue_ms", "device_ms", "wire_ms"):
            row[k] = round(row[k], 3)
    return {
        "submissions": sum(r["submissions"] for r in heights.values()),
        "joined": joined,
        "heights": {str(h): heights[h] for h in sorted(heights)},
    }


def wall_anchor_offsets(dumps: list[dict]) -> dict:
    """All-zero offsets (source wall_anchor): trust each node's wall
    clock as ground truth. The right merge basis for in-proc harnesses
    (soak, tests) where every node shares one clock — NTP estimation
    would import a chaos-delayed link's bias into known-exact anchors."""
    return {
        d["node_id"]: {
            "offset_s": 0.0,
            "rtt_s": 0.0,
            "hops": 0,
            "source": SOURCE_WALL,
        }
        for d in dumps
    }


def cluster_report(
    dumps: list[dict],
    reference: str = "",
    n_heights: int = 16,
    offsets=None,
    merge=None,
) -> dict:
    """The one artifact: offsets + per-height slowest path + link and
    straggler rankings. `dumps` are normalize_dump() outputs. `offsets`
    overrides the NTP estimation (e.g. wall_anchor_offsets); `merge`
    reuses a precomputed merge_records() triple."""
    if merge is None:
        merge = merge_records(dumps, offsets=offsets, reference=reference)
    ref, offsets, merged = merge
    names = {d["node_id"]: d["name"] for d in dumps}
    return {
        "schema": REPORT_SCHEMA,
        "reference": names.get(ref, ref),
        "nodes": [
            {
                "name": d["name"],
                "node_id": d["node_id"],
                "records": len(d["records"]),
            }
            for d in dumps
        ],
        "offsets": {
            names.get(nid, nid): info for nid, info in offsets.items()
        },
        "heights": {
            str(h): path
            for h, path in height_paths(merged, n_heights).items()
        },
        "links": link_latencies(merged, dumps),
        "stragglers": straggler_ranking(merged),
        # cross-process verify attribution (empty when no verify-service
        # dump / traced submissions are in the merge)
        "verify_flow": verify_flow(merged),
    }


def report_text(report: dict) -> str:
    """Human rendering of a cluster_report: per-height slowest path +
    the link/straggler rankings."""
    lines = [
        f"cluster report (reference {report['reference']}, "
        f"{len(report['nodes'])} nodes)"
    ]
    for n in report["nodes"]:
        off = report["offsets"].get(n["name"], {})
        lines.append(
            f"  {n['name']:<12} offset {off.get('offset_s', 0.0) * 1e3:+8.3f} ms"
            f"  ({off.get('source', '?')}, {n['records']} records)"
        )
    lines.append("")
    lines.append(
        f"  {'height':>6} {'proposer':<12} {'slowest node':<12} "
        f"{'closer':>6} {'close_lag_ms':>12} {'commit_wait_ms':>14}"
    )
    for h in sorted(report["heights"], key=int):
        p = report["heights"][h]
        s = p.get("slowest") or {}
        lines.append(
            f"  {h:>6} {p.get('proposer') or '?':<12} "
            f"{s.get('node', '?'):<12} {s.get('closer_index', -1):>6} "
            f"{s.get('close_lag_ms', 0.0):>12.2f} "
            f"{(s.get('commit_wait_ms') or 0.0):>14.2f}"
        )
    if report["links"]:
        lines.append("")
        lines.append("  slowest links (one-way, from matched gossip pairs):")
        for e in report["links"][:8]:
            lines.append(
                f"    {e['src']:<12} -> {e['dst']:<12} "
                f"min {e['min_lag_ms']:>8.2f} ms  "
                f"median {e['median_lag_ms']:>8.2f} ms  "
                f"p95 {e['p95_lag_ms']:>8.2f} ms  ({e['samples']} msgs)"
            )
    vf = report.get("verify_flow") or {}
    if vf.get("submissions"):
        lines.append("")
        lines.append(
            f"  verify flow ({vf['submissions']} traced submissions, "
            f"{vf['joined']} joined to service sub-spans):"
        )
        lines.append(
            f"    {'height':>6} {'subs':>5} {'rows':>6} {'ipc_ms':>9} "
            f"{'queue_ms':>9} {'device_ms':>9} {'wire_ms':>9}"
        )
        for h in sorted(vf["heights"], key=int):
            r = vf["heights"][h]
            lines.append(
                f"    {h:>6} {r['submissions']:>5} {r['rows']:>6} "
                f"{r['ipc_ms']:>9.2f} {r['queue_ms']:>9.2f} "
                f"{r['device_ms']:>9.2f} {r['wire_ms']:>9.2f}"
            )
    if report["stragglers"]:
        lines.append("")
        lines.append("  quorum-closing stragglers (precommit):")
        for s in report["stragglers"][:8]:
            lines.append(
                f"    val {s['validator_index']:>3}  closed "
                f"{s['quorum_closes']:>3}x ({s['close_share'] * 100:.0f}%)  "
                f"median close lag {s['median_close_lag_ms']:>8.2f} ms  "
                f"median arrival {s['median_arrival_lag_ms']:>8.2f} ms"
            )
    return "\n".join(lines)
