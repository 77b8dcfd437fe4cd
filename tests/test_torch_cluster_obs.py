"""The port's cluster observability (``obs/cluster.py``, with the tracer's
re-anchoring, the metrics' cardinality bounds and ``p2p/mconn.py``'s
clock samples it reads) against the contract of
``tests/test_cluster_obs.py``: the wall anchor's drift bound, label
cardinality caps, the NTP sample math of the timestamped ping/pong,
min-RTT offset paths around a biased link, the merge onto one timeline,
the cluster report's golden schema, and on a live 4-validator mesh of the
port over encrypted p2p (``tests/torch_chaos_harness.py`` on
``device="cpu"``) a 50 ms one-way delay on the heavy validator's link to
the victim: every offset within 10 ms, that link ranked first at about
50 ms, the heavy validator named the victim's quorum-closing straggler.
The unit contracts run one body on both packages' roots (the JAX
package's as the yardstick). Where the reference runs
``tools/cluster_trace.py`` and ``tools/trace_report.py`` as processes,
the twins call what those tools call (``merge_records``,
``cluster_report``, ``report_text``, ``cluster.to_chrome_trace``,
``side_by_side_timeline``, ``attribution_table``) in the process; the CLI
forms wait for the port's tools (ROADMAP.md, item A5e). Beside them,
parity: both packages' ``cluster_report`` of the same dumps, and of the
live mesh's, are equal. Tolerance: exact (reports), the reference's
bounds on offsets and lags.
"""

import asyncio
import importlib
import json
import struct
import time
from types import SimpleNamespace

import pytest

from .test_torch_consensus import PORT, REF, cpu_verifier  # noqa: F401 (autouse)

pytestmark = pytest.mark.obs

ROOTS = [PORT.root, REF.root]


def cluster_ns(root: str) -> SimpleNamespace:
    """The observability names of one package, with its metrics' bounds
    and its MConnection."""
    metrics = importlib.import_module(f"{root}.libs.metrics")
    mconn = importlib.import_module(f"{root}.p2p.mconn")
    return SimpleNamespace(
        root=root,
        obs=importlib.import_module(f"{root}.obs"),
        cluster=importlib.import_module(f"{root}.obs.cluster"),
        Counter=metrics.Counter,
        Gauge=metrics.Gauge,
        Histogram=metrics.Histogram,
        MetricCardinalityError=metrics.MetricCardinalityError,
        OTHER_LABEL=metrics.OTHER_LABEL,
        bounded_label=metrics.bounded_label,
        MConnection=mconn.MConnection,
        _PONG_FMT=mconn._PONG_FMT,
    )


NS = {root: cluster_ns(root) for root in ROOTS}
CP = NS[PORT.root]


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def h(request):
    return NS[request.param]


# --- tracer wall-anchor re-anchoring (drift bound) -------------------------


def test_tracer_reanchor_bounds_drift(h):
    t = h.obs.Tracer(enabled=True, reanchor_interval_s=0.01)
    # simulate 5 s of accumulated monotonic-vs-wall drift in the anchor
    t.epoch_wall_ns -= 5_000_000_000
    time.sleep(0.02)
    t.event("tick")  # recording path must refresh the stale anchor
    reconstructed = t.epoch_wall_ns + int(
        (time.perf_counter() - t.epoch) * 1e9
    )
    assert abs(reconstructed - time.time_ns()) < 100_000_000  # < 100 ms
    assert t.wall_anchor_age_s() < 1.0


def test_tracer_reanchor_manual_and_disabled(h):
    t = h.obs.Tracer(enabled=True, reanchor_interval_s=0.0)  # auto off
    t.epoch_wall_ns -= 5_000_000_000
    t.event("tick")
    drift = abs(
        t.epoch_wall_ns
        + int((time.perf_counter() - t.epoch) * 1e9)
        - time.time_ns()
    )
    assert drift > 4_000_000_000  # interval 0 never re-anchors
    t.reanchor()
    drift = abs(
        t.epoch_wall_ns
        + int((time.perf_counter() - t.epoch) * 1e9)
        - time.time_ns()
    )
    assert drift < 100_000_000


# --- label-cardinality bounding --------------------------------------------


def test_metric_cardinality_cap_raises(h):
    c = h.Counter("t_card_counter", "h", ("x",), max_series=3)
    for i in range(3):
        c.inc(x=str(i))
    with pytest.raises(h.MetricCardinalityError) as ei:
        c.inc(x="overflow")
    assert "t_card_counter" in str(ei.value)
    c.inc(x="0")  # existing series still fine
    assert c.value(x="0") == 2.0

    g = h.Gauge("t_card_gauge", "h", ("x",), max_series=2)
    g.set(1, x="a")
    g.set(2, x="b")
    with pytest.raises(h.MetricCardinalityError):
        g.set(3, x="c")

    hist = h.Histogram("t_card_hist", "h", labels=("x",), max_series=2)
    hist.observe(0.1, x="a")
    hist.observe(0.2, x="b")
    with pytest.raises(h.MetricCardinalityError):
        hist.observe(0.3, x="c")
    # unlabeled metrics are a single series: never capped
    u = h.Counter("t_card_plain", "h", max_series=1)
    for _ in range(5):
        u.inc()


def test_bounded_label_topk(h):
    fam = "t_bounded_label_family"
    assert h.bounded_label(fam, "p1", k=2) == "p1"
    assert h.bounded_label(fam, "p2", k=2) == "p2"
    assert h.bounded_label(fam, "p3", k=2) == h.OTHER_LABEL
    # admitted values stay admitted; the long tail shares one bucket
    assert h.bounded_label(fam, "p1", k=2) == "p1"
    assert h.bounded_label(fam, "p4", k=2) == h.OTHER_LABEL


# --- mconn NTP sample math -------------------------------------------------


def test_mconn_pong_sample_math(h):
    mc = h.MConnection(None, [], None, peer_id="")
    t1w, t1m = time.time_ns(), time.perf_counter_ns()
    offset_ns = 500_000_000  # peer clock runs 0.5 s ahead
    t2 = t1w + offset_ns
    t3 = t2
    mc._on_pong(struct.pack(h._PONG_FMT, t1w, t1m, t2, t3))
    assert mc.clock_samples == 1
    assert 0.4 < mc.clock_offset_s < 0.6
    assert 0.0 <= mc.rtt_s < 0.1
    # EWMA folds further samples instead of replacing
    t1w, t1m = time.time_ns(), time.perf_counter_ns()
    t2 = t1w + offset_ns
    mc._on_pong(struct.pack(h._PONG_FMT, t1w, t1m, t2, t2))
    assert mc.clock_samples == 2
    assert 0.4 < mc.clock_offset_s < 0.6
    # short/legacy payloads are ignored, not an error
    mc._on_pong(b"")
    mc._on_pong(b"\x00" * 8)
    assert mc.clock_samples == 2
    # the min-RTT clock filter is a sliding window: a wall-clock step
    # ages out of the filter instead of pinning a stale offset forever
    for _ in range(20):
        t1w, t1m = time.time_ns(), time.perf_counter_ns()
        mc._on_pong(struct.pack(h._PONG_FMT, t1w, t1m, t1w, t1w))  # offset ~0
    assert abs(mc.min_rtt_offset_s) < 0.1  # the 0.5 s samples expired
    # a pre-extension ping gets a bare pong; a stamped one gets echoes
    assert mc._pong_packet(b"") == bytes([0xFF, 1])
    stamped = mc._pong_packet(struct.pack("<qq", t1w, t1m))
    assert len(stamped) == 2 + struct.calcsize(h._PONG_FMT)
    e1w, e1m, e2, e3 = struct.unpack_from(h._PONG_FMT, stamped[2:])
    assert (e1w, e1m) == (t1w, t1m) and e2 <= e3


# --- offset estimation: min-RTT paths route around a biased link -----------


def _dump(h, node_id, records=(), peer_clock=None, epoch_wall_ns=0, name=""):
    return h.obs.normalize_dump(
        {
            "node_id": node_id,
            "moniker": name or node_id,
            "epoch_wall_ns": epoch_wall_ns,
            "records": list(records),
            "peer_clock": peer_clock or {},
        }
    )


def test_estimate_offsets_min_rtt_path_avoids_biased_link(h):
    # direct A-B link has 50 ms asymmetric delay: its NTP estimate is
    # biased +25 ms; the clean A-C-B path must win
    a = _dump(h, 
        "A",
        peer_clock={
            "B": {"offset_s": 0.025, "rtt_s": 0.100, "samples": 9},
            "C": {"offset_s": 0.0005, "rtt_s": 0.002, "samples": 9},
        },
    )
    b = _dump(h, 
        "B",
        peer_clock={"A": {"offset_s": -0.025, "rtt_s": 0.100, "samples": 9}},
    )
    c = _dump(h, 
        "C",
        peer_clock={"B": {"offset_s": -0.0002, "rtt_s": 0.002, "samples": 9}},
    )
    offs = h.obs.estimate_offsets([a, b, c])
    assert offs["A"]["source"] == "reference"
    assert offs["B"]["source"] == "ntp_graph" and offs["B"]["hops"] == 2
    assert abs(offs["B"]["offset_s"]) < 0.005  # NOT the 25 ms direct bias
    assert abs(offs["C"]["offset_s"]) < 0.005
    # a node with no NTP path falls back to its wall anchor
    d = _dump(h, "D")
    offs = h.obs.estimate_offsets([a, b, c, d])
    assert offs["D"]["source"] == "wall_anchor"


def test_merge_records_rebases_onto_reference_timeline(h):
    # same instant seen by two nodes whose tracers were born 1 s apart
    # and whose clocks differ by a known offset
    rec = {"name": "x", "t0": 2.0, "dur": 0.0, "height": 1, "round": 0,
           "kind": "event"}
    a = _dump(h, "A", [rec], epoch_wall_ns=10_000_000_000)
    b = _dump(h, 
        "B",
        [dict(rec, t0=0.5)],
        # B's ring started 1.5 s after A's (true time) and B's clock
        # runs 0.25 s ahead: t0=0.5 on B is the same true instant as
        # t0=2.0 on A
        epoch_wall_ns=11_500_000_000 + 250_000_000,
        peer_clock={"A": {"offset_s": -0.25, "rtt_s": 0.001, "samples": 5}},
    )
    _, offsets, merged = h.obs.merge_records([a, b])
    assert abs(offsets["B"]["offset_s"] - 0.25) < 1e-6
    t_by_node = {m["node"]: m["t0"] for m in merged}
    assert abs(t_by_node["A"] - t_by_node["B"]) < 1e-6


# --- cluster-report JSON schema (golden) -----------------------------------

REPORT_KEYS = {
    "schema", "reference", "nodes", "offsets", "heights", "links",
    "stragglers", "verify_flow",
}
NODE_KEYS = {"name", "node_id", "records"}
OFFSET_KEYS = {"offset_s", "rtt_s", "hops", "source"}
HEIGHT_KEYS = {"proposer", "proposal_gossip_ms", "quorum_close", "slowest"}
SLOWEST_KEYS = {"node", "closer_index", "close_lag_ms", "commit_wait_ms"}
QUORUM_KEYS = {"closer_index", "close_lag_ms", "round"}
LINK_KEYS = {
    "src", "dst", "min_lag_ms", "median_lag_ms", "p95_lag_ms", "samples",
}
STRAGGLER_KEYS = {
    "validator_index", "quorum_closes", "close_share",
    "median_close_lag_ms", "median_arrival_lag_ms",
}


def _synthetic_dumps(h):
    def ev(name, t0, height, **fields):
        return {"name": name, "t0": t0, "dur": 0.0, "height": height,
                "round": 0, "kind": "event", "fields": fields}

    a_recs = [
        ev("gossip.send", 1.00, 1, type="proposal", peer="*"),
        ev("quorum.vote", 1.02, 1, type="precommit", val=0, lag_ms=0.0),
        ev("quorum.close", 1.04, 1, type="precommit", closer=1,
           lag_ms=20.0),
    ]
    b_recs = [
        ev("gossip.recv", 1.01, 1, type="proposal", peer="A"),
        ev("quorum.vote", 1.03, 1, type="precommit", val=1, lag_ms=0.0),
        ev("quorum.close", 1.09, 1, type="precommit", closer=0,
           lag_ms=60.0),
    ]
    a = _dump(h, "A", a_recs, peer_clock={
        "B": {"offset_s": 0.0, "rtt_s": 0.002, "samples": 4}
    })
    b = _dump(h, "B", b_recs)
    return [a, b]


def test_merge_dedupes_duplicate_monikers(h):
    # fleet config templates often stamp every node with one moniker;
    # report keys must stay distinct or offsets/links silently collide
    a = _dump(h, "A", name="val")
    b = _dump(h, 
        "B",
        name="val",
        peer_clock={"A": {"offset_s": 0.1, "rtt_s": 0.001, "samples": 3}},
    )
    report = h.obs.cluster_report([a, b])
    assert sorted(report["offsets"]) == ["val", "val#2"]
    assert report["offsets"]["val"]["source"] == "reference"
    assert abs(report["offsets"]["val#2"]["offset_s"] + 0.1) < 1e-9


def test_cluster_report_schema_golden(h):
    report = h.obs.cluster_report(_synthetic_dumps(h))
    assert set(report) == REPORT_KEYS
    assert report["schema"] == "tm-tpu/cluster-report/v2"
    assert report["reference"] == "A"
    assert [set(n) for n in report["nodes"]] == [NODE_KEYS, NODE_KEYS]
    assert all(set(o) == OFFSET_KEYS for o in report["offsets"].values())
    assert set(report["heights"]) == {"1"}
    h1 = report["heights"]["1"]
    assert set(h1) == HEIGHT_KEYS
    assert h1["proposer"] == "A"
    assert set(h1["slowest"]) == SLOWEST_KEYS
    assert all(set(q) == QUORUM_KEYS for q in h1["quorum_close"].values())
    assert h1["slowest"]["node"] == "B"
    assert h1["slowest"]["closer_index"] == 0
    assert [set(l) for l in report["links"]] == [LINK_KEYS]
    assert report["links"][0]["src"] == "A"
    assert report["links"][0]["dst"] == "B"
    assert report["links"][0]["median_lag_ms"] == pytest.approx(10.0)
    assert all(set(s) == STRAGGLER_KEYS for s in report["stragglers"])
    # report_text renders without error and names the straggler
    text = h.obs.report_text(report)
    assert "cluster report" in text and "val" in text
    # the report round-trips through JSON (soak artifact requirement)
    assert json.loads(json.dumps(report)) == report


# --- the live-net acceptance test ------------------------------------------


# --- parity: both packages' reports of the same dumps -----------------------


def test_both_packages_report_the_same_dumps():
    port, ref = (ns.obs.cluster_report(_synthetic_dumps(ns)) for ns in NS.values())
    assert port == ref
    assert CP.obs.report_text(port) == NS[REF.root].obs.report_text(ref)


# --- the live-net acceptance test ------------------------------------------


def test_cluster_trace_recovers_injected_delay(monkeypatch):
    """The reference's live-net test on the port's mesh: powers
    40/20/20/20, a 50 ms ONE-WAY delay on the single link heavy->victim
    after a warm-up, rings cleared, 6 heights in the degraded regime. The
    merged report must (a) estimate every node's clock offset within
    10 ms through NTP paths around the delayed link, (b) rank
    heavy->victim first at 40-130 ms and every other link under 35 ms, and
    (c) name the heavy validator the victim's quorum-closing straggler at
    most heights. The merged Perfetto trace (what ``tools/cluster_trace.py
    --out`` writes) holds gossip.recv and quorum.close and one process a
    node; the JAX package's report of the same dumps is the port's."""
    from tendermint_tpu_torch.chaos.link import LinkPolicy
    from tendermint_tpu_torch.chaos.network import ChaosNetwork

    from .torch_chaos_harness import (
        build_chaos_handles,
        memoize_host_oracle,
        node_dump,
        start_mesh,
        stop_mesh,
    )

    memoize_host_oracle(monkeypatch)
    obs = CP.obs
    handles = build_chaos_handles(
        tracer_factory=lambda name: obs.Tracer(enabled=True),
        ping_interval=0.15,
        powers=(40, 20, 20, 20),
        device="cpu",
    )
    vals = handles[0].cs.state.validators.validators
    heavy_idx = max(range(len(vals)), key=lambda i: vals[i].voting_power)
    victim_idx = (heavy_idx + 1) % len(handles)
    heavy, victim = f"n{heavy_idx}", f"n{victim_idx}"

    async def run():
        net = ChaosNetwork(seed=5)
        for hd in handles:
            net.install(hd)
        await start_mesh(handles)
        try:
            await asyncio.gather(*(hd.cs.wait_for_height(2, timeout=60) for hd in handles))
            await asyncio.sleep(0.8)
            net.set_link_policy(heavy, victim, LinkPolicy(latency_s=0.05),
                                reverse=LinkPolicy())
            for hd in handles:
                hd.cs.tracer.clear()
            h_clear = max(hd.cs.state.last_block_height for hd in handles)
            await asyncio.gather(*(hd.cs.wait_for_height(h_clear + 6, timeout=60)
                                   for hd in handles))
            return h_clear, [node_dump(hd) for hd in handles]
        finally:
            await stop_mesh(handles)

    h_clear, raw_dumps = asyncio.run(run())
    for d in raw_dumps:
        d["records"] = [r for r in d["records"]
                        if r.get("height", 0) == 0 or r["height"] >= h_clear + 2]
    dumps = [obs.normalize_dump(d) for d in raw_dumps]
    report = obs.cluster_report(dumps)

    # (a) offsets
    for name, off in report["offsets"].items():
        assert abs(off["offset_s"]) < 0.010, (name, off)
    ntp = [o for o in report["offsets"].values() if o["source"] == "ntp_graph"]
    assert len(ntp) == len(handles) - 1
    # (b) the delayed link tops the one-way link ranking
    links = report["links"]
    assert links, "no gossip send/recv pairs joined"
    top = links[0]
    assert (top["src"], top["dst"]) == (heavy, victim), links[:4]
    assert 0.040 * 1e3 <= top["min_lag_ms"] <= 0.130 * 1e3
    for e in links[1:]:
        assert e["min_lag_ms"] < 35.0, e
    # (c) the victim's quorum closes name the heavy validator
    heights = report["heights"]
    victim_closes = [p["quorum_close"][victim] for p in heights.values()
                     if victim in p["quorum_close"]]
    assert len(victim_closes) >= 3, heights
    named = sum(1 for q in victim_closes if q["closer_index"] == heavy_idx)
    assert named >= (len(victim_closes) + 1) // 2, victim_closes
    heavy_row = next(s for s in report["stragglers"] if s["validator_index"] == heavy_idx)
    assert heavy_row["quorum_closes"] >= named

    # what tools/cluster_trace.py prints and writes, in the process
    merge = obs.merge_records(dumps)
    text = obs.report_text(obs.cluster_report(dumps, merge=merge))
    assert "cluster report" in text
    assert heavy in text and victim in text
    trace = json.loads(json.dumps(CP.cluster.to_chrome_trace(merge[2], dumps)))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "gossip.recv" in names and "quorum.close" in names
    pids = {e.get("pid") for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert len(pids) == len(handles)

    # parity: the JAX package's report of the same dumps
    ref = NS[REF.root].obs
    assert ref.cluster_report([ref.normalize_dump(d) for d in raw_dumps]) == report


# --- multi-dump trace report (side-by-side columns) -------------------------


def test_trace_report_side_by_side(h):
    """What tools/trace_report.py prints for several dumps (its
    render_many), in the process: the side-by-side node columns and the
    pooled attribution table."""
    docs = {}
    for name, shift in (("nodeA", 0.0), ("nodeB", 0.002)):
        t = h.obs.Tracer(enabled=True)
        base = t.epoch
        t.add_span("cs.propose", base + shift, 0.05, height=1)
        t.add_span("cs.commit", base + 0.05 + shift, 0.15, height=1)
        t.event("chaos.partition", name="split")
        docs[name] = {"records": [r.to_json() for r in t.records()], "moniker": name}
    named = {name: json.loads(json.dumps(doc))["records"] for name, doc in docs.items()}
    pooled = [r for recs in named.values() for r in recs]
    out = "\n\n".join([h.obs.side_by_side_timeline(named, 16),
                        h.obs.attribution_table(pooled)])
    assert "nodeA" in out and "nodeB" in out
    assert "cs.propose" in out
    assert "! annotations" in out
    assert "latency attribution" in out
