"""The port's device-cost ledger plane against the contract of
``tests/test_device_ledger.py``: ``DispatchLedger`` accounting, the
scheduler's wiring, the fill-efficiency detector and its monitor seam,
the profiling hooks (``obs/profiler.py``, the port's over
``torch.profiler``), and the ``dump_dispatch_ledger`` and profile RPC
routes (``rpc/core.py``) with their structured errors. The contracts run
one body on both packages' roots (the JAX package's as the yardstick), but
the ledger-to-shape-registry reconciliation, which runs the port's
verifier on ``device="cpu"`` (kernel 3's plain version) and leaves the JAX
package's compile to its own test. Beside them, the port's device trace:
on ``device="cpu"`` a CPU-activity trace exported and summarised; asked
for CUDA where there is none, or where the torch build's profiler has no
CUDA activity, the structured ``enabled: false`` with its reason and no
trace written; the summary's pairing of kernel and launch records by
correlation id on a synthetic trace; the profile routes on the CPU
trace. ``tools/device_report.py`` and ``tools/bench_trend.py`` are
reference tools (their tests wait for the port's, ROADMAP.md item A5e).
Tolerance: exact (ledger sums to the reference's approximations).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from .test_torch_consensus import PORT, REF, cpu_verifier  # noqa: F401 (autouse)

pytestmark = pytest.mark.ledger

ROOTS = [PORT.root, REF.root]


def ledger_ns(root: str) -> SimpleNamespace:
    """The ledger plane's names of one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    health, profiler = m("obs.health"), m("obs.profiler")
    metrics, bv = m("libs.metrics"), m("crypto.batch_verifier")
    return SimpleNamespace(
        root=root,
        obs=m("obs"),
        host=m("crypto.ed25519"),
        BatchVerifier=bv.BatchVerifier,
        SigItem=bv.SigItem,
        ShapeRegistry=m("crypto.shape_registry").ShapeRegistry,
        Registry=metrics.Registry,
        SchedulerMetrics=metrics.SchedulerMetrics,
        OK=health.OK,
        WARN=health.WARN,
        BurnRateSLO=health.BurnRateSLO,
        HealthMonitor=health.HealthMonitor,
        FillEfficiencyDetector=health.FillEfficiencyDetector,
        DispatchLedger=m("obs.ledger").DispatchLedger,
        ProfileCapture=profiler.ProfileCapture,
        ProfilerUnavailable=profiler.ProfilerUnavailable,
        VerifyScheduler=m("parallel.scheduler").VerifyScheduler,
        RPCCore=m("rpc.core").RPCCore,
        RPCError=m("rpc.server").RPCError,
    )


NS = {root: ledger_ns(root) for root in ROOTS}
LP = NS[PORT.root]


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def h(request):
    return NS[request.param]


BAD = b"\x00" * 64


def _item(h, i: int, ok: bool = True) -> h.SigItem:
    return h.SigItem(b"\x01" * 32, b"m%d" % i, b"\x02" * 64 if ok else BAD)


class StubVerifier:
    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.batches = []

    def verify(self, items):
        if self.delay:
            time.sleep(self.delay)
        self.batches.append(list(items))
        return np.array([it.sig != BAD for it in items])


def _sched(h, stub=None, ledger=None, **kw) -> h.VerifyScheduler:
    return h.VerifyScheduler(
        verifier=stub or StubVerifier(),
        metrics=h.SchedulerMetrics(h.Registry("test")),
        ledger=ledger or h.DispatchLedger(),
        **kw,
    )


# --- DispatchLedger accounting ----------------------------------------------


def test_ledger_totals_and_per_class_attribution(h):
    led = h.DispatchLedger()
    # round 1: two classes share a 64-bucket round, 48 rows requested
    led.record_round(
        1.0,
        class_rows={"consensus": 32, "blocksync": 16},
        requested=48,
        dispatched=64,
        submissions=2,
        class_subs={"consensus": 1, "blocksync": 1},
        queue_wait_s=0.004,
        class_queue_wait={"consensus": 0.001, "blocksync": 0.003},
        host_prep_s=0.002,
        device_s=0.100,
    )
    # round 2: single-class full bucket
    led.record_round(
        2.0,
        class_rows={"consensus": 64},
        requested=64,
        dispatched=64,
        submissions=4,
        device_s=0.060,
    )
    # fn-lane round: books whole, no bucket padding attributable
    led.record_round(
        3.0,
        class_rows={"sequencer": 17},
        requested=17,
        dispatched=17,
        submissions=1,
        device_s=0.010,
        engine="fn",
    )
    s = led.summary()
    assert s["rounds"] == 3
    assert s["fn_rounds"] == 1
    assert s["rows_requested"] == 112  # sig rounds only
    assert s["rows_dispatched"] == 128
    assert s["fn_rows"] == 17
    assert s["padding_rows"] == 16
    assert s["fill_ratio"] == round(112 / 128, 4)
    assert s["device_seconds"] == pytest.approx(0.170)
    # device time attributed by row share: consensus got 32/48 of round
    # 1 plus all of round 2; fn round books whole to sequencer
    pc = s["per_class"]
    assert pc["consensus"]["device_seconds"] == pytest.approx(
        0.100 * (32 / 48) + 0.060, abs=1e-6
    )
    assert pc["blocksync"]["device_seconds"] == pytest.approx(
        0.100 * (16 / 48), abs=1e-6
    )
    assert pc["sequencer"]["device_seconds"] == pytest.approx(0.010)
    # shares sum to ~1.0 over the whole ledger
    assert sum(v["device_share"] for v in pc.values()) == pytest.approx(
        1.0, abs=0.01
    )
    # single-class rounds credit submissions without class_subs
    assert pc["consensus"]["submissions"] == 1 + 4
    assert pc["blocksync"]["queue_wait_seconds"] == pytest.approx(0.003)
    # amortization curve: the 64 bucket saw 2 rounds, 6 submissions
    assert s["by_bucket"]["64"] == {
        "rounds": 2, "rows_requested": 112, "submissions": 6,
    }
    assert s["requests_per_dispatch"] == pytest.approx(7 / 3, abs=1e-3)


def test_ledger_fill_percentiles_and_entry_ring(h):
    led = h.DispatchLedger(max_entries=8)
    for i in range(20):
        # fill alternates 0.25 / 1.0
        req = 16 if i % 2 else 64
        led.record_round(
            float(i), class_rows={"consensus": req}, requested=req,
            dispatched=64, device_s=0.001,
        )
    s = led.summary()
    # totals are exact despite the 8-entry ring...
    assert s["rounds"] == 20
    assert s["rows_dispatched"] == 20 * 64
    # ...while the fill window honestly flags the truncation
    assert s["fill_window_truncated"] is True
    assert len(led.entries()) == 8
    # percentiles over retained entries: half at 0.25, half at 1.0
    assert s["fill_ratio_p50"] in (0.25, 1.0)
    assert s["fill_ratio_p95"] == 1.0
    # entries() respects since_seq and limit
    assert [e["seq"] for e in led.entries(since_seq=18)] == [18, 19]
    assert len(led.entries(limit=3)) == 3


def test_ledger_mark_and_span_summary(h):
    led = h.DispatchLedger()
    led.record_round(
        1.0, class_rows={"light": 8}, requested=8, dispatched=8,
        device_s=0.5,
    )
    mark = led.mark()
    led.record_round(
        2.0, class_rows={"consensus": 24}, requested=24, dispatched=64,
        submissions=3, device_s=0.2,
    )
    s = led.summary(since=mark)
    # the span covers only the post-mark round
    assert s["rounds"] == 1
    assert s["rows_requested"] == 24
    assert s["padding_rows"] == 40
    assert s["device_seconds"] == pytest.approx(0.2)
    assert list(s["per_class"]) == ["consensus"]
    assert s["per_class"]["consensus"]["device_share"] == pytest.approx(
        1.0
    )
    # the span rebuild carries submissions and queue wait, not just
    # rows/device time — a single-class round's submissions belong to
    # its class even without an explicit class_subs map
    assert s["per_class"]["consensus"]["submissions"] == 3
    assert s["fill_window_truncated"] is False
    # ...and explicit per-class wait survives the span view too
    led.record_round(
        3.0, class_rows={"consensus": 4, "light": 4}, requested=8,
        dispatched=8, submissions=2,
        class_subs={"consensus": 1, "light": 1},
        class_queue_wait={"consensus": 0.002, "light": 0.005},
        device_s=0.1,
    )
    s2 = led.summary(since=mark)
    assert s2["per_class"]["light"]["queue_wait_seconds"] == pytest.approx(
        0.005
    )
    assert s2["per_class"]["light"]["submissions"] == 1


def test_ledger_thread_safety_under_concurrent_records(h):
    led = h.DispatchLedger()

    def hammer(klass):
        for i in range(500):
            led.record_round(
                float(i), class_rows={klass: 4}, requested=4,
                dispatched=8, device_s=0.001,
            )

    threads = [
        threading.Thread(target=hammer, args=(k,))
        for k in ("a", "b", "c")
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s = led.summary()
    assert s["rounds"] == 1500
    assert s["rows_requested"] == 6000
    # seq ids never collide: the ring's newest entries are distinct
    seqs = [e["seq"] for e in led.entries()]
    assert len(seqs) == len(set(seqs))


# --- scheduler wiring --------------------------------------------------------


def test_scheduler_records_sig_and_fn_rounds(h):
    led = h.DispatchLedger()
    stub = StubVerifier(delay=0.02)
    s = _sched(h, stub, ledger=led)

    async def run():
        await s.start()
        first = asyncio.create_task(s.submit([_item(h, 0)], "consensus"))
        await asyncio.sleep(0.005)
        await asyncio.gather(
            s.submit([_item(h, 1), _item(h, 2)], "consensus"),
            s.submit([_item(h, 3)], "blocksync"),
            first,
        )
        await s.submit_fn(
            list(range(5)), lambda xs: [True] * len(xs), "sequencer"
        )
        await s.stop()

    asyncio.run(run())
    summ = led.summary()
    assert summ["rounds"] == 3  # solo round + coalesced round + fn
    assert summ["fn_rounds"] == 1
    assert summ["fn_rows"] == 5
    # the coalesced round carries both classes with their real rows
    coalesced = [
        e for e in led.entries()
        if e["engine"] == "sig" and len(e["classes"]) == 2
    ]
    assert len(coalesced) == 1
    assert coalesced[0]["rows"] == {"consensus": 2, "blocksync": 1}
    assert coalesced[0]["submissions"] == 2
    assert coalesced[0]["queue_wait_s"] > 0
    assert coalesced[0]["device_s"] > 0
    # tm_* accounting surface: device seconds per class, padding counter
    per_class = summ["per_class"]
    assert s.metrics.device_seconds.value(
        klass="consensus"
    ) == pytest.approx(per_class["consensus"]["device_seconds"], rel=0.05)
    assert s.metrics.padding_rows.value() == summ["padding_rows"]


def test_scheduler_dispatch_log_size_configurable(h):
    s = _sched(h, dispatch_log_size=4)
    assert s.dispatch_log.maxlen == 4
    # ledger is the accounting source of truth past the ring cap: the
    # docstring note is load-bearing, the behavior is what we pin
    led = s.ledger

    async def run():
        await s.start()
        for i in range(10):
            await s.submit([_item(h, i)], "consensus")
        await s.stop()

    asyncio.run(run())
    assert len(s.dispatch_log) == 4  # ring truncated
    assert led.summary()["rounds"] == 10  # ledger did not


def test_scheduler_ledger_reconciles_with_shape_registry():
    """Acceptance: ledger totals reconcile with the shape-registry
    dispatch counters — in steady state (key tables warm) every
    scheduler sig round is exactly one registry-recorded device
    dispatch, and the padded bucket the ledger booked is the bucket the
    verifier dispatched. (A COLD run records extra registry dispatches
    for the table-build programs — real device work that is not a
    scheduler round; warming first makes the comparison exact.) The
    port's verifier on device="cpu": its rounds are kernel 3's plain
    version."""
    h = NS[PORT.root]
    reg = h.ShapeRegistry()
    bv = h.BatchVerifier(min_device_batch=0, shape_registry=reg, device="cpu")
    led = h.DispatchLedger()
    s = h.VerifyScheduler(
        verifier=bv,
        metrics=h.SchedulerMetrics(h.Registry("test")),
        ledger=led,
    )
    k = h.host.PrivKey.from_secret(b"ledger-reconcile")
    pub = k.public_key().data

    def items(n, tag):
        return [
            h.SigItem(pub, b"%s-%d" % (tag, i), k.sign(b"%s-%d" % (tag, i)))
            for i in range(n)
        ]

    async def run():
        await s.start()
        # warm: builds the key's device table (its own registry
        # dispatch) and compiles the 8-bucket program
        assert (await s.submit(items(2, b"warm"), "consensus")).all()
        before = reg.snapshot()
        mark = led.mark()
        assert (await s.submit(items(5, b"a"), "consensus")).all()
        assert (await s.submit(items(11, b"b"), "blocksync")).all()
        await s.stop()
        return before, mark

    before, mark = asyncio.run(run())
    after = reg.snapshot()
    summ = led.summary(since=mark)
    sig_rounds = summ["rounds"] - summ["fn_rounds"]
    dispatches = (
        after["device_dispatch_count"] - before["device_dispatch_count"]
    )
    assert sig_rounds == dispatches == 2
    assert summ["rows_requested"] == 16
    # the ledger's dispatched rows are the verifier's padded buckets
    assert summ["rows_dispatched"] == sum(
        reg.bucket_for(n) for n in (5, 11)
    )
    assert summ["padding_rows"] == summ["rows_dispatched"] - 16


def test_ledger_recording_overhead_microbench(h):
    """Acceptance: ledger recording adds <2% to dispatch wall time. The
    dispatch floor is ~60-100 ms (PERF_ANALYSIS §10); 2% is >=1.2 ms
    per round. One record_round must land orders of magnitude under
    that — pin <=120 us/call mean so even a 60 ms round pays <0.2%."""
    led = h.DispatchLedger()
    class_rows = {"consensus": 48, "blocksync": 16}
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        led.record_round(
            float(i),
            class_rows=class_rows,
            requested=64,
            dispatched=64,
            submissions=2,
            class_subs={"consensus": 1, "blocksync": 1},
            queue_wait_s=0.001,
            class_queue_wait={"consensus": 0.001, "blocksync": 0.002},
            host_prep_s=0.001,
            device_s=0.06,
        )
    per_call = (time.perf_counter() - t0) / n
    assert led.summary()["rounds"] == n
    assert per_call < 120e-6, (
        f"record_round {per_call * 1e6:.1f} us/call — ledger recording "
        "must stay noise against the ~60 ms dispatch floor"
    )


# --- fill-efficiency health detector ----------------------------------------


def test_fill_efficiency_detector_floor_and_min_rows(h):
    FillEfficiencyDetector = h.FillEfficiencyDetector

    def slo():
        return h.BurnRateSLO(
            "fill", objective=0.8, short_window=30.0, long_window=300.0
        )

    det = FillEfficiencyDetector(slo(), floor=0.1, min_rows=256)
    # tiny intervals are never judged: a small committee's padded vote
    # rounds are a latency choice, not pageable waste
    t = 0.0
    for _ in range(20):
        t += 1.0
        det.observe_interval(t, 1.0, 64.0)  # fill 0.016 but 64 rows
    assert det.verdict(t) == h.OK
    # sustained 5%-full buckets at volume flags
    det2 = FillEfficiencyDetector(slo(), floor=0.1, min_rows=256)
    t = 0.0
    for _ in range(20):
        t += 1.0
        det2.observe_interval(t, 100.0, 2048.0)
    assert det2.verdict(t) >= h.WARN
    # healthy fill at volume stays h.OK
    det3 = FillEfficiencyDetector(slo(), floor=0.1, min_rows=256)
    t = 0.0
    for _ in range(20):
        t += 1.0
        det3.observe_interval(t, 1800.0, 2048.0)
    assert det3.verdict(t) == h.OK


def test_monitor_ledger_seam_flags_fill_floor(h):
    led = h.DispatchLedger()
    mon = h.HealthMonitor(
        tracer=h.obs.Tracer(enabled=True), fill_floor=0.1, fill_min_rows=256
    )
    mon.bind_ledger(led)
    t = 0.0
    for i in range(20):
        t += 1.0
        # each tick moves 2048 dispatched rows at 5% fill
        led.record_round(
            t, class_rows={"blocksync": 102}, requested=102,
            dispatched=2048, device_s=0.01,
        )
        mon.sample(t)
    assert mon.detectors["fill_efficiency"].verdict(t) >= h.WARN
    assert mon.subsystem_verdicts(t)["scheduler"] >= h.WARN
    # the verdict document names the detector
    doc = mon.verdict(t)
    assert "fill_efficiency" in doc["subsystems"]["scheduler"]["detectors"]


# --- profiling hooks ---------------------------------------------------------


def test_profile_capture_session_lifecycle(h, tmp_path):
    cap = h.ProfileCapture(str(tmp_path), sample_interval_s=0.002)
    assert cap.active is False
    started = cap.start(label="test", device=False)
    assert cap.active is True
    assert started["id"] == "profile_0001"
    assert started["device_trace"] == {"enabled": False}
    # a second start is the structured profiler-unavailable error
    with pytest.raises(h.ProfilerUnavailable):
        cap.start()
    # give the sampler a few ticks on this (busy) thread
    deadline = time.monotonic() + 0.2
    while time.monotonic() < deadline:
        sum(range(100))
    session = cap.stop()
    assert cap.active is False
    assert session["duration_s"] >= 0.0
    lp = session["loop_profile"]
    assert lp["samples"] >= 1
    assert os.path.exists(lp["path"])
    with open(lp["path"]) as f:
        doc = json.load(f)
    assert doc["samples"] == lp["samples"]
    assert doc["stacks"] and doc["stacks"][0]["count"] >= 1
    # stop with nothing running is the same structured error
    with pytest.raises(h.ProfilerUnavailable):
        cap.stop()
    # ids are monotonic across sessions
    assert cap.start(device=False)["id"] == "profile_0002"
    cap.stop()


def test_profile_capture_device_trace_guarded(h, tmp_path):
    """device=True must never raise out of start/stop: on a backend or
    environment where the jax profiler can't run, unavailability is a
    structured field inside device_trace."""
    cap = h.ProfileCapture(str(tmp_path), sample_interval_s=0.005)
    started = cap.start(device=True)
    assert "device_trace" in started
    assert isinstance(started["device_trace"].get("enabled"), bool)
    session = cap.stop()
    dt = session["device_trace"]
    if not dt["enabled"]:
        assert "error" in dt  # degraded structurally, not thrown


# --- RPC routes --------------------------------------------------------------


class _StubSched:
    def __init__(self, ledger):
        self.ledger = ledger


class _StubNode:
    class config:
        class rpc:
            unsafe = False

    def __init__(self, ledger=None, profiler=None):
        if ledger is not None:
            self.verify_scheduler = _StubSched(ledger)
        else:
            self.verify_scheduler = None
        if profiler is not None:
            self.profiler = profiler


def test_dump_dispatch_ledger_route(h, tmp_path):
    led = h.DispatchLedger()
    led.record_round(
        1.0, class_rows={"consensus": 6, "light": 2}, requested=8,
        dispatched=8, submissions=2, device_s=0.004,
    )
    core = h.RPCCore(_StubNode(ledger=led))
    out = core.dump_dispatch_ledger()
    assert out["enabled"] is True
    assert out["summary"]["rounds"] == 1
    assert out["summary"]["per_class"]["consensus"]["rows"] == 6
    assert len(out["entries"]) == 1
    assert "device_dispatch_count" in out["shape_registry"]
    # entries param caps the detail view
    for i in range(5):
        led.record_round(
            2.0 + i, class_rows={"consensus": 8}, requested=8,
            dispatched=8, device_s=0.001,
        )
    assert len(core.dump_dispatch_ledger(entries=3)["entries"]) == 3
    # entries=0 means summary-only, not "the whole ring"
    assert core.dump_dispatch_ledger(entries=0)["entries"] == []
    with pytest.raises(h.RPCError) as ei:
        core.dump_dispatch_ledger(entries="nope")
    assert ei.value.code == -32602


def test_profile_rpc_routes_and_structured_errors(h, tmp_path):
    cap = h.ProfileCapture(str(tmp_path), sample_interval_s=0.005)
    core = h.RPCCore(_StubNode(profiler=cap))
    routes = core.routes()
    assert "profile_start" in routes and "profile_stop" in routes
    # stop with no session: the profiler-unavailable structured error
    with pytest.raises(h.RPCError) as ei:
        core.profile_stop()
    assert ei.value.code == -32000
    assert "profiler unavailable" in str(ei.value.message)
    started = core.profile_start(label="rpc", device=False)
    assert started["started"] is True
    # double start: same structured error class
    with pytest.raises(h.RPCError) as ei:
        core.profile_start()
    assert ei.value.code == -32000
    time.sleep(0.03)
    stopped = core.profile_stop()
    assert stopped["stopped"] is True
    assert "loop_profile" in stopped
    # a node assembled WITHOUT a profiler does not expose the routes
    bare = h.RPCCore(_StubNode())
    assert "profile_start" not in bare.routes()
    assert "dump_dispatch_ledger" in bare.routes()
    # ...and its ledger dump reports the scheduler-less state honestly
    assert bare.dump_dispatch_ledger()["enabled"] is False


# --- the port's device trace (torch.profiler) --------------------------------


def _busy(seconds: float) -> None:
    import torch

    deadline = time.monotonic() + seconds
    x = torch.ones(64, 64)
    while time.monotonic() < deadline:
        x = (x @ x).clamp_(max=1.0)


def test_cpu_trace_exports_and_summarises(tmp_path):
    """On device="cpu" the device trace is a CPU-activity torch.profiler
    trace: started enabled, exported into the session directory at stop,
    its summary holding no kernel (no CUDA activity was asked for)."""
    cap = LP.ProfileCapture(str(tmp_path), sample_interval_s=0.002, device="cpu")
    started = cap.start(label="cpu", device=True)
    dt = started["device_trace"]
    assert dt["enabled"] is True and dt["device"] == "cpu"
    assert dt["activities"] == ["CPU"]
    _busy(0.05)
    session = cap.stop()
    dt = session["device_trace"]
    assert "stop_error" not in dt, dt
    assert dt["path"] == os.path.join(started["dir"], "device_trace.json")
    with open(dt["path"]) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names
    assert dt["kernels"] == [] and dt["launch_calls"] == 0 and dt["unpaired"] == 0
    assert session["loop_profile"]["samples"] >= 1


def test_cuda_trace_without_cuda_is_off_with_its_reason(tmp_path, monkeypatch):
    """Asked for CUDA on a machine without it, the trace is off with the
    reason, and no CPU-only trace stands in for it: no trace file, no
    summary. The same where CUDA is there but the build's profiler has no
    CUDA activity."""
    import torch
    import torch.profiler

    cap = LP.ProfileCapture(str(tmp_path / "a"), device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = cap.start(device=True)
    assert started["device_trace"]["enabled"] is False
    assert "is_available() is false" in started["device_trace"]["error"]
    session = cap.stop()
    assert "path" not in session["device_trace"] and "kernels" not in session["device_trace"]
    assert not os.path.exists(os.path.join(session["dir"], "device_trace.json"))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    cap = LP.ProfileCapture(str(tmp_path / "b"), device="cuda:0")
    dt = cap.start(device=True)["device_trace"]
    assert dt["enabled"] is False and "no CUDA activity" in dt["error"], dt
    session = cap.stop()
    assert not os.path.exists(os.path.join(session["dir"], "device_trace.json"))
    # an unknown device is refused the same way
    cap = LP.ProfileCapture(str(tmp_path / "c"), device="mps")
    assert cap.start()["device_trace"]["enabled"] is False
    cap.stop()


def _trace_events():
    """A synthetic Chrome trace as torch.profiler exports one with CUDA
    activity: three launches of one kernel (one by a runtime call over a
    driver call of the same correlation), one of another, one kernel whose
    launch record is missing, a memcpy."""
    def x(cat, name, ts, dur, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    return {"traceEvents": [
        x("cpu_op", "aten::empty", 0.0, 5.0),
        x("cuda_runtime", "cudaLaunchKernel", 100.0, 4.0, 1),
        x("kernel", "verify_table_kernel(unsigned char const*, int)", 110.0, 700.0, 1),
        x("cuda_driver", "cuLaunchKernel", 900.0, 2.0, 2),
        x("cuda_runtime", "cudaLaunchKernel", 899.0, 6.0, 2),
        x("kernel", "verify_table_kernel(unsigned char const*, int)", 920.0, 690.0, 2),
        x("cuda_runtime", "cudaLaunchKernel", 2000.0, 5.0, 3),
        x("kernel", "void (anonymous namespace)::verify_table_kernel(unsigned char const*, int)",
          2030.0, 710.0, 3),
        x("cuda_runtime", "cudaLaunchKernel", 3000.0, 3.0, 4),
        x("kernel", "neg_pubkey_table_kernel<4>(unsigned char const*)", 3010.0, 180.0, 4),
        x("kernel", "at::native::vectorized_elementwise_kernel<4>(int)", 3300.0, 2.0, 99),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50.0, 3.0, 7),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 100.0, "id": 1},
    ]}


def test_device_trace_summary_pairs_kernels_and_launches():
    """The summary's per-kernel split: kernel and launch records pair by
    correlation id (a runtime call outranks the driver call under it);
    device, launch and queue times in ms, totals and medians; a kernel
    without its launch record is counted but not split."""
    profiler = importlib.import_module(f"{PORT.root}.obs.profiler")
    s = profiler.device_trace_summary(_trace_events())
    rows = {r["name"]: r for r in s["kernels"]}
    assert [r["name"] for r in s["kernels"]] == [
        "verify_table_kernel", "neg_pubkey_table_kernel", "at::native::vectorized_elementwise_kernel"]
    v = rows["verify_table_kernel"]
    assert (v["launches"], v["paired"]) == (3, 3)
    assert v["device_ms"] == {"total": 2.1, "median": 0.7}
    assert v["launch_ms"] == {"total": 0.015, "median": 0.005}
    assert v["queue_ms"] == {"total": 0.061, "median": 0.021}
    n = rows["neg_pubkey_table_kernel"]
    assert (n["launches"], n["paired"], n["queue_ms"]["median"]) == (1, 1, 0.01)
    other = rows["at::native::vectorized_elementwise_kernel"]
    assert (other["launches"], other["paired"], other["launch_ms"]["median"]) == (1, 0, None)
    assert s["unpaired"] == 1 and s["launch_calls"] == 5
    assert s["other_gpu"] == {"gpu_memcpy": {"events": 1, "ms": 0.003}}
    assert profiler.kernel_short_name("void g1_tree_g<4>(int*)") == "g1_tree_g"
    assert profiler.kernel_short_name(
        "void (anonymous namespace)::neg_pubkey_table_kernel(unsigned char const*)"
    ) == "neg_pubkey_table_kernel"


def test_profile_routes_arm_the_cpu_trace(tmp_path):
    """profile_start/profile_stop over the port's RPCCore with a capture
    on device="cpu": the device trace is on, the stop record carries its
    path and summary beside the loop profile; a second start is -32000."""
    cap = LP.ProfileCapture(str(tmp_path), sample_interval_s=0.002, device="cpu")
    core = LP.RPCCore(_StubNode(profiler=cap))
    started = core.profile_start(label="rpc", device="true")
    assert started["started"] is True and started["device_trace"]["enabled"] is True
    with pytest.raises(LP.RPCError) as ei:
        core.profile_start(device=True)
    assert ei.value.code == -32000
    _busy(0.03)
    stopped = core.profile_stop()
    assert stopped["stopped"] is True
    assert os.path.exists(stopped["device_trace"]["path"])
    assert stopped["device_trace"]["kernels"] == []
    assert stopped["loop_profile"]["samples"] >= 1
    assert core.profile_start(device="false")["device_trace"] == {"enabled": False}
    core.profile_stop()
