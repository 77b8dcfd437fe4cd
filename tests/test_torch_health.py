"""The port's live health plane (``obs/health.py``) against the contract
of ``tests/test_health.py``: burn-rate window math, the detectors on
synthetic timestamped streams, the monitor's pull seams over real
``libs.metrics`` objects, incidents into the tracer ring and the gauges,
the verdict document, the event-loop heartbeat; the ipc round-trip
detector and the remote-scheduler seam of ``tests/test_verify_service.py``;
and the chaos e2e on a 4-validator mesh of the port over encrypted p2p
(``tests/torch_chaos_harness.py`` on ``device="cpu"``): a 400 ms straggler
flips the victim's quorum-lag detector to warn and nothing else. The unit
contracts run one body on both packages' roots (the JAX package's as the
yardstick). Beside them, parity: both packages' monitors fed one seeded
stream give the same verdict document. ``HealthMonitor.from_config`` and
the ipc knob of ``HealthConfig`` wait for the port's ``config`` (ROADMAP.md,
item A5e); the bench-trend tests test a reference tool. Tolerance: exact
(verdicts, documents); the detectors' thresholds as the reference states
them.
"""

import asyncio
import importlib
import random
import time
from types import SimpleNamespace

import pytest

from .test_torch_consensus import PORT, REF, cpu_verifier  # noqa: F401 (autouse)

pytestmark = pytest.mark.health

ROOTS = [PORT.root, REF.root]
_DETECTORS = (
    "BurnRateSLO", "EventLoopLagDetector", "HealthMonitor", "LatencyDriftDetector",
    "PeerFlapDetector", "QuorumLagDetector", "RoundChurnDetector",
    "SchedulerSaturationDetector", "StalledRoundDetector", "IpcRoundTripDetector",
    "CRITICAL", "OK", "WARN",
)


def health_ns(root: str) -> SimpleNamespace:
    """The health plane's names of one package, with its metrics and obs."""
    health = importlib.import_module(f"{root}.obs.health")
    metrics = importlib.import_module(f"{root}.libs.metrics")
    return SimpleNamespace(
        root=root,
        obs=importlib.import_module(f"{root}.obs"),
        Counter=metrics.Counter,
        HealthMetrics=metrics.HealthMetrics,
        Histogram=metrics.Histogram,
        Registry=metrics.Registry,
        SchedulerMetrics=metrics.SchedulerMetrics,
        **{name: getattr(health, name) for name in _DETECTORS},
    )


NS = {root: health_ns(root) for root in ROOTS}
HP = NS[PORT.root]


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def h(request):
    return NS[request.param]


def _slo(h, objective=0.9, short=30.0, long=300.0, **kw):
    return h.BurnRateSLO(
        "t", objective=objective, short_window=short, long_window=long, **kw
    )


# --- burn-rate window math --------------------------------------------------


def test_burn_rate_multiwindow_math(h):
    slo = _slo(h, objective=0.9, min_events=4)
    # 10 good events: zero burn, ok
    for i in range(10):
        slo.observe(float(i), bad=0)
    assert slo.burn(10.0) == 0.0
    assert slo.verdict(10.0) == h.OK
    # 3 bad of the next 10: 3/20 = 0.15 bad fraction over a 10% budget
    # -> burn 1.5 in both windows -> warn, below the 6x critical gate
    for i in range(10, 20):
        slo.observe(float(i), bad=1 if i % 3 == 0 else 0)
    t = 20.0
    assert slo.burn(t) == pytest.approx((3 / 20) / 0.1)
    assert slo.verdict(t) == h.WARN


def test_burn_rate_critical_requires_both_windows(h):
    slo = _slo(h, objective=0.9, min_events=4)
    # an all-bad burst: burn 10x in both windows -> critical
    for i in range(8):
        slo.observe(float(i), bad=1)
    assert slo.verdict(8.0) == h.CRITICAL
    # 40 s later the short window holds no events (burn 0) while the
    # long window still carries the burst: a recovered incident
    # un-pages as the short window drains
    t = 45.0
    assert slo.burn(t, slo.long_window) > 1.0
    assert slo.burn(t, slo.short_window) == 0.0
    assert slo.verdict(t) == h.OK


def test_burn_rate_min_events_and_prune(h):
    slo = _slo(h, objective=0.9, min_events=4)
    for i in range(3):
        slo.observe(float(i), bad=1)
    # under min_events the verdict stays ok no matter the burn
    assert slo.verdict(3.0) == h.OK
    slo.observe(3.0, bad=1)
    assert slo.verdict(3.5) == h.CRITICAL
    # everything ages past the long window -> pruned -> ok again
    assert slo.verdict(400.0) == h.OK
    assert len(slo._events) == 0


def test_burn_rate_validates_params(h):
    with pytest.raises(ValueError):
        h.BurnRateSLO("x", objective=1.0)
    with pytest.raises(ValueError):
        h.BurnRateSLO("x", short_window=60.0, long_window=30.0)


# --- detectors on synthetic streams ----------------------------------------


def test_round_churn_detector(h):
    det = h.RoundChurnDetector(_slo(h, objective=0.9))
    for i in range(10):
        det.observe_height(float(i), round_=0)
    assert det.verdict(10.0) == h.OK
    # 2 churned heights in the next 10 -> burn 2x -> warn
    for i in range(10, 20):
        det.observe_height(float(i), round_=1 if i < 12 else 0)
    assert det.verdict(20.0) == h.WARN
    assert det.last_value == 0.0  # last height committed at round 0


def test_round_churn_sustained_goes_critical(h):
    det = h.RoundChurnDetector(_slo(h, objective=0.9))
    for i in range(10):
        det.observe_height(float(i), round_=2)
    assert det.verdict(10.0) == h.CRITICAL


def test_stalled_round_direct_critical_without_events(h):
    det = h.StalledRoundDetector(_slo(h, objective=0.9), ceiling_s=20.0)
    det.arm(0.0)
    # a burn window over zero events never fires — the stall must page
    # through the direct condition
    assert det.verdict(10.0) == h.OK
    assert det.verdict(25.0) == h.CRITICAL
    assert det.last_value == 25.0
    # a commit resets the stall clock
    det.observe_height(26.0)
    assert det.verdict(30.0) == h.OK
    # near-stall intervals feed the SLO: repeated slow heights warn
    t = 26.0
    for _ in range(8):
        t += 21.0
        det.observe_height(t)
    assert det.slo.verdict(t) == h.CRITICAL  # every interval over ceiling


def test_stalled_round_near_stall_warns_before_paging(h):
    # intervals past near_stall_fraction x ceiling but UNDER the
    # ceiling book bad SLO events: the committee slipping toward the
    # stall warns while the direct page stays quiet
    det = h.StalledRoundDetector(_slo(h, objective=0.9), ceiling_s=20.0)
    det.arm(0.0)
    t = 0.0
    for _ in range(8):
        t += 12.0  # > 10 (near-stall bar), < 20 (page bar)
        det.observe_height(t)
        assert det._direct(t) == h.OK  # never pages
    assert det.slo.verdict(t) >= h.WARN
    assert det.verdict(t) >= h.WARN
    # healthy cadence books good events and recovers as windows drain
    det2 = h.StalledRoundDetector(_slo(h, objective=0.9), ceiling_s=20.0)
    det2.arm(0.0)
    t = 0.0
    for _ in range(8):
        t += 5.0
        det2.observe_height(t)
    assert det2.verdict(t) == h.OK


def test_quorum_lag_warmup_learns_before_judging(h):
    det = h.QuorumLagDetector(
        _slo(h, objective=0.9, min_events=8), floor_s=0.025, min_baseline=16
    )
    # the first min_baseline samples are learning-only: even lags far
    # over the floor record NO SLO events (you can't call an anomaly
    # before a baseline exists — the clean gossip plane's genuine
    # trickle spread would false-flag against the static floor)
    for i in range(16):
        det.observe_lag(float(i), 0.06)
    assert len(det.slo._events) == 0
    assert det.verdict(16.0) == h.OK
    # post-warmup the learned tail IS the bar: 2 x p95(60 ms) = 120 ms
    assert det.threshold() == pytest.approx(0.12)
    det.observe_lag(17.0, 0.06)  # inside the learned spread: good
    assert det.slo._events[-1][1] == 0


def test_quorum_lag_baseline_not_poisoned_by_straggler(h):
    det = h.QuorumLagDetector(
        _slo(h, objective=0.9, min_events=8),
        floor_s=0.025,
        margin=4.0,
        min_baseline=16,
    )
    # clean phase: sub-ms arrivals learn the baseline (16 warmup + 4
    # judged-good)
    for i in range(20):
        det.observe_lag(float(i), 0.001)
    assert det.verdict(20.0) == h.OK
    thr_before = det.threshold()
    assert thr_before == pytest.approx(0.025)  # floor dominates
    # straggler phase: one of three arrivals comes 50 ms late
    t = 20.0
    for i in range(12):
        t += 1.0
        det.observe_lag(t, 0.05)
        det.observe_lag(t, 0.001)
        det.observe_lag(t, 0.001)
    assert det.verdict(t) == h.WARN
    # the bad samples were never admitted to the baseline: a persistent
    # straggler keeps flagging instead of teaching the detector that
    # 50 ms is normal
    assert det.threshold() == pytest.approx(thr_before)
    assert det.snapshot(t)["baseline_p95"] < 0.01
    assert det.last_threshold == pytest.approx(0.025)
    assert det.snapshot(t)["last_bad"] == pytest.approx(0.05)


def test_scheduler_saturation_detector(h):
    det = h.SchedulerSaturationDetector(
        _slo(h, objective=0.8), depth_floor=256
    )
    # shallow queue: never saturated regardless of fill
    for i in range(10):
        det.observe_sample(float(i), 10.0, 1.0, 0)
    assert det.verdict(10.0) == h.OK
    # deep queue with no dispatch progress -> saturated -> warn
    t = 10.0
    for i in range(10):
        t += 1.0
        det.observe_sample(t, 500.0, 1.0, 0)
    assert det.verdict(t) >= h.WARN
    # deep queue but dispatches advancing with partial fill = the
    # device is draining a burst, not saturated
    det2 = h.SchedulerSaturationDetector(
        _slo(h, objective=0.8), depth_floor=256
    )
    for i in range(10):
        det2.observe_sample(float(i), 500.0, 0.5, 3)
    assert det2.verdict(10.0) == h.OK


def test_latency_drift_detector_learns_then_flags(h):
    det = h.LatencyDriftDetector(
        _slo(h, objective=0.8), drift_factor=4.0, abs_floor_s=0.001
    )
    # below min_baseline the threshold is inf: nothing can flag
    for i in range(8):
        det.observe_mean(float(i), 0.002)
    assert det.verdict(8.0) == h.OK
    thr = det.threshold()
    assert thr == pytest.approx(0.008)  # 4 x the 2 ms median
    # a degrading disk: interval means drift to 20 ms
    t = 8.0
    for i in range(10):
        t += 1.0
        det.observe_mean(t, 0.02)
    assert det.verdict(t) >= h.WARN
    # drifted samples never join the baseline
    assert det.threshold() == pytest.approx(thr)


def test_peer_flap_detector(h):
    det = h.PeerFlapDetector(_slo(h, objective=0.8))
    for i, n in enumerate((4, 4, 4, 4, 4, 4)):
        det.observe_count(float(i), n)
    assert det.verdict(6.0) == h.OK
    # connect/drop cycling: every drop is a bad event
    t = 6.0
    for n in (3, 4, 2, 4, 1, 4, 2, 3):
        t += 1.0
        det.observe_count(t, n)
    assert det.verdict(t) >= h.WARN
    # a STABLE small peer set is fine — flap is churn, not size
    det2 = h.PeerFlapDetector(_slo(h, objective=0.8))
    for i in range(10):
        det2.observe_count(float(i), 1)
    assert det2.verdict(10.0) == h.OK


def test_event_loop_lag_detector(h):
    det = h.EventLoopLagDetector(_slo(h, objective=0.9, min_events=8),
                               lag_warn_s=0.05)
    for i in range(20):
        det.observe_lag(float(i), 0.002)
    assert det.verdict(20.0) == h.OK
    # the loop-bound regime: sustained lag dominates BOTH windows (the
    # long window needs >= 60% bad against the 10% budget to cross the
    # 6x critical gate)
    t = 20.0
    for i in range(60):
        t += 1.0
        det.observe_lag(t, 0.2)
    assert det.verdict(t) == h.CRITICAL


# --- monitor: pull seams over real metric objects ---------------------------


def _monitor(h, **kw):
    kw.setdefault("tracer", h.obs.Tracer(enabled=True))
    return h.HealthMonitor(**kw)


def test_monitor_scheduler_seam(h):
    reg = h.Registry()
    sm = h.SchedulerMetrics(reg)
    mon = _monitor(h)
    mon.bind_scheduler(sm)
    sm.queue_depth.inc(500, klass="consensus")
    sm.batch_fill_ratio.set(1.0)
    t = 0.0
    for i in range(10):
        t += 1.0
        mon.sample(t)  # depth 500, fill 1.0, no dispatch progress
    assert mon.detectors["scheduler_saturation"].verdict(t) >= h.WARN
    assert mon.subsystem_verdicts(t)["scheduler"] >= h.WARN


def test_monitor_wal_drift_seam(h):
    reg = h.Registry()
    hist = reg.histogram(
        "wal_fsync_seconds", "", buckets=(0.001, 0.01, 0.1, float("inf"))
    )
    mon = _monitor(h)
    mon.bind_wal(hist)
    t = 0.0
    mon.sample(t)  # establishes the cumulative baseline
    # healthy disk: 2 ms fsyncs, interval means learn the baseline
    for i in range(10):
        for _ in range(4):
            hist.observe(0.002)
        t += 1.0
        mon.sample(t)
    assert mon.detectors["wal_fsync_drift"].verdict(t) == h.OK
    # the disk degrades: 30 ms interval means, > 4 x the 2 ms median
    for i in range(10):
        for _ in range(4):
            hist.observe(0.03)
        t += 1.0
        mon.sample(t)
    assert mon.detectors["wal_fsync_drift"].verdict(t) >= h.WARN
    assert mon.subsystem_verdicts(t)["wal"] >= h.WARN


def test_monitor_sequencer_slo_seam(h):
    reg = h.Registry()
    hist = reg.histogram(
        "sequencer_apply_latency_seconds",
        "",
        buckets=(0.01, 0.05, 0.1, 0.5, 1.0, float("inf")),
    )
    mon = _monitor(h)
    mon.bind_sequencer(hist)
    t = 0.0
    mon.sample(t)
    # 20 applies inside the 100 ms target: good
    for _ in range(20):
        hist.observe(0.02)
    t += 1.0
    mon.sample(t)
    assert mon.detectors["sequencer_apply_slo"].verdict(t) == h.OK
    # the polling-floor regression: applies land at 500 ms
    for i in range(3):
        for _ in range(20):
            hist.observe(0.5)
        t += 1.0
        mon.sample(t)
    assert mon.detectors["sequencer_apply_slo"].verdict(t) == h.CRITICAL
    assert mon.subsystem_verdicts(t)["sequencer"] == h.CRITICAL


def test_monitor_lightserve_hit_rate_seam(h):
    reg = h.Registry()

    class LS:
        cache_hits = reg.counter("ls_hits", "")
        cache_misses = reg.counter("ls_misses", "")

    mon = _monitor(h)
    mon.bind_lightserve(LS())
    t = 0.0
    LS.cache_hits.inc(100)
    mon.sample(t)
    t += 1.0
    mon.sample(t)  # no new traffic: no event recorded
    assert mon.detectors["lightserve_hit_rate"].verdict(t) == h.OK
    # hit rate collapses to 50% against the 0.9 floor
    for i in range(3):
        LS.cache_hits.inc(50)
        LS.cache_misses.inc(50)
        t += 1.0
        mon.sample(t)
    assert mon.detectors["lightserve_hit_rate"].verdict(t) >= h.WARN


def test_monitor_peer_seam_and_status_rollup(h):
    class Sw:
        peers = {}

    mon = _monitor(h)
    mon.bind_switch(Sw())
    t = 0.0
    sizes = [4, 4, 3, 4, 2, 4, 1, 4, 2, 4, 1, 4]
    for n in sizes:
        Sw.peers = {i: None for i in range(n)}
        t += 1.0
        mon.sample(t)
    assert mon.detectors["peer_flap"].verdict(t) >= h.WARN
    verdicts = mon.subsystem_verdicts(t)
    assert verdicts["p2p"] >= h.WARN
    assert mon.status(t) >= h.WARN
    # untouched subsystems stay ok in the roll-up
    assert verdicts["consensus"] == h.OK
    assert verdicts["runtime"] == h.OK


def test_monitor_seam_isolation_and_detector_thresholds(h):
    """A pull seam that raises every tick (a bound metrics object
    changing shape) must not starve the seams bound after it or the
    end-of-tick evaluation — the watchdog-fails-dark class — and the
    floor/flap detectors must carry the bar they judged against, not
    the 0.0 Detector default."""

    class BrokenDepth:
        def total(self):
            raise AttributeError("metrics object changed shape")

    class BrokenSched:
        queue_depth = BrokenDepth()

    class Sw:
        peers = {}

    mon = _monitor(h)
    mon.bind_scheduler(BrokenSched())  # first seam in the pull order
    mon.bind_switch(Sw())  # last seam in the pull order
    t = 0.0
    sizes = [4, 4, 3, 4, 2, 4, 1, 4, 2, 4, 1, 4]
    for n in sizes:
        Sw.peers = {i: None for i in range(n)}
        t += 1.0
        mon.sample(t)  # scheduler raises every tick; p2p still feeds
    assert mon.detectors["peer_flap"].verdict(t) >= h.WARN
    # evaluation still ran: the flap transition emitted its incident
    assert any(i["detector"] == "peer_flap" for i in mon.incidents)
    # the flap threshold is the count the drop came FROM, surviving
    # the recovery ticks in between
    assert mon.detectors["peer_flap"].last_threshold == 4.0
    # the hit-rate floor detector's threshold IS its SLO objective
    ls = mon.detectors["lightserve_hit_rate"]
    assert ls.last_threshold == ls.slo.objective > 0.0


def test_status_query_pages_unstarted_stall(h):
    """A node stalled from genesis: start() never called, no feeds at
    all. The first status query arms the stall clock; a query past the
    ceiling must page h.CRITICAL — and status()/verdict() must agree
    (the soak divergence artifact carries both)."""
    mon = _monitor(h, stall_ceiling_s=10.0)
    assert mon.status(0.0) == h.OK  # arms at first evaluation
    assert mon.status(5.0) == h.OK
    assert mon.status(11.0) == h.CRITICAL
    assert mon.subsystem_verdicts(11.0)["consensus"] == h.CRITICAL
    doc = mon.verdict(11.0)
    assert doc["status"] == "critical"
    assert any(i["detector"] == "stalled_round" for i in mon.incidents)
    # a commit recovers it on the next query
    mon.observe_height_committed(7, 0, t=12.0)
    assert mon.status(12.5) == h.OK


# --- monitor: incidents, gauges, verdict document ---------------------------


def _drive_quorum_warn(h, mon, t0=0.0):
    """Deterministic OK->WARN flip of the quorum-lag detector: 40
    clean sub-ms arrivals (32 warmup + 8 judged good), then a quarter
    of the stream straggling at 50 ms against the 25 ms floor — ~4x
    the 5% budget: warn, under the 6x critical gate."""
    t = t0
    for i in range(40):
        t += 0.1
        mon.observe_vote_arrival(1, 0.001, t=t)
    for i in range(12):
        t += 0.1
        mon.observe_vote_arrival(1, 0.05, t=t)
        for _ in range(3):
            mon.observe_vote_arrival(1, 0.001, t=t)
    mon.observe_height_committed(5, 0, t=t)  # commits trigger _evaluate
    return t


def test_incident_emission_into_tracer_and_gauges(h):
    tracer = h.obs.Tracer(enabled=True)
    reg = h.Registry()
    hm = h.HealthMetrics(reg)
    mon = h.HealthMonitor(tracer=tracer, metrics=hm)
    t = _drive_quorum_warn(h, mon)

    assert mon.detectors["quorum_lag"].verdict(t) == h.WARN
    # the transition emitted exactly one structured incident
    incidents = [r for r in tracer.records() if r.name == "health.incident"]
    assert len(incidents) == 1
    f = incidents[0].fields
    assert f["slo"] == "quorum_lag"
    assert f["subsystem"] == "consensus"
    assert (f["from"], f["to"]) == ("ok", "warn")
    # the escalation carries the OFFENDING lag (the 50 ms straggler),
    # not whatever good sample arrived after it
    assert f["value"] == pytest.approx(0.05)
    assert f["value"] > f["threshold"] > 0
    assert mon.incidents[-1]["detector"] == "quorum_lag"

    # gauges carry the roll-up: tm_health_status{subsystem="consensus"}
    # >= warn, burn rate exported per slo, incident counted
    assert hm.status.value(subsystem="consensus") >= h.WARN
    assert hm.burn_rate.value(slo="quorum_lag") >= 1.0
    assert hm.incidents.value(subsystem="consensus") == 1
    body = reg.render()
    assert 'tm_health_status{subsystem="consensus"}' in body
    assert 'tm_slo_burn_rate{slo="quorum_lag"}' in body

    # recovery: the stream goes quiet, both windows drain, the detector
    # un-pages and the ok transition is ALSO an incident record
    mon.observe_height_committed(6, 0, t=t + 400.0)
    incidents = [r for r in tracer.records() if r.name == "health.incident"]
    assert incidents[-1].fields["to"] == "ok"
    assert hm.status.value(subsystem="consensus") == h.OK


def test_verdict_document_shape(h):
    mon = h.HealthMonitor(tracer=h.obs.Tracer(enabled=True))
    t = _drive_quorum_warn(h, mon)
    doc = mon.verdict(t)
    assert doc["status"] == "warn" and doc["code"] == h.WARN
    assert set(doc["subsystems"]) == {
        "consensus", "scheduler", "wal", "sequencer", "lightserve",
        "p2p", "runtime",
    }
    cons = doc["subsystems"]["consensus"]
    assert cons["status"] == "warn"
    assert cons["detectors"]["quorum_lag"]["status"] == "warn"
    assert cons["detectors"]["quorum_lag"]["burn_long"] >= 1.0
    assert cons["detectors"]["round_churn"]["status"] == "ok"
    assert doc["incidents"][-1]["to"] == "warn"
    # stall pages through verdict() even with no event feed at all
    mon2 = h.HealthMonitor(tracer=h.obs.Tracer(enabled=True),
                         stall_ceiling_s=20.0)
    mon2.stalled_round.arm(0.0)
    doc2 = mon2.verdict(25.0)
    assert doc2["subsystems"]["consensus"]["status"] == "critical"


def test_monitor_determinism_on_identical_streams(h):
    def drive(mon):
        t = 0.0
        for i in range(30):
            t += 0.5
            mon.observe_vote_arrival(1, 0.05 if i % 3 == 0 else 0.001, t=t)
            if i % 5 == 4:
                mon.observe_height_committed(i // 5 + 1, i % 2, t=t)
        return mon.verdict(t)

    a = drive(h.HealthMonitor(tracer=h.obs.Tracer(enabled=True)))
    b = drive(h.HealthMonitor(tracer=h.obs.Tracer(enabled=True)))
    assert a == b


def test_heartbeat_probe_measures_loop_lag(h):
    """The event-loop lag probe: a blocking callback makes the
    heartbeat's sleep overshoot, and the overshoot lands in the
    detector's SLO stream (the loop-bound regime, measured)."""

    async def run():
        mon = h.HealthMonitor(
            tracer=h.obs.Tracer(enabled=True),
            interval=10.0,  # keep the sample loop out of the way
            heartbeat_interval=0.02,
        )
        await mon.start()
        try:
            await asyncio.sleep(0.1)  # a few clean beats
            clean = len(mon.event_loop_lag.slo._events)
            assert clean >= 2
            time.sleep(0.25)  # block the loop: the next beat is late
            await asyncio.sleep(0.05)
            # the overshoot was recorded as a bad event (clean beats
            # may have followed and moved last_value on)
            assert mon.event_loop_lag.last_bad >= 0.1
            assert any(
                b for _, b, _ in mon.event_loop_lag.slo._events
            )
        finally:
            await mon.stop()
        assert not mon._tasks

    asyncio.run(run())


# --- the ipc round-trip detector (tests/test_verify_service.py) -------------


def test_ipc_detector_learns_then_flags_drift(h):
    det = h.IpcRoundTripDetector(
        h.BurnRateSLO(
            "ipc_round_trip",
            objective=0.8,
            short_window=30.0,
            long_window=300.0,
        )
    )
    t = 0.0
    for _ in range(16):  # learn a ~2 ms baseline
        t += 1.0
        det.observe_interval(t, mean_rtt_s=0.002)
    assert det.verdict(t) == h.OK
    assert det.threshold() == pytest.approx(0.008)
    for _ in range(12):  # 10x the learned median, sustained
        t += 1.0
        det.observe_interval(t, mean_rtt_s=0.02)
    assert det.verdict(t) >= h.WARN
    assert det.last_threshold == pytest.approx(0.008)
    # drifted samples never taught the baseline
    assert det.threshold() == pytest.approx(0.008)


def test_ipc_detector_pages_on_degrades(h):
    det = h.IpcRoundTripDetector(
        h.BurnRateSLO(
            "ipc_round_trip",
            objective=0.8,
            short_window=30.0,
            long_window=300.0,
        )
    )
    t = 0.0
    for _ in range(8):  # every interval saw local-degrade fallbacks
        t += 1.0
        det.observe_interval(t, mean_rtt_s=None, degrades=3)
    assert det.verdict(t) >= h.WARN


def test_monitor_remote_scheduler_seam(h):
    """bind_remote_scheduler pulls ipc_stats() deltas: first sample is
    baseline-only, then interval means + degrades feed the detector and
    the verdict document carries it under the scheduler subsystem."""
    class FakeRemote:
        def __init__(self):
            self.stats = {
                "rtt_count": 0,
                "rtt_sum_s": 0.0,
                "remote_submissions": 0,
                "degrades": 0,
                "reconnects": 1,
                "connected": True,
            }

        def ipc_stats(self):
            return dict(self.stats)

    mon = h.HealthMonitor(tracer=h.obs.Tracer(enabled=True))
    remote = FakeRemote()
    mon.bind_remote_scheduler(remote)
    t = 0.0
    mon.sample(t)  # first sample: baseline only
    det = mon.detectors["ipc_round_trip"]
    assert det.subsystem == "scheduler"
    for _ in range(16):  # healthy 2 ms intervals
        t += 1.0
        remote.stats["rtt_count"] += 10
        remote.stats["rtt_sum_s"] += 10 * 0.002
        mon.sample(t)
    assert mon.subsystem_verdicts(t)["scheduler"] == 0
    for _ in range(12):  # service wedges: degrades + drifted RTT
        t += 1.0
        remote.stats["rtt_count"] += 10
        remote.stats["rtt_sum_s"] += 10 * 0.05
        remote.stats["degrades"] += 4
        mon.sample(t)
    assert mon.detectors["ipc_round_trip"].verdict(t) >= h.WARN
    assert mon.subsystem_verdicts(t)["scheduler"] >= h.WARN
    doc = mon.verdict(t)
    assert "ipc_round_trip" in doc["subsystems"]["scheduler"]["detectors"]


# --- parity: one seeded stream, both packages -------------------------------


def _seeded_stream(seed: int):
    """(kind, args, t) feeds of a monitor: vote arrivals with seeded lags,
    a straggling quarter past the halfway mark, commits with seeded
    rounds."""
    rng = random.Random(seed)
    t, out = 0.0, []
    for i in range(400):
        t += rng.uniform(0.01, 0.2)
        late = i > 200 and rng.random() < 0.25
        out.append(("vote", (1 + i % 2, 0.05 if late else rng.uniform(0.0, 0.004)), t))
        if i % 8 == 7:
            out.append(("commit", (i // 8 + 1, int(rng.random() < 0.1)), t))
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_monitors_of_both_packages_agree_on_a_seeded_stream(seed):
    docs, incidents = [], []
    for ns in (HP, NS[REF.root]):
        mon = ns.HealthMonitor(tracer=ns.obs.Tracer(enabled=True),
                               metrics=ns.HealthMetrics(ns.Registry()))
        for kind, args, t in _seeded_stream(seed):
            if kind == "vote":
                mon.observe_vote_arrival(*args, t=t)
            else:
                mon.observe_height_committed(*args, t=t)
        docs.append(mon.verdict(t))
        incidents.append([(r.name, r.fields) for r in mon.tracer.records()
                          if r.name == "health.incident"])
    assert docs[0] == docs[1]
    assert incidents[0] == incidents[1] and incidents[0]
    assert docs[0]["subsystems"]["consensus"]["detectors"]["quorum_lag"]["status"] != "ok"


# --- chaos e2e: the straggler flips exactly the quorum-lag detector ---------


@pytest.mark.chaos
def test_chaos_straggler_flips_quorum_lag_to_warn(monkeypatch):
    """The reference's chaos e2e on the port's mesh: powers 40/20/20/20
    (the heavy validator's vote is in every 2/3), a live health plane on
    every node. Clean heights first (no detector critical, every baseline
    past its warmup), then 400 ms on every outbound link of the heavy
    validator: within K=10 heights the victim's quorum-lag detector is at
    warn, its last bad lag over 0.3 s and its learned bar between the
    25 ms floor and the injection, nothing critical anywhere, every
    non-ok detector a consensus one; the incident is in the victim's
    dump_traces ring and tm_health_status reads warn for consensus, ok for
    every other subsystem.

    Each distinct signature is checked once on the host oracle
    (memoize_host_oracle): every node of the mesh checks every vote and
    LastCommit on it, ~4 ms a signature in Python behind one GIL, which
    widened the clean arrival spread (p95 ~0.23 s on a quiet host) until
    the learned bar, 2 x p95, passed the 400 ms injection."""
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
    monitors, registries = {}, {}

    def health_factory(name, tracer):
        reg = HP.Registry()
        monitors[name] = HP.HealthMonitor(tracer=tracer, metrics=HP.HealthMetrics(reg))
        registries[name] = reg
        return monitors[name]

    handles = build_chaos_handles(
        tracer_factory=lambda name: HP.obs.Tracer(enabled=True),
        ping_interval=0.5,
        powers=(40, 20, 20, 20),
        health_factory=health_factory,
        device="cpu",
    )
    vals = handles[0].cs.state.validators.validators
    heavy_idx = max(range(len(vals)), key=lambda i: vals[i].voting_power)
    victim_idx = (heavy_idx + 1) % len(handles)
    heavy, victim = f"n{heavy_idx}", f"n{victim_idx}"
    K = 10

    async def run():
        net = ChaosNetwork(seed=7)
        for hd in handles:
            net.install(hd)
        await start_mesh(handles)
        try:
            await asyncio.gather(*(hd.cs.wait_for_height(8, timeout=120) for hd in handles))
            for name, m in monitors.items():
                assert len(m.quorum_lag._baseline) >= m.quorum_lag.min_baseline, (
                    f"{name}: quorum-lag baseline warmup incomplete")
            clean = {name: m.verdict() for name, m in monitors.items()}
            for hd in handles:
                if hd.name != heavy:
                    net.set_link_policy(heavy, hd.name, LinkPolicy(latency_s=0.4),
                                        reverse=LinkPolicy())
            h_clear = max(hd.cs.state.last_block_height for hd in handles)
            await asyncio.gather(*(hd.cs.wait_for_height(h_clear + K, timeout=180)
                                   for hd in handles))
            dump = node_dump(handles[victim_idx])
            hashes = {hd.block_store.load_block(h_clear + K).hash() for hd in handles}
            post = {name: m.verdict() for name, m in monitors.items()}
            return clean, post, dump, hashes
        finally:
            await stop_mesh(handles)

    clean, post, dump, hashes = asyncio.run(run())
    assert len(hashes) == 1, "nodes disagree under the straggler link"
    for name, doc in clean.items():
        assert doc["status"] != "critical", (name, doc)
        for entry in doc["subsystems"].values():
            for det, state in entry["detectors"].items():
                assert state["status"] != "critical", (name, det, state)
    vdoc = post[victim]
    vdet = vdoc["subsystems"]["consensus"]["detectors"]["quorum_lag"]
    assert vdet["status"] == "warn", vdoc
    assert vdet["last_bad"] > 0.3, vdet
    assert 0.025 <= vdet["threshold"] < 0.4, vdet
    for name, doc in post.items():
        assert doc["status"] != "critical", (name, doc)
        for sub, entry in doc["subsystems"].items():
            for det, state in entry["detectors"].items():
                if state["status"] != "ok":
                    assert det in ("quorum_lag", "round_churn"), (name, det, state)
                    assert sub == "consensus"
    incidents = [r for r in dump["records"] if r["name"] == "health.incident"]
    assert any(r["fields"]["slo"] == "quorum_lag" and r["fields"]["to"] == "warn"
               for r in incidents), incidents
    status = registries[victim].render()
    g = monitors[victim].metrics.status
    assert g.value(subsystem="consensus") >= HP.WARN
    assert 'tm_health_status{subsystem="consensus"}' in status
    for sub in ("scheduler", "wal", "sequencer", "lightserve", "p2p", "runtime"):
        assert g.value(subsystem=sub) == HP.OK, sub
