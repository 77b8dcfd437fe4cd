"""The port's adaptive consensus pacing (``consensus/pacing.py``,
``obs/quantile.py``) against the contract of ``tests/test_pacing.py``.

The tests of the reference file hold here on ``tendermint_tpu_torch``:
sketch units, controller AIMD/clamp semantics, schedule determinism,
config round-trip, the chaos straggler that forces a back-off (the port's
chaos mesh, ``tests/torch_chaos_harness.py``, on ``device="cpu"``), the
learned-tail persistence, and the report step through the port's
``python -m tendermint_tpu_torch.tools.pacing_report``. Beside them,
parity: both packages' controllers fed one seeded stream of samples
derive the same schedule and snapshots. Tolerance: exact.

The reference's ``test_four_validator_net_tightens_commit_wait`` has no
twin here. It fails in every full run of the reference, and the cause is
its premise, not ``consensus/pacing.py``: the commit step learns the lag of
the late precommits behind the quorum, measured when the receiving node
processes them, and in one process of 4 in-proc nodes that lag is the
loop's backlog. Each node checks every vote and LastCommit on the
pure-Python host oracle (~620 checks of ~5 ms for 8 heights, behind one
GIL), so the tail (p95 x 1.25) stays above the 100 ms static wait the test
expects it to undercut (p95 75-107 ms measured alone). With the oracle
memoized the tail falls to ~15 ms alone, but under the tier-1 run's six
loaded workers it again passed 80 ms: a twin would fail for the host's load,
whatever the port does.
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import subprocess
import sys
import time

import pytest

from tendermint_tpu_torch import obs
from tendermint_tpu_torch.config.config import Config, ConsensusTimeoutsConfig
from tendermint_tpu_torch.consensus.pacing import (
    PACING_STEPS,
    PacingConfig,
    PacingController,
)
from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig
from tendermint_tpu_torch.consensus.ticker import TimeoutInfo, TimeoutTicker
from tendermint_tpu_torch.obs.quantile import StreamingQuantile
from tendermint_tpu_torch.obs.report import pct
from tendermint_tpu_torch.types.vote import VoteType

from .test_torch_consensus import cpu_verifier  # noqa: F401 (autouse)
from .torch_chaos_harness import make_genesis, make_node, make_validators

pytestmark = pytest.mark.pacing

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPORT = [sys.executable, "-m", "tendermint_tpu_torch.tools.pacing_report"]


# --- obs/quantile.py: the streaming sketch ---------------------------------


def test_sketch_exact_within_window():
    s = StreamingQuantile(window=8)
    xs = [5.0, 1.0, 9.0, 3.0, 7.0]
    s.extend(xs)
    assert len(s) == 5 and s.count == 5
    # agrees bit-for-bit with the shared list-percentile rule
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert s.quantile(q) == pct(xs, q)
    assert s.max() == 9.0


def test_sketch_window_evicts_old_samples():
    s = StreamingQuantile(window=4)
    s.extend([100.0, 100.0, 100.0, 100.0])
    assert s.quantile(0.5) == 100.0
    s.extend([1.0, 1.0, 1.0, 1.0])  # old regime fully aged out
    assert s.quantile(0.99) == 1.0
    assert s.count == 8 and len(s) == 4


def test_sketch_empty_and_reset():
    s = StreamingQuantile(window=4)
    assert s.quantile(0.5) == 0.0 and s.max() == 0.0
    s.add(2.0)
    s.reset()
    assert len(s) == 0 and s.count == 0 and s.quantile(0.5) == 0.0
    with pytest.raises(ValueError):
        StreamingQuantile(window=0)


def test_sketch_snapshot_shape():
    s = StreamingQuantile(window=16)
    s.extend(float(i) for i in range(10))
    snap = s.snapshot()
    assert snap["count"] == 10 and snap["window_fill"] == 10
    assert snap["p50"] == 5.0 and snap["max"] == 9.0


# --- controller semantics --------------------------------------------------


def _controller(**over) -> PacingController:
    static = ConsensusConfig(
        timeout_propose=0.4,
        timeout_prevote=0.2,
        timeout_precommit=0.2,
        timeout_commit=0.1,
    )
    kw = dict(
        tail_quantile=0.95,
        safety_margin=1.25,
        headroom_s=0.002,
        min_factor=0.05,
        window=32,
        min_samples=4,
        backoff_step=0.5,
        recover_step=0.25,
    )
    kw.update(over)
    return PacingController(static, PacingConfig(**kw))


def test_controller_static_until_min_samples():
    pc = _controller()
    # no samples, full backoff: exactly the static schedule
    assert pc.propose(0) == 0.4
    assert pc.commit_wait() == 0.1
    for _ in range(3):  # below min_samples
        pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, 0.001)
    for _ in range(10):
        pc.on_height_committed(1, 0)  # decay backoff fully
    assert pc.commit_wait() == 0.1  # still static: not enough samples


def test_controller_tightens_to_learned_tail():
    pc = _controller()
    for _ in range(8):
        pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, 0.004)
        pc.observe_vote_arrival(VoteType.PREVOTE, 0.003)
        pc.observe_vote_arrival(VoteType.PRECOMMIT, 0.003)
        pc.observe_proposal_complete(0.01)
    for _ in range(4):  # 4 clean commits: backoff 1.0 -> 0.0
        pc.on_height_committed(1, 0)
    # learned = tail * margin + headroom, all way below static
    assert pc.commit_wait() == pytest.approx(0.004 * 1.25 + 0.002)
    assert pc.propose(0) == pytest.approx(0.4 * 0.05)  # floor: 20 ms
    assert pc.prevote(0) == pytest.approx(0.2 * 0.05)
    snap = pc.snapshot()
    assert snap["steps"]["commit"]["backoff"] == 0.0


def test_controller_floor_and_ceiling_clamps():
    pc = _controller()
    for _ in range(8):
        pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, 1e-9)
        pc.observe_vote_arrival(VoteType.PREVOTE, 10.0)  # above static
    for _ in range(4):
        pc.on_height_committed(1, 0)
    # floor of last resort: min_factor * static
    assert pc.commit_wait() == pytest.approx(0.1 * 0.05)
    # hard ceiling: never above the static value
    assert pc.prevote(0) == 0.2


def test_controller_aimd_backoff_and_recovery():
    pc = _controller()
    for _ in range(8):
        pc.observe_proposal_complete(0.004)
    for _ in range(4):
        pc.on_height_committed(1, 0)
    tight = pc.propose(0)
    assert tight == pytest.approx(0.4 * 0.05)
    # a fired timeout jumps multiplicatively toward static
    pc.on_timeout_fired("propose")
    assert pc.snapshot()["steps"]["propose"]["backoff"] == 0.5
    backed_off = pc.propose(0)
    assert backed_off == pytest.approx(tight + 0.5 * (0.4 - tight))
    pc.on_timeout_fired("propose")
    assert pc.snapshot()["steps"]["propose"]["backoff"] == 1.0
    assert pc.propose(0) == 0.4  # fully static again
    # the height whose timeout fired is NOT a success for that step,
    # even if it still committed at round 0 — no decay yet
    pc.on_height_committed(2, 0)
    assert pc.snapshot()["steps"]["propose"]["backoff"] == 1.0
    # recovery is additive (slow): the next clean commit steps 0.25 back
    pc.on_height_committed(3, 0)
    assert pc.snapshot()["steps"]["propose"]["backoff"] == 0.75


def test_controller_per_step_failure_isolation():
    """A flapping propose schedule must not freeze the OTHER steps'
    recovery: only the failed step skips its decay on the commit."""
    pc = _controller()
    # two clean commits: every step decays 1.0 -> 0.5
    pc.on_height_committed(1, 0)
    pc.on_height_committed(2, 0)
    assert all(
        pc.snapshot()["steps"][s]["backoff"] == 0.5 for s in PACING_STEPS
    )
    pc.on_timeout_fired("propose")  # propose doubles to 1.0, flagged
    pc.on_height_committed(3, 0)
    snap = pc.snapshot()["steps"]
    # propose failed this height: no decay. Everyone else decays.
    assert snap["propose"]["backoff"] == 1.0
    assert snap["prevote"]["backoff"] == 0.25
    assert snap["precommit"]["backoff"] == 0.25
    assert snap["commit"]["backoff"] == 0.25
    # a round advance fails EVERY step (jump floor 0.5), and the
    # round-1 commit that follows clears flags but never decays
    pc.on_round_advance(1)
    pc.on_height_committed(4, 1)
    snap = pc.snapshot()["steps"]
    assert snap["propose"]["backoff"] == 1.0
    assert all(snap[s]["backoff"] == 0.5 for s in PACING_STEPS[1:])


def test_controller_round_advance_backs_off_everything():
    pc = _controller()
    for _ in range(8):
        pc.observe_proposal_complete(0.004)
        pc.observe_vote_arrival(VoteType.PREVOTE, 0.003)
        pc.observe_vote_arrival(VoteType.PRECOMMIT, 0.003)
        pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, 0.002)
    for _ in range(4):
        pc.on_height_committed(1, 0)
    assert all(
        pc.snapshot()["steps"][s]["backoff"] == 0.0 for s in PACING_STEPS
    )
    pc.on_round_advance(1)
    assert all(
        pc.snapshot()["steps"][s]["backoff"] == 0.5 for s in PACING_STEPS
    )
    # a round-0 query during back-off interpolates; round > 0 is ALWAYS
    # the static per-round escalation (reference semantics preserved)
    assert pc.propose(1) == 0.4 + 0.5  # static + delta * 1
    assert pc.prevote(2) == 0.2 + 0.5 * 2


def test_controller_commit_height_decision_events():
    tracer = obs.Tracer(enabled=True)
    static = ConsensusConfig(adaptive_timeouts=True)
    pc = PacingController.from_config(static, tracer=tracer)
    pc.on_height_committed(7, 0)
    decisions = [
        r for r in tracer.records() if r.name == "pacing.decision"
    ]
    assert {d.fields["step"] for d in decisions} == set(PACING_STEPS)
    assert all(d.height == 7 for d in decisions)
    d = decisions[0].fields
    assert {"learned_ms", "static_ms", "effective_ms", "backoff"} <= set(d)


def test_schedule_determinism_identical_streams():
    """Two controllers fed the same sample/event stream must emit the
    SAME timeout schedule — the property that lets a trace replay
    reproduce a node's pacing decisions exactly."""

    def drive(pc: PacingController) -> list[float]:
        out = []
        lag = 0.0037
        for h in range(40):
            lag = (lag * 1.31) % 0.05  # deterministic pseudo-noise
            pc.observe_proposal_complete(lag + 0.001)
            pc.observe_vote_arrival(VoteType.PREVOTE, lag)
            pc.observe_vote_arrival(VoteType.PRECOMMIT, lag * 0.7)
            pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, lag / 3)
            if h % 11 == 5:
                pc.on_timeout_fired("propose")
            if h % 17 == 3:
                pc.on_round_advance(1)
            pc.on_height_committed(h + 1, 1 if h % 17 == 3 else 0)
            out += [
                pc.propose(0),
                pc.prevote(0),
                pc.precommit(0),
                pc.commit_wait(),
            ]
        return out

    a, b = _controller(), _controller()
    assert drive(a) == drive(b)
    assert a.snapshot() == b.snapshot()


def test_controller_reset_learning_returns_to_static():
    """The WAL-catchup hook: dropping the learned distributions sends
    schedules back to static (until fresh samples), while back-off
    levels — event history, not distribution state — survive."""
    pc = _controller()
    for _ in range(8):
        pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, 1e-6)
    for _ in range(4):
        pc.on_height_committed(1, 0)
    assert pc.commit_wait() < 0.1
    pc.on_timeout_fired("propose")
    pc.reset_learning()
    assert pc.commit_wait() == 0.1  # static again: no samples
    assert pc.snapshot()["steps"]["propose"]["backoff"] == 0.5


def test_pacing_config_validation():
    for bad in (
        dict(tail_quantile=0.0),
        dict(tail_quantile=1.5),
        dict(safety_margin=0.5),
        dict(min_factor=0.0),
        dict(min_factor=1.5),
        dict(window=1),
        dict(min_samples=0),
        dict(backoff_step=0.0),
        dict(recover_step=1.5),
        dict(headroom_s=-1.0),
    ):
        with pytest.raises(ValueError):
            _controller(**bad)


# --- ticker on_fire wiring -------------------------------------------------


def test_ticker_on_fire_sees_only_expiries():
    async def run():
        fired: list[TimeoutInfo] = []
        t = TimeoutTicker(on_fire=fired.append)
        t.schedule(TimeoutInfo(0.01, 1, 0, 3))
        await asyncio.sleep(0.05)
        assert [ti.step for ti in fired] == [3]
        assert t.tock_queue.get_nowait().step == 3
        # a replaced schedule is cancelled before expiry: only the
        # replacement reaches the observer
        t.schedule(TimeoutInfo(0.2, 1, 0, 4))
        t.schedule(TimeoutInfo(0.01, 1, 0, 5))
        await asyncio.sleep(0.05)
        assert [ti.step for ti in fired] == [3, 5]
        assert t.tock_queue.get_nowait().step == 5
        # a raising observer must not lose the tock
        t.set_on_fire(lambda ti: 1 / 0)
        t.schedule(TimeoutInfo(0.01, 1, 0, 6))
        await asyncio.sleep(0.05)
        assert t.tock_queue.get_nowait().step == 6
        t.stop()

    asyncio.run(run())


# --- [consensus] adaptive_timeouts config round-trip -----------------------


_ADAPTIVE_OVERRIDES = {
    "adaptive_timeouts": True,
    "adaptive_tail_quantile": 0.9,
    "adaptive_safety_margin": 1.5,
    "adaptive_headroom": 0.004,
    "adaptive_min_factor": 0.1,
    "adaptive_window": 33,
    "adaptive_min_samples": 5,
    "adaptive_backoff_step": 0.4,
    "adaptive_recover_step": 0.2,
}


def test_config_adaptive_knobs_roundtrip(tmp_path):
    c = Config.default()
    c.root_dir = str(tmp_path)
    for k, v in _ADAPTIVE_OVERRIDES.items():
        setattr(c.consensus, k, v)
    c.save()
    c2 = Config.load(str(tmp_path))
    for k, v in _ADAPTIVE_OVERRIDES.items():
        assert getattr(c2.consensus, k) == v, k
    smc = c2.consensus.to_state_machine_config()
    for k, v in _ADAPTIVE_OVERRIDES.items():
        assert getattr(smc, k) == v, k


def test_config_serialization_list_covers_sm_config():
    """The silent-drop guard: every field of the state-machine
    ConsensusConfig must be registered in the ConsensusTimeoutsConfig
    serialization list (a knob added to one side but not the other
    would vanish on a config-file round trip)."""
    from dataclasses import fields

    sm_fields = {f.name for f in fields(ConsensusConfig)}
    listed = set(ConsensusTimeoutsConfig._SM_FIELDS)
    assert listed == sm_fields
    # and every listed knob exists on the TOML side too
    toml_fields = {f.name for f in fields(ConsensusTimeoutsConfig)}
    assert listed <= toml_fields


def test_config_adaptive_validation_surfaces_at_load():
    c = Config.default()
    c.consensus.adaptive_timeouts = True
    c.consensus.adaptive_tail_quantile = 2.0
    with pytest.raises(ValueError, match="tail_quantile"):
        c.validate_basic()
    # knobs are not validated while the feature is off (a stale file
    # section must not brick a node that disabled pacing)
    c.consensus.adaptive_timeouts = False
    c.validate_basic()


# --- live net: the loop actually closes ------------------------------------


def _adaptive_cfg(**over) -> ConsensusConfig:
    kw = dict(
        timeout_propose=0.4,
        timeout_propose_delta=0.1,
        timeout_prevote=0.2,
        timeout_prevote_delta=0.1,
        timeout_precommit=0.2,
        timeout_precommit_delta=0.1,
        timeout_commit=0.1,
        skip_timeout_commit=False,
        adaptive_timeouts=True,
        adaptive_window=64,
        adaptive_min_samples=4,
        adaptive_recover_step=0.25,
        adaptive_tail_quantile=0.95,
    )
    kw.update(over)
    return ConsensusConfig(**kw)


def test_late_straggler_feeds_commit_sketch():
    """A previous-height precommit arriving too late even for the
    LastCommit window is dropped — but its arrival lag must STILL feed
    the commit controller (exactly once per validator), or a tightened
    commit wait could never observe the widened tail of a degrading
    validator (the controller would censor its own input stream)."""
    from tendermint_tpu_torch.consensus.state_machine import Step
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.vote import Vote

    vs, pvs = make_validators(4)
    genesis = make_genesis(vs)
    cs = make_node(vs, pvs[0], genesis, config=_adaptive_cfg())[0]
    # mid-height 2, already past NEW_HEIGHT: the LastCommit window for
    # height-1 stragglers is closed
    cs.rs.height = 2
    cs.rs.step = Step.PROPOSE
    cs._last_quorum_close_pc = time.perf_counter() - 0.123
    vote = Vote(
        type=VoteType.PRECOMMIT,
        height=1,
        round=0,
        block_id=BlockID(b"h" * 32, PartSetHeader(1, b"p" * 32)),
        timestamp_ns=1,
        validator_address=vs.validators[1].address,
        validator_index=1,
    )

    async def run():
        assert not await cs._add_vote(vote, "", pre_verified=True)
        # gossip re-delivery: same validator feeds only once
        assert not await cs._add_vote(vote, "", pre_verified=True)

    asyncio.run(run())
    commit = cs.pacing.snapshot()["steps"]["commit"]
    assert commit["samples"] == 1
    # the sample is the true arrival lag behind the quorum close
    assert cs.pacing._steps["commit"].sketch.max() >= 0.123
    missed = [
        r
        for r in cs.tracer.records()
        if r.name == "pacing.straggler_missed"
    ]
    # tracer defaults off in this harness unless TM_TPU_TRACE is set;
    # the event only exists when tracing is on
    assert len(missed) <= 1


def test_adaptive_metrics_gauges():
    """The pacing gauges/counters exist under the documented names and
    carry per-step labels."""
    from tendermint_tpu_torch.libs.metrics import ConsensusMetrics, Registry

    reg = Registry("pacing_gauges")
    m = ConsensusMetrics(reg)
    static = ConsensusConfig(adaptive_timeouts=True)
    pc = PacingController.from_config(static, metrics=m)
    pc.commit_wait()
    pc.on_timeout_fired("propose")
    pc.on_height_committed(1, 0)
    expo = reg.render()
    assert 'consensus_adaptive_timeout_seconds{step="commit"}' in expo
    assert 'consensus_pacing_timeouts_fired_total{step="propose"} 1' in expo
    assert 'consensus_pacing_backoff{step="propose"}' in expo
    # rounds > 0 export the schedule actually in effect (the static
    # escalation), not a stale round-0 value
    pc.propose(2)
    expo = reg.render()
    assert 'consensus_adaptive_timeout_seconds{step="propose"} 4' in expo
    # the commit wait's NEW_HEIGHT expiry fires every healthy height:
    # no failure tally exists for it
    assert "commit" not in pc.snapshot()["fired"]


# --- chaos: the controller backs off to cover an injected tail -------------


@pytest.mark.chaos
def test_chaos_straggler_forces_backoff_without_stall(tmp_path):
    """The weighted quorum topology (powers 40/20/20/20: the heavy
    validator's vote is required by every 2/3) with adaptive pacing on
    every node. Phase 1 runs clean so the controllers tighten; then
    chaos injects a 50 ms one-way delay on heavy->victim. Within the
    K=10 chaos heights the victim's controllers must LEARN the injected
    tail (heavy's votes arrive ~50 ms behind the first vote at the
    victim, every height), consensus must keep committing on all nodes,
    and no height may take longer than the static config would allow
    (round 0 + one full retry round + the commit wait)."""
    from tendermint_tpu_torch.chaos.link import LinkPolicy
    from tendermint_tpu_torch.chaos.network import ChaosNetwork

    from .torch_chaos_harness import (
        build_chaos_handles,
        node_dump,
        start_mesh,
        stop_mesh,
    )

    cfg = _adaptive_cfg(
        # keep back-off sticky enough to observe at phase end
        adaptive_recover_step=0.1,
    )
    handles = build_chaos_handles(
        tracer_factory=lambda name: obs.Tracer(enabled=True),
        ping_interval=0.5,
        powers=(40, 20, 20, 20),
        config=cfg,
        device="cpu",
    )
    vals = handles[0].cs.state.validators.validators
    heavy_idx = max(
        range(len(vals)), key=lambda i: vals[i].voting_power
    )
    victim_idx = (heavy_idx + 1) % len(handles)
    heavy, victim = f"n{heavy_idx}", f"n{victim_idx}"
    K = 10

    async def run():
        net = ChaosNetwork(seed=11)
        for h in handles:
            net.install(h)
        await start_mesh(handles)
        try:
            # phase 1: clean heights — controllers earn tightness
            await asyncio.gather(
                *(h.cs.wait_for_height(4, timeout=120) for h in handles)
            )
            pre = handles[victim_idx].cs.pacing.snapshot()
            net.set_link_policy(
                heavy,
                victim,
                LinkPolicy(latency_s=0.05),
                reverse=LinkPolicy(),
            )
            for h in handles:
                h.cs.tracer.clear()
            h_clear = max(
                h.cs.state.last_block_height for h in handles
            )
            t0 = time.perf_counter()
            await asyncio.gather(
                *(
                    h.cs.wait_for_height(h_clear + K, timeout=180)
                    for h in handles
                )
            )
            chaos_wall = time.perf_counter() - t0
            post = handles[victim_idx].cs.pacing.snapshot()
            dump = node_dump(handles[victim_idx])
            hashes = {
                h.block_store.load_block(h_clear + K).hash()
                for h in handles
            }
            return pre, post, dump, hashes, chaos_wall, h_clear
        finally:
            await stop_mesh(handles)

    pre, post, dump, hashes, chaos_wall, h_clear = asyncio.run(run())

    # liveness + agreement through the degraded regime
    assert len(hashes) == 1, "nodes disagree under the straggler link"

    # the victim LEARNED the injected tail: heavy's prevote arrives
    # ~50 ms behind the victim's first prevote every height, so the
    # p95 arrival tail (x1.25 margin) must now cover the injection
    assert post["steps"]["prevote"]["samples"] > pre["steps"]["prevote"][
        "samples"
    ]
    assert post["steps"]["prevote"]["learned_s"] >= 0.05, post
    # and the schedule it would set covers the tail while respecting
    # the static ceiling
    assert 0.05 <= post["steps"]["prevote"]["effective_s"] <= 0.2, post

    # never slower than the static config would allow: per-height wall
    # bounded by one full round-0 schedule + one retry round + the
    # commit wait + a generous compute allowance for this host
    att = obs.wall_attribution(dump["records"])
    walls = [
        v["wall_ms"]
        for h, v in att["heights"].items()
        if h > h_clear + 1  # first post-clear height straddles the clear
    ]
    assert walls, att
    static_allowance_ms = (
        (cfg.propose(0) + cfg.prevote(0) + cfg.precommit(0))
        + (cfg.propose(1) + cfg.prevote(1) + cfg.precommit(1))
        + cfg.timeout_commit
    ) * 1e3 + 1500.0
    assert max(walls) <= static_allowance_ms, (max(walls), walls)

    # report smoke on the real dump: the attribution + decision tables
    # render from exactly this artifact
    p = tmp_path / "victim_dump.json"
    p.write_text(json.dumps(dump))
    out = subprocess.run(
        REPORT + [str(p)],
        capture_output=True,
        text=True,
        cwd=ROOT,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "timeout floor" in out.stdout
    assert "pacing decisions" in out.stdout


# --- the port's tools/pacing_report.py CLI smoke ---------------------------


def test_pacing_report_cli_smoke(tmp_path):
    # hand-built records: synthetic timestamps must stay inside each
    # height's window (a real tracer would stamp events with "now")
    records = []
    for h in (2, 3):
        off = (h - 2) * 0.1
        for name, t0, dur in (
            ("cs.new_height", off, 0.04),
            ("cs.propose", off + 0.04, 0.01),
            ("cs.prevote", off + 0.05, 0.005),
            ("cs.precommit", off + 0.055, 0.005),
            ("cs.commit", off + 0.06, 0.002),
        ):
            records.append(
                {
                    "name": name,
                    "t0": t0,
                    "dur": dur,
                    "height": h,
                    "round": 0,
                    "kind": "span",
                }
            )
        records.append(
            {
                "name": "pacing.decision",
                "t0": off + 0.061,
                "dur": 0.0,
                "height": h,
                "round": 0,
                "kind": "event",
                "fields": {
                    "step": "commit",
                    "learned_ms": 5.0,
                    "static_ms": 40.0,
                    "effective_ms": 12.0,
                    "backoff": 0.2,
                    "samples": 30,
                },
            }
        )
    doc = {"moniker": "n0", "records": records}
    p = tmp_path / "dump.json"
    p.write_text(json.dumps(doc))

    out = subprocess.run(
        REPORT + [str(p)],
        capture_output=True,
        text=True,
        cwd=ROOT,
        timeout=60,
    )
    assert out.returncode == 0, out.stderr
    assert "timeout floor" in out.stdout
    assert "commit" in out.stdout

    out = subprocess.run(
        REPORT + [str(p), "--json"],
        capture_output=True,
        text=True,
        cwd=ROOT,
        timeout=60,
    )
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    rep = doc["n0"]
    assert rep["wall"]["aggregate"]["n_heights"] == 2
    assert rep["pacing"]["commit"]["static_ms"] == 40.0
    # the floor bucket is the cs.new_height window here: 40 of 62 ms
    agg = rep["wall"]["aggregate"]
    assert agg["floor_share"] == pytest.approx(40.0 / 62.0, abs=0.01)


# --- persistence (learned-tail warm starts) ---------------------------------


def test_tails_roundtrip_restores_schedule(tmp_path):
    """save_tails/load_tails: a fresh controller that loads a trained
    one's file derives the identical schedule — no re-learning heights,
    no min_samples gating on restart."""
    path = str(tmp_path / "cs.wal.pacing.json")
    pc = _controller()
    for _ in range(16):
        pc.observe_post_quorum_straggler(VoteType.PRECOMMIT, 0.004)
        pc.observe_vote_arrival(VoteType.PREVOTE, 0.002)
        pc.observe_vote_arrival(VoteType.PRECOMMIT, 0.003)
        pc.observe_proposal_complete(0.005)
    for h in range(8):
        pc.on_height_committed(h, 0)  # decay backoff
    assert pc.commit_wait() < 0.1  # actually learned something
    assert pc.save_tails(path)

    fresh = _controller()
    assert fresh.commit_wait() == 0.1  # static before the load
    assert fresh.load_tails(path)
    for step in PACING_STEPS:
        assert fresh._steps[step].snapshot() == pc._steps[step].snapshot()
    assert fresh.commit_wait() == pc.commit_wait()


def test_tails_load_tolerates_missing_and_corrupt(tmp_path):
    pc = _controller()
    assert not pc.load_tails(str(tmp_path / "nope.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert not pc.load_tails(str(bad))
    bad.write_text(json.dumps({"schema": "something-else", "steps": {}}))
    assert not pc.load_tails(str(bad))
    # junk inside one step must not poison the controller
    blob = pc.state_dict()
    blob["steps"]["commit"]["samples"] = ["zebra"]
    pc2 = _controller()
    pc2.load_state(blob)
    assert pc2.commit_wait() == 0.1  # commit stayed static
    # unconfigured controller: both directions are clean no-ops
    assert not pc.save_tails()
    assert not pc.load_tails()


def test_tails_survive_state_machine_restart(tmp_path):
    """Integration: a ConsensusState with persist_path saves on stop and
    the next incarnation warm-starts with the learned commit wait."""
    path = str(tmp_path / "cs.wal.pacing.json")
    vs, pvs = make_validators(1)
    genesis = make_genesis(vs)
    cfg = ConsensusConfig.test_config()
    cfg.adaptive_timeouts = True
    cfg.adaptive_min_samples = 2

    async def first():
        cs, *_ = make_node(vs, pvs[0], genesis, config=cfg)
        cs.pacing.persist_path = path
        for _ in range(8):
            cs.pacing.observe_post_quorum_straggler(
                VoteType.PRECOMMIT, 0.001
            )
        await cs.start()
        await cs.wait_for_height(2, timeout=30)
        await cs.stop()
        return cs.pacing.snapshot()["steps"]["commit"]["samples"]

    samples = asyncio.run(first())
    assert samples >= 8

    async def second():
        cs, *_ = make_node(vs, pvs[0], genesis, config=cfg)
        cs.pacing.persist_path = path
        await cs.start()
        restored = cs.pacing.snapshot()["steps"]["commit"]["samples"]
        await cs.stop()
        return restored

    assert asyncio.run(second()) >= samples


# --- parity with the JAX package --------------------------------------------


def test_controller_matches_the_reference_on_one_seeded_stream():
    """Both packages' PacingController, fed one seeded stream of arrival
    lags, fired timeouts, round advances and commits, give the same
    schedule after every height and the same snapshot and saved tails at
    the end."""
    import random

    from tendermint_tpu.consensus import pacing as ref_pacing
    from tendermint_tpu.consensus import state_machine as ref_sm
    from tendermint_tpu.types import vote as ref_vote

    def drive(pacing, sm, vote_type) -> tuple:
        static = sm.ConsensusConfig(timeout_propose=0.4, timeout_prevote=0.2,
                                    timeout_precommit=0.2, timeout_commit=0.1)
        pc = pacing.PacingController(static, pacing.PacingConfig(window=32, min_samples=4))
        rng = random.Random(20261018)
        out = []
        for h in range(60):
            pc.observe_proposal_complete(rng.uniform(0.001, 0.05))
            pc.observe_vote_arrival(vote_type.PREVOTE, rng.uniform(0.0, 0.06))
            pc.observe_vote_arrival(vote_type.PRECOMMIT, rng.uniform(0.0, 0.04))
            pc.observe_post_quorum_straggler(vote_type.PRECOMMIT, rng.expovariate(60.0))
            if rng.random() < 0.15:
                pc.on_timeout_fired(rng.choice(["propose", "prevote", "precommit"]))
            round_ = 1 if rng.random() < 0.1 else 0
            if round_:
                pc.on_round_advance(round_)
            pc.on_height_committed(h + 1, round_)
            out.append((pc.propose(0), pc.prevote(1), pc.precommit(0), pc.commit_wait()))
        return out, pc.snapshot(), pc.state_dict()

    from tendermint_tpu_torch.consensus import pacing, state_machine

    port = drive(pacing, state_machine, VoteType)
    ref = drive(ref_pacing, ref_sm, ref_vote.VoteType)
    assert port == ref
    assert port[1]["steps"]["commit"]["samples"] == 60
