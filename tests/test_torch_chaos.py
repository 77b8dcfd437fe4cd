"""The port's chaos subsystem (``chaos/{link,network,scenario,
backend_guard}.py``) against the contract of ``tests/test_chaos.py``: the
seeded link model (a deterministic fault trace, drop-all and
duplicate-all, multiplexed messages kept whole, policy updates on a live
connection), the switch's dial retry with full jitter, statesync's chunk
backoff and peer rotation, the backend guard's classification (the port's
CUDA probe, with injected child commands, never a real card), and on a
4-validator mesh of the port over encrypted p2p (``tests/
torch_chaos_harness.py`` on ``device="cpu"``): a seeded latency, drop and
duplicate storm replayed alike, a 2|2 partition that stalls and heals, a
node killed and restarted, and a seed-stable random scenario. The unit
contracts run one body on both packages' roots. Beside them, parity:

- ``ScenarioRunner.plan_jsonl()`` of seeds 7, 8 and 13 byte-identical
  across the packages; ``link_rng`` streams and the ``FaultTrace`` of one
  seeded message sequence identical;
- a port mesh and a JAX-package mesh under the same seeded storm commit
  the same app hashes at heights 1-4.

The three tests of the reference file that need a port-side ``bench.py``
or the multichip capture wait for them (ROADMAP.md, item A5). The port's
nodes verify on its process verifier on ``device="cpu"`` (4-row rounds
under ``min_device_batch``, on the host oracle); the JAX package's on a
verifier of that package whose ``min_device_batch`` no round reaches.
Tolerance: exact (trace bytes, hashes).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import random
import sys
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    PORT,
    REF,
    cpu_verifier,
    make_genesis,
    make_node,
    make_validators,
)
from .test_torch_light import ref_host_verifier  # noqa: F401 (a fixture)

pytestmark = pytest.mark.chaos

ROOTS = [PORT.root, REF.root]


def chaos_ns(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    chaos = m("chaos")
    return SimpleNamespace(
        root=root,
        ChaosConn=chaos.ChaosConn,
        ChaosNetwork=chaos.ChaosNetwork,
        FaultTrace=chaos.FaultTrace,
        LinkPolicy=chaos.LinkPolicy,
        NodeHandle=chaos.NodeHandle,
        Scenario=chaos.Scenario,
        ScenarioRunner=chaos.ScenarioRunner,
        Step=chaos.Step,
        link_rng=chaos.link_rng,
        random_scenario=chaos.random_scenario,
        fallback_artifact=chaos.fallback_artifact,
        BackendStatus=chaos.BackendStatus,
        switch=m("p2p.switch"),
        NetAddress=m("p2p.transport").NetAddress,
        ChunkQueue=m("statesync.chunks").ChunkQueue,
        syncer=m("statesync.syncer"),
    )


NS = {root: chaos_ns(root) for root in ROOTS}
CP = NS[PORT.root]


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def cn(request):
    return NS[request.param]


# --- link model (unit) -------------------------------------------------------


class _SinkConn:
    """Fake SecretConnection capturing written frames."""

    def __init__(self):
        self.frames: list[bytes] = []
        self.closed = False

    async def write(self, data: bytes) -> None:
        self.frames.append(data)

    async def read(self) -> bytes:  # pragma: no cover - never used
        await asyncio.sleep(3600)

    def close(self) -> None:
        self.closed = True


def _packets(n_msgs: int, ch: int = 0x20, payload: bytes = b"x" * 40):
    """n single-packet mconn messages on one channel."""
    return [bytes([ch, 1]) + payload + b"%03d" % i for i in range(n_msgs)]


async def _drive(cn, policy, seed: int, n_msgs: int = 40):
    sink = _SinkConn()
    conn = cn.ChaosConn(sink, policy, cn.link_rng(seed, "a", "b"), link_id="a>b")
    for pkt in _packets(n_msgs):
        await conn.write(pkt)
    deadline = asyncio.get_running_loop().time() + 10.0
    expected = sum(1 + e[6] for e in conn.trace.entries if e[3] == "deliver")
    while len(sink.frames) < expected:
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError("chaos pump stalled")
        await asyncio.sleep(0.01)
    conn.close()
    return sink, conn


def test_link_trace_deterministic(cn):
    """Same seed + same message sequence => byte-identical fault trace; a
    different seed diverges."""
    policy = cn.LinkPolicy(latency_s=0.001, jitter_s=0.004, drop=0.25, duplicate=0.15)

    async def run(seed):
        _, conn = await _drive(cn, policy, seed)
        return conn.trace.to_jsonl()

    t1 = asyncio.run(run(7))
    t2 = asyncio.run(run(7))
    t3 = asyncio.run(run(8))
    assert t1 == t2, "same-seed fault traces diverged"
    assert t1 != t3, "different seeds produced identical traces"
    kinds = {json.loads(line)[3] for line in t1.splitlines()}
    assert kinds == {"drop", "deliver"}


def test_link_drop_all_and_duplicate_all(cn):
    async def run():
        sink_drop, _ = await _drive(cn, cn.LinkPolicy(drop=1.0), seed=1, n_msgs=10)
        assert sink_drop.frames == []
        sink_dup, _ = await _drive(cn, cn.LinkPolicy(duplicate=1.0), seed=1, n_msgs=10)
        assert len(sink_dup.frames) == 20
        # FIFO preserved under latency+jitter when reorder is off
        sink_fifo, _ = await _drive(cn, cn.LinkPolicy(latency_s=0.002, jitter_s=0.01),
                                    seed=3, n_msgs=15)
        assert sink_fifo.frames == _packets(15)

    asyncio.run(run())


def test_link_multiplexed_messages_stay_coherent(cn):
    """Interleaved multi-packet messages on two channels keep per-message
    packet runs contiguous per channel."""

    async def run():
        sink = _SinkConn()
        conn = cn.ChaosConn(sink, cn.LinkPolicy(latency_s=0.001, jitter_s=0.003),
                            cn.link_rng(5, "a", "b"))
        await conn.write(bytes([0x20, 0]) + b"part1")
        await conn.write(bytes([0x30, 1]) + b"other")
        await conn.write(bytes([0x20, 1]) + b"part2")
        while len(sink.frames) < 3:
            await asyncio.sleep(0.01)
        conn.close()
        idx = [i for i, f in enumerate(sink.frames) if f[0] == 0x20]
        assert idx[1] == idx[0] + 1
        assert sink.frames[idx[0]][2:] == b"part1"
        assert sink.frames[idx[1]][2:] == b"part2"

    asyncio.run(run())


def test_link_policy_updates_apply_to_live_conn(cn):
    """ChaosConn re-resolves its policy per message through policy_fn."""

    async def run():
        sink = _SinkConn()
        policies = {"cur": cn.LinkPolicy()}
        conn = cn.ChaosConn(sink, policies["cur"], cn.link_rng(1, "a", "b"),
                            policy_fn=lambda: policies["cur"])
        pkts = _packets(3)
        await conn.write(pkts[0])  # noop: passes straight through
        assert sink.frames == [pkts[0]]
        policies["cur"] = cn.LinkPolicy(drop=1.0)
        await conn.write(pkts[1])  # dropped by the new policy, same conn
        policies["cur"] = cn.LinkPolicy()
        await conn.write(pkts[2])
        assert sink.frames == [pkts[0], pkts[2]]
        conn.close()

    asyncio.run(run())


# --- dial retry jitter ---------------------------------------------------------


class _DeadTransport:
    """Transport whose dials always fail and that never accepts."""

    def __init__(self):
        self.listen_port = 0
        self.dials = 0

    async def accept(self):
        await asyncio.sleep(3600)

    async def dial(self, addr):
        self.dials += 1
        raise ConnectionError("unreachable")

    async def close(self):
        pass

    def _node_info_fn(self):  # pragma: no cover - never reached
        raise AssertionError


class _RecordingRng(random.Random):
    def __init__(self, seed):
        super().__init__(seed)
        self.ceilings: list[float] = []

    def uniform(self, a, b):
        self.ceilings.append(b)
        return 0.001  # keep the test fast; the draw itself is recorded


def test_dial_retry_full_jitter_cap_and_gave_up_event(cn):
    async def run():
        transport = _DeadTransport()
        rng = _RecordingRng(42)
        sw = cn.switch.Switch(transport, max_dial_attempts=6, dial_rng=rng)
        gave_up = []
        sw.events.add_listener("t", cn.switch.EVENT_PEER_DIAL_GAVE_UP, gave_up.append)
        await sw.start()
        addr = cn.NetAddress("deadbeef", "127.0.0.1", 1)
        await sw._dial_with_retry(addr)
        await sw.stop()
        return transport, rng, gave_up, addr

    transport, rng, gave_up, addr = asyncio.run(run())
    assert transport.dials == 6, "attempt cap not enforced"
    assert rng.ceilings == [min(10.0, 0.2 * 2**n) for n in range(1, 6)]
    assert gave_up == [addr], "terminal gave-up event not fired"


# --- statesync chunk backoff + rotation ------------------------------------------


def test_chunk_retry_backoff_and_last_sender(cn):
    now = [0.0]
    q = cn.ChunkQueue(2, now=lambda: now[0])
    assert q.allocate() == 0
    assert q.allocate() == 1
    q.note_request(0, "pA")
    q.retry(0)
    assert q.allocate() is None  # backing off right after a failure
    assert q.last_sender(0) == "pA"
    assert q.retries(0) == 1
    now[0] = 0.11  # past the 0.1 s first backoff
    assert q.allocate() == 0
    q.retry(0, "pB")
    assert q.last_sender(0) == "pB"
    now[0] = 0.25  # the second backoff doubles to 0.2 s: not yet elapsed
    assert q.allocate() is None
    now[0] = 0.45
    assert q.allocate() == 0


def test_chunk_fetch_rotates_away_from_failing_peer(cn):
    class _Peer:
        def __init__(self, pid):
            self.id = pid

    class _Snap:
        height, format, chunks, hash = 5, 1, 1, b"h"

    requests = []

    async def run():
        syncer = cn.syncer.Syncer(
            app_snapshot_conn=None, state_provider=None,
            request_chunk=lambda peer, h, f, i: requests.append((peer.id, i)),
        )
        d = cn.syncer._DiscoveredSnapshot(_Snap())
        d.peers = [_Peer("pA"), _Peer("pB")]
        q = cn.ChunkQueue(1)
        assert q.allocate() == 0
        q.note_request(0, "pA")
        q.retry(0, "pA")
        task = asyncio.create_task(syncer._fetch_chunks(d, q))
        deadline = asyncio.get_running_loop().time() + 5.0
        while not requests:
            if asyncio.get_running_loop().time() > deadline:
                break
            await asyncio.sleep(0.02)
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

    asyncio.run(run())
    assert requests, "refetch never happened"
    assert requests[0][0] == "pB", "refetch did not rotate off the failing peer"


# --- the backend guard: a bounded CUDA probe ----------------------------------------


@pytest.mark.parametrize("marker", [
    "RuntimeError: No CUDA GPUs are available",
    "RuntimeError: CUDA driver initialization failed, you might not have a CUDA gpu.",
    "RuntimeError: CUDA error: no CUDA-capable device is detected",
    "cudaErrorNoDevice",
    "RuntimeError: Found no NVIDIA driver on your system.",
])
def test_backend_guard_probe_classification(marker):
    """Injected children: a card that answers, a hang killed at the bound
    (rc 124), each of CUDA's unreachable-device messages, and any other
    failure. The artifact keeps the reference's keys."""
    from tendermint_tpu_torch.chaos import backend_guard

    ok = backend_guard.probe_backend(
        probe_cmd=[sys.executable, "-c", "print('cuda')"], timeout_s=30)
    assert ok.available and ok.backend == "cuda" and ok.kind == "ok"

    hang = backend_guard.probe_backend(
        probe_cmd=[sys.executable, "-c", "import time; time.sleep(30)"], timeout_s=0.5)
    assert not hang.available and hang.kind == "timeout" and hang.rc == 124
    assert "hang" in hang.error

    down = backend_guard.probe_backend(
        probe_cmd=[sys.executable, "-c",
                   f"import sys; sys.stderr.write({marker!r}); sys.exit(1)"],
        timeout_s=30)
    assert not down.available and down.kind == "tunnel_down" and down.rc == 1

    broken = backend_guard.probe_backend(
        probe_cmd=[sys.executable, "-c",
                   "import sys; sys.stderr.write('ImportError: no torch'); sys.exit(2)"],
        timeout_s=30)
    assert not broken.available and broken.kind == "backend_error" and broken.rc == 2

    art = backend_guard.fallback_artifact(down, fallback="cpu", extra={"metric": "m"})
    assert {"rc", "error", "backend", "fallback"} <= set(art)
    json.dumps(art)
    ref = NS[REF.root]
    ref_art = ref.fallback_artifact(ref.BackendStatus(available=False, rc=1), fallback="cpu")
    assert set(ref_art) == set(backend_guard.fallback_artifact(
        backend_guard.BackendStatus(available=False, rc=1), fallback="cpu"))


def test_backend_guard_cpu_probe_hides_the_cards():
    """platform="cpu" hides the cards from the child and probes torch on
    the CPU; meta_block(live=False) imports no torch."""
    from tendermint_tpu_torch.chaos import backend_guard

    env = backend_guard.sanitized_env({"PATH": "/bin"}, platform="cpu")
    assert env == {"PATH": "/bin", "CUDA_VISIBLE_DEVICES": ""}
    assert backend_guard.sanitized_env({"PATH": "/bin"}) == {"PATH": "/bin"}
    st = backend_guard.probe_backend(platform="cpu", timeout_s=120)
    assert st.available and st.backend == "cpu" and st.kind == "ok", st
    meta = backend_guard.meta_block(live=False)
    assert meta["backend"] is None and meta["device_count"] == 0
    assert meta["torch_version"]
    assert backend_guard.classify_failure("", 124) == "timeout"
    assert backend_guard.classify_failure("Segmentation fault", 139) == "backend_error"


# --- scenario e2e on a 4-validator mesh of the port ----------------------------------


def _mesh():
    from .torch_chaos_harness import build_chaos_handles

    return build_chaos_handles(4, device="cpu")


STORM = dict(latency_s=0.005, jitter_s=0.01, drop=0.02, duplicate=0.02)


def _storm(cn, seed):
    return cn.Scenario(
        seed=seed,
        steps=[cn.Step(at_height=2, action="clock_skew", params={"node": "n3", "scale": 1.2})],
        default_policy=cn.LinkPolicy(**STORM),
    )


def _kill_restart(cn):
    return cn.Scenario(
        seed=13,
        steps=[
            cn.Step(at_height=2, action="kill", params={"node": "n3"}),
            # after=0: never restart before the kill has fired
            cn.Step(at_time=4.0, action="restart", params={"node": "n3"}, after=0),
        ],
    )


def _run_storm(seed: int, until: int):
    from .torch_chaos_harness import chain_hashes, start_mesh, stop_mesh

    async def run():
        handles = _mesh()
        runner = CP.ScenarioRunner(handles, _storm(CP, seed))
        await start_mesh(handles)
        try:
            heights = await runner.run(until_height=until, timeout=120)
            hashes = await chain_hashes(handles, until - 1)
        finally:
            await stop_mesh(handles)
        return runner.plan_jsonl(), heights, hashes

    return asyncio.run(run())


def test_scenario_determinism_latency_drop_storm():
    """Same seed => byte-identical scenario plan and identical committed
    height sequences up to the target on a 4-validator p2p mesh of the
    port under a latency + drop + duplicate storm."""
    until = 4
    plan1, heights1, hashes1 = _run_storm(seed=7, until=until)
    plan2, heights2, hashes2 = _run_storm(seed=7, until=until)
    assert plan1 == plan2, "same-seed scenario plans diverged"
    want = list(range(1, until + 1))
    for heights in (heights1, heights2):
        for name, seq in heights.items():
            assert seq[:until] == want, f"{name} missed heights: {seq}"
    assert len(hashes1) == 1 and len(hashes2) == 1, "chains diverged"
    plan3, _, _ = _run_storm(seed=8, until=2)
    assert plan1 != plan3


def test_partition_heal_liveness():
    """2|2 split: neither half can commit; after heal all four reconverge
    on one chain and resume committing."""
    from .torch_chaos_harness import chain_hashes, start_mesh, stop_mesh

    async def run():
        handles = _mesh()
        net = CP.ChaosNetwork(seed=11)
        for h in handles:
            net.install(h)
        await start_mesh(handles)
        try:
            await asyncio.gather(*(h.cs.wait_for_height(2, timeout=60) for h in handles))
            await net.partition("split", [["n0", "n1"], ["n2", "n3"]])
            for h in handles:
                for peer_id in h.switch.peers:
                    other = net._name_for(peer_id)
                    assert net.allowed(h.name, other), (
                        f"live cross-partition conn {h.name}<->{other}")
            await asyncio.sleep(1.0)  # let in-flight commits settle
            stalled = [h.block_store.height for h in handles]
            await asyncio.sleep(2.0)
            assert [h.block_store.height for h in handles] == stalled, (
                "a 2|2 partition committed blocks")
            await net.heal("split")
            target = max(stalled) + 2
            await asyncio.gather(*(h.cs.wait_for_height(target, timeout=90)
                                   for h in handles))
            hashes = await chain_hashes(handles, target)
            assert len(hashes) == 1, "nodes diverged after heal"
        finally:
            await stop_mesh(handles)

    asyncio.run(run())


def test_kill_restart_scenario_recovers():
    """Node n3 dies at height 2, restarts 4 s in with fresh p2p around the
    same state, and the whole mesh (n3 included) reaches the target on one
    chain."""
    from .torch_chaos_harness import chain_hashes, start_mesh, stop_mesh

    async def run():
        handles = _mesh()
        runner = CP.ScenarioRunner(handles, _kill_restart(CP))
        await start_mesh(handles)
        try:
            heights = await runner.run(until_height=4, timeout=120)
            assert all(seq[:4] == [1, 2, 3, 4] for seq in heights.values())
            hashes = await chain_hashes(handles, 3)
            assert len(hashes) == 1, "chains diverged after kill/restart"
        finally:
            await stop_mesh(handles)

    asyncio.run(run())


def test_random_scenario_is_seed_stable(cn):
    names = ["n0", "n1", "n2", "n3"]
    s1 = cn.random_scenario(99, names)
    s2 = cn.random_scenario(99, names)
    s3 = cn.random_scenario(100, names)

    def as_plan(s):
        return [st.resolved(i) for i, st in enumerate(s.steps)] + [s.default_policy]

    assert as_plan(s1) == as_plan(s2)
    assert as_plan(s1) != as_plan(s3)


# --- parity with the JAX package ----------------------------------------------------


class _FakeTicker:
    def set_scale(self, scale):
        self.scale = scale


class _FakeCS:
    def __init__(self):
        self.ticker = _FakeTicker()

    async def stop(self):
        pass


class _FakeSwitch:
    is_running = False
    peers: dict = {}

    async def stop(self):
        pass


def _plan(cn, scenario) -> bytes:
    """plan_jsonl() of `scenario` run against four stand-in handles of
    package `cn` that already stand at height 9 (the plan is logged before
    any step fires; height-triggered steps fire at once)."""

    async def restart(handle, net):
        pass

    handles = [
        cn.NodeHandle(name=f"n{i}", cs=_FakeCS(),
                      node_key=SimpleNamespace(id="%040x" % i),
                      transport=SimpleNamespace(), switch=_FakeSwitch(),
                      block_store=SimpleNamespace(height=9), restart_fn=restart)
        for i in range(4)
    ]
    runner = cn.ScenarioRunner(handles, scenario)
    asyncio.run(runner.run(until_height=1, timeout=30))
    return runner.plan_jsonl()


def test_scenario_plans_byte_identical_across_packages():
    """plan_jsonl() of the storm scenario at seeds 7 and 8 and of the
    kill/restart scenario at seed 13: the same bytes from both packages."""
    for build in (lambda cn: _storm(cn, 7), lambda cn: _storm(cn, 8), _kill_restart):
        plans = {root: _plan(NS[root], build(NS[root])) for root in ROOTS}
        assert plans[PORT.root] == plans[REF.root]
        assert plans[PORT.root].startswith(b'["scenario","seed",')


def test_link_rng_and_fault_trace_identical_across_packages():
    """The seeded per-link RNG (its seed bytes b"tm-tpu-chaos:%d:%s>%s")
    gives the same stream in both packages, and the same seeded message
    sequence through ChaosConn leaves the same FaultTrace."""
    for seed, a, b in ((0, "a", "b"), (7, "n0", "n3"), (13, "dial", "n1")):
        streams = {root: [NS[root].link_rng(seed, a, b).random() for _ in range(64)]
                   for root in ROOTS}
        assert streams[PORT.root] == streams[REF.root]
    policy = dict(latency_s=0.001, jitter_s=0.004, drop=0.25, duplicate=0.15, reorder=0.1)

    async def run(cn):
        _, conn = await _drive(cn, cn.LinkPolicy(**policy), seed=21, n_msgs=60)
        return conn.trace.to_jsonl()

    traces = {root: asyncio.run(run(NS[root])) for root in ROOTS}
    assert traces[PORT.root] == traces[REF.root]
    assert len(traces[PORT.root].splitlines()) == 60


def _app_hashes(handles, heights: int) -> list:
    """Every live node's app hash after each height 1..heights (block
    h + 1's header), one set a height."""
    return [{h.block_store.load_block(k + 1).header.app_hash for h in handles}
            for k in range(1, heights + 1)]


def test_port_and_reference_meshes_same_app_hashes(ref_host_verifier):
    """A port mesh and a JAX-package mesh (tests/chaos_harness.py) under
    the same seeded storm commit the same app hashes at heights 1-4."""
    from tests import chaos_harness as ref_harness

    from . import torch_chaos_harness as port_harness

    got = {}
    for root, harness, build in (
        (PORT.root, port_harness, lambda: port_harness.build_chaos_handles(4, device="cpu")),
        (REF.root, ref_harness, lambda: ref_harness.build_chaos_handles(4)),
    ):
        cn = NS[root]

        async def run():
            handles = build()
            runner = cn.ScenarioRunner(handles, _storm(cn, 7))
            await harness.start_mesh(handles)
            try:
                await runner.run(until_height=5, timeout=120)
                return _app_hashes(handles, 4), runner.plan_jsonl()
            finally:
                await harness.stop_mesh(handles)

        got[root] = asyncio.run(run())
    assert got[PORT.root] == got[REF.root]
    assert all(len(s) == 1 for s in got[PORT.root][0])


def test_twin_node_builder_matches_the_port_make_node():
    """The harness's port-only make_node builds the node
    tests/test_torch_consensus.py's make_node builds for the port: the same
    state, validators, config and application."""
    from . import torch_chaos_harness as port_harness

    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    want = make_node(PORT, vs, pvs[0], genesis)
    twin_vs, twin_pvs = port_harness.make_validators(4)
    got = port_harness.make_node(twin_vs, twin_pvs[0], port_harness.make_genesis(twin_vs))
    assert twin_vs.hash() == vs.hash()
    assert got[0].state.encode() == want[0].state.encode()
    assert vars(got[0].config) == vars(want[0].config)
    assert [type(x) for x in got] == [type(x) for x in want]
    assert (got[0].priv_validator.get_pub_key().data
            == want[0].priv_validator.get_pub_key().data)


@pytest.mark.parametrize("root", ROOTS, ids=["port", "ref"])
def test_gated_switch_stop_survives_redials(root, monkeypatch):
    """A switch stopping while its peers redial it: with its connection
    gate closed first (its conn_gate refusing every peer), the stop ends and
    no peer is left, though each peer's stop is slowed so the redials land
    inside it. (Without the gate the reference's stop can hang in
    MultiplexTransport.close(), ROADMAP.md section C; the port's refuses
    peers while it stops, test_port_switch_stop_refuses_peers_while_stopping.)"""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    NodeKey, NodeInfo = m("p2p.key").NodeKey, m("p2p.node_info").NodeInfo
    Switch = m("p2p.switch").Switch
    transport = m("p2p.transport")
    stop = transport.Peer.stop

    async def slow_stop(self):
        await asyncio.sleep(0.3)
        await stop(self)

    monkeypatch.setattr(transport.Peer, "stop", slow_stop)

    def node():
        nk, box = NodeKey.generate(), {}

        def info():
            return NodeInfo(node_id=nk.id, listen_addr=f"127.0.0.1:{box['t'].listen_port}",
                            network="gate-chain", channels=b"")

        box["t"] = transport.MultiplexTransport(nk, info)
        box["sw"] = Switch(box["t"])
        return nk, box["t"], box["sw"]

    async def run():
        nodes = [node() for _ in range(5)]
        for _, t, sw in nodes:
            await t.listen()
            await sw.start()
        for i, (_, _, sw) in enumerate(nodes):
            sw.dial_peers_async([transport.NetAddress(o[0].id, "127.0.0.1", o[1].listen_port)
                                 for j, o in enumerate(nodes) if j != i], persistent=True)
        for _ in range(200):
            if all(len(sw.peers) == 4 for _, _, sw in nodes):
                break
            await asyncio.sleep(0.05)
        victim = nodes[0][2]
        victim.conn_gate = lambda _peer_id: False
        await asyncio.wait_for(victim.stop(), 20)
        left = len(victim.peers)
        for _, _, sw in nodes[1:]:
            sw.conn_gate = lambda _peer_id: False
        for _, _, sw in nodes[1:]:
            await asyncio.wait_for(sw.stop(), 20)
        return left

    assert asyncio.run(run()) == 0


def test_port_switch_stop_refuses_peers_while_stopping():
    """The port's switch ends its stop, with no gate, though a peer dials
    in while it stops: the dial lands while a reactor's on_stop runs (after
    the switch stopped its peers, before it closes its transport), and the
    switch refuses that peer rather than keep it, whose open connection
    would hold MultiplexTransport.close() for good."""
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.node_info import NodeInfo
    from tendermint_tpu_torch.p2p.switch import Reactor, Switch
    from tendermint_tpu_torch.p2p.transport import MultiplexTransport, NetAddress

    def node():
        nk, box = NodeKey.generate(), {}

        def info():
            return NodeInfo(node_id=nk.id, listen_addr=f"127.0.0.1:{box['t'].listen_port}",
                            network="stop-chain", channels=b"")

        box["t"] = MultiplexTransport(nk, info)
        return nk, box["t"], Switch(box["t"])

    async def run():
        (nk_a, t_a, sw_a), (_, t_c, sw_c) = node(), node()
        dialed = {}

        class DialInOnStop(Reactor):
            async def on_stop(self):
                dialed["peer"] = await sw_c.dial_peer(
                    NetAddress(nk_a.id, "127.0.0.1", t_a.listen_port))
                await asyncio.sleep(0.3)  # the stopping switch takes the connection

        sw_a.add_reactor("dial-in", DialInOnStop("dial-in"))
        for t, sw in ((t_a, sw_a), (t_c, sw_c)):
            await t.listen()
            await sw.start()
        await asyncio.wait_for(sw_a.stop(), 15)
        left = dict(sw_a.peers)
        await asyncio.wait_for(sw_c.stop(), 15)
        return dialed, left

    dialed, left = asyncio.run(run())
    assert dialed["peer"] is not None  # the dial reached the stopping switch
    assert left == {}
