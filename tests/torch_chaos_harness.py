"""The port's chaos-mesh builder: the twin of ``tests/chaos_harness.py``.

Builds in-proc validator nodes of ``tendermint_tpu_torch`` over the port's
encrypted p2p (a ``MultiplexTransport``, a ``Switch`` and a
``ConsensusReactor`` a node) wrapped in the port's ``chaos.NodeHandle``s,
with a restart_fn that rebuilds a killed node from its block and state
stores, as ``Node.on_start`` does (the "restart" scenario action): the
port's ``consensus/replay.py`` ``Handshaker`` replays the stored blocks
the state has not caught up with into a fresh ``ConsensusState`` (same
privval, app, L2 and stores), around fresh transport/switch. ``tests/test_torch_chaos.py``
runs it on ``device="cpu"``; ``chip_smoke.py``'s phase 10 on the card.

It imports nothing of the JAX package, so the smoke can load it where JAX
is absent. Its validators, genesis and node builder are therefore those of
``tendermint_tpu_torch/tools/_inproc.py`` (the builders of
``tests/helpers.py`` and ``tests/test_consensus.py`` over the port alone,
with the same seeds), which the port's ``lightserve_bench`` builds its net
with too. ``sign_commit`` is ``tests/helpers.py``'s (without QC
dual-signs) over the package of the set it is given; the port's
``bench_replay`` tool signs its window with it, and ``soak`` reads a
node's ledger through ``node_ledger``.

``ChaosVerifyService`` kills and restarts the port's verify service on
``device`` (``tests/test_torch_verify_service.py`` on ``device="cpu"``).
``build_chaos_handles`` takes the reference's per-node tracers
(``tracer_factory``), ping interval, weighted powers and live health plane
(``health_factory``, ``obs/health.py``'s monitor on ``cs.health``), and
``node_dump`` gives a node's ``dump_traces``-shaped record for
``obs.cluster`` (``tests/test_torch_health.py``,
``tests/test_torch_cluster_obs.py``). The reference's helpers for stubbed
verifiers, ring topologies and gossip-tick counts come with the callers
that need them.
"""

from __future__ import annotations

import asyncio
import importlib

from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.chaos import NodeHandle
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig, ConsensusState
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.p2p.transport import MultiplexTransport, NetAddress
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.tools._inproc import (  # noqa: F401 (re-exported)
    CHAIN_ID,
    T0,
    make_genesis,
    make_node,
    make_validators,
)
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet

NETWORK = "chaos-chain"


# --- builders (tests/helpers.py and test_torch_consensus.make_node) --------


def make_weighted_validators(powers, seed: bytes = b"val"):
    """Like make_validators with per-validator voting powers; pvs[i] is
    validator index i of the sorted set."""
    pvs = [MockPV.from_secret(seed + b"%d" % i) for i in range(len(powers))]
    vs = ValidatorSet([Validator(pv.get_pub_key(), p) for pv, p in zip(pvs, powers)])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators]


def sign_commit(vs, pvs, height: int, round_: int, block_id, chain_id: str = CHAIN_ID,
                time_ns: int = T0):
    """All validators precommit block_id (tests/helpers.py's, without the
    QC dual-signs); returns the Commit. The vote classes are those of
    `vs`'s package, so a set of either package signs its own commit."""
    root = type(vs).__module__.split(".")[0]
    vote = importlib.import_module(root + ".types.vote")
    votes = importlib.import_module(root + ".types.vote_set").VoteSet(
        chain_id, height, round_, vote.VoteType.PRECOMMIT, vs)
    for i, pv in enumerate(pvs):
        v = vote.Vote(type=vote.VoteType.PRECOMMIT, height=height, round=round_,
                      block_id=block_id, timestamp_ns=time_ns + i,
                      validator_address=pv.get_pub_key().address(), validator_index=i)
        pv.sign_vote(chain_id, v)
        votes.add_vote(v, verified=True)
    return votes.make_commit()


async def rebuild_node(pv, genesis, app, l2, block_store, state_store,
                       config=None, **kw):
    """A ConsensusState rebuilt from a stopped node's stores, as
    ``Node.on_start`` does: the Handshaker brings the app, the L2 node and
    the state level with the block store (a kill can land after the
    height's block was saved and before its state was), and consensus
    resumes at the height after it. `kw` goes to ConsensusState."""
    executor = BlockExecutor(state_store, block_store, LocalClient(app), l2)
    state = state_store.load() or State.from_genesis(genesis)
    state = await Handshaker(state_store, block_store, genesis, executor).handshake(state)
    return ConsensusState(
        config or ConsensusConfig.test_config(), state, executor,
        block_store, l2, priv_validator=pv, **kw,
    )


def memoize_host_oracle(monkeypatch) -> None:
    """For one test (`monkeypatch`), the port's ed25519 host oracle checks
    each distinct (key, message, signature) once and reuses its verdict.
    An in-proc mesh on device="cpu" checks every vote once a receiver and
    every LastCommit once a node on that oracle (Python integers, ~4 ms a
    signature), all behind one GIL: the work stretches the spread of vote
    arrivals the health and cluster planes measure. The verdicts are the
    oracle's."""
    import functools

    from tendermint_tpu_torch.crypto import ed25519

    monkeypatch.setattr(ed25519, "verify", functools.lru_cache(maxsize=None)(ed25519.verify))


def process_verifier(device: str = "cuda"):
    """The port's process verifier the nodes verify on (through the
    default scheduler when one is installed), on `device`. Raises without
    CUDA unless device="cpu", and when the process verifier was already
    built on another device."""
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.device import resolve

    dev = resolve(device)
    verifier = default_verifier(dev)
    if verifier.device.type != dev.type:
        raise ValueError(f"the process verifier is on {verifier.device}, not {dev}")
    return verifier



class ChaosVerifyService:
    """Kill-and-restart wrapper around the port's in-proc verify service
    (``parallel/verify_service.ServiceThread``), the twin of
    ``tests/chaos_harness.py``'s: ``kill()`` tears the service down
    mid-flight (clients' pending submissions degrade to their local
    verifier, never hang), ``restart()`` brings a fresh service up on the
    SAME socket path (clients' backoff loops re-attach). `device` is the
    card the service verifies on ("cpu" without CUDA); the other keyword
    arguments go to ``VerifyServiceServer`` (a stub verifier through
    ``scheduler=VerifyScheduler(verifier=...)`` keeps a run device-free)."""

    def __init__(self, path: str, device: str = "cuda", **kw):
        self.path = path
        self.device = device
        self._kw = kw
        self.service = None
        self.restarts = 0

    def start(self) -> None:
        from tendermint_tpu_torch.parallel.verify_service import ServiceThread

        self.service = ServiceThread(self.path, device=self.device, **self._kw)
        self.service.start()

    def kill(self) -> None:
        """Tear the service down (connections die, socket unlinks)."""
        if self.service is not None:
            self.service.stop()
            self.service = None

    def restart(self) -> None:
        self.kill()
        self.start()
        self.restarts += 1

    @property
    def alive(self) -> bool:
        return self.service is not None


# --- the mesh ----------------------------------------------------------------


def _wire_node(cs, nk, ping_interval: float = 10.0):
    """Fresh transport + switch + consensus reactor for one node."""
    transport = None
    sw = None

    def node_info():
        return NodeInfo(
            node_id=nk.id,
            listen_addr=f"127.0.0.1:{transport.listen_port}",
            network=NETWORK,
            channels=sw.channels() if sw else b"",
        )

    transport = MultiplexTransport(nk, node_info)
    sw = Switch(transport, ping_interval=ping_interval)
    sw.add_reactor("consensus", ConsensusReactor(cs, vote_batch=True))
    return transport, sw


def build_chaos_handles(
    n: int = 4,
    config=None,
    device: str = "cuda",
    tracer_factory=None,
    ping_interval: float = 10.0,
    powers=None,
    health_factory=None,
) -> list[NodeHandle]:
    """n validator NodeHandles (not yet listening/started), as the
    reference harness builds them, `config` the per-node ConsensusConfig.
    Every node verifies on the process verifier, which must be on `device`
    (process_verifier). `tracer_factory(name) -> Tracer` gives each node
    its own span ring (None: the process-wide tracer); a small
    `ping_interval` makes the peers' clock-offset estimates converge in a
    short run; `powers` gives validator i of the sorted set its voting
    power; `health_factory(name, tracer) -> HealthMonitor` gives each node
    a live health plane on `cs.health`, its incidents in that node's
    tracer."""
    process_verifier(device)
    if powers is not None:
        vs, pvs = make_weighted_validators(powers)
    else:
        vs, pvs = make_validators(n)
    genesis = make_genesis(vs)
    handles: list[NodeHandle] = []
    stores: dict[str, dict] = {}
    for i, pv in enumerate(pvs):
        tracer = tracer_factory(f"n{i}") if tracer_factory else None
        health = health_factory(f"n{i}", tracer) if health_factory else None
        cs, app, l2, bs, ss = make_node(vs, pv, genesis, config=config,
                                        tracer=tracer, health=health)
        stores[f"n{i}"] = dict(pv=pv, genesis=genesis, app=app, l2=l2,
                               block_store=bs, state_store=ss, config=config,
                               tracer=tracer, health=health)
        nk = NodeKey.generate()
        transport, sw = _wire_node(cs, nk, ping_interval=ping_interval)
        handles.append(
            NodeHandle(
                name=f"n{i}",
                cs=cs,
                node_key=nk,
                transport=transport,
                switch=sw,
                block_store=bs,
                restart_fn=_make_restart(handles, stores),
            )
        )
    return handles


def ring_peer_indices(i: int, n: int, degree: int) -> list[int]:
    """The ring-with-chords topology of a committee net (chip_smoke.py's
    phase 7): node i dials its next `degree` ring successors (i+1 ..
    i+degree mod n), so every edge is dialed once and each node ends with
    about 2 x degree connections."""
    if n <= 1:
        return []
    degree = max(1, min(degree, n - 1))
    return [(i + d) % n for d in range(1, degree + 1)]


def _make_restart(handles: list[NodeHandle], stores: dict[str, dict]):
    async def restart(handle: NodeHandle, net) -> None:
        """Rebuild the node from its stores (rebuild_node: same privval,
        app, L2 and stores) and its p2p (fresh node key), and rejoin."""
        handle.cs = await rebuild_node(**stores[handle.name])
        handle.node_key = NodeKey.generate()
        handle.transport, handle.switch = _wire_node(
            handle.cs, handle.node_key, ping_interval=handle.switch.ping_interval)
        net.install(handle)
        await handle.transport.listen()
        await handle.switch.start()
        handle.switch.dial_peers_async(
            [NetAddress(h.node_key.id, "127.0.0.1", h.transport.listen_port)
             for h in handles if h is not handle and h.alive],
            persistent=True,
        )
        await handle.cs.start()

    return restart


async def start_mesh(handles: list[NodeHandle]) -> None:
    """Listen, start switches, wire a persistent full mesh, start
    consensus. Chaos must already be installed so transports wrap their
    connections."""
    for h in handles:
        await h.transport.listen()
        await h.switch.start()
    for h in handles:
        h.switch.dial_peers_async(
            [NetAddress(o.node_key.id, "127.0.0.1", o.transport.listen_port)
             for o in handles if o is not h],
            persistent=True,
        )
    for h in handles:
        await h.cs.start()


async def stop_mesh(handles: list[NodeHandle]) -> None:
    for h in handles:
        if not h.alive:
            continue
        await h.cs.stop()
        await h.switch.stop()


def node_dump(handle: NodeHandle) -> dict:
    """A `dump_traces`-shaped dict for one in-proc node, the input of
    obs.cluster; meaningful when the mesh was built with per-node tracers
    (tracer_factory)."""
    tracer = handle.cs.tracer
    return {
        "node_id": handle.node_key.id,
        "moniker": handle.name,
        "epoch_wall_ns": tracer.epoch_wall_ns,
        "records": [r.to_json() for r in tracer.records()],
        "peer_clock": handle.switch.peer_clock_table(),
    }


def node_ledger(handle: NodeHandle):
    """The DispatchLedger behind a handle's verify path, if any: a
    scheduler-backed verifier (classed adapter or the scheduler itself)
    or an explicitly attached `cs.dispatch_ledger`."""
    cs = handle.cs
    led = getattr(cs, "dispatch_ledger", None)
    if led is not None:
        return led
    verifier = getattr(cs, "verifier", None)
    sched = getattr(verifier, "_sched", None)  # _ClassedVerifier
    if sched is None:
        sched = getattr(cs, "verify_scheduler", None)
    return getattr(sched, "ledger", None)


async def chain_hashes(handles: list[NodeHandle], height: int) -> set:
    return {
        h.block_store.load_block(height).hash()
        for h in handles
        if h.alive and h.block_store.height >= height
    }
