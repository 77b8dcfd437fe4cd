"""The port's chaos-mesh builder: the twin of ``tests/chaos_harness.py``.

Builds in-proc validator nodes of ``tendermint_tpu_torch`` over the port's
encrypted p2p (a ``MultiplexTransport``, a ``Switch`` and a
``ConsensusReactor`` a node) wrapped in the port's ``chaos.NodeHandle``s,
with a restart_fn that rebuilds transport/switch around the surviving
consensus state (the "restart" scenario action). ``tests/test_torch_chaos.py``
runs it on ``device="cpu"``; ``chip_smoke.py``'s phase 10 on the card.

It imports nothing of the JAX package, so the smoke can load it where JAX
is absent. Its node builder is therefore ``make_node`` of
``tests/test_torch_consensus.py`` written out over the port alone (that
module builds both packages' namespaces when imported); the validators and
genesis of ``tests/helpers.py`` likewise, with the same seeds.

Left out until their modules are ported: ``ChaosVerifyService`` (it wraps
``parallel/verify_service.py``, item A3 of ROADMAP.md) and
``health_factory`` (it builds ``obs/health.py``'s monitor, item A5). The
reference's helpers for per-node tracers, weighted powers, stubbed
verifiers, ring topologies and gossip-tick counts come with the callers
that need them.
"""

from __future__ import annotations

import asyncio

from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.chaos import NodeHandle
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig, ConsensusState
from tendermint_tpu_torch.l2node.mock import MockL2Node
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.p2p.transport import MultiplexTransport, NetAddress
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet

NETWORK = "chaos-chain"
CHAIN_ID = "test-chain"  # tests/helpers.py's
T0 = 1_700_000_000_000_000_000


# --- builders (tests/helpers.py and test_torch_consensus.make_node) --------


def make_validators(n: int, power: int = 10, seed: bytes = b"val"):
    """(ValidatorSet, [MockPV]) with privvals ordered to match the set."""
    pvs = [MockPV.from_secret(seed + b"%d" % i) for i in range(n)]
    vs = ValidatorSet([Validator(pv.get_pub_key(), power) for pv in pvs])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators]


def make_genesis(vs, chain_id: str = CHAIN_ID) -> GenesisDoc:
    doc = GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=T0,
        validators=[
            GenesisValidator("ed25519", v.pub_key.data, v.voting_power,
                             bls_pub_key=v.bls_pub_key)
            for v in vs.validators
        ],
    )
    doc.validate_and_complete()
    return doc


def make_node(vs, pv, genesis, l2=None, config=None, **kw):
    """(cs, app, l2, block_store, state_store): KVStoreApplication through
    LocalClient, MemKV stores, MockL2Node; `kw` goes to ConsensusState."""
    l2 = l2 or MockL2Node()
    app = KVStoreApplication()
    state = State.from_genesis(genesis)
    state_store = StateStore(MemKV())
    state_store.bootstrap(state)
    block_store = BlockStore(MemKV())
    executor = BlockExecutor(state_store, block_store, LocalClient(app), l2)
    cs = ConsensusState(
        config or ConsensusConfig.test_config(), state, executor,
        block_store, l2, priv_validator=pv, **kw,
    )
    return cs, app, l2, block_store, state_store


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


# --- the mesh ----------------------------------------------------------------


def _wire_node(cs, nk):
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
    sw = Switch(transport)
    sw.add_reactor("consensus", ConsensusReactor(cs, vote_batch=True))
    return transport, sw


def build_chaos_handles(n: int = 4, config=None, device: str = "cuda") -> list[NodeHandle]:
    """n validator NodeHandles (not yet listening/started), as the
    reference harness builds them, `config` the per-node ConsensusConfig.
    Every node verifies on the process verifier, which must be on `device`
    (process_verifier)."""
    process_verifier(device)
    vs, pvs = make_validators(n)
    genesis = make_genesis(vs)
    handles: list[NodeHandle] = []
    for i, pv in enumerate(pvs):
        cs, app, l2, bs, ss = make_node(vs, pv, genesis, config=config)
        nk = NodeKey.generate()
        transport, sw = _wire_node(cs, nk)
        handles.append(
            NodeHandle(
                name=f"n{i}",
                cs=cs,
                node_key=nk,
                transport=transport,
                switch=sw,
                block_store=bs,
                restart_fn=_make_restart(handles),
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


def _make_restart(handles: list[NodeHandle]):
    async def restart(handle: NodeHandle, net) -> None:
        """Rebuild p2p around the same consensus state (same privval and
        stores, fresh node key) and rejoin."""
        handle.node_key = NodeKey.generate()
        handle.transport, handle.switch = _wire_node(handle.cs, handle.node_key)
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


async def chain_hashes(handles: list[NodeHandle], height: int) -> set:
    return {
        h.block_store.load_block(height).hash()
        for h in handles
        if h.alive and h.block_store.height >= height
    }
