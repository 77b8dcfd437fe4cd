"""The in-proc validator net the port's harnesses build on.

A seeded committee of ``MockPV`` validators, its genesis, one node a
validator (a ``ConsensusState`` over the kvstore app through
``LocalClient``, MemKV stores and a mock L2 node), full-mesh gossip of the
nodes' own messages, and a light-client provider over a list of blocks.
The reference's harnesses take these from its ``tests/`` (``helpers.py``,
``test_consensus.py``, ``test_light.py``); the port's tools import nothing
outside the package, so they live here, with the same seeds and chain id,
and the port's test harnesses (``tests/torch_chaos_harness.py``) import
them from here.
"""

from __future__ import annotations

from ..abci.client import LocalClient
from ..abci.kvstore import KVStoreApplication
from ..consensus.state_machine import ConsensusConfig, ConsensusState
from ..l2node.mock import MockL2Node
from ..state.execution import BlockExecutor
from ..state.state import State
from ..state.store import StateStore
from ..store.block_store import BlockStore
from ..store.kv import MemKV
from ..types.genesis import GenesisDoc, GenesisValidator
from ..types.priv_validator import MockPV
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet

CHAIN_ID = "test-chain"
T0 = 1_700_000_000_000_000_000


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
    LocalClient, MemKV stores, MockL2Node; `kw` goes to ConsensusState.
    Without a `verifier` in `kw` the node verifies on the process verifier."""
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


def wire_net(nodes) -> None:
    """Full-mesh gossip of self-produced messages (in-proc harness)."""
    for i, n in enumerate(nodes):
        def hook(msg, i=i):
            for j, other in enumerate(nodes):
                if j != i:
                    other.peer_msg_queue.put_nowait((msg, f"node{i}"))

        n.broadcast_hook = hook


class MockProvider:
    """A light-client provider over a list of LightBlocks (in-proc, no
    sockets)."""

    def __init__(self, blocks, name: str = "primary"):
        self.blocks = {b.height: b for b in blocks}
        self.name = name

    async def light_block(self, height: int):
        if height == 0:
            height = max(self.blocks)
        return self.blocks.get(height)

    def id(self) -> str:
        return self.name
