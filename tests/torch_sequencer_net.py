"""A BFT net of the port that hands off to sequencer mode over encrypted
p2p: the upgrade of ``tests/test_sequencer.py``'s
``test_bft_upgrade_hands_off_to_sequencer`` with followers.

Every node is a validator with a ``ConsensusReactor`` and a
``BlockBroadcastReactor`` (``wait_sync=True``, as node assembly registers
it) on one switch, full mesh. At ``upgrade_height`` each node stops BFT and
switches as node assembly's ``_switch_to_sequencer_mode`` does: its mock L2
is seeded to the BFT height, then the reactor's routines start. Node 0
holds the sequencer key and produces signed BlockV2s; the others follow,
each block's signer recovered through their ``SequencerVerifyBatcher``
(the process default scheduler's ``secp_recover`` lane). Votes before the
upgrade reach their nodes' ``VoteBatcher``s, so through the default
scheduler too.

``tests/test_torch_sequencer.py`` runs it on ``device="cpu"`` behind a
port verify service; ``chip_smoke.py``'s phase 11 on the card. It imports
nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
from types import SimpleNamespace

from tendermint_tpu_torch.crypto import secp256k1
from tendermint_tpu_torch.l2node.mock import MockL2Node
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.transport import NetAddress
from tendermint_tpu_torch.sequencer import (
    BlockBroadcastReactor,
    LocalSigner,
    StateV2,
    StaticSequencerVerifier,
)

from .torch_chaos_harness import _wire_node, make_genesis, make_node, make_validators

SEQUENCER_SECRET = b"upgrade-seq"  # test_bft_upgrade_hands_off_to_sequencer's key


def build_upgrade_net(n: int, upgrade_height: int, block_interval: float = 0.1,
                      config=None) -> list[SimpleNamespace]:
    """n validator nodes, node 0 the sequencer: each a SimpleNamespace of
    cs, l2, sv (StateV2), seq (its BlockBroadcastReactor), node_key,
    transport and switch, not yet listening."""
    vs, pvs = make_validators(n)
    genesis = make_genesis(vs)
    signer = LocalSigner(secp256k1.PrivKey.from_secret(SEQUENCER_SECRET))
    verifier = StaticSequencerVerifier([signer.address()])
    nodes = []
    for i, pv in enumerate(pvs):
        l2 = MockL2Node()
        sv = StateV2(l2, block_interval=block_interval,
                     signer=signer if i == 0 else None, verifier=verifier)
        seq = BlockBroadcastReactor(sv, verifier, wait_sync=True)

        async def on_upgrade(state, l2=l2, seq=seq):
            l2.seed_v2_height(state.last_block_height)
            await seq.start_sequencer_routines()

        cs, _app, _l2, bs, _ss = make_node(
            vs, pv, genesis, l2=l2, config=config,
            upgrade_height=upgrade_height, on_upgrade=on_upgrade)
        nk = NodeKey.generate()
        transport, sw = _wire_node(cs, nk)
        sw.add_reactor("sequencer", seq)
        nodes.append(SimpleNamespace(cs=cs, l2=l2, sv=sv, seq=seq, bs=bs,
                                     node_key=nk, transport=transport, switch=sw,
                                     signer=signer if i == 0 else None))
    return nodes


async def run_upgrade(nodes, upgrade_height: int, v2_blocks: int,
                      timeout: float = 120.0) -> dict:
    """Start the net (a full mesh), wait for every node to commit the
    upgrade height and for every follower to apply `v2_blocks` BlockV2s
    past it, then stop. Returns the BFT heights, the sequencer's and each
    follower's V2 height, and the signers the followers recovered from
    their last blocks."""
    for nd in nodes:
        await nd.transport.listen()
        await nd.switch.start()
    for i, nd in enumerate(nodes):
        for other in nodes[i + 1:]:
            await nd.switch.dial_peer(
                NetAddress(other.node_key.id, "127.0.0.1", other.transport.listen_port))
    for nd in nodes:
        await nd.cs.start()
    try:
        await asyncio.wait_for(asyncio.gather(
            *(nd.cs.wait_for_height(upgrade_height, timeout=timeout) for nd in nodes)),
            timeout)
        target = upgrade_height + v2_blocks
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while (any(nd.sv.latest_height() < target for nd in nodes[1:])
               and loop.time() < deadline):
            await asyncio.sleep(0.05)
        return {
            "bft_heights": [nd.bs.height for nd in nodes],
            "sequencer_v2": nodes[0].sv.latest_height(),
            "follower_v2": [nd.sv.latest_height() for nd in nodes[1:]],
            "signers": [nd.sv.latest_block.recover_signer() if nd.sv.latest_block else None
                        for nd in nodes[1:]],
            "sequencer_address": nodes[0].signer.address(),
        }
    finally:
        await stop_upgrade_net(nodes)


async def stop_upgrade_net(nodes) -> None:
    for nd in nodes:
        if nd.cs._running:
            await nd.cs.stop()
    for nd in nodes:
        await nd.switch.stop()
