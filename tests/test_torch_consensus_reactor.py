"""The port's consensus reactor over its p2p stack against the contract of
``tests/test_consensus_reactor.py``: a 4-validator net over encrypted p2p,
a late node brought to the net's height by gossip, and batch-point BLS
checked through the reactor's ``BLSBatcher``. Beside them:

- parity: the same seeds and a fixed clock give the JAX package's app
  hashes and header fields at every height over p2p (``assert_parity``);
- the wire: two port nodes and two JAX-package nodes in one event loop
  commit the same blocks over p2p;
- the vote route: no gossiped vote that a node's ``VoteBatcher`` passed is
  checked again by its ``ConsensusState._verify_vote``, and the batchers'
  rounds reach the plain version of kernel 3 (``verify_prehashed_table``).

The port's nodes verify on its process verifier on ``device="cpu"``
(``cpu_verifier``: rounds under ``min_device_batch`` on the host oracle);
the JAX package's nodes on a verifier of that package whose
``min_device_batch`` no round reaches, so their verdicts come from its host
oracle and it compiles no device program on the CPU. Tolerance: exact
(hashes and header bytes).
"""

from __future__ import annotations

import asyncio
import importlib
import threading
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    CLOCK_NS,
    PORT,
    REF,
    _bls_setup,
    assert_parity,
    cpu_verifier,
    make_genesis,
    make_node,
    make_validators,
    net_heights,
    parity_config,
)

NETWORK = "reactor-chain"


def p2p(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        ed25519=m("crypto.ed25519"),
        NodeKey=m("p2p.key").NodeKey,
        NodeInfo=m("p2p.node_info").NodeInfo,
        Switch=m("p2p.switch").Switch,
        MultiplexTransport=m("p2p.transport").MultiplexTransport,
        NetAddress=m("p2p.transport").NetAddress,
        ConsensusReactor=m("consensus.reactor").ConsensusReactor,
        VoteBatcher=m("consensus.vote_batcher").VoteBatcher,
    )


P2P = {ns.root: p2p(ns.root) for ns in (PORT, REF)}


@pytest.fixture
def ref_host_verifier(monkeypatch):
    """The JAX package's process verifier on its host oracle."""
    v = REF.bv.BatchVerifier(min_device_batch=1 << 30)
    monkeypatch.setattr(REF.bv, "_default", v)
    return v


def build_p2p_node(ns, vs, pv, genesis, key_seed: bytes | None = None, **node_kwargs):
    """(cs, node key, transport, switch, block store) of package `ns`: a
    node of make_node with a MultiplexTransport, a Switch and a
    ConsensusReactor; the node key from `key_seed`, else fresh."""
    net = P2P[ns.root]
    cs, app, l2, bs, ss = make_node(ns, vs, pv, genesis, **node_kwargs)
    nk = (net.NodeKey(net.ed25519.PrivKey.from_secret(key_seed))
          if key_seed is not None else net.NodeKey.generate())
    transport = None
    sw = None

    def node_info():
        return net.NodeInfo(
            node_id=nk.id,
            listen_addr=f"127.0.0.1:{transport.listen_port}",
            network=NETWORK,
            channels=sw.channels() if sw else b"",
        )

    transport = net.MultiplexTransport(nk, node_info)
    sw = net.Switch(transport)
    sw.add_reactor("consensus", net.ConsensusReactor(cs))
    return cs, nk, transport, sw, bs


async def start_p2p(nodes):
    """Listen, start the switches, dial a full mesh (each pair once)."""
    for cs, nk, t, sw, _ in nodes:
        await t.listen()
        await sw.start()
    for i, (_, _, _, sw_i, _) in enumerate(nodes):
        net = P2P[type(sw_i).__module__.split(".")[0]]
        for j, (_, nk_j, t_j, _, _) in enumerate(nodes):
            if j > i:
                await sw_i.dial_peer(net.NetAddress(nk_j.id, "127.0.0.1", t_j.listen_port))


async def run_p2p(nodes, height: int, timeout: float = 60.0):
    """start_p2p, start consensus, wait for `height` on every node, stop."""
    await start_p2p(nodes)
    for cs, *_ in nodes:
        await cs.start()
    try:
        await asyncio.gather(*(cs.wait_for_height(height, timeout=timeout)
                               for cs, *_ in nodes))
    finally:
        for cs, nk, t, sw, _ in nodes:
            await cs.stop()
            await sw.stop()


# --- the contract of tests/test_consensus_reactor.py ------------------------


def test_consensus_over_p2p():
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    nodes = [build_p2p_node(PORT, vs, pv, genesis) for pv in pvs]
    asyncio.run(run_p2p(nodes, 3))
    hashes = {cs.block_store.load_block(3).hash() for cs, *_ in nodes}
    assert len(hashes) == 1, "nodes disagree over p2p"


def test_late_node_catches_up_via_gossip():
    """Node 3 joins after the net reached height 3; the reactor's catch-up
    gossip (block parts from the store, commit votes rebuilt) brings it to
    the net's height."""
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    nodes = [build_p2p_node(PORT, vs, pv, genesis) for pv in pvs]
    early, late = nodes[:3], nodes[3]

    async def run():
        await start_p2p(early)
        for cs, *_ in early:
            await cs.start()
        await asyncio.gather(*(cs.wait_for_height(3, timeout=60) for cs, *_ in early))
        cs_l, nk_l, t_l, sw_l, _ = late
        await t_l.listen()
        await sw_l.start()
        for _, nk, t, _, _ in early:
            await sw_l.dial_peer(
                P2P[PORT.root].NetAddress(nk.id, "127.0.0.1", t.listen_port))
        await cs_l.start()
        try:
            await cs_l.wait_for_height(3, timeout=60)
        finally:
            for cs, nk, t, sw, _ in nodes:
                await cs.stop()
                await sw.stop()

    asyncio.run(run())
    cs_l = late[0]
    assert cs_l.state.last_block_height >= 3
    assert cs_l.block_store.load_block(3).hash() == early[0][0].block_store.load_block(3).hash()


def test_batch_point_bls_over_p2p_uses_aggregate_batcher():
    """Every 2nd block a batch point: precommits carry real BLS12-381
    dual-signatures, the reactor's BLSBatcher pre-verifies them, and every
    node's L2 receives CommitBatch with >= 2/3 BLS data that verify as one
    aggregate."""
    bls = PORT.bls
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    registry, signers = _bls_setup(PORT, pvs)
    nodes = []
    for pv, signer in zip(pvs, signers):
        l2 = PORT.MockL2Node(batch_blocks_interval=2,
                             bls_verifier=registry.verifier(),
                             bls_batch_verifier=registry.batch_verifier())
        nodes.append(build_p2p_node(PORT, vs, pv, genesis, l2=l2, bls_signer=signer))
    asyncio.run(run_p2p(nodes, 3, timeout=120))
    for cs, *_ in nodes:
        assert cs.l2.committed_batches, "no batch committed"
        batch_hash, bls_datas = cs.l2.committed_batches[0]
        assert len(bls_datas) >= 3
        pubs, sigs = [], []
        for d in bls_datas:
            _, val = cs.state.validators.get_by_address(d.signer)
            pubs.append(registry._by_tm[bytes(val.pub_key.data)])
            sigs.append(bls.g1_from_bytes(d.signature))
        assert bls.verify_aggregated_same_message(
            bls.aggregate_signatures(sigs), batch_hash, pubs)
    assert any(sw.reactors["consensus"].bls_batcher.batch_sizes for *_, sw, _ in nodes), (
        "no BLS verification went through the reactor's batcher")


# --- the port's own contract ------------------------------------------------


def p2p_parity_net(ns, heights: int = 3, n: int = 4):
    """parity_net over p2p: the seeded validators, the fixed clock, node
    keys from the seed; returns net_heights of the run to heights + 1."""
    vs, pvs = make_validators(ns, n, seed=b"parity")
    genesis = make_genesis(ns, vs)
    config = parity_config(ns)
    nodes = [build_p2p_node(ns, vs, pv, genesis, key_seed=b"parity-node%d" % i,
                            config=config, now_ns=lambda: CLOCK_NS)
             for i, pv in enumerate(pvs)]
    asyncio.run(run_p2p(nodes, heights + 1))
    return net_heights([nd[4] for nd in nodes], heights)


def test_p2p_net_matches_reference(ref_host_verifier):
    """Legacy commits over p2p: the same seeds and clock through both
    packages give equal app hashes and header fields at heights 1-3."""
    assert_parity(p2p_parity_net(PORT), p2p_parity_net(REF))


def test_mixed_package_net_agrees(ref_host_verifier):
    """Two port nodes and two JAX-package nodes over p2p in one event
    loop reach height 3 with one block hash at every height: the two
    packages speak the same wire (handshake, framing, reactor messages,
    batched votes)."""
    nodes = []
    for i in range(4):
        ns = PORT if i % 2 == 0 else REF
        # each package's own genesis and privval, from the same seeds
        vs, pvs = make_validators(ns, 4, seed=b"mixed")
        nodes.append(build_p2p_node(ns, vs, pvs[i], make_genesis(ns, vs)))
    assert [type(nd[0]).__module__.split(".")[0] for nd in nodes] == [
        PORT.root, REF.root, PORT.root, REF.root]
    asyncio.run(run_p2p(nodes, 3))
    for h in (1, 2, 3):
        assert len({nd[4].load_block(h).hash() for nd in nodes}) == 1, h


# batcher rounds of a run that take kernel 3's plain version (~0.4 s each on
# one thread) before the rest take the host oracle
PLAIN_BATCHER_ROUNDS = 6


def test_vote_route_skips_serial_checks_and_reaches_kernel3(monkeypatch):
    """With the reactor, every gossiped vote goes through the node's
    VoteBatcher, and from there through one started VerifyScheduler as the
    process default, before the state machine sees it. The state machine
    checks no vote its batcher passed, and rounds that carry batcher rows
    and reach min_device_batch (2 here, so a 4-validator net's rounds reach
    it) run kernel 3's plain version on the CPU: the first
    PLAIN_BATCHER_ROUNDS such rounds do, and from then on the rounds take
    the host oracle."""
    import torch

    from tendermint_tpu_torch.consensus.state_machine import ConsensusState
    from tendermint_tpu_torch.ops import ed25519_batch as ed
    from tendermint_tpu_torch.parallel import scheduler as sched_mod

    VoteBatcher = P2P[PORT.root].VoteBatcher
    verifier = PORT.bv.BatchVerifier(device="cpu", min_device_batch=2)
    monkeypatch.setattr(PORT.bv, "_default", verifier)
    passed = {}  # id(batcher) -> the signatures it passed
    rechecked, serial = [], []
    # a batcher's items are live from its _verify_items call until their
    # verdicts return; the round that holds them is prepared (prep
    # thread) and run (dispatch thread) inside that span
    live, lock, tls = set(), threading.Lock(), threading.local()
    plain_calls = {"batcher": 0, "other": 0}

    submit, submit_many = VoteBatcher.submit, VoteBatcher.submit_many
    verify_items, verify_vote = VoteBatcher._verify_items, ConsensusState._verify_vote
    prepare, plain = verifier.prepare, ed.verify_prehashed_table_plain

    async def tracked_submit(self, pubkey, msg, sig, key_type="ed25519"):
        ok = await submit(self, pubkey, msg, sig, key_type=key_type)
        if ok:
            passed.setdefault(id(self), set()).add(sig)
        return ok

    async def tracked_submit_many(self, sigs):
        oks = await submit_many(self, sigs)
        passed.setdefault(id(self), set()).update(s[2] for s, ok in zip(sigs, oks) if ok)
        return oks

    def tracked_verify_items(self, items):
        with lock:
            live.update(id(it) for it in items)
        try:
            return verify_items(self, items)
        finally:
            with lock:
                live.difference_update(id(it) for it in items)

    def tagged_prepare(items):
        with lock:
            from_batcher = any(id(it) in live for it in items)
        handle = prepare(items)
        run = handle.run

        def run_tagged():
            tls.from_batcher = from_batcher
            try:
                return run()
            finally:
                tls.from_batcher = False

        handle.run = run_tagged
        return handle

    def counted_plain(*args):
        from_batcher = getattr(tls, "from_batcher", False)
        plain_calls["batcher" if from_batcher else "other"] += 1
        if plain_calls["batcher"] >= PLAIN_BATCHER_ROUNDS:
            # the route is shown: later rounds take the host oracle, or the
            # run's wall is ~40 plain calls of ~0.4 s each, which a loaded
            # host stretches past run_p2p's wait for height 2
            verifier._min_device_batch = 1 << 30
        return plain(*args)

    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    nodes = [build_p2p_node(PORT, vs, pv, genesis, config=parity_config(PORT))
             for pv in pvs]
    batcher_of = {id(cs): id(sw.reactors["consensus"].vote_batcher)
                  for cs, nk, t, sw, _ in nodes}

    def checked_vote(self, vote, vals):
        serial.append(vote.signature)
        if vote.signature in passed.get(batcher_of[id(self)], ()):
            rechecked.append(vote)
        return verify_vote(self, vote, vals)

    monkeypatch.setattr(VoteBatcher, "submit", tracked_submit)
    monkeypatch.setattr(VoteBatcher, "submit_many", tracked_submit_many)
    monkeypatch.setattr(VoteBatcher, "_verify_items", tracked_verify_items)
    monkeypatch.setattr(ConsensusState, "_verify_vote", checked_vote)
    monkeypatch.setattr(verifier, "prepare", tagged_prepare)
    monkeypatch.setattr(ed, "verify_prehashed_table_plain", counted_plain)
    for cs, *_ in nodes:
        assert cs.verifier is verifier
    sched = sched_mod.VerifyScheduler()

    async def run():
        await sched.start()
        try:
            await run_p2p(nodes, 2)
        finally:
            await sched.stop()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain version is thousands of small ops
    monkeypatch.setattr(sched_mod, "_default_scheduler", sched)
    try:
        asyncio.run(run())
    finally:
        torch.set_num_threads(threads)
    assert len({nd[4].load_block(2).hash() for nd in nodes}) == 1
    n_passed = sum(len(v) for v in passed.values())
    assert n_passed >= 4 * 3, passed  # a vote of each peer at each node
    assert not rechecked, f"{len(rechecked)} pre-verified votes checked again"
    assert serial, "the nodes' own votes go through _verify_vote"
    assert plain_calls["batcher"] > 0, plain_calls
