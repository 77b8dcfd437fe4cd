"""The port's evidence pool and gossip reactor (``evidence/{pool,reactor}
.py``) against the contract of ``tests/test_evidence.py``: the
duplicate-vote rules, an equivocation reported by consensus landing in a
committed block, old and unknown evidence rejected, and evidence gossiped
between two nodes over p2p channel 0x38. Each contract runs one body on
both packages' roots. Beside them:

- parity: the same seeded equivocation and the same light-client attack
  (a 4-validator chain built through each package's
  ``BlockExecutor`` with fixed block times, forked and re-signed by its own
  keys, detected by each package's ``LightClient`` against its serving
  plane) give both packages' pools the same verdict, the same evidence
  bytes and hash and the same ``pending_evidence``; copies of the attack
  with one signature flipped (both accept it: a commit's tally counts the
  valid signatures, 3 of 4 is still over 2/3) and with half the power
  flipped (both reject it with the same message) are judged alike;
- the wire: evidence added on a port node reaches a JAX-package node's
  pool over encrypted p2p, and the other way round.

The port verifies on its process verifier on ``device="cpu"``
(``cpu_verifier``: 2- and 4-row rounds under ``min_device_batch``, on the
host oracle); the JAX package on a verifier of that package whose
``min_device_batch`` no round reaches. Tolerance: exact (verdicts, bytes).
"""

from __future__ import annotations

import asyncio
import copy
import importlib
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    CHAIN_ID,
    CLOCK_NS,
    PORT,
    REF,
    T0,
    cpu_verifier,
    make_genesis,
    make_validators,
)
from .test_torch_light import ref_host_verifier  # noqa: F401 (a fixture)

ROOTS = [PORT.root, REF.root]


def ev_ns(root: str) -> SimpleNamespace:
    """The evidence subsystem's classes of one package, with what its
    nodes and p2p need."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    evidence = m("evidence")
    ns = PORT if root == PORT.root else REF
    return SimpleNamespace(
        root=root,
        net=ns,
        EvidencePool=evidence.EvidencePool,
        EvidenceReactor=evidence.EvidenceReactor,
        verify_duplicate_vote=evidence.verify_duplicate_vote,
        DuplicateVoteEvidence=m("types.evidence").DuplicateVoteEvidence,
        LightClientAttackEvidence=m("types.evidence").LightClientAttackEvidence,
        decode_evidence=m("types.evidence").decode_evidence,
        Commit=m("types.block").Commit,
        VoteSet=m("types.vote_set").VoteSet,
        NodeKey=m("p2p.key").NodeKey,
        NodeInfo=m("p2p.node_info").NodeInfo,
        Switch=m("p2p.switch").Switch,
        MultiplexTransport=m("p2p.transport").MultiplexTransport,
        NetAddress=m("p2p.transport").NetAddress,
        ed25519=m("crypto.ed25519"),
        LightServePlane=m("lightserve").LightServePlane,
        LightClient=m("light.client").LightClient,
        TrustOptions=m("light.client").TrustOptions,
        ErrLightClientAttack=m("light.client").ErrLightClientAttack,
        LightStore=m("light.store").LightStore,
    )


NS = {root: ev_ns(root) for root in ROOTS}


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def en(request):
    """One package's evidence namespace; for the JAX package its process
    verifier on its host oracle and no default scheduler."""
    if request.param == REF.root:
        request.getfixturevalue("ref_host_verifier")
    return NS[request.param]


def _conflicting_votes(en, pv, index, height, round_=0, ts=T0):
    """Two precommits from one validator for different blocks."""
    n = en.net

    def mk(h):
        v = n.Vote(type=n.VoteType.PRECOMMIT, height=height, round=round_,
                   block_id=n.BlockID(hash=h, part_set_header=n.PartSetHeader(1, h)),
                   timestamp_ns=ts, validator_address=pv.get_pub_key().address(),
                   validator_index=index)
        pv.sign_vote(CHAIN_ID, v)
        return v

    return mk(b"\x01" * 32), mk(b"\x02" * 32)


def _node(en, vs, pvs, genesis, validator=True, fixed_clock=False):
    """(cs, pool, block store, state store) of one node of package `en`
    with an evidence pool wired into its executor and state machine."""
    n = en.net
    l2 = n.MockL2Node()
    state = n.State.from_genesis(genesis)
    ss = n.StateStore(n.MemKV())
    ss.bootstrap(state)
    bs = n.BlockStore(n.MemKV())
    pool = en.EvidencePool(n.MemKV(), ss, bs)
    executor = n.BlockExecutor(ss, bs, n.LocalClient(n.KVStoreApplication()), l2,
                               evidence_pool=pool)
    kw = {"now_ns": lambda: CLOCK_NS} if fixed_clock else {}
    cs = n.ConsensusState(n.ConsensusConfig.test_config(), state, executor, bs, l2,
                          priv_validator=pvs[0] if validator else None,
                          evidence_pool=pool, **kw)
    return cs, pool, bs, ss


def _p2p(en, pool, secret=None):
    """(node key, transport, switch) carrying an EvidenceReactor."""
    nk = (en.NodeKey(en.ed25519.PrivKey.from_secret(secret)) if secret
          else en.NodeKey.generate())
    box = {}

    def node_info():
        return en.NodeInfo(node_id=nk.id, listen_addr=f"127.0.0.1:{box['t'].listen_port}",
                           network="ev-chain",
                           channels=box["sw"].channels() if "sw" in box else b"")

    box["t"] = en.MultiplexTransport(nk, node_info)
    box["sw"] = en.Switch(box["t"])
    box["sw"].add_reactor("evidence", en.EvidenceReactor(pool))
    return nk, box["t"], box["sw"]


# --- the contract of tests/test_evidence.py ------------------------------------------


def test_verify_duplicate_vote_rules(en):
    vs, pvs = make_validators(en.net, 4)
    va, vb = _conflicting_votes(en, pvs[0], 0, height=3)
    ev = en.DuplicateVoteEvidence.from_votes(va, vb, vs.total_voting_power(), 10, T0)
    ev.validate_basic()
    en.verify_duplicate_vote(ev, CHAIN_ID, vs)

    bad = en.DuplicateVoteEvidence.from_votes(va, vb, 999, 10, T0)
    with pytest.raises(ValueError, match="total voting power"):
        en.verify_duplicate_vote(bad, CHAIN_ID, vs)

    va2, vb2 = _conflicting_votes(en, pvs[0], 0, height=3)
    vb2.signature = bytes([vb2.signature[0] ^ 1]) + vb2.signature[1:]
    bad2 = en.DuplicateVoteEvidence.from_votes(va2, vb2, vs.total_voting_power(), 10, T0)
    with pytest.raises(ValueError, match="invalid signature"):
        en.verify_duplicate_vote(bad2, CHAIN_ID, vs)

    with pytest.raises(ValueError):
        ev_same = en.DuplicateVoteEvidence.from_votes(va, va, vs.total_voting_power(), 10, T0)
        ev_same.validate_basic()


def test_equivocation_lands_in_committed_block(en):
    """Consensus captures conflicting votes -> the pool builds evidence on
    Update -> the proposer includes it -> it commits -> the pool marks it
    committed."""
    vs, pvs = make_validators(en.net, 1)
    genesis = make_genesis(en.net, vs)
    cs, pool, bs, ss = _node(en, vs, pvs, genesis)
    rogue_a, rogue_b = _conflicting_votes(en, pvs[0], 0, height=1)

    async def run():
        await cs.start()
        try:
            await cs.wait_for_height(1, timeout=30)
            pool.report_conflicting_votes(rogue_a, rogue_b)
            await cs.wait_for_height(3, timeout=30)
            for h in range(2, 4):
                blk = bs.load_block(h)
                if blk and blk.evidence:
                    return blk
            await cs.wait_for_height(4, timeout=30)
            return bs.load_block(4)
        finally:
            await cs.stop()

    blk = asyncio.run(run())
    assert blk is not None and blk.evidence, "evidence never committed"
    ev = blk.evidence[0]
    assert isinstance(ev, en.DuplicateVoteEvidence)
    assert ev.vote_a.validator_address == pvs[0].get_pub_key().address()
    assert pool.size() == 0, "evidence still pending after commit"


def test_pool_rejects_old_and_unknown_evidence(en):
    n = en.net
    vs, pvs = make_validators(n, 2)
    genesis = make_genesis(n, vs)
    state = n.State.from_genesis(genesis)
    ss = n.StateStore(n.MemKV())
    ss.bootstrap(state)
    pool = en.EvidencePool(n.MemKV(), ss, n.BlockStore(n.MemKV()))
    va, vb = _conflicting_votes(en, pvs[0], 0, height=99)
    ev = en.DuplicateVoteEvidence.from_votes(va, vb, vs.total_voting_power(), 10, T0)
    with pytest.raises(ValueError, match="don't have header"):
        pool.add_evidence(ev)


async def _gossip(src_en, dst_en, src_node, dst_node, ev) -> int:
    """Evidence `ev` added to src's pool reaches dst's pool over p2p
    channel 0x38; returns dst's pool size after at most 5 s."""
    a = _p2p(src_en, src_node[1])
    b = _p2p(dst_en, dst_node[1])
    for _, t, sw in (a, b):
        await t.listen()
        await sw.start()
    try:
        await a[2].dial_peer(src_en.NetAddress(b[0].id, "127.0.0.1", b[1].listen_port))
        src_node[1].add_evidence(ev)
        for _ in range(100):
            await asyncio.sleep(0.05)
            if dst_node[1].size() > 0:
                break
        return dst_node[1].size()
    finally:
        for _, t, sw in (a, b):
            await sw.stop()


def test_reactor_gossips_evidence_between_peers(en):
    """Evidence added on node A reaches node B's pool over p2p channel
    0x38 (reference reactor_test.go TestReactorBroadcastEvidence)."""
    vs, pvs = make_validators(en.net, 1)
    genesis = make_genesis(en.net, vs)
    a = _node(en, vs, pvs, genesis)
    b = _node(en, vs, pvs, genesis, validator=False)

    async def run():
        cs_a = a[0]
        await cs_a.start()
        await cs_a.wait_for_height(1, timeout=30)
        # a live proposer would commit the evidence itself before the
        # gossip tick: stop A's chain first
        await cs_a.stop()
        blk = a[2].load_block(1)
        b[2].save_block(blk, blk.make_part_set(), a[2].load_seen_commit(1))
        b[3].save(a[3].load())
        b[1]._state = a[3].load()
        a[1]._state = a[3].load()
        va, vb = _conflicting_votes(en, pvs[0], 0, height=1, ts=blk.header.time_ns)
        ev = en.DuplicateVoteEvidence.from_votes(va, vb, vs.total_voting_power(), 10,
                                                 blk.header.time_ns)
        return await _gossip(en, en, a, b, ev)

    assert asyncio.run(run()) == 1, "evidence did not gossip to peer"


# --- the wire: port <-> JAX package --------------------------------------------------


@pytest.mark.parametrize("src,dst", [(PORT.root, REF.root), (REF.root, PORT.root)],
                         ids=["port-to-ref", "ref-to-port"])
def test_evidence_gossip_across_packages(src, dst, ref_host_verifier):
    """Each package runs the same 1-validator chain to height 1 on the
    fixed clock (the same block); evidence added on the `src` package's
    node reaches the `dst` package's pool over encrypted p2p, decoded and
    verified there, with the same bytes."""
    s_en, d_en = NS[src], NS[dst]
    nodes = {}
    for en in (s_en, d_en):
        vs, pvs = make_validators(en.net, 1)
        genesis = make_genesis(en.net, vs)
        nodes[en.root] = (_node(en, vs, pvs, genesis, fixed_clock=True), vs, pvs)

    async def run():
        for en in (s_en, d_en):
            cs = nodes[en.root][0][0]
            await cs.start()
            try:
                await cs.wait_for_height(1, timeout=30)
            finally:
                await cs.stop()
        (a, vs, pvs), (b, _, _) = nodes[src], nodes[dst]
        assert a[2].load_block(1).hash() == b[2].load_block(1).hash()
        for node in (a, b):
            node[1]._state = node[3].load()
        t = a[2].load_block(1).header.time_ns
        va, vb = _conflicting_votes(s_en, pvs[0], 0, height=1, ts=t)
        ev = s_en.DuplicateVoteEvidence.from_votes(va, vb, vs.total_voting_power(), 10, t)
        got = await _gossip(s_en, d_en, a, b, ev)
        return got, ev, b[1].pending_evidence()

    got, ev, pending = asyncio.run(run())
    assert got == 1, "evidence did not cross the packages"
    assert [e.encode() for e in pending] == [ev.encode()]
    assert pending[0].hash() == ev.hash()


# --- parity of the pools ---------------------------------------------------------------


def _exec_chain(en, n_vals: int, heights: int):
    """A chain of `heights` blocks of package `en` built through its
    BlockExecutor: block h at T0 + h s, every validator's precommit signed
    into a VoteSet and make_commit(), applied and saved. Returns the stores,
    the set and the privvals."""
    n = en.net
    vs, pvs = make_validators(n, n_vals)
    genesis = make_genesis(n, vs)
    state = n.State.from_genesis(genesis)
    ss = n.StateStore(n.MemKV())
    ss.bootstrap(state)
    bs = n.BlockStore(n.MemKV())
    l2 = n.MockL2Node()
    executor = n.BlockExecutor(ss, bs, n.LocalClient(n.KVStoreApplication()), l2)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}

    async def go(state):
        last_commit = None
        for h in range(1, heights + 1):
            t = T0 + h * 10**9
            block = executor.create_proposal_block(
                h, state, last_commit, state.validators.validators[0].address,
                l2.request_block_data(h), t)
            parts = block.make_part_set()
            bid = n.BlockID(block.hash(), parts.header)
            votes = en.VoteSet(CHAIN_ID, h, 0, n.VoteType.PRECOMMIT, state.validators)
            for i, v in enumerate(state.validators.validators):
                vote = n.Vote(type=n.VoteType.PRECOMMIT, height=h, round=0, block_id=bid,
                              timestamp_ns=t + 1 + i, validator_address=v.address,
                              validator_index=i)
                by_addr[v.address].sign_vote(CHAIN_ID, vote)
                votes.add_vote(vote, verified=True)
            commit = votes.make_commit()
            state = await executor.apply_block(state, bid, block)
            bs.save_block(block, parts, commit)
            last_commit = commit

    asyncio.run(go(state))
    return bs, ss, vs, pvs


def _forked(en, cache, vs, pvs, fork_at, tip):
    """Each package's own fork builder: its tools/lightserve_bench.py."""
    tool = "tendermint_tpu_torch.tools" if en.root == PORT.root else "tools"
    bench = importlib.import_module(tool + ".lightserve_bench")
    return bench.forked_light_chain(cache, vs, pvs, fork_at, tip)


def _flip(en, ev, indices):
    """A copy of light-client-attack evidence `ev` whose conflicting
    commit has one bit of each signature at `indices` flipped."""
    commit = en.Commit.decode(ev.conflicting_commit)
    for i in indices:
        sig = commit.signatures[i].signature
        commit.signatures[i].signature = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
    bad = copy.copy(ev)
    bad.conflicting_commit = commit.encode()
    return bad


def _pool_run(en):
    """The pool's judgement of one seeded equivocation and one seeded
    light-client attack on package `en`'s 4-validator chain of 8 blocks:
    verdicts, evidence bytes and hashes, pending lists (encoded)."""
    from tendermint_tpu_torch.tools._inproc import MockProvider

    bs, ss, vs, pvs = _exec_chain(en, 4, 8)
    target = bs.height - 1
    now = T0 + (bs.height + 60) * 10**9
    pool = en.EvidencePool(en.net.MemKV(), ss, bs)
    out = {}

    def judge(name, ev):
        try:
            pool.add_evidence(ev)
            out[name] = ("accepted", ev.encode(), ev.hash())
        except ValueError as e:
            out[name] = (type(e).__name__, str(e))

    # an equivocation of validator 1 at height 3
    meta = bs.load_block_meta(3)
    va, vb = _conflicting_votes(en, pvs[1], 1, height=3, ts=meta.header.time_ns)
    judge("duplicate vote", en.DuplicateVoteEvidence.from_votes(
        va, vb, vs.total_voting_power(), 10, meta.header.time_ns))
    va2, vb2 = _conflicting_votes(en, pvs[1], 1, height=3, ts=meta.header.time_ns)
    vb2.signature = bytes([vb2.signature[0] ^ 1]) + vb2.signature[1:]
    judge("duplicate vote, one signature flipped", en.DuplicateVoteEvidence.from_votes(
        va2, vb2, vs.total_voting_power(), 10, meta.header.time_ns))

    # a light-client attack: the primary serves a fork re-signed by the set
    plane = en.LightServePlane(bs, ss, CHAIN_ID)
    forked = _forked(en, plane.cache, vs, pvs, max(2, target - 2), target)
    c = en.LightClient(
        CHAIN_ID, en.TrustOptions(3600 * 10**9, 1, plane.cache.get(1).header.hash()),
        MockProvider(list(forked.values()), name="byzantine-primary"),
        [plane.provider("honest-witness")], en.LightStore(en.net.MemKV()),
        now_ns=lambda: now,
    )
    with pytest.raises(en.ErrLightClientAttack) as ei:
        asyncio.run(c.verify_light_block_at_height(target))
    ev = ei.value.evidence
    judge("light-client attack", ev)
    judge("attack, one signature flipped", _flip(en, ev, [0]))
    # validators 0 and 1 hold half the power: the tally falls to 1/2
    judge("attack, half the power flipped", _flip(en, ev, [0, 1]))
    out["pending"] = [e.encode() for e in pool.pending_evidence()]
    out["pending hashes"] = [e.hash() for e in pool.pending_evidence()]
    return out


def test_pools_same_verdicts_bytes_and_pending(ref_host_verifier):
    """The same seeded equivocation and light-client attack, on the same
    chain built by each package: the same verdicts, evidence bytes and
    hashes, and the same pending list."""
    got = {root: _pool_run(NS[root]) for root in ROOTS}
    assert got[PORT.root] == got[REF.root]
    out = got[PORT.root]
    assert out["duplicate vote"][0] == "accepted"
    assert out["duplicate vote, one signature flipped"][0] == "ValueError"
    assert out["light-client attack"][0] == "accepted"
    assert out["attack, one signature flipped"][0] == "accepted"
    assert out["attack, half the power flipped"][0] == "ValueError"
    assert len(out["pending"]) == 3
    ev = NS[PORT.root].decode_evidence(out["light-client attack"][1])
    assert isinstance(ev, NS[PORT.root].LightClientAttackEvidence)
