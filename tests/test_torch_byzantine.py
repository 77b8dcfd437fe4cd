"""Byzantine validators against the port: the contract of the reference's
``tests/test_byzantine.py`` (its 3 scenarios, their timeouts and
assertions unchanged) on the port's ``consensus/state_machine.py``,
``evidence/pool.py``, ``state/execution.py`` and ``types/evidence.py``. A
4-validator in-proc net where the 4th validator is actively malicious: it
never runs the honest state machine, and a driver hooked into the honest
nodes' gossip injects signed equivocations at the live (height, round).
Each scenario asserts

  safety   — honest nodes never commit different blocks at a height
  evidence — the equivocation is captured, pooled, proposed, and lands
             in a committed block as DuplicateVoteEvidence
  liveness — the chain keeps advancing with 3/4 honest power

and the committed evidence is bytes on the wire: the reference's
``decode_evidence`` reads the port's encoding with an equal ``hash()``, and
the port reads the reference's back. Votes are checked on the port's
process verifier on the CPU (``cpu_verifier``). Tolerance: exact (hashes,
evidence bytes).
"""

import asyncio
import time

from tendermint_tpu_torch.consensus.messages import ProposalMessage, VoteMessage
from tendermint_tpu_torch.evidence import EvidencePool
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    decode_evidence,
)

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    CHAIN_ID,
    PORT,
    cpu_verifier,
    make_genesis,
    make_validators,
)

BYZ = 3  # validator index of the byzantine actor


def _make_honest_node(pv, genesis):
    """Full node with an evidence pool wired through the executor, so
    captured equivocations flow into proposed blocks."""
    l2 = PORT.MockL2Node()
    app = PORT.KVStoreApplication()
    state = PORT.State.from_genesis(genesis)
    state_store = PORT.StateStore(PORT.MemKV())
    state_store.bootstrap(state)
    block_store = PORT.BlockStore(PORT.MemKV())
    pool = EvidencePool(PORT.MemKV(), state_store, block_store)
    executor = PORT.BlockExecutor(
        state_store, block_store, PORT.LocalClient(app), l2, evidence_pool=pool
    )
    cs = PORT.ConsensusState(
        PORT.ConsensusConfig.test_config(),
        state,
        executor,
        block_store,
        l2,
        priv_validator=pv,
        evidence_pool=pool,
    )
    return cs, pool, block_store


def _byz_vote(pv, vtype, height, round_, block_id):
    v = PORT.Vote(
        type=vtype,
        height=height,
        round=round_,
        block_id=block_id,
        timestamp_ns=time.time_ns(),
        validator_address=pv.get_pub_key().address(),
        validator_index=BYZ,
    )
    pv.sign_vote(CHAIN_ID, v)
    return v


def _fake_block_id():
    h = b"\xbb" * 32
    return PORT.BlockID(hash=h, part_set_header=PORT.PartSetHeader(1, h))


def _wire(css, observer=None):
    """Full-mesh gossip of self-produced messages; `observer(i, msg)`
    sees every broadcast (the byzantine driver's tap)."""
    for i, n in enumerate(css):

        def hook(msg, i=i):
            for j, other in enumerate(css):
                if j != i:
                    other.peer_msg_queue.put_nowait((msg, f"node{i}"))
            if observer is not None:
                observer(i, msg)

        n.broadcast_hook = hook


def _inject(cs, vote):
    cs.peer_msg_queue.put_nowait((VoteMessage(vote), "byzantine"))


def _assert_no_fork(css, up_to_height):
    for h in range(1, up_to_height + 1):
        hashes = {
            cs.block_store.load_block(h).hash()
            for cs in css
            if cs.block_store.load_block(h) is not None
        }
        assert len(hashes) <= 1, f"honest nodes forked at height {h}"


def _committed_byz_evidence(block_store, byz_addr, up_to_height):
    for h in range(2, up_to_height + 1):
        blk = block_store.load_block(h)
        if blk is None:
            continue
        for ev in blk.evidence:
            if (
                isinstance(ev, DuplicateVoteEvidence)
                and ev.vote_a.validator_address == byz_addr
            ):
                return ev
    return None


def _equivocating_driver(css, byz_pv, injected):
    """Fire once per height, at PROPOSAL time (the start of the round):
    the byzantine validator "precommits" both the proposed block and a
    fake one at the same (h, r) to the whole net. Injecting on a late-round
    trigger (an observed precommit) is flaky under CPU contention — votes
    for an already-committed height are discarded, never captured as
    evidence."""

    def byz_driver(i, msg):
        if not isinstance(msg, ProposalMessage):
            return
        p = msg.proposal
        if p.height in injected:
            return
        injected.add(p.height)
        va = _byz_vote(byz_pv, PORT.VoteType.PRECOMMIT, p.height, p.round,
                       p.block_id)
        vb = _byz_vote(byz_pv, PORT.VoteType.PRECOMMIT, p.height, p.round,
                       _fake_block_id())
        for cs in css:
            _inject(cs, va)
            _inject(cs, vb)

    return byz_driver


async def _run_until_evidence(css, height, timeout, injected, byz_addr):
    for cs in css:
        await cs.start()
    await asyncio.gather(*(cs.wait_for_height(height, timeout=timeout)
                           for cs in css))
    # Evidence needs a proposal slot after capture: on a loaded box the
    # injection can fire late, so keep the chain running until the
    # evidence commits (bounded) instead of hard-stopping at `height`.
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if (
            injected
            and _committed_byz_evidence(
                css[0].block_store, byz_addr, css[0].state.last_block_height
            )
            is not None
        ):
            break
        await asyncio.sleep(0.25)
    for cs in css:
        await cs.stop()


def _assert_evidence_bytes_cross_packages(ev):
    """The port's encoding decodes in the reference to evidence of the
    same hash, and the reference's encoding of it decodes in the port to
    the same bytes and hash."""
    from tendermint_tpu.types import evidence as ref_evidence

    data = ev.encode()
    ref_ev = ref_evidence.decode_evidence(data)
    assert isinstance(ref_ev, ref_evidence.DuplicateVoteEvidence)
    assert ref_ev.hash() == ev.hash()
    ref_data = ref_ev.encode()
    assert ref_data == data
    back = decode_evidence(ref_data)
    assert isinstance(back, DuplicateVoteEvidence)
    assert back.hash() == ev.hash() and back.encode() == data


def test_equivocating_precommits_yield_committed_evidence():
    """The byzantine validator precommits two different blocks at the
    same (height, round), relayed to every honest node. Safety holds,
    the duplicate-vote evidence commits, and the chain keeps moving
    (reference byzantine_test.go's double-sign shape)."""
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    byz_pv = pvs[BYZ]
    byz_addr = byz_pv.get_pub_key().address()

    nodes = [_make_honest_node(pv, genesis) for pv in pvs[:3]]
    css = [n[0] for n in nodes]
    injected: set = set()
    _wire(css, observer=_equivocating_driver(css, byz_pv, injected))

    asyncio.run(_run_until_evidence(css, 5, 90, injected, byz_addr))
    assert injected, "byzantine driver never fired"
    top = max(cs.state.last_block_height for cs in css)
    _assert_no_fork(css, top)
    ev = _committed_byz_evidence(css[0].block_store, byz_addr, top)
    assert ev is not None, "byzantine equivocation never committed as evidence"
    assert ev.vote_a.block_id != ev.vote_b.block_id
    for cs in css:
        assert cs.state.last_block_height >= 5, "liveness lost"
    _assert_evidence_bytes_cross_packages(ev)


def test_split_prevotes_no_fork():
    """Conflicting prevotes targeted at different peers (the classic
    split-vote attack): the real proposal hash goes to nodes {0,1}, a
    fabricated hash to nodes {1,2}. Node 1 sees both and captures the
    equivocation; no honest pair ever commits different blocks."""
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    byz_pv = pvs[BYZ]
    byz_addr = byz_pv.get_pub_key().address()

    nodes = [_make_honest_node(pv, genesis) for pv in pvs[:3]]
    css = [n[0] for n in nodes]
    injected: set = set()

    def byz_driver(i, msg):
        if not isinstance(msg, ProposalMessage):
            return
        p = msg.proposal
        key = (p.height, p.round)
        if key in injected or len(injected) >= 3:
            return
        injected.add(key)
        real = _byz_vote(
            byz_pv, PORT.VoteType.PREVOTE, p.height, p.round, p.block_id
        )
        fake = _byz_vote(
            byz_pv, PORT.VoteType.PREVOTE, p.height, p.round, _fake_block_id()
        )
        _inject(css[0], real)
        _inject(css[1], real)
        _inject(css[1], fake)
        _inject(css[2], fake)

    _wire(css, observer=byz_driver)

    async def run():
        for cs in css:
            await cs.start()
        await asyncio.gather(*(cs.wait_for_height(4, timeout=90) for cs in css))
        for cs in css:
            await cs.stop()

    asyncio.run(run())
    assert injected, "byzantine driver never fired"
    _assert_no_fork(css, 4)
    for cs in css:
        assert cs.state.last_block_height >= 4, "liveness lost"
    # node 1 received both conflicting prevotes: the equivocation must be
    # captured and eventually committed by some honest proposer
    ev = _committed_byz_evidence(css[1].block_store, byz_addr, 4)
    assert ev is not None, "split prevotes never captured as evidence"
    assert ev.vote_a.type == PORT.VoteType.PREVOTE


def test_byzantine_proposer_rounds_skipped():
    """The byzantine validator is silent whenever it is the proposer
    (forcing round changes) while still equivocating precommits in other
    rounds. The honest majority must ride through its proposer slots:
    liveness and agreement hold across a window that includes byzantine
    proposer rounds."""
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    byz_pv = pvs[BYZ]
    byz_addr = byz_pv.get_pub_key().address()

    nodes = [_make_honest_node(pv, genesis) for pv in pvs[:3]]
    css = [n[0] for n in nodes]
    injected: set = set()
    _wire(css, observer=_equivocating_driver(css, byz_pv, injected))

    # 6 heights with round-robin proposers guarantees at least one
    # byzantine proposer slot (4 validators)
    asyncio.run(_run_until_evidence(css, 6, 120, injected, byz_addr))
    top = max(cs.state.last_block_height for cs in css)
    _assert_no_fork(css, top)
    for cs in css:
        assert cs.state.last_block_height >= 6, "liveness lost"
    # at least one commit must carry a non-zero round (the byzantine
    # proposer's slot timed out and the net recovered in a later round)
    rounds = []
    for h in range(1, top + 1):
        blk = css[0].block_store.load_block(h + 1)
        if blk is not None and blk.last_commit is not None:
            rounds.append(blk.last_commit.round)
        else:
            sc = css[0].block_store.load_seen_commit(h)
            if sc is not None:
                rounds.append(sc.round)
    assert any(r > 0 for r in rounds), (
        f"no round ever advanced past 0 ({rounds}) — byzantine proposer "
        "slots were never exercised"
    )
    ev = _committed_byz_evidence(css[0].block_store, byz_addr, top)
    assert ev is not None, "equivocation evidence missing"
