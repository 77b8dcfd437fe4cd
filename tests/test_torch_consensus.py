"""The port's in-process consensus core against the contract of
``tests/test_consensus.py``: in-proc validators wired through broadcast
hooks (no p2p), a single-validator chain, a 4-validator net, a faulty
node, the batch-point BLS flow and its rejection, the upgrade switch,
batch start across a restart and catch-up rounds. Beside them, parity: a
4-validator net of each package on the same seeds and the same fixed
clock gives equal app hashes and header fields at heights 1-3, and equal
blocks while the two chains' LastCommits carry the same signers.

The port runs with its process verifier on ``device="cpu"`` (votes on the
host oracle, LastCommit rounds below ``min_device_batch``); the JAX
package on its own default verifier, whose 4-row rounds stay on its host
oracle too. Tolerance: exact (hashes and header bytes).

The helpers here build either package's net from its import root; the
other ``test_torch_*`` consensus files import them.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
from types import SimpleNamespace

import pytest

CHAIN_ID = "test-chain"
T0 = 1_700_000_000_000_000_000
CLOCK_NS = T0 + 10**9  # the fixed wall clock of the parity nets

# header fields that carry which precommits made it into the LastCommit:
# the proposer builds its block once +2/3 are in, so stragglers are a race
# between the nodes (and with pipelined heights, by design); compared
# across the packages only while both chains' signer sets agree
COMMIT_FIELDS = ("time_ns", "last_block_id", "last_commit_hash")


def pkg(root: str) -> SimpleNamespace:
    """The classes and modules a net needs, from one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    sm = m("consensus.state_machine")
    return SimpleNamespace(
        root=root,
        bls=m("crypto.bls_signatures"),
        bv=m("crypto.batch_verifier"),
        R=m("crypto.bls12_381").R,
        LocalClient=m("abci.client").LocalClient,
        KVStoreApplication=m("abci.kvstore").KVStoreApplication,
        ConsensusConfig=sm.ConsensusConfig,
        ConsensusState=sm.ConsensusState,
        MockL2Node=m("l2node.mock").MockL2Node,
        BlockExecutor=m("state.execution").BlockExecutor,
        State=m("state.state").State,
        StateStore=m("state.store").StateStore,
        BlockStore=m("store.block_store").BlockStore,
        MemKV=m("store.kv").MemKV,
        MockPV=m("types.priv_validator").MockPV,
        Validator=m("types.validator").Validator,
        ValidatorSet=m("types.validator_set").ValidatorSet,
        GenesisDoc=m("types.genesis").GenesisDoc,
        GenesisValidator=m("types.genesis").GenesisValidator,
        BlockID=m("types.block_id").BlockID,
        PartSetHeader=m("types.part_set").PartSetHeader,
        Vote=m("types.vote").Vote,
        VoteType=m("types.vote").VoteType,
        HeightVoteSet=m("consensus.height_vote_set").HeightVoteSet,
        batch=m("consensus.batch"),
    )


PORT = pkg("tendermint_tpu_torch")
REF = pkg("tendermint_tpu")


@pytest.fixture(autouse=True)
def cpu_verifier(monkeypatch):
    """The port's process verifier on the CPU and no default scheduler."""
    from tendermint_tpu_torch.parallel import scheduler

    v = PORT.bv.BatchVerifier(device="cpu")
    monkeypatch.setattr(PORT.bv, "_default", v)
    monkeypatch.setattr(scheduler, "_default_scheduler", None)
    monkeypatch.delenv("TM_TPU_BLS_PAIRING_DEVICE", raising=False)
    return v


# --- builders (tests/helpers.py and tests/test_consensus.py, per package) --


def make_validators(ns, n: int, power: int = 10, seed: bytes = b"val"):
    """(ValidatorSet, [MockPV]) with privvals ordered to match the set."""
    pvs = [ns.MockPV.from_secret(seed + b"%d" % i) for i in range(n)]
    vs = ns.ValidatorSet([ns.Validator(pv.get_pub_key(), power) for pv in pvs])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators]


def make_qc_validators(ns, n: int, power: int = 10, seed: bytes = b"val"):
    """(ValidatorSet, [MockPV], {address: bls scalar}): every validator
    carries a BLS key, scalars derived from `seed`."""
    pvs = [ns.MockPV.from_secret(seed + b"%d" % i) for i in range(n)]
    vals, privs = [], {}
    for i, pv in enumerate(pvs):
        h = hashlib.sha256(seed + b"bls%d" % i).digest()
        scalar = int.from_bytes(h, "big") % (ns.R - 1) + 1
        pub = ns.bls.pubkey_from_priv(scalar)
        privs[pv.get_pub_key().address()] = scalar
        vals.append(ns.Validator(pv.get_pub_key(), power,
                                 bls_pub_key=ns.bls.g2_to_bytes(pub.key)))
    vs = ns.ValidatorSet(vals)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators], privs


def make_genesis(ns, vs, chain_id: str = CHAIN_ID):
    doc = ns.GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=T0,
        validators=[
            ns.GenesisValidator("ed25519", v.pub_key.data, v.voting_power,
                                bls_pub_key=v.bls_pub_key)
            for v in vs.validators
        ],
    )
    doc.validate_and_complete()
    return doc


def make_node(ns, vs, pv, genesis, l2=None, config=None, **kw):
    """(cs, app, l2, block_store, state_store): KVStoreApplication through
    LocalClient, MemKV stores, MockL2Node; `kw` goes to ConsensusState."""
    l2 = l2 or ns.MockL2Node()
    app = ns.KVStoreApplication()
    state = ns.State.from_genesis(genesis)
    state_store = ns.StateStore(ns.MemKV())
    state_store.bootstrap(state)
    block_store = ns.BlockStore(ns.MemKV())
    executor = ns.BlockExecutor(state_store, block_store, ns.LocalClient(app), l2)
    cs = ns.ConsensusState(
        config or ns.ConsensusConfig.test_config(), state, executor,
        block_store, l2, priv_validator=pv, **kw,
    )
    return cs, app, l2, block_store, state_store


def wire_net(css):
    """Full-mesh gossip of self-produced messages (in-proc harness)."""
    for i, n in enumerate(css):
        def hook(msg, i=i):
            for j, other in enumerate(css):
                if j != i:
                    other.peer_msg_queue.put_nowait((msg, f"node{i}"))

        n.broadcast_hook = hook


async def run_to(css, height: int, timeout: float = 60.0, live=None):
    """Start `live` (default all) nodes, wait for `height`, stop them."""
    live = css if live is None else live
    for cs in live:
        await cs.start()
    try:
        await asyncio.gather(*(cs.wait_for_height(height, timeout=timeout)
                               for cs in live))
    finally:
        for cs in live:
            await cs.stop()


def parity_config(ns, **fields):
    """test_config with room for every precommit before the next proposal
    and propose/vote timeouts no loaded host reaches in a healthy round."""
    cfg = ns.ConsensusConfig.test_config()
    cfg.timeout_propose = cfg.timeout_prevote = cfg.timeout_precommit = 5.0
    cfg.timeout_commit = 0.3
    cfg.skip_timeout_commit = False
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def parity_net(ns, heights: int = 3, n: int = 4, qc: bool = False,
               scheduler=None, timeout: float = 60.0, **cfg):
    """A seeded n-validator net on the fixed clock (with `scheduler`
    started around it when given); returns, per height, every node's block
    hash and app hash after it, and node 0's blocks."""
    if qc:
        vs, pvs, privs = make_qc_validators(ns, n, seed=b"parity")
    else:
        vs, pvs = make_validators(ns, n, seed=b"parity")
    genesis = make_genesis(ns, vs)
    config = parity_config(ns, quorum_certificates=qc, **cfg)
    nodes = []
    for pv in pvs:
        kw = {}
        if qc:
            kw["bls_signer"] = ns.bls.signer_for(privs[pv.get_pub_key().address()])
        nodes.append(make_node(ns, vs, pv, genesis, config=config,
                               now_ns=lambda: CLOCK_NS, **kw))
        nodes[-1][0].executor.qc_enabled = qc
    css = [nd[0] for nd in nodes]
    wire_net(css)

    async def run():
        if scheduler is not None:
            await scheduler.start()
        try:
            await run_to(css, heights + 1, timeout=timeout)
        finally:
            if scheduler is not None:
                await scheduler.stop()

    asyncio.run(run())
    return net_heights([nd[3] for nd in nodes], heights)


def net_heights(stores, heights: int) -> list[dict]:
    """Per height of a net run to heights + 1: every node's block hash and
    app hash after it, and the first node's blocks (what assert_parity
    reads), from the nodes' block stores."""
    out = []
    for h in range(1, heights + 1):
        blocks = [bs.load_block(h) for bs in stores]
        nxt = [bs.load_block(h + 1) for bs in stores]
        out.append({
            "hashes": {b.hash() for b in blocks},
            "app_hashes": {b.header.app_hash for b in nxt},
            "header": blocks[0].header,
            "prev": stores[0].load_block(h - 1) if h > 1 else None,
            "block": blocks[0],
            "next": nxt[0],
        })
    return out


def header_fields(header) -> dict:
    """Every header field but the LastCommit-dependent ones."""
    return {k: v for k, v in vars(header).items()
            if not k.startswith("_") and k not in COMMIT_FIELDS}


def signer_flags(block) -> list | None:
    """The LastCommit's block-ID flag per validator (None at height 1)."""
    if block.last_commit is None:
        return None
    return [int(cs.block_id_flag) for cs in block.last_commit.signatures]


def assert_parity(port, ref):
    """Same block per height on every node of each net; equal app hashes
    and header fields across the packages; each package's commit-derived
    fields link its own chain. While both chains' LastCommits carry the
    same signers at every height so far, the whole blocks are equal across
    the packages too (commit-derived fields and time_ns included)."""
    assert len(port) == len(ref)
    linked = True
    for h, (p, r) in enumerate(zip(port, ref), start=1):
        assert len(p["hashes"]) == 1 and len(r["hashes"]) == 1, f"height {h} forked"
        assert len(p["app_hashes"]) == 1 and len(r["app_hashes"]) == 1
        assert p["app_hashes"] == r["app_hashes"], f"app hash differs at {h}"
        assert header_fields(p["header"]) == header_fields(r["header"]), h
        linked = linked and signer_flags(p["block"]) == signer_flags(r["block"])
        if linked:
            assert p["header"].last_commit_hash == r["header"].last_commit_hash, h
            assert p["header"].last_block_id.hash == r["header"].last_block_id.hash, h
            assert p["block"].hash() == r["block"].hash(), f"block differs at {h}"
        for side in (p, r):
            hd = side["header"]
            assert side["next"].header.last_block_id.hash == side["block"].hash()
            if side["prev"] is not None:
                assert hd.last_block_id.hash == side["prev"].hash()
                assert hd.last_commit_hash == side["block"].last_commit.hash()


# --- the contract of tests/test_consensus.py --------------------------------


def test_single_validator_chain():
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)

    async def run():
        cs, app, l2, bs, ss = make_node(PORT, vs, pvs[0], genesis)
        await run_to([cs], 3, timeout=20)
        assert cs.state.last_block_height >= 3
        assert bs.height >= 3
        assert len(l2.delivered) >= 3
        b2, b3 = bs.load_block(2), bs.load_block(3)
        assert b3.header.last_block_id.hash == b2.hash()
        assert b3.last_commit is not None
        ss.load_validators(2).verify_commit_light(
            CHAIN_ID, b3.header.last_block_id, 2, b3.last_commit)

    asyncio.run(run())


def test_four_validator_net():
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    nodes = [make_node(PORT, vs, pv, genesis) for pv in pvs]
    css = [n[0] for n in nodes]
    wire_net(css)
    asyncio.run(run_to(css, 3, timeout=30))
    assert len({cs.block_store.load_block(3).hash() for cs in css}) == 1
    assert all(cs.state.last_block_height >= 3 for cs in css)


def test_net_survives_one_faulty_node():
    """3 of 4 validators are enough for progress (one node never starts);
    the height-2 commit carries an absent signature for it."""
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    nodes = [make_node(PORT, vs, pv, genesis) for pv in pvs]
    css = [n[0] for n in nodes]
    wire_net(css)
    asyncio.run(run_to(css, 2, timeout=40, live=css[:3]))
    assert all(cs.state.last_block_height >= 2 for cs in css[:3])
    b = css[0].block_store.load_block(3)
    commit = b.last_commit if b is not None else css[0].block_store.load_seen_commit(2)
    assert any(s.is_absent() for s in commit.signatures)


def _bls_setup(ns, pvs):
    """Real BLS keys per validator and a registry-backed verifier."""
    registry = ns.bls.BLSKeyRegistry()
    signers = []
    for i, pv in enumerate(pvs):
        priv = 7919 + i
        registry.register(pv.get_pub_key().data, ns.bls.pubkey_from_priv(priv))
        signers.append(ns.bls.signer_for(priv))
    return registry, signers


def test_batch_point_bls_flow():
    """Every 2nd block is a batch point: the header carries the batch hash,
    precommits carry real BLS12-381 signatures over it, the L2 node
    verifies each one and receives CommitBatch with the BLS data, which
    verify against the registered key; a flipped byte does not."""
    bls = PORT.bls
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    registry, signers = _bls_setup(PORT, pvs)
    l2 = PORT.MockL2Node(batch_blocks_interval=2, bls_verifier=registry.verifier())
    cs, app, _, bs, ss = make_node(PORT, vs, pvs[0], genesis, l2=l2,
                                   bls_signer=signers[0])
    asyncio.run(run_to([cs], 4, timeout=30))
    batch_blocks = [bs.load_block(h) for h in range(1, 5)
                    if bs.load_block(h).header.batch_hash]
    assert batch_blocks, "no batch points produced"
    assert l2.committed_batches and l2.bls_appended
    batch_hash, bls_datas = l2.committed_batches[0]
    assert bls_datas and batch_blocks[0].data.l2_batch_header
    pub = bls.public_key_from_bytes(
        bls.public_key_to_bytes(bls.pubkey_from_priv(7919)), True)
    sig_bytes = bls_datas[0].signature
    assert bls.verify(bls.g1_from_bytes(sig_bytes), batch_hash, pub)
    bad = bytearray(sig_bytes)
    bad[7] ^= 1
    assert not registry.verifier()(pvs[0].get_pub_key().data, batch_hash, bytes(bad))


def test_batch_point_rejects_invalid_bls():
    """A precommit whose BLS signature does not verify is rejected at the
    batch point: height 1 (never a batch point) commits, height 2 stalls."""
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    registry, _ = _bls_setup(PORT, pvs)
    l2 = PORT.MockL2Node(batch_blocks_interval=1, bls_verifier=registry.verifier())

    async def run():
        cs, *_ = make_node(PORT, vs, pvs[0], genesis, l2=l2,
                           bls_signer=lambda bh: b"\x01" * 96)
        await cs.start()
        await cs.wait_for_height(1, timeout=10)
        with pytest.raises(asyncio.TimeoutError):
            await cs.wait_for_height(2, timeout=1.5)
        await cs.stop()
        assert not l2.committed_batches

    asyncio.run(run())


def test_upgrade_switch_stops_bft():
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    upgraded = []

    async def run():
        cs, *_ = make_node(PORT, vs, pvs[0], genesis, upgrade_height=2,
                           on_upgrade=lambda st: upgraded.append(st.last_block_height))
        await cs.start()
        await cs.wait_for_height(2, timeout=20)
        await asyncio.sleep(0.5)  # room to (wrongly) keep going
        await cs.stop()
        assert upgraded == [2]
        assert cs.state.last_block_height == 2

    asyncio.run(run())


def test_batch_start_survives_restart():
    """get_batch_start rebuilds the batch cache from the block store after
    a restart (interval batching from on-chain params, every 3 blocks)."""
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    genesis.consensus_params.batch.blocks_interval = 3
    registry, signers = _bls_setup(PORT, pvs)
    l2 = PORT.MockL2Node(bls_verifier=registry.verifier())
    cs, app, _, bs, ss = make_node(PORT, vs, pvs[0], genesis, l2=l2,
                                   bls_signer=signers[0])
    asyncio.run(run_to([cs], 7, timeout=30))
    batch_points = [h for h in range(1, 8) if bs.load_block(h).is_batch_point()]
    assert batch_points and 1 not in batch_points
    fresh = PORT.batch.BatchCache()
    start_h, _ = PORT.batch.get_batch_start(fresh, 8, 1, genesis.genesis_time_ns, bs)
    assert start_h == max(batch_points)
    assert fresh.blocks_since_last_batch_point[0].header.height == start_h


def test_height_vote_set_grants_catchup_rounds():
    """Votes for a round beyond current+1 are accepted on first arrival,
    up to 2 catch-up rounds per peer; 2/3 at the catch-up round shows."""
    vs, pvs = make_validators(PORT, 4)
    hvs = PORT.HeightVoteSet(CHAIN_ID, 5, vs)
    bid = PORT.BlockID(b"\x11" * 32, PORT.PartSetHeader(1, b"\x22" * 32))

    def vote(i, round_):
        v = PORT.Vote(type=PORT.VoteType.PRECOMMIT, height=5, round=round_,
                      block_id=bid, timestamp_ns=1000 + i,
                      validator_address=pvs[i].get_pub_key().address(),
                      validator_index=i)
        pvs[i].sign_vote(CHAIN_ID, v)
        return v

    assert hvs.add_vote(vote(0, 2), peer_id="peerA", verified=True)
    assert hvs.add_vote(vote(1, 2), peer_id="peerA", verified=True)
    assert hvs.add_vote(vote(0, 4), peer_id="peerA", verified=True)
    with pytest.raises(ValueError):
        hvs.add_vote(vote(0, 6), peer_id="peerA", verified=True)
    assert hvs.add_vote(vote(2, 2), peer_id="peerB", verified=True)
    _, ok = hvs.precommits(2).two_thirds_majority()
    assert ok


# --- the port's own contract ------------------------------------------------


def test_four_validator_net_matches_reference():
    """Legacy commits: the same seeds and clock through both packages give
    equal app hashes and header fields at heights 1-3."""
    assert_parity(parity_net(PORT), parity_net(REF))


def test_default_verifier_is_the_card(monkeypatch):
    """ConsensusState(verifier=None) binds the process verifier, which is
    CUDA: without a card it raises rather than carry on on the CPU."""
    import torch

    monkeypatch.setattr(PORT.bv, "_default", None)
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    if torch.cuda.is_available():
        cs, *_ = make_node(PORT, vs, pvs[0], genesis)
        assert cs.verifier.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            make_node(PORT, vs, pvs[0], genesis)
