"""The port's light client (``light/{client,verifier,store,types}.py``)
against the contract of ``tests/test_light.py``: skipping verification to
a distant header, sequential verification, an expired trusting period,
backwards verification, the detector's attack evidence against a forked
primary, a witness that disagrees at the trust root, a bad witness removed,
the primary replaced when it lacks a block, store pruning and a restart
from the store. Beside them, parity: the same seeded chains (a static set,
a set that rotates one validator every 5 heights so skipping has to
bisect, a forked primary, a tampered commit) go through the JAX package's
``LightClient`` and the port's: the same verdicts, the same trusted
heights in the same order, the same requests to the primary and the same
attack evidence bytes.

The port verifies on its process verifier on ``device="cpu"``
(``cpu_verifier``; a 4-row commit stays under ``min_device_batch``, on the
host oracle); the JAX package on a verifier of that package whose
``min_device_batch`` no round reaches. Tolerance: exact (verdicts, heights,
bytes).
"""

from __future__ import annotations

import asyncio
import copy
import importlib
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    PORT,
    REF,
    cpu_verifier,
)

CHAIN_ID = "light-chain"
T0 = 1_700_000_000 * 1_000_000_000
BLOCK_NS = 1_000_000_000  # 1 s blocks
PERIOD = 3600 * 1_000_000_000  # 1 h trusting period


def light_ns(root: str) -> SimpleNamespace:
    """The light client's classes and the chain types of one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    client = m("light.client")
    return SimpleNamespace(
        root=root,
        LightBlock=m("light.types").LightBlock,
        LightClient=client.LightClient,
        TrustOptions=client.TrustOptions,
        LightClientError=client.LightClientError,
        ErrLightClientAttack=client.ErrLightClientAttack,
        LightStore=m("light.store").LightStore,
        MemKV=m("store.kv").MemKV,
        Header=m("types.block").Header,
        BlockID=m("types.block_id").BlockID,
        PartSetHeader=m("types.part_set").PartSetHeader,
        Validator=m("types.validator").Validator,
        ValidatorSet=m("types.validator_set").ValidatorSet,
        MockPV=m("types.priv_validator").MockPV,
        Vote=m("types.vote").Vote,
        VoteType=m("types.vote").VoteType,
        VoteSet=m("types.vote_set").VoteSet,
    )


LP = light_ns(PORT.root)
LR = light_ns(REF.root)


@pytest.fixture
def ref_host_verifier(monkeypatch):
    """The JAX package's process verifier on its host oracle, and no
    default scheduler of that package (one another test left installed
    would take the rounds)."""
    from tendermint_tpu.parallel import scheduler

    v = REF.bv.BatchVerifier(min_device_batch=1 << 30)
    monkeypatch.setattr(REF.bv, "_default", v)
    monkeypatch.setattr(scheduler, "_default_scheduler", None)
    return v


def make_chain(n, n_vals=4, seed=b"light", fork_at=None, fork_seed=b"fork",
               rotate_every=0, ns=LP):
    """n LightBlocks of package `ns`; from height `fork_at` on a forked app
    hash (so other header hashes). With `rotate_every`, the set at height h
    is n_vals consecutive validators of a pool, starting at
    h // rotate_every: one validator leaves and one joins every
    rotate_every heights."""
    pool = [ns.MockPV.from_secret(seed + b"%d" % i)
            for i in range(n_vals + (n // rotate_every + 1 if rotate_every else 0))]

    def vset(h):
        first = h // rotate_every if rotate_every else 0
        pvs = pool[first:first + n_vals]
        vs = ns.ValidatorSet([ns.Validator(pv.get_pub_key(), 10) for pv in pvs])
        by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
        return vs, [by_addr[v.address] for v in vs.validators]

    blocks = []
    last_id = ns.BlockID()
    for h in range(1, n + 1):
        vs, ordered = vset(h)
        forked = fork_at is not None and h >= fork_at
        header = ns.Header(
            chain_id=CHAIN_ID,
            height=h,
            time_ns=T0 + h * BLOCK_NS,
            last_block_id=last_id,
            validators_hash=vs.hash(),
            next_validators_hash=vset(h + 1)[0].hash(),
            app_hash=(fork_seed if forked else b"app") + b"-%d" % h,
            proposer_address=vs.validators[0].address,
        )
        bid = ns.BlockID(header.hash(), part_set_header=ns.PartSetHeader(1, header.hash()))
        votes = ns.VoteSet(CHAIN_ID, h, 0, ns.VoteType.PRECOMMIT, vs)
        for i, pv in enumerate(ordered):
            v = ns.Vote(type=ns.VoteType.PRECOMMIT, height=h, round=0, block_id=bid,
                        timestamp_ns=header.time_ns,
                        validator_address=pv.get_pub_key().address(), validator_index=i)
            pv.sign_vote(CHAIN_ID, v)
            votes.add_vote(v, verified=True)
        blocks.append(ns.LightBlock(header, votes.make_commit(), vs))
        last_id = bid
    return blocks


class MockProvider:
    def __init__(self, blocks, name="primary", fail_heights=()):
        self.blocks = {b.height: b for b in blocks}
        self.name = name
        self.fail_heights = set(fail_heights)
        self.requests = []

    async def light_block(self, height):
        if height == 0:
            height = max(self.blocks)
        self.requests.append(height)
        if height in self.fail_heights:
            return None
        return self.blocks.get(height)

    def id(self):
        return self.name


def make_client(chain, *, witnesses=None, store=None, now=None, ns=LP, **kw):
    primary = MockProvider(chain)
    witnesses = witnesses if witnesses is not None else [
        MockProvider(chain, name="witness-0")
    ]
    store = store or ns.LightStore(ns.MemKV())
    trust = ns.TrustOptions(PERIOD, 1, chain[0].header.hash())
    return ns.LightClient(
        CHAIN_ID, trust, primary, witnesses, store,
        now_ns=now or (lambda: T0 + 200 * BLOCK_NS), **kw,
    )


# --- the contract of tests/test_light.py ----------------------------------------


def test_bisection_verifies_distant_header():
    chain = make_chain(100)
    c = make_client(chain)
    lb = asyncio.run(c.verify_light_block_at_height(100))
    assert lb.height == 100
    # a static set jumps straight to the target: no fetch of every height
    assert len(c.primary.requests) < 20
    assert c.last_trusted_height() == 100


def test_sequential_verifies_every_header():
    chain = make_chain(10)
    c = make_client(chain, sequential=True)
    lb = asyncio.run(c.verify_light_block_at_height(10))
    assert lb.height == 10
    assert len([h for h in c.primary.requests if h <= 10]) >= 9


def test_expired_trusting_period_rejected():
    chain = make_chain(10)
    c = make_client(chain, now=lambda: T0 + PERIOD + 1000 * BLOCK_NS)
    with pytest.raises((LP.LightClientError, Exception)):
        asyncio.run(c.verify_light_block_at_height(10))


def test_backwards_verification():
    chain = make_chain(50)
    c = make_client(chain)
    asyncio.run(c.verify_light_block_at_height(50))
    lb = asyncio.run(c.verify_light_block_at_height(20))
    assert lb.height == 20
    assert c.store.get(20) is not None  # the hash chain walked down from 50


def test_detector_catches_forked_primary():
    """The primary serves a forked chain and the honest witness diverges:
    the client detects the fork and surfaces attack evidence carrying the
    primary's forked block."""
    honest = make_chain(40)
    forked = make_chain(40, fork_at=21)
    c = LP.LightClient(
        CHAIN_ID,
        LP.TrustOptions(PERIOD, 1, honest[0].header.hash()),
        MockProvider(forked, name="byzantine-primary"),
        [MockProvider(honest, name="honest-witness")],
        LP.LightStore(LP.MemKV()),
        now_ns=lambda: T0 + 200 * BLOCK_NS,
    )
    with pytest.raises(LP.ErrLightClientAttack) as ei:
        asyncio.run(c.verify_light_block_at_height(40))
    ev = ei.value.evidence
    assert ev.common_height <= 20
    assert ev.total_voting_power == 40
    conflicting = LP.Header.decode(ev.conflicting_header)
    assert conflicting.hash() != honest[conflicting.height - 1].header.hash()
    assert conflicting.hash() == forked[conflicting.height - 1].header.hash()


def test_conflicting_witness_at_trust_root_is_hard_error():
    chain = make_chain(30)
    garbage = make_chain(30, seed=b"other")  # another chain entirely
    c = make_client(chain, witnesses=[MockProvider(garbage, name="bad-witness")])
    with pytest.raises(LP.LightClientError, match="trust root"):
        asyncio.run(c.verify_light_block_at_height(30))


def test_bad_witness_removed_good_witness_matches():
    """A witness serving an unverifiable conflicting block is removed; the
    good witness cross-references."""
    chain = make_chain(30)
    bad_chain = list(chain)
    tampered = copy.deepcopy(chain[29])
    tampered.header.app_hash = b"tampered"
    tampered.header._hash = None  # the cached header hash no longer holds
    bad_chain[29] = tampered
    c = make_client(chain, witnesses=[
        MockProvider(bad_chain, name="bad-witness"),
        MockProvider(chain, name="good-witness"),
    ])
    lb = asyncio.run(c.verify_light_block_at_height(30))
    assert lb.height == 30
    assert [w.id() for w in c.witnesses] == ["good-witness"]


def test_primary_replaced_when_missing_blocks():
    chain = make_chain(30)
    c = LP.LightClient(
        CHAIN_ID,
        LP.TrustOptions(PERIOD, 1, chain[0].header.hash()),
        MockProvider(chain, fail_heights={30}),
        [MockProvider(chain, name="witness-0"), MockProvider(chain, name="witness-1")],
        LP.LightStore(LP.MemKV()),
        now_ns=lambda: T0 + 200 * BLOCK_NS,
    )
    lb = asyncio.run(c.verify_light_block_at_height(30))
    assert lb.height == 30
    assert c.primary.id() == "witness-0"
    assert "primary" in [w.id() for w in c.witnesses]  # demoted, now a witness


def test_store_pruning_bounds_size():
    chain = make_chain(60)
    c = make_client(chain, pruning_size=5, sequential=True)
    asyncio.run(c.verify_light_block_at_height(60))
    assert len(c.store.heights()) <= 5
    assert c.last_trusted_height() == 60


def test_restart_resumes_from_store():
    chain = make_chain(20)
    kv = LP.MemKV()
    c1 = make_client(chain, store=LP.LightStore(kv))
    asyncio.run(c1.verify_light_block_at_height(20))
    c2 = LP.LightClient(
        CHAIN_ID, None, MockProvider(chain), [MockProvider(chain, name="w")],
        LP.LightStore(kv), trusting_period_ns=PERIOD,
        now_ns=lambda: T0 + 200 * BLOCK_NS,
    )
    lb = asyncio.run(c2.initialize())
    assert lb.height == 20


# --- parity with the JAX package ----------------------------------------------------


def _run(ns, chain, target, **kw):
    """(outcome, trusted heights, primary requests) of one client of
    package `ns` verifying to `target`: outcome "ok", or the error's type
    name and message."""
    c = make_client(chain, ns=ns, **kw)
    try:
        asyncio.run(c.verify_light_block_at_height(target))
        outcome = "ok"
    except Exception as e:  # both packages' errors compared by name
        outcome = (type(e).__name__, str(e))
    return outcome, c.store.heights(), list(c.primary.requests)


def _tamper(ns, lb):
    """lb with the signatures of 2 of its 4 validators (half the power)
    flipped in one bit."""
    bad = copy.deepcopy(lb)
    for i in (0, 1):
        sig = bad.commit.signatures[i].signature
        bad.commit.signatures[i].signature = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
    return bad


@pytest.mark.parametrize("sequential", [False, True], ids=["skipping", "sequential"])
def test_same_chain_same_verdicts_and_trusted_heights(sequential, ref_host_verifier):
    """A rotating 60-height chain (one validator out and one in every 5
    heights, so a 1/3-trust jump fails past 10 heights and skipping
    bisects) and a static one: both packages build the same headers,
    accept alike, trust the same heights in the same order and ask the
    primary for the same heights. Then the same chain with one commit
    tampered (half the power's signatures flipped, at the first height
    the client trusted past the root): both reject it with the same error
    and trust the same heights."""
    kw = {"sequential": sequential}
    for args in ({"rotate_every": 5}, {}):
        chains = {ns.root: make_chain(60, ns=ns, **args) for ns in (LP, LR)}
        assert ([b.header.hash() for b in chains[LP.root]]
                == [b.header.hash() for b in chains[LR.root]])
        got = {ns.root: _run(ns, chains[ns.root], 60, **kw) for ns in (LP, LR)}
        assert got[LP.root] == got[LR.root], args
        outcome, heights, requests = got[LP.root]
        assert outcome == "ok" and heights[-1] == 60
        if sequential:
            assert heights == list(range(1, 61))
        elif args:
            assert 2 < len(heights) < 30, heights  # bisected, not every height
        else:
            assert heights == [1, 60]
        bad_h = heights[1]
        tampered = {ns.root: [_tamper(ns, b) if b.height == bad_h else b
                              for b in chains[ns.root]] for ns in (LP, LR)}
        got = {ns.root: _run(ns, tampered[ns.root], 60, **kw) for ns in (LP, LR)}
        assert got[LP.root] == got[LR.root], args
        outcome, heights, _ = got[LP.root]
        assert outcome != "ok" and "invalid commit" in outcome[1], outcome
        assert bad_h not in heights and 60 not in heights, heights


def test_same_forked_primary_same_evidence(ref_host_verifier):
    """The detector: the same forked primary and honest witness give both
    packages ErrLightClientAttack with byte-identical evidence."""
    ev = {}
    for ns in (LP, LR):
        honest = make_chain(40, ns=ns)
        forked = make_chain(40, ns=ns, fork_at=21)
        c = ns.LightClient(
            CHAIN_ID, ns.TrustOptions(PERIOD, 1, honest[0].header.hash()),
            MockProvider(forked, name="byzantine-primary"),
            [MockProvider(honest, name="honest-witness")],
            ns.LightStore(ns.MemKV()), now_ns=lambda: T0 + 200 * BLOCK_NS,
        )
        with pytest.raises(ns.ErrLightClientAttack) as ei:
            asyncio.run(c.verify_light_block_at_height(40))
        e = ei.value.evidence
        ev[ns.root] = (e.conflicting_header, e.conflicting_commit,
                       e.conflicting_validators, e.common_height,
                       e.total_voting_power, e.timestamp_ns, c.store.heights())
    assert ev[LP.root] == ev[LR.root]
