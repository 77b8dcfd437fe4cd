"""The port's blocksync (``blocksync/{pool,reactor}.py``) against the
contract of ``tests/test_blocksync.py``: pool requests and windows, peer
punishment on a redo, the flowrate ban of a slow peer, a healthy peer left
alone, ``verify_commits_light`` over many heights with one bad commit, a
fresh node fast-syncing over encrypted p2p and handing off, and a tampered
block punishing its peer. Beside them:

- the wire: a port client blocksyncs from a JAX-package server over p2p,
  and a JAX-package client from a port server; every synced block hash and
  the app hash after it equal the source chain's;
- the tier: a window of ``VERIFY_WINDOW`` commits whose rows reach
  ``BIGTABLE_MIN`` goes to the big tier (the plain versions of kernels 5
  and 6 run, kernel 3's does not), counted by a monkeypatch on the plain
  versions.

The port verifies on its process verifier on ``device="cpu"``
(``cpu_verifier``); the JAX package's client on a verifier of that package
whose ``min_device_batch`` no round reaches (its host oracle). The source
chains of the wire and tier tests are built through each package's own
``BlockExecutor`` on a fixed clock (``build_chain``): proposal blocks with
the mock L2 node's transactions, every precommit signed into a
``VoteSet``, ``make_commit()``, ``apply_block`` and ``save_block``.
Tolerance: exact (hashes).
"""

from __future__ import annotations

import asyncio
import copy
import importlib
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu_torch.blocksync import pool as pool_mod
from tendermint_tpu_torch.blocksync.pool import BlockPool
from tendermint_tpu_torch.blocksync.reactor import BlocksyncReactor
from tendermint_tpu_torch.libs.flowrate import Monitor

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    CHAIN_ID,
    PORT,
    REF,
    T0,
    cpu_verifier,
    make_genesis,
    make_node,
    make_validators,
)

NETWORK = "bsync-chain"


def ns_extra(root: str) -> SimpleNamespace:
    """The blocksync and p2p classes of one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root,
        BlocksyncReactor=m("blocksync.reactor").BlocksyncReactor,
        VoteSet=m("types.vote_set").VoteSet,
        NodeKey=m("p2p.key").NodeKey,
        NodeInfo=m("p2p.node_info").NodeInfo,
        Switch=m("p2p.switch").Switch,
        MultiplexTransport=m("p2p.transport").MultiplexTransport,
        NetAddress=m("p2p.transport").NetAddress,
    )


EXTRA = {ns.root: ns_extra(ns.root) for ns in (PORT, REF)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions are thousands of small tensor operations, which
    several threads per worker only slow down on a loaded host."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# --- chains, stores and switches ------------------------------------------------


def sign_commit(ns, vs, pvs, height, block_id, time_ns=T0):
    """All validators precommit block_id at round 0; returns the Commit."""
    votes = EXTRA[ns.root].VoteSet(CHAIN_ID, height, 0, ns.VoteType.PRECOMMIT, vs)
    for i, pv in enumerate(pvs):
        v = ns.Vote(type=ns.VoteType.PRECOMMIT, height=height, round=0,
                    block_id=block_id, timestamp_ns=time_ns + i,
                    validator_address=pv.get_pub_key().address(), validator_index=i)
        pv.sign_vote(CHAIN_ID, v)
        votes.add_vote(v, verified=True)
    return votes.make_commit()


def build_chain(ns, n_vals: int, heights: int, seed: bytes = b"bsync", txs: int = 3):
    """A chain of `heights` blocks of package `ns` on a fixed clock: each
    height a proposal block through the BlockExecutor with `txs` kvstore
    transactions of the mock L2 node, precommits of every validator into a
    VoteSet, make_commit(), save_block and apply_block. Returns the set,
    its privvals, the genesis, the block store's KV and store, and the
    final state."""
    vs, pvs = make_validators(ns, n_vals, seed=seed)
    genesis = make_genesis(ns, vs)
    l2 = ns.MockL2Node(txs_per_block=txs)
    state = ns.State.from_genesis(genesis)
    state_store = ns.StateStore(ns.MemKV())
    state_store.bootstrap(state)
    kv = ns.MemKV()
    bs = ns.BlockStore(kv)
    executor = ns.BlockExecutor(state_store, bs, ns.LocalClient(ns.KVStoreApplication()), l2)

    async def go(state):
        last_commit = None
        for h in range(1, heights + 1):
            t = T0 + h * 10**9
            block = executor.create_proposal_block(
                h, state, last_commit, state.validators.validators[0].address,
                l2.request_block_data(h), t)
            parts = block.make_part_set()
            bid = ns.BlockID(block.hash(), parts.header)
            commit = sign_commit(ns, state.validators, pvs, h, bid, time_ns=t + 1)
            bs.save_block(block, parts, commit)
            state = await executor.apply_block(state, bid, block)
            last_commit = commit
        return state

    state = asyncio.run(go(state))
    return SimpleNamespace(vs=vs, pvs=pvs, genesis=genesis, kv=kv, bs=bs, state=state)


def copy_store(ns, kv):
    """A BlockStore over a copy of `kv`."""
    dup = ns.MemKV()
    dup._d = dict(kv._d)
    return ns.BlockStore(dup)


def build_switch(ns, reactors):
    """(node key, transport, switch) of package `ns` with `reactors`."""
    net = EXTRA[ns.root]
    nk = net.NodeKey.generate()
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
    for name, r in reactors.items():
        sw.add_reactor(name, r)
    return nk, transport, sw


async def sync_over_p2p(srv_ns, srv_chain, src_store, cli_ns, cli_chain, timeout=60.0):
    """A server of package srv_ns over `src_store` (inactive pool) and a
    fresh client node of package cli_ns syncing from genesis over p2p;
    each chain argument is that package's (validator set, privvals,
    genesis). Returns (client block store, reactor, heights at which
    on_caught_up fired)."""
    vs, pvs, genesis = srv_chain
    srv_cs, _, srv_l2, _, _ = make_node(srv_ns, vs, pvs[0], genesis)
    server_r = EXTRA[srv_ns.root].BlocksyncReactor(
        srv_cs.state, srv_cs.executor, src_store, srv_l2, active=False)
    snk, st, ssw = build_switch(srv_ns, {"blocksync": server_r})

    vs, pvs, genesis = cli_chain
    cli_cs, _, cli_l2, cli_bs, _ = make_node(cli_ns, vs, pvs[0], genesis)
    caught_up = []

    async def on_caught_up(state):
        caught_up.append(state.last_block_height)

    client_r = EXTRA[cli_ns.root].BlocksyncReactor(
        cli_cs.state, cli_cs.executor, cli_bs, cli_l2,
        on_caught_up=on_caught_up, active=False)
    cnk, ct, csw = build_switch(cli_ns, {"blocksync": client_r})
    for t, sw in ((st, ssw), (ct, csw)):
        await t.listen()
        await sw.start()
    await csw.dial_peer(EXTRA[cli_ns.root].NetAddress(snk.id, "127.0.0.1", st.listen_port))
    await asyncio.sleep(0.2)
    client_r.start_sync()
    deadline = time.monotonic() + timeout
    while not caught_up and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
    for sw in (ssw, csw):
        await sw.stop()
    return cli_bs, client_r, caught_up


# --- the contract of tests/test_blocksync.py: the pool --------------------


def _fake_block(h):
    class B:
        def __init__(self, height):
            self.header = type("H", (), {"height": height})()
            self.last_commit = object()  # non-None for window pairing

    return B(h)


def test_pool_requests_and_windows():
    sent = []
    pool = BlockPool(
        start_height=1,
        send_request=lambda pid, h: sent.append((pid, h)) or True,
        on_peer_error=lambda pid, reason: None,
    )
    pool.set_peer_range("p1", 0, 10)
    pool.make_requests()
    assert sent, "no requests made"
    for h in range(1, 6):
        pool.add_block("p1", _fake_block(h))
    # each block needs its successor present; entries are (block,
    # successor_commit, successor_qc), the qc None on legacy blocks
    w = pool.peek_window(10)
    assert [b.header.height for b, _c, _qc in w] == [1, 2, 3, 4]
    assert all(qc is None for _b, _c, qc in w)
    pool.pop_request()
    w = pool.peek_window(2)
    assert [b.header.height for b, _c, _qc in w] == [2, 3]


def test_pool_redo_punishes_peer():
    errors = []
    pool = BlockPool(
        start_height=1,
        send_request=lambda pid, h: True,
        on_peer_error=lambda pid, reason: errors.append(pid),
    )
    pool.set_peer_range("bad", 0, 5)
    pool.make_requests()
    pool.add_block("bad", _fake_block(1))
    pool.add_block("bad", _fake_block(2))
    pool.redo_request(1, "bad block")
    assert "bad" in errors


def test_slow_peer_banned_sync_completes_via_fast_peer():
    """A slow-but-alive peer trickling below MIN_RECV_RATE is banned, and
    its heights go to a healthy peer, so the sync completes."""
    sent = []
    errors = []
    pool = BlockPool(
        start_height=1,
        send_request=lambda pid, h: sent.append((pid, h)) or True,
        on_peer_error=lambda pid, reason: errors.append((pid, reason)),
    )
    pool.set_peer_range("slow", 0, 6)
    pool.make_requests()
    assert all(pid == "slow" for pid, _ in sent)

    slow = pool._peers["slow"]
    assert slow.recv_monitor._sample == pool_mod.RATE_SAMPLE == 1.0
    assert slow.recv_monitor._window == pool_mod.RATE_WINDOW == 40.0
    slow.recv_monitor = Monitor(sample_period=0.02, window=0.1)

    pool.add_block("slow", _fake_block(1), size=64)
    for _ in range(6):
        time.sleep(0.03)
        slow.recv_monitor.update(8)
    rate = slow.recv_monitor.status().cur_rate
    assert 0.0 < rate < pool_mod.MIN_RECV_RATE

    pool.set_peer_range("fast", 0, 6)
    sent.clear()
    pool.make_requests()  # the rate check runs here
    assert ("slow", "peer is not sending us data fast enough") in errors
    assert "slow" not in pool._peers, "slow peer still in the pool"
    assert sent and all(pid == "fast" for pid, _ in sent)
    for h in range(2, 7):
        pool.add_block("fast", _fake_block(h), size=4096)
    w = pool.peek_window(10)
    assert [b.header.height for b, _c, _qc in w] == [1, 2, 3, 4, 5]
    assert "fast" in {p.peer_id for p in pool._peers.values()}


def test_fast_peer_not_banned_by_rate_check():
    """A peer at a healthy rate passes check_peer_rates; a peer that never
    sent anything is left to the timeout path."""
    errors = []
    pool = BlockPool(
        start_height=1,
        send_request=lambda pid, h: True,
        on_peer_error=lambda pid, reason: errors.append(pid),
    )
    pool.set_peer_range("fast", 0, 6)
    pool.make_requests()
    fast = pool._peers["fast"]
    assert fast.pending, "no heights assigned to the fast peer"
    pool.set_peer_range("silent", 0, 6)
    for h in range(1, 4):
        assert pool.add_block("fast", _fake_block(h), size=1 << 20)
    assert fast.recv_monitor.status().bytes_total >= 3 << 20
    pool.check_peer_rates()
    assert errors == []
    assert "fast" in pool._peers and "silent" in pool._peers


# --- batched multi-commit verification --------------------------------------


def test_verify_commits_light_batches_many_heights():
    """One batch covers many commits; the invalid one is flagged alone."""
    vs, pvs = make_validators(PORT, 4)
    entries = []
    for h in range(1, 9):
        bid = PORT.BlockID(bytes([h]) * 32, PORT.PartSetHeader(1, bytes([h]) * 32))
        entries.append((bid, h, sign_commit(PORT, vs, pvs, h, bid)))
    bad = entries[4][2]
    for i in range(3):
        bad.signatures[i].signature = b"\x00" * 64

    verifier = PORT.bv.BatchVerifier(device="cpu", min_device_batch=1 << 30)  # host path
    verdicts = vs.verify_commits_light(CHAIN_ID, entries, verifier=verifier)
    assert verdicts == [True] * 4 + [False] + [True] * 3


# --- fast sync over p2p --------------------------------------------------------


def _build_source_chain(n_heights):
    """A single-validator chain run to height n in process; what a syncing
    node needs."""
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)

    async def run():
        cs, app, l2, bs, ss = make_node(PORT, vs, pvs[0], genesis)
        await cs.start()
        await cs.wait_for_height(n_heights, timeout=60)
        await cs.stop()
        return bs

    return vs, pvs, genesis, asyncio.run(run())


def test_fast_sync_over_p2p_catches_up():
    """A fresh node blocksyncs an 8-height chain from a serving peer and
    hands off to consensus."""
    vs, pvs, genesis, src_bs = _build_source_chain(8)
    chain = (vs, pvs, genesis)
    cli_bs, client_r, caught_up = asyncio.run(
        sync_over_p2p(PORT, chain, src_bs, PORT, chain))
    # blocks 1..7 apply (8 needs its successor's commit, which arrives
    # through consensus after the hand-off)
    assert cli_bs.height >= 7, f"client only reached height {cli_bs.height}"
    assert client_r.blocks_applied >= 7
    assert caught_up, "on_caught_up never fired"


def test_fast_sync_rejects_tampered_block():
    """A peer serving a tampered block is punished and the height is
    requested again."""
    vs, pvs, genesis, src_bs = _build_source_chain(5)

    async def run():
        cli_cs, _, cli_l2, cli_bs, _ = make_node(PORT, vs, pvs[0], genesis)
        reactor = BlocksyncReactor(cli_cs.state, cli_cs.executor, cli_bs, cli_l2,
                                   active=False)
        errors = []
        reactor.pool._on_peer_error = lambda pid, reason: errors.append(pid)
        reactor.pool.set_peer_range("evil", 0, 5)
        reactor.pool.make_requests()
        b1 = copy.deepcopy(src_bs.load_block(1))
        b1.data.txs = [b"forged=1"]
        b1.data._hash = None
        b1.header._hash = None  # content changed, so the hash changes
        reactor.pool.add_block("evil", b1)
        reactor.pool.add_block("evil", src_bs.load_block(2))
        await reactor._process_ready_blocks()
        return errors, cli_bs.height

    errors, h = asyncio.run(run())
    assert "evil" in errors, "tampered block did not punish the peer"
    assert h == 0, "tampered block was applied"


# --- the port's own contract -----------------------------------------------------


@pytest.mark.parametrize("server,client", [(REF, PORT), (PORT, REF)],
                         ids=["ref-server-port-client", "port-server-ref-client"])
def test_mixed_package_sync_over_p2p(server, client, ref_host_verifier):
    """A client of one package blocksyncs a 4-validator, 12-height chain
    built by the other package's BlockExecutor over p2p: the two packages
    speak the same blocksync wire, and the client's blocks and the app
    hashes after them equal the source's. Each applied block h + 1 passes
    the client's own check of its header's app hash (the source's after h)
    against the client's app after h; the last is compared here."""
    heights = 12
    src = build_chain(server, 4, heights)
    cli_vs, cli_pvs = make_validators(client, 4, seed=b"bsync")
    assert cli_vs.hash() == src.vs.hash()
    cli_bs, client_r, caught_up = asyncio.run(sync_over_p2p(
        server, (src.vs, src.pvs, src.genesis), copy_store(server, src.kv),
        client, (cli_vs, cli_pvs, make_genesis(client, cli_vs))))
    assert caught_up == [heights - 1], caught_up
    assert cli_bs.height == heights - 1 and client_r.blocks_applied == heights - 1
    for h in range(1, heights):
        assert cli_bs.load_block(h).hash() == src.bs.load_block(h).hash(), h
    # the header of h + 1 carries the app hash after h
    assert client_r.state.last_block_height == heights - 1
    assert client_r.state.app_hash == src.bs.load_block(heights).header.app_hash


def test_window_of_bigtable_min_rows_dispatches_to_the_big_tier(monkeypatch):
    """The reactor's window as the pool serves it: REQUEST_WINDOW (40)
    heights in flight, so at most 39 blocks with their successors, under
    VERIFY_WINDOW (64). At 14 validators it is 546 rows, past BIGTABLE_MIN:
    its one verify round builds the big tables (neg_pubkey_bigtable) and
    runs verify_prehashed_bigcache, never kernel 3's plain version. Rounds
    of one commit (14 rows, the applied blocks' LastCommit checks) stay
    under min_device_batch, on the host oracle. The plain versions are
    counted by a monkeypatch."""
    from tendermint_tpu_torch.crypto.batch_verifier import BIGTABLE_MIN
    from tendermint_tpu_torch.ops import ed25519_batch as ed

    n_vals = 14
    window = min(BlocksyncReactor.VERIFY_WINDOW, pool_mod.REQUEST_WINDOW - 1)
    assert n_vals * window >= BIGTABLE_MIN
    verifier = PORT.bv.BatchVerifier(device="cpu", min_device_batch=n_vals + 1)
    monkeypatch.setattr(PORT.bv, "_default", verifier)
    src = build_chain(PORT, n_vals, window + 1, seed=b"bigtier", txs=1)
    calls = {"bigtable": [], "bigcache": [], "table": []}

    def counting(key, fn):
        def wrapped(*args):
            calls[key].append(int(args[0].shape[0]) if key == "bigtable"
                              else int(args[2].shape[0]))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ed, "neg_pubkey_bigtable_plain",
                        counting("bigtable", ed.neg_pubkey_bigtable_plain))
    monkeypatch.setattr(ed, "verify_prehashed_bigcache_plain",
                        counting("bigcache", ed.verify_prehashed_bigcache_plain))
    monkeypatch.setattr(ed, "verify_prehashed_table_plain",
                        counting("table", ed.verify_prehashed_table_plain))

    async def run():
        cs, _, l2, bs, _ = make_node(PORT, src.vs, src.pvs[0], src.genesis)
        reactor = BlocksyncReactor(cs.state, cs.executor, bs, l2, active=False)
        errors = []
        reactor.pool._on_peer_error = lambda pid, reason: errors.append(pid)
        reactor.pool.set_peer_range("peer", 0, window + 1)
        reactor.pool.make_requests()
        for h in range(1, window + 2):
            assert reactor.pool.add_block("peer", src.bs.load_block(h)), h
        got = len(reactor.pool.peek_window(BlocksyncReactor.VERIFY_WINDOW))
        await reactor._process_ready_blocks()
        return reactor, bs, errors, got

    reactor, bs, errors, got = asyncio.run(run())
    assert got == window
    assert not errors
    assert bs.height == window and reactor.blocks_applied == window
    for h in range(1, window + 1):
        assert bs.load_block(h).hash() == src.bs.load_block(h).hash()
    assert reactor.state.app_hash == src.bs.load_block(window + 1).header.app_hash
    bucket = verifier._registry.bucket_for(n_vals * window)
    assert sum(calls["bigtable"]) >= n_vals, calls
    assert calls["bigcache"] == [bucket], calls
    assert calls["table"] == [], calls
    assert verifier._registry.buckets_by_tier().get("big") == (bucket,)
