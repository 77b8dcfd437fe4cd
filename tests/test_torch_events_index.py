"""The port's event plane against the JAX package: ``libs/pubsub.py``,
``types/event_bus.py``, ``state/txindex.py`` and ``state/sink_sql.py``.

The same seeded 4-validator chain of 6 heights (3 kvstore txs a block from
``MockL2Node``, precommits signed by seeded keys, block times fixed) goes
through each package's ``BlockExecutor``, each with its own ``EventBus``,
``IndexerService`` and ``KVIndexer`` over ``MemKV``. Held equal between the
packages: each subscriber's messages (event maps, block hashes, tx
payloads) for the three queries a joining node's smoke phase subscribes
(every NewBlock, the txs past a height, one kvstore key), the
``TxResult.encode()`` bytes of ``get_tx`` and of ``search_txs`` over
several queries, ``search_blocks``, and the indexer's KV contents byte for
byte. The SQL sink: the contract of ``tests/test_store_state.py:259`` on
both roots, and equal rows from both packages on the chain's events. An
in-process port net with a bus on every node: one NewBlock a height with
the committed hash, and one Vote event for every vote a node added. The
laggard rule: a subscriber past its capacity is cancelled with "out of
capacity" in both packages. Tolerance: exact (bytes, hashes, counts).

The port's process verifier runs on ``device="cpu"`` (the ``cpu_verifier``
fixture of ``tests/test_torch_consensus.py``), the JAX package's on its
host oracle."""

from __future__ import annotations

import asyncio
import importlib
import time
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    PORT,
    REF,
    T0,
    cpu_verifier,
    make_genesis,
    make_validators,
    parity_config,
    wire_net,
)

HEIGHTS = 6
TXS = 3
TX_AFTER = 3  # subscriber (b): the txs of the heights past this one
KEY = "tx-4-1"  # subscriber (c): one kvstore key of the chain
QUERIES = {
    "blocks": "tm.event = 'NewBlock'",
    "late_txs": f"tm.event = 'Tx' AND tx.height > {TX_AFTER}",
    "one_key": f"app.key = '{KEY}'",
}
# the KV indexer's own query form, "type.key=value" (state/txindex.py:126)
TX_SEARCHES = ["app.creator=kvstore", "app.key=tx-1-0", "app.key=tx-5-2",
               f"app.key={KEY}", "app.key=missing", "app.creator=other"]


def events_ns(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, event_bus=m("types.event_bus"), pubsub=m("libs.pubsub"),
        txindex=m("state.txindex"), sink_sql=m("state.sink_sql"),
        tmhash=m("crypto.tmhash"), MemKV=m("store.kv").MemKV,
        VoteSet=m("types.vote_set").VoteSet, sm=m("consensus.state_machine"))


EPORT, EREF = events_ns("tendermint_tpu_torch"), events_ns("tendermint_tpu")


async def wait_until(cond, what: str, limit: float = 10.0) -> None:
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.005)


def drain(sub) -> list:
    out = []
    while not sub.queue.empty():
        out.append(sub.queue.get_nowait())
    return out


def run_chain(ns, ens, heights: int = HEIGHTS) -> dict:
    """Builds the seeded chain through ns's BlockExecutor with an EventBus,
    an IndexerService over a KVIndexer on MemKV, and the three subscribers;
    returns what the parity checks compare."""
    vs, pvs = make_validators(ns, 4, seed=b"events")
    genesis = make_genesis(ns, vs, chain_id="events-chain")
    state = ns.State.from_genesis(genesis)
    state_store = ns.StateStore(ns.MemKV())
    state_store.bootstrap(state)
    bs = ns.BlockStore(ns.MemKV())
    l2 = ns.MockL2Node(txs_per_block=TXS)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}

    async def go(state):
        bus = ens.event_bus.EventBus()
        index_kv = ens.MemKV()
        indexer = ens.txindex.KVIndexer(index_kv)
        service = ens.txindex.IndexerService(indexer, bus)
        subs = {name: bus.subscribe(f"smoke-{name}", ens.pubsub.Query(q))
                for name, q in QUERIES.items()}
        await service.start()
        executor = ns.BlockExecutor(state_store, bs, ns.LocalClient(ns.KVStoreApplication()),
                                    l2, event_bus=bus)
        got = {name: [] for name in subs}
        last_commit, txs = None, []
        for h in range(1, heights + 1):
            t = T0 + h * 10**9
            block = executor.create_proposal_block(
                h, state, last_commit, state.validators.validators[0].address,
                l2.request_block_data(h), t)
            parts = block.make_part_set()
            bid = ns.BlockID(block.hash(), parts.header)
            votes = ens.VoteSet("events-chain", h, 0, ns.VoteType.PRECOMMIT, state.validators)
            for i, v in enumerate(state.validators.validators):
                vote = ns.Vote(type=ns.VoteType.PRECOMMIT, height=h, round=0, block_id=bid,
                               timestamp_ns=t + 1 + i, validator_address=v.address,
                               validator_index=i)
                by_addr[v.address].sign_vote("events-chain", vote)
                votes.add_vote(vote, verified=True)
            commit = votes.make_commit()
            state = await executor.apply_block(state, bid, block)
            bs.save_block(block, parts, commit)
            last_commit = commit
            txs += list(block.data.txs)
            for name, sub in subs.items():
                got[name] += drain(sub)
        hashes = [ens.tmhash.sum(tx) for tx in txs]
        await wait_until(lambda: all(indexer.get_tx(h) is not None for h in hashes)
                         and all(indexer.search_blocks(f"block.height={h}") == [h]
                                 for h in range(1, heights + 1)), "the indexer")
        await service.stop()
        return state, got, indexer, index_kv, txs

    state, got, indexer, index_kv, txs = asyncio.run(go(state))
    msgs = {
        "blocks": [(m.data.hash(), m.data.header.height, m.events) for m in got["blocks"]],
        "late_txs": [(m.data, m.events) for m in got["late_txs"]],
        "one_key": [(m.data, m.events) for m in got["one_key"]],
    }
    return {
        "app_hash": state.app_hash,
        "block_hashes": [bs.load_block(h).hash() for h in range(1, heights + 1)],
        "txs": txs,
        "msgs": msgs,
        "get_tx": [indexer.get_tx(ens.tmhash.sum(tx)).encode() for tx in txs],
        "search_txs": {q: [r.encode() for r in indexer.search_txs(q, limit=1000)]
                       for q in TX_SEARCHES},
        "search_blocks": {h: indexer.search_blocks(f"block.height={h}")
                          for h in range(0, heights + 2)},
        "kv": dict(index_kv._d),
        "results": [indexer.get_tx(ens.tmhash.sum(tx)) for tx in txs],
    }


@pytest.fixture(scope="module")
def chains():
    """Both chains, each package's process verifier on its host (the
    port's on device="cpu", the JAX package's on its host oracle) and no
    default scheduler of either (one another test left installed would
    take the rounds)."""
    from tendermint_tpu.parallel import scheduler as ref_sched
    from tendermint_tpu_torch.parallel import scheduler as port_sched

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PORT.bv, "_default", PORT.bv.BatchVerifier(device="cpu"))
        mp.setattr(REF.bv, "_default", REF.bv.BatchVerifier(min_device_batch=1 << 30))
        mp.setattr(port_sched, "_default_scheduler", None)
        mp.setattr(ref_sched, "_default_scheduler", None)
        return {"port": run_chain(PORT, EPORT), "ref": run_chain(REF, EREF)}


def test_subscribers_see_the_same_messages(chains):
    port, ref = chains["port"], chains["ref"]
    assert port["block_hashes"] == ref["block_hashes"]
    assert port["app_hash"] == ref["app_hash"]
    assert port["msgs"] == ref["msgs"]
    blocks = port["msgs"]["blocks"]
    assert [h for _, h, _ in blocks] == list(range(1, HEIGHTS + 1))
    assert [b for b, _, _ in blocks] == port["block_hashes"]
    late = port["msgs"]["late_txs"]
    assert len(late) == (HEIGHTS - TX_AFTER) * TXS
    assert all(int(ev["tx.height"][0]) > TX_AFTER for _, ev in late)
    ((data, ev),) = port["msgs"]["one_key"]
    assert data[2] == b"tx-4-1=v1" and ev["app.key"] == [KEY] and ev["tx.height"] == ["4"]


def test_indexed_tx_results_and_searches_are_equal(chains):
    port, ref = chains["port"], chains["ref"]
    assert port["get_tx"] == ref["get_tx"]
    assert port["search_txs"] == ref["search_txs"]
    assert port["search_blocks"] == ref["search_blocks"]
    for i, r in enumerate(port["results"]):
        assert (r.height, r.index, r.tx) == (i // TXS + 1, i % TXS, port["txs"][i])
    assert len(port["search_txs"]["app.creator=kvstore"]) == HEIGHTS * TXS
    assert len(port["search_txs"][f"app.key={KEY}"]) == 1
    assert port["search_txs"]["app.key=missing"] == []
    assert port["search_blocks"][0] == [] and port["search_blocks"][HEIGHTS + 1] == []


def test_indexer_kv_contents_are_byte_equal(chains):
    assert chains["port"]["kv"] == chains["ref"]["kv"]
    assert len(chains["port"]["kv"]) == HEIGHTS * TXS * 3 + HEIGHTS


@pytest.mark.parametrize("ens", [EPORT, EREF], ids=["port", "ref"])
def test_sql_event_sink_schema_and_idempotency(ens):
    """The contract of tests/test_store_state.py:259: the relational
    schema with its joined views, idempotent re-indexing, plain-SQL
    queryability, no search API."""
    sink = ens.sink_sql.SQLEventSink(chain_id="sink-chain")
    sink.index_block(5, [("block_header", [("num_txs", "2"), ("proposer", "AA")])])
    sink.index_block(5, [("block_header", [("num_txs", "999")])])  # a no-op

    res = ens.txindex.TxResult(height=5, index=0, tx=b"k=v", code=0, log="", events=[])
    sink.index_tx(res, [("transfer", [("sender", "alice")])])
    sink.index_tx(res, [("transfer", [("sender", "mallory")])])  # a no-op

    cur = sink._conn.cursor()
    cur.execute("SELECT COUNT(*) FROM blocks")
    assert cur.fetchone()[0] == 1
    cur.execute("SELECT height, type, key, value FROM block_events")
    rows = cur.fetchall()
    assert ("5", "block_header", "num_txs", "2") == tuple(str(c) for c in rows[0])
    cur.execute("SELECT key, value, composite_key FROM tx_events")
    assert cur.fetchall() == [("sender", "alice", "transfer.sender")]
    with pytest.raises(NotImplementedError):
        sink.search_txs("q")
    sink.close()


def test_sql_event_sink_rows_are_equal(chains, monkeypatch):
    """Both packages' sinks fed the chain's indexed results (each block's
    height event, each tx's kvstore events) hold the same rows, on a fixed
    clock."""
    monkeypatch.setattr(time, "time_ns", lambda: T0)
    rows = {}
    for name, ens in (("port", EPORT), ("ref", EREF)):
        sink = ens.sink_sql.SQLEventSink(chain_id="events-chain")
        for r in chains[name]["results"]:
            if r.index == 0:
                sink.index_block(r.height, [("block", [("height", str(r.height))])])
            res = ens.txindex.TxResult.decode(r.encode())
            sink.index_tx(res, [(t, sorted(a.items())) for t, a in res.events])
        cur = sink._conn.cursor()
        rows[name] = {}
        for table in ("blocks", "tx_results", "events", "attributes", "block_events",
                      "tx_events"):
            cur.execute(f"SELECT * FROM {table}")
            rows[name][table] = cur.fetchall()
        sink.close()
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]["blocks"]) == HEIGHTS
    assert len(rows["port"]["tx_results"]) == HEIGHTS * TXS
    assert len(rows["port"]["attributes"]) == HEIGHTS * TXS * 2 + HEIGHTS


@pytest.mark.parametrize("ens", [EPORT, EREF], ids=["port", "ref"])
def test_a_subscriber_past_its_capacity_is_cancelled(ens):
    async def run():
        bus = ens.event_bus.EventBus()
        slow = bus.subscribe("slow", ens.event_bus.query_for_event("Tx"), capacity=2)
        fast = bus.subscribe("fast", ens.event_bus.query_for_event("Tx"))
        for h in range(1, 4):
            await bus.publish_tx(h, b"%d" % h, b"tx")
        with pytest.raises(ens.pubsub.SubscriptionCancelled, match="out of capacity"):
            await slow.next()
        assert bus.num_client_subscriptions("slow") == 0
        assert [(await fast.next()).data[0] for _ in range(3)] == [1, 2, 3]
        assert bus.num_clients() == 1

    asyncio.run(run())


def test_port_net_publishes_blocks_and_every_added_vote():
    """A 4-validator in-process port net, an EventBus on every node (its
    ConsensusState and its BlockExecutor): each node receives one NewBlock
    a height, in order, with the hash its store committed, and one Vote
    event for every vote it added, in the order it added them."""
    ns = PORT
    vs, pvs = make_validators(ns, 4, seed=b"events-net")
    genesis = make_genesis(ns, vs)
    config = parity_config(ns)
    target = 3

    async def run():
        nodes = []
        for pv in pvs:
            bus = EPORT.event_bus.EventBus()
            state = ns.State.from_genesis(genesis)
            state_store = ns.StateStore(ns.MemKV())
            state_store.bootstrap(state)
            bs = ns.BlockStore(ns.MemKV())
            l2 = ns.MockL2Node()
            executor = ns.BlockExecutor(state_store, bs, ns.LocalClient(ns.KVStoreApplication()),
                                        l2, event_bus=bus)
            cs = ns.ConsensusState(config, state, executor, bs, l2, priv_validator=pv,
                                   event_bus=bus)
            added = []
            cs.event_switch.add_listener("test", EPORT.sm.EVENT_VOTE, added.append)
            subs = {"block": bus.subscribe("t", EPORT.event_bus.query_for_event("NewBlock")),
                    "vote": bus.subscribe("t", EPORT.event_bus.query_for_event("Vote"))}
            nodes.append(SimpleNamespace(cs=cs, bs=bs, subs=subs, added=added,
                                         got={"block": [], "vote": []}))
        css = [n.cs for n in nodes]
        wire_net(css)

        async def pump():
            while True:
                for n in nodes:
                    for k, sub in n.subs.items():
                        n.got[k] += drain(sub)
                await asyncio.sleep(0.01)

        pumper = asyncio.create_task(pump())
        for cs in css:
            await cs.start()
        try:
            await asyncio.gather(*(cs.wait_for_height(target + 1, timeout=60) for cs in css))
        finally:
            for cs in css:
                await cs.stop()
            pumper.cancel()
        for n in nodes:
            for k, sub in n.subs.items():
                n.got[k] += drain(sub)
        return nodes

    nodes = asyncio.run(run())
    for n in nodes:
        heights = [m.data.header.height for m in n.got["block"]]
        assert heights == list(range(1, n.bs.height + 1)), heights
        assert n.bs.height >= target
        assert [m.data.hash() for m in n.got["block"]] == [
            n.bs.load_block(h).hash() for h in heights]
        assert all(m.events["block.height"] == [str(m.data.header.height)]
                   for m in n.got["block"])
        assert [m.data for m in n.got["vote"]] == n.added
        assert all(m is v for m, v in zip((m.data for m in n.got["vote"]), n.added))
        assert len(n.added) >= 2 * len(nodes) * target  # a prevote and a precommit each
    for h in range(1, target + 1):
        assert len({n.bs.load_block(h).hash() for n in nodes}) == 1, h
