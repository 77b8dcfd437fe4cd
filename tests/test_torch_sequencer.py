"""The port's sequencer plane (``sequencer/``) against the contract of
``tests/test_sequencer.py``: the caches, BlockV2 signing and recovery,
StateV2 production, gossip to a follower over encrypted p2p, a rogue
signer refused, the sync-gap catch-up, the BFT -> sequencer upgrade,
out-of-order blocks through the pending cache, event-driven apply and
windowed catch-up, request expiry, encode-once fan-out, backpressure, and a
burst of signer checks coalesced into few scheduler rounds. Beside them:

- BlockV2 parity: the same seeded key and block signed by both packages
  give equal bytes, hash and recovered address;
- a follower's ``SequencerVerifyBatcher`` recovers through a port
  ``RemoteVerifyScheduler`` to a port verify service's ``secp_recover``
  lane: its blocks apply and the service's tenant row counts them. With
  the reference's ``_verify_items`` (a closure on the fn lane, which a
  remote scheduler runs in the follower's own process) the service sees
  none of them;
- the upgrade with two followers over encrypted p2p behind a port verify
  service (``tests/torch_sequencer_net.py``, ``chip_smoke.py``'s phase 11
  on the card): votes before the upgrade and the followers' recoveries
  after it cross the socket.

The two tests of the reference file that need the node, its config and
``tools/`` wait for those modules. Verifiers run on ``device="cpu"``.
Tolerance: exact (bytes, hashes, addresses).
"""

from __future__ import annotations

import asyncio
import inspect
import textwrap

import pytest

from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import secp256k1
from tendermint_tpu_torch.l2node.mock import MockL2Node
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.p2p.transport import MultiplexTransport, NetAddress
from tendermint_tpu_torch.parallel import scheduler as sched_mod
from tendermint_tpu_torch.sequencer import (
    BlockBroadcastReactor,
    BlockRingBuffer,
    HashSet,
    LocalSigner,
    PendingBlockCache,
    StateV2,
    StaticSequencerVerifier,
)
from tendermint_tpu_torch.types.block_v2 import BlockV2

from .test_torch_verify_service import connect, sock_path

pytestmark = pytest.mark.sequencer

NETWORK = "seq-chain"


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """The port's process verifier on the CPU and no default scheduler."""
    v = bv.BatchVerifier(device="cpu")
    monkeypatch.setattr(bv, "_default", v)
    monkeypatch.setattr(sched_mod, "_default_scheduler", None)
    return v


# --- caches ----------------------------------------------------------------


def test_ring_buffer_eviction():
    rb = BlockRingBuffer(capacity=3)
    for n in range(5):
        rb.add(BlockV2(number=n, hash=bytes([n]) * 32))
    assert rb.get_by_height(1) is None
    assert rb.get_by_height(4).number == 4
    assert len(rb) == 3


def test_hash_set_dedup_and_eviction():
    s = HashSet(capacity=2)
    assert not s.add(b"a")
    assert s.add(b"a")  # duplicate
    s.add(b"b")
    s.add(b"c")  # evicts "a"
    assert b"a" not in s
    assert b"c" in s


def test_pending_cache_longest_chain():
    c = PendingBlockCache()
    root = b"\x00" * 32

    def blk(n, h, parent):
        return BlockV2(number=n, hash=h * 32, parent_hash=parent)

    # two forks off root: [a1] and [b1 <- b2]
    a1 = blk(1, b"\x0a", root)
    b1 = blk(1, b"\x0b", root)
    b2 = blk(2, b"\x0c", b1.hash)
    for b in (a1, b1, b2):
        assert c.add(b, local_height=0)
    chain = c.get_longest_chain(root)
    assert [b.number for b in chain] == [1, 2]
    assert chain[0].hash == b1.hash
    c.prune_below(1)
    assert c.get(a1.hash) is None and c.get(b1.hash) is None
    assert c.get(b2.hash) is not None


def test_pending_cache_height_window():
    c = PendingBlockCache()
    far = BlockV2(number=500, hash=b"\x01" * 32, parent_hash=b"\x02" * 32)
    assert not c.add(far, local_height=10)  # too far ahead
    assert c.add(far, local_height=450)


# --- BlockV2 signature semantics -------------------------------------------


def test_block_v2_sign_recover_roundtrip():
    key = secp256k1.PrivKey.from_secret(b"seq-key")
    signer = LocalSigner(key)
    l2 = MockL2Node()
    block, _ = l2.request_block_data_v2(l2.get_latest_block_v2().hash)
    block.signature = signer.sign(block.hash)
    assert block.recover_signer() == signer.address()
    # wire roundtrip preserves recoverability
    rt = BlockV2.decode(block.encode())
    assert rt.recover_signer() == signer.address()
    assert rt.transactions == block.transactions
    # a flipped signature byte recovers a different (or no) signer
    bad = BlockV2.decode(block.encode())
    bad.signature = bytes([block.signature[0] ^ 1]) + block.signature[1:]
    assert bad.recover_signer() != signer.address()


def test_block_v2_signed_by_both_packages_is_identical():
    """The same seeded key and mock-L2 block, signed by each package's
    LocalSigner: equal signatures, wire bytes, hashes and recovered
    addresses, and each package decodes and recovers the other's block."""
    from tendermint_tpu.crypto import secp256k1 as ref_secp
    from tendermint_tpu.l2node.mock import MockL2Node as RefL2
    from tendermint_tpu.sequencer import LocalSigner as RefSigner
    from tendermint_tpu.types.block_v2 import BlockV2 as RefBlock

    out = {}
    for name, l2cls, sgn, key in (
        ("port", MockL2Node, LocalSigner, secp256k1.PrivKey),
        ("ref", RefL2, RefSigner, ref_secp.PrivKey),
    ):
        signer = sgn(key.from_secret(b"parity-seq"))
        l2 = l2cls()
        blocks = []
        parent = l2.get_latest_block_v2().hash
        for _ in range(3):
            b, _ = l2.request_block_data_v2(parent)
            b.signature = signer.sign(b.hash)
            l2.apply_block_v2(b)
            blocks.append(b)
            parent = b.hash
        out[name] = (signer.address(), blocks)
    (p_addr, p_blocks), (r_addr, r_blocks) = out["port"], out["ref"]
    assert p_addr == r_addr
    for pb, rb in zip(p_blocks, r_blocks):
        assert pb.hash == rb.hash and pb.signature == rb.signature
        assert pb.encode() == rb.encode()
        assert pb.recover_signer() == rb.recover_signer() == p_addr
        assert RefBlock.decode(pb.encode()).recover_signer() == p_addr
        assert BlockV2.decode(rb.encode()).recover_signer() == p_addr


# --- StateV2 production -----------------------------------------------------


def test_state_v2_produces_signed_blocks():
    key = secp256k1.PrivKey.from_secret(b"producer")
    signer = LocalSigner(key)
    l2 = MockL2Node()
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        sv = StateV2(l2, block_interval=0.01, signer=signer, verifier=verifier)
        await sv.start()
        b1 = await sv.produce_block()
        b2 = await sv.produce_block()
        await sv.stop()
        return b1, b2

    b1, b2 = asyncio.run(run())
    assert b2.parent_hash == b1.hash
    assert b1.recover_signer() == signer.address()
    assert l2.get_latest_block_v2().hash == b2.hash


# --- end-to-end over p2p ----------------------------------------------------


def _build_seq_node(signer, verifier, *, wait_sync=False, l2=None, intervals=0.1):
    l2 = l2 or MockL2Node()
    sv = StateV2(l2, block_interval=0.05, signer=signer, verifier=verifier)
    nk = NodeKey.generate()
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
    reactor = BlockBroadcastReactor(
        sv,
        verifier,
        wait_sync=wait_sync,
        apply_interval=intervals,
        sync_interval=intervals,
    )
    sw.add_reactor("sequencer", reactor)
    return sv, reactor, nk, transport, sw


async def _start_and_connect(nodes):
    for _, _, _, t, sw in nodes:
        await t.listen()
        await sw.start()
    for i, (_, _, nk_i, t_i, sw_i) in enumerate(nodes):
        for j, (_, _, nk_j, t_j, _) in enumerate(nodes):
            if j <= i:
                continue
            await sw_i.dial_peer(NetAddress(nk_j.id, "127.0.0.1", t_j.listen_port))


async def _stop_nodes(nodes):
    for _, r, _, _, sw in nodes:
        await r.on_stop()
        await sw.stop()


def test_sequencer_gossip_and_follower_apply():
    key = secp256k1.PrivKey.from_secret(b"seq-e2e")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        seq = _build_seq_node(signer, verifier)
        fol = _build_seq_node(None, verifier)
        nodes = [seq, fol]
        await _start_and_connect(nodes)
        for _, r, *_ in nodes:
            await r.on_start()
        # wait until the follower applied a few gossiped blocks
        for _ in range(100):
            await asyncio.sleep(0.05)
            if fol[0].latest_height() >= 3:
                break
        seq_h = seq[0].latest_height()
        fol_h = fol[0].latest_height()
        assert fol_h >= 3, f"follower stuck at {fol_h} (seq at {seq_h})"
        assert fol[0].latest_block.recover_signer() == signer.address()
        await _stop_nodes(nodes)

    asyncio.run(run())


def test_follower_rejects_wrong_signer():
    seq_key = secp256k1.PrivKey.from_secret(b"real-seq")
    rogue_key = secp256k1.PrivKey.from_secret(b"rogue")
    signer = LocalSigner(rogue_key)  # rogue signs blocks
    verifier = StaticSequencerVerifier(
        [LocalSigner(seq_key).address()]
    )  # ...but only real-seq is allowed

    async def run():
        seq = _build_seq_node(signer, verifier)
        fol = _build_seq_node(None, verifier)
        nodes = [seq, fol]
        await _start_and_connect(nodes)
        for _, r, *_ in nodes:
            await r.on_start()
        await asyncio.sleep(0.5)
        h = fol[0].latest_height()
        await _stop_nodes(nodes)
        return h

    assert asyncio.run(run()) == 0, "follower applied a rogue-signed block"


def test_sync_gap_catchup():
    """A follower joining far behind fetches blocks over the sync channel
    (reference checkSyncGap + requestMissingBlocks :351-383)."""
    key = secp256k1.PrivKey.from_secret(b"seq-gap")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        seq = _build_seq_node(signer, verifier)
        # pre-produce 30 blocks (> SMALL_GAP_THRESHOLD) before follower joins
        await seq[0].start()
        for _ in range(30):
            await seq[0].produce_block()
        fol = _build_seq_node(None, verifier)
        nodes = [seq, fol]
        await _start_and_connect(nodes)
        seq[1].sequencer_started = True  # StateV2 already started above
        seq[1]._tasks.append(asyncio.create_task(seq[1]._broadcast_routine()))
        await fol[1].on_start()
        for _ in range(200):
            await asyncio.sleep(0.05)
            if fol[0].latest_height() >= 30:
                break
        h = fol[0].latest_height()
        await _stop_nodes(nodes)
        return h

    assert asyncio.run(run()) >= 30


def test_bft_upgrade_hands_off_to_sequencer():
    """A BFT chain crossing upgrade_height switches to sequencer mode and
    keeps producing BlockV2s (reference node.go:1612-1632
    switchToSequencerMode wired from consensus/state.go:1921-1938)."""
    from .torch_chaos_harness import make_genesis, make_node, make_validators

    vs, pvs = make_validators(1)
    genesis = make_genesis(vs)
    key = secp256k1.PrivKey.from_secret(b"upgrade-seq")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])
    l2 = MockL2Node()

    async def run():
        sv = StateV2(l2, block_interval=999, signer=signer, verifier=verifier)
        produced = []

        async def on_upgrade(state):
            # mirror switchToSequencerMode: seed L2 to the BFT height and
            # start StateV2 production
            l2.seed_v2_height(state.last_block_height)
            await sv.start()
            produced.append(await sv.produce_block())
            produced.append(await sv.produce_block())

        cs, app, _, bs, ss = make_node(
            vs, pvs[0], genesis, l2=l2, upgrade_height=2, on_upgrade=on_upgrade
        )
        await cs.start()
        await cs.wait_for_height(2, timeout=30)
        await asyncio.sleep(0.2)
        await cs.stop()
        await sv.stop()
        return produced

    produced = asyncio.run(run())
    assert len(produced) == 2
    assert produced[0].number == 3  # continues above the BFT chain
    assert produced[1].number == 4
    assert produced[0].recover_signer() == signer.address()


def _signed_chain(signer, n, l2=None):
    """n signed linked blocks from a fresh mock chain (+ the source l2)."""
    src = l2 or MockL2Node()
    chain = []
    parent = src.get_latest_block_v2().hash
    for _ in range(n):
        b, _ = src.request_block_data_v2(parent)
        b.signature = signer.sign(b.hash)
        src.apply_block_v2(b)
        chain.append(b)
        parent = b.hash
    return chain, src


def test_out_of_order_blocks_buffered_in_pending_cache():
    """Future blocks land in the pending cache and apply once the gap
    closes (reference onBlockV2 future-block caching + tryApplyFromCache)."""
    key = secp256k1.PrivKey.from_secret(b"seq-ooo")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        l2 = MockL2Node()
        sv = StateV2(l2, block_interval=999, signer=None, verifier=verifier)
        await sv.start()
        reactor = BlockBroadcastReactor(sv, verifier)
        chain, _src = _signed_chain(signer, 3)

        class FakePeer:
            id = "fake-peer"

            def try_send(self, ch, msg):
                return True

        peer = FakePeer()
        # deliver 3, 2 (buffered), then 1 (applies; cache drains the rest)
        await reactor._on_block_v2(chain[2], peer, verify_sig=True)
        await reactor._on_block_v2(chain[1], peer, verify_sig=True)
        assert sv.latest_height() == 0
        assert reactor.pending_cache.size() == 2
        await reactor._on_block_v2(chain[0], peer, verify_sig=True)
        assert sv.latest_height() == 3
        await sv.stop()

    asyncio.run(run())


# --- the event-driven streaming plane --------------------------------------


class _FakePeer:
    """try_send-only peer double with an adjustable send-queue headroom
    (None = no queue_headroom attribute semantics: always send)."""

    def __init__(self, pid="fake-peer", headroom=None):
        self.id = pid
        self._headroom = headroom
        self.sent: list[tuple[int, bytes]] = []

    def try_send(self, ch, msg):
        if self._headroom is not None and self._headroom <= 0:
            return False
        self.sent.append((ch, msg))
        return True

    def queue_headroom(self, ch):
        return 1000 if self._headroom is None else self._headroom


class _FakeSwitch:
    def __init__(self, peers):
        self.peers = {p.id: p for p in peers}


def test_event_driven_apply_no_polling_tick():
    """With the apply/sync fallback tick at 60 s, gossiped blocks still
    apply promptly: receipt wakes the plane, the interval is only a
    fallback."""
    import time as _time

    key = secp256k1.PrivKey.from_secret(b"seq-event")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        seq = _build_seq_node(signer, verifier, intervals=60.0)
        fol = _build_seq_node(None, verifier, intervals=60.0)
        nodes = [seq, fol]
        await _start_and_connect(nodes)
        for _, r, *_ in nodes:
            await r.on_start()
        t0 = _time.perf_counter()
        for _ in range(200):
            await asyncio.sleep(0.02)
            if fol[0].latest_height() >= 3:
                break
        wall = _time.perf_counter() - t0
        h = fol[0].latest_height()
        lats = list(fol[1].apply_latencies)
        await _stop_nodes(nodes)
        return h, wall, lats

    h, wall, lats = asyncio.run(run())
    assert h >= 3, f"follower stuck at {h} with 60 s fallback ticks"
    # 3 blocks at 0.05 s production cadence: event-driven apply keeps
    # pace with production, nowhere near even ONE fallback tick
    assert wall < 10.0, f"took {wall:.1f}s — rode the fallback tick?"
    assert lats and max(lats) < 2.0, f"apply latencies {lats[:5]}..."


def test_windowed_catchup_event_driven():
    """A follower joining 30+ blocks behind catches up through the 0x51
    window without polling ticks: each landed response refills the
    request window (sync_interval is 60 s)."""
    import time as _time

    key = secp256k1.PrivKey.from_secret(b"seq-window")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        seq = _build_seq_node(signer, verifier, intervals=60.0)
        await seq[0].start()
        for _ in range(30):
            await seq[0].produce_block()
        fol = _build_seq_node(None, verifier, intervals=60.0)
        nodes = [seq, fol]
        await _start_and_connect(nodes)
        seq[1].sequencer_started = True  # StateV2 already started above
        seq[1]._tasks.append(asyncio.create_task(seq[1]._broadcast_routine()))
        await fol[1].on_start()
        t0 = _time.perf_counter()
        for _ in range(400):
            await asyncio.sleep(0.02)
            if fol[0].latest_height() >= 30:
                break
        wall = _time.perf_counter() - t0
        h = fol[0].latest_height()
        outstanding = len(fol[1].requested_heights)
        await _stop_nodes(nodes)
        return h, wall, outstanding

    h, wall, outstanding = asyncio.run(run())
    assert h >= 30, f"follower caught up only to {h}"
    assert wall < 8.0, f"catchup took {wall:.1f}s with 60 s sync ticks"
    # landed heights left the window (no lifetime accumulation)
    assert outstanding <= 5, f"{outstanding} stale requested heights"


def test_requested_heights_expire():
    """requested_heights entries answered by NoBlockResponse or belonging
    to a departed peer expire instead of accumulating (and a TTL covers
    silent peers)."""
    import time as _time

    key = secp256k1.PrivKey.from_secret(b"seq-expire")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        sv = StateV2(MockL2Node(), signer=None, verifier=verifier)
        await sv.start()
        reactor = BlockBroadcastReactor(sv, verifier, sync_interval=0.1)
        p1 = _FakePeer("p1")
        p2 = _FakePeer("p2")
        reactor.switch = _FakeSwitch([p1, p2])
        reactor.peer_heights = {"p1": 100, "p2": 100}
        await reactor._request_missing_blocks(1, 100)
        assert len(reactor.requested_heights) == reactor.catchup_window
        # NoBlockResponse from the asked peer expires that height
        h0 = next(iter(reactor.requested_heights))
        asked = reactor.requested_heights[h0][0]
        reactor._on_no_block(h0, p1 if asked == "p1" else p2)
        assert h0 not in reactor.requested_heights
        # ...and clamps the peer's advertised height below the miss
        assert reactor.peer_heights[asked] == h0 - 1
        # a departed peer's in-flight requests expire with it
        victim = p1 if any(
            pid == "p1" for pid, _ in reactor.requested_heights.values()
        ) else p2
        await reactor.remove_peer(victim, "bye")
        assert all(pid != victim.id for pid, _ in reactor.requested_heights.values())
        # TTL: silent peers' entries age out on the next sync pass
        stale_t = _time.monotonic() - reactor.request_ttl - 1
        old = {h: (pid, stale_t) for h, (pid, _t) in reactor.requested_heights.items()}
        reactor.requested_heights = dict(old)
        await reactor.check_sync_gap()
        # expired entries were dropped and immediately re-requested with
        # fresh timestamps (the event-driven window refills itself)
        assert all(
            t > stale_t for _pid, t in reactor.requested_heights.values()
        ), "TTL-expired requests survived the sync pass"
        await sv.stop()

    asyncio.run(run())


def test_encode_once_fanout_many_peers():
    """Gossiping one block to N subscriber peers costs one BlockV2
    serialization (memoized encode shared by every framed send), and
    serving the same block on the sync channel reuses it."""
    from tendermint_tpu_torch.types import block_v2 as bv2

    key = secp256k1.PrivKey.from_secret(b"seq-encode-once")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        sv = StateV2(MockL2Node(), signer=None, verifier=verifier)
        await sv.start()
        reactor = BlockBroadcastReactor(sv, verifier)
        peers = [_FakePeer(f"p{i}") for i in range(8)]
        reactor.switch = _FakeSwitch(peers)
        chain, _src = _signed_chain(signer, 1)
        block = chain[0]
        before = bv2.serializations()
        reactor._gossip_block(block, from_peer="")
        assert bv2.serializations() - before == 1
        sent = [p for p in peers if p.sent]
        assert len(sent) == 8
        # all eight sends share the identical framed message bytes
        msgs = {p.sent[0][1] for p in peers}
        assert len(msgs) == 1
        # a sync-channel serve of the same block is another cache hit
        reactor.recent_blocks.add(block)
        await reactor._on_block_request(block.number, peers[0])
        assert bv2.serializations() - before == 1
        # mutation invalidates: a re-signed block re-serializes once
        block.signature = signer.sign(block.hash)
        block.encode()
        assert bv2.serializations() - before == 2
        await sv.stop()

    asyncio.run(run())


def test_backpressure_skips_and_revisits_slow_subscriber():
    """A peer with a full 0x50 send queue is skipped (fan-out never blocks
    behind it) and revisited once its queue drains; the healthy peers get
    the block immediately."""
    key = secp256k1.PrivKey.from_secret(b"seq-backpressure")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])

    async def run():
        sv = StateV2(MockL2Node(), signer=None, verifier=verifier)
        await sv.start()
        reactor = BlockBroadcastReactor(sv, verifier)
        slow = _FakePeer("slow", headroom=0)
        fast = _FakePeer("fast")
        reactor.switch = _FakeSwitch([slow, fast])
        chain, _src = _signed_chain(signer, 1)
        block = chain[0]
        reactor._gossip_block(block, from_peer="")
        assert fast.sent and not slow.sent
        assert "slow" in reactor._fanout_pending
        # queue drains -> the revisit task delivers without a re-gossip
        slow._headroom = 10
        for _ in range(100):
            await asyncio.sleep(0.02)
            if slow.sent:
                break
        assert slow.sent, "deferred block never revisited"
        assert not reactor._fanout_pending
        # bookkeeping: the slow peer is now marked sent (no duplicate)
        reactor._gossip_block(block, from_peer="")
        assert len(slow.sent) == 1 and len(fast.sent) == 1
        # teardown the lazily-spawned revisit task
        await reactor.on_stop()

    asyncio.run(run())


def test_verify_batcher_coalesces_burst_into_one_round():
    """A burst of follower-side ECDSA checks coalesces into fn-lane
    scheduler rounds under the `sequencer` class instead of one on-loop
    recover per block."""
    from tendermint_tpu_torch.parallel.scheduler import (
        CLASS_ORDER,
        VerifyScheduler,
        set_default_scheduler,
    )
    from tendermint_tpu_torch.sequencer import SequencerVerifyBatcher

    # lane position: directly below live consensus, above every backfill
    assert CLASS_ORDER.index("sequencer") == CLASS_ORDER.index("consensus") + 1

    key = secp256k1.PrivKey.from_secret(b"seq-batcher")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])
    chain, _src = _signed_chain(signer, 16)
    forged = BlockV2.decode(chain[0].encode())
    forged.signature = bytes([chain[0].signature[0] ^ 1]) + chain[0].signature[1:]

    async def run():
        sched = VerifyScheduler()
        await sched.start()
        set_default_scheduler(sched)
        try:
            batcher = SequencerVerifyBatcher(verifier)
            verdicts = await batcher.submit_items(chain + [forged])
            batcher.stop()
            rounds = [
                d for d in sched.dispatch_log
                if d.get("fn") and d["classes"] == ["sequencer"]
            ]
            return verdicts, rounds
        finally:
            set_default_scheduler(None)
            await sched.stop()

    verdicts, rounds = asyncio.run(run())
    assert verdicts[:16] == [True] * 16
    assert verdicts[16] is False
    # 17 checks -> a handful of coalesced fn rounds (first may dispatch
    # alone while the rest accumulate), every one under `sequencer`
    assert rounds and len(rounds) <= 3
    assert sum(d["n"] for d in rounds) == 17


# --- through the verify service ---------------------------------------------


def _reference_lines() -> dict:
    """The reference's SequencerVerifyBatcher._check and _verify_items,
    compiled in the port's module: its lines, the port's scheduler."""
    from tendermint_tpu.sequencer.verify import SequencerVerifyBatcher as Ref
    from tendermint_tpu_torch.sequencer import verify as port_verify

    scope = {}
    for fn in (Ref._check, Ref._verify_items):
        src = textwrap.dedent(inspect.getsource(fn))
        exec(compile(src, f"<reference {fn.__name__}>", "exec"), vars(port_verify), scope)
    return scope


@pytest.mark.parametrize("lines", ["port", "reference"])
def test_follower_recovers_through_the_verify_service(tmp_path, monkeypatch, lines):
    """A sequencer and a follower over encrypted p2p, the process default
    scheduler a RemoteVerifyScheduler to a port service on the CPU: the
    follower applies the sequencer's blocks, their signers recovered on
    the service's secp_recover lane, and the service's one tenant row
    counts every block the follower checked. On the reference's lines the
    follower still applies them, but the service recovers none."""
    from tendermint_tpu_torch.parallel.verify_service import ServiceThread
    from tendermint_tpu_torch.sequencer import SequencerVerifyBatcher

    if lines == "reference":
        for name, fn in _reference_lines().items():
            monkeypatch.setattr(SequencerVerifyBatcher, name, fn, raising=False)
    key = secp256k1.PrivKey.from_secret(b"seq-remote")
    signer = LocalSigner(key)
    verifier = StaticSequencerVerifier([signer.address()])
    svc = ServiceThread(sock_path(tmp_path, "seq.sock"), device="cpu",
                        scheduler=sched_mod.VerifyScheduler())
    svc.start()
    seq0 = max((e["seq"] for e in svc.server.scheduler.ledger.entries()), default=-1)

    async def run():
        remote = await connect(svc.server.path)
        sched_mod.set_default_scheduler(remote)
        try:
            seq = _build_seq_node(signer, verifier)
            fol = _build_seq_node(None, verifier)
            nodes = [seq, fol]
            await _start_and_connect(nodes)
            for _, r, *_ in nodes:
                await r.on_start()
            for _ in range(200):
                await asyncio.sleep(0.05)
                if fol[0].latest_height() >= 5:
                    break
            h = fol[0].latest_height()
            signer_seen = fol[0].latest_block.recover_signer()
            await _stop_nodes(nodes)
            return h, signer_seen, remote.ipc_stats()
        finally:
            sched_mod.set_default_scheduler(None)
            await remote.stop()

    try:
        h, signer_seen, stats = asyncio.run(run())
    finally:
        svc.stop()
    assert h >= 5 and signer_seen == signer.address()
    rows = list(svc.server.client_stats.values())
    rounds = [e for e in svc.server.scheduler.ledger.entries()
              if e["seq"] > seq0 and e["engine"] == "secp_recover"]
    if lines == "port":
        assert len(rows) == 1 and rows[0]["fn_items"] >= h, rows
        assert rows[0]["submissions"] == 0
        assert rounds and all(e["classes"] == ["sequencer"] for e in rounds)
        assert sum(e["requested"] for e in rounds) == rows[0]["fn_items"]
        assert stats["degrades"] == 0 and stats["remote_submissions"] >= 1
    else:
        assert not rounds and sum(r["fn_items"] for r in rows) == 0


def test_upgrade_with_two_followers_behind_the_verify_service(tmp_path):
    """Three validators over encrypted p2p (tests/torch_sequencer_net.py),
    every node's default scheduler a RemoteVerifyScheduler to a port
    service on the CPU: the gossiped votes before the upgrade reach the
    service as signature rounds, the BFT chain stops at the upgrade
    height, node 0 produces BlockV2s above it, and both followers apply
    them, recovering each signer on the service's secp_recover lane."""
    from tendermint_tpu_torch.parallel.verify_service import ServiceThread

    from .torch_sequencer_net import build_upgrade_net, run_upgrade

    upgrade, v2_blocks = 3, 6
    svc = ServiceThread(sock_path(tmp_path, "up.sock"), device="cpu",
                        scheduler=sched_mod.VerifyScheduler())
    svc.start()
    seq0 = max((e["seq"] for e in svc.server.scheduler.ledger.entries()), default=-1)

    async def run():
        remote = await connect(svc.server.path)
        sched_mod.set_default_scheduler(remote)
        try:
            nodes = build_upgrade_net(3, upgrade)
            return await run_upgrade(nodes, upgrade, v2_blocks, timeout=90), remote.ipc_stats()
        finally:
            sched_mod.set_default_scheduler(None)
            await remote.stop()

    try:
        res, stats = asyncio.run(run())
    finally:
        svc.stop()
    assert res["bft_heights"] == [upgrade] * 3
    assert all(h >= upgrade + v2_blocks for h in res["follower_v2"]), res
    assert res["sequencer_v2"] >= upgrade + v2_blocks
    assert res["signers"] == [res["sequencer_address"]] * 2
    entries = [e for e in svc.server.scheduler.ledger.entries() if e["seq"] > seq0]
    sig = [e for e in entries if e["engine"] == "sig"]
    recover = [e for e in entries if e["engine"] == "secp_recover"]
    assert sig and all(e["classes"] == ["consensus"] for e in sig)
    assert sum(e["requested"] for e in recover) >= 2 * v2_blocks
    assert stats["degrades"] == 0
