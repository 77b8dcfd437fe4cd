"""The port's height pipelining and commit pipeline against the contract of
``tests/test_pipeline.py`` and the trio of ``tests/test_commit_pipeline.py``
(group-commit WAL, write-behind block store, background apply).

- ``pipelined_heights`` self-constructs a pipeline; the next-height buffer
  holds, caps and drains; a pipelined net commits the serial net's chain
  and conserves wall time with overlap credit; a pipelined QC chain
  carries chained QCs; the crash between H+1's proposal and H's durable
  boundary replays without a double sign or a skipped height.
- A legacy (non-pipelined) peer follows a pipelined majority. The JAX
  package runs this over real p2p, which the port does not have yet; here
  it runs on the in-process broadcast net.
- Parity: with ``pipelined_heights`` on and off, a 4-validator net of each
  package on the same seeds and clock gives equal app hashes and header
  fields at heights 1-3.

The port's process verifier is on ``device="cpu"``. Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from io import BytesIO

import pytest

from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.commit_pipeline import CommitPipeline
from tendermint_tpu_torch.consensus.messages import VoteMessage
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig, ConsensusState
from tendermint_tpu_torch.consensus.wal import (
    KIND_END_HEIGHT,
    GroupCommitWAL,
    WALMessage,
    decode_records,
    encode_record,
)
from tendermint_tpu_torch.crypto import bls_signatures as bls
from tendermint_tpu_torch.crypto.bls12_381 import R
from tendermint_tpu_torch.l2node.mock import MockL2Node
from tendermint_tpu_torch.libs import protoio as pio
from tendermint_tpu_torch.obs import report
from tendermint_tpu_torch.obs.tracer import Tracer
from tendermint_tpu_torch.privval.file_pv import STEP_PROPOSE, FilePV
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.store.block_store import BlockStore, WriteBehindBlockStore
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote, VoteType

from .test_torch_consensus import (  # noqa: F401  (cpu_verifier: autouse)
    CHAIN_ID,
    PORT,
    REF,
    assert_parity,
    cpu_verifier,
    make_genesis,
    make_node,
    make_qc_validators,
    make_validators,
    parity_net,
    run_to,
    wire_net,
)


def _pipelined_config(**overrides) -> ConsensusConfig:
    cfg = ConsensusConfig.test_config()
    cfg.pipelined_heights = True
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def test_pipelined_config_self_constructs_pipeline():
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    cs, *_ = make_node(PORT, vs, pvs[0], genesis, config=_pipelined_config())
    assert cs.pipeline is not None
    cs2, *_ = make_node(PORT, vs, pvs[0], genesis)
    assert cs2.pipeline is None


def _vote_msg(height: int) -> VoteMessage:
    return VoteMessage(Vote(
        type=VoteType.PREVOTE, height=height, round=0,
        block_id=BlockID(b"\x00" * 32, PartSetHeader()), timestamp_ns=0,
        validator_address=b"\x00" * 20, validator_index=0,
    ))


def test_next_height_buffer_holds_caps_and_drains():
    """H+1 traffic is held, hard-capped, and drained: stale entries are
    discarded, current ones re-fed, and a drain below the buffered height
    re-stashes."""
    vs, pvs = make_validators(PORT, 2)
    genesis = make_genesis(PORT, vs)
    cs, *_ = make_node(PORT, vs, pvs[0], genesis, config=_pipelined_config())
    ahead, *_ = make_node(PORT, vs, pvs[0], genesis, config=_pipelined_config())

    async def run():
        cs.rs.height = 5
        await cs._handle_msg(_vote_msg(6), "peer")
        assert len(cs._next_height_buf) == 1
        cs._NEXT_HEIGHT_BUF_CAP = 3
        for _ in range(5):
            await cs._handle_msg(_vote_msg(6), "peer")
        assert len(cs._next_height_buf) == 3
        cs._buffer_next_height_msg(_vote_msg(2), "peer")
        cs.rs.height = 6
        await cs._drain_next_height_buf()
        assert cs._next_height_buf == []
        ahead.rs.height = 5
        await ahead._handle_msg(_vote_msg(6), "peer")
        await ahead._drain_next_height_buf()  # still at 5: nothing to feed
        assert len(ahead._next_height_buf) == 1

    asyncio.run(run())


def _run_net(pipelined: bool, heights: int, tracer=None, n: int = 4):
    vs, pvs = make_validators(PORT, n)
    genesis = make_genesis(PORT, vs)
    cfg = _pipelined_config() if pipelined else ConsensusConfig.test_config()
    css = [make_node(PORT, vs, pv, genesis, config=cfg,
                     tracer=(tracer if i == 0 else None))[0]
           for i, pv in enumerate(pvs)]
    wire_net(css)
    asyncio.run(run_to(css, heights, timeout=90))
    assert len({cs.block_store.load_block(heights).hash() for cs in css}) == 1
    return css


def test_pipelined_net_matches_serial_app_hash():
    H = 4
    piped = _run_net(True, H)
    serial = _run_net(False, H)
    assert all(cs.pipeline is not None for cs in piped)
    assert (piped[0].block_store.load_block(H).header.app_hash
            == serial[0].block_store.load_block(H).header.app_hash)


def test_pipelined_net_conserves_wall_with_overlap_credit():
    """Every completed height's buckets sum to wall + booked
    pipeline_overlap_ms, and the validator passes."""
    tracer = Tracer(enabled=True, ring_size=65536)
    _run_net(True, 5, tracer=tracer)
    cons = report.wall_conservation([r.to_json() for r in tracer.records()])
    rows = cons.get("heights", {})
    assert rows, "no conservation rows from the pipelined run"
    assert report.check_conservation(cons) == []
    assert cons["aggregate"]["conserved"] is True
    assert all(row["pipeline_overlap_ms"] >= 0.0 for row in rows.values())


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "serial"])
def test_net_matches_reference(pipelined):
    """pipelined_heights on and off: equal app hashes and header fields to
    the JAX package's net on the same seeds and clock, heights 1-3."""
    port = parity_net(PORT, pipelined_heights=pipelined)
    ref = parity_net(REF, pipelined_heights=pipelined)
    assert_parity(port, ref)


def test_pipelined_chain_carries_chained_qc():
    vs, pvs, privs = make_qc_validators(PORT, 4, seed=b"pipeqc")
    genesis = make_genesis(PORT, vs)
    cfg = _pipelined_config(quorum_certificates=True)
    H = 4
    css = []
    for pv in pvs:
        cs, *_ = make_node(PORT, vs, pv, genesis, config=cfg,
                           bls_signer=bls.signer_for(privs[pv.get_pub_key().address()]))
        cs.executor.qc_enabled = True
        css.append(cs)
    wire_net(css)
    asyncio.run(run_to(css, H, timeout=90))
    assert len({cs.block_store.load_block(H).hash() for cs in css}) == 1
    bs = css[0].block_store
    for h in range(2, H):
        blk = bs.load_block(h + 1)
        assert blk.last_qc is not None and blk.last_qc.height == h
        vs.verify_commit_qc(CHAIN_ID, blk.last_qc.block_id, h, blk.last_qc)


def test_legacy_peer_follows_pipelined_chain():
    """A non-pipelined peer in a majority-pipelined committee keeps up on
    the in-process net and agrees on every block."""
    vs, pvs = make_validators(PORT, 4)
    genesis = make_genesis(PORT, vs)
    H = 4
    css = []
    for i, pv in enumerate(pvs):
        cfg = _pipelined_config() if i < 3 else ConsensusConfig.test_config()
        css.append(make_node(PORT, vs, pv, genesis, config=cfg)[0])
    wire_net(css)
    asyncio.run(run_to(css, H, timeout=90))
    legacy = css[3]
    assert legacy.pipeline is None and not legacy.config.pipelined_heights
    for h in range(1, H + 1):
        assert len({cs.block_store.load_block(h).hash() for cs in css}) == 1


# --- crash across the pipelined boundary -------------------------------------


class _RecordingPV:
    """FilePV wrapper recording every signature by (height, round, step);
    `freeze_at=H` refuses any signing past (H, 0, propose)."""

    def __init__(self, inner: FilePV, book: dict, freeze_at=None):
        self.inner, self.book, self.freeze_at = inner, book, freeze_at

    def get_pub_key(self):
        return self.inner.get_pub_key()

    def sign_proposal(self, chain_id, proposal):
        if self.freeze_at is not None and (
            proposal.height > self.freeze_at
            or (proposal.height == self.freeze_at and proposal.round > 0)
        ):
            raise RuntimeError("crash window: signing frozen")
        self.inner.sign_proposal(chain_id, proposal)
        self.book.setdefault((proposal.height, proposal.round, "proposal"),
                             set()).add(bytes(proposal.signature))

    def sign_vote(self, chain_id, vote):
        if self.freeze_at is not None and vote.height >= self.freeze_at:
            raise RuntimeError("crash window: signing frozen")
        self.inner.sign_vote(chain_id, vote)
        self.book.setdefault((vote.height, vote.round, int(vote.type)),
                             set()).add(bytes(vote.signature))


def _crash_node(genesis, pv, wal_path, block_kv, state_kv, bls_scalar):
    """Pipelined + QC single-validator node over restartable stores and an
    on-disk group-commit WAL."""
    l2 = MockL2Node()
    state_store = StateStore(state_kv)
    block_store = WriteBehindBlockStore(block_kv, max_inflight=4)
    state = state_store.load()
    if state is None:
        state = State.from_genesis(genesis)
        state_store.bootstrap(state)
    executor = BlockExecutor(state_store, block_store,
                             LocalClient(KVStoreApplication()), l2)
    executor.qc_enabled = True
    cs = ConsensusState(
        _pipelined_config(quorum_certificates=True), state, executor,
        block_store, l2, priv_validator=pv,
        wal=GroupCommitWAL(wal_path, flush_interval=0.001),
        commit_pipeline=CommitPipeline(), bls_signer=bls.signer_for(bls_scalar),
    )
    return cs, block_store, state_store


def _truncate_wal_after_end_height(path: str, h: int) -> None:
    data = open(path, "rb").read()
    off, cut = 0, None
    for m in decode_records(data, lenient=True):
        off += len(encode_record(m))
        if m.kind == KIND_END_HEIGHT and pio.read_uvarint(BytesIO(m.data)) == h:
            cut = off
            break
    assert cut is not None, f"no end_height({h}) record in the WAL"
    with open(path, "r+b") as f:
        f.truncate(cut)


def test_crash_between_next_propose_and_durable_boundary(tmp_path):
    """The node signed H+1's proposal while H's decision is not yet in the
    stores and the H+1 records never reached disk. Restart replays H from
    the WAL, re-enters H+1 and continues without a double sign (the
    conflicting re-proposal is refused; the round advances) and without
    skipping a height; the chained QC re-derives across the boundary."""
    CRASH_H = 4
    kp, sp = str(tmp_path / "pv_key.json"), str(tmp_path / "pv_state.json")
    wal_path = str(tmp_path / "wal")
    fpv = FilePV.generate(kp, sp)
    scalar = int.from_bytes(hashlib.sha256(b"crash-bls").digest(), "big") % (R - 1) + 1
    pub = bls.pubkey_from_priv(scalar)
    vs = ValidatorSet([Validator(fpv.get_pub_key(), 10,
                                 bls_pub_key=bls.g2_to_bytes(pub.key))])
    genesis = make_genesis(PORT, vs)
    book: dict = {}
    block_kv, state_kv = MemKV(), MemKV()

    async def first_run():
        pv = _RecordingPV(FilePV.load(kp, sp), book, freeze_at=CRASH_H)
        cs, bs, ss = _crash_node(genesis, pv, wal_path, block_kv, state_kv, scalar)
        cs.state = await Handshaker(ss, bs, genesis, cs.executor).handshake(cs.state)
        await cs.start()
        await cs.wait_for_height(2, timeout=60)
        bs.wait_durable()
        snap = ({k: v for k, v in block_kv.iterate()},
                {k: v for k, v in state_kv.iterate()})
        deadline = time.monotonic() + 60
        while (CRASH_H, 0, "proposal") not in book:
            assert time.monotonic() < deadline, "H+1 proposal never signed"
            await asyncio.sleep(0.005)
        await cs.stop()
        bs.stop()
        cs.wal.close()
        return snap

    snap_block, snap_state = asyncio.run(first_run())
    pv_check = FilePV.load(kp, sp)
    assert pv_check.last_state.height == CRASH_H
    assert pv_check.last_state.step == STEP_PROPOSE
    _truncate_wal_after_end_height(wal_path, CRASH_H - 1)

    async def second_run():
        block_kv2, state_kv2 = MemKV(), MemKV()
        for k, v in snap_block.items():
            block_kv2.set(k, v)
        for k, v in snap_state.items():
            state_kv2.set(k, v)
        pv = _RecordingPV(FilePV.load(kp, sp), book)
        cs, bs, ss = _crash_node(genesis, pv, wal_path, block_kv2, state_kv2, scalar)
        cs.state = await Handshaker(ss, bs, genesis, cs.executor).handshake(cs.state)
        await cs.start()
        await cs.wait_for_height(CRASH_H + 2, timeout=90)
        await cs.stop()
        bs.stop()
        cs.wal.close()
        return cs, bs

    cs, bs = asyncio.run(second_run())
    assert cs.state.last_block_height >= CRASH_H + 2
    for h in range(2, CRASH_H + 3):
        blk, prev = bs.load_block(h), bs.load_block(h - 1)
        assert blk is not None, f"height {h} missing after replay"
        assert blk.header.last_block_id.hash == prev.hash(), f"chain broken at {h}"
    for key, sigs in book.items():
        assert len(sigs) == 1, f"double sign at {key}: {len(sigs)} sigs"
    assert (CRASH_H, 0, "proposal") in book
    assert bs.load_seen_commit(CRASH_H).round >= 1
    blk = bs.load_block(CRASH_H + 1)
    assert blk.last_qc is not None and blk.last_qc.height == CRASH_H
    vs.verify_commit_qc(CHAIN_ID, blk.last_qc.block_id, CRASH_H, blk.last_qc)


# --- the commit pipeline trio: group WAL, write-behind store, apply ----------


def test_group_wal_coalesces_durable_decodable_fsyncs(tmp_path):
    """write_sync returns after a covering fsync, records decode in order
    with the end-height barrier, concurrent writers share fsyncs, and
    search_for_end_height returns the tail after a barrier."""
    path = str(tmp_path / "wal")
    wal = GroupCommitWAL(path, flush_interval=0.001)
    for i in range(10):
        wal.write_sync(WALMessage("consensus", b"m%d" % i))
    wal.write_end_height(1)
    wal.write_sync(WALMessage("consensus", b"h2-partial"))
    wal.barrier()
    assert [m.data for m in wal.search_for_end_height(1)] == [b"h2-partial"]
    wal.close()
    msgs = list(decode_records(open(path, "rb").read()))
    assert [m.data for m in msgs[:10]] == [b"m%d" % i for i in range(10)]
    assert msgs[10].kind == "end_height" and wal.fsync_count >= 1

    wal = GroupCommitWAL(str(tmp_path / "wal2"), flush_interval=0.05)
    n = 8
    start = threading.Barrier(n)

    def writer(i):
        start.wait()
        wal.write_sync(WALMessage("consensus", b"c%d" % i))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fsyncs = wal.fsync_count
    wal.close()
    assert 1 <= fsyncs < n
    assert len(list(decode_records(open(str(tmp_path / "wal2"), "rb").read()))) == n


def _mini_chain(n):
    """n consecutive blocks of a single validator with part sets and seen
    commits."""
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    cs, app, l2, bs, ss = make_node(PORT, vs, pvs[0], genesis)
    asyncio.run(run_to([cs], n, timeout=30))
    return [(bs.load_block(h), bs.load_block(h).make_part_set(), bs.load_seen_commit(h))
            for h in range(1, n + 1)]


def test_write_behind_store_overlay_and_durability():
    """Pending saves serve from the overlay at once, become durable in
    order, refuse a gap, and a cold store over the same KV sees them."""
    chain = _mini_chain(3)
    kv = MemKV()
    store = WriteBehindBlockStore(kv, max_inflight=2)
    for block, parts, seen in chain:
        store.save_block(block, parts, seen)
        h = block.header.height
        assert store.height == h
        assert store.load_block(h).hash() == block.hash()
        assert store.load_seen_commit(h) is not None
        assert store.load_block_meta(h).block_id.hash == block.hash()
    with pytest.raises(ValueError):
        store.save_block(*chain[0])
    store.wait_durable()
    assert store.durable_height == 3 and store.save_queue_depth == 0
    store.stop()
    reopened = BlockStore(kv)
    assert reopened.height == 3
    for block, _, _ in chain:
        assert reopened.load_block(block.header.height).hash() == block.hash()


def test_background_apply_matches_serial_chain(tmp_path):
    """A single validator with the whole trio (group WAL, write-behind
    store, CommitPipeline) lands on the serial path's app hash, results
    and validators, and the pipeline really applied every height."""
    from tendermint_tpu_torch.consensus.wal import WAL

    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    heights = 4

    def run(pipelined, name):
        state_store = StateStore(MemKV())
        state = State.from_genesis(genesis)
        state_store.bootstrap(state)
        path = str(tmp_path / name)
        if pipelined:
            bs = WriteBehindBlockStore(MemKV(), max_inflight=4)
            wal, pipe = GroupCommitWAL(path, flush_interval=0.001), CommitPipeline()
        else:
            bs, wal, pipe = BlockStore(MemKV()), WAL(path), None
        l2 = MockL2Node()
        ex = BlockExecutor(state_store, bs, LocalClient(KVStoreApplication()), l2)
        cs = ConsensusState(ConsensusConfig.test_config(), state, ex, bs, l2,
                            priv_validator=pvs[0], wal=wal, commit_pipeline=pipe)
        asyncio.run(run_to([cs], heights + 1, timeout=60))
        if pipelined:
            bs.wait_durable()
            bs.stop()
        cs.wal.close()
        return cs

    s, p = run(False, "wal-serial"), run(True, "wal-piped")
    assert p._applied_height >= heights + 1
    assert p.pipeline.applied_heights >= heights + 1 and p.pipeline.error is None
    for h in range(2, heights + 2):  # block h carries the state after h - 1
        hs, hp = (c.block_store.load_block(h).header for c in (s, p))
        assert (hp.app_hash, hp.last_results_hash, hp.validators_hash) == (
            hs.app_hash, hs.last_results_hash, hs.validators_hash), h
