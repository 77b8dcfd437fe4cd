"""The port's crash recovery, WAL and file privval against the contract of
``tests/test_replay.py`` and the WAL and file-PV parts of
``tests/test_wal_privval.py``.

- A restart on the same stores, WAL and app continues the chain; a fresh
  app is replayed from the block store by the handshake; the blocksync
  switch-over skips WAL catch-up once and re-anchors the WAL.
- A node process killed by ``libs/fail.fail_point`` (``FAIL_TEST_INDEX``)
  between app execution and L2 delivery restarts from its on-disk stores:
  the handshake replays the block into a fresh app and L2 node, and the
  chain goes on with the app hashes of a run that never crashed.
- WAL records, torn writes and corruption; FilePV persistence, double-sign
  refusal, idempotent re-sign and proposals; the remote signer over
  localhost TCP.
- Parity: the same WAL messages make the JAX package's file byte for byte,
  and the same FilePV key signs the same votes and proposals to the same
  bytes.

The port's process verifier is on ``device="cpu"``. Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import subprocess
import sys
import textwrap

import pytest

from tendermint_tpu.consensus import wal as ref_wal
from tendermint_tpu.privval.file_pv import FilePV as RefFilePV
from tendermint_tpu.types import vote as ref_vote
from tendermint_tpu.types.block_id import BlockID as RefBlockID
from tendermint_tpu.types.part_set import PartSetHeader as RefPSH
from tendermint_tpu.types.proposal import Proposal as RefProposal
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig, ConsensusState
from tendermint_tpu_torch.consensus.wal import (
    WAL,
    WALMessage,
    decode_records,
    encode_record,
)
from tendermint_tpu_torch.l2node.mock import MockL2Node
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.privval.file_pv import DoubleSignError, FilePV
from tendermint_tpu_torch.privval.signer import (
    SignerClient,
    SignerListenerEndpoint,
    SignerServer,
)
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import MemKV, SqliteKV
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote, VoteType

from .test_torch_consensus import (  # noqa: F401  (cpu_verifier: autouse)
    PORT,
    cpu_verifier,
    make_genesis,
    make_node,
    make_validators,
    run_to,
)

CHAIN_ID = "replay-chain"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _genesis(pv) -> GenesisDoc:
    g = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=1,
                   validators=[GenesisValidator("ed25519", pv.get_pub_key().data, 10)])
    g.validate_and_complete()
    return g


def _node(genesis, pv_path, kv_block, kv_state, app, l2, wal_path=None):
    """(cs, block_store, state_store): handshake first, as a node boots."""
    state_store, block_store = StateStore(kv_state), BlockStore(kv_block)
    executor = BlockExecutor(state_store, block_store, LocalClient(app), l2)
    state = state_store.load() or State.from_genesis(genesis)

    async def boot():
        return await Handshaker(state_store, block_store, genesis,
                                executor).handshake(state)

    state = asyncio.run(boot())
    cs = ConsensusState(ConsensusConfig.test_config(), state, executor,
                        block_store, l2, priv_validator=FilePV.load(*pv_path),
                        wal=WAL(wal_path) if wal_path else None)
    return cs, block_store, state_store


# --- tests/test_replay.py ---------------------------------------------------


def test_node_restarts_and_continues(tmp_path):
    """Run to height 2, stop on the same stores, WAL and app, restart
    through the handshake and WAL catch-up, continue to 4; the chain is
    contiguous across the restart."""
    kv_block, kv_state, app, l2 = MemKV(), MemKV(), KVStoreApplication(), MockL2Node()
    pv_path = (str(tmp_path / "pv_key"), str(tmp_path / "pv_state"))
    wal_path = str(tmp_path / "wal" / "wal")
    genesis = _genesis(FilePV.generate(*pv_path))

    cs, bs, ss = _node(genesis, pv_path, kv_block, kv_state, app, l2, wal_path)
    asyncio.run(run_to([cs], 2, timeout=20))
    cs.wal.close()
    assert ss.load().last_block_height >= 2
    cs, bs, ss = _node(genesis, pv_path, kv_block, kv_state, app, l2, wal_path)
    asyncio.run(run_to([cs], 4, timeout=20))
    cs.wal.close()
    assert cs.state.last_block_height >= 4
    for h in range(2, 5):
        assert bs.load_block(h).header.last_block_id.hash == bs.load_block(h - 1).hash()


def test_handshake_replays_into_fresh_app(tmp_path):
    kv_block, kv_state, l2 = MemKV(), MemKV(), MockL2Node()
    pv_path = (str(tmp_path / "k"), str(tmp_path / "s"))
    genesis = _genesis(FilePV.generate(*pv_path))
    app = KVStoreApplication()
    cs, _, _ = _node(genesis, pv_path, kv_block, kv_state, app, l2)
    asyncio.run(run_to([cs], 3, timeout=20))
    assert app.info().last_block_height >= 3

    fresh = KVStoreApplication()  # lost all state
    state_store, block_store = StateStore(kv_state), BlockStore(kv_block)
    executor = BlockExecutor(state_store, block_store, LocalClient(fresh), l2)
    hs = Handshaker(state_store, block_store, genesis, executor)
    state = asyncio.run(hs.handshake(state_store.load()))
    assert hs.n_blocks_replayed >= 3
    assert fresh.info().last_block_height >= 3
    assert state.last_block_height == fresh.info().last_block_height
    assert fresh.info().last_block_app_hash == app.info().last_block_app_hash


def test_blocksync_switchover_skips_wal_catchup(tmp_path):
    """Blocksync moved state past the WAL's last end-height: start()
    refuses to replay, start(skip_wal_catchup=True) starts and writes a
    barrier, and the next plain restart starts."""
    vs, pvs = make_validators(PORT, 1)
    genesis = make_genesis(PORT, vs)
    wal_path = str(tmp_path / "cs.wal")

    async def run():
        wal = WAL(wal_path)
        wal.write_end_height(1)
        wal.write_end_height(2)
        wal.flush_and_sync()
        for i, skip in enumerate((None, True, False)):
            cs, *_ = make_node(PORT, vs, pvs[0], genesis)
            cs.wal = wal if i == 0 else WAL(wal_path)
            cs.state.last_block_height = 5
            if skip is None:
                with pytest.raises(RuntimeError):
                    await cs.start()
            else:
                await cs.start(skip_wal_catchup=skip)
                assert cs.rs.height == 6
            await cs.stop()

    asyncio.run(run())


# --- a crash between app execution and L2 delivery --------------------------

_CHILD = textwrap.dedent("""
    import asyncio, sys
    sys.path.insert(0, {root!r})
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    bv._default = bv.BatchVerifier(device="cpu")
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.l2node.mock import MockL2Node
    from tendermint_tpu_torch.store.kv import SqliteKV
    from tests.test_torch_replay_wal import _genesis, _node, run_to
    from tendermint_tpu_torch.privval.file_pv import FilePV
    d = {tmp!r}
    pv_path = (d + "/k", d + "/s")
    cs, _, _ = _node(_genesis(FilePV.load(*pv_path)), pv_path, SqliteKV(d + "/blocks.db"),
                     SqliteKV(d + "/state.db"), KVStoreApplication(), MockL2Node(),
                     d + "/wal")
    asyncio.run(run_to([cs], 6, timeout=60))
    sys.exit(3)  # the fail point never fired
""")


def _fail_point_index(genesis, pv_path, height: int) -> int:
    """The FAIL_TEST_INDEX of the fail point between app execution and L2
    delivery while applying `height`, counted on an in-memory run of the
    same node (the calls come in the same order on disk)."""
    calls = []

    def record():
        f = sys._getframe(1)
        if f.f_code.co_name == "apply_block":
            calls.append(("apply", f.f_lineno, f.f_locals["block"].header.height))
        else:
            calls.append((f.f_code.co_name, f.f_lineno, None))

    real = fail.fail_point
    fail.fail_point = record
    try:
        cs, *_ = _node(genesis, pv_path, MemKV(), MemKV(), KVStoreApplication(),
                       MockL2Node())
        asyncio.run(run_to([cs], height + 1, timeout=30))
    finally:
        fail.fail_point = real
    first = min(i for i, c in enumerate(calls) if c[0] == "apply")
    site = calls[first][1]  # apply_block's first fail point: app exec -> L2
    return next(i for i, c in enumerate(calls) if c == ("apply", site, height))


def test_crash_between_app_execution_and_l2_delivery(tmp_path):
    """FAIL_TEST_INDEX kills a node process right after the app executed
    block 2 and before the L2 node saw it. The stores hold block 2 and the
    state of height 1. A restart with a fresh app and L2 node replays
    block 2 into both through the handshake and commits on, with the app
    hashes of a run that never crashed."""
    d = str(tmp_path)
    pv_path = (d + "/k", d + "/s")
    genesis = _genesis(FilePV.generate(*pv_path))
    # the dry and the clean runs sign with the same key from a fresh state
    idx = _fail_point_index(genesis, (d + "/k", d + "/s.dry"), 2)
    env = dict(os.environ, FAIL_TEST_INDEX=str(idx))
    child = subprocess.run([sys.executable, "-c", _CHILD.format(root=ROOT, tmp=d)],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120)
    assert child.returncode == 1, child.stderr[-2000:]
    kv_block, kv_state = SqliteKV(d + "/blocks.db"), SqliteKV(d + "/state.db")
    assert BlockStore(kv_block).height == 2
    assert StateStore(kv_state).load().last_block_height == 1

    app, l2 = KVStoreApplication(), MockL2Node()
    cs, bs, ss = _node(genesis, pv_path, kv_block, kv_state, app, l2, d + "/wal")
    assert [h for h, _ in l2.delivered] == [1, 2]  # replayed into the L2 node
    asyncio.run(run_to([cs], 4, timeout=30))
    cs.wal.close()

    clean, cbs, _ = _node(genesis, (d + "/k", d + "/s.clean"), MemKV(), MemKV(),
                          KVStoreApplication(),
                          MockL2Node())
    asyncio.run(run_to([clean], 4, timeout=30))
    for h in range(2, 5):
        assert bs.load_block(h).header.last_block_id.hash == bs.load_block(h - 1).hash()
        assert bs.load_block(h).header.app_hash == cbs.load_block(h).header.app_hash


# --- tests/test_wal_privval.py: WAL and file privval -----------------------


def _bid(seed=b"b", ns_bid=BlockID, ns_psh=PartSetHeader):
    return ns_bid(hashlib.sha256(seed).digest(),
                  ns_psh(1, hashlib.sha256(seed + b"p").digest()))


def _vote(height, round_, vtype, block_id, ts=1000, cls=Vote):
    return cls(type=vtype, height=height, round=round_, block_id=block_id,
               timestamp_ns=ts, validator_address=b"\x00" * 20, validator_index=0)


def test_wal_write_and_replay(tmp_path):
    wal = WAL(str(tmp_path / "wal"))
    for kind, data in (("vote", b"v1"), ("vote", b"v2")):
        wal.write(WALMessage(kind, data))
    wal.write_end_height(1)
    wal.write(WALMessage("proposal", b"p2"))
    wal.write(WALMessage("vote", b"v3"))
    wal.flush_and_sync()
    tail = wal.search_for_end_height(1)
    assert [(m.kind, m.data) for m in tail] == [("proposal", b"p2"), ("vote", b"v3")]
    assert wal.search_for_end_height(7) is None
    assert len(wal.search_for_end_height(0)) == 5
    wal.close()


def test_wal_torn_write_is_tolerated(tmp_path):
    path = str(tmp_path / "wal")
    wal = WAL(path)
    wal.write(WALMessage("vote", b"complete"))
    wal.flush_and_sync()
    wal.close()
    rec = encode_record(WALMessage("vote", b"torn"))
    with open(path, "ab") as f:
        f.write(rec[: len(rec) // 2])
    wal2 = WAL(path)
    assert [m.data for m in wal2.search_for_end_height(0)] == [b"complete"]
    assert wal2.repair() > 0
    wal2.write(WALMessage("vote", b"after-repair"))
    wal2.flush_and_sync()
    assert [m.data for m in wal2.search_for_end_height(0)] == [b"complete", b"after-repair"]
    wal2.close()


def test_wal_corruption_detected(tmp_path):
    path = str(tmp_path / "wal")
    wal = WAL(path)
    wal.write(WALMessage("vote", b"data"))
    wal.flush_and_sync()
    wal.close()
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF  # a payload byte: crc mismatch
    with pytest.raises(Exception):
        list(decode_records(bytes(raw), lenient=False))
    assert list(decode_records(bytes(raw), lenient=True)) == []


def test_wal_file_equals_reference(tmp_path):
    """Stamped records (a record stamps the wall clock when it has no
    time of its own) and an end-height barrier make equal files."""
    from tendermint_tpu_torch.consensus import wal as port_wal

    msgs = [("vote", b"v1", 5), ("proposal", b"\x00" * 300, 6), ("vote", b"", 7)]
    for name, mod in (("port", port_wal), ("ref", ref_wal)):
        w = mod.WAL(str(tmp_path / name))
        for kind, data, ts in msgs:
            w.write(mod.WALMessage(kind, data, ts))
        end = mod.end_height_record(3)
        end.timestamp_ns = 8
        w.write(end)
        w.flush_and_sync()
        w.close()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


def test_filepv_persistence(tmp_path):
    kp, sp = str(tmp_path / "key.json"), str(tmp_path / "state.json")
    pv = FilePV.generate(kp, sp)
    v = _vote(1, 0, VoteType.PREVOTE, _bid())
    pv.sign_vote(CHAIN_ID, v)
    assert pv.get_pub_key().verify(v.sign_bytes(CHAIN_ID), v.signature)
    pv2 = FilePV.load(kp, sp)
    assert pv2.get_pub_key().data == pv.get_pub_key().data
    assert (pv2.last_state.height, pv2.last_state.step) == (1, 2)


def test_filepv_blocks_double_sign(tmp_path):
    pv = FilePV.generate(str(tmp_path / "k"), str(tmp_path / "s"))
    pv.sign_vote(CHAIN_ID, _vote(5, 0, VoteType.PREVOTE, _bid(b"x")))
    with pytest.raises(DoubleSignError):  # same HRS, other block
        pv.sign_vote(CHAIN_ID, _vote(5, 0, VoteType.PREVOTE, _bid(b"y")))
    with pytest.raises(DoubleSignError):  # height regression
        pv.sign_vote(CHAIN_ID, _vote(4, 0, VoteType.PREVOTE, _bid(b"x")))
    pv.sign_vote(CHAIN_ID, _vote(5, 0, VoteType.PRECOMMIT, _bid(b"x")))
    with pytest.raises(DoubleSignError):  # step regression
        pv.sign_vote(CHAIN_ID, _vote(5, 0, VoteType.PREVOTE, _bid(b"x")))


def test_filepv_idempotent_resign(tmp_path):
    pv = FilePV.generate(str(tmp_path / "k"), str(tmp_path / "s"))
    v1 = _vote(5, 0, VoteType.PREVOTE, _bid(), ts=1000)
    pv.sign_vote(CHAIN_ID, v1)
    v2 = _vote(5, 0, VoteType.PREVOTE, _bid(), ts=1000)
    pv.sign_vote(CHAIN_ID, v2)
    assert v2.signature == v1.signature
    v3 = _vote(5, 0, VoteType.PREVOTE, _bid(), ts=2000)
    pv.sign_vote(CHAIN_ID, v3)
    assert v3.signature == v1.signature and v3.timestamp_ns == 1000


def test_filepv_proposal(tmp_path):
    pv = FilePV.generate(str(tmp_path / "k"), str(tmp_path / "s"))
    p = Proposal(height=2, round=0, pol_round=-1, block_id=_bid(), timestamp_ns=5)
    pv.sign_proposal(CHAIN_ID, p)
    assert pv.get_pub_key().verify(p.sign_bytes(CHAIN_ID), p.signature)
    with pytest.raises(DoubleSignError):
        pv.sign_proposal(CHAIN_ID, Proposal(height=2, round=0, pol_round=-1,
                                            block_id=_bid(b"z"), timestamp_ns=5))


def test_filepv_signatures_equal_reference(tmp_path):
    """One key file, loaded by each package: the same votes and proposal
    sign to the same bytes, and the state files match."""
    kp = str(tmp_path / "key.json")
    FilePV.generate(kp, str(tmp_path / "seed_state.json"))
    sigs = {}
    for name, cls, V, B, P, Prop in (
        ("port", FilePV, Vote, BlockID, PartSetHeader, Proposal),
        ("ref", RefFilePV, ref_vote.Vote, RefBlockID, RefPSH, RefProposal),
    ):
        pv = cls.load(kp, str(tmp_path / f"{name}_state.json"))  # fresh state
        out = []
        for h, vtype in ((1, 1), (1, 2), (2, 1)):
            v = _vote(h, 0, ref_vote.VoteType(vtype) if name == "ref" else VoteType(vtype),
                      _bid(b"h%d" % h, B, P), cls=V)
            pv.sign_vote(CHAIN_ID, v)
            out.append(v.signature)
        p = Prop(height=3, round=0, pol_round=-1, block_id=_bid(b"p", B, P),
                 timestamp_ns=7)
        pv.sign_proposal(CHAIN_ID, p)
        out.append(p.signature)
        sigs[name] = out
    assert sigs["port"] == sigs["ref"]


def test_remote_signer_roundtrip(tmp_path):
    async def run():
        pv = FilePV.generate(str(tmp_path / "k"), str(tmp_path / "s"))
        ep = SignerListenerEndpoint()
        await ep.start()
        signer = SignerServer(pv, "127.0.0.1", ep.port)
        await signer.start()
        await ep.wait_for_signer()
        client = SignerClient(ep)
        assert await client.ping()
        pub = await client.get_pub_key()
        assert pub.data == pv.get_pub_key().data
        v = _vote(1, 0, VoteType.PREVOTE, _bid())
        await client.sign_vote(CHAIN_ID, v)
        assert pub.verify(v.sign_bytes(CHAIN_ID), v.signature)
        with pytest.raises(Exception, match="DoubleSign"):
            await client.sign_vote(CHAIN_ID, _vote(1, 0, VoteType.PREVOTE, _bid(b"other")))
        await signer.stop()
        await ep.stop()

    asyncio.run(run())
