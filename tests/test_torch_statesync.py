"""The port's statesync (``statesync/{chunks,syncer,stateprovider,reactor}.py``)
and ABCI gRPC transport (``abci/grpc_transport.py``) against the contract
of ``tests/test_statesync.py``: the chunk queue's allocation, completion,
retry and sender discard, the syncer restoring a kvstore snapshot (in
process, and with the destination app behind gRPC), a snapshot whose
restored hash is not the trusted one rejected, and a fresh node
bootstrapping over encrypted p2p. Beside them, the wire: a port
``GRPCClient`` restores a snapshot into a JAX-package app behind that
package's ``GRPCServer``, and the other way round, since both name the
service ``tendermint_tpu.abci.ABCIApplication``; the restored state and app
hash equal the source's. Tolerance: exact (app state and hashes).
"""

from __future__ import annotations

import asyncio
import importlib

import pytest

from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.statesync import ChunkQueue, StateSyncReactor, Syncer
from tendermint_tpu_torch.statesync.chunks import Chunk
from tendermint_tpu_torch.statesync.syncer import ErrNoSnapshots

PORT_ROOT = "tendermint_tpu_torch"
REF_ROOT = "tendermint_tpu"


class FakePeer:
    def __init__(self, pid="peer-0"):
        self.id = pid
        self.sent = []

    def try_send(self, ch, msg):
        self.sent.append((ch, msg))
        return True


# --- the contract of tests/test_statesync.py: the chunk queue --------------


def test_chunk_queue_allocation_and_completion():
    q = ChunkQueue(3)
    assert q.allocate() == 0
    assert q.allocate() == 1
    assert q.allocate() == 2
    assert q.allocate() is None
    for i in range(3):
        assert q.add(Chunk(1, 1, i, b"c%d" % i, sender="p"))
    assert not q.add(Chunk(1, 1, 1, b"dup", sender="p"))  # duplicate
    assert not q.add(Chunk(1, 1, 99, b"oob", sender="p"))  # out of range
    assert q.complete


def test_chunk_queue_retry_and_sender_discard():
    q = ChunkQueue(3)
    q.add(Chunk(1, 1, 0, b"a", sender="good"))
    q.add(Chunk(1, 1, 1, b"b", sender="evil"))
    q.add(Chunk(1, 1, 2, b"c", sender="evil"))
    assert sorted(q.discard_sender("evil")) == [1, 2]
    assert not q.complete
    assert q.allocate() == 1  # freed for a refetch


# --- the state provider and the syncer over a real app ---------------------


class DirectStateProvider:
    """Stands in for the light-client provider: serves the trusted app
    hash, state and commit recorded from the source node."""

    def __init__(self, app_hash, state=None, commit=None):
        self._app_hash = app_hash
        self._state = state
        self._commit = commit

    async def app_hash(self, height):
        return self._app_hash

    async def state(self, height):
        return self._state

    async def commit(self, height):
        return self._commit


def _run_source_app(app_cls=KVStoreApplication, n_txs=30):
    """A kvstore app with committed state and snapshots."""
    app = app_cls()
    app.SNAPSHOT_CHUNK_SIZE = 64  # several chunks
    for i in range(n_txs):
        app.deliver_tx(b"key%d=value%d" % (i, i))
        app.commit()
    return app


def test_syncer_restores_kvstore_snapshot():
    src = _run_source_app()
    snaps = src.list_snapshots()
    assert snaps and snaps[-1].chunks > 1
    snap = snaps[-1]

    dst = KVStoreApplication()
    dst.SNAPSHOT_CHUNK_SIZE = 64
    provider = DirectStateProvider(src.info().last_block_app_hash,
                                   state="STATE", commit="COMMIT")
    sent_requests = []

    def request_chunk(peer, height, fmt, index):
        sent_requests.append(index)
        data = src.load_snapshot_chunk(height, fmt, index)
        syncer.add_chunk(Chunk(height, fmt, index, data, sender=peer.id))

    syncer = Syncer(dst, provider, request_chunk)
    assert syncer.add_snapshot(FakePeer(), snap)
    state, commit = asyncio.run(syncer.sync_any(discovery_time=0.1))
    assert state == "STATE" and commit == "COMMIT"
    assert dst._state == src._state
    assert dst.info().last_block_app_hash == src.info().last_block_app_hash
    assert len(set(sent_requests)) == snap.chunks


async def _restore_over_grpc(server_root: str, client_root: str, src, dst):
    """Restore src's last snapshot into `dst` (an app of server_root's
    package behind its GRPCServer) through client_root's GRPCClient and
    Syncer. Returns (state, commit) of the sync."""
    grpc_srv = importlib.import_module(f"{server_root}.abci.grpc_transport")
    grpc_cli = importlib.import_module(f"{client_root}.abci.grpc_transport")
    syncer_mod = importlib.import_module(f"{client_root}.statesync.syncer")
    chunks_mod = importlib.import_module(f"{client_root}.statesync.chunks")
    snap = src.list_snapshots()[-1]
    provider = DirectStateProvider(src.info().last_block_app_hash,
                                   state="STATE", commit="COMMIT")
    server = grpc_srv.GRPCServer(dst, port=0)
    await server.start()
    client = grpc_cli.GRPCClient(port=server.port)
    await client.connect()

    def request_chunk(peer, height, fmt, index):
        data = src.load_snapshot_chunk(height, fmt, index)
        syncer.add_chunk(chunks_mod.Chunk(height, fmt, index, data, sender=peer.id))

    try:
        syncer = syncer_mod.Syncer(client, provider, request_chunk)
        assert syncer.add_snapshot(FakePeer(), snap)
        return await syncer.sync_any(discovery_time=0.1)
    finally:
        await client.close()
        await server.stop()


def test_syncer_restores_snapshot_over_grpc_external_app():
    """The destination app behind the gRPC transport: offer_snapshot and
    apply_snapshot_chunk cross the wire as awaited client calls."""
    src = _run_source_app()
    dst = KVStoreApplication()
    dst.SNAPSHOT_CHUNK_SIZE = 64
    state, commit = asyncio.run(_restore_over_grpc(PORT_ROOT, PORT_ROOT, src, dst))
    assert state == "STATE" and commit == "COMMIT"
    assert dst._state == src._state
    assert dst.info().last_block_app_hash == src.info().last_block_app_hash


def test_syncer_rejects_corrupted_snapshot_then_no_snapshots():
    src = _run_source_app()
    snap = src.list_snapshots()[-1]
    dst = KVStoreApplication()
    dst.SNAPSHOT_CHUNK_SIZE = 64
    provider = DirectStateProvider(b"\x00" * 32)  # the wrong trusted hash

    def request_chunk(peer, height, fmt, index):
        data = src.load_snapshot_chunk(height, fmt, index)
        syncer.add_chunk(Chunk(height, fmt, index, data, sender=peer.id))

    syncer = Syncer(dst, provider, request_chunk)
    syncer.add_snapshot(FakePeer(), snap)

    async def run():
        # the restored hash is not the trusted one, so the snapshot is
        # rejected; with no other snapshot and no discovery time, it bails
        with pytest.raises(ErrNoSnapshots):
            await syncer.sync_any(discovery_time=0)

    asyncio.run(run())


def test_statesync_over_p2p_bootstrap():
    """A fresh node discovers the snapshot over 0x60, fetches its chunks
    over 0x61 and restores; the app states match."""
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.node_info import NodeInfo
    from tendermint_tpu_torch.p2p.switch import Switch
    from tendermint_tpu_torch.p2p.transport import MultiplexTransport, NetAddress

    src = _run_source_app()
    dst = KVStoreApplication()
    dst.SNAPSHOT_CHUNK_SIZE = 64
    provider = DirectStateProvider(src.info().last_block_app_hash,
                                   state="STATE", commit="COMMIT")

    def build(app, syncer):
        nk = NodeKey.generate()
        transport = None
        sw = None

        def node_info():
            return NodeInfo(
                node_id=nk.id,
                listen_addr=f"127.0.0.1:{transport.listen_port}",
                network="ss-chain",
                channels=sw.channels() if sw else b"",
            )

        transport = MultiplexTransport(nk, node_info)
        sw = Switch(transport)
        reactor = StateSyncReactor(app, syncer)
        sw.add_reactor("statesync", reactor)
        return reactor, nk, transport, sw

    async def run():
        server_r, server_nk, server_t, server_sw = build(src, None)

        def request_chunk(peer, height, fmt, index):
            client_r.request_chunk(peer, height, fmt, index)

        syncer = Syncer(dst, provider, request_chunk)
        client_r, client_nk, client_t, client_sw = build(dst, syncer)
        for t, sw in ((server_t, server_sw), (client_t, client_sw)):
            await t.listen()
            await sw.start()
        await client_sw.dial_peer(
            NetAddress(server_nk.id, "127.0.0.1", server_t.listen_port))
        await asyncio.sleep(0.2)  # the snapshot discovery round trip
        state, commit = await asyncio.wait_for(syncer.sync_any(discovery_time=1.0), 20)
        for sw in (server_sw, client_sw):
            await sw.stop()
        return state, commit

    state, commit = asyncio.run(run())
    assert state == "STATE" and commit == "COMMIT"
    assert dst._state == src._state


# --- the port's own contract ------------------------------------------------------


@pytest.mark.parametrize("server_root,client_root",
                         [(REF_ROOT, PORT_ROOT), (PORT_ROOT, REF_ROOT)],
                         ids=["ref-server-port-client", "port-server-ref-client"])
def test_grpc_interop_with_reference(server_root, client_root):
    """A client of one package restores a snapshot into an app of the other
    behind that package's GRPCServer: the gRPC service name is a wire name
    both packages share, and the payloads cross unchanged. The restored
    state and app hash equal the source's (a source app of the client's
    package)."""
    grpc_cli = importlib.import_module(f"{client_root}.abci.grpc_transport")
    grpc_srv = importlib.import_module(f"{server_root}.abci.grpc_transport")
    assert grpc_cli.SERVICE == grpc_srv.SERVICE == "tendermint_tpu.abci.ABCIApplication"
    src = _run_source_app(
        importlib.import_module(f"{client_root}.abci.kvstore").KVStoreApplication)
    dst = importlib.import_module(f"{server_root}.abci.kvstore").KVStoreApplication()
    dst.SNAPSHOT_CHUNK_SIZE = 64
    state, commit = asyncio.run(_restore_over_grpc(server_root, client_root, src, dst))
    assert state == "STATE" and commit == "COMMIT"
    assert dst._state == src._state
    assert dst.info().last_block_app_hash == src.info().last_block_app_hash
