"""StateSync reactor — snapshot/chunk exchange over channels 0x60/0x61.

Reference: statesync/reactor.go. Serves snapshots from the local app
(ListSnapshots/LoadSnapshotChunk) to bootstrapping peers and feeds
discovered snapshots + received chunks into an active Syncer.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..abci.types import Snapshot
from ..libs import protoio as pio
from ..libs.log import Logger, nop_logger
from ..p2p.mconn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..p2p.transport import Peer
from .chunks import Chunk
from .syncer import Syncer

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
RECENT_SNAPSHOTS = 10  # reference reactor.go:24

_SNAPSHOTS_REQ = 1
_SNAPSHOTS_RESP = 2
_CHUNK_REQ = 3
_CHUNK_RESP = 4


def _enc(kind: int, **f) -> bytes:
    out = pio.field_varint(1, kind)
    for num, key in (
        (2, "height"),
        (3, "format"),
        (4, "chunks"),
        (7, "index"),
    ):
        if key in f:
            out += pio.field_varint(num, f[key])
    for num, key in ((5, "hash"), (6, "metadata"), (8, "chunk")):
        if key in f:
            out += pio.field_bytes(num, f[key])
    if f.get("missing"):
        out += pio.field_varint(9, 1)
    return out


def _dec(data: bytes) -> dict:
    out = {}
    names = {
        1: "kind", 2: "height", 3: "format", 4: "chunks",
        5: "hash", 6: "metadata", 7: "index", 8: "chunk", 9: "missing",
    }
    for num, _wt, val in pio.iter_fields(data):
        if num in names:
            out[names[num]] = val
    return out


class StateSyncReactor(Reactor):
    def __init__(
        self,
        app_snapshot_conn,
        syncer: Optional[Syncer] = None,
        logger: Optional[Logger] = None,
    ):
        super().__init__("StateSync")
        self._app = app_snapshot_conn
        self.syncer = syncer  # set while a sync is in progress
        self.logger = logger or nop_logger()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(id=SNAPSHOT_CHANNEL, priority=5),
            ChannelDescriptor(id=CHUNK_CHANNEL, priority=3),
        ]

    async def add_peer(self, peer: Peer) -> None:
        # ask every new peer for its snapshots (reference reactor.go AddPeer)
        if self.syncer is not None:
            peer.try_send(SNAPSHOT_CHANNEL, _enc(_SNAPSHOTS_REQ))

    def request_chunk(self, peer, height: int, format: int, index: int) -> None:
        """The syncer's chunk-request hook."""
        peer.try_send(
            CHUNK_CHANNEL,
            _enc(_CHUNK_REQ, height=height, format=format, index=index),
        )

    async def receive(self, channel_id: int, peer: Peer, msg: bytes) -> None:
        try:
            f = _dec(msg)
            kind = f.get("kind", 0)
        except Exception as e:
            self.logger.error("bad statesync msg", err=str(e))
            await self.switch.stop_peer_for_error(peer, "bad statesync msg")
            return
        if channel_id == SNAPSHOT_CHANNEL:
            if kind == _SNAPSHOTS_REQ:
                await self._serve_snapshots(peer)
            elif kind == _SNAPSHOTS_RESP and self.syncer is not None:
                snap = Snapshot(
                    height=f.get("height", 0),
                    format=f.get("format", 0),
                    chunks=f.get("chunks", 0),
                    hash=f.get("hash", b""),
                    metadata=f.get("metadata", b""),
                )
                self.syncer.add_snapshot(peer, snap)
        elif channel_id == CHUNK_CHANNEL:
            if kind == _CHUNK_REQ:
                await self._serve_chunk(peer, f)
            elif kind == _CHUNK_RESP and self.syncer is not None:
                if not f.get("missing"):
                    self.syncer.add_chunk(
                        Chunk(
                            height=f.get("height", 0),
                            format=f.get("format", 0),
                            index=f.get("index", 0),
                            chunk=f.get("chunk", b""),
                            sender=peer.id,
                        )
                    )

    async def _serve_snapshots(self, peer: Peer) -> None:
        """ListSnapshots from the app, newest first (reference :150-180)."""
        res = self._app.list_snapshots()
        if asyncio.iscoroutine(res):
            res = await res
        snaps = sorted(res, key=lambda s: s.height, reverse=True)
        for s in snaps[:RECENT_SNAPSHOTS]:
            peer.try_send(
                SNAPSHOT_CHANNEL,
                _enc(
                    _SNAPSHOTS_RESP,
                    height=s.height,
                    format=s.format,
                    chunks=s.chunks,
                    hash=s.hash,
                    metadata=s.metadata,
                ),
            )

    async def _serve_chunk(self, peer: Peer, f: dict) -> None:
        res = self._app.load_snapshot_chunk(
            f.get("height", 0), f.get("format", 0), f.get("index", 0)
        )
        if asyncio.iscoroutine(res):
            res = await res
        if res is None:
            peer.try_send(
                CHUNK_CHANNEL,
                _enc(
                    _CHUNK_RESP,
                    height=f.get("height", 0),
                    format=f.get("format", 0),
                    index=f.get("index", 0),
                    missing=True,
                ),
            )
            return
        peer.try_send(
            CHUNK_CHANNEL,
            _enc(
                _CHUNK_RESP,
                height=f.get("height", 0),
                format=f.get("format", 0),
                index=f.get("index", 0),
                chunk=res,
            ),
        )
