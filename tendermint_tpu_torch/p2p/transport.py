"""MultiplexTransport + Peer.

Reference: p2p/transport.go (dial/accept + upgrade: SecretConnection then
NodeInfo exchange) and p2p/peer.go (the Peer wrapper the reactors see).
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from ..crypto import ed25519
from ..libs.log import Logger, nop_logger
from .key import NodeKey, id_from_pubkey
from .mconn import ChannelDescriptor, MConnection
from .node_info import NodeInfo
from .secret_connection import SecretConnection


@dataclass
class NetAddress:
    id: str  # expected node id ("" = accept any)
    host: str
    port: int

    @classmethod
    def parse(cls, s: str) -> "NetAddress":
        """id@host:port or host:port."""
        node_id = ""
        if "@" in s:
            node_id, s = s.split("@", 1)
        host, port = s.rsplit(":", 1)
        return cls(node_id, host, int(port))

    def __str__(self) -> str:
        prefix = f"{self.id}@" if self.id else ""
        return f"{prefix}{self.host}:{self.port}"


class Peer:
    """A connected, handshaked peer (reference p2p/peer.go)."""

    def __init__(
        self,
        node_info: NodeInfo,
        sconn: SecretConnection,
        mconn: MConnection,
        outbound: bool,
        socket_addr: NetAddress,
    ):
        self.node_info = node_info
        self.sconn = sconn
        self.mconn = mconn
        self.outbound = outbound
        self.socket_addr = socket_addr
        self.data: dict = {}  # reactor scratch space (reference peer.Set)

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def send(self, channel_id: int, msg: bytes) -> bool:
        return self.mconn.send(channel_id, msg)

    try_send = send

    def queue_headroom(self, channel_id: int) -> int:
        """Free send-queue slots on one channel (0 = full; see
        MConnection.queue_headroom)."""
        return self.mconn.queue_headroom(channel_id)

    # --- clock estimate (timestamped ping/pong, mconn.py) ----------------

    @property
    def clock_offset_s(self):
        """Estimated peer wall-clock offset (peer minus us), or None
        before the first ping/pong sample."""
        return self.mconn.clock_offset_s

    @property
    def rtt_s(self):
        return self.mconn.rtt_s

    def clock_info(self) -> dict:
        """The per-peer entry `dump_traces` exports for cluster-trace
        offset estimation (obs/cluster.py)."""
        return {
            "offset_s": self.mconn.clock_offset_s,
            "rtt_s": self.mconn.rtt_s,
            "min_rtt_s": self.mconn.min_rtt_s,
            "min_rtt_offset_s": self.mconn.min_rtt_offset_s,
            "samples": self.mconn.clock_samples,
        }

    async def stop(self) -> None:
        await self.mconn.stop()

    def __repr__(self) -> str:
        arrow = "out" if self.outbound else "in"
        return f"Peer{{{self.id[:12]} {arrow} {self.socket_addr}}}"


class MultiplexTransport:
    def __init__(
        self,
        node_key: NodeKey,
        node_info_fn: Callable[[], NodeInfo],
        logger: Optional[Logger] = None,
        conn_wrapper: Optional[Callable] = None,
    ):
        self._node_key = node_key
        self._node_info_fn = node_info_fn
        self.logger = logger or nop_logger()
        self._server: Optional[asyncio.AbstractServer] = None
        self._accepted: asyncio.Queue = asyncio.Queue()
        self.listen_port = 0
        # (peer_id, conn) -> conn: interposition seam for link shaping —
        # chaos wraps every upgraded connection here so ALL reactor
        # traffic is shaped without reactor changes (chaos/link.py)
        self.conn_wrapper = conn_wrapper

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._on_accept, host, port)
        self.listen_port = self._server.sockets[0].getsockname()[1]

    async def _on_accept(self, reader, writer) -> None:
        try:
            upgraded = await asyncio.wait_for(
                self._upgrade(reader, writer), timeout=10
            )
            await self._accepted.put(upgraded)
        except Exception as e:
            self.logger.info("inbound upgrade failed", err=repr(e))
            writer.close()

    async def accept(self) -> tuple[NodeInfo, SecretConnection, NetAddress]:
        return await self._accepted.get()

    async def dial(
        self, addr: NetAddress
    ) -> tuple[NodeInfo, SecretConnection, NetAddress]:
        reader, writer = await asyncio.open_connection(addr.host, addr.port)
        info, sconn, _ = await asyncio.wait_for(
            self._upgrade(reader, writer), timeout=10
        )
        if addr.id and info.node_id != addr.id:
            sconn.close()
            raise ValueError(
                f"dialed {addr.id} but authenticated {info.node_id}"
            )
        return info, sconn, addr

    async def _upgrade(self, reader, writer):
        """SecretConnection handshake, identity check, NodeInfo exchange."""
        sconn = await SecretConnection.make(
            reader, writer, self._node_key.priv_key
        )
        # exchange NodeInfo over the encrypted link (length-prefixed)
        my_info = self._node_info_fn().encode()
        await sconn.write(struct.pack("<I", len(my_info)) + my_info)
        (n,) = struct.unpack("<I", await sconn.read_exactly(4))
        if n > 1 << 16:
            raise ValueError("node info too large")
        their_info = NodeInfo.decode(await sconn.read_exactly(n))
        their_info.validate_basic()
        # the authenticated key must match the claimed node id
        auth_id = id_from_pubkey(sconn.remote_pubkey)
        if auth_id != their_info.node_id:
            raise ValueError("node id does not match authenticated key")
        peername = writer.get_extra_info("peername") or ("?", 0)
        conn = sconn
        if self.conn_wrapper is not None:
            conn = self.conn_wrapper(their_info.node_id, sconn)
        return (
            their_info,
            conn,
            NetAddress(their_info.node_id, peername[0], peername[1]),
        )

    async def close(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
