"""PEX — peer exchange reactor over the hashed-bucket address book.

Reference: p2p/pex/pex_reactor.go (+ seed-mode crawl). The address book
itself lives in p2p/addrbook.py — 256+64 hashed buckets with
eviction/promotion, the reference's eclipse-resistance structure
(addrbook.go:1-947), not a flat scored table.
"""

from __future__ import annotations

import asyncio
import secrets
from typing import Optional

from ..libs import protoio as pio
from ..libs.log import nop_logger
from .addrbook import AddrBook, KnownAddress  # noqa: F401 (re-export)
from .mconn import ChannelDescriptor
from .switch import Reactor
from .transport import NetAddress, Peer

PEX_CHANNEL = 0x00


# --- pex reactor ----------------------------------------------------------

_MSG_REQUEST = 1
_MSG_ADDRS = 2


def _encode_addrs(addrs: list[NetAddress]) -> bytes:
    return pio.field_varint(1, _MSG_ADDRS) + b"".join(
        pio.field_bytes(2, str(a).encode()) for a in addrs
    )


def _encode_request() -> bytes:
    return pio.field_varint(1, _MSG_REQUEST)


class PEXReactor(Reactor):
    """Requests addresses from peers, serves its own, and keeps dialing
    until enough outbound connections exist (reference pex_reactor.go).
    seed_mode: accept, exchange addresses, disconnect (crawler)."""

    def __init__(
        self,
        book: AddrBook,
        target_outbound: int = 10,
        seed_mode: bool = False,
        logger=None,
    ):
        super().__init__("pex")
        self.book = book
        self.target_outbound = target_outbound
        self.seed_mode = seed_mode
        self.logger = logger or nop_logger()
        self._requested: set[str] = set()
        self._ensure_task: Optional[asyncio.Task] = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1)]

    async def on_start(self) -> None:
        self._ensure_task = asyncio.get_running_loop().create_task(
            self._ensure_peers_routine()
        )

    async def on_stop(self) -> None:
        if self._ensure_task:
            self._ensure_task.cancel()
        self.book.save()

    async def add_peer(self, peer: Peer) -> None:
        # inbound peers' self-reported listen addr goes into the book
        if peer.node_info.listen_addr:
            try:
                addr = NetAddress.parse(
                    f"{peer.id}@{peer.node_info.listen_addr}"
                )
                self.book.add_address(addr)
            except ValueError:
                pass
        if peer.outbound:
            self.book.mark_good(peer.id)
        elif peer.id not in self._requested:
            self._requested.add(peer.id)
            peer.send(PEX_CHANNEL, _encode_request())

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self._requested.discard(peer.id)

    async def receive(self, channel_id: int, peer: Peer, msg: bytes) -> None:
        f = pio.decode_fields(msg)
        kind = f.get(1, [0])[0]
        if kind == _MSG_REQUEST:
            peer.send(
                PEX_CHANNEL, _encode_addrs(self.book.get_selection())
            )
            if self.seed_mode and not peer.outbound:
                # seeds disconnect after serving addresses
                await asyncio.sleep(0.1)
                await self.switch.stop_peer_gracefully(peer)
        elif kind == _MSG_ADDRS:
            try:
                src_addr = NetAddress.parse(
                    f"{peer.id}@{peer.node_info.listen_addr}"
                ) if peer.node_info.listen_addr else None
            except ValueError:
                src_addr = None
            for raw in f.get(2, []):
                try:
                    self.book.add_address(
                        NetAddress.parse(raw.decode()), src=src_addr
                    )
                except (ValueError, UnicodeDecodeError):
                    await self.switch.stop_peer_for_error(
                        peer, "malformed pex address"
                    )
                    return

    async def _ensure_peers_routine(self) -> None:
        while True:
            try:
                await self._ensure_peers()
            except Exception as e:
                self.logger.info("ensure peers failed", err=repr(e))
            await asyncio.sleep(1.0)

    async def _ensure_peers(self) -> None:
        sw = self.switch
        if sw is None or not sw.is_running:
            return
        out = sum(1 for p in sw.peers.values() if p.outbound)
        if out >= self.target_outbound:
            return
        exclude = set(sw.peers.keys()) | sw.dialing | {self.book._our_id}
        addr = self.book.pick_address(exclude)
        if addr is None:
            # ask a random peer for more addresses
            peers = list(sw.peers.values())
            if peers:
                peers[secrets.randbelow(len(peers))].send(
                    PEX_CHANNEL, _encode_request()
                )
            return
        self.book.mark_attempt(addr.id)
        try:
            peer = await sw.dial_peer(addr)
            if peer is not None:
                self.book.mark_good(addr.id)
        except Exception:
            pass
