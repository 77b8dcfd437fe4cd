"""Switch — peer lifecycle + reactor multiplexing.

Reference: p2p/switch.go:69 (Switch), p2p/base_reactor.go (Reactor iface).
Reactors register channel descriptors; the switch owns peers and routes
each received message to the reactor that claimed its channel.
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable, Optional

from ..libs.events import EventSwitch
from ..libs.log import Logger, nop_logger
from ..libs.service import Service
from .mconn import ChannelDescriptor, MConnection
from .node_info import NodeInfo
from .transport import MultiplexTransport, NetAddress, Peer

# redial schedule (reference switch.go reconnectAttempts): FULL-jitter
# exponential backoff — sleep ~ U(0, min(CAP, BASE·2ⁿ)). The seed's fixed
# 0.2s·2ⁿ schedule redialed simultaneously-restarted nodes in lockstep
# (thundering herd); jitter decorrelates them. Exhausting the attempt cap
# fires a terminal "gave up" event; non-persistent dials then stop, while
# persistent peers drop to a slow lane (jittered sleeps at the cap) so an
# extended outage never permanently degrades the mesh.
DIAL_BACKOFF_BASE = 0.2
DIAL_BACKOFF_CAP = 10.0
MAX_DIAL_ATTEMPTS = 40

EVENT_PEER_DIAL_GAVE_UP = "peer_dial_gave_up"


class Reactor:
    """Base reactor (reference p2p/base_reactor.go BaseReactor)."""

    def __init__(self, name: str):
        self.name = name
        self.switch: Optional["Switch"] = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    async def add_peer(self, peer: Peer) -> None:
        pass

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        pass

    async def receive(self, channel_id: int, peer: Peer, msg: bytes) -> None:
        pass

    async def on_start(self) -> None:
        pass

    async def on_stop(self) -> None:
        pass


class Switch(Service):
    def __init__(
        self,
        transport: MultiplexTransport,
        logger: Optional[Logger] = None,
        max_peers: int = 50,
        send_rate: int = 0,
        recv_rate: int = 0,
        max_dial_attempts: int = MAX_DIAL_ATTEMPTS,
        dial_rng: Optional[random.Random] = None,
        ping_interval: float = 10.0,
    ):
        super().__init__("p2p-switch", logger)
        self.transport = transport
        self.reactors: dict[str, Reactor] = {}
        self._channel_to_reactor: dict[int, Reactor] = {}
        self.peers: dict[str, Peer] = {}
        self.max_peers = max_peers
        # per-connection byte-rate caps (reference MConnConfig SendRate/
        # RecvRate, p2p/conn/connection.go:78-210); 0 = unthrottled —
        # nodes pass config.p2p values, tests default to unlimited
        self.send_rate = send_rate
        self.recv_rate = recv_rate
        # keepalive cadence, which is also the clock-offset sampling rate
        # (tests shrink it so offset EWMAs converge inside a short run)
        self.ping_interval = ping_interval
        self.dialing: set[str] = set()
        self._persistent_addrs: list[NetAddress] = []
        # addresses with a live _dial_with_retry loop (including its
        # backoff sleeps, which `dialing` does not cover) — keeps error
        # redials and heal()-triggered redial_persistent() from stacking
        # concurrent retry loops for one address
        self._retrying: set[str] = set()
        self.max_dial_attempts = max_dial_attempts
        # seedable so chaos scenarios replay the exact redial schedule
        self.dial_rng = dial_rng or random.Random()
        # peer lifecycle events (EVENT_PEER_DIAL_GAVE_UP fires with the
        # NetAddress after the redial budget is exhausted)
        self.events = EventSwitch()
        # chaos seam: predicate(peer_id) -> bool consulted before a peer
        # is added; partitions/blackholes install one (chaos/network.py)
        self.conn_gate: Optional[Callable[[str], bool]] = None
        self._stopping = False

    def add_reactor(self, name: str, reactor: Reactor) -> None:
        for ch in reactor.get_channels():
            if ch.id in self._channel_to_reactor:
                raise ValueError(f"channel {ch.id:#x} already claimed")
            self._channel_to_reactor[ch.id] = reactor
        reactor.switch = self
        self.reactors[name] = reactor

    def channels(self) -> bytes:
        return bytes(sorted(self._channel_to_reactor.keys()))

    # --- lifecycle --------------------------------------------------------

    async def on_start(self) -> None:
        self._stopping = False
        for r in self.reactors.values():
            await r.on_start()
        self.spawn(self._accept_routine(), "accept")

    async def on_stop(self) -> None:
        # accept and redial routines run until on_stop returns: a peer
        # they add from here on would outlive the loop below and hold
        # transport.close() for good (the listener's wait_closed waits
        # for every accepted connection), so _add_peer refuses it
        self._stopping = True
        for peer in list(self.peers.values()):
            await self._stop_and_remove(peer, "switch stopping")
        for r in self.reactors.values():
            await r.on_stop()
        await self.transport.close()

    async def _accept_routine(self) -> None:
        while True:
            info, sconn, addr = await self.transport.accept()
            if len(self.peers) >= self.max_peers:
                sconn.close()
                continue
            try:
                await self._add_peer(info, sconn, addr, outbound=False)
            except Exception as e:
                self.logger.info("failed to add inbound peer", err=repr(e))
                sconn.close()

    # --- dialing ----------------------------------------------------------

    async def dial_peer(self, addr: NetAddress) -> Optional[Peer]:
        if addr.id and (addr.id in self.peers or addr.id in self.dialing):
            return None
        self.dialing.add(addr.id)
        try:
            info, sconn, addr = await self.transport.dial(addr)
            return await self._add_peer(info, sconn, addr, outbound=True)
        finally:
            self.dialing.discard(addr.id)

    def dial_peers_async(self, addrs: list[NetAddress], persistent: bool = True) -> None:
        if persistent:
            self._persistent_addrs.extend(addrs)
        for addr in addrs:
            self.spawn(
                self._dial_with_retry(addr, persistent=persistent),
                f"dial/{addr}",
            )

    async def _dial_with_retry(
        self,
        addr: NetAddress,
        initial_backoff: bool = False,
        persistent: bool = False,
    ) -> None:
        key = addr.id or str(addr)
        if key in self._retrying:
            return
        self._retrying.add(key)
        try:
            await self._dial_with_retry_locked(addr, initial_backoff, persistent)
        finally:
            self._retrying.discard(key)

    async def _dial_with_retry_locked(
        self, addr: NetAddress, initial_backoff: bool, persistent: bool
    ) -> None:
        attempt = 0
        if initial_backoff:
            # error-path redials: the dial itself may SUCCEED and then be
            # reset by the remote (e.g. its conn_gate rejects us), which
            # never reaches the failure backoff below — desynchronize the
            # first attempt so such loops can't spin at full speed
            await asyncio.sleep(
                self.dial_rng.uniform(0.0, 2 * DIAL_BACKOFF_BASE)
            )
        while self.is_running:
            try:
                peer = await self.dial_peer(addr)
                if peer is not None or (addr.id and addr.id in self.peers):
                    return
            except Exception as e:
                self.logger.info("dial failed", addr=str(addr), err=repr(e))
            attempt += 1
            if attempt == self.max_dial_attempts:
                self.logger.info(
                    "giving up on peer",
                    addr=str(addr),
                    attempts=attempt,
                    persistent=persistent,
                )
                self.events.fire_event(EVENT_PEER_DIAL_GAVE_UP, addr)
                # non-persistent dials are done; persistent peers drop to
                # a slow lane (jittered sleeps at the cap) instead of
                # being abandoned forever — a peer down for 10 minutes
                # must not permanently degrade the mesh
                if not persistent:
                    return
            ceiling = min(
                DIAL_BACKOFF_CAP, DIAL_BACKOFF_BASE * (2 ** min(attempt, 16))
            )
            await asyncio.sleep(self.dial_rng.uniform(0.0, ceiling))

    def redial_persistent(self) -> None:
        """Re-kick the retry loop for persistent peers not currently
        connected, dialing, or already inside a retry loop — after a
        partition heals, peers without a live retry loop (e.g. dropped
        gracefully by the partition enforcer) reconnect through here."""
        for addr in self._persistent_addrs:
            if addr.id and (addr.id in self.peers or addr.id in self.dialing):
                continue
            if (addr.id or str(addr)) in self._retrying:
                continue
            self.spawn(
                self._dial_with_retry(addr, persistent=True),
                f"redial/{addr}",
            )

    # --- peers ------------------------------------------------------------

    async def _add_peer(
        self, info: NodeInfo, sconn, addr: NetAddress, outbound: bool
    ) -> Peer:
        my_info = self.transport._node_info_fn()
        my_info.compatible_with(info)
        if self.conn_gate is not None and not self.conn_gate(info.node_id):
            sconn.close()
            raise ValueError(f"connection to {info.node_id[:12]} blackholed")
        if info.node_id == my_info.node_id:
            sconn.close()
            raise ValueError("connected to self")
        existing = self.peers.get(info.node_id)
        if existing is not None:
            # simultaneous-dial crossing: both ends dialed each other at
            # once. If each side kept its own outbound conn, each would
            # close the conn the OTHER side kept — both die and the
            # instant redial re-crosses, a reconnect livelock (seen after
            # partition heal, when every node redials at the same tick).
            # Tie-break so both sides keep the SAME conn: the one dialed
            # by the lower node id survives.
            lower_is_me = my_info.node_id < info.node_id
            new_survives = outbound == lower_is_me
            existing_survives = existing.outbound == lower_is_me
            if existing_survives or not new_survives:
                sconn.close()
                raise ValueError("duplicate peer")
            await self._stop_and_remove(existing, "crossed dial: replaced")
            if info.node_id in self.peers:
                # another add for this id completed during the await —
                # inserting now would silently overwrite a live peer and
                # leak it as a running ghost in every reactor
                sconn.close()
                raise ValueError("duplicate peer")
        if self._stopping:
            sconn.close()
            raise ValueError("switch stopping")

        descs = [
            d
            for r in self.reactors.values()
            for d in r.get_channels()
        ]
        peer_holder: list[Peer] = []

        async def on_receive(ch_id: int, msg: bytes) -> None:
            reactor = self._channel_to_reactor.get(ch_id)
            if reactor is not None and peer_holder:
                await reactor.receive(ch_id, peer_holder[0], msg)

        async def on_error(err: Exception) -> None:
            if peer_holder:
                await self.stop_peer_for_error(peer_holder[0], repr(err))

        mconn = MConnection(
            sconn,
            descs,
            on_receive,
            on_error,
            ping_interval=self.ping_interval,
            send_rate=self.send_rate,
            recv_rate=self.recv_rate,
            peer_id=info.node_id,
        )
        peer = Peer(info, sconn, mconn, outbound, addr)
        peer_holder.append(peer)
        self.peers[peer.id] = peer
        mconn.metrics.peers.set(len(self.peers))
        mconn.start()
        for r in self.reactors.values():
            await r.add_peer(peer)
        self.logger.info("added peer", peer=str(peer))
        return peer

    async def stop_peer_for_error(self, peer: Peer, reason: str) -> None:
        """StopPeerForError (reference :opped by every reactor on bad
        messages); persistent peers get redialed."""
        # identity check, not membership: after a crossed-dial replacement
        # the dead conn's error callback fires while self.peers[id] maps
        # to the REPLACEMENT peer, which must stay up
        if self.peers.get(peer.id) is not peer:
            return
        self.logger.info("stopping peer", peer=str(peer), reason=reason)
        await self._stop_and_remove(peer, reason)
        for addr in self._persistent_addrs:
            if addr.id == peer.id and self.is_running:
                self.spawn(
                    self._dial_with_retry(
                        addr, initial_backoff=True, persistent=True
                    ),
                    f"redial/{addr}",
                )
                break

    async def stop_peer_gracefully(self, peer: Peer) -> None:
        await self._stop_and_remove(peer, "graceful stop")

    async def _stop_and_remove(self, peer: Peer, reason: str) -> None:
        if self.peers.get(peer.id) is peer:
            del self.peers[peer.id]
            peer.mconn.metrics.peers.set(len(self.peers))
        await peer.stop()
        for r in self.reactors.values():
            await r.remove_peer(peer, reason)

    def peer_clock_table(self) -> dict:
        """Per-peer NTP offset/RTT estimates (timestamped ping/pong,
        mconn.py), keyed by peer node id; peers without a complete
        sample are omitted. The `peer_clock` section of `dump_traces`,
        shared by the RPC core and the in-proc test harness so both dump
        shapes stay identical."""
        out = {}
        for pid, p in self.peers.items():
            info = p.clock_info()
            if info.get("samples"):
                out[pid] = info
        return out

    def broadcast(self, channel_id: int, msg: bytes) -> None:
        """Best-effort send to every peer (reference Switch.Broadcast :264)."""
        for peer in list(self.peers.values()):
            peer.send(channel_id, msg)

    def num_peers(self) -> int:
        return len(self.peers)
