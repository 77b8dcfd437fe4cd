"""EvidenceReactor — gossip pending evidence over channel 0x38.

Reference: evidence/reactor.go — `EvidenceChannel = 0x38` (:15),
per-peer `broadcastEvidenceRoutine` walking the pool's pending list
(:104-150), Receive → AddEvidence (:80-100); peers sending invalid
evidence are stopped.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs import protoio as pio
from ..libs.log import Logger, nop_logger
from ..p2p.mconn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..p2p.transport import Peer
from ..types.evidence import decode_evidence
from .pool import BenignEvidenceError, EvidencePool

EVIDENCE_CHANNEL = 0x38
_BROADCAST_INTERVAL = 0.5  # reference: peerRetryMessageIntervalMS-ish pacing


def _enc_list(evs: list) -> bytes:
    return b"".join(pio.field_bytes(1, ev.encode()) for ev in evs)


def _dec_list(data: bytes) -> list:
    return [
        decode_evidence(val)
        for num, _wt, val in pio.iter_fields(data)
        if num == 1
    ]


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool, logger: Optional[Logger] = None):
        super().__init__("Evidence")
        self.pool = pool
        self.logger = logger or nop_logger()
        self._peer_tasks: dict[str, asyncio.Task] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=6)]

    async def add_peer(self, peer: Peer) -> None:
        self._peer_tasks[peer.id] = asyncio.create_task(
            self._broadcast_routine(peer)
        )

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        t = self._peer_tasks.pop(peer.id, None)
        if t:
            t.cancel()

    async def on_stop(self) -> None:
        for t in self._peer_tasks.values():
            t.cancel()
        self._peer_tasks.clear()

    async def receive(self, channel_id: int, peer: Peer, msg: bytes) -> None:
        try:
            evs = _dec_list(msg)
        except Exception as e:
            self.logger.error("bad evidence msg", err=str(e))
            await self.switch.stop_peer_for_error(peer, "bad evidence msg")
            return
        for ev in evs:
            try:
                self.pool.add_evidence(ev)
            except BenignEvidenceError as e:
                # we are behind / pruned / the evidence just aged out —
                # never punish a peer for evidence we can't judge (the
                # reference only disconnects on ErrInvalidEvidence,
                # evidence/reactor.go:87-99)
                self.logger.info("cannot verify evidence", err=str(e))
                continue
            except ValueError as e:
                self.logger.info(
                    "peer sent invalid evidence", peer=peer.id, err=str(e)
                )
                await self.switch.stop_peer_for_error(
                    peer, f"invalid evidence: {e}"
                )
                return

    async def _broadcast_routine(self, peer: Peer) -> None:
        """Periodically send our full pending list to the peer; the pool
        dedupes on the receiving side (reference walks a clist with
        per-element waiting; the polling shape is equivalent for the small
        evidence volumes involved)."""
        sent: set[bytes] = set()
        while True:
            try:
                pending = self.pool.pending_evidence()
                fresh = [ev for ev in pending if ev.hash() not in sent]
                if fresh:
                    if peer.try_send(EVIDENCE_CHANNEL, _enc_list(fresh)):
                        sent.update(ev.hash() for ev in fresh)
                await asyncio.sleep(_BROADCAST_INTERVAL)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.logger.error("evidence broadcast error", err=str(e))
                await asyncio.sleep(_BROADCAST_INTERVAL)
