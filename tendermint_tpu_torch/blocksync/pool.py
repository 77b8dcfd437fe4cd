"""BlockPool — parallel block fetching with per-peer accounting.

Reference: blocksync/pool.go:63-560 — a window of in-flight height
requests, each assigned to a peer advertising that height; peers that
stall or send garbage are reported and their requests reassigned.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..libs.flowrate import Monitor
from ..libs.log import Logger, nop_logger
from ..libs.metrics import BlocksyncMetrics, default_metrics
from ..obs import default_tracer
from ..types.block import Block, Commit

REQUEST_WINDOW = 40  # max heights in flight (reference maxPendingRequests)
REQUEST_TIMEOUT = 8.0
# minimum sustained recv rate before a peer with pending requests is
# banned (reference blocksync/pool.go minRecvRate: 7680 B/s) — a
# slow-but-alive peer must not throttle sync indefinitely
MIN_RECV_RATE = 7680.0
# reference bpPeer uses flow.New(time.Second, 40*time.Second): the long
# window keeps multi-second block transfers from decaying a healthy
# peer's rate below the ban threshold between deliveries
RATE_SAMPLE = 1.0
RATE_WINDOW = 40.0


def _peer_monitor() -> Monitor:
    return Monitor(sample_period=RATE_SAMPLE, window=RATE_WINDOW)


@dataclass
class _PoolPeer:
    peer_id: str
    base: int
    height: int
    pending: set[int] = field(default_factory=set)
    timeouts: int = 0
    recv_monitor: Monitor = field(default_factory=_peer_monitor)


@dataclass
class _Requester:
    height: int
    peer_id: str = ""
    block: Optional[Block] = None
    requested_at: float = 0.0


class BlockPool:
    """send_request(peer_id, height) is injected by the reactor;
    on_peer_error(peer_id, reason) reports misbehaving peers."""

    def __init__(
        self,
        start_height: int,
        send_request: Callable[[str, int], bool],
        on_peer_error: Callable[[str, str], None],
        logger: Optional[Logger] = None,
    ):
        self.height = start_height  # next height to process
        self._send_request = send_request
        self._on_peer_error = on_peer_error
        self.metrics = default_metrics(BlocksyncMetrics)
        self.logger = logger or nop_logger()
        self._peers: dict[str, _PoolPeer] = {}
        self._requesters: dict[int, _Requester] = {}
        self._task: Optional[asyncio.Task] = None
        self.started_at = time.monotonic()

    # --- peer bookkeeping -------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        p = self._peers.get(peer_id)
        if p is None:
            self._peers[peer_id] = _PoolPeer(peer_id, base, height)
        else:
            p.base, p.height = base, height

    def remove_peer(self, peer_id: str) -> None:
        p = self._peers.pop(peer_id, None)
        if p is None:
            return
        for h in list(p.pending):
            r = self._requesters.get(h)
            if r is not None and r.block is None:
                r.peer_id = ""
                r.requested_at = 0.0

    def max_peer_height(self) -> int:
        return max((p.height for p in self._peers.values()), default=0)

    def is_caught_up(self) -> bool:
        """Reference IsCaughtUp: some peers known, and our height reached
        the best peer height."""
        if not self._peers:
            return time.monotonic() - self.started_at > 5.0
        return self.height >= self.max_peer_height()

    def num_pending(self) -> int:
        return sum(1 for r in self._requesters.values() if r.block is None)

    # --- request scheduling ----------------------------------------------

    def check_peer_rates(self) -> None:
        """Ban peers with pending requests whose sustained recv rate fell
        below MIN_RECV_RATE (reference removeTimedoutPeers, pool.go:522).
        cur_rate stays exactly 0.0 until the first block arrives, so a
        never-sent peer is left to the request-timeout path."""
        for p in list(self._peers.values()):
            if not p.pending:
                continue
            rate = p.recv_monitor.status().cur_rate
            if rate != 0.0 and rate < MIN_RECV_RATE:
                self._on_peer_error(
                    p.peer_id, "peer is not sending us data fast enough"
                )
                self.remove_peer(p.peer_id)

    def make_requests(self) -> None:
        """Ensure up to REQUEST_WINDOW requesters exist and are assigned."""
        self.check_peer_rates()
        target = self.max_peer_height()
        for h in range(self.height, min(self.height + REQUEST_WINDOW, target + 1)):
            if h not in self._requesters:
                self._requesters[h] = _Requester(h)
        now = time.monotonic()
        for r in self._requesters.values():
            if r.block is not None:
                continue
            if r.peer_id and now - r.requested_at < REQUEST_TIMEOUT:
                continue
            if r.peer_id:  # timed out
                self._timeout_peer(r.peer_id, r.height)
            peer = self._pick_peer(r.height)
            if peer is None:
                continue
            if self._send_request(peer.peer_id, r.height):
                r.peer_id = peer.peer_id
                r.requested_at = now
                if not peer.pending:
                    # fresh busy period: restart the rate window so a
                    # stale decayed rate from an idle stretch can't
                    # instantly trip the min-rate ban
                    peer.recv_monitor = _peer_monitor()
                peer.pending.add(r.height)

    def _pick_peer(self, height: int) -> Optional[_PoolPeer]:
        candidates = [
            p
            for p in self._peers.values()
            if p.base <= height <= p.height and len(p.pending) < 20
        ]
        if not candidates:
            return None
        return candidates[secrets.randbelow(len(candidates))]

    def _timeout_peer(self, peer_id: str, height: int) -> None:
        p = self._peers.get(peer_id)
        if p is not None:
            p.pending.discard(height)
            p.timeouts += 1
            self.metrics.request_timeouts.inc()
            default_tracer().event(
                "blocksync.request_timeout", height=height,
                peer=peer_id[:12],
            )
            if p.timeouts >= 3:
                self.metrics.peers_banned.inc()
                self._on_peer_error(peer_id, "blocksync request timeouts")
                self.remove_peer(peer_id)

    # --- block ingestion --------------------------------------------------

    def add_block(self, peer_id: str, block: Block, size: int = 0) -> bool:
        h = block.header.height
        r = self._requesters.get(h)
        if r is None or r.block is not None:
            return False
        if r.peer_id and r.peer_id != peer_id:
            return False  # unsolicited from a different peer
        r.block = block
        r.peer_id = peer_id
        if r.requested_at:
            # request -> response latency for the assigned requester
            latency = time.monotonic() - r.requested_at
            self.metrics.block_response_seconds.observe(latency)
            default_tracer().event(
                "blocksync.block_received",
                height=h,
                peer=peer_id[:12],
                latency_ms=round(latency * 1e3, 2),
                bytes=size,
            )
        p = self._peers.get(peer_id)
        if p is not None:
            p.pending.discard(h)
            p.recv_monitor.update(size)  # peer-quality rate accounting
        return True

    def no_block(self, peer_id: str, height: int) -> None:
        r = self._requesters.get(height)
        if r is not None and r.peer_id == peer_id and r.block is None:
            r.peer_id = ""
            r.requested_at = 0.0
        p = self._peers.get(peer_id)
        if p is not None:
            p.pending.discard(height)

    def peek_two_blocks(self) -> tuple[Optional[Block], Optional[Block]]:
        first = self._requesters.get(self.height)
        second = self._requesters.get(self.height + 1)
        return (
            first.block if first else None,
            second.block if second else None,
        )

    def peek_window(self, max_blocks: int) -> list[tuple]:
        """[(block, successor_last_commit, successor_last_qc)] for
        consecutive ready blocks from `height` — each block paired with
        the commit that verifies it (the multi-block batched-verify
        window, SURVEY.md §3.4) and, on QC-capable chains, the
        successor's QuorumCertificate (None on legacy blocks). Stops at
        the first gap or successor without a last commit."""
        out = []
        h = self.height
        while len(out) < max_blocks:
            r = self._requesters.get(h)
            nxt = self._requesters.get(h + 1)
            if r is None or r.block is None or nxt is None or nxt.block is None:
                break
            if nxt.block.last_commit is None:
                break  # undecodable/hostile successor; per-block path rejects
            out.append((
                r.block,
                nxt.block.last_commit,
                getattr(nxt.block, "last_qc", None),
            ))
            h += 1
        return out

    def pop_request(self) -> None:
        self._requesters.pop(self.height, None)
        self.height += 1

    def redo_request(self, height: int, reason: str) -> None:
        """First block failed verification: ditch both blocks and punish
        the senders (reference RedoRequest)."""
        for h in (height, height + 1):
            r = self._requesters.get(h)
            if r is not None:
                if r.peer_id:
                    self._on_peer_error(r.peer_id, reason)
                    self.remove_peer(r.peer_id)
                self._requesters[h] = _Requester(h)
