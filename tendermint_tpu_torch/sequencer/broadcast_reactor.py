"""BlockBroadcastReactor — sequencer-mode block gossip + sync catchup.

Reference: sequencer/broadcast_reactor.go. Two channels:
- 0x50 broadcast (signature-verified BlockV2 gossip, :24-25),
- 0x51 sync (BlockRequest / BlockResponseV2 / NoBlockResponse, no
  signature verification — blocks fetched by request are trusted via the
  hash-linked chain, :26).

Shape: the sequencer node drains StateV2's broadcast queue and gossips;
follower nodes run an apply/sync routine. The reference (and the first
port) drove that routine on fixed 10-second polling ticks; this plane is
EVENT-DRIVEN (PERF_ANALYSIS §17):

- apply/sync wake on block receipt, pending-cache insertion, peer
  status/arrival/departure and NoBlockResponse — the configured
  apply/sync intervals survive only as a fallback tick;
- catchup keeps a window of up to `catchup_window` missing-height
  requests in flight (each response refills the window) instead of one
  thresholded burst per 10 s cycle, and `requested_heights` entries
  expire on NoBlockResponse / peer departure / TTL instead of
  accumulating for the life of the node;
- fan-out is encode-once (BlockV2.encode memoization) and
  backpressure-aware: a peer whose 0x50 send queue is full is skipped
  and revisited by a drain task instead of stalling the broadcast loop
  behind the slowest subscriber;
- follower-side ECDSA signature checks ride SequencerVerifyBatcher:
  off the event loop, bursts coalesced into single fn-lane rounds
  through parallel/scheduler under the `sequencer` class.
"""

from __future__ import annotations

import asyncio
import random
import time
from collections import OrderedDict, deque
from typing import Optional

from ..libs import protoio as pio
from ..libs.log import Logger
from ..libs.metrics import SequencerMetrics, default_metrics
from ..obs import default_tracer
from ..p2p.mconn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..p2p.transport import Peer
from ..types.block_v2 import BlockV2
from .caches import (
    MAX_PENDING_HEIGHT_BEHIND,
    BlockRingBuffer,
    HashSet,
    PeerHashSet,
    PendingBlockCache,
)
from .signer import ErrInvalidSignature, SequencerVerifier
from .state_v2 import StateV2
from .verify import SequencerVerifyBatcher

BLOCK_BROADCAST_CHANNEL = 0x50
SEQUENCER_SYNC_CHANNEL = 0x51

SMALL_GAP_THRESHOLD = 20
RECENT_BLOCKS_CAPACITY = 1000
SEEN_BLOCKS_CAPACITY = 2000
PEER_SENT_CAPACITY = 500
APPLY_INTERVAL = 10.0
SYNC_INTERVAL = 10.0
# missing-height requests kept in flight during catchup (the window
# refills as responses land; [sequencer] catchup_window)
CATCHUP_WINDOW = 64
# deferred fan-out entries held per congested peer before the oldest
# drop (a dropped subscriber catches up on the 0x51 sync channel)
FANOUT_PENDING_CAP = 64
# cadence of the deferred-fan-out drain pass (only runs while some
# peer's 0x50 queue was full)
FANOUT_REVISIT_INTERVAL = 0.05
# receipt-timestamp map bound (apply-latency attribution)
_RECV_TIMES_CAP = 4096

# message kinds (field 1)
_BLOCK_RESPONSE_V2 = 1
_BLOCK_REQUEST = 2
_NO_BLOCK_RESPONSE = 3
_STATUS = 4  # height advertisement (the reference reuses blocksync's pool)


def _enc(kind: int, height: int = 0, block: Optional[BlockV2] = None) -> bytes:
    out = pio.field_varint(1, kind)
    if height:
        out += pio.field_varint(2, height)
    if block is not None:
        out += pio.field_bytes(3, block.encode())
    return out


def _dec(data: bytes) -> tuple[int, int, Optional[BlockV2]]:
    kind = height = 0
    block = None
    for num, _wt, val in pio.iter_fields(data):
        if num == 1:
            kind = val
        elif num == 2:
            height = val
        elif num == 3:
            block = BlockV2.decode(val)
    return kind, height, block


class BlockBroadcastReactor(Reactor):
    def __init__(
        self,
        state_v2: StateV2,
        verifier: Optional[SequencerVerifier] = None,
        wait_sync: bool = False,
        logger: Optional[Logger] = None,
        apply_interval: float = APPLY_INTERVAL,
        sync_interval: float = SYNC_INTERVAL,
        catchup_window: int = CATCHUP_WINDOW,
        metrics: Optional[SequencerMetrics] = None,
        tracer=None,
    ):
        super().__init__("BlockBroadcast")
        self.state_v2 = state_v2
        self.verifier = verifier if verifier is not None else state_v2.verifier
        self.wait_sync = wait_sync
        self.recent_blocks = BlockRingBuffer(RECENT_BLOCKS_CAPACITY)
        self.pending_cache = PendingBlockCache()
        self.seen_blocks = HashSet(SEEN_BLOCKS_CAPACITY)
        self.peer_sent = PeerHashSet(PEER_SENT_CAPACITY)
        self.peer_heights: dict[str, int] = {}
        # heights we asked for on the sync channel; unsolicited sync
        # responses are dropped (the unauthenticated channel must not let
        # an arbitrary peer extend our chain unprompted). Entries map
        # height -> (peer_id, monotonic request time) so NoBlockResponse,
        # peer departure and a TTL can expire them — the original set
        # accumulated unanswered heights for the life of the node.
        self.requested_heights: dict[int, tuple[str, float]] = {}
        self._apply_lock = asyncio.Lock()
        self.sequencer_started = False
        self._tasks: list[asyncio.Task] = []
        self.logger = (logger or state_v2.logger).with_fields(
            module="broadcastReactor"
        )
        self.metrics = metrics or default_metrics(SequencerMetrics)
        # seq.* spans: park (floor) / broadcast + sync_gap (gossip) /
        # apply (compute) — the sequencer family's wall-attribution
        # seam (obs.report.FAMILY_WALL_SPANS["sequencer"]). Heights on
        # these spans are V2 (L2) heights. is-None check: an empty
        # Tracer is falsy (it has __len__)
        self.tracer = default_tracer() if tracer is None else tracer
        # fallback tick intervals ([sequencer] apply_interval /
        # sync_interval): the event-driven wakeups below do the real
        # pacing; these only bound how stale a missed edge can get
        self.apply_interval = apply_interval
        self.sync_interval = sync_interval
        self.catchup_window = max(1, int(catchup_window))
        # silent-peer request expiry (NoBlockResponse and departures
        # expire immediately; this covers a peer that just never answers)
        self.request_ttl = max(1.0, float(sync_interval))
        self._wakeup = asyncio.Event()
        # off-loop coalesced ECDSA checks (sequencer/verify.py)
        self.verify_batcher = SequencerVerifyBatcher(
            self.verifier, logger=self.logger
        )
        # receipt time per block hash -> apply-latency attribution
        self._recv_times: dict[bytes, float] = {}
        # recent receipt->applied latencies, seconds (bench harness)
        self.apply_latencies: deque[float] = deque(maxlen=4096)
        # deferred fan-out: peer id -> ordered {hash: block} awaiting a
        # send-queue slot; drained by _fanout_revisit_routine
        self._fanout_pending: dict[str, OrderedDict[bytes, BlockV2]] = {}
        self._fanout_wakeup = asyncio.Event()
        self._fanout_task: Optional[asyncio.Task] = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=BLOCK_BROADCAST_CHANNEL, priority=6, send_queue_capacity=1000
            ),
            ChannelDescriptor(
                id=SEQUENCER_SYNC_CHANNEL, priority=5, send_queue_capacity=1000
            ),
        ]

    # --- lifecycle (broadcast_reactor.go:96-129) ----------------------------

    async def on_start(self) -> None:
        if not self.wait_sync:
            await self.start_sequencer_routines()

    async def start_sequencer_routines(self) -> None:
        """Start production/apply routines; called at upgrade or after
        blocksync catches up past the upgrade height (:104-125)."""
        if self.sequencer_started:
            self.logger.error("sequencer routines already started")
            return
        self.wait_sync = False
        if not self.state_v2.is_running:
            await self.state_v2.start()
        if self.state_v2.is_sequencer_mode():
            self._tasks.append(
                asyncio.create_task(self._broadcast_routine())
            )
        else:
            self._tasks.append(asyncio.create_task(self._apply_routine()))
        self.sequencer_started = True

    async def on_stop(self) -> None:
        if self._fanout_task is not None:
            self._tasks.append(self._fanout_task)
            self._fanout_task = None
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        self.verify_batcher.stop()
        if self.state_v2.is_running:
            await self.state_v2.stop()

    async def add_peer(self, peer: Peer) -> None:
        self.peer_sent.add_peer(peer.id)
        # advertise our height so peers can catch up from us
        peer.try_send(
            SEQUENCER_SYNC_CHANNEL,
            _enc(_STATUS, height=self.state_v2.latest_height()),
        )
        # a fresh peer may close our gap: let the sync pass look
        self._wakeup.set()

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self.peer_sent.remove_peer(peer.id)
        self.peer_heights.pop(peer.id, None)
        dropped = self._fanout_pending.pop(peer.id, None)
        if dropped:
            self.metrics.fanout_dropped.inc(len(dropped))
        # in-flight requests to the departed peer will never be answered
        stale = [
            h
            for h, (pid, _t) in self.requested_heights.items()
            if pid == peer.id
        ]
        for h in stale:
            del self.requested_heights[h]
        if stale:
            self.metrics.requests_expired.inc(len(stale))
            self._wakeup.set()

    # --- receive (broadcast_reactor.go:146-205) ------------------------------

    async def receive(self, channel_id: int, peer: Peer, msg: bytes) -> None:
        try:
            kind, height, block = _dec(msg)
        except Exception as e:
            self.logger.error("bad sequencer msg", err=str(e))
            await self.switch.stop_peer_for_error(peer, "bad sequencer msg")
            return
        if channel_id == BLOCK_BROADCAST_CHANNEL:
            if kind == _BLOCK_RESPONSE_V2 and block is not None:
                await self._on_block_v2(block, peer, verify_sig=True)
        elif channel_id == SEQUENCER_SYNC_CHANNEL:
            if kind == _BLOCK_REQUEST:
                await self._on_block_request(height, peer)
            elif kind == _BLOCK_RESPONSE_V2 and block is not None:
                # Sync responses are signature-verified like broadcasts.
                # (The reference skips verification here as a shortcut, but
                # every sequencer block IS signed, and an unverified path
                # would let whichever peer answered a request — or pushed
                # an unsolicited response — extend our chain with forged
                # blocks. Requested heights only bypass the seen-dedup.)
                requested = block.number in self.requested_heights
                self.requested_heights.pop(block.number, None)
                await self._on_block_v2(
                    block, peer, verify_sig=True, dedup=not requested
                )
                if requested:
                    # window slot freed: the sync pass may request more
                    self._wakeup.set()
            elif kind == _STATUS:
                prev = self.peer_heights.get(peer.id, 0)
                self.peer_heights[peer.id] = height
                if height > prev:
                    self._wakeup.set()
            elif kind == _NO_BLOCK_RESPONSE:
                self._on_no_block(height, peer)

    def _on_no_block(self, height: int, peer: Peer) -> None:
        """The asked peer cannot serve `height`: expire the in-flight
        request (it would otherwise linger until TTL) and clamp our view
        of the peer below the failed height so the re-request lands on
        someone else."""
        entry = self.requested_heights.get(height)
        if entry is None or entry[0] != peer.id:
            return
        del self.requested_heights[height]
        self.metrics.requests_expired.inc()
        if self.peer_heights.get(peer.id, 0) >= height:
            self.peer_heights[peer.id] = height - 1
        self._wakeup.set()

    # --- routines -----------------------------------------------------------

    async def _broadcast_routine(self) -> None:
        """Sequencer side: drain StateV2's queue, gossip (:215-227)."""
        while True:
            block = await self.state_v2.broadcast_queue.get()
            self.recent_blocks.add(block)
            self.metrics.blocks_broadcast.inc()
            self.metrics.height.set(block.number)
            self._advertise_height(block.number)
            self._gossip_block(block, from_peer="")

    async def _apply_routine(self) -> None:
        """Follower side: event-driven pending-cache drain + gap check.
        Wakes on receipt/insertion/status edges (self._wakeup); the
        configured intervals remain only as a fallback tick."""
        fallback = max(0.01, min(self.apply_interval, self.sync_interval))
        while True:
            t_park = time.perf_counter()
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout=fallback)
            except asyncio.TimeoutError:
                pass
            self._wakeup.clear()
            if self.tracer.enabled:
                # the parked wait is the streaming plane's "floor":
                # event-driven wakeups keep it at the inter-block gap,
                # the polled design pinned it at the fallback tick
                self.tracer.add_span(
                    "seq.park",
                    t_park,
                    time.perf_counter() - t_park,
                    height=self.state_v2.latest_height() + 1,
                )
            try:
                await self.try_apply_from_cache()
                await self.check_sync_gap()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # the apply/sync loop must survive transient peer errors
                self.logger.error("apply routine error", err=str(e))

    # --- core logic (broadcast_reactor.go:251-316) ---------------------------

    def _note_received(self, block: BlockV2) -> None:
        if block.hash in self._recv_times:
            return
        self._recv_times[block.hash] = time.perf_counter()
        while len(self._recv_times) > _RECV_TIMES_CAP:
            self._recv_times.pop(next(iter(self._recv_times)))

    async def _on_block_v2(
        self, block: BlockV2, src: Peer, verify_sig: bool, dedup: bool = True
    ) -> None:
        if self.seen_blocks.add(block.hash) and dedup:
            return  # broadcast dedup; requested sync responses bypass dedup
        self._note_received(block)
        self.peer_sent.add(src.id, block.hash)
        self.peer_heights[src.id] = max(
            self.peer_heights.get(src.id, 0), block.number
        )
        local_height = self.state_v2.latest_height()
        if self._is_next_block(block):
            if verify_sig:
                # off-loop coalesced ECDSA round (burst -> one dispatch);
                # verified OUTSIDE the apply lock so concurrent receives
                # coalesce instead of serializing on it
                ok = await self.verify_batcher.submit_item(block)
                if not ok:
                    # un-poison dedup: a forged copy arriving first must
                    # not make us drop the genuine broadcast of this
                    # hash later
                    self.seen_blocks.discard(block.hash)
                    self.logger.error(
                        "invalid block signature", number=block.number
                    )
                    return
            try:
                await self.apply_block(block, verify_sig=False)
            except Exception as e:
                # un-poison on content/apply failures too: the signature
                # covers only the 32-byte hash, so a relayed copy with
                # tampered contents passes the signature check but fails
                # in the execution layer — the genuine copy of this hash
                # must still be acceptable later
                self.seen_blocks.discard(block.hash)
                self.logger.error(
                    "apply failed", number=block.number, err=str(e)
                )
                return
            if verify_sig:
                self._gossip_block(block, from_peer=src.id)
            # applying may unlock pending children immediately
            await self.try_apply_from_cache()
        elif verify_sig:
            if self.pending_cache.add(block, local_height):
                self.metrics.pending_blocks.set(self.pending_cache.size())
                # the parent may already be in flight on the sync plane
                self._wakeup.set()

    async def try_apply_from_cache(self) -> None:
        """Apply the longest pending chain on top of the head (:318-349).
        The whole chain's signatures verify as ONE coalesced off-loop
        round before any apply."""
        current = self.state_v2.latest_block
        if current is not None:
            chain = self.pending_cache.get_longest_chain(current.hash)
            verdicts = (
                await self.verify_batcher.submit_items(chain)
                if chain
                else []
            )
            for block, ok in zip(chain, verdicts):
                if not ok:
                    # same un-poisoning as the broadcast path, plus the
                    # pending slot: a forged copy must not block the
                    # genuine block of this hash from ever re-entering
                    self.seen_blocks.discard(block.hash)
                    self.pending_cache.remove(block.hash)
                    self.logger.error(
                        "invalid pending block signature",
                        number=block.number,
                    )
                    break
                if not self._is_next_block(block):
                    break
                try:
                    await self.apply_block(block, verify_sig=False)
                except Exception as e:
                    self.seen_blocks.discard(block.hash)
                    self.pending_cache.remove(block.hash)
                    self.logger.error(
                        "apply from cache failed",
                        number=block.number,
                        err=str(e),
                    )
                    break
        local_height = self.state_v2.latest_height()
        if local_height > MAX_PENDING_HEIGHT_BEHIND:
            self.pending_cache.prune_below(
                local_height - MAX_PENDING_HEIGHT_BEHIND
            )
        self.metrics.pending_blocks.set(self.pending_cache.size())

    async def check_sync_gap(self) -> None:
        """Keep a window of missing-height requests in flight when we're
        far behind (:351-383). Landed/stale/expired entries leave the
        window; the freed budget is re-requested immediately."""
        local_height = self.state_v2.latest_height()
        now = time.monotonic()
        live = set(self.switch.peers) if self.switch is not None else set()
        expired = 0
        for h in list(self.requested_heights):
            pid, t = self.requested_heights[h]
            if h <= local_height:
                del self.requested_heights[h]  # landed (or passed by)
            elif pid not in live or now - t > self.request_ttl:
                del self.requested_heights[h]
                expired += 1
        if expired:
            self.metrics.requests_expired.inc(expired)
        max_peer_height = max(self.peer_heights.values(), default=0)
        if max_peer_height - local_height <= SMALL_GAP_THRESHOLD:
            return
        t0 = time.perf_counter()
        await self._request_missing_blocks(local_height + 1, max_peer_height)
        if self.tracer.enabled:
            self.tracer.add_span(
                "seq.sync_gap",
                t0,
                time.perf_counter() - t0,
                height=local_height + 1,
                behind=max_peer_height - local_height,
            )

    async def _request_missing_blocks(self, start: int, end: int) -> None:
        peers = list(self.switch.peers.values()) if self.switch else []
        if not peers:
            return
        budget = self.catchup_window - len(self.requested_heights)
        if budget <= 0:
            return
        now = time.monotonic()
        for height in range(start, end + 1):
            if budget <= 0:
                break
            if height in self.requested_heights:
                continue
            peer = self._find_peer_with_height(peers, height)
            if peer is None:
                continue
            self.requested_heights[height] = (peer.id, now)
            self.metrics.catchup_requests.inc()
            peer.try_send(
                SEQUENCER_SYNC_CHANNEL, _enc(_BLOCK_REQUEST, height=height)
            )
            budget -= 1

    def _find_peer_with_height(self, peers, height: int):
        n = len(peers)
        start = random.randrange(n)
        for i in range(n):
            peer = peers[(start + i) % n]
            if self.peer_heights.get(peer.id, 0) >= height:
                return peer
        return None

    def _is_next_block(self, block: BlockV2) -> bool:
        current = self.state_v2.latest_block
        if current is None:
            return block.number == self.state_v2.latest_height() + 1
        return (
            block.number == current.number + 1
            and block.parent_hash == current.hash
        )

    async def apply_block(self, block: BlockV2, verify_sig: bool) -> None:
        """Verify + apply atomically (:389-420)."""
        async with self._apply_lock:
            t0 = time.perf_counter()
            if verify_sig and not self._verify_signature(block):
                raise ErrInvalidSignature(str(block.number))
            current = self.state_v2.latest_block
            if current is not None and block.parent_hash != current.hash:
                raise ValueError("parent mismatch")
            await self.state_v2.apply_block(block)
            if self.tracer.enabled:
                self.tracer.add_span(
                    "seq.apply",
                    t0,
                    time.perf_counter() - t0,
                    height=block.number,
                )
            self.recent_blocks.add(block)
            self._advertise_height(block.number)
            self.metrics.blocks_applied.inc()
            self.metrics.height.set(block.number)
            t_recv = self._recv_times.pop(block.hash, None)
            if t_recv is not None:
                lat = time.perf_counter() - t_recv
                self.metrics.apply_latency.observe(lat)
                self.apply_latencies.append(lat)
            self.logger.debug(
                "applied block", number=block.number, verify_sig=verify_sig
            )

    def _verify_signature(self, block: BlockV2) -> bool:
        """Recover signer address, check against the sequencer set
        (:422-455). Synchronous path — the gossip/sync receive planes
        use the coalesced off-loop verify_batcher instead."""
        if not block.signature:
            return False
        addr = block.recover_signer()
        if addr is None:
            return False
        if self.verifier is None:
            return False
        return self.verifier.is_sequencer(addr)

    # --- gossip (broadcast_reactor.go:457-511) -------------------------------

    def _gossip_block(self, block: BlockV2, from_peer: str) -> None:
        """Encode-once fan-out: ONE BlockV2 serialization (memoized on
        the block) framed into one wire message shared by every peer
        send. Congested peers defer instead of dropping or stalling."""
        if self.switch is None:
            return
        t0 = time.perf_counter()
        sends = 0
        msg = None  # framed lazily: zero eligible peers = zero encodes
        for peer in list(self.switch.peers.values()):
            if peer.id == from_peer:
                continue
            if self.peer_sent.contains(peer.id, block.hash):
                continue
            if msg is None:
                msg = _enc(_BLOCK_RESPONSE_V2, block=block)
            self._send_or_defer(peer, block, msg)
            sends += 1
        if sends and self.tracer.enabled:
            self.tracer.add_span(
                "seq.broadcast",
                t0,
                time.perf_counter() - t0,
                height=block.number,
                peers=sends,
            )

    def _send_or_defer(
        self,
        peer: Peer,
        block: BlockV2,
        msg: Optional[bytes] = None,
        defer: bool = True,
    ) -> bool:
        """try_send with skip-and-revisit backpressure: a full 0x50
        queue (the p2p send_queue_* signal) defers the block to the
        revisit drain instead of blocking the fan-out on one slow
        subscriber. The revisit drain itself calls with defer=False —
        the block is already at that peer's pending head."""
        headroom = getattr(peer, "queue_headroom", None)
        if headroom is None or headroom(BLOCK_BROADCAST_CHANNEL) > 0:
            if msg is None:
                msg = _enc(_BLOCK_RESPONSE_V2, block=block)
            if peer.try_send(BLOCK_BROADCAST_CHANNEL, msg):
                self.peer_sent.add(peer.id, block.hash)
                self.metrics.fanout_sends.inc()
                return True
        if defer:
            self._defer_fanout(peer.id, block)
        return False

    def _defer_fanout(self, peer_id: str, block: BlockV2) -> None:
        pending = self._fanout_pending.setdefault(peer_id, OrderedDict())
        if block.hash in pending:
            return
        pending[block.hash] = block
        self.metrics.fanout_deferred.inc()
        while len(pending) > FANOUT_PENDING_CAP:
            pending.popitem(last=False)
            self.metrics.fanout_dropped.inc()
        if self._fanout_task is None or self._fanout_task.done():
            self._fanout_task = asyncio.get_running_loop().create_task(
                self._fanout_revisit_routine()
            )
        self._fanout_wakeup.set()

    async def _fanout_revisit_routine(self) -> None:
        """Drain deferred fan-out as congested peers free queue slots.
        Parks when nothing is deferred; per-peer head-of-line order is
        preserved (a subscriber applies blocks in chain order anyway)."""
        while True:
            if not self._fanout_pending:
                self._fanout_wakeup.clear()
                await self._fanout_wakeup.wait()
            await asyncio.sleep(FANOUT_REVISIT_INTERVAL)
            if self.switch is None:
                continue
            floor = (
                self.state_v2.latest_height() - MAX_PENDING_HEIGHT_BEHIND
            )
            for peer_id in list(self._fanout_pending):
                pending = self._fanout_pending.get(peer_id)
                if pending is None:
                    continue
                peer = self.switch.peers.get(peer_id)
                if peer is None:
                    del self._fanout_pending[peer_id]
                    self.metrics.fanout_dropped.inc(len(pending))
                    continue
                while pending:
                    h, block = next(iter(pending.items()))
                    if block.number <= floor:
                        # too stale to push; the peer's own sync plane
                        # is the catch-up path now
                        pending.popitem(last=False)
                        self.metrics.fanout_dropped.inc()
                        continue
                    if self.peer_sent.contains(peer_id, h):
                        pending.popitem(last=False)
                        continue
                    if not self._send_or_defer(peer, block, defer=False):
                        break  # still congested
                    pending.popitem(last=False)
                if not pending:
                    self._fanout_pending.pop(peer_id, None)

    def _advertise_height(self, height: int) -> None:
        if self.switch is None:
            return
        msg = _enc(_STATUS, height=height)
        for peer in list(self.switch.peers.values()):
            peer.try_send(SEQUENCER_SYNC_CHANNEL, msg)

    async def _on_block_request(self, height: int, src: Peer) -> None:
        """Serve a block from the recent cache or the L2 node (:513-540)."""
        block = self.recent_blocks.get_by_height(height)
        if block is None:
            block = self.state_v2.get_block_by_number(height)
        if block is None:
            src.try_send(
                SEQUENCER_SYNC_CHANNEL, _enc(_NO_BLOCK_RESPONSE, height=height)
            )
            return
        src.try_send(SEQUENCER_SYNC_CHANNEL, _enc(_BLOCK_RESPONSE_V2, block=block))
