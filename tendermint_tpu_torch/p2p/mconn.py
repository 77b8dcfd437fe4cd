"""MConnection — one TCP link multiplexed into prioritized byte channels.

Reference: p2p/conn/connection.go:78-210 (MConnection, ChannelDescriptor
:721, sendRoutine :422 / recvRoutine :560): messages are chopped into
~1024-byte packets tagged with a channel id + EOF flag; the send routine
picks the channel with the least recently-used-relative-to-priority queue;
ping/pong keepalive rides channel 0xFF here (the reference uses dedicated
packet types).

Packet layout inside a SecretConnection message:
  byte 0: channel id (0xFE ping, 0xFF pong)
  byte 1: eof flag
  bytes 2..: payload chunk

Ping/pong carries an NTP-style timestamp payload (cluster tracing): a
ping ships the sender's wall+monotonic send time, the pong echoes it
plus the responder's receive/transmit wall times, and the ping sender
folds the four timestamps into a per-peer clock-offset/RTT EWMA
(`clock_offset_s` / `rtt_s`). Empty payloads stay valid — a node that
doesn't stamp its pings still keeps the keepalive alive, it just never
produces clock samples. Offsets are observability-grade only: a peer
can lie about t2/t3, so nothing consensus-critical may read them.
"""

from __future__ import annotations

import asyncio
import struct
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from ..libs.flowrate import Monitor
from ..libs.log import Logger, nop_logger
from ..libs.metrics import (
    OTHER_LABEL,
    P2PMetrics,
    bounded_label,
    default_metrics,
)
from ..obs import default_tracer

MAX_PACKET_PAYLOAD = 1000
_PING = 0xFE
_PONG = 0xFF

# ping payload: <qq  = (t1_wall_ns, t1_mono_ns) at the sender
# pong payload: <qqqq = (t1_wall_ns, t1_mono_ns, t2_wall_ns, t3_wall_ns)
#   t2 = responder receive wall time, t3 = responder transmit wall time
_PING_FMT = "<qq"
_PONG_FMT = "<qqqq"
_PING_LEN = struct.calcsize(_PING_FMT)
_PONG_LEN = struct.calcsize(_PONG_FMT)

# EWMA weight for new clock samples; low enough to ride out one-off
# scheduling spikes, high enough that ~10 pings converge
_CLOCK_ALPHA = 0.2

# sliding clock-filter depth (NTP keeps 8): the min-RTT sample is taken
# over the last N pings, not all time, so a wall-clock step doesn't
# leave a permanently stale offset pinned to an unbeatable old sample
_CLOCK_WINDOW = 16

# reference p2p/conn/connection.go defaultSendRate/defaultRecvRate:
# 512000 B/s (500 KB/s) per connection; 0 disables throttling
DEFAULT_SEND_RATE = 512000
DEFAULT_RECV_RATE = 512000
_THROTTLE_TICK = 0.05


@dataclass
class ChannelDescriptor:
    id: int
    priority: int = 1
    send_queue_capacity: int = 100
    recv_message_capacity: int = 1 << 22


class _Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.send_queue: asyncio.Queue[bytes] = asyncio.Queue(
            desc.send_queue_capacity
        )
        self.sending: bytes = b""
        self.recv_buf = bytearray()
        self.recently_sent = 0  # decayed bytes for priority scheduling

    def is_send_pending(self) -> bool:
        return bool(self.sending) or not self.send_queue.empty()

    def next_packet(self) -> tuple[bytes, bool]:
        if not self.sending:
            self.sending = self.send_queue.get_nowait()
        chunk = self.sending[:MAX_PACKET_PAYLOAD]
        self.sending = self.sending[MAX_PACKET_PAYLOAD:]
        eof = not self.sending
        self.recently_sent += len(chunk)
        return chunk, eof


class MConnection:
    """on_receive(channel_id, message_bytes) is awaited per complete
    message; on_error(err) fires once when the connection dies."""

    def __init__(
        self,
        conn,  # SecretConnection (or anything with read/write/close)
        channels: list[ChannelDescriptor],
        on_receive: Callable[[int, bytes], Awaitable[None]],
        on_error: Optional[Callable[[Exception], Awaitable[None]]] = None,
        ping_interval: float = 10.0,
        send_rate: int = DEFAULT_SEND_RATE,
        recv_rate: int = DEFAULT_RECV_RATE,
        metrics: Optional[P2PMetrics] = None,
        logger: Optional[Logger] = None,
        peer_id: str = "",
    ):
        self._conn = conn
        self._channels = {d.id: _Channel(d) for d in channels}
        self._on_receive = on_receive
        self._on_error = on_error
        self._ping_interval = ping_interval
        self._send_rate = send_rate
        self._recv_rate = recv_rate
        # per-channel queue depth / full-drop / stall accounting; shared
        # process-wide set unless the assembler passes its own
        self.metrics = metrics or default_metrics(P2PMetrics)
        # public: peer-quality metrics read these (reference Status())
        self.send_monitor = Monitor()
        self.recv_monitor = Monitor()
        # NTP-style per-peer clock estimate from timestamped ping/pong;
        # None until the first complete sample
        self.peer_id = peer_id
        self.clock_offset_s: Optional[float] = None  # peer clock - ours
        self.rtt_s: Optional[float] = None
        # NTP clock-filter: the minimum-RTT sample over the last
        # _CLOCK_WINDOW pings is the least queue-inflated one, so its
        # offset is the sharpest estimate — the cluster merge prefers
        # it over the EWMA
        self._clock_window: deque = deque(maxlen=_CLOCK_WINDOW)
        self.min_rtt_s: Optional[float] = None
        self.min_rtt_offset_s: Optional[float] = None
        self.clock_samples = 0
        self.logger = logger or nop_logger()
        self._tasks: list[asyncio.Task] = []
        self._send_signal = asyncio.Event()
        self._running = False
        self._errored = False

    async def _throttle(self, mon: Monitor, want: int, rate: int) -> None:
        """Block until `want` bytes fit the rate budget (reference
        sendRoutine/recvRoutine flowrate.Limit)."""
        if rate <= 0:
            return
        while mon.limit(want, rate) < want:
            await asyncio.sleep(_THROTTLE_TICK)

    def start(self) -> None:
        self._running = True
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._send_routine()),
            loop.create_task(self._recv_routine()),
            loop.create_task(self._ping_routine()),
        ]

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._conn.close()

    def queue_headroom(self, channel_id: int) -> int:
        """Free slots in a channel's send queue — the cheap read of the
        p2p_send_queue_* backpressure signal. 0 means a send would be
        dropped (TrySend returns False); fan-out planes use it to
        skip-and-revisit a congested peer instead of hammering sends."""
        ch = self._channels.get(channel_id)
        if ch is None or not self._running:
            return 0
        return max(0, ch.send_queue.maxsize - ch.send_queue.qsize())

    def send(self, channel_id: int, msg: bytes) -> bool:
        """Queue a message; False if the channel queue is full (TrySend)."""
        ch = self._channels.get(channel_id)
        if ch is None or not self._running:
            return False
        try:
            ch.send_queue.put_nowait(msg)
        except asyncio.QueueFull:
            self.metrics.send_queue_full.inc(chID=f"{channel_id:#04x}")
            default_tracer().event(
                "p2p.send_queue_full",
                ch=f"{channel_id:#04x}",
                depth=ch.send_queue.qsize(),
            )
            return False
        self.metrics.send_queue_depth.set(
            ch.send_queue.qsize(), chID=f"{channel_id:#04x}"
        )
        self.metrics.message_send_bytes.inc(
            len(msg), chID=f"{channel_id:#04x}"
        )
        self._send_signal.set()
        return True

    async def _send_routine(self) -> None:
        try:
            while self._running:
                await self._send_signal.wait()
                sent_any = True
                while sent_any:
                    sent_any = await self._send_some()
                self._send_signal.clear()
                # re-check: a send() between loop exit and clear would be
                # lost without this
                if any(
                    c.is_send_pending() for c in self._channels.values()
                ):
                    self._send_signal.set()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._die(e)

    async def _send_some(self) -> bool:
        """Send one packet from the least-loaded-by-priority channel
        (reference sendSomePacketMsgs)."""
        best = None
        best_ratio = None
        for ch in self._channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / max(1, ch.desc.priority)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        if best is None:
            return False
        chunk, eof = best.next_packet()
        if eof:
            # keep the depth gauge honest on drain, not just on enqueue
            self.metrics.send_queue_depth.set(
                best.send_queue.qsize(), chID=f"{best.desc.id:#04x}"
            )
        pkt = bytes([best.desc.id, 1 if eof else 0]) + chunk
        t0 = time.perf_counter()
        await self._throttle(self.send_monitor, len(pkt), self._send_rate)
        stalled = time.perf_counter() - t0
        if stalled >= _THROTTLE_TICK:
            # rate-cap back-pressure: the slice of send time the link
            # budget (not the peer) is responsible for
            self.metrics.send_stall_seconds.inc(stalled)
            default_tracer().event(
                "p2p.send_stall",
                ch=f"{best.desc.id:#04x}",
                stall_ms=round(stalled * 1e3, 2),
            )
        await self._conn.write(pkt)
        self.send_monitor.update(len(pkt))
        # decay counters so priorities stay relative
        for ch in self._channels.values():
            ch.recently_sent = int(ch.recently_sent * 0.8)
        return True

    async def _recv_routine(self) -> None:
        try:
            while self._running:
                await self._throttle(
                    self.recv_monitor, MAX_PACKET_PAYLOAD, self._recv_rate
                )
                pkt = await self._read_packet()
                if pkt is None:
                    continue
                ch_id, eof, chunk = pkt
                self.recv_monitor.update(len(chunk) + 2)
                if ch_id == _PING:
                    await self._conn.write(self._pong_packet(chunk))
                    continue
                if ch_id == _PONG:
                    self._on_pong(chunk)
                    continue
                ch = self._channels.get(ch_id)
                if ch is None:
                    raise ValueError(f"unknown channel {ch_id:#x}")
                ch.recv_buf += chunk
                if len(ch.recv_buf) > ch.desc.recv_message_capacity:
                    raise ValueError("message exceeds recv capacity")
                if eof:
                    msg = bytes(ch.recv_buf)
                    ch.recv_buf = bytearray()
                    self.metrics.message_receive_bytes.inc(
                        len(msg), chID=f"{ch_id:#04x}"
                    )
                    await self._on_receive(ch_id, msg)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._die(e)

    async def _read_packet(self):
        # one SecretConnection frame carries exactly one packet (we always
        # write packets as single frames ≤ 1024B)
        data = await self._conn.read()
        if len(data) < 2:
            return None
        return data[0], data[1] == 1, data[2:]

    async def _ping_routine(self) -> None:
        try:
            while self._running:
                await asyncio.sleep(self._ping_interval)
                await self._conn.write(
                    bytes([_PING, 1])
                    + struct.pack(
                        _PING_FMT, time.time_ns(), time.perf_counter_ns()
                    )
                )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._die(e)

    # --- clock-offset estimation ------------------------------------------

    @staticmethod
    def _pong_packet(ping_payload: bytes) -> bytes:
        """Echo the ping's timestamps plus our receive/transmit wall
        times; a payload-less (pre-extension) ping gets a bare pong."""
        if len(ping_payload) < _PING_LEN:
            return bytes([_PONG, 1])
        t1_wall, t1_mono = struct.unpack_from(_PING_FMT, ping_payload)
        t2 = time.time_ns()
        # t3 is stamped immediately before the write; at this packet size
        # the t2/t3 gap is the cost of one struct.pack
        return bytes([_PONG, 1]) + struct.pack(
            _PONG_FMT, t1_wall, t1_mono, t2, time.time_ns()
        )

    def _on_pong(self, payload: bytes) -> None:
        """Fold one NTP sample (t1..t4) into the offset/RTT EWMAs."""
        if len(payload) < _PONG_LEN:
            return
        t1_wall, t1_mono, t2, t3 = struct.unpack_from(_PONG_FMT, payload)
        t4_wall = time.time_ns()
        t4_mono = time.perf_counter_ns()
        # RTT from OUR monotonic clock (immune to either wall clock
        # stepping mid-flight), minus the responder's processing time
        rtt = (t4_mono - t1_mono - (t3 - t2)) / 1e9
        if rtt < 0:  # stale echo / clock anomaly: discard the sample
            return
        offset = ((t2 - t1_wall) + (t3 - t4_wall)) / 2e9
        if self.clock_samples == 0:
            self.clock_offset_s = offset
            self.rtt_s = rtt
        else:
            self.clock_offset_s += _CLOCK_ALPHA * (offset - self.clock_offset_s)
            self.rtt_s += _CLOCK_ALPHA * (rtt - self.rtt_s)
        self._clock_window.append((rtt, offset))
        self.min_rtt_s, self.min_rtt_offset_s = min(self._clock_window)
        self.clock_samples += 1
        if self.peer_id:
            label = bounded_label("p2p_peer_clock", self.peer_id)
            if label != OTHER_LABEL:
                # gauges are last-write-wins: an "_other" series shared
                # by every overflow peer would flap between unrelated
                # peers' offsets — wrong data, not coarse data. Overflow
                # peers stay observable via dump_traces' peer_clock.
                self.metrics.peer_clock_offset.set(
                    self.clock_offset_s, peer=label
                )
                self.metrics.peer_rtt.set(self.rtt_s, peer=label)

    async def _die(self, err: Exception) -> None:
        if self._errored or not self._running:
            return
        self._errored = True
        self._running = False
        self.logger.info("connection error", err=repr(err))
        if self._on_error is not None:
            await self._on_error(err)
