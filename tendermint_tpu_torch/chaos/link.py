"""Seeded link model — network shaping at the connection layer.

`ChaosConn` wraps the SecretConnection a `MultiplexTransport` hands to the
MConnection, so every reactor (consensus gossip, blocksync, statesync,
evidence, sequencer broadcast) is shaped without modification. Shaping
happens OUTSIDE the AEAD: writes are dropped/delayed before encryption and
reads after decryption, so the nonce counters never desync — unlike
`p2p/fuzz.py`, a dropped message here does not kill the connection.

Faults are applied at MESSAGE granularity: MConnection chops a message
into packets tagged (channel, eof); ChaosConn buffers a channel's packets
until eof and then makes ONE seeded decision for the whole message. This
keeps the per-channel reassembly buffers coherent (dropping or reordering
a mid-message packet would corrupt every later message on that channel).

Determinism: each link direction owns a `random.Random` derived from
(seed, src_id, dst_id), so the decision stream for a link depends only on
the seed and the number of messages sent over it — replaying the same
message sequence yields a byte-identical fault trace (see
tests/test_chaos.py::test_link_trace_deterministic).
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import json
import random
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class LinkPolicy:
    """Per-direction shaping knobs for one link.

    Asymmetric links are expressed by installing different policies for
    the A->B and B->A directions (ChaosNetwork.set_link_policy).
    """

    latency_s: float = 0.0  # base one-way delay
    jitter_s: float = 0.0  # uniform [0, jitter_s) added per message
    drop: float = 0.0  # P(message silently dropped)
    duplicate: float = 0.0  # P(message delivered twice)
    reorder: float = 0.0  # P(message held back past later traffic)
    reorder_extra_s: float = 0.05  # hold-back amount for reordered msgs
    bandwidth_bps: int = 0  # serialization cap in bytes/s; 0 = infinite

    def is_noop(self) -> bool:
        return (
            self.latency_s == 0.0
            and self.jitter_s == 0.0
            and self.drop == 0.0
            and self.duplicate == 0.0
            and self.reorder == 0.0
            and self.bandwidth_bps == 0
        )


def link_rng(seed: int, src_id: str, dst_id: str) -> random.Random:
    """Deterministic RNG for one link DIRECTION, independent of dial
    order or connection timing."""
    h = hashlib.sha256(
        b"tm-tpu-chaos:%d:%s>%s" % (seed, src_id.encode(), dst_id.encode())
    ).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


class FaultTrace:
    """Append-only record of chaos decisions, serializable for replay
    comparison. Entries are plain tuples so `to_jsonl()` is byte-stable
    across runs."""

    def __init__(self):
        self.entries: list[tuple] = []

    def add(self, *entry) -> None:
        self.entries.append(entry)

    def to_jsonl(self) -> bytes:
        return b"\n".join(
            json.dumps(list(e), separators=(",", ":")).encode()
            for e in self.entries
        )

    def __len__(self) -> int:
        return len(self.entries)


@dataclass
class _Scheduled:
    due: float
    seq: int
    frames: list[bytes] = field(default_factory=list)

    def __lt__(self, other: "_Scheduled") -> bool:
        return (self.due, self.seq) < (other.due, other.seq)


class ChaosConn:
    """Connection wrapper applying a seeded LinkPolicy to the write
    direction. Exposes the SecretConnection surface MConnection uses
    (write/read/close) and passes everything else through."""

    def __init__(
        self,
        conn,
        policy: LinkPolicy,
        rng: random.Random,
        link_id: str = "",
        trace: Optional[FaultTrace] = None,
        policy_fn=None,
    ):
        self._conn = conn
        # policy_fn (when given) is re-resolved per message, so a
        # mid-scenario set_link/set_default_policy reshapes LIVE
        # connections, not just ones established afterwards
        self._policy = policy
        self._policy_fn = policy_fn
        self._rng = rng
        self.link_id = link_id
        self.trace = trace if trace is not None else FaultTrace()
        self._partial: dict[int, list[bytes]] = {}  # channel -> frames
        self._raw_mid: set[int] = set()  # channels mid-message on fast path
        self._heap: list[_Scheduled] = []
        self._seq = 0
        self._msg_seq = 0
        self._wakeup = asyncio.Event()
        self._busy_until = 0.0  # bandwidth serialization horizon
        self._order_floor = 0.0  # FIFO floor for non-reordered messages
        self._pump_task: Optional[asyncio.Task] = None
        self._pump_busy = False  # pump is mid-message on the wire
        self._closed = False

    @property
    def policy(self) -> LinkPolicy:
        return self._policy_fn() if self._policy_fn is not None else self._policy

    # --- write side (shaped) ---------------------------------------------

    async def write(self, data: bytes) -> None:
        if len(data) < 2:  # not an mconn packet; pass through
            await self._conn.write(data)
            return
        ch_id, eof = data[0], data[1] == 1
        if ch_id in self._raw_mid:
            # a message that began on the noop fast path finishes raw even
            # if the policy changed mid-message — mixing paths would split
            # its frames across the heap and corrupt channel reassembly
            if eof:
                self._raw_mid.discard(ch_id)
            await self._conn.write(data)
            return
        if (
            ch_id not in self._partial
            and not self._heap
            and not self._pump_busy
            and self.policy.is_noop()
        ):
            # fast path only when nothing is queued or mid-flush in the
            # pump: a raw write racing the pump's frame loop would
            # interleave two messages' frames and corrupt reassembly
            if not eof:
                self._raw_mid.add(ch_id)
            await self._conn.write(data)
            return
        frames = self._partial.setdefault(ch_id, [])
        frames.append(data)
        if not eof:
            return
        del self._partial[ch_id]
        await self._dispatch_message(ch_id, frames)

    async def _dispatch_message(self, ch_id: int, frames: list[bytes]) -> None:
        p = self.policy
        rng = self._rng
        msg = self._msg_seq
        self._msg_seq += 1
        size = sum(len(f) for f in frames)

        if p.drop and rng.random() < p.drop:
            self.trace.add(self.link_id, msg, ch_id, "drop", size)
            from ..obs import default_tracer

            default_tracer().event(
                "chaos.drop", link=self.link_id, ch=ch_id, bytes=size
            )
            return
        delay = p.latency_s
        if p.jitter_s:
            delay += rng.random() * p.jitter_s
        dup = bool(p.duplicate) and rng.random() < p.duplicate
        reordered = bool(p.reorder) and rng.random() < p.reorder

        loop = asyncio.get_running_loop()
        now = loop.time()
        if p.bandwidth_bps > 0:
            start = max(now, self._busy_until)
            self._busy_until = start + size / p.bandwidth_bps
            due = self._busy_until + delay
        else:
            due = now + delay
        if reordered:
            due += p.reorder_extra_s
        else:
            # preserve FIFO among non-reordered messages
            due = max(due, self._order_floor)
            self._order_floor = due
        self.trace.add(
            self.link_id,
            msg,
            ch_id,
            "deliver",
            size,
            round(delay, 6),
            int(dup),
            int(reordered),
        )
        copies = 2 if dup else 1
        for _ in range(copies):
            heapq.heappush(self._heap, _Scheduled(due, self._seq, frames))
            self._seq += 1
        self._ensure_pump()
        self._wakeup.set()

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump()
            )

    async def _pump(self) -> None:
        try:
            while not self._closed:
                if not self._heap:
                    self._wakeup.clear()
                    await self._wakeup.wait()
                    continue
                loop = asyncio.get_running_loop()
                head = self._heap[0]
                wait = head.due - loop.time()
                if wait > 0:
                    # a newly scheduled earlier message can preempt
                    self._wakeup.clear()
                    try:
                        await asyncio.wait_for(self._wakeup.wait(), wait)
                    except asyncio.TimeoutError:
                        pass
                    continue
                item = heapq.heappop(self._heap)
                self._pump_busy = True
                try:
                    for frame in item.frames:
                        await self._conn.write(frame)
                finally:
                    self._pump_busy = False
        except asyncio.CancelledError:
            raise
        except Exception:
            # connection died underneath us; MConnection's own recv/send
            # routines surface the error — the pump just stops shaping
            pass

    # --- read side (pass-through) ----------------------------------------

    async def read(self) -> bytes:
        return await self._conn.read()

    async def read_exactly(self, n: int) -> bytes:
        return await self._conn.read_exactly(n)

    def close(self) -> None:
        self._closed = True
        if self._pump_task is not None:
            self._pump_task.cancel()
        self._wakeup.set()
        self._conn.close()

    def __getattr__(self, name):
        return getattr(self._conn, name)
