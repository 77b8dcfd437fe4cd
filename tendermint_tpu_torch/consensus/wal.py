"""Consensus write-ahead log.

Reference: consensus/wal.go — every message is logged BEFORE being acted
on (TimedWALMessage :35, EndHeightMessage :42, WAL iface :58, BaseWAL :76
over autofile.Group, CRC+length framed encoder :288-420). fsync happens on
internal messages (consensus/state.go:821-828) and on EndHeight
(state.go:1853-1859) so a crashed node replays deterministically
(replay.go:95-173 catchupReplay).

Record frame: crc32(payload) u32be | len(payload) u32be | payload, where
payload = field(1)=kind, field(2)=timestamp_ns, field(3)=data.
"""

from __future__ import annotations

import asyncio
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from io import BytesIO
from typing import Iterator, Optional

from ..libs import protoio as pio
from ..libs.autofile import Group
from ..obs import default_tracer

MAX_WAL_MSG_SIZE = 1 << 20

KIND_END_HEIGHT = "end_height"


@dataclass
class WALMessage:
    kind: str  # "end_height" or a consensus message kind
    data: bytes
    timestamp_ns: int = 0


def end_height_record(height: int) -> WALMessage:
    """The canonical end-height barrier record — single owner of its
    encoding (write_end_height and the pipelined finalize both use it,
    so replay always recognizes the barrier)."""
    return WALMessage(KIND_END_HEIGHT, pio.write_uvarint(height))


def encode_record(msg: WALMessage) -> bytes:
    payload = (
        pio.field_bytes(1, msg.kind.encode())
        + pio.field_varint(2, msg.timestamp_ns or time.time_ns())
        + pio.field_bytes(3, msg.data)
    )
    if len(payload) > MAX_WAL_MSG_SIZE:
        raise ValueError("WAL message too big")
    return (
        struct.pack(">I", zlib.crc32(payload))
        + struct.pack(">I", len(payload))
        + payload
    )


class WALCorruption(Exception):
    pass


def decode_records(
    data: bytes, lenient: bool = False
) -> Iterator[WALMessage]:
    """Yields messages; raises WALCorruption (or stops, if lenient — the
    last record of a crashed node is expected to be torn)."""
    buf = BytesIO(data)
    total = len(data)
    while buf.tell() < total:
        head = buf.read(8)
        if len(head) < 8:
            if lenient:
                return
            raise WALCorruption("truncated record header")
        crc, length = struct.unpack(">II", head)
        if length > MAX_WAL_MSG_SIZE:
            if lenient:
                return
            raise WALCorruption("record length too large")
        payload = buf.read(length)
        if len(payload) < length:
            if lenient:
                return
            raise WALCorruption("truncated record payload")
        if zlib.crc32(payload) != crc:
            if lenient:
                return
            raise WALCorruption("crc mismatch")
        try:
            f = pio.decode_fields(payload)
            msg = WALMessage(
                kind=f[1][0].decode(),
                data=f.get(3, [b""])[0],
                timestamp_ns=f.get(2, [0])[0],
            )
        except (KeyError, IndexError, ValueError, EOFError, TypeError,
                AttributeError, UnicodeDecodeError) as e:
            # CRC-valid but structurally hostile payload (a crafted WAL,
            # not a torn tail): surface as corruption, never as a raw
            # decoder exception (fuzz target, reference test/fuzz shape)
            if lenient:
                return
            raise WALCorruption(f"malformed record payload: {e}") from None
        yield msg


class WAL:
    """File WAL over an autofile Group (reference BaseWAL).

    Every fsync is timed into `metrics.wal_fsync_seconds` (a
    ConsensusMetrics, when given — fsync is the disk-bound slice of the
    commit path) and the tracer's timeline as a `wal.fsync` span; the
    flight recorder bins it into the height in progress."""

    def __init__(
        self,
        path: str,
        head_size_limit: int = 10 * 1024 * 1024,
        metrics=None,
        tracer=None,
    ):
        self._group = Group(path, head_size_limit=head_size_limit)
        self._path = path
        self._metrics = metrics
        # is-None check: Tracer has __len__, so a fresh (empty)
        # tracer is falsy and `or` would silently discard it
        self._tracer = default_tracer() if tracer is None else tracer
        # total fsyncs issued over this WAL's life — the commit-path
        # bench divides the delta by heights to report fsyncs/height
        self.fsync_count = 0

    def write(self, msg: WALMessage) -> None:
        self._group.write(encode_record(msg))

    def _sync_timed(self) -> None:
        t0 = time.perf_counter()
        self._group.sync()
        dur = time.perf_counter() - t0
        self.fsync_count += 1
        if self._metrics is not None:
            self._metrics.wal_fsync_seconds.observe(dur)
        self._tracer.add_span("wal.fsync", t0, dur)

    def write_sync(self, msg: WALMessage) -> None:
        self.write(msg)
        self._sync_timed()

    def write_end_height(self, height: int) -> None:
        """The end-height barrier, fsynced (reference state.go:1853)."""
        self.write_sync(end_height_record(height))

    def flush_and_sync(self) -> None:
        self._sync_timed()

    # durability-barrier surface shared with GroupCommitWAL, so the
    # commit pipeline runs against either kind. `timeout` only bounds a
    # QUEUED barrier wait (GroupCommitWAL); the plain WAL's single
    # inline fsync is not interruptible, so it is ignored here.
    def barrier(self, timeout: Optional[float] = None) -> None:
        self._sync_timed()

    async def abarrier(self) -> None:
        await asyncio.get_running_loop().run_in_executor(
            None, self._sync_timed
        )

    # pipeline-boundary barrier surface: `mark()` names the set of
    # records written so far; `abarrier_to(mark)` resolves when an fsync
    # covers exactly that set — so a background finalization task can
    # wait for ITS height's end-height record without being extended by
    # whatever the next height has written since. The plain WAL has no
    # sequence bookkeeping: one inline fsync covers everything.
    def mark(self) -> int:
        return 0

    async def abarrier_to(self, mark: int) -> None:
        await self.abarrier()

    def close(self) -> None:
        self._group.close()

    # --- replay -----------------------------------------------------------

    def search_for_end_height(self, height: int) -> Optional[list[WALMessage]]:
        """Messages AFTER the end-height record for `height` (i.e. the
        in-progress height+1 messages to replay). None if no such record.
        height=0 means replay from the beginning."""
        msgs = list(decode_records(self._group.read_all(), lenient=True))
        if height == 0:
            return msgs
        for i, m in enumerate(msgs):
            if m.kind == KIND_END_HEIGHT:
                h = pio.read_uvarint(BytesIO(m.data))
                if h == height:
                    return msgs[i + 1 :]
        return None

    def repair(self) -> int:
        """Truncate the head file at the first corrupt record (reference
        repairWalFile, consensus/state.go:2714). Returns bytes dropped."""
        self._group.flush()
        with open(self._path, "rb") as f:
            data = f.read()
        good = 0
        buf = BytesIO(data)
        while True:
            head = buf.read(8)
            if len(head) < 8:
                break
            crc, length = struct.unpack(">II", head)
            if length > MAX_WAL_MSG_SIZE:
                break
            payload = buf.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            good = buf.tell()
        dropped = len(data) - good
        if dropped:
            with open(self._path, "rb+") as f:
                f.truncate(good)
            # reopen head so the append offset is right
            self._group._head.close()
            self._group._head = open(self._path, "ab")
        return dropped


class GroupCommitWAL(WAL):
    """WAL with fsyncs coalesced across queued records (group commit).

    Records are appended to the OS file immediately (`write`); a
    dedicated flush thread issues ONE fsync covering every record
    written since the previous one. Coalescing is natural: records that
    arrive while an fsync is in flight all ride the next one (measured
    on this box: 4.4 records/fsync at 8 concurrent writers with ZERO
    added latency — tools/fsync_bench.py). `flush_interval > 0` adds a
    bounded wait before each fsync to trade barrier latency for even
    fewer fsyncs (8/fsync at 2 ms) — worth it on high-latency disks,
    off by default. The durability contract is unchanged — `write_sync`/`write_end_height`/
    `barrier()` do not return until an fsync covering the caller's last
    write has completed — but concurrent waiters (the consensus event
    loop at precommit time, the background finalization task's
    end-height barrier, replay) share a single fsync instead of paying
    one each. `abarrier()` is the awaitable form for event-loop callers
    so the loop keeps serving gossip while the disk syncs.

    Reference counterpart: none — the reference fsyncs inline per
    internal message (consensus/state.go:821-828). Group commit is the
    classic DB/journal trick (one fsync per *batch* of commits); on the
    1-core bench host one fsync is ~1-10 ms, and the serial path pays
    O(messages) of them per height.
    """

    def __init__(
        self,
        path: str,
        head_size_limit: int = 10 * 1024 * 1024,
        metrics=None,
        tracer=None,
        flush_interval: float = 0.0,
    ):
        super().__init__(
            path, head_size_limit=head_size_limit, metrics=metrics,
            tracer=tracer,
        )
        self.flush_interval = max(0.0, flush_interval)
        self._mtx = threading.Lock()
        self._flushed = threading.Condition(self._mtx)
        self._written_seq = 0  # records handed to the OS file
        self._synced_seq = 0  # records covered by a completed fsync
        self._async_waiters: list[tuple[int, asyncio.AbstractEventLoop,
                                        asyncio.Future]] = []
        self._closed = False
        # latched fsync failure: barriers must RAISE, never report
        # records durable that never reached disk (double-sign risk on
        # replay); the serial WAL propagates the same error inline
        self._error: Optional[BaseException] = None
        self._flusher = threading.Thread(
            target=self._flush_loop, name="wal-group-commit", daemon=True
        )
        self._flusher.start()

    # --- writes ------------------------------------------------------------

    def write(self, msg: WALMessage) -> None:
        with self._mtx:
            if self._closed:
                raise RuntimeError("WAL closed")
            if self._error is not None:
                raise RuntimeError("WAL fsync failed") from self._error
            self._group.write(encode_record(msg))
            self._written_seq += 1
            self._flushed.notify_all()  # wake the flusher

    def barrier(self, timeout: Optional[float] = None) -> None:
        """Block until every record written so far is durable."""
        with self._mtx:
            target = self._written_seq
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            # no break on _closed: close() drains the flusher before the
            # file closes, so a waiter either gets covered by the final
            # drain or fails on the latched error — aborting early would
            # report undurable records as synced
            while self._synced_seq < target and self._error is None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("WAL group-commit barrier")
                self._flushed.wait(remaining)
            if self._synced_seq < target:
                raise RuntimeError("WAL fsync failed") from self._error

    async def abarrier(self) -> None:
        """Awaitable durability barrier: resolves when every record
        written so far is covered by an fsync, without blocking the
        event loop while the disk syncs. Raises if the flush thread
        latched an fsync failure for uncovered records."""
        await self.abarrier_to(self.mark())

    def mark(self) -> int:
        """Sequence number naming every record written so far — the
        pipelined finalize takes one right after its end-height write,
        so its background barrier covers exactly that boundary and is
        never extended by the next height's traffic."""
        with self._mtx:
            return self._written_seq

    async def abarrier_to(self, mark: int) -> None:
        """abarrier for an explicit `mark` (see WAL.mark): resolves when
        an fsync covers every record up to it."""
        loop = asyncio.get_running_loop()
        with self._mtx:
            target = mark
            if self._synced_seq >= target:
                return
            if self._error is not None:
                raise RuntimeError("WAL fsync failed") from self._error
            if self._closed:
                raise RuntimeError("WAL closed before records were durable")
            fut: asyncio.Future = loop.create_future()
            self._async_waiters.append((target, loop, fut))
        await fut

    def write_sync(self, msg: WALMessage) -> None:
        self.write(msg)
        self.barrier()

    def flush_and_sync(self) -> None:
        self.barrier()

    # --- flush thread -------------------------------------------------------

    def _flush_loop(self) -> None:
        while True:
            with self._mtx:
                while (
                    self._written_seq == self._synced_seq
                    and not self._closed
                ):
                    self._flushed.wait()
                if self._closed and self._written_seq == self._synced_seq:
                    return
                target = self._written_seq
            # coalescing window: let writers that are already in flight
            # land in this fsync instead of forcing another
            if self.flush_interval > 0:
                time.sleep(self.flush_interval)
                with self._mtx:
                    target = self._written_seq
            t0 = time.perf_counter()
            try:
                self._group.sync()
            except Exception as e:
                # REAL fsync failure (EIO/ENOSPC — close() joins this
                # thread before touching the file, so it can't be a
                # shutdown race): latch it, fail every waiter, and stop.
                # Records must never be reported durable that didn't
                # reach disk.
                with self._mtx:
                    self._error = e
                    self._release_waiters()
                    self._flushed.notify_all()
                return
            dur = time.perf_counter() - t0
            self.fsync_count += 1
            with self._mtx:
                covered = target - self._synced_seq
                self._synced_seq = target
                self._release_waiters()
                self._flushed.notify_all()
            try:
                # bookkeeping must never kill the flush thread — a dead
                # flusher with no latched error wedges every barrier
                if self._metrics is not None:
                    self._metrics.wal_fsync_seconds.observe(dur)
                    gr = getattr(
                        self._metrics, "wal_group_fsync_records", None
                    )
                    if gr is not None:
                        gr.observe(covered)
                self._tracer.add_span(
                    "wal.group_fsync", t0, dur, n=covered
                )
            except Exception:
                pass

    def _release_waiters(self) -> None:
        # under self._mtx
        still = []
        err = self._error
        for target, loop, fut in self._async_waiters:
            if self._synced_seq >= target:
                try:
                    loop.call_soon_threadsafe(
                        lambda f=fut: f.done() or f.set_result(None)
                    )
                except RuntimeError:
                    pass  # waiter's loop closed (cancelled/torn down)
            elif err is not None:
                # uncovered records at fsync failure: fail the waiter —
                # success here would report undurable records as synced.
                # (_closed alone is NOT failure: the flusher's final
                # drain covers queued records before close completes)
                try:
                    loop.call_soon_threadsafe(
                        lambda f=fut, e=err: f.done()
                        or f.set_exception(
                            RuntimeError(f"WAL fsync failed: {e!r}")
                        )
                    )
                except RuntimeError:
                    pass  # waiter's loop closed
            else:
                still.append((target, loop, fut))
        self._async_waiters = still

    def close(self) -> None:
        with self._mtx:
            if self._closed:
                return
            self._closed = True
            self._flushed.notify_all()
        # unbounded join: the flusher exits once drained (or on a
        # latched error). A bounded join here closed the file under an
        # in-flight fsync on a stalled disk, mis-latching durable
        # records as failed — blocking mirrors what the disk is doing.
        self._flusher.join()
        with self._mtx:
            self._release_waiters()
            # anything still pending can only mean the flusher died
            # without covering it — fail, never silently drop
            for target, loop, fut in self._async_waiters:
                try:
                    loop.call_soon_threadsafe(
                        lambda f=fut: f.done()
                        or f.set_exception(
                            RuntimeError(
                                "WAL closed before records were durable"
                            )
                        )
                    )
                except RuntimeError:
                    pass  # waiter's loop closed
            self._async_waiters = []
        super().close()


class NilWAL:
    """No-op WAL for tests (reference consensus/wal.go:421 nilWAL)."""

    def write(self, msg) -> None:
        pass

    def write_sync(self, msg) -> None:
        pass

    def write_end_height(self, height: int) -> None:
        pass

    def flush_and_sync(self) -> None:
        pass

    def barrier(self, timeout=None) -> None:
        pass

    async def abarrier(self) -> None:
        pass

    def mark(self) -> int:
        return 0

    async def abarrier_to(self, mark: int) -> None:
        pass

    def close(self) -> None:
        pass

    def search_for_end_height(self, height: int):
        return None

    def repair(self) -> int:
        return 0
