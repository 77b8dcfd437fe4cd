"""Verify-as-a-service: one device-owning scheduler process serving a
whole committee over Unix-domain-socket IPC.

Live nets above ~32 validators are event-loop-bound and ran with
stubbed signature verification — a single-process harness cannot absorb
100 nodes' device verifies, so the committee-crypto cost model has never
been measured end-to-end on this stack. This module lifts the
cross-subsystem coalescing design one level, to cross-PROCESS:

- **`VerifyServiceServer`**: a standalone process
  (`python -m tendermint_tpu_torch verify-service`) owns the `VerifyScheduler`
  — and with it the `BatchVerifier`, the device mesh, the shape
  registry, the DispatchLedger and the prewarm ladder — and serves a
  length-prefixed binary protocol over a UDS. Submissions from ANY
  connected client land in the same class queues, so rounds coalesce
  across processes: one padded device dispatch per round for the whole
  rack. Per-client FIFO holds because each connection's frames decode
  and enqueue in read order and the scheduler preserves per-class FIFO.
  The server also serves its own `/metrics` + `/dump_dispatch_ledger`
  over a TCP stats port (reusing libs/metrics + obs/ledger), so the
  multi-tenant device bill now has real tenants: per-client
  submission/row counts ride the dump next to the per-class ledger.

- **`RemoteVerifyScheduler`**: the client, with the exact
  `submit`/`submit_fn`/`submit_sync`/`submit_fn_sync`/`classed` surface
  of the in-proc scheduler, so `set_default_scheduler(remote)` captures
  every subsystem's verify path unchanged. Connection retry with capped
  exponential backoff; when the socket dies MID-FLIGHT every pending
  submission degrades to the local in-proc verifier on this process —
  the backend-guard philosophy: never hang, never silently drop a
  verdict. Each degrade lands a structured `verify_service.degrade`
  tracer event + `tm_verify_remote_degrades_total`; submit→verdict
  round trips feed cumulative `ipc_stats()` that the health plane's
  `ipc_round_trip` detector (obs/health.py) watches for drift.

- **fn lanes ride the same wire**: callers whose private-engine rounds
  are pure functions of wire-able items submit them by NAME to engines
  registered server-side — `bls_agg` (grouped same-message BLS
  aggregate verification over raw public-key bytes; the client resolves
  tm→BLS keys since the registry is client-side state) and
  `secp_recover` (sequencer ECDSA: eth-address recovery over
  (hash, sig) pairs; the membership check stays client-side). Closures
  that cannot cross a process boundary run locally, exactly as before.

Wire format (all integers big-endian):

    frame    := u32 length | payload            (length = len(payload))
    payload  := u8 type | u64 request_id | body
    SUBMIT(1)       body := str8 klass | u32 n | n * sigitem | [ctx]
    sigitem         := str8 key_type | bytes16 pubkey | bytes32 msg
                       | bytes16 sig
    VERDICTS(2)     body := u32 n | ceil(n/8) bitmap (little-bit-order)
    SUBMIT_FN(3)    body := str8 klass | str8 engine | u32 n | n * item
                    | [ctx]
    item            := u8 nparts | nparts * bytes32
    ctx             := u64 height | u32 round | str8 origin
                    (optional trailer: clients stamp the consensus
                    height in progress + their identity so the service
                    records queue/dispatch/device sub-spans under the
                    submitter's span context; a decoder that stops at
                    the last item ignores it, so old servers accept new
                    clients and vice versa)
    FN_RESULTS(4)   body := u32 n | n * (u8 tag | [u32 len | bytes])
                    tag: 0=False 1=True 2=None 3=bytes
    PING(5)/PONG(6) body := opaque (echoed verbatim)
    STATS(7)        body := empty
    STATS_RESULT(8) body := u32 len | JSON
    ERROR(9)        body := u32 len | utf-8 message

`str8` = u8 length + bytes; `bytes16`/`bytes32` = u16/u32 length +
bytes. Frames are capped at MAX_FRAME; an oversized or undecodable
frame errors the connection (the client degrades and reconnects).
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..crypto.batch_verifier import BatchVerifier, SigItem, default_verifier
from ..crypto.shape_registry import default_shape_registry
from ..device import resolve
from ..libs.log import Logger, nop_logger
from ..libs.metrics import (
    Registry,
    RemoteSchedulerMetrics,
    default_metrics,
    default_registry,
)
from ..obs import default_tracer
from ..obs.ledger import default_ledger
from .scheduler import VerifyScheduler, _ClassedVerifier

MSG_SUBMIT = 1
MSG_VERDICTS = 2
MSG_SUBMIT_FN = 3
MSG_FN_RESULTS = 4
MSG_PING = 5
MSG_PONG = 6
MSG_STATS = 7
MSG_STATS_RESULT = 8
MSG_ERROR = 9

# one frame bounds one submission; 64 MiB holds ~380k vote-sized items,
# far past max_batch — anything bigger is a protocol violation, not load
MAX_FRAME = 64 * 1024 * 1024

# structured degrade event name (tracer ring / dump_traces)
DEGRADE_EVENT = "verify_service.degrade"

_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_HDR = struct.Struct(">BQ")  # type, request_id


# Frame decode violations (cap, truncation, unknown tag) share the
# engine-item violation class — both are protocol errors, and the
# engines live in parallel/engines.py so the in-proc scheduler resolves
# the same table
from .engines import WireError  # noqa: F401  (re-export, wire contract)


# --- encoding helpers -------------------------------------------------------


def _put_str8(out: list, s: str) -> None:
    b = s.encode()
    if len(b) > 255:
        raise WireError(f"str8 too long: {len(b)}")
    out.append(_U8.pack(len(b)))
    out.append(b)


def _put_bytes16(out: list, b: bytes) -> None:
    if len(b) > 0xFFFF:
        raise WireError(f"bytes16 too long: {len(b)}")
    out.append(_U16.pack(len(b)))
    out.append(b)


def _put_bytes32(out: list, b: bytes) -> None:
    out.append(_U32.pack(len(b)))
    out.append(b)


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise WireError("truncated frame")
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b

    def u8(self) -> int:
        return _U8.unpack(self.take(1))[0]

    def u16(self) -> int:
        return _U16.unpack(self.take(2))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def str8(self) -> str:
        try:
            return self.take(self.u8()).decode()
        except UnicodeDecodeError as e:
            # a corrupt name field is a protocol violation like any
            # other malformed frame — it must ride the WireError
            # contract, not kill the handler task unlogged
            raise WireError(f"invalid str8: {e}") from None

    def bytes16(self) -> bytes:
        return self.take(self.u16())

    def bytes32(self) -> bytes:
        return self.take(self.u32())


def _put_trace_ctx(out: list, ctx) -> None:
    """Optional trace-context trailer: (height, round, origin)."""
    if ctx is None:
        return
    height, round_, origin = ctx
    out.append(_U64.pack(max(0, int(height))))
    out.append(_U32.pack(max(0, int(round_))))
    _put_str8(out, str(origin))


def decode_trace_ctx(cur: _Cursor, req_id: int):
    """The trailer, if the frame carries one; the req_id joins the
    client's round-trip span to the service's sub-spans. Returns
    (height, round, origin, req_id) or None."""
    if cur.off >= len(cur.buf):
        return None
    height = _U64.unpack(cur.take(8))[0]
    round_ = cur.u32()
    origin = cur.str8()
    return (height, round_, origin, req_id)


def encode_submit(
    req_id: int, items: list[SigItem], klass: str, ctx=None
) -> bytes:
    out = [_HDR.pack(MSG_SUBMIT, req_id)]
    _put_str8(out, klass)
    out.append(_U32.pack(len(items)))
    for it in items:
        _put_str8(out, it.key_type)
        _put_bytes16(out, bytes(it.pubkey))
        _put_bytes32(out, bytes(it.msg))
        _put_bytes16(out, bytes(it.sig))
    _put_trace_ctx(out, ctx)
    return b"".join(out)


def decode_submit(cur: _Cursor) -> tuple[list[SigItem], str]:
    klass = cur.str8()
    n = cur.u32()
    items = []
    for _ in range(n):
        key_type = cur.str8() or "ed25519"
        pubkey = cur.bytes16()
        msg = cur.bytes32()
        sig = cur.bytes16()
        items.append(SigItem(pubkey, msg, sig, key_type))
    return items, klass


def encode_verdicts(req_id: int, verdicts: np.ndarray) -> bytes:
    arr = np.asarray(verdicts, dtype=bool)
    bitmap = np.packbits(arr.astype(np.uint8), bitorder="little").tobytes()
    return b"".join(
        (_HDR.pack(MSG_VERDICTS, req_id), _U32.pack(arr.size), bitmap)
    )


def decode_verdicts(cur: _Cursor) -> np.ndarray:
    n = cur.u32()
    bitmap = cur.take((n + 7) // 8)
    if n == 0:
        return np.zeros(0, dtype=bool)
    return (
        np.unpackbits(
            np.frombuffer(bitmap, dtype=np.uint8),
            count=n,
            bitorder="little",
        ).astype(bool)
    )


def encode_submit_fn(
    req_id: int, engine: str, items: list[tuple], klass: str, ctx=None
) -> bytes:
    out = [_HDR.pack(MSG_SUBMIT_FN, req_id)]
    _put_str8(out, klass)
    _put_str8(out, engine)
    out.append(_U32.pack(len(items)))
    for parts in items:
        if len(parts) > 255:
            raise WireError("fn item has too many parts")
        out.append(_U8.pack(len(parts)))
        for p in parts:
            _put_bytes32(out, bytes(p))
    _put_trace_ctx(out, ctx)
    return b"".join(out)


def decode_submit_fn(cur: _Cursor) -> tuple[str, list[tuple], str]:
    klass = cur.str8()
    engine = cur.str8()
    n = cur.u32()
    items = [
        tuple(cur.bytes32() for _ in range(cur.u8())) for _ in range(n)
    ]
    return engine, items, klass


def encode_fn_results(req_id: int, results: list) -> bytes:
    out = [_HDR.pack(MSG_FN_RESULTS, req_id), _U32.pack(len(results))]
    for r in results:
        if r is None:
            out.append(_U8.pack(2))
        elif isinstance(r, (bytes, bytearray)):
            out.append(_U8.pack(3))
            _put_bytes32(out, bytes(r))
        else:
            out.append(_U8.pack(1 if r else 0))
    return b"".join(out)


def decode_fn_results(cur: _Cursor) -> list:
    n = cur.u32()
    out: list = []
    for _ in range(n):
        tag = cur.u8()
        if tag == 0:
            out.append(False)
        elif tag == 1:
            out.append(True)
        elif tag == 2:
            out.append(None)
        elif tag == 3:
            out.append(cur.bytes32())
        else:
            raise WireError(f"unknown fn-result tag {tag}")
    return out


def encode_error(req_id: int, message: str) -> bytes:
    b = message.encode()[:4096]
    return b"".join((_HDR.pack(MSG_ERROR, req_id), _U32.pack(len(b)), b))


async def read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
    """One length-prefixed frame, or None on clean EOF."""
    try:
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (length,) = _U32.unpack(hdr)
    if length > MAX_FRAME:
        raise WireError(f"frame of {length} bytes exceeds cap")
    try:
        return await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None


def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_U32.pack(len(payload)) + payload)


# --- server-side fn engines -------------------------------------------------
# The table lives in parallel/engines.py (shared with the in-proc
# scheduler's submit_wire_fn); re-exported names keep existing callers
# (tools/verify_service_bench.py) working.

from .engines import (  # noqa: E402,F401
    BUILTIN_ENGINES,
    _engine_bls_agg,
    _engine_secp_recover,
)


# --- the server -------------------------------------------------------------


class VerifyServiceServer:
    """Owns the scheduler/device plane and serves the UDS protocol.

    Lifecycle: construct, `await start()` on the serving loop,
    `await stop()`. `stats_port` > 0 additionally serves GET /metrics
    (the process registry, text exposition), GET /dump_dispatch_ledger
    (the same JSON shape as the node RPC route, plus per-client tenant
    rows) and GET /dump_traces (the service flight ring in the node
    dump_traces shape, mergeable by obs/cluster.py) over TCP —
    `tools/device_report.py` reads those dumps directly."""

    def __init__(
        self,
        path: str,
        scheduler: Optional[VerifyScheduler] = None,
        verifier=None,
        max_batch: int = 16384,
        logger: Optional[Logger] = None,
        stats_port: Optional[int] = None,
        stats_host: str = "127.0.0.1",
        registry: Optional[Registry] = None,
        engines: Optional[dict] = None,
        tracer=None,
        device: str = "cuda",
    ):
        self.path = path
        self.logger = logger or nop_logger()
        # resolved here, on the caller's thread: without CUDA the default
        # raises now, not inside a ServiceThread's loop
        self.device = resolve(device)
        if scheduler is None and verifier is None:
            verifier = BatchVerifier(device=self.device)
        # the service's own flight ring: traced client submissions land
        # their queue/dispatch/device sub-spans here, and GET
        # /dump_traces on the stats port ships it in the dump_traces
        # shape so obs/cluster.py merges it next to validator dumps
        # (is-None check — an empty Tracer is falsy via __len__)
        self.tracer = tracer
        self.scheduler = scheduler or VerifyScheduler(
            verifier=verifier, max_batch=max_batch, logger=self.logger,
            tracer=tracer,
        )
        self.registry = registry or default_registry()
        self.stats_port = stats_port
        self.stats_host = stats_host
        self.engines = dict(BUILTIN_ENGINES)
        if engines:
            self.engines.update(engines)
        self._server: Optional[asyncio.AbstractServer] = None
        self._stats_server: Optional[asyncio.AbstractServer] = None
        self._sock_ino: Optional[int] = None  # the socket file this server bound
        self._conn_tasks: set[asyncio.Task] = set()
        self._next_client = 0
        # tenant accounting: client_id -> {submissions, rows, ...}
        # (per CONNECTION; a closed client's spend stays in the bill —
        # a tenant's work doesn't vanish on disconnect). BOUNDED: a
        # closed connection that never submitted is dropped outright
        # (a flapping client at the 2 s backoff cap would otherwise
        # add ~43k dead entries/day), and past MAX_CLIENT_STATS the
        # oldest CLOSED entries fold into one "_closed" aggregate row
        # so the table and every STATS/dump response stay bounded
        self.client_stats: dict[str, dict] = {}
        self.max_client_stats = 1024

    async def start(self) -> None:
        if not self.scheduler.running:
            await self.scheduler.start()
        # a stale socket file from a crashed predecessor refuses bind
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._server = await asyncio.start_unix_server(
            self._handle_conn, path=self.path
        )
        self._sock_ino = os.stat(self.path).st_ino
        # stats_port None = no HTTP surface; 0 = ephemeral (read the
        # bound port back from .stats_port)
        if self.stats_port is not None:
            self._stats_server = await asyncio.start_server(
                self._handle_stats_http, self.stats_host, self.stats_port
            )
            self.stats_port = (
                self._stats_server.sockets[0].getsockname()[1]
            )
        self.logger.info(
            "verify service listening", socket=self.path,
            stats_port=self.stats_port or None,
        )

    async def stop(self) -> None:
        servers = [
            s for s in (self._server, self._stats_server) if s is not None
        ]
        for srv in servers:
            srv.close()
        # wait_closed() awaits every accepted connection since py3.12, and
        # an attached client or an idle stats prober holds its own open:
        # end the handlers of both servers, again for any accepted before
        # close() whose handler had yet to start, until both are closed
        closed = asyncio.ensure_future(
            asyncio.gather(*(srv.wait_closed() for srv in servers))
        )
        while True:
            for t in list(self._conn_tasks):
                t.cancel()
            done, _ = await asyncio.wait([closed], timeout=0.05)
            if done:
                break
        self._server = self._stats_server = None
        await self.scheduler.stop()
        try:
            # a successor may have bound this path since (a restart after
            # a stop that outlived its caller's wait): its socket stays
            if os.stat(self.path).st_ino == self._sock_ino:
                os.unlink(self.path)
        except FileNotFoundError:
            pass

    # --- stats/dump surface ------------------------------------------------

    def dump(self, entries: int = 128) -> dict:
        """The dump_dispatch_ledger shape + the tenant table."""
        ledger = self.scheduler.ledger
        return {
            "enabled": True,
            "service": {"socket": self.path, "pid": os.getpid()},
            "summary": ledger.summary(),
            "entries": ledger.entries(limit=entries) if entries > 0 else [],
            "shape_registry": default_shape_registry().snapshot(),
            "per_client": {
                k: dict(v) for k, v in sorted(self.client_stats.items())
            },
        }

    def _trace(self):
        from ..obs import default_tracer as _dt

        return self.tracer if self.tracer is not None else _dt()

    def trace_dump(self) -> dict:
        """The service ring in the node `dump_traces` response shape, so
        obs.cluster.normalize_dump accepts it unchanged. No peer_clock:
        the service sits outside the p2p NTP graph, which routes its
        merge through the raw-wall-anchor fallback by design."""
        tracer = self._trace()
        return {
            "enabled": tracer.enabled,
            "epoch_wall_ns": tracer.epoch_wall_ns,
            "node_id": f"verify-service-{os.getpid()}",
            "moniker": "verify-service",
            "peer_clock": {},
            "records": [r.to_json() for r in tracer.records()],
        }

    # --- UDS protocol ------------------------------------------------------

    def _prune_client_stats(self) -> None:
        """Fold the oldest closed per-connection rows into "_closed"
        once the table exceeds max_client_stats (insertion order =
        connection order, so iteration finds the oldest first). Live
        connections alone fold nothing and leave no "_closed" row: idle
        clients that never submitted owe nothing."""
        closed = [
            k
            for k, v in self.client_stats.items()
            if v.get("closed") and k != "_closed"
        ]
        if not closed:
            return
        agg = self.client_stats.setdefault(
            "_closed",
            {"submissions": 0, "rows": 0, "fn_submissions": 0,
             "fn_items": 0, "clients": 0},
        )
        excess = len(self.client_stats) - self.max_client_stats
        for name in closed[:max(0, excess)]:
            v = self.client_stats.pop(name)
            for key in ("submissions", "rows", "fn_submissions",
                        "fn_items"):
                agg[key] += v[key]
            agg["clients"] += 1

    async def _handle_conn(self, reader, writer) -> None:
        self._next_client += 1
        client = f"client-{self._next_client}"
        stats = self.client_stats[client] = {
            "submissions": 0, "rows": 0, "fn_submissions": 0,
            "fn_items": 0,
        }
        if len(self.client_stats) > self.max_client_stats:
            self._prune_client_stats()
        wlock = asyncio.Lock()
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        pending: set[asyncio.Task] = set()

        async def send(payload: bytes) -> None:
            async with wlock:
                write_frame(writer, payload)
                await writer.drain()

        def spawn(coro) -> None:
            t = asyncio.get_running_loop().create_task(coro)
            pending.add(t)
            t.add_done_callback(pending.discard)

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                cur = _Cursor(frame)
                typ, req_id = _HDR.unpack(cur.take(_HDR.size))
                if typ == MSG_SUBMIT:
                    items, klass = decode_submit(cur)
                    ctx = decode_trace_ctx(cur, req_id)
                    stats["submissions"] += 1
                    stats["rows"] += len(items)
                    # create_task here, synchronously in read order:
                    # tasks first run in creation order and submit()
                    # enqueues before its first await point, so one
                    # client's submissions keep FIFO within their class
                    spawn(
                        self._do_submit(send, req_id, items, klass, ctx)
                    )
                elif typ == MSG_SUBMIT_FN:
                    engine, items, klass = decode_submit_fn(cur)
                    ctx = decode_trace_ctx(cur, req_id)
                    stats["fn_submissions"] += 1
                    stats["fn_items"] += len(items)
                    spawn(
                        self._do_submit_fn(
                            send, req_id, engine, items, klass, ctx
                        )
                    )
                elif typ == MSG_PING:
                    await send(
                        _HDR.pack(MSG_PONG, req_id)
                        + cur.buf[cur.off :]
                    )
                elif typ == MSG_STATS:
                    body = json.dumps(self.dump()).encode()
                    await send(
                        _HDR.pack(MSG_STATS_RESULT, req_id)
                        + _U32.pack(len(body))
                        + body
                    )
                else:
                    await send(
                        encode_error(req_id, f"unknown frame type {typ}")
                    )
        except (WireError, ConnectionError, OSError) as e:
            self.logger.error(
                "verify-service connection error", client=client,
                err=repr(e),
            )
        finally:
            self._conn_tasks.discard(task)
            for t in pending:
                t.cancel()
            if stats["submissions"] or stats["fn_submissions"]:
                stats["closed"] = True  # spend stays billable
            else:
                # a connection that never submitted owes nothing —
                # dropping it keeps a flapping client from growing
                # the table
                self.client_stats.pop(client, None)
            writer.close()

    def _service_span(self, ctx, t_recv: float, n: int, klass: str) -> None:
        """End-to-end service-side span for one traced submission
        (decode -> verdicts encoded); the queue/device slices inside it
        are recorded by the scheduler under the same ctx."""
        if ctx is None:
            return
        height, round_, origin, req = ctx
        self._trace().add_span(
            "verify.service", t_recv, time.perf_counter() - t_recv,
            height=height, round=round_, origin=origin, req=req,
            n=n, klass=klass,
        )

    async def _do_submit(self, send, req_id, items, klass, ctx=None):
        t_recv = time.perf_counter()
        try:
            verdicts = await self.scheduler.submit(items, klass, ctx=ctx)
        except Exception as e:
            await self._send_guarded(
                send, encode_error(req_id, f"verify failed: {e!r}")
            )
            return
        self._service_span(ctx, t_recv, len(items), klass)
        await self._send_guarded(send, encode_verdicts(req_id, verdicts))

    async def _do_submit_fn(
        self, send, req_id, engine, items, klass, ctx=None
    ):
        fn = self.engines.get(engine)
        if fn is None:
            await self._send_guarded(
                send, encode_error(req_id, f"unknown fn engine {engine!r}")
            )
            return
        t_recv = time.perf_counter()
        try:
            results = await self.scheduler.submit_fn(
                items, fn, klass, engine=engine, ctx=ctx
            )
        except Exception as e:
            await self._send_guarded(
                send,
                encode_error(req_id, f"fn engine {engine} failed: {e!r}"),
            )
            return
        self._service_span(ctx, t_recv, len(items), klass)
        await self._send_guarded(send, encode_fn_results(req_id, results))

    async def _send_guarded(self, send, payload: bytes) -> None:
        # the client vanishing mid-response is its problem, not ours —
        # its pending futures degrade locally on its side
        try:
            await send(payload)
        except (ConnectionError, OSError):
            pass

    # --- stats HTTP (GET /metrics + /dump_dispatch_ledger) ----------------

    async def _handle_stats_http(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            req_line = await reader.readline()
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            try:
                method, target, _ = (
                    req_line.decode().strip().split(" ", 2)
                )
            except (ValueError, UnicodeDecodeError):
                return
            path = target.split("?", 1)[0]
            if method != "GET":
                body, status, ctype = b"method not allowed\n", 405, "text/plain"
            elif path == "/metrics":
                body = self.registry.render().encode()
                status, ctype = 200, "text/plain; version=0.0.4"
            elif path == "/dump_dispatch_ledger":
                body = json.dumps(self.dump()).encode()
                status, ctype = 200, "application/json"
            elif path == "/dump_traces":
                body = json.dumps(self.trace_dump()).encode()
                status, ctype = 200, "application/json"
            else:
                body, status, ctype = b"not found\n", 404, "text/plain"
            reason = {200: "OK", 404: "Not Found",
                      405: "Method Not Allowed"}[status]
            writer.write(
                f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n".encode() + body
            )
            await writer.drain()
        finally:
            self._conn_tasks.discard(task)
            writer.close()


# --- the client -------------------------------------------------------------


class _RemoteReq:
    __slots__ = (
        "kind", "items", "klass", "future", "fallback", "t0", "ctx",
    )

    def __init__(self, kind, items, klass, future, fallback, t0, ctx=None):
        self.kind = kind  # "sig" | "fn"
        self.items = items
        self.klass = klass
        self.future = future
        self.fallback = fallback  # zero-arg callable for the local path
        self.t0 = t0
        self.ctx = ctx  # (height, round, origin, req_id) when traced


class RemoteVerifyScheduler:
    """Client half of the split-brain deployment: the VerifyScheduler
    surface (`submit`/`submit_fn`/`submit_sync`/`submit_fn_sync`/
    `classed`) over a UDS connection to a VerifyServiceServer, selected
    by `[scheduler] remote_socket` in node assembly.

    Degradation contract (the backend-guard philosophy — never hang, never
    silently drop): while disconnected, and for every submission
    in flight when the socket dies, work runs on the LOCAL in-proc
    verifier instead; each occurrence lands a structured
    `verify_service.degrade` tracer event and counts in
    `tm_verify_remote_degrades_total`. The connection manager retries
    with capped exponential backoff and re-attaches transparently —
    callers only ever see verdicts. A wedged-but-open service (alive
    socket, no replies) is the `ipc_round_trip` health detector's job:
    this client feeds it cumulative submit→verdict latency via
    `ipc_stats()`.

    fn lanes: `submit_fn(_sync)` runs closures LOCALLY (a process
    boundary cannot ship a closure); `submit_wire_fn(_sync)` ships
    items by engine name to the service (bls_agg, secp_recover) with a
    caller-supplied local fallback."""

    def __init__(
        self,
        path: str,
        verifier=None,
        logger: Optional[Logger] = None,
        metrics: Optional[RemoteSchedulerMetrics] = None,
        tracer=None,
        retry_base: float = 0.05,
        retry_cap: float = 2.0,
        origin: str = "",
    ):
        self.path = path
        self._verifier = verifier
        self.logger = logger or nop_logger()
        self.metrics = metrics or default_metrics(RemoteSchedulerMetrics)
        self.tracer = tracer
        # identity stamped into each submission's wire trace context so
        # the service's queue/device sub-spans name their submitter
        # (node assembly passes the node id; harnesses a worker label)
        self.origin = origin or f"client-{os.getpid()}"
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._wlock: Optional[asyncio.Lock] = None
        self._manager: Optional[asyncio.Task] = None
        # degrade fallbacks run on a PRIVATE pool, never the shared
        # default executor: the callers waiting on those fallbacks are
        # worker threads that each HOLD a default-executor slot
        # (min(32, cpus+4) = 6 on a 2-core box), so a service death
        # with enough submissions in flight used to park every slot on
        # work that could only run in one of those slots — the net
        # froze at the height the kill landed on (the
        # submit_sync deadlock class, one level up)
        self._fallback_pool: Optional[ThreadPoolExecutor] = None
        self._running = False
        self._connected = asyncio.Event()
        self._next_id = 0
        self._pending: dict[int, _RemoteReq] = {}
        # cumulative IPC round-trip accounting for the health seam
        # (plain counters so the pull-delta pattern works without
        # metrics objects); guarded by the GIL — single-writer loop
        self._rtt_count = 0
        self._rtt_sum = 0.0
        self._remote_submissions = 0
        self._degrades = 0
        self._reconnects = 0

    # the local fallback verifier, resolved lazily so constructing a
    # RemoteVerifyScheduler never forces a device init by itself
    @property
    def verifier(self):
        if self._verifier is None:
            self._verifier = default_verifier()
        return self._verifier

    @property
    def running(self) -> bool:
        return self._running

    @property
    def connected(self) -> bool:
        return self._writer is not None

    # ledger parity with VerifyScheduler (node assembly binds
    # health/fill seams to `.ledger`): remote rounds are booked on the
    # SERVICE's ledger, so the client exposes the process default —
    # local degraded rounds the fallback verifier drives are direct
    # dispatches and show up in the shape registry instead
    @property
    def ledger(self):
        return default_ledger()

    def _trace(self):
        # is-None check (Tracer defines __len__; `or` discards an
        # injected-but-empty ring — the falsy-tracer class)
        return default_tracer() if self.tracer is None else self.tracer

    def ipc_stats(self) -> dict:
        """Cumulative client-side IPC counters (health pull seam)."""
        return {
            "rtt_count": self._rtt_count,
            "rtt_sum_s": self._rtt_sum,
            "remote_submissions": self._remote_submissions,
            "degrades": self._degrades,
            "reconnects": self._reconnects,
            "connected": self.connected,
        }

    # --- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._loop = asyncio.get_running_loop()
        self._wlock = asyncio.Lock()
        self._connected = asyncio.Event()
        self._fallback_pool = ThreadPoolExecutor(
            2, thread_name_prefix="verify-degrade"
        )
        self._running = True
        self._manager = self._loop.create_task(self._run())

    async def stop(self) -> None:
        self._running = False
        manager, self._manager = self._manager, None
        if manager is not None:
            manager.cancel()
            try:
                await manager
            except (asyncio.CancelledError, Exception):
                pass
        self._teardown_conn()
        # resolve anything still pending locally — stop() must not
        # strand a caller
        self._degrade_pending("client stopped")
        pool, self._fallback_pool = self._fallback_pool, None
        if pool is not None:
            # queued (not yet running) fallbacks still execute;
            # shutdown only refuses NEW work after the drain above
            pool.shutdown(wait=False)

    async def _run(self) -> None:
        backoff = self.retry_base
        while self._running:
            try:
                reader, writer = await asyncio.open_unix_connection(
                    self.path
                )
            except (ConnectionError, OSError, FileNotFoundError):
                await asyncio.sleep(backoff)
                backoff = min(self.retry_cap, backoff * 2)
                continue
            backoff = self.retry_base
            self._writer = writer
            self._connected.set()
            self._reconnects += 1
            self.metrics.reconnects.inc()
            self.logger.info(
                "verify-service attached", socket=self.path
            )
            try:
                await self._read_loop(reader)
            except (ConnectionError, OSError, WireError) as e:
                self.logger.error(
                    "verify-service connection lost", err=repr(e)
                )
            finally:
                self._teardown_conn()
                self._degrade_pending("connection lost mid-flight")

    def _teardown_conn(self) -> None:
        self._connected.clear()
        writer, self._writer = self._writer, None
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_loop(self, reader) -> None:
        while True:
            frame = await read_frame(reader)
            if frame is None:
                raise ConnectionError("verify service closed the socket")
            cur = _Cursor(frame)
            typ, req_id = _HDR.unpack(cur.take(_HDR.size))
            req = self._pending.pop(req_id, None)
            if req is None:
                continue  # degraded already (e.g. raced a reconnect)
            now = time.perf_counter()
            if typ == MSG_VERDICTS and req.kind == "sig":
                self._book_rtt(req, now)
                if not req.future.done():
                    req.future.set_result(decode_verdicts(cur))
            elif typ == MSG_FN_RESULTS and req.kind == "fn":
                self._book_rtt(req, now)
                if not req.future.done():
                    req.future.set_result(decode_fn_results(cur))
            elif typ == MSG_ERROR:
                msg = cur.bytes32().decode(errors="replace")
                self._degrade_one(req, f"service error: {msg}")
            else:
                self._degrade_one(
                    req, f"mismatched response type {typ}"
                )

    def _book_rtt(self, req: _RemoteReq, now: float) -> None:
        dt = max(0.0, now - req.t0)
        self._rtt_count += 1
        self._rtt_sum += dt
        self.metrics.rtt_seconds.observe(dt)
        if req.ctx is not None:
            # the client-observed round trip, on the NODE's own ring
            # and under the height it was stamped with: the per-height
            # conservation audit bills this as verify_ipc, and the
            # cluster merge joins it (via origin+req) to the service's
            # queue/device sub-spans to expose the wire overhead
            height, round_, origin, rid = req.ctx
            self._trace().add_span(
                "verify.ipc", req.t0, dt,
                height=height, round=round_, origin=origin, req=rid,
                n=len(req.items), klass=req.klass,
            )

    # --- degradation -------------------------------------------------------

    def _degrade_event(self, reason: str, klass: str, n: int) -> None:
        self._degrades += 1
        self.metrics.degrades.inc()
        self._trace().event(DEGRADE_EVENT, reason=reason, klass=klass, n=n)

    def _degrade_one(self, req: _RemoteReq, reason: str) -> None:
        """Resolve one request through its local path on the PRIVATE
        fallback pool — never the event loop, and never the shared
        default executor (whose slots the waiting callers hold)."""
        if req.future.done():
            return
        self._degrade_event(reason, req.klass, len(req.items))
        pool = self._fallback_pool
        fut = self._loop.run_in_executor(pool, req.fallback)

        def _done(f):
            if req.future.done():
                return
            exc = f.exception()
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(f.result())

        fut.add_done_callback(_done)

    def _degrade_pending(self, reason: str) -> None:
        pending, self._pending = self._pending, {}
        for req in pending.values():
            self._degrade_one(req, reason)

    # --- submission --------------------------------------------------------

    async def submit(
        self, items: list[SigItem], klass: str = "consensus"
    ) -> np.ndarray:
        items = list(items)
        if not items:
            return np.zeros(0, dtype=bool)
        fallback = lambda: np.asarray(self.verifier.verify(items))  # noqa: E731
        if not self._running or not self.connected:
            if self._running:
                self._degrade_event("service unreachable", klass, len(items))
            return await asyncio.get_running_loop().run_in_executor(
                self._fallback_pool if self._running else None, fallback
            )
        return await self._send_req("sig", items, klass, fallback)

    async def submit_fn(
        self, items: list, fn: Callable[[list], list],
        klass: str = "consensus", engine: str = "fn",
    ):
        """Closure lane: a function object cannot cross the process
        boundary, so it runs locally (off-loop) — identical semantics
        to the in-proc scheduler's degraded path. Wire-able engines go
        through submit_wire_fn instead (`engine` here is only the
        accounting label, accepted for surface parity)."""
        items = list(items)
        if not items:
            return []
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, items
        )

    async def submit_wire_fn(
        self,
        engine: str,
        items: list[tuple],
        klass: str = "consensus",
        fallback: Optional[Callable[[], list]] = None,
    ):
        items = list(items)
        if not items:
            return []
        fb = fallback or (lambda: [None] * len(items))
        if not self._running or not self.connected:
            if self._running:
                self._degrade_event("service unreachable", klass, len(items))
            return await asyncio.get_running_loop().run_in_executor(
                self._fallback_pool if self._running else None, fb
            )
        return await self._send_req(
            "fn", items, klass, fb, engine=engine
        )

    async def _send_req(self, kind, items, klass, fallback, engine=""):
        from ..obs.tracer import height_hint

        self._next_id += 1
        req_id = self._next_id
        # trace context: the consensus height in progress (published by
        # the state machine on every step transition) + this client's
        # identity. Always stamped — ~15 bytes on the wire — so the
        # service side can attribute even when the client's own ring is
        # off; recording on either side stays gated on its tracer.
        height, round_ = height_hint()
        wire_ctx = (height, round_, self.origin)
        req = _RemoteReq(
            kind, items, klass, self._loop.create_future(), fallback,
            time.perf_counter(), ctx=(height, round_, self.origin, req_id),
        )
        self._pending[req_id] = req
        try:
            payload = (
                encode_submit(req_id, items, klass, ctx=wire_ctx)
                if kind == "sig"
                else encode_submit_fn(
                    req_id, engine, items, klass, ctx=wire_ctx
                )
            )
            async with self._wlock:
                writer = self._writer
                if writer is None:
                    raise ConnectionError("not connected")
                write_frame(writer, payload)
                await writer.drain()
        except (ConnectionError, OSError, WireError) as e:
            # degrade only if WE still own the request: a teardown that
            # raced this send (read loop died while drain() was
            # suspended) already popped it via _degrade_pending — a
            # second _degrade_one would verify the batch locally twice
            # and double-count the degrade
            if self._pending.pop(req_id, None) is not None:
                self._degrade_one(req, f"send failed: {e!r}")
        else:
            self._remote_submissions += 1
            self.metrics.submissions.inc(
                klass="fn" if kind == "fn" else klass
            )
        return await req.future

    # --- thread bridges (the VerifyScheduler surface) ----------------------

    def submit_sync(
        self, items: list[SigItem], klass: str = "consensus"
    ) -> np.ndarray:
        items = list(items)
        loop = self._loop
        if not self._running or loop is None or _on_loop_thread():
            return np.asarray(self.verifier.verify(items))
        if not self.connected:
            # degraded-mode fast path: run the local verify ON THE
            # CALLING worker thread instead of bouncing loop -> pool
            # (the thread already owns an executor slot; see
            # _fallback_pool). A reconnect racing this check costs one
            # extra local verify, never a wrong verdict.
            self._degrade_event("service unreachable", klass, len(items))
            return np.asarray(self.verifier.verify(items))
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self.submit(items, klass), loop
            )
            return np.asarray(fut.result())
        except Exception as e:
            self.logger.error(
                "remote verify failed; direct dispatch", err=repr(e)
            )
            return np.asarray(self.verifier.verify(items))

    def submit_fn_sync(
        self, items: list, fn: Callable[[list], list],
        klass: str = "consensus", engine: str = "fn",
    ):
        # closures run on the calling worker thread — exactly where the
        # in-proc scheduler's degraded path runs them
        return fn(list(items))

    def submit_wire_fn_sync(
        self,
        engine: str,
        items: list[tuple],
        klass: str = "consensus",
        fallback: Optional[Callable[[], list]] = None,
    ):
        items = list(items)
        fb = fallback or (lambda: [None] * len(items))
        loop = self._loop
        if not self._running or loop is None or _on_loop_thread():
            return fb()
        if not self.connected:
            # same calling-thread fast path as submit_sync
            self._degrade_event("service unreachable", klass, len(items))
            return fb()
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self.submit_wire_fn(engine, items, klass, fb), loop
            )
            return fut.result()
        except Exception as e:
            self.logger.error(
                "remote fn-lane verify failed; local fallback",
                err=repr(e),
            )
            return fb()

    def classed(self, klass: str) -> _ClassedVerifier:
        """BatchVerifier-shaped handle submitting under `klass` (the
        same adapter the in-proc scheduler hands out — it only needs
        submit_sync + .verifier)."""
        return _ClassedVerifier(self, klass)


def _on_loop_thread() -> bool:
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return False
    return True


# --- standalone runtime ------------------------------------------------------


def run_service(
    path: str,
    max_batch: int = 16384,
    stats_port: Optional[int] = None,
    prewarm: bool = False,
    logger: Optional[Logger] = None,
    ready_fd: Optional[int] = None,
    trace: bool = False,
    device: str = "cuda",
) -> int:
    """Blocking service runtime for the CLI entrypoint: build the
    scheduler (which builds the process verifier/mesh on first
    dispatch), optionally AOT-prewarm the bucket ladder, serve until
    SIGINT/SIGTERM. `ready_fd` (harness use) gets one JSON line
    ({"ready": true, "stats_port": N}) written when the socket is
    accepting — spawners wait on it instead of polling. `trace` (or
    TM_TPU_TRACE=1) arms the service flight ring served at
    GET /dump_traces on the stats port. `device` is the card the
    service verifies on ("cpu" on a machine without CUDA)."""
    import signal

    from ..obs import Tracer, set_default_tracer

    logger = logger or nop_logger()
    tracer = set_default_tracer(
        Tracer(enabled=trace or os.environ.get("TM_TPU_TRACE") == "1")
    )
    server = VerifyServiceServer(
        path, max_batch=max_batch, logger=logger, stats_port=stats_port,
        tracer=tracer, device=device,
    )

    async def run() -> None:
        await server.start()
        if prewarm:
            try:
                entries = server.scheduler.verifier.prewarm_buckets()
                logger.info(
                    "verify-service prewarm complete",
                    programs=len(entries),
                )
            except Exception as e:
                logger.error("verify-service prewarm failed", err=repr(e))
        if ready_fd is not None:
            os.write(
                ready_fd,
                json.dumps(
                    {"ready": True, "stats_port": server.stats_port}
                ).encode(),
            )
            os.close(ready_fd)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        try:
            await stop.wait()
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


class ServiceThread:
    """In-process service on its own event-loop thread — the unit-test
    and single-process-harness runtime (the production topology runs
    `python -m tendermint_tpu_torch verify-service` instead)."""

    def __init__(self, path: str, device: str = "cuda", **kw):
        self.server = VerifyServiceServer(path, device=device, **kw)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self.server.start())
            started.set()
            loop.run_forever()
            loop.run_until_complete(self.server.stop())
            loop.close()

        self._thread = threading.Thread(
            target=run, name="verify-service", daemon=True
        )
        self._thread.start()
        if not started.wait(30):
            raise RuntimeError("verify service failed to start")

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._loop = self._thread = None
