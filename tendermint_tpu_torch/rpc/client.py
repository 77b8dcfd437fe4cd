"""RPC clients: HTTP (keep-alive JSON-RPC), websocket events, local.

Reference: rpc/client/http (HTTP + websocket event subscriptions),
rpc/client/local (in-proc, wraps the core directly). The method surface
mirrors the core route table (rpc/core/routes.go:10-43); every route is
reachable via `call`, with named helpers for the common ones.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
from typing import Any, AsyncIterator, Optional


def _split_addr(addr: str) -> tuple[str, int]:
    s = addr
    for prefix in ("tcp://", "http://", "ws://"):
        s = s.removeprefix(prefix)
    s = s.split("/", 1)[0]
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


class RPCClientError(RuntimeError):
    """RuntimeError subclass: pre-consolidation callers catch
    (ConnectionError, RuntimeError, OSError) around RPC calls."""

    def __init__(self, code: int, message: str):
        super().__init__(f"rpc error {code}: {message}")
        self.code = code
        self.message = message


class _NamedRoutes:
    """Named helpers shared by every client flavor."""

    async def call(self, method: str, **params) -> Any:
        raise NotImplementedError

    async def status(self):
        return await self.call("status")

    async def health(self):
        """Liveness + monitor verdict: {node_id, latest_block_height,
        catching_up, monitored, status} (rpc/core.py health — no longer
        the reference's empty dict)."""
        return await self.call("health")

    async def dump_health(self):
        """Full health-plane dump: per-subsystem detector SLO state +
        recent incidents (obs/health.HealthMonitor.verdict())."""
        return await self.call("dump_health")

    async def net_info(self):
        return await self.call("net_info")

    async def genesis(self):
        return await self.call("genesis")

    async def block(self, height: Optional[int] = None):
        return await self.call("block", height=height)

    async def block_by_hash(self, hash_hex: str):
        return await self.call("block_by_hash", hash=hash_hex)

    async def block_results(self, height: Optional[int] = None):
        return await self.call("block_results", height=height)

    async def blockchain(self, min_height: int, max_height: int):
        return await self.call(
            "blockchain", minHeight=min_height, maxHeight=max_height
        )

    async def commit(self, height: Optional[int] = None):
        return await self.call("commit", height=height)

    async def validators(self, height: Optional[int] = None, **kw):
        return await self.call("validators", height=height, **kw)

    async def consensus_state(self):
        return await self.call("consensus_state")

    async def consensus_params(self, height: Optional[int] = None):
        return await self.call("consensus_params", height=height)

    async def abci_info(self):
        return await self.call("abci_info")

    async def abci_query(self, path: str, data: str, height: int = 0,
                         prove: bool = False):
        return await self.call(
            "abci_query", path=path, data=data, height=height, prove=prove
        )

    async def tx(self, hash_hex: str, prove: bool = False):
        return await self.call("tx", hash=hash_hex, prove=prove)

    async def tx_search(self, query: str, page: int = 1, per_page: int = 30):
        return await self.call(
            "tx_search", query=query, page=page, per_page=per_page
        )

    async def block_search(self, query: str, page: int = 1,
                           per_page: int = 30):
        return await self.call(
            "block_search", query=query, page=page, per_page=per_page
        )

    async def broadcast_evidence(self, evidence_json: str):
        return await self.call("broadcast_evidence", evidence=evidence_json)


class HTTPClient(_NamedRoutes):
    """JSON-RPC 2.0 over a persistent HTTP/1.1 connection.

    Unlike the one-shot client in rpc/light_provider.py this keeps the
    connection alive across calls (the reference http client pools too).
    """

    def __init__(self, addr: str):
        self.host, self.port = _split_addr(addr)
        self._id = 0
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def _ensure(self) -> None:
        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    async def call(self, method: str, **params) -> Any:
        params = {k: v for k, v in params.items() if v is not None}
        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method,
             "params": params}
        ).encode()
        async with self._lock:
            for attempt in (0, 1):  # one retry on a dead keep-alive conn
                await self._ensure()
                try:
                    self._writer.write(
                        b"POST / HTTP/1.1\r\nHost: rpc\r\n"
                        b"Content-Type: application/json\r\n"
                        b"Content-Length: " + str(len(payload)).encode()
                        + b"\r\n\r\n" + payload
                    )
                    await self._writer.drain()
                    status = await self._reader.readline()
                    if not status:
                        raise ConnectionError("closed")
                    if b"200" not in status:
                        # the rest of the response is unread: drop the
                        # connection or the next call reads stale bytes
                        await self.close()
                        raise RPCClientError(
                            -32000, f"http error: {status.decode().strip()}"
                        )
                    headers = {}
                    while True:
                        line = await self._reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            break
                        k, _, v = line.decode().partition(":")
                        headers[k.strip().lower()] = v.strip()
                    n = int(headers.get("content-length", 0))
                    body = await self._reader.readexactly(n) if n else b""
                    break
                except (ConnectionError, asyncio.IncompleteReadError):
                    await self.close()
                    if attempt:
                        raise
        resp = json.loads(body)
        if "error" in resp and resp["error"]:
            e = resp["error"]
            raise RPCClientError(e.get("code", -1), e.get("message", ""))
        return resp.get("result")


class LocalClient(_NamedRoutes):
    """In-proc client over the node's RPCCore (reference rpc/client/local)."""

    def __init__(self, node):
        from .core import RPCCore

        self.core = RPCCore(node)

    async def call(self, method: str, **params) -> Any:
        params = {k: v for k, v in params.items() if v is not None}
        fn = self.core.routes().get(method)
        if fn is None:
            raise RPCClientError(-32601, f"method {method!r} not found")
        res = fn(**params)
        if asyncio.iscoroutine(res):
            res = await res
        return res

    async def subscribe(self, query: str):
        return self.core.subscribe_ws(id(self), query)

    async def unsubscribe(self, query: str) -> None:
        self.core.unsubscribe_ws(id(self), query)


class WSClient:
    """Websocket event-subscription client (reference rpc/client/http ws).

    subscribe(query) -> async iterator of event payloads. Regular RPC
    calls also work over the socket (the server dispatches non-subscribe
    methods through the same handler).
    """

    def __init__(self, addr: str):
        self.host, self.port = _split_addr(addr)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._id = 0
        self._pending: dict[Any, asyncio.Future] = {}
        self._events: dict[str, asyncio.Queue] = {}
        self._pump_task: Optional[asyncio.Task] = None

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        key = "dGhlIHNhbXBsZSBub25jZQ=="
        self._writer.write(
            (
                f"GET /websocket HTTP/1.1\r\nHost: {self.host}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        await self._writer.drain()
        status = await self._reader.readline()
        if b"101" not in status:
            raise ConnectionError(f"ws upgrade refused: {status!r}")
        while True:
            line = await self._reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        self._pump_task = asyncio.get_running_loop().create_task(
            self._pump(), name="ws-client/pump"
        )

    async def close(self) -> None:
        if self._pump_task:
            self._pump_task.cancel()
        if self._writer:
            self._writer.close()

    async def _send_frame(self, data: bytes, opcode: int = 1) -> None:
        mask = os.urandom(4)
        n = len(data)
        header = bytes([0x80 | opcode])  # FIN | opcode
        if n < 126:
            header += bytes([0x80 | n])
        elif n < 1 << 16:
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        self._writer.write(header + mask + masked)
        await self._writer.drain()

    async def _send(self, obj: dict) -> None:
        await self._send_frame(json.dumps(obj).encode())

    async def _read_msg(self) -> Optional[bytes]:
        message = b""
        while True:
            try:
                h = await self._reader.readexactly(2)
            except (asyncio.IncompleteReadError, ConnectionError):
                return None
            fin, opcode = h[0] & 0x80, h[0] & 0x0F
            n = h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", await self._reader.readexactly(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", await self._reader.readexactly(8))[0]
            payload = await self._reader.readexactly(n)
            if opcode == 8:  # close
                return None
            if opcode == 9:  # ping -> masked pong with same payload
                await self._send_frame(payload, opcode=0xA)
                continue
            if opcode == 10:  # pong: control frame, not message data
                continue
            message += payload
            if fin:
                return message

    async def _pump(self) -> None:
        while True:
            raw = await self._read_msg()
            if raw is None:
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(ConnectionError("ws closed"))
                return
            try:
                msg = json.loads(raw)
            except json.JSONDecodeError:
                continue
            rid = msg.get("id")
            if isinstance(rid, str) and rid.endswith("#event"):
                q = msg.get("result", {}).get("query", "")
                queue = self._events.get(q)
                if queue is not None:
                    queue.put_nowait(msg["result"])
                continue
            fut = self._pending.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)

    async def call(self, method: str, **params) -> Any:
        self._id += 1
        rid = self._id
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await self._send(
                {"jsonrpc": "2.0", "id": rid, "method": method,
                 "params": params}
            )
            resp = await asyncio.wait_for(fut, 30)
        finally:
            self._pending.pop(rid, None)
        if resp.get("error"):
            e = resp["error"]
            raise RPCClientError(e.get("code", -1), e.get("message", ""))
        return resp.get("result")

    async def subscribe(self, query: str) -> AsyncIterator[dict]:
        """Subscribe and yield `{"query", "data", "events"}` payloads."""
        queue: asyncio.Queue = asyncio.Queue()
        self._events[query] = queue
        await self.call("subscribe", query=query)

        async def gen():
            while True:
                yield await queue.get()

        return gen()

    async def unsubscribe(self, query: str) -> None:
        self._events.pop(query, None)
        await self.call("unsubscribe", query=query)
