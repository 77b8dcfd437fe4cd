"""JSON-RPC 2.0 server: HTTP POST, GET-with-query, and websocket.

Reference: rpc/jsonrpc/server/ (http_json_handler, ws_handler :29) with
the core route table of rpc/core/routes.go:10-43 — minus the mempool
broadcast routes, which this fork deletes (no mempool; txs come from the
L2 node). Implemented on raw asyncio (no external HTTP dependency): a
minimal HTTP/1.1 parser, JSON-RPC dispatch, and RFC 6455 websocket
upgrade for event subscriptions.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import time
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from ..libs.metrics import RPCMetrics, default_metrics
from ..libs.service import Service
from .core import RPCCore

_WS_MAGIC = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class RPCServer(Service):
    def __init__(self, node, host: str = "127.0.0.1", port: int = 26657,
                 core=None):
        super().__init__("rpc", getattr(node, "logger", None))
        self.core = core if core is not None else RPCCore(node)
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._ws_tasks: set[asyncio.Task] = set()
        self._conns: set[asyncio.StreamWriter] = set()

    async def on_start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self.logger.info("rpc listening", addr=f"{self.host}:{self.port}")

    async def on_stop(self) -> None:
        if self._server:
            self._server.close()
        # keep-alive clients hold connections open indefinitely; close
        # them or wait_closed() (which awaits handler completion since
        # py3.12) never returns — again for any accepted before close()
        # whose handler had yet to start, until the server is closed
        for t in list(self._ws_tasks):
            t.cancel()
        if self._server:
            closed = asyncio.ensure_future(self._server.wait_closed())
            while True:
                for w in list(self._conns):
                    w.close()
                done, _ = await asyncio.wait([closed], timeout=0.05)
                if done:
                    break

    # --- http plumbing ------------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        self._conns.add(writer)
        try:
            while True:
                req_line = await reader.readline()
                if not req_line:
                    return
                try:
                    method, target, _version = (
                        req_line.decode().strip().split(" ", 2)
                    )
                except ValueError:
                    return
                headers = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                if headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_ws(reader, writer, headers)
                    return
                body = b""
                try:
                    n = int(headers.get("content-length", 0))
                except ValueError:
                    break  # malformed header: drop the connection
                if n < 0 or n > (1 << 24):
                    break
                if n:
                    body = await reader.readexactly(n)
                resp = await self._dispatch_http(method, target, body)
                payload = json.dumps(resp).encode()
                writer.write(
                    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                    b"Content-Length: " + str(len(payload)).encode()
                    + b"\r\nConnection: keep-alive\r\n\r\n" + payload
                )
                await writer.drain()
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _dispatch_http(self, method: str, target: str, body: bytes):
        if method == "POST" and body:
            try:
                req = json.loads(body)
            except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
                # invalid UTF-8 raises UnicodeDecodeError, not
                # JSONDecodeError (fuzz finding) — both are parse errors
                return _err(None, -32700, "parse error")
            if isinstance(req, list):
                return [await self._call_one(r) for r in req]
            return await self._call_one(req)
        # GET style: /method?param=value (reference uri handlers)
        try:
            u = urlparse(target)
            name = u.path.lstrip("/")
            params = {
                k: v[0] for k, v in parse_qs(u.query).items()
            }
        except (ValueError, UnicodeDecodeError):
            # urlparse raises on hostile targets ("Invalid IPv6 URL")
            return _err(None, -32700, "parse error")
        return await self._call_one(
            {"jsonrpc": "2.0", "id": -1, "method": name or "help",
             "params": params}
        )

    async def _call_one(self, req) -> dict:
        # hostile-input guards (fuzz target): a JSON body is not
        # necessarily an object, and method/params not necessarily the
        # right shapes — answer with JSON-RPC errors, never raise
        if not isinstance(req, dict):
            return _err(None, -32600, "invalid request: not an object")
        rid = req.get("id", -1)
        name = req.get("method", "")
        if not isinstance(name, str):
            return _err(rid, -32600, "invalid request: bad method")
        params = req.get("params") or {}
        if isinstance(params, list):
            params = {str(i): p for i, p in enumerate(params)}
        if not isinstance(params, dict):
            return _err(rid, -32602, "invalid params: not an object")
        fn = self.core.routes().get(name)
        metrics = default_metrics(RPCMetrics)
        if fn is None:
            # unknown methods share one label so a hostile client can't
            # explode the metric's cardinality
            metrics.request_errors.inc(method="_unknown")
            return _err(rid, -32601, f"method {name!r} not found")
        metrics.requests.inc(method=name)
        t0 = time.perf_counter()
        try:
            res = fn(**params)
            if asyncio.iscoroutine(res):
                res = await res
            return {"jsonrpc": "2.0", "id": rid, "result": res}
        except RPCError as e:
            metrics.request_errors.inc(method=name)
            return _err(rid, e.code, e.message)
        except TypeError as e:
            metrics.request_errors.inc(method=name)
            return _err(rid, -32602, f"invalid params: {e}")
        except Exception as e:
            metrics.request_errors.inc(method=name)
            return _err(rid, -32603, f"internal error: {e}")
        finally:
            metrics.request_duration.observe(
                time.perf_counter() - t0, method=name
            )

    # --- websocket (reference ws_handler :29) --------------------------------

    async def _handle_ws(self, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key", "")
        accept = base64.b64encode(
            hashlib.sha1(key.encode() + _WS_MAGIC).digest()
        ).decode()
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
            b"Connection: Upgrade\r\nSec-WebSocket-Accept: "
            + accept.encode() + b"\r\n\r\n"
        )
        await writer.drain()
        subs: dict[str, Any] = {}
        send_lock = asyncio.Lock()

        async def send_json(obj) -> None:
            data = json.dumps(obj).encode()
            async with send_lock:
                writer.write(_ws_frame(data))
                await writer.drain()

        async def pump(query_str, sub):
            while True:
                msg = await sub.next()
                await send_json(
                    {
                        "jsonrpc": "2.0",
                        "id": f"{query_str}#event",
                        "result": {
                            "query": query_str,
                            "data": self.core.encode_event(msg),
                            "events": msg.events,
                        },
                    }
                )

        try:
            while True:
                data = await _ws_read(reader)
                if data is None:
                    break
                try:
                    req = json.loads(data)
                except (json.JSONDecodeError, UnicodeDecodeError,
                        ValueError):
                    continue
                if not isinstance(req, dict):
                    continue
                name = req.get("method", "")
                params = req.get("params") or {}
                rid = req.get("id", -1)
                # hostile-shape guards, mirroring _call_one: params must
                # be an object and the query a string, or the branches
                # below raise out of the connection task
                if not isinstance(params, dict):
                    await send_json(
                        _err(rid, -32602, "invalid params: not an object")
                    )
                    continue
                if name == "subscribe":
                    q = params.get("query", "")
                    if not isinstance(q, str):
                        await send_json(
                            _err(rid, -32602, "invalid query")
                        )
                        continue
                    try:
                        sub = self.core.subscribe_ws(id(writer), q)
                    except Exception as e:
                        await send_json(_err(rid, -32603, str(e)))
                        continue
                    t = asyncio.create_task(pump(q, sub))
                    self._ws_tasks.add(t)
                    subs[q] = (sub, t)
                    await send_json(
                        {"jsonrpc": "2.0", "id": rid, "result": {}}
                    )
                elif name == "unsubscribe":
                    q = params.get("query", "")
                    if not isinstance(q, str):
                        await send_json(
                            _err(rid, -32602, "invalid query")
                        )
                        continue
                    ent = subs.pop(q, None)
                    if ent:
                        ent[1].cancel()
                        self.core.unsubscribe_ws(id(writer), q)
                    await send_json(
                        {"jsonrpc": "2.0", "id": rid, "result": {}}
                    )
                else:
                    await send_json(await self._call_one(req))
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            for q, (sub, t) in subs.items():
                t.cancel()
                self.core.unsubscribe_ws(id(writer), q)
            writer.close()


def _err(rid, code, message) -> dict:
    return {
        "jsonrpc": "2.0",
        "id": rid,
        "error": {"code": code, "message": message},
    }


def _ws_frame(payload: bytes, opcode: int = 1) -> bytes:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 1 << 16:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


async def _ws_read(reader) -> Optional[bytes]:
    """One complete (possibly fragmented) text/binary message; None on
    close."""
    message = b""
    while True:
        try:
            h = await reader.readexactly(2)
        except asyncio.IncompleteReadError:
            return None
        fin = h[0] & 0x80
        opcode = h[0] & 0x0F
        masked = h[1] & 0x80
        n = h[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", await reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", await reader.readexactly(8))[0]
        mask = await reader.readexactly(4) if masked else b"\x00" * 4
        payload = await reader.readexactly(n)
        if masked:
            payload = bytes(
                b ^ mask[i % 4] for i, b in enumerate(payload)
            )
        if opcode == 8:  # close
            return None
        if opcode == 9:  # ping -> implicit pong not required for tests
            continue
        message += payload
        if fin:
            return message
