"""ABCI clients: local (in-proc) and socket (asyncio pipelined).

Reference: abci/client/local_client.go (mutex-serialized direct calls) and
socket_client.go (sendRequestsRoutine :119 / recvResponseRoutine :153 —
async pipelining over a unix/tcp socket with varint-delimited frames).
"""

from __future__ import annotations

import asyncio
from io import BytesIO
from typing import Any, Optional

from ..libs import protoio as pio
from . import types as abci


class ABCIClientError(Exception):
    pass


class LocalClient:
    """In-proc client: one asyncio lock serializes calls, mirroring
    local_client.go's mutex. Sync app methods run directly (they are
    CPU-light); a slow app should use the socket client instead."""

    def __init__(self, app: abci.Application):
        self._app = app
        self._lock = asyncio.Lock()

    async def call(self, method: str, *args) -> Any:
        async with self._lock:
            return getattr(self._app, method)(*args)

    async def echo(self, msg: str) -> str:
        return await self.call("echo", msg)

    async def info(self) -> abci.ResponseInfo:
        return await self.call("info")

    async def init_chain(self, *args) -> abci.ResponseInitChain:
        return await self.call("init_chain", *args)

    async def query(self, *args) -> abci.ResponseQuery:
        return await self.call("query", *args)

    async def check_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        return await self.call("check_tx", tx)

    async def begin_block(self, *args):
        return await self.call("begin_block", *args)

    async def deliver_tx(self, tx: bytes) -> abci.ResponseDeliverTx:
        return await self.call("deliver_tx", tx)

    async def end_block(self, height: int):
        return await self.call("end_block", height)

    async def commit(self) -> abci.ResponseCommit:
        return await self.call("commit")

    async def list_snapshots(self):
        return await self.call("list_snapshots")

    async def offer_snapshot(self, *args):
        return await self.call("offer_snapshot", *args)

    async def load_snapshot_chunk(self, *args) -> bytes:
        return await self.call("load_snapshot_chunk", *args)

    async def apply_snapshot_chunk(self, *args):
        return await self.call("apply_snapshot_chunk", *args)

    async def close(self) -> None:
        pass


class SocketClient(LocalClient):
    """Pipelined socket client: requests are written in order and matched
    to responses FIFO (the reference's reqSent queue)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 26658):
        self._host, self._port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: asyncio.Queue = asyncio.Queue()
        self._recv_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()

    async def connect(self, retries: int = 20, delay: float = 0.1) -> None:
        last_err: Optional[Exception] = None
        for _ in range(retries):
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self._host, self._port
                )
                self._recv_task = asyncio.get_running_loop().create_task(
                    self._recv_routine()
                )
                return
            except OSError as e:
                last_err = e
                await asyncio.sleep(delay)
        raise ABCIClientError(f"cannot connect to ABCI server: {last_err}")

    async def _recv_routine(self) -> None:
        try:
            while True:
                frame = await _read_frame(self._reader)
                fut: asyncio.Future = await self._pending.get()
                if not fut.done():
                    try:
                        fut.set_result(abci.decode_result(frame))
                    except Exception as e:  # app returned an error
                        fut.set_exception(e)
        except (asyncio.IncompleteReadError, ConnectionError, EOFError):
            while not self._pending.empty():
                fut = self._pending.get_nowait()
                if not fut.done():
                    fut.set_exception(ABCIClientError("connection closed"))

    async def call(self, method: str, *args) -> Any:
        async with self._lock:
            if self._writer is None:
                raise ABCIClientError("not connected")
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            await self._pending.put(fut)
            payload = abci.encode_rpc(method, list(args))
            self._writer.write(pio.write_uvarint(len(payload)) + payload)
            await self._writer.drain()
        return await fut

    async def close(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
        if self._writer:
            self._writer.close()


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    shift = 0
    n = 0
    while True:
        b = (await reader.readexactly(1))[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 70:
            raise ABCIClientError("frame length varint too long")
    if n > 1 << 26:
        raise ABCIClientError("frame too large")
    return await reader.readexactly(n)


class SocketServer:
    """ABCI app server (reference abci/server/socket_server.go)."""

    def __init__(self, app: abci.Application, host: str = "127.0.0.1", port: int = 26658):
        self._app = app
        self._host, self._port = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def port(self) -> int:
        return self._port

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self._host, self._port
        )
        if self._port == 0:
            self._port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # an attached client holds its connection open, and
            # wait_closed() awaits every connection since py3.12: close
            # them, again for any accepted before close() whose handler
            # had yet to start, until the server is closed
            closed = asyncio.ensure_future(self._server.wait_closed())
            while True:
                for w in list(self._writers):
                    w.close()
                done, _ = await asyncio.wait([closed], timeout=0.05)
                if done:
                    break

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._writers.add(writer)
        try:
            while True:
                frame = await _read_frame(reader)
                method, args = abci.decode_rpc(frame)
                try:
                    result = getattr(self._app, method)(*args)
                    out = abci.encode_result(result)
                except Exception as e:
                    out = abci.encode_error(repr(e))
                writer.write(pio.write_uvarint(len(out)) + out)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, EOFError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()
