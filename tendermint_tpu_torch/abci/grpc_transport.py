"""ABCI over gRPC — the reference's second remote transport.

Reference: abci/client/grpc_client.go + abci/server/grpc_server.go expose
the ABCIApplication service over gRPC next to the socket transport. This
framework keeps its hand-encoded wire (abci/types.py encode_rpc /
encode_result — the same payloads the socket transport frames) and
carries it over grpc.aio with a generic handler: one unary-unary method
per ABCI call under /tendermint_tpu.abci.ABCIApplication/<Method>, bytes
in/out, no protobuf codegen (the framework has none anywhere — see
libs/protoio.py).

Unlike the reference's grpc client (which is fire-and-forget per call and
documents itself as slower than the socket client), calls here are plain
awaited unary RPCs; concurrency discipline comes from the callers (the
proxy layer serializes per connection, as with the socket client).

Gated import: grpcio ships in this image, but everything degrades to a
clear error (not an import crash) if it is absent.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from . import types as abci
from .client import ABCIClientError, LocalClient

try:  # pragma: no cover - exercised by the import itself
    import grpc

    _GRPC_ERR = None
except Exception as e:  # pragma: no cover
    grpc = None
    _GRPC_ERR = e

SERVICE = "tendermint_tpu.abci.ABCIApplication"

# the reference service's method set (abci/types/types.proto service
# ABCIApplication) — used to register generic handlers
METHODS = (
    "echo",
    "info",
    "init_chain",
    "query",
    "check_tx",
    "begin_block",
    "deliver_tx",
    "end_block",
    "commit",
    "list_snapshots",
    "offer_snapshot",
    "load_snapshot_chunk",
    "apply_snapshot_chunk",
)


def _require_grpc() -> None:
    if grpc is None:
        raise ABCIClientError(
            f"grpc transport requires grpcio (import failed: {_GRPC_ERR});"
            " use the socket transport"
        )


def _method_path(method: str) -> str:
    # CamelCase the snake_case method for the wire path, matching the
    # reference's service method names (CheckTx, BeginBlock, ...)
    return "/{}/{}".format(
        SERVICE, "".join(p.capitalize() for p in method.split("_"))
    )


class GRPCServer:
    """ABCI app server over gRPC (reference abci/server/grpc_server.go)."""

    def __init__(self, app: abci.Application,
                 host: str = "127.0.0.1", port: int = 26658):
        _require_grpc()
        self._app = app
        self._host = host
        self.port = port
        self._server: Optional["grpc.aio.Server"] = None
        self._lock = asyncio.Lock()

    def _handler(self, method: str):
        async def unary(request: bytes, context) -> bytes:
            try:
                m, args = abci.decode_rpc(request)
                if m != method:
                    raise ABCIClientError(
                        f"method mismatch: path {method}, payload {m}"
                    )
                fn = getattr(self._app, m)
                # one app, many connections: serialize like LocalClient
                async with self._lock:
                    res = fn(*args)
                    if asyncio.iscoroutine(res):
                        res = await res
                return abci.encode_result(res)
            except Exception as e:
                return abci.encode_error(repr(e))

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=None,  # raw bytes
            response_serializer=None,
        )

    async def start(self) -> None:
        self._server = grpc.aio.server()
        handlers = {
            _method_path(m).rsplit("/", 1)[1]: self._handler(m)
            for m in METHODS
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),)
        )
        self.port = self._server.add_insecure_port(
            f"{self._host}:{self.port}"
        )
        await self._server.start()

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.5)


class GRPCClient(LocalClient):
    """ABCI client over gRPC (reference abci/client/grpc_client.go).

    Drop-in for SocketClient: same call surface, same payload encoding.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 26658):
        _require_grpc()
        self._target = f"{host}:{port}"
        self._channel: Optional["grpc.aio.Channel"] = None
        self._stubs: dict = {}

    async def connect(self, retries: int = 20, delay: float = 0.1) -> None:
        self._channel = grpc.aio.insecure_channel(self._target)
        # probe with Echo until the server is up (the socket client
        # retries its TCP connect the same way)
        for i in range(retries):
            try:
                await self.echo("ping")
                return
            except Exception:
                if i == retries - 1:
                    # don't leak the aio channel (its polling task +
                    # socket) on a failed start
                    await self.close()
                    raise
                await asyncio.sleep(delay)

    async def call(self, method: str, *args):
        if self._channel is None:
            raise ABCIClientError("grpc client not connected")
        stub = self._stubs.get(method)
        if stub is None:
            stub = self._channel.unary_unary(
                _method_path(method),
                request_serializer=None,
                response_deserializer=None,
            )
            self._stubs[method] = stub
        try:
            reply = await stub(abci.encode_rpc(method, list(args)))
        except grpc.aio.AioRpcError as e:
            raise ABCIClientError(f"grpc call failed: {e.code()}") from None
        return abci.decode_result(reply)

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None


def grpc_client_creator(host: str, port: int):
    """ClientCreator for the grpc transport (proxy/multi_app_conn.py)."""
    from ..proxy.multi_app_conn import ClientCreator

    return ClientCreator(lambda: GRPCClient(host, port))
