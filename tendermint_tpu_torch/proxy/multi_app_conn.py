"""AppConns — consensus/query/snapshot ABCI connections.

Reference: proxy/multi_app_conn.go:24-28 + proxy/client.go ClientCreator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..abci import types as abci
from ..abci.client import LocalClient, SocketClient


class ClientCreator:
    """Creates one ABCI client per named connection."""

    def __init__(self, factory: Callable[[], object]):
        self._factory = factory

    async def new_client(self):
        client = self._factory()
        if hasattr(client, "connect"):  # socket and grpc remote clients
            await client.connect()
        return client


def local_client_creator(app: abci.Application) -> ClientCreator:
    """All three connections share the app; LocalClient's lock serializes
    (the reference's local client shares one mutex across connections)."""
    shared = LocalClient(app)
    return ClientCreator(lambda: shared)


def remote_client_creator(host: str, port: int) -> ClientCreator:
    return ClientCreator(lambda: SocketClient(host, port))


class AppConns:
    def __init__(self, creator: ClientCreator):
        self._creator = creator
        self.consensus = None
        self.query = None
        self.snapshot = None

    async def start(self) -> None:
        self.consensus = await self._creator.new_client()
        self.query = await self._creator.new_client()
        self.snapshot = await self._creator.new_client()

    async def stop(self) -> None:
        for c in (self.consensus, self.query, self.snapshot):
            if c is not None:
                await c.close()
