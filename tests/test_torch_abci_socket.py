"""The port's ABCI socket server (``abci/client.py``'s ``SocketServer``)
stops while a client is attached: it closes its live connections before it
awaits ``wait_closed()``, which since Python 3.12 waits for every
connection. The reference's ``stop``, bound onto the same server, is
still waiting 5 s later. A connection accepted just before the stop, its
handler not yet started, ends too. Beside it, the round trip of
``tests/test_store_state.py`` on the port, and the port's client against a
JAX-package server and the other way round. Tolerance: exact (results).
"""

from __future__ import annotations

import asyncio
import socket
import types

import pytest

from tendermint_tpu_torch.abci.client import SocketClient, SocketServer
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication


def _reference_stop():
    from tendermint_tpu.abci.client import SocketServer as Ref

    return Ref.stop


@pytest.mark.parametrize("lines", ["port", "reference"])
def test_stop_with_a_client_attached_ends_inside_5s(lines):
    """A SocketServer with one SocketClient attached stops inside 5 s, and
    the client then sees the connection closed; with the reference's
    `stop` it does not end inside 5 s."""

    async def run():
        server = SocketServer(KVStoreApplication(), port=0)
        if lines == "reference":
            server.stop = types.MethodType(_reference_stop(), server)
        await server.start()
        client = SocketClient(port=server.port)
        await client.connect()
        assert await client.echo("hi") == "hi"
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        try:
            await asyncio.wait_for(server.stop(), 5)
            stopped = True
        except asyncio.TimeoutError:
            stopped = False
        wall = loop.time() - t0
        closed = False
        if stopped:
            try:
                await asyncio.wait_for(client.echo("after"), 5)
            except Exception:
                closed = True
        await client.close()
        return stopped, wall, closed

    stopped, wall, closed = asyncio.run(run())
    if lines == "port":
        assert stopped and wall < 5, wall
        assert closed, "the client's connection outlived the server"
    else:
        assert not stopped, "the reference's stop ended with a client attached"


def test_stop_ends_connections_accepted_just_before_it():
    """A connection the server accepted whose handler has not started yet
    when stop() closes the server still ends: for each number of loop
    passes between the connect and the stop (some land in that window),
    the stop returns inside 5 s."""

    async def once(passes: int) -> bool:
        server = SocketServer(KVStoreApplication(), port=0)
        await server.start()
        client = socket.create_connection(("127.0.0.1", server.port))
        try:
            for _ in range(passes):
                await asyncio.sleep(0)
            await asyncio.wait_for(server.stop(), 5)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            client.close()

    async def run():
        return [await once(k) for k in range(8)]

    assert asyncio.run(run()) == [True] * 8


@pytest.mark.parametrize("server_root", ["tendermint_tpu_torch", "tendermint_tpu"])
def test_socket_roundtrip_across_packages(server_root):
    """The round trip of the reference's socket test, a port client
    against either package's server (and a JAX-package client against the
    port's): the same answers, and the port's server stops with the client
    attached."""
    import importlib

    client_root = ("tendermint_tpu" if server_root == "tendermint_tpu_torch"
                   else "tendermint_tpu_torch")
    srv = importlib.import_module(f"{server_root}.abci.client")
    app = importlib.import_module(f"{server_root}.abci.kvstore").KVStoreApplication
    cli = importlib.import_module(f"{client_root}.abci.client")

    async def run():
        server = srv.SocketServer(app(), port=0)
        await server.start()
        client = cli.SocketClient(port=server.port)
        await client.connect()
        try:
            info = await client.info()
            r = await client.deliver_tx(b"k=v")
            c = await client.commit()
            q = await client.query("/key", b"k", 0, False)
            outs = await asyncio.gather(*(client.echo(f"m{i}") for i in range(5)))
        finally:
            if server_root == "tendermint_tpu_torch":
                await asyncio.wait_for(server.stop(), 5)
                await client.close()
            else:
                await client.close()
                await server.stop()
        return info.data, r.is_ok(), len(c.data), q.value, outs

    assert asyncio.run(run()) == ("kvstore", True, 32, b"v", [f"m{i}" for i in range(5)])
