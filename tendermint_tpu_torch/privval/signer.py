"""Remote signer protocol — keep validator keys in a separate process.

Reference: privval/signer_client.go (node side), signer_listener_endpoint
/ signer_dialer_endpoint, signer_requestHandler.go, retry wrapper
retry_signer_client.go. Topology matches the reference: the NODE listens
(SignerListenerEndpoint), the SIGNER dials in (SignerDialerEndpoint) so
the key machine needs no open ports. Frames are uvarint-delimited JSON.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from ..libs import protoio as pio
from ..types.proposal import Proposal
from ..types.vote import Vote


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    shift = n = 0
    while True:
        b = (await reader.readexactly(1))[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return await reader.readexactly(n)


def _write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(pio.write_uvarint(len(payload)) + payload)


class RemoteSignerError(Exception):
    pass


class SignerListenerEndpoint:
    """Node side: listens for the signer's inbound connection and forwards
    sign requests over it. Implements the PrivValidator surface via the
    async `client()` — consensus uses SignerClient below."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host, self._port = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn: Optional[tuple] = None
        self._conn_ready = asyncio.Event()
        self._lock = asyncio.Lock()

    @property
    def port(self) -> int:
        return self._port

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connect, self._host, self._port
        )
        if self._port == 0:
            self._port = self._server.sockets[0].getsockname()[1]

    async def _on_connect(self, reader, writer) -> None:
        # returning keeps the streams open; we hold the references
        self._conn = (reader, writer)
        self._conn_ready.set()

    async def wait_for_signer(self, timeout: float = 5.0) -> None:
        await asyncio.wait_for(self._conn_ready.wait(), timeout)

    async def request(self, msg: dict, timeout: float = 5.0) -> dict:
        async with self._lock:
            if self._conn is None:
                raise RemoteSignerError("no signer connected")
            reader, writer = self._conn
            _write_frame(writer, json.dumps(msg).encode())
            await writer.drain()
            resp = json.loads(
                (await asyncio.wait_for(_read_frame(reader), timeout)).decode()
            )
            if "error" in resp:
                raise RemoteSignerError(resp["error"])
            return resp

    async def stop(self) -> None:
        if self._conn is not None:
            self._conn[1].close()
            self._conn = None
        if self._server:
            self._server.close()
            await self._server.wait_closed()


class SignerClient:
    """Async PrivValidator over a listener endpoint (reference
    privval/signer_client.go). Consensus awaits these."""

    def __init__(self, endpoint: SignerListenerEndpoint):
        self._ep = endpoint
        self._pub_key = None

    async def get_pub_key(self):
        if self._pub_key is None:
            from ..crypto import ed25519

            resp = await self._ep.request({"m": "pub_key"})
            self._pub_key = ed25519.PubKey(bytes.fromhex(resp["pub_key"]))
        return self._pub_key

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        resp = await self._ep.request(
            {"m": "sign_vote", "chain_id": chain_id, "vote": vote.encode().hex()}
        )
        signed = Vote.decode(bytes.fromhex(resp["vote"]))
        vote.signature = signed.signature
        vote.timestamp_ns = signed.timestamp_ns
        vote.bls_signature = signed.bls_signature
        vote.qc_signature = signed.qc_signature

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        resp = await self._ep.request(
            {
                "m": "sign_proposal",
                "chain_id": chain_id,
                "proposal": proposal.encode().hex(),
            }
        )
        signed = Proposal.decode(bytes.fromhex(resp["proposal"]))
        proposal.signature = signed.signature
        proposal.timestamp_ns = signed.timestamp_ns

    async def ping(self) -> bool:
        resp = await self._ep.request({"m": "ping"})
        return resp.get("pong", False)


class SignerServer:
    """Signer side: dials the node and serves sign requests from a local
    PrivValidator (reference signer_dialer_endpoint + request handler)."""

    def __init__(self, pv, host: str, port: int):
        self._pv = pv
        self._host, self._port = host, port
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        reader, writer = await asyncio.open_connection(self._host, self._port)
        self._writer = writer
        self._task = asyncio.get_running_loop().create_task(
            self._serve(reader, writer)
        )

    async def _serve(self, reader, writer) -> None:
        try:
            while True:
                req = json.loads((await _read_frame(reader)).decode())
                try:
                    resp = self._handle(req)
                except Exception as e:
                    resp = {"error": repr(e)}
                _write_frame(writer, json.dumps(resp).encode())
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass

    def _handle(self, req: dict) -> dict:
        m = req["m"]
        if m == "ping":
            return {"pong": True}
        if m == "pub_key":
            return {"pub_key": self._pv.get_pub_key().data.hex()}
        if m == "sign_vote":
            vote = Vote.decode(bytes.fromhex(req["vote"]))
            self._pv.sign_vote(req["chain_id"], vote)
            return {"vote": vote.encode().hex()}
        if m == "sign_proposal":
            prop = Proposal.decode(bytes.fromhex(req["proposal"]))
            self._pv.sign_proposal(req["chain_id"], prop)
            return {"proposal": prop.encode().hex()}
        raise RemoteSignerError(f"unknown method {m}")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        if getattr(self, "_writer", None) is not None:
            self._writer.close()
