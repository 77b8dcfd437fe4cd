"""Light-client proxy: an RPC endpoint whose answers are verified.

Reference: light/proxy/ (proxy.go + routes.go) — serves (a subset of)
the node RPC surface, but headers/commits come through the light
client's verification before being returned, so a caller can point any
RPC consumer at the proxy and inherit light-client security. Raw data
queries (tx, abci_query, …) are forwarded to the primary untouched,
exactly as the reference does.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Optional

from ..libs.service import Service


class _ProxyCore:
    """Route table facade the RPC server dispatches into (duck-typed
    like rpc.core.RPCCore; reference light/proxy/routes.go)."""

    def __init__(self, light_client, forward_call):
        self.lc = light_client
        self._forward = forward_call

    def routes(self) -> dict:
        fwd = self._forward
        return {
            "health": lambda: {},
            "status": self.status,
            "commit": self.commit,
            "block": self.block,
            "blockchain": lambda **kw: fwd("blockchain", **kw),
            "validators": self.validators,
            "genesis": lambda **kw: fwd("genesis", **kw),
            "abci_info": lambda **kw: fwd("abci_info", **kw),
            "abci_query": lambda **kw: fwd("abci_query", **kw),
            "tx": lambda **kw: fwd("tx", **kw),
            "tx_search": lambda **kw: fwd("tx_search", **kw),
            "block_search": lambda **kw: fwd("block_search", **kw),
            "net_info": lambda **kw: fwd("net_info", **kw),
            "help": lambda: {"routes": sorted(self.routes())},
        }

    async def status(self) -> dict:
        h = self.lc.last_trusted_height()
        lb = self.lc.trusted_light_block(h) if h > 0 else None
        return {
            "node_info": {"network": self.lc.chain_id, "moniker": "light"},
            "sync_info": {
                "latest_block_height": h,
                "latest_block_hash": (
                    lb.header.hash().hex().upper() if lb else ""
                ),
            },
        }

    async def commit(self, height=None, **_kw) -> dict:
        height = int(height) if height else 0
        if not height:
            raw = await self._forward("status")
            height = int(raw["sync_info"]["latest_block_height"])
        lb = await self.lc.verify_light_block_at_height(height)
        h = lb.header
        return {
            "canonical": True,
            "signed_header": {
                "header": {
                    "chain_id": h.chain_id,
                    "height": h.height,
                    "time": h.time_ns,
                    "app_hash": h.app_hash.hex().upper(),
                    "validators_hash": h.validators_hash.hex().upper(),
                    "next_validators_hash":
                        h.next_validators_hash.hex().upper(),
                },
                "commit": {
                    "height": lb.commit.height,
                    "round": lb.commit.round,
                    "block_id": {
                        "hash": lb.commit.block_id.hash.hex().upper()
                    },
                },
            },
        }

    async def block(self, height=None, **_kw) -> dict:
        """Forward the block, verifying the RETURNED header against the
        light client: the header is re-parsed and re-hashed locally —
        trusting any hash field the primary itself supplied would let a
        malicious primary forge the body and echo the real hash."""
        if not height:
            raw_st = await self._forward("status")
            height = int(raw_st["sync_info"]["latest_block_height"])
        raw = await self._forward("block", height=height)
        hb = raw.get("block", {}).get("header")
        if not hb or int(hb.get("height", 0) or 0) != int(height):
            raise RuntimeError(
                f"primary returned no/mismatched header for height {height}"
            )
        from ..rpc.light_provider import header_from_json

        got = header_from_json(hb).hash().hex().upper()
        lb = await self.lc.verify_light_block_at_height(int(height))
        want = lb.header.hash().hex().upper()
        if got != want:
            raise RuntimeError(
                f"primary block header hashes to {got} != verified {want} "
                f"at height {height}"
            )
        return raw

    async def validators(self, height=None, **_kw) -> dict:
        height = int(height) if height else 0
        if not height:
            raw = await self._forward("status")
            height = int(raw["sync_info"]["latest_block_height"])
        lb = await self.lc.verify_light_block_at_height(height)
        return {
            "block_height": height,
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": v.pub_key.data.hex(),
                    "pub_key_type": v.pub_key.type_name,
                    "voting_power": v.voting_power,
                }
                for v in lb.validators.validators
            ],
            "count": len(lb.validators.validators),
            "total": len(lb.validators.validators),
        }

    # the RPC server calls these for websocket subscribe; the proxy has
    # no event bus, so subscriptions are refused (reference proxy has
    # the same surface gap for non-forwarded subscriptions)
    def subscribe_ws(self, client_id, query_str: str):
        raise RuntimeError("light proxy does not serve subscriptions")

    def unsubscribe_ws(self, client_id, query_str: str) -> None:
        pass

    def encode_event(self, msg) -> dict:
        return {}


class LightProxy(Service):
    """`tendermint light <chainID> -p <primary> -w <witnesses>`'s server
    (reference light/proxy/proxy.go): a light client + verified RPC."""

    def __init__(
        self,
        light_client,
        primary_addr: str,
        listen_host: str = "127.0.0.1",
        listen_port: int = 8888,
    ):
        super().__init__("light-proxy")
        from ..rpc.light_provider import RPCClient
        from ..rpc.server import RPCServer

        self.lc = light_client
        self._primary = RPCClient(primary_addr)

        async def forward(method: str, **params) -> Any:
            params = {k: v for k, v in params.items() if v is not None}
            return await self._primary.call(method, **params)

        # reuse the node RPC server's http/ws plumbing with the proxy's
        # route table
        self._server = RPCServer(
            None,
            host=listen_host,
            port=listen_port,
            core=_ProxyCore(light_client, forward),
        )

    @property
    def listen_port(self) -> int:
        return self._server.port

    async def on_start(self) -> None:
        await self.lc.initialize()
        await self._server.start()

    async def on_stop(self) -> None:
        await self._server.stop()
        await self._primary.close()
        # the light client's providers hold keep-alive RPC connections
        for prov in [self.lc.primary, *self.lc.witnesses]:
            client = getattr(prov, "client", None)
            if client is not None and hasattr(client, "close"):
                await client.close()
