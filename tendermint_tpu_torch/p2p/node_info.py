"""NodeInfo — what peers exchange at handshake (reference p2p/node_info.go)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

P2P_PROTOCOL_VERSION = 8  # reference version/version.go
BLOCK_PROTOCOL_VERSION = 11
MAX_NUM_CHANNELS = 16


@dataclass
class NodeInfo:
    node_id: str
    listen_addr: str
    network: str  # chain id
    version: str = "0.1.0"
    channels: bytes = b""
    moniker: str = "node"
    tx_index: str = "on"
    rpc_address: str = ""
    protocol_p2p: int = P2P_PROTOCOL_VERSION
    protocol_block: int = BLOCK_PROTOCOL_VERSION

    def validate_basic(self) -> None:
        if len(self.node_id) != 40:
            raise ValueError("invalid node id")
        if len(self.channels) > MAX_NUM_CHANNELS:
            raise ValueError("too many channels")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("duplicate channels")

    def compatible_with(self, other: "NodeInfo") -> None:
        """CompatibleWith (reference): same block protocol, same network,
        at least one common channel."""
        if self.protocol_block != other.protocol_block:
            raise ValueError("incompatible block protocol")
        if self.network != other.network:
            raise ValueError(
                f"different networks: {self.network} vs {other.network}"
            )
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise ValueError("no common channels")

    def encode(self) -> bytes:
        return json.dumps(
            {
                "node_id": self.node_id,
                "listen_addr": self.listen_addr,
                "network": self.network,
                "version": self.version,
                "channels": self.channels.hex(),
                "moniker": self.moniker,
                "tx_index": self.tx_index,
                "rpc_address": self.rpc_address,
                "protocol_p2p": self.protocol_p2p,
                "protocol_block": self.protocol_block,
            }
        ).encode()

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        d = json.loads(data.decode())
        return cls(
            node_id=d["node_id"],
            listen_addr=d["listen_addr"],
            network=d["network"],
            version=d.get("version", ""),
            channels=bytes.fromhex(d.get("channels", "")),
            moniker=d.get("moniker", ""),
            tx_index=d.get("tx_index", "on"),
            rpc_address=d.get("rpc_address", ""),
            protocol_p2p=d.get("protocol_p2p", P2P_PROTOCOL_VERSION),
            protocol_block=d.get("protocol_block", BLOCK_PROTOCOL_VERSION),
        )
