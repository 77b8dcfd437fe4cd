"""NodeKey — the node's p2p identity (reference p2p/key.go).

ID = hex of the ed25519 pubkey address (20 bytes -> 40 hex chars).
"""

from __future__ import annotations

import json
import os

from ..crypto import ed25519


class NodeKey:
    def __init__(self, priv_key: ed25519.PrivKey):
        self.priv_key = priv_key

    @property
    def pub_key(self) -> ed25519.PubKey:
        return self.priv_key.public_key()

    @property
    def id(self) -> str:
        return self.pub_key.address().hex()

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(ed25519.PrivKey.generate())

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            return cls(ed25519.PrivKey(bytes.fromhex(d["priv_key"])))
        nk = cls.generate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"id": nk.id, "priv_key": nk.priv_key.seed.hex()}, f)
        return nk


def id_from_pubkey(pub: ed25519.PubKey) -> str:
    return pub.address().hex()
