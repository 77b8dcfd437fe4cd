"""Example key-value store app (reference abci/example/kvstore/kvstore.go:65).

Transactions are "key=value" byte strings; state is a dict whose app hash
is a deterministic digest over sorted entries. Supports validator updates
via the special "val:<pubkey_hex>!<power>" tx (reference kvstore
PersistentKVStoreApplication) and snapshots for statesync tests.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from . import types as abci


class KVStoreApplication(abci.BaseApplication):
    SNAPSHOT_CHUNK_SIZE = 1024

    def __init__(self):
        self._state: dict[str, str] = {}
        self._height = 0
        self._app_hash = b""
        self._pending_val_updates: list[abci.ValidatorUpdate] = []
        self._validators: dict[str, int] = {}  # pubkey hex -> power
        self._snapshots: dict[int, bytes] = {}
        self._restore_buf: Optional[list[bytes]] = None
        self._compute_app_hash()

    # --- helpers ----------------------------------------------------------

    def _compute_app_hash(self) -> None:
        blob = json.dumps(
            {"kv": self._state, "h": self._height}, sort_keys=True
        ).encode()
        self._app_hash = hashlib.sha256(blob).digest()

    # --- abci -------------------------------------------------------------

    def info(self) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data="kvstore",
            version="1.0",
            last_block_height=self._height,
            last_block_app_hash=self._app_hash if self._height else b"",
        )

    def init_chain(
        self, chain_id, consensus_params, validators, app_state, initial_height
    ) -> abci.ResponseInitChain:
        for v in validators:
            self._validators[v.pub_key_data.hex()] = v.power
        if app_state:
            self._state.update(
                {str(k): str(v) for k, v in app_state.items()}
            )
        self._compute_app_hash()
        return abci.ResponseInitChain(app_hash=self._app_hash)

    def check_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        if b"=" not in tx and not tx.startswith(b"val:"):
            return abci.ResponseCheckTx(code=1, log="tx must be key=value")
        return abci.ResponseCheckTx()

    def deliver_tx(self, tx: bytes) -> abci.ResponseDeliverTx:
        if tx.startswith(b"val:"):
            try:
                body = tx[4:].decode()
                pubkey_hex, power = body.split("!")
                self._pending_val_updates.append(
                    abci.ValidatorUpdate(
                        "ed25519", bytes.fromhex(pubkey_hex), int(power)
                    )
                )
                self._validators[pubkey_hex] = int(power)
                return abci.ResponseDeliverTx(
                    events=[abci.Event("val_update", {"pubkey": pubkey_hex})]
                )
            except (ValueError, IndexError) as e:
                return abci.ResponseDeliverTx(code=2, log=f"bad val tx: {e}")
        if b"=" in tx:
            k, v = tx.split(b"=", 1)
        else:
            k = v = tx
        self._state[k.decode(errors="replace")] = v.decode(errors="replace")
        return abci.ResponseDeliverTx(
            events=[
                abci.Event(
                    "app", {"creator": "kvstore", "key": k.decode(errors="replace")}
                )
            ]
        )

    def end_block(self, height: int) -> abci.ResponseEndBlock:
        updates, self._pending_val_updates = self._pending_val_updates, []
        return abci.ResponseEndBlock(validator_updates=updates)

    def commit(self) -> abci.ResponseCommit:
        self._height += 1
        self._compute_app_hash()
        self._snapshots[self._height] = json.dumps(
            {"kv": self._state, "h": self._height}, sort_keys=True
        ).encode()
        # keep only recent snapshots
        for h in sorted(self._snapshots):
            if h < self._height - 10:
                del self._snapshots[h]
        return abci.ResponseCommit(data=self._app_hash)

    def query(self, path, data, height, prove) -> abci.ResponseQuery:
        key = data.decode(errors="replace")
        val = self._state.get(key)
        if val is None:
            return abci.ResponseQuery(code=1, log="key not found", key=data)
        return abci.ResponseQuery(
            key=data, value=val.encode(), height=self._height
        )

    # --- snapshots (statesync) -------------------------------------------

    def list_snapshots(self) -> list[abci.Snapshot]:
        out = []
        for h, blob in sorted(self._snapshots.items()):
            chunks = max(
                1,
                (len(blob) + self.SNAPSHOT_CHUNK_SIZE - 1)
                // self.SNAPSHOT_CHUNK_SIZE,
            )
            out.append(
                abci.Snapshot(
                    height=h,
                    format=1,
                    chunks=chunks,
                    hash=hashlib.sha256(blob).digest(),
                )
            )
        return out

    def offer_snapshot(self, snapshot, app_hash) -> abci.ResponseOfferSnapshot:
        if snapshot.format != 1:
            return abci.ResponseOfferSnapshot(result="REJECT_FORMAT")
        self._restore_buf = [b""] * snapshot.chunks
        self._restore_target = snapshot
        return abci.ResponseOfferSnapshot(result="ACCEPT")

    def load_snapshot_chunk(self, height, format, chunk) -> bytes:
        blob = self._snapshots.get(height, b"")
        start = chunk * self.SNAPSHOT_CHUNK_SIZE
        return blob[start : start + self.SNAPSHOT_CHUNK_SIZE]

    def apply_snapshot_chunk(
        self, index, chunk, sender
    ) -> abci.ResponseApplySnapshotChunk:
        if self._restore_buf is None or index >= len(self._restore_buf):
            return abci.ResponseApplySnapshotChunk(result="ABORT")
        self._restore_buf[index] = chunk
        if all(c for c in self._restore_buf) or (
            index == len(self._restore_buf) - 1
        ):
            blob = b"".join(self._restore_buf)
            if hashlib.sha256(blob).digest() != self._restore_target.hash:
                return abci.ResponseApplySnapshotChunk(
                    result="RETRY_SNAPSHOT"
                )
            st = json.loads(blob.decode())
            self._state = st["kv"]
            self._height = st["h"]
            self._compute_app_hash()
            self._restore_buf = None
        return abci.ResponseApplySnapshotChunk(result="ACCEPT")
