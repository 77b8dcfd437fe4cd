"""ABCI application interface + request/response types.

Reference: abci/types/application.go:13-32 — the 17-method Application
surface (echo/flush/info lifecycle, init_chain, query, the consensus
connection's begin_block/deliver_tx/end_block/commit, and the snapshot
connection's four methods). The mempool connection is gone in the morph
fork (no mempool; txs come from the L2 node), but check_tx stays on the
interface for app compatibility.
"""

from __future__ import annotations

import base64
import json
from dataclasses import asdict, dataclass, field
from typing import Optional, Protocol

CODE_TYPE_OK = 0


@dataclass
class Event:
    type: str
    attributes: dict[str, str] = field(default_factory=dict)


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_data: bytes
    power: int
    # morph QC plane: rotating a validator in with its BLS12-381 G2 key
    # (192 bytes uncompressed) makes it QC-capable from its first height
    # in the set; empty means "no key supplied" — an update to an
    # existing member keeps the key already on record
    bls_pub_key: bytes = b""


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseInitChain:
    validators: list[ValidatorUpdate] = field(default_factory=list)
    consensus_params: Optional[dict] = None
    app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    key: bytes = b""
    value: bytes = b""
    height: int = 0
    index: int = 0
    proof_ops: list = field(default_factory=list)


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0


@dataclass
class ResponseBeginBlock:
    events: list[Event] = field(default_factory=list)


@dataclass
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseEndBlock:
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[dict] = None
    events: list[Event] = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class ResponseOfferSnapshot:
    result: str = "ACCEPT"  # ACCEPT | ABORT | REJECT | REJECT_FORMAT | REJECT_SENDER


@dataclass
class ResponseApplySnapshotChunk:
    result: str = "ACCEPT"  # ACCEPT | ABORT | RETRY | RETRY_SNAPSHOT | REJECT_SNAPSHOT
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)


class Application(Protocol):
    """The 17-method app surface (reference abci/types/application.go)."""

    def echo(self, msg: str) -> str: ...

    def info(self) -> ResponseInfo: ...

    def init_chain(
        self,
        chain_id: str,
        consensus_params: dict,
        validators: list[ValidatorUpdate],
        app_state: dict,
        initial_height: int,
    ) -> ResponseInitChain: ...

    def query(self, path: str, data: bytes, height: int, prove: bool) -> ResponseQuery: ...

    def check_tx(self, tx: bytes) -> ResponseCheckTx: ...

    def begin_block(
        self, header, last_commit_info, byzantine_validators
    ) -> ResponseBeginBlock: ...

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx: ...

    def end_block(self, height: int) -> ResponseEndBlock: ...

    def commit(self) -> ResponseCommit: ...

    def list_snapshots(self) -> list[Snapshot]: ...

    def offer_snapshot(
        self, snapshot: Snapshot, app_hash: bytes
    ) -> ResponseOfferSnapshot: ...

    def load_snapshot_chunk(
        self, height: int, format: int, chunk: int
    ) -> bytes: ...

    def apply_snapshot_chunk(
        self, index: int, chunk: bytes, sender: str
    ) -> ResponseApplySnapshotChunk: ...


class BaseApplication:
    """No-op defaults (reference abci/types/application.go BaseApplication)."""

    def echo(self, msg: str) -> str:
        return msg

    def info(self) -> ResponseInfo:
        return ResponseInfo()

    def init_chain(
        self, chain_id, consensus_params, validators, app_state, initial_height
    ) -> ResponseInitChain:
        return ResponseInitChain()

    def query(self, path, data, height, prove) -> ResponseQuery:
        return ResponseQuery()

    def check_tx(self, tx) -> ResponseCheckTx:
        return ResponseCheckTx()

    def begin_block(
        self, header, last_commit_info, byzantine_validators
    ) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def deliver_tx(self, tx) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, height) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def list_snapshots(self) -> list[Snapshot]:
        return []

    def offer_snapshot(self, snapshot, app_hash) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot(result="ABORT")

    def load_snapshot_chunk(self, height, format, chunk) -> bytes:
        return b""

    def apply_snapshot_chunk(self, index, chunk, sender) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk(result="ABORT")


# --- wire helpers for the socket client/server ----------------------------


def _to_jsonable(obj):
    if isinstance(obj, bytes):
        return {"__b__": base64.b64encode(obj).decode()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if hasattr(obj, "__dataclass_fields__"):
        # per-field recursion (NOT asdict, which flattens nested
        # dataclasses into untyped dicts): a Header's BlockID must
        # arrive at the remote app as a BlockID
        return {
            "__dc__": type(obj).__name__,
            "fields": {
                k: _to_jsonable(getattr(obj, k))
                for k in obj.__dataclass_fields__
            },
        }
    return obj


def _from_jsonable(obj):
    if isinstance(obj, dict):
        if "__b__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b__"])
        if "__dc__" in obj:
            cls = _DATACLASSES[obj["__dc__"]]
            return cls(**_from_jsonable(obj["fields"]))
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    return obj


_DATACLASSES = {
    c.__name__: c
    for c in (
        Event,
        ValidatorUpdate,
        ResponseInfo,
        ResponseInitChain,
        ResponseQuery,
        ResponseCheckTx,
        ResponseBeginBlock,
        ResponseDeliverTx,
        ResponseEndBlock,
        ResponseCommit,
        Snapshot,
        ResponseOfferSnapshot,
        ResponseApplySnapshotChunk,
    )
}


def _register_request_types() -> None:
    """Request-side dataclasses that cross the remote transports
    (begin_block carries the full Header tree — found driving a real
    node against an external app, r4)."""
    from ..types.block import Header
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader

    for c in (Header, BlockID, PartSetHeader):
        _DATACLASSES[c.__name__] = c


_register_request_types()


def encode_rpc(method: str, args: list) -> bytes:
    return json.dumps({"m": method, "a": _to_jsonable(args)}).encode()


def decode_rpc(data: bytes) -> tuple[str, list]:
    d = json.loads(data.decode())
    return d["m"], _from_jsonable(d["a"])


def encode_result(value) -> bytes:
    return json.dumps({"r": _to_jsonable(value)}).encode()


def decode_result(data: bytes):
    d = json.loads(data.decode())
    if "e" in d:
        raise RuntimeError(d["e"])
    return _from_jsonable(d["r"])


def encode_error(msg: str) -> bytes:
    return json.dumps({"e": msg}).encode()
