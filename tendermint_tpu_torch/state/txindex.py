"""Tx + block event indexing.

Reference: state/txindex/ (TxIndexer iface, kv sink, IndexerService
subscribing to the EventBus — node/node.go:296-347) and state/indexer/
(BlockIndexer). Serves /tx, /tx_search, /block_search RPC queries.

Index layout (kv):
  tx hash        : "th/"  + tx_hash            -> TxResult blob
  tx event       : "te/"  + key=value/height/i -> tx_hash
  block event    : "be/"  + key=value/height   -> b""
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Optional

from ..crypto import tmhash
from ..libs import protoio as pio

_TX_HASH = b"th/"
_TX_EVENT = b"te/"
_BLOCK_EVENT = b"be/"


@dataclass
class TxResult:
    """Reference abci.TxResult (indexed per DeliverTx)."""

    height: int = 0
    index: int = 0
    tx: bytes = b""
    code: int = 0
    log: str = ""
    events: list = field(default_factory=list)  # (type, {k: v})

    def encode(self) -> bytes:
        out = (
            pio.field_varint(1, self.height)
            + pio.field_varint(2, self.index)
            + pio.field_bytes(3, self.tx)
            + pio.field_varint(4, self.code)
            + pio.field_bytes(5, self.log.encode())
        )
        for etype, attrs in self.events:
            body = pio.field_bytes(1, etype.encode())
            for k, v in attrs.items():
                body += pio.field_bytes(
                    2, pio.field_bytes(1, str(k).encode()) + pio.field_bytes(2, str(v).encode())
                )
            out += pio.field_bytes(6, body)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "TxResult":
        t = cls()
        for num, _wt, val in pio.iter_fields(data):
            if num == 1:
                t.height = val
            elif num == 2:
                t.index = val
            elif num == 3:
                t.tx = val
            elif num == 4:
                t.code = val
            elif num == 5:
                t.log = val.decode()
            elif num == 6:
                etype = ""
                attrs = {}
                for n2, _w2, v2 in pio.iter_fields(val):
                    if n2 == 1:
                        etype = v2.decode()
                    elif n2 == 2:
                        kv = pio.decode_fields(v2)
                        attrs[kv[1][0].decode()] = kv[2][0].decode()
                t.events.append((etype, attrs))
        return t


def _event_key(etype: str, k: str, v: str) -> str:
    return f"{etype}.{k}={v}"


class KVIndexer:
    """kv tx/block indexer (reference state/txindex/kv/kv.go)."""

    def __init__(self, kv):
        self._kv = kv

    # --- writing ------------------------------------------------------------

    def index_tx(self, result: TxResult) -> None:
        h = tmhash.sum(result.tx)
        self._kv.set(_TX_HASH + h, result.encode())
        for etype, attrs in result.events:
            for k, v in attrs.items():
                key = (
                    _TX_EVENT
                    + _event_key(etype, k, v).encode()
                    + b"/"
                    + result.height.to_bytes(8, "big")
                    + result.index.to_bytes(4, "big")
                )
                self._kv.set(key, h)

    def index_block(self, height: int, events: list) -> None:
        for etype, attrs in events:
            for k, v in attrs.items():
                key = (
                    _BLOCK_EVENT
                    + _event_key(etype, k, v).encode()
                    + b"/"
                    + height.to_bytes(8, "big")
                )
                self._kv.set(key, b"")

    # --- queries ------------------------------------------------------------

    def get_tx(self, tx_hash: bytes) -> Optional[TxResult]:
        data = self._kv.get(_TX_HASH + tx_hash)
        return TxResult.decode(data) if data is not None else None

    def search_txs(self, event_query: str, limit: int = 100) -> list[TxResult]:
        """event_query: "type.key=value" (the reference's query language
        subset used by tx_search)."""
        prefix = _TX_EVENT + event_query.encode() + b"/"
        out = []
        for _k, h in self._kv.iterate(prefix, prefix + b"\xff" * 13):
            tx = self.get_tx(h)
            if tx is not None:
                out.append(tx)
            if len(out) >= limit:
                break
        return out

    def search_blocks(self, event_query: str, limit: int = 100) -> list[int]:
        prefix = _BLOCK_EVENT + event_query.encode() + b"/"
        out = []
        for k, _v in self._kv.iterate(prefix, prefix + b"\xff" * 9):
            out.append(int.from_bytes(k[len(prefix):], "big"))
            if len(out) >= limit:
                break
        return out


class IndexerService:
    """Subscribes to the event bus and feeds the indexer
    (reference state/txindex/indexer_service.go: one subscription for tx
    events, one for new-block events, drained by a background task)."""

    SUBSCRIBER = "IndexerService"

    def __init__(self, indexer: KVIndexer, event_bus):
        self.indexer = indexer
        self.event_bus = event_bus
        self._tasks: list[asyncio.Task] = []
        # per-height tx counter to recover the tx index within its block
        self._height_counts: dict[int, int] = {}

    async def start(self) -> None:
        from ..types.event_bus import (
            EventNewBlock,
            EventTx,
            query_for_event,
        )

        tx_sub = self.event_bus.subscribe(
            self.SUBSCRIBER + "/tx", query_for_event(EventTx)
        )
        blk_sub = self.event_bus.subscribe(
            self.SUBSCRIBER + "/block", query_for_event(EventNewBlock)
        )
        self._tasks = [
            asyncio.create_task(self._drain_tx(tx_sub)),
            asyncio.create_task(self._drain_block(blk_sub)),
        ]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []

    @staticmethod
    def _events_from_bus(events: dict) -> list:
        """Flattened "type.key" -> [v] bus attributes back to event tuples."""
        out: dict[str, dict] = {}
        for k, vals in events.items():
            if "." not in k:
                continue
            etype, attr = k.split(".", 1)
            if etype in ("tm", "tx"):  # bus bookkeeping keys
                continue
            for v in vals:
                out.setdefault(etype, {})[attr] = v
        return [(etype, attrs) for etype, attrs in out.items()]

    async def _drain_tx(self, sub) -> None:
        while True:
            msg = await sub.next()
            height, tx_hash, tx = msg.data
            idx = self._height_counts.get(height, 0)
            self._height_counts[height] = idx + 1
            self._height_counts = {
                h: c for h, c in self._height_counts.items()
                if h >= height - 2
            }
            self.indexer.index_tx(
                TxResult(
                    height=height,
                    index=idx,
                    tx=tx,
                    events=self._events_from_bus(msg.events),
                )
            )

    async def _drain_block(self, sub) -> None:
        while True:
            msg = await sub.next()
            block = msg.data
            self.indexer.index_block(
                block.header.height, self._events_from_bus(msg.events)
            )
