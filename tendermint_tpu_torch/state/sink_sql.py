"""SQL event sink — the reference's psql indexer sink over DB-API.

Reference: state/indexer/sink/psql/{psql.go,schema.sql}. Same relational
schema (blocks / tx_results / events / attributes + the three views) and
the same write paths (IndexBlockEvents, IndexTxEvents with idempotent
re-index). The Go sink hard-binds github.com/lib/pq; this one speaks
PEP 249 against stdlib sqlite3 (the tested backend — this image ships no
postgres driver). Running it against PostgreSQL additionally needs the
reference's own schema.sql (SERIAL keys; this module's DDL uses sqlite's
AUTOINCREMENT spelling) and an insert-returning strategy in place of
cursor.lastrowid — left to a deployment that has a driver to test
against, and flagged loudly here rather than shipped untested.

The sink is append-only and stores the full event stream relationally so
external indexers can query it with plain SQL (the reference's stated
purpose — psql.go:1-35); it deliberately implements NO search API
(backport.go returns errors for search, as does this class).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .txindex import TxResult


_SCHEMA_SQLITE = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  height     BIGINT NOT NULL,
  chain_id   VARCHAR NOT NULL,
  created_at BIGINT NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain
  ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id   BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_index   INTEGER NOT NULL,
  created_at BIGINT NOT NULL,
  tx_hash    VARCHAR NOT NULL,
  tx_result  BLOB NOT NULL,
  UNIQUE (block_id, tx_index)
);
CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_id    BIGINT NULL REFERENCES tx_results(rowid),
  type     VARCHAR NOT NULL
);
CREATE TABLE IF NOT EXISTS attributes (
  event_id      BIGINT NOT NULL REFERENCES events(rowid),
  key           VARCHAR NOT NULL,
  composite_key VARCHAR NOT NULL,
  value         VARCHAR NULL,
  UNIQUE (event_id, key)
);
CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes ON (events.rowid = attributes.event_id);
CREATE VIEW IF NOT EXISTS block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key,
         composite_key, value
  FROM blocks JOIN event_attributes
    ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;
CREATE VIEW IF NOT EXISTS tx_events AS
  SELECT height, tx_index, chain_id, type, key, composite_key, value,
         tx_results.created_at
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON (tx_results.rowid = event_attributes.tx_id)
  WHERE event_attributes.tx_id IS NOT NULL;
"""


class SQLEventSink:
    def __init__(
        self,
        connect: Optional[Callable] = None,
        chain_id: str = "",
        paramstyle: str = "?",
    ):
        """connect: zero-arg factory returning a PEP 249 connection
        (default: in-memory sqlite3; see module docstring for what a
        postgres deployment must adapt)."""
        if connect is None:
            import sqlite3

            db = sqlite3.connect(":memory:")
            connect = lambda: db  # noqa: E731
        self._conn = connect()
        self._p = paramstyle
        self.chain_id = chain_id
        cur = self._conn.cursor()
        cur.executescript(_SCHEMA_SQLITE) if hasattr(
            cur, "executescript"
        ) else [
            cur.execute(stmt)
            for stmt in _SCHEMA_SQLITE.split(";")
            if stmt.strip()
        ]
        self._conn.commit()

    def _q(self, sql: str) -> str:
        return sql.replace("?", self._p) if self._p != "?" else sql

    def _block_rowid(self, cur, height: int) -> int:
        cur.execute(
            self._q(
                "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?"
            ),
            (height, self.chain_id),
        )
        row = cur.fetchone()
        if row is None:
            raise KeyError(f"block {height} not indexed")
        return row[0]

    # --- write paths (psql.go IndexBlockEvents / IndexTxEvents) -----------

    def index_block(self, height: int, events: list) -> None:
        """events: [(type, [(key, value), ...]), ...]. Idempotent per
        (height, chain_id) — a replayed block does not duplicate rows
        (psql.go:103 ON CONFLICT DO NOTHING shape)."""
        cur = self._conn.cursor()
        cur.execute(
            self._q(
                "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?"
            ),
            (height, self.chain_id),
        )
        if cur.fetchone() is not None:
            return
        cur.execute(
            self._q(
                "INSERT INTO blocks (height, chain_id, created_at) "
                "VALUES (?, ?, ?)"
            ),
            (height, self.chain_id, time.time_ns()),
        )
        block_id = cur.lastrowid
        self._insert_events(cur, block_id, None, events)
        self._conn.commit()

    def index_tx(self, result: TxResult, events: list) -> None:
        cur = self._conn.cursor()
        block_id = self._block_rowid(cur, result.height)
        cur.execute(
            self._q(
                "SELECT rowid FROM tx_results "
                "WHERE block_id = ? AND tx_index = ?"
            ),
            (block_id, result.index),
        )
        if cur.fetchone() is not None:
            return
        import hashlib

        cur.execute(
            self._q(
                "INSERT INTO tx_results "
                "(block_id, tx_index, created_at, tx_hash, tx_result) "
                "VALUES (?, ?, ?, ?, ?)"
            ),
            (
                block_id,
                result.index,
                time.time_ns(),
                hashlib.sha256(result.tx).hexdigest().upper(),
                result.encode(),
            ),
        )
        tx_id = cur.lastrowid
        self._insert_events(cur, block_id, tx_id, events)
        self._conn.commit()

    def _insert_events(self, cur, block_id, tx_id, events) -> None:
        for etype, attrs in events:
            cur.execute(
                self._q(
                    "INSERT INTO events (block_id, tx_id, type) "
                    "VALUES (?, ?, ?)"
                ),
                (block_id, tx_id, etype),
            )
            event_id = cur.lastrowid
            for k, v in attrs:
                cur.execute(
                    self._q(
                        "INSERT INTO attributes "
                        "(event_id, key, composite_key, value) "
                        "VALUES (?, ?, ?, ?)"
                    ),
                    (event_id, k, f"{etype}.{k}", v),
                )

    # --- the sink exposes no search (reference backport.go) ---------------

    def search_txs(self, *_a, **_kw):
        raise NotImplementedError(
            "the SQL sink does not implement search; query it with SQL"
        )

    search_blocks = search_txs

    def close(self) -> None:
        self._conn.close()
