"""Persistence layer (SURVEY.md layer 4): embedded KV, block store,
state store. The reference sits on tm-db v0.6.6 (goleveldb); here the
embedded engine is sqlite3 (stdlib, transactional) behind the same
minimal KV port so stores stay engine-agnostic."""

from .kv import KV, MemKV, SqliteKV  # noqa: F401
from .block_store import BlockStore  # noqa: F401
