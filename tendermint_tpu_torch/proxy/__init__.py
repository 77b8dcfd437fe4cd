"""Proxy — the node's three named ABCI connections.

Reference: proxy/multi_app_conn.go:24-28 — consensus/query/snapshot
connections (the mempool connection was removed along with the mempool).
A ClientCreator abstracts local vs remote apps (proxy/client.go).
"""

from .multi_app_conn import AppConns, ClientCreator, local_client_creator  # noqa: F401
