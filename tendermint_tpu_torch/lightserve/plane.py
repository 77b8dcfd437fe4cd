"""LightServePlane — the node's serving-plane bundle + in-proc provider.

Node assembly builds one plane per node ([lightserve] config): the
proof cache over the node's own block/state stores and the shared
ServeVerifier. The RPC routes (`light_block`, `signed_header`,
`validator_set` in rpc/core.py) serve from `plane.cache`; in-proc
harnesses (tools/lightserve_bench.py, tests) hand `plane.provider()`
to simulated LightClients so the swarm exercises the identical
assembly/caching path the RPC routes use, minus the HTTP hop.
"""

from __future__ import annotations

from typing import Optional

from ..libs.log import Logger, nop_logger
from ..libs.metrics import LightServeMetrics, default_metrics
from .cache import DEFAULT_CACHE_SIZE, LightBlockCache
from .verifier import (
    DEFAULT_REUSE_WINDOW_NS,
    ServeVerifier,
)


class LocalCacheProvider:
    """light.Provider over the serving plane's cache — what an in-proc
    simulated client syncs against (the RPC-transport equivalent is
    rpc/light_provider.RPCProvider hitting the `light_block` route)."""

    def __init__(self, cache: LightBlockCache, name: str = "lightserve"):
        self.cache = cache
        self._name = name

    async def light_block(self, height: int):
        return self.cache.get(height)

    def id(self) -> str:
        return self._name


class LightServePlane:
    def __init__(
        self,
        block_store,
        state_store,
        chain_id: str,
        cache_size: int = DEFAULT_CACHE_SIZE,
        dedup_window_ns: int = DEFAULT_REUSE_WINDOW_NS,
        verifier=None,
        metrics: Optional[LightServeMetrics] = None,
        logger: Optional[Logger] = None,
    ):
        self.chain_id = chain_id
        self.logger = logger or nop_logger()
        metrics = metrics or default_metrics(LightServeMetrics)
        self.cache = LightBlockCache(
            block_store,
            state_store,
            chain_id=chain_id,
            max_entries=cache_size,
            metrics=metrics,
        )
        self.verifier = ServeVerifier(
            verifier=verifier,
            reuse_window_ns=dedup_window_ns,
            metrics=metrics,
            logger=self.logger,
        )

    def provider(self, name: str = "lightserve") -> LocalCacheProvider:
        return LocalCacheProvider(self.cache, name=name)

    def stats(self) -> dict:
        return {"cache": self.cache.stats(), "verify": self.verifier.stats()}
