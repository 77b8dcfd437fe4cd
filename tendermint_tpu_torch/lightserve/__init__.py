"""Light-client serving plane.

The CLIENT half of skipping verification is `light/` (routed through
the dispatch scheduler); this package is the
SERVER half a full node needs to serve millions of light clients:

- `LightBlockCache` (cache.py): assemble each height's
  header+commit+validator-set proof ONCE from the (write-behind) block
  store and serve it to every client, LRU-bounded and pinned to the
  durable height so a crash/rollback can never leave a stale proof
  cached;
- `ServeVerifier` (verifier.py): accept thousands of concurrent
  skipping-verification requests, dedupe identical (trusted→target)
  hops, and ride the shared commit verifies through the process
  dispatch scheduler's `lightserve` lane so client bisections coalesce
  into shared device rounds instead of per-client programs;
- `LightServePlane` (plane.py): the node-assembly bundle ([lightserve]
  config) the RPC routes (`light_block`/`signed_header`/`validator_set`)
  and the in-proc swarm harness (tools/lightserve_bench.py) serve from.
"""

from .cache import LightBlockCache  # noqa: F401
from .plane import LightServePlane, LocalCacheProvider  # noqa: F401
from .verifier import ServeVerifier  # noqa: F401
