"""The light-client swarm over a chain and a scheduler handed in.

``tendermint_tpu_torch.tools.lightserve_bench`` (the port's copy of
``tools/lightserve_bench.py``) holds the swarm: its client loop
(``_swarm_sync``) and its divergent-witness and forged-header scenarios
(``_attack_scenarios``). Its ``run_swarm`` serves the chain of an in-proc
net it runs itself, on a scheduler it makes. ``chip_smoke.py``'s phase 10
(a) serves the 150-validator, 129-height chain of its phase 9 instead, on a
scheduler that records its rounds: ``run_swarm`` here builds the plane over
that chain (``served_chain``) on that scheduler's ``lightserve`` lane and
runs the tool's client loop and scenarios on it. The stats keep the tool's
keys. It imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import time
from types import SimpleNamespace

from tendermint_tpu_torch.tools import lightserve_bench as bench

# the plane's dedup window, the tool's default
DEDUP_WINDOW_NS = 60 * 1_000_000_000


def served_chain(block_store, state_store, vs, pvs, chain_id: str, now_ns=time.time_ns):
    """What the swarm needs of a chain: the serving node's stores, its
    validator set and their privvals (the fork is re-signed by them), the
    chain id and the clients' clock."""
    return SimpleNamespace(bs=block_store, ss=state_store, vs=vs, pvs=pvs,
                           chain_id=chain_id, now_ns=now_ns)


def run_swarm(n_clients: int, chain, scheduler) -> dict:
    """The tool's swarm and attack scenarios on `chain` (served_chain),
    through one LightServePlane verifying on `scheduler`'s lightserve lane
    (started here, stopped after). Returns the tool's stats dict, the
    scheduler's rounds counted from this run's start."""
    from tendermint_tpu_torch.crypto.shape_registry import (
        ShapeRegistry,
        default_shape_registry,
    )
    from tendermint_tpu_torch.libs.metrics import LightServeMetrics, Registry
    from tendermint_tpu_torch.light.client import TrustOptions
    from tendermint_tpu_torch.lightserve import LightServePlane

    async def run() -> dict:
        bs = chain.bs
        # the tip's commit is still the seen commit, so the swarm targets
        # one below it, as the tool does
        target = bs.height - 1
        await scheduler.start()
        plane = LightServePlane(
            bs, chain.ss, chain.chain_id,
            dedup_window_ns=DEDUP_WINDOW_NS,
            verifier=scheduler.classed("lightserve"),
            metrics=LightServeMetrics(Registry("lightserve_swarm")),
        )
        trust = TrustOptions(bench.TRUSTING_PERIOD_NS, 1, plane.cache.get(1).header.hash())
        rounds0 = int(scheduler.metrics.dispatches.value())
        coalesced0 = int(scheduler.metrics.dispatch_coalesced.value())
        before = default_shape_registry().snapshot()
        try:
            stats = await bench._swarm_sync(plane, target, n_clients, chain.now_ns, trust)
            stats["scenarios"] = await bench._attack_scenarios(
                plane, bs, chain.ss, chain.vs, chain.pvs, target, chain.now_ns, trust)
        finally:
            await scheduler.stop()
        delta = ShapeRegistry.delta(before, default_shape_registry().snapshot())
        stats.update({
            "net_heights": bs.height,
            "target_height": target,
            "n_validators": chain.vs.size(),
            "cache": plane.cache.stats(),
            "verify": plane.verifier.stats(),
            "registry_delta": delta,
            "scheduler_rounds": int(scheduler.metrics.dispatches.value()) - rounds0,
            "scheduler_coalesced_rounds":
                int(scheduler.metrics.dispatch_coalesced.value()) - coalesced0,
            "requests_per_device_dispatch": round(
                plane.verifier.requests / max(1, delta["device_dispatch_count"]), 1),
        })
        return stats

    return asyncio.run(run())
