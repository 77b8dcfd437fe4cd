#!/usr/bin/env python
"""Light-client swarm bench — N-thousand clients through the serving plane.

Drives a real in-proc 4-validator consensus net for a few heights, then
points N simulated `LightClient`s (the real light/client.py, in-proc
provider — no sockets) at one node's `tendermint_tpu_torch/lightserve` plane:

- every client syncs the same target height from the same trust root,
  so the proof cache serves each height's LightBlock from ONE assembly
  (cache hit-rate ~= 1 - heights/fetches) and the ServeVerifier
  collapses the swarm's identical bisection hops into a handful of
  executed verifications riding the scheduler's `lightserve` lane;
- a **divergent-witness** scenario syncs one client against a forked
  primary (the fork is RE-SIGNED by the net's real validator keys — a
  true 2/3-equivocation attack) with the honest plane as witness: the
  client must raise LightClientAttackEvidence and the honest node's
  evidence pool must accept it;
- a **forged-header** scenario gives a client a witness serving a
  tampered (unverifiable) block: the witness is removed, the sync
  completes.

The result records clients/s, cache hit-rate, verify dedup rate, and
the shape-registry delta (distinct_program_shapes /
device_dispatch_count) across the swarm sync — the sublinearity proof
the BENCH artifact carries (`bench.py --family lightserve`).

  python -m tendermint_tpu_torch.tools.lightserve_bench --clients 1000 --heights 8
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import dataclasses
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

TRUSTING_PERIOD_NS = 3600 * 1_000_000_000


async def drive_net(heights: int, n_vals: int):
    """Run the in-proc consensus net to `heights`; returns node 0's
    (block_store, state_store) plus the committee (vs, pvs)."""
    from tendermint_tpu_torch.tools._inproc import make_genesis, make_validators
    from tendermint_tpu_torch.tools._inproc import make_node, wire_net

    vs, pvs = make_validators(n_vals)
    genesis = make_genesis(vs)
    nodes = [make_node(vs, pv, genesis) for pv in pvs]
    css = [n[0] for n in nodes]
    wire_net(css)
    for cs in css:
        await cs.start()
    await asyncio.gather(
        *(cs.wait_for_height(heights, timeout=180) for cs in css)
    )
    for cs in css:
        await cs.stop()
    _cs0, _app, _l2, bs, ss = nodes[0]
    return bs, ss, vs, pvs


def forked_light_chain(cache, vs, pvs, fork_at: int, tip: int) -> dict:
    """height->LightBlock for a chain that shares the honest prefix
    below `fork_at` and is RE-SIGNED by the real committee from there —
    the verifiable 2/3-equivocation fork the attack scenario needs."""
    CHAIN_ID = cache.chain_id
    from tendermint_tpu_torch.light.types import LightBlock
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.vote import Vote, VoteType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    ordered = [by_addr[v.address] for v in vs.validators]
    out: dict[int, LightBlock] = {}
    last_forked_id = None
    for h in range(1, tip + 1):
        honest = cache.get(h)
        if honest is None:
            raise RuntimeError(f"honest chain has no height {h}")
        if h < fork_at:
            out[h] = honest
            continue
        header = dataclasses.replace(
            honest.header,
            app_hash=b"forked-app-%d" % h,
            last_block_id=(
                last_forked_id
                if last_forked_id is not None
                else honest.header.last_block_id
            ),
            _hash=None,
        )
        bid = BlockID(
            header.hash(), PartSetHeader(1, header.hash())
        )
        votes = VoteSet(CHAIN_ID, h, 0, VoteType.PRECOMMIT, vs)
        for i, pv in enumerate(ordered):
            v = Vote(
                type=VoteType.PRECOMMIT,
                height=h,
                round=0,
                block_id=bid,
                timestamp_ns=header.time_ns,
                validator_address=pv.get_pub_key().address(),
                validator_index=i,
            )
            pv.sign_vote(CHAIN_ID, v)
            votes.add_vote(v, verified=True)
        out[h] = LightBlock(header, votes.make_commit(), vs)
        last_forked_id = bid
    return out


async def _swarm_sync(
    plane, target: int, n_clients: int, now_fn, trust
) -> dict:
    CHAIN_ID = plane.chain_id
    from tendermint_tpu_torch.light.client import LightClient
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.store.kv import MemKV

    async def one_client(i: int) -> bool:
        c = LightClient(
            CHAIN_ID,
            trust,
            plane.provider(),
            [plane.provider("witness-0")],
            LightStore(MemKV()),
            now_ns=now_fn,
            serve_verifier=plane.verifier,
        )
        lb = await c.verify_light_block_at_height(target)
        return lb.height == target

    t0 = time.perf_counter()
    results = await asyncio.gather(
        *(one_client(i) for i in range(n_clients))
    )
    wall = time.perf_counter() - t0
    return {
        "n_clients": n_clients,
        "synced": sum(bool(r) for r in results),
        "wall_s": round(wall, 3),
        "clients_per_s": round(n_clients / wall, 1) if wall else 0.0,
    }


async def _attack_scenarios(plane, bs, ss, vs, pvs, target, now_fn, trust):
    """Divergent-witness (verifiable fork -> evidence in the pool) and
    forged-header (tampered witness removed) scenarios. The accepted
    evidence's bytes ride along (hex) for callers that gossip it."""
    CHAIN_ID = plane.chain_id
    from tendermint_tpu_torch.tools._inproc import MockProvider
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.light.client import (
        ErrLightClientAttack,
        LightClient,
    )
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence

    out: dict = {}
    # --- divergent witness: forked primary vs the honest plane ---------
    forked = forked_light_chain(
        plane.cache, vs, pvs, fork_at=max(2, target - 2), tip=target
    )
    c = LightClient(
        CHAIN_ID,
        trust,
        MockProvider(list(forked.values()), name="byzantine-primary"),
        [plane.provider("honest-witness")],
        LightStore(MemKV()),
        now_ns=now_fn,
    )
    detected = False
    pool_size = 0
    evidence_hex = None
    try:
        await c.verify_light_block_at_height(target)
    except ErrLightClientAttack as e:
        detected = True
        pool = EvidencePool(MemKV(), ss, bs)
        pool.add_evidence(e.evidence)
        pool_size = len(pool.pending_evidence())
        out["evidence_is_light_attack"] = isinstance(
            e.evidence, LightClientAttackEvidence
        )
        evidence_hex = e.evidence.encode().hex()
    out["divergent_witness"] = {
        "attack_detected": detected,
        "evidence_pool_size": pool_size,
        "evidence_hex": evidence_hex,
    }

    # --- forged header: tampered witness removed, sync completes -------
    tampered = copy.deepcopy(plane.cache.get(target))
    tampered.header.app_hash = b"tampered"
    tampered.header._hash = None
    bad_blocks = [
        (tampered if h == target else plane.cache.get(h))
        for h in range(1, target + 1)
    ]
    c2 = LightClient(
        CHAIN_ID,
        trust,
        plane.provider(),
        [
            MockProvider(bad_blocks, name="forged-witness"),
            plane.provider("honest-witness"),
        ],
        LightStore(MemKV()),
        now_ns=now_fn,
    )
    lb = await c2.verify_light_block_at_height(target)
    out["forged_header"] = {
        "synced": lb.height == target,
        "forged_witness_removed": (
            [w.id() for w in c2.witnesses] == ["honest-witness"]
        ),
    }
    return out


def run_swarm(
    n_clients: int = 1000,
    heights: int = 8,
    n_vals: int = 4,
    dedup_window_s: float = 60.0,
    with_attack: bool = True,
    device: str = "cuda",
) -> dict:
    """The whole harness: net -> plane -> swarm -> attack scenarios.
    Returns one JSON-able stats dict (see module docstring). The nodes
    and the plane verify on the process verifier, built on `device`."""
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.crypto.shape_registry import (
        ShapeRegistry,
        default_shape_registry,
    )
    from tendermint_tpu_torch.libs.metrics import (
        LightServeMetrics,
        Registry,
        SchedulerMetrics,
    )
    from tendermint_tpu_torch.light.client import TrustOptions
    from tendermint_tpu_torch.lightserve import LightServePlane
    from tendermint_tpu_torch.parallel.scheduler import VerifyScheduler
    from tendermint_tpu_torch.tools._inproc import CHAIN_ID

    default_verifier(device)

    async def run() -> dict:
        bs, ss, vs, pvs = await drive_net(heights, n_vals)
        # the tip's commit is still the seen commit (no canonical one
        # until height+1 exists), so the swarm targets one below it —
        # every served height is then durable and cacheable
        target = bs.height - 1
        reg = Registry("lightserve_bench")
        scheduler = VerifyScheduler(metrics=SchedulerMetrics(reg))
        await scheduler.start()
        plane = LightServePlane(
            bs,
            ss,
            CHAIN_ID,
            dedup_window_ns=int(dedup_window_s * 1e9),
            verifier=scheduler.classed("lightserve"),
            metrics=LightServeMetrics(reg),
        )
        root = plane.cache.get(1)
        trust = TrustOptions(
            TRUSTING_PERIOD_NS, 1, root.header.hash()
        )
        now_fn = time.time_ns
        before = default_shape_registry().snapshot()
        try:
            stats = await _swarm_sync(
                plane, target, n_clients, now_fn, trust
            )
            if with_attack:
                stats["scenarios"] = await _attack_scenarios(
                    plane, bs, ss, vs, pvs, target, now_fn, trust
                )
        finally:
            await scheduler.stop()
        delta = ShapeRegistry.delta(
            before, default_shape_registry().snapshot()
        )
        stats.update(
            {
                "net_heights": bs.height,
                "target_height": target,
                "n_validators": n_vals,
                "cache": plane.cache.stats(),
                "verify": plane.verifier.stats(),
                "registry_delta": delta,
                # the metrics counters, NOT dispatch_log (a deque capped
                # at 1024 — a big swarm would silently under-report)
                "scheduler_rounds": int(
                    scheduler.metrics.dispatches.value()
                ),
                "scheduler_coalesced_rounds": int(
                    scheduler.metrics.dispatch_coalesced.value()
                ),
                "requests_per_device_dispatch": round(
                    plane.verifier.requests
                    / max(1, delta["device_dispatch_count"]),
                    1,
                ),
            }
        )
        return stats

    return asyncio.run(run())


def main() -> int:
    ap = argparse.ArgumentParser(
        description="light-client swarm bench over the serving plane"
    )
    ap.add_argument("--clients", type=int, default=1000)
    ap.add_argument("--heights", type=int, default=8)
    ap.add_argument("--vals", type=int, default=4)
    ap.add_argument("--dedup-window", type=float, default=60.0)
    ap.add_argument(
        "--no-attack", action="store_true",
        help="skip the divergent-witness / forged-header scenarios",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device the nodes and the plane verify on: cuda (default) or cpu",
    )
    args = ap.parse_args()
    stats = run_swarm(
        n_clients=args.clients,
        heights=args.heights,
        n_vals=args.vals,
        dedup_window_s=args.dedup_window,
        with_attack=not args.no_attack,
        device=args.device,
    )
    print(json.dumps(stats, indent=1))
    return 0 if stats["synced"] == stats["n_clients"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
