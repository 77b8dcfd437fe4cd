"""The port's light-client swarm: the twin of ``tools/lightserve_bench.py``.

N simulated ``LightClient``s (the port's ``light/client.py``, in-proc
providers, no sockets) sync one served chain through one
``LightServePlane`` of ``tendermint_tpu_torch``:

- every client syncs the same target height from the same trust root, so
  the proof cache serves each height's LightBlock from ONE assembly and the
  ``ServeVerifier`` collapses the swarm's identical bisection hops into a
  handful of executed verifications on the scheduler's ``lightserve`` lane
  (``VerifyScheduler(...).classed("lightserve")``);
- a **divergent-witness** scenario syncs one client against a forked
  primary (the fork RE-SIGNED by the chain's own validator keys, a true
  2/3-equivocation attack) with the honest plane as witness: the client
  must raise LightClientAttackEvidence and an ``EvidencePool`` over the
  serving node's stores must accept it;
- a **forged-header** scenario gives a client a witness serving a tampered
  block at the target: the witness is removed, the sync completes.

The served chain comes from a builder: ``drive_net`` runs an in-proc
n-validator consensus net of the port (the reference's 4-validator shape
in ``tests/test_torch_lightserve.py``), and ``chip_smoke.py`` hands in the
150-validator, 129-height chain of its phase 9. The stats keep the
reference's keys. It imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import time
from types import SimpleNamespace

TRUSTING_PERIOD_NS = 3600 * 1_000_000_000
# the plane's dedup window, tools/lightserve_bench.py's default
DEDUP_WINDOW_NS = 60 * 1_000_000_000


class BlocksProvider:
    """A light-client provider over a list of LightBlocks."""

    def __init__(self, blocks, name: str = "primary"):
        self.blocks = {b.height: b for b in blocks}
        self.name = name

    async def light_block(self, height: int):
        if height == 0:
            height = max(self.blocks)
        return self.blocks.get(height)

    def id(self) -> str:
        return self.name


def served_chain(block_store, state_store, vs, pvs, chain_id: str, now_ns=time.time_ns):
    """What the swarm needs of a chain: the serving node's stores, its
    validator set and their privvals (the fork is re-signed by them), the
    chain id and the clients' clock."""
    return SimpleNamespace(bs=block_store, ss=state_store, vs=vs, pvs=pvs,
                           chain_id=chain_id, now_ns=now_ns)


async def drive_net(heights: int, n_vals: int):
    """Run an in-proc n_vals-validator consensus net of the port (the
    broadcast hook of test_torch_consensus.wire_net) to `heights`; returns
    node 0's served chain."""
    from tests.torch_chaos_harness import CHAIN_ID, make_genesis, make_node, make_validators

    vs, pvs = make_validators(n_vals)
    genesis = make_genesis(vs)
    nodes = [make_node(vs, pv, genesis) for pv in pvs]
    css = [n[0] for n in nodes]
    for i, n in enumerate(css):
        def hook(msg, i=i):
            for j, other in enumerate(css):
                if j != i:
                    other.peer_msg_queue.put_nowait((msg, f"node{i}"))

        n.broadcast_hook = hook
    for cs in css:
        await cs.start()
    try:
        await asyncio.gather(*(cs.wait_for_height(heights, timeout=180) for cs in css))
    finally:
        for cs in css:
            await cs.stop()
    _cs0, _app, _l2, bs, ss = nodes[0]
    return served_chain(bs, ss, vs, pvs, CHAIN_ID)


def forked_light_chain(cache, chain, fork_at: int, tip: int) -> dict:
    """height -> LightBlock of a chain that shares the honest prefix below
    `fork_at` and is RE-SIGNED by the real committee from there."""
    from tendermint_tpu_torch.light.types import LightBlock
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.vote import Vote, VoteType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    vs = chain.vs
    by_addr = {pv.get_pub_key().address(): pv for pv in chain.pvs}
    ordered = [by_addr[v.address] for v in vs.validators]
    out: dict = {}
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
            last_block_id=(last_forked_id if last_forked_id is not None
                           else honest.header.last_block_id),
            _hash=None,
        )
        bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
        votes = VoteSet(chain.chain_id, h, 0, VoteType.PRECOMMIT, vs)
        for i, pv in enumerate(ordered):
            v = Vote(type=VoteType.PRECOMMIT, height=h, round=0, block_id=bid,
                     timestamp_ns=header.time_ns,
                     validator_address=pv.get_pub_key().address(), validator_index=i)
            pv.sign_vote(chain.chain_id, v)
            votes.add_vote(v, verified=True)
        out[h] = LightBlock(header, votes.make_commit(), vs)
        last_forked_id = bid
    return out


async def swarm_sync(plane, chain_id: str, target: int, n_clients: int, now_fn, trust) -> dict:
    """n_clients LightClients, each with the plane as primary and witness
    and the plane's ServeVerifier, verify to `target` at once."""
    from tendermint_tpu_torch.light.client import LightClient
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.store.kv import MemKV

    async def one_client(i: int) -> bool:
        c = LightClient(
            chain_id, trust, plane.provider(), [plane.provider("witness-0")],
            LightStore(MemKV()), now_ns=now_fn, serve_verifier=plane.verifier,
        )
        lb = await c.verify_light_block_at_height(target)
        return lb.height == target

    t0 = time.perf_counter()
    results = await asyncio.gather(*(one_client(i) for i in range(n_clients)))
    wall = time.perf_counter() - t0
    return {
        "n_clients": n_clients,
        "synced": sum(bool(r) for r in results),
        "wall_s": round(wall, 3),
        "clients_per_s": round(n_clients / wall, 1) if wall else 0.0,
    }


async def attack_scenarios(plane, chain, target: int, now_fn, trust) -> dict:
    """Divergent-witness (a verifiable fork -> evidence in the pool) and
    forged-header (the tampered witness removed) scenarios. The accepted
    evidence's bytes ride along (hex) for callers that gossip it."""
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.light.client import ErrLightClientAttack, LightClient
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence

    out: dict = {}
    # --- divergent witness: forked primary vs the honest plane ------------
    forked = forked_light_chain(plane.cache, chain, fork_at=max(2, target - 2), tip=target)
    c = LightClient(
        chain.chain_id, trust,
        BlocksProvider(list(forked.values()), name="byzantine-primary"),
        [plane.provider("honest-witness")], LightStore(MemKV()), now_ns=now_fn,
    )
    detected = False
    pool_size = 0
    evidence_hex = None
    try:
        await c.verify_light_block_at_height(target)
    except ErrLightClientAttack as e:
        detected = True
        pool = EvidencePool(MemKV(), chain.ss, chain.bs)
        pool.add_evidence(e.evidence)
        pool_size = len(pool.pending_evidence())
        out["evidence_is_light_attack"] = isinstance(e.evidence, LightClientAttackEvidence)
        evidence_hex = e.evidence.encode().hex()
    out["divergent_witness"] = {
        "attack_detected": detected,
        "evidence_pool_size": pool_size,
        "evidence_hex": evidence_hex,
    }

    # --- forged header: tampered witness removed, sync completes ----------
    tampered = copy.deepcopy(plane.cache.get(target))
    tampered.header.app_hash = b"tampered"
    tampered.header._hash = None
    bad_blocks = [(tampered if h == target else plane.cache.get(h))
                  for h in range(1, target + 1)]
    c2 = LightClient(
        chain.chain_id, trust, plane.provider(),
        [BlocksProvider(bad_blocks, name="forged-witness"),
         plane.provider("honest-witness")],
        LightStore(MemKV()), now_ns=now_fn,
    )
    lb = await c2.verify_light_block_at_height(target)
    out["forged_header"] = {
        "synced": lb.height == target,
        "forged_witness_removed": [w.id() for w in c2.witnesses] == ["honest-witness"],
    }
    return out


def run_swarm(
    n_clients: int = 1000,
    heights: int = 8,
    n_vals: int = 4,
    chain=None,
    scheduler=None,
) -> dict:
    """The whole harness: chain -> plane -> swarm -> attack scenarios. The
    chain is `chain` (served_chain) or, without it, an in-proc net of
    n_vals validators run to `heights` (drive_net). The plane verifies on
    `scheduler`'s (or a new VerifyScheduler's) lightserve lane, started
    here. Returns one stats dict with the reference's keys."""
    from tendermint_tpu_torch.crypto.shape_registry import (
        ShapeRegistry,
        default_shape_registry,
    )
    from tendermint_tpu_torch.libs.metrics import LightServeMetrics, Registry, SchedulerMetrics
    from tendermint_tpu_torch.light.client import TrustOptions
    from tendermint_tpu_torch.lightserve import LightServePlane
    from tendermint_tpu_torch.parallel.scheduler import VerifyScheduler

    async def run() -> dict:
        served = chain if chain is not None else await drive_net(heights, n_vals)
        bs = served.bs
        # the tip's commit is still the seen commit (no canonical one until
        # height + 1 exists), so the swarm targets one below it: every
        # served height is then durable and cacheable
        target = bs.height - 1
        reg = Registry("lightserve_swarm")
        sched = scheduler or VerifyScheduler(metrics=SchedulerMetrics(reg))
        await sched.start()
        plane = LightServePlane(
            bs, served.ss, served.chain_id,
            dedup_window_ns=DEDUP_WINDOW_NS,
            verifier=sched.classed("lightserve"),
            metrics=LightServeMetrics(reg),
        )
        root = plane.cache.get(1)
        trust = TrustOptions(TRUSTING_PERIOD_NS, 1, root.header.hash())
        now_fn = served.now_ns
        rounds0 = int(sched.metrics.dispatches.value())
        coalesced0 = int(sched.metrics.dispatch_coalesced.value())
        before = default_shape_registry().snapshot()
        try:
            stats = await swarm_sync(plane, served.chain_id, target, n_clients, now_fn, trust)
            stats["scenarios"] = await attack_scenarios(plane, served, target, now_fn, trust)
        finally:
            await sched.stop()
        delta = ShapeRegistry.delta(before, default_shape_registry().snapshot())
        stats.update({
            "net_heights": bs.height,
            "target_height": target,
            "n_validators": served.vs.size(),
            "cache": plane.cache.stats(),
            "verify": plane.verifier.stats(),
            "registry_delta": delta,
            # the metrics counters, not dispatch_log (a deque capped at 1024)
            "scheduler_rounds": int(sched.metrics.dispatches.value()) - rounds0,
            "scheduler_coalesced_rounds":
                int(sched.metrics.dispatch_coalesced.value()) - coalesced0,
            "requests_per_device_dispatch": round(
                plane.verifier.requests / max(1, delta["device_dispatch_count"]), 1),
        })
        return stats

    return asyncio.run(run())
