"""The port's light-client serving plane (``lightserve/{cache,verifier,
plane}.py``) against the contract of ``tests/test_lightserve.py``: the
proof cache's durability-pinned admission, rollback purge and LRU bound;
the ``ServeVerifier``'s hop dedup, shared failure verdicts and per-client
time checks; a sequential client refusing non-adjacent blocks; a
server-assisted swarm; the scheduler's ``lightserve`` lane; the trusted
store's prune safety; and the 1,000-client swarm of
``tools/lightserve_bench.py`` through the port's twin,
``tests/torch_lightserve_swarm.py``, at the reference's size (4
validators, 6 heights) with its asserts. Each contract runs one body on
both packages' roots (the JAX package's as the yardstick). Beside them:

- parity: both packages' ``ServeVerifier`` on the same seeded hop sequence
  give the same verdicts, the same error types and messages and the same
  ``stats()``;
- the lane: executed hops of a 10-validator chain reach the scheduler's
  ``lightserve`` class and, at 8+ rows, the plain version of kernel 3
  (``verify_prehashed_table``).

The port verifies on its process verifier on ``device="cpu"``
(``cpu_verifier``); the JAX package on a verifier of that package whose
``min_device_batch`` no round reaches (``ref_host_verifier``). The eight
tests of the reference file that need ``rpc.*``, ``node.node`` or
``tools.prewarm`` wait for those modules (ROADMAP.md, item A5).
Tolerance: exact (verdicts, stats, hashes).
"""

from __future__ import annotations

import asyncio
import importlib
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    PORT,
    REF,
    cpu_verifier,
    make_genesis,
    make_node,
    make_validators,
)
from .test_torch_light import (  # noqa: F401 (ref_host_verifier: a fixture)
    BLOCK_NS,
    CHAIN_ID as LIGHT_CHAIN_ID,
    LP,
    LR,
    PERIOD,
    T0,
    MockProvider,
    make_chain,
    ref_host_verifier,
)

pytestmark = pytest.mark.lightserve

ROOTS = [PORT.root, REF.root]


def serve_ns(root: str) -> SimpleNamespace:
    """The serving plane's classes of one package, with its light client's
    and its net builders."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    ls = m("lightserve")
    metrics = m("libs.metrics")
    verifier = m("light.verifier")
    return SimpleNamespace(
        light=LP if root == PORT.root else LR,
        net=PORT if root == PORT.root else REF,
        LightBlockCache=ls.LightBlockCache,
        LightServePlane=ls.LightServePlane,
        ServeVerifier=ls.ServeVerifier,
        LightServeMetrics=metrics.LightServeMetrics,
        Registry=metrics.Registry,
        VerificationError=verifier.VerificationError,
        ErrNewHeaderTooFarAhead=verifier.ErrNewHeaderTooFarAhead,
        CLASS_ORDER=m("parallel.scheduler").CLASS_ORDER,
    )


NS = {root: serve_ns(root) for root in ROOTS}


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def sn(request):
    """One package's serving-plane namespace; for the JAX package its
    process verifier on its host oracle and no default scheduler."""
    if request.param == REF.root:
        request.getfixturevalue("ref_host_verifier")
    return NS[request.param]


def _metrics(sn):
    return sn.LightServeMetrics(sn.Registry("lightserve_test"))


async def _drive_net(sn, heights, n_vals=1):
    ns = sn.net
    vs, pvs = make_validators(ns, n_vals)
    genesis = make_genesis(ns, vs)
    nodes = [make_node(ns, vs, pv, genesis) for pv in pvs]
    for cs, *_ in nodes:
        await cs.start()
    try:
        await asyncio.gather(*(cs.wait_for_height(heights, timeout=120) for cs, *_ in nodes))
    finally:
        for cs, *_ in nodes:
            await cs.stop()
    return nodes[0]


def _chain(sn, n, **kw):
    return make_chain(n, ns=sn.light, **kw)


# --- the proof cache ---------------------------------------------------------


def test_cache_assembles_once_and_pins_to_durable(sn):
    async def run():
        _cs, _app, _l2, bs, ss = await _drive_net(sn, 4)
        cache = sn.LightBlockCache(bs, ss, metrics=_metrics(sn))
        tip = bs.height
        lb = cache.get(tip - 1)
        assert lb is not None and lb.height == tip - 1
        lb.validate_basic(lb.header.chain_id)
        again = cache.get(tip - 1)
        assert again is lb  # the shared object, not a re-assembly
        assert cache.hits == 1 and cache.assembled == 1
        # the tip's canonical commit lives in block tip + 1: served fresh
        # from the seen commit, never cached
        tip_lb = cache.get(tip)
        assert tip_lb is not None and tip_lb.height == tip
        assert cache.get(tip) is not tip_lb
        assert len(cache) == 1
        assert cache.get(0).height == tip
        assert cache.get(tip + 10) is None

    asyncio.run(run())


def test_cache_drops_entries_above_a_rollback(sn):
    async def run():
        _cs, _app, _l2, bs, ss = await _drive_net(sn, 5)
        cache = sn.LightBlockCache(bs, ss, metrics=_metrics(sn))
        h = bs.height - 1
        assert cache.get(h) is not None
        assert len(cache) == 1
        bs.prune_blocks_since(h - 1)
        assert cache.get(h) is None
        assert len(cache) == 0 or cache.get(h - 2) is not None

    asyncio.run(run())


def test_cache_rollback_purges_stale_entries_on_observation(sn):
    async def run():
        _cs, _app, _l2, bs, ss = await _drive_net(sn, 6)
        cache = sn.LightBlockCache(bs, ss, metrics=_metrics(sn))
        h = bs.height - 1
        assert cache.get(h) is not None
        assert cache.get(h - 2) is not None
        assert len(cache) == 2
        bs.prune_blocks_since(h - 1)
        # an access to an unrelated height observes the regression and
        # purges the now-suspect entry at h
        assert cache.get(h - 2) is not None
        assert len(cache) == 1
        assert cache.get(h) is None

    asyncio.run(run())


def test_cache_lru_bound(sn):
    async def run():
        _cs, _app, _l2, bs, ss = await _drive_net(sn, 6)
        cache = sn.LightBlockCache(bs, ss, max_entries=2, metrics=_metrics(sn))
        for h in range(1, bs.height):
            cache.get(h)
        assert len(cache) <= 2

    asyncio.run(run())


# --- the serve verifier -------------------------------------------------------


def test_serve_verifier_dedups_identical_hops(sn):
    chain = _chain(sn, 40)
    sv = sn.ServeVerifier(metrics=_metrics(sn))
    now = T0 + 50 * BLOCK_NS

    async def run():
        await asyncio.gather(*(sv.verify_hop(chain[0], chain[29], PERIOD, now)
                               for _ in range(32)))
        assert sv.executed == 1
        assert sv.deduped == 31
        await sv.verify_hop(chain[0], chain[29], PERIOD, now + BLOCK_NS)
        assert sv.executed == 1
        await sv.verify_hop(chain[0], chain[29], PERIOD, now + sv.reuse_window_ns * 2)
        assert sv.executed == 2

    asyncio.run(run())


def test_serve_verifier_shares_failure_verdicts(sn):
    honest = _chain(sn, 30)
    garbage = _chain(sn, 30, seed=b"unrelated")
    sv = sn.ServeVerifier(metrics=_metrics(sn))
    now = T0 + 40 * BLOCK_NS

    async def run():
        outcomes = await asyncio.gather(
            *(sv.verify_hop(honest[0], garbage[29], PERIOD, now) for _ in range(8)),
            return_exceptions=True,
        )
        assert all(isinstance(o, (sn.VerificationError, sn.ErrNewHeaderTooFarAhead))
                   for o in outcomes)
        assert sv.executed == 1

    asyncio.run(run())


def test_skewed_client_cannot_poison_the_verdict_cache(sn):
    chain = _chain(sn, 40)
    sv = sn.ServeVerifier(metrics=_metrics(sn))
    honest_now = T0 + 50 * BLOCK_NS
    skewed_now = T0 + 10 * BLOCK_NS

    async def run():
        with pytest.raises(sn.VerificationError, match="future"):
            await sv.verify_hop(chain[0], chain[29], PERIOD, skewed_now)
        assert sv.executed == 0  # rejected before the shared cache
        await sv.verify_hop(chain[0], chain[29], PERIOD, honest_now)
        assert sv.executed == 1
        with pytest.raises(sn.VerificationError, match="future"):
            await sv.verify_hop(chain[0], chain[29], PERIOD, skewed_now)
        assert sv.executed == 1

    asyncio.run(run())


def test_bogus_trusted_valset_cannot_poison_honest_key(sn):
    chain = _chain(sn, 40)
    other = _chain(sn, 40, seed=b"other")
    sv = sn.ServeVerifier(metrics=_metrics(sn))
    now = T0 + 50 * BLOCK_NS
    bogus_trusted = sn.light.LightBlock(chain[0].header, chain[0].commit, other[0].validators)

    async def run():
        with pytest.raises(sn.VerificationError):
            await sv.verify_hop(bogus_trusted, chain[29], PERIOD, now)
        await sv.verify_hop(chain[0], chain[29], PERIOD, now)
        assert sv.executed == 2 and sv.deduped == 0

    asyncio.run(run())


def test_sequential_mode_rejects_non_adjacent_blocks(sn):
    chain = _chain(sn, 10)
    L = sn.light

    class MisservingProvider(MockProvider):
        async def light_block(self, height):
            if height not in (0, 1, 10):
                height = min(height + 3, 9)  # wrong interim heights
            return await super().light_block(height)

    async def run():
        c = L.LightClient(
            LIGHT_CHAIN_ID, L.TrustOptions(PERIOD, 1, chain[0].header.hash()),
            MisservingProvider(chain), [MockProvider(chain, name="w")],
            L.LightStore(L.MemKV()), sequential=True,
            now_ns=lambda: T0 + 20 * BLOCK_NS,
        )
        with pytest.raises(sn.VerificationError, match="sequential"):
            await c.verify_light_block_at_height(10)

    asyncio.run(run())


def test_server_assisted_client_swarm_dedups(sn):
    chain = _chain(sn, 50)
    sv = sn.ServeVerifier(metrics=_metrics(sn))
    now = T0 + 60 * BLOCK_NS
    L = sn.light

    async def one():
        c = L.LightClient(
            LIGHT_CHAIN_ID, L.TrustOptions(PERIOD, 1, chain[0].header.hash()),
            MockProvider(chain), [MockProvider(chain, name="w")],
            L.LightStore(L.MemKV()), now_ns=lambda: now, serve_verifier=sv,
        )
        lb = await c.verify_light_block_at_height(50)
        assert lb.height == 50

    async def run():
        await asyncio.gather(*(one() for _ in range(64)))

    asyncio.run(run())
    assert sv.requests >= 64
    assert sv.executed <= 4  # root verify + one direct skip hop
    assert sv.dedup_rate() > 0.9


def test_scheduler_has_lightserve_lane(sn):
    assert "lightserve" in sn.CLASS_ORDER
    # serving external clients ranks below every internal class
    assert sn.CLASS_ORDER.index("lightserve") == len(sn.CLASS_ORDER) - 1


# --- trusted-store prune safety -------------------------------------------------


def test_light_store_prune_never_evicts_latest_anchor(sn):
    L = sn.light
    chain = _chain(sn, 10)
    store = L.LightStore(L.MemKV())
    for lb in chain:
        store.save(lb)
    store.prune(0)  # hostile keep: the anchor must survive
    assert store.latest() is not None
    assert store.latest().height == 10
    store2 = L.LightStore(L.MemKV())
    for lb in chain:
        store2.save(lb)
    store2.prune(3)
    assert store2.heights() == [8, 9, 10]
    assert store2.latest().height == 10


def test_light_store_prune_mid_bisection_keeps_anchor(sn):
    L = sn.light
    chain = _chain(sn, 60)

    async def run():
        c = L.LightClient(
            LIGHT_CHAIN_ID, L.TrustOptions(PERIOD, 1, chain[0].header.hash()),
            MockProvider(chain), [MockProvider(chain, name="w")],
            L.LightStore(L.MemKV()), pruning_size=1,
            now_ns=lambda: T0 + 70 * BLOCK_NS,
        )
        lb = await c.verify_light_block_at_height(60)
        assert lb.height == 60
        assert c.store.latest().height == 60
        lb2 = await c.verify_light_block_at_height(60)
        assert lb2.height == 60

    asyncio.run(run())


# --- the swarm acceptance, on the port ----------------------------------------------


def test_swarm_1000_clients_shared_rounds_and_attack_evidence():
    """1,000 simulated light clients sync a 4-validator net of the port
    through its serving plane (tests/torch_lightserve_swarm.py): cache hit
    rate > 0.9, device dispatches sublinear in the client count, the
    divergent-witness scenario lands LightClientAttackEvidence in the
    port's evidence pool, the forged-header witness removed."""
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence, decode_evidence

    from .torch_lightserve_swarm import run_swarm

    stats = run_swarm(n_clients=1000, heights=6, n_vals=4)
    assert stats["synced"] == stats["n_clients"] == 1000
    assert stats["cache"]["hit_rate"] > 0.9
    assert stats["verify"]["executed"] <= 8
    assert stats["registry_delta"]["device_dispatch_count"] <= 8
    assert (stats["registry_delta"]["device_dispatch_count"] + stats["scheduler_rounds"]
            < stats["n_clients"] / 10)
    assert stats["verify"]["dedup_rate"] > 0.99
    sc = stats["scenarios"]
    assert sc["divergent_witness"]["attack_detected"]
    assert sc["divergent_witness"]["evidence_pool_size"] >= 1
    assert sc["forged_header"]["synced"]
    assert sc["forged_header"]["forged_witness_removed"]
    ev = decode_evidence(bytes.fromhex(sc["divergent_witness"]["evidence_hex"]))
    assert isinstance(ev, LightClientAttackEvidence) and sc["evidence_is_light_attack"]
    assert set(stats) >= {"synced", "n_clients", "cache", "verify", "registry_delta",
                          "scheduler_rounds", "scheduler_coalesced_rounds", "scenarios"}


# --- parity with the JAX package ------------------------------------------------------


def _hop_sequence(sn):
    """One seeded sequence of requests to a fresh ServeVerifier of package
    `sn`: (step, outcome) with outcome "ok" or the error's type name and
    message, and the final stats()."""
    chain = _chain(sn, 40)
    garbage = _chain(sn, 40, seed=b"unrelated")
    other = _chain(sn, 40, seed=b"other")
    sv = sn.ServeVerifier(metrics=_metrics(sn))
    now = T0 + 50 * BLOCK_NS
    bogus = sn.light.LightBlock(chain[0].header, chain[0].commit, other[0].validators)
    steps = [
        ("root", lambda: sv.verify_root(chain[0], now)),
        ("root again", lambda: sv.verify_root(chain[0], now)),
        ("hop 1-30", lambda: sv.verify_hop(chain[0], chain[29], PERIOD, now)),
        ("hop 1-30 again", lambda: sv.verify_hop(chain[0], chain[29], PERIOD, now + BLOCK_NS)),
        ("adjacent 30-31", lambda: sv.verify_hop(chain[29], chain[30], PERIOD, now)),
        ("garbage target", lambda: sv.verify_hop(chain[0], garbage[29], PERIOD, now)),
        ("garbage again", lambda: sv.verify_hop(chain[0], garbage[29], PERIOD, now)),
        ("skewed clock", lambda: sv.verify_hop(chain[0], chain[29], PERIOD, T0 + 10 * BLOCK_NS)),
        ("bogus trusted set", lambda: sv.verify_hop(bogus, chain[29], PERIOD, now)),
        ("expired", lambda: sv.verify_hop(chain[0], chain[39], PERIOD, T0 + PERIOD + 100 * BLOCK_NS)),
        ("outside the window",
         lambda: sv.verify_hop(chain[0], chain[29], PERIOD, now + sv.reuse_window_ns * 2)),
    ]

    async def run():
        out = []
        for name, call in steps:
            try:
                await call()
                out.append((name, "ok"))
            except Exception as e:  # both packages' errors compared by name
                out.append((name, type(e).__name__, str(e)))
        return out

    return asyncio.run(run()), sv.stats()


def test_serve_verifier_same_verdicts_and_stats(ref_host_verifier):
    """The same seeded hop sequence through both packages' ServeVerifier:
    the same verdicts, error types and messages, and the same stats()."""
    got = {root: _hop_sequence(NS[root]) for root in ROOTS}
    assert got[PORT.root] == got[REF.root]
    outcomes, stats = got[PORT.root]
    kinds = {o[0]: o[1] for o in outcomes}
    assert kinds["hop 1-30"] == "ok" and kinds["skewed clock"] != "ok"
    assert kinds["garbage target"] != "ok" and kinds["bogus trusted set"] != "ok"
    assert stats["executed"] >= 4 and stats["deduped"] >= 3


def test_executed_hops_reach_the_lightserve_lane_and_kernel3_plain(monkeypatch):
    """A 10-validator chain's executed hops go through a started
    VerifyScheduler's lightserve class (the ledger's rows) and, at 10 rows
    (over min_device_batch), through kernel 3's plain version on the CPU;
    every other request rides the dedup."""
    import torch

    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.lightserve import ServeVerifier
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.ops import ed25519_batch as ed
    from tendermint_tpu_torch.parallel.scheduler import VerifyScheduler

    torch.set_num_threads(1)  # the plain version is thousands of small ops
    plain = ed.verify_prehashed_table_plain
    calls = []

    def counted(*args):
        calls.append(int(args[2].shape[0]))
        return plain(*args)

    monkeypatch.setattr(ed, "verify_prehashed_table_plain", counted)
    chain = make_chain(30, n_vals=10)
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(Registry("ls_lane")))
    sv = ServeVerifier(verifier=sched.classed("lightserve"),
                       metrics=NS[PORT.root].LightServeMetrics(Registry("ls_lane_m")))
    now = T0 + 40 * BLOCK_NS

    async def run():
        await sched.start()
        try:
            await asyncio.gather(*(sv.verify_root(chain[0], now) for _ in range(4)))
            await asyncio.gather(*(sv.verify_hop(chain[0], chain[29], PERIOD, now)
                                   for _ in range(4)))
        finally:
            await sched.stop()

    asyncio.run(run())
    assert sv.executed == 2 and sv.deduped == 6
    rounds = [e for e in ledger.entries() if "lightserve" in e["rows"]]
    # the root's full-power round; the hop's trusting and full rounds
    assert len(rounds) >= 3, ledger.entries()
    assert all(e["rows"]["lightserve"] == 10 for e in rounds), rounds
    assert len(calls) >= 3 and all(b >= 10 for b in calls), calls
