"""The port's verify dispatch scheduler against the contract of
``tests/test_scheduler.py``: coalescing, priority, per-submitter FIFO,
clean drain, thread bridges and fallbacks, the fn lane, failure recovery,
metrics, the real verifier, ``default_dispatch`` plumbing and the vote
batcher. The scheduler is a verbatim copy; these run it on the port's
verifier (device="cpu": host path and the kernels' plain versions) and on
the same deterministic stubs. Also: the unported fn-lane engines raise
NotImplementedError. Tolerance: exact verdicts."""

import asyncio
import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.crypto.batch_verifier import BatchVerifier, SigItem
from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
from tendermint_tpu_torch.parallel.scheduler import (
    VerifyScheduler,
    default_dispatch,
    set_default_scheduler,
)

BAD = b"\x00" * 64


def _item(i: int, ok: bool = True) -> SigItem:
    return SigItem(b"\x01" * 32, b"m%d" % i, b"\x02" * 64 if ok else BAD)


class StubVerifier:
    """Deterministic stand-in: records each dispatched batch, optional
    device-ish latency so submissions coalesce into the next round."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.batches: list[list[SigItem]] = []

    def verify(self, items):
        if self.delay:
            time.sleep(self.delay)
        self.batches.append(list(items))
        return np.array([it.sig != BAD for it in items])


def _sched(stub=None, **kw) -> VerifyScheduler:
    return VerifyScheduler(
        verifier=stub or StubVerifier(),
        metrics=SchedulerMetrics(Registry("test")),
        **kw,
    )


def test_cross_subsystem_coalescing():
    """Items from different classes merge into ONE padded dispatch while
    a round is in flight, and each submission's verdicts stay aligned."""
    stub = StubVerifier(delay=0.02)
    s = _sched(stub)

    async def run():
        await s.start()
        # first submission occupies the device; the rest queue and must
        # coalesce into one follow-up round
        first = asyncio.create_task(s.submit([_item(0)], "consensus"))
        await asyncio.sleep(0.005)
        outs = await asyncio.gather(
            s.submit([_item(1), _item(2, ok=False)], "consensus"),
            s.submit([_item(3)], "blocksync"),
            s.submit([_item(4)], "light"),
            first,
        )
        await s.stop()
        return outs

    a, b, c, first = asyncio.run(run())
    assert a.tolist() == [True, False]
    assert b.tolist() == [True]
    assert c.tolist() == [True]
    assert first.tolist() == [True]
    sizes = sorted(len(batch) for batch in stub.batches)
    assert sizes == [1, 4], f"expected one coalesced round, got {sizes}"
    coalesced = [d for d in s.dispatch_log if d["subs"] >= 2]
    assert coalesced and set(coalesced[0]["classes"]) == {
        "consensus", "blocksync", "light",
    }
    assert s.metrics.dispatch_coalesced.value() == 1


def test_consensus_preempts_bulk_flood():
    """A blocksync flood must not starve consensus: a consensus item
    submitted mid-flood rides the very next round."""
    stub = StubVerifier(delay=0.01)
    s = _sched(stub, max_batch=64)

    async def run():
        await s.start()
        flood = [
            asyncio.create_task(
                s.submit([_item(1000 + 64 * j + i) for i in range(64)],
                         "blocksync")
            )
            for j in range(8)
        ]
        await asyncio.sleep(0.015)  # flood is mid-flight
        t0 = time.perf_counter()
        ok = await s.submit([_item(0)], "consensus")
        consensus_wait = time.perf_counter() - t0
        await asyncio.gather(*flood)
        await s.stop()
        return ok, consensus_wait

    ok, wait = asyncio.run(run())
    assert ok.tolist() == [True]
    # serial drain of the remaining flood would be ~6 rounds x 10 ms;
    # preemption bounds the wait to ~1-2 rounds
    assert wait < 0.04, f"consensus starved behind flood: {wait:.3f}s"
    # and the round carrying the consensus item ran before the flood end
    idx = next(
        i for i, batch in enumerate(stub.batches)
        if any(it.msg == b"m0" for it in batch)
    )
    assert idx < len(stub.batches) - 1


def test_per_submitter_fifo_order():
    """Verdicts resolve strictly in submission order within a class,
    including when a large submission spans multiple rounds."""
    stub = StubVerifier(delay=0.002)
    s = _sched(stub, max_batch=16)
    resolved = []

    async def one(tag, items):
        await s.submit(items, "blocksync")
        resolved.append(tag)

    async def run():
        await s.start()
        tasks = [
            asyncio.create_task(one(0, [_item(i) for i in range(40)])),
        ]
        await asyncio.sleep(0)  # deterministic enqueue order
        tasks += [
            asyncio.create_task(one(1, [_item(100 + i) for i in range(4)])),
            asyncio.create_task(one(2, [_item(200)])),
        ]
        await asyncio.gather(*tasks)
        await s.stop()

    asyncio.run(run())
    assert resolved == [0, 1, 2]
    # the 40-item submission split across max_batch=16 rounds
    assert max(len(b) for b in stub.batches) <= 16


def test_clean_drain_on_stop():
    """stop() dispatches everything already queued — no submission is
    abandoned or failed."""
    stub = StubVerifier(delay=0.01)
    s = _sched(stub)

    async def run():
        await s.start()
        subs = [
            asyncio.create_task(s.submit([_item(i)], "consensus"))
            for i in range(24)
        ]
        await asyncio.sleep(0)  # enqueue, then immediately drain
        await s.stop()
        return await asyncio.gather(*subs)

    outs = asyncio.run(run())
    assert all(o.tolist() == [True] for o in outs)
    assert sum(len(b) for b in stub.batches) == 24


def test_threadsafe_bridge_and_fallbacks():
    """submit_sync coalesces from worker threads; degrades to direct
    dispatch on an event-loop thread, before start, and after stop."""
    stub = StubVerifier(delay=0.005)
    s = _sched(stub)

    # not started: direct
    out = s.submit_sync([_item(0)], "blocksync")
    assert out.tolist() == [True] and len(stub.batches) == 1

    async def run():
        await s.start()
        loop = asyncio.get_running_loop()
        outs = await asyncio.gather(
            *(
                loop.run_in_executor(
                    None, s.submit_sync, [_item(10 + i)], "blocksync"
                )
                for i in range(6)
            )
        )
        # on the loop thread: direct dispatch, never a deadlock
        onloop = s.classed("light").verify([_item(99)])
        await s.stop()
        return outs, onloop

    outs, onloop = asyncio.run(run())
    assert all(o.tolist() == [True] for o in outs)
    assert onloop.tolist() == [True]
    # after stop: direct again
    assert s.submit_sync([_item(1)], "blocksync").tolist() == [True]


def test_fn_lane_serializes_with_priority():
    """A private-engine (BLS-style) submission dispatches as its own
    round on the shared dispatch thread, under the same class order."""
    stub = StubVerifier(delay=0.01)
    s = _sched(stub)
    fn_batches = []

    def bls_like(items):
        fn_batches.append(list(items))
        return [True for _ in items]

    async def run():
        await s.start()
        sig = asyncio.create_task(s.submit([_item(0)], "blocksync"))
        await asyncio.sleep(0.003)
        fn = asyncio.create_task(
            s.submit_fn([("pk", "msg", "sig")], bls_like, "consensus")
        )
        out = await asyncio.gather(sig, fn)
        await s.stop()
        return out

    sig_out, fn_out = asyncio.run(run())
    assert sig_out.tolist() == [True]
    assert fn_out == [True]
    assert fn_batches == [[("pk", "msg", "sig")]]
    assert any(d.get("fn") for d in s.dispatch_log)


def test_failed_partial_submission_drops_remainder():
    """When a round carrying one slice of a multi-round submission
    fails, the queued remainder is discarded — the scheduler must not
    burn device rounds on a future that already holds the exception."""

    class FailFirst(StubVerifier):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def verify(self, items):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            return super().verify(items)

    stub = FailFirst()
    s = _sched(stub, max_batch=8)

    async def run():
        await s.start()
        big = asyncio.create_task(
            s.submit([_item(i) for i in range(40)], "blocksync")
        )
        try:
            raised = not (await big)
        except RuntimeError:
            raised = True
        # after the failure settles, a fresh submission still verifies
        ok = await s.submit([_item(100)], "consensus")
        await s.stop()
        return raised, ok

    raised, ok = asyncio.run(run())
    assert raised, "failed submission must surface its exception"
    assert ok.tolist() == [True]
    # round 1 (8 items) failed; at most ONE already-pipelined residual
    # round (8 items) may have executed before the failure was observed;
    # the remaining >=24 items were dropped at the queue head
    dead = sum(
        len(b) for b in stub.batches if any(it.sig != BAD for it in b)
        and any(it.msg != b"m100" for it in b)
    )
    assert dead <= 8, f"dead rounds kept dispatching: {dead} items"
    assert sum(len(b) for b in stub.batches) <= 9


def test_shape_registry_rows_dimension():
    """A grown table store is a new program even at the same bucket:
    the registry keys shapes on (bucket, rows, devices)."""
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry

    reg = ShapeRegistry()
    assert reg.record_dispatch("small", 8, rows=128) is True
    assert reg.record_dispatch("small", 8, rows=128) is False
    assert reg.record_dispatch("small", 8, rows=256) is True  # regrown
    assert reg.record_dispatch("generic", 8) is True
    assert reg.distinct_shapes("small") == 2
    assert reg.buckets_by_tier()["small"] == (8,)
    assert reg.shapes_by_tier()["small"] == ((8, 128, 1), (8, 256, 1))
    assert reg.dispatch_count() == 4
    # a sharded round is a distinct program even at the same bucket/rows
    assert reg.record_dispatch("small", 8, rows=128, devices=4) is True
    assert reg.record_dispatch("small", 8, rows=128, devices=4) is False
    assert reg.distinct_shapes("small") == 3
    assert reg.sharded_dispatch_count() == 2
    snap = reg.snapshot()
    assert snap["sharded_dispatch_count"] == 2
    delta = ShapeRegistry.delta(
        snap, (reg.record_dispatch("small", 8, rows=128, devices=4),
               reg.snapshot())[1]
    )
    assert delta["sharded_dispatch_count"] == 1
    assert delta["device_dispatch_count"] == 1
    assert delta["distinct_program_shapes"] == 0


def test_verifier_failure_resolves_futures_and_recovers():
    """A verifier exception fails the affected submissions (the sync
    bridge then falls back to direct dispatch) without killing the
    worker — later rounds still verify."""

    class FlakyVerifier(StubVerifier):
        def __init__(self):
            super().__init__()
            self.fail_next = True

        def verify(self, items):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("injected device fault")
            return super().verify(items)

    s = _sched(FlakyVerifier())

    async def run():
        await s.start()
        loop = asyncio.get_running_loop()
        # bridge path: scheduler round fails -> direct fallback verifies
        out1 = await loop.run_in_executor(
            None, s.submit_sync, [_item(0)], "blocksync"
        )
        out2 = await s.submit([_item(1)], "consensus")
        await s.stop()
        return out1, out2

    out1, out2 = asyncio.run(run())
    assert out1.tolist() == [True]
    assert out2.tolist() == [True]


def test_metrics_and_queue_depth_accounting():
    stub = StubVerifier(delay=0.01)
    s = _sched(stub)

    async def run():
        await s.start()
        first = asyncio.create_task(s.submit([_item(0)], "consensus"))
        await asyncio.sleep(0.003)
        queued = asyncio.create_task(
            s.submit([_item(i) for i in range(1, 5)], "blocksync")
        )
        await asyncio.sleep(0)
        depth_mid = s.metrics.queue_depth.value(klass="blocksync")
        await asyncio.gather(first, queued)
        await s.stop()
        return depth_mid

    depth_mid = asyncio.run(run())
    assert depth_mid == 4  # queued while round 1 was in flight
    assert s.metrics.queue_depth.value(klass="blocksync") == 0
    assert s.metrics.dispatches.value() >= 2
    assert 0 < s.metrics.batch_fill_ratio.value() <= 1.0


def test_real_host_verifier_through_scheduler():
    """End-to-end with the real BatchVerifier host fast path: verdicts
    through the scheduler are bit-identical to the serial host oracle,
    adversarial rows included."""
    v = BatchVerifier(min_device_batch=1 << 30, device="cpu")
    s = VerifyScheduler(
        verifier=v, metrics=SchedulerMetrics(Registry("test2"))
    )
    keys = [host.PrivKey.from_secret(b"sched%d" % i) for i in range(8)]
    items, want = [], []
    for i, k in enumerate(keys):
        msg = b"vote-%d" % i
        sig = k.sign(msg)
        if i % 3 == 1:
            sig = BAD
        if i % 3 == 2:
            msg = msg + b"!"
        items.append(SigItem(k.public_key().data, msg, sig))
        want.append(host.verify(items[-1].pubkey, msg, items[-1].sig))

    async def run():
        await s.start()
        loop = asyncio.get_running_loop()
        got = await loop.run_in_executor(
            None, s.submit_sync, items, "blocksync"
        )
        await s.stop()
        return got

    got = asyncio.run(run())
    assert got.tolist() == want


def test_default_dispatch_plumbing(monkeypatch):
    """default_dispatch returns the raw verifier with no scheduler
    installed, and a classed adapter (self-degrading while stopped)
    when one is."""
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier

    monkeypatch.setattr(bv, "_default", None)
    default_verifier(device="cpu")
    set_default_scheduler(None)
    assert default_dispatch("light") is default_verifier()
    s = _sched()
    set_default_scheduler(s)
    try:
        adapter = default_dispatch("light")
        assert adapter is not default_verifier()
        # not started -> degrades to direct dispatch on the stub
        assert adapter.verify([_item(0)]).tolist() == [True]
    finally:
        set_default_scheduler(None)


def test_vote_batcher_routes_via_scheduler(monkeypatch):
    """VoteBatcher bound to the shared verifier rides the installed
    scheduler; its batches appear in the scheduler's dispatch log under
    the consensus class."""
    from tendermint_tpu_torch.consensus.vote_batcher import VoteBatcher

    monkeypatch.setattr(bv, "_default", None)
    bv.default_verifier(device="cpu")
    stub = StubVerifier()
    s = _sched(stub)
    set_default_scheduler(s)
    try:
        batcher = VoteBatcher()  # no explicit verifier -> routable
        batcher._route_scheduler = True

        async def run():
            await s.start()
            outs = await asyncio.gather(
                *(
                    batcher.submit(b"\x01" * 32, b"m%d" % i, b"\x02" * 64)
                    for i in range(6)
                )
            )
            batcher.stop()
            await s.stop()
            return outs

        outs = asyncio.run(run())
        assert all(outs)
        assert sum(len(b) for b in stub.batches) == 6
        assert all(
            d["classes"] == ["consensus"] for d in s.dispatch_log
        )
    finally:
        set_default_scheduler(None)


def test_device_path_rounds_through_scheduler():
    """The port's verifier on its device path (plain kernel versions):
    a coalesced round of two submitters goes through prepare() on the
    prep thread and run() on the dispatch thread; verdicts equal the host
    oracle and the ledger books one round of both classes."""
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.obs.ledger import DispatchLedger

    v = BatchVerifier(min_device_batch=0, device="cpu",
                      shape_registry=ShapeRegistry())
    ledger = DispatchLedger()
    s = VerifyScheduler(
        verifier=v, metrics=SchedulerMetrics(Registry("test3")), ledger=ledger
    )
    keys = [host.PrivKey.from_secret(b"dev%d" % i) for i in range(6)]
    items = []
    for i, k in enumerate(keys):
        msg = b"precommit-%d" % i
        sig = k.sign(msg) if i != 4 else BAD
        items.append(SigItem(k.public_key().data, msg, sig))
    want = [host.verify(it.pubkey, it.msg, it.sig) for it in items]

    async def run():
        await s.start()
        loop = asyncio.get_running_loop()
        # hold the dispatch thread so both submissions land in one round
        gate = threading.Event()
        blocker = asyncio.create_task(
            s.submit_fn([0], lambda xs: gate.wait(5) and [True], "consensus")
        )
        await asyncio.sleep(0.01)
        a = loop.run_in_executor(None, s.submit_sync, items[:3], "consensus")
        b = loop.run_in_executor(None, s.submit_sync, items[3:], "blocksync")
        await asyncio.sleep(0.05)
        gate.set()
        out = await asyncio.gather(a, b, blocker)
        await s.stop()
        return out

    a, b, _ = asyncio.run(run())
    assert a.tolist() + b.tolist() == want
    sig_rounds = [e for e in ledger.entries() if e["engine"] == "sig"]
    assert len(sig_rounds) == 1
    assert sig_rounds[0]["rows"] == {"consensus": 3, "blocksync": 3}
    assert sig_rounds[0]["dispatched"] == 8
    assert v._registry.buckets_by_tier()["small"] == (8,)


def test_secp_recover_engine_matches_reference():
    """The ported secp_recover engine recovers the signer's Ethereum
    address on the host, as the reference engine does, for a valid, a
    malformed (bad recovery id, short) and an empty signature, through the
    scheduler's wire-engine lane; an unknown engine still runs the
    caller's fallback."""
    from tendermint_tpu.parallel.engines import BUILTIN_ENGINES as REF_ENGINES
    from tendermint_tpu_torch.crypto import secp256k1

    key = secp256k1.PrivKey.from_secret(b"sequencer")
    digest = hashlib.sha256(b"block-v2").digest()
    sig = secp256k1.eth_sign(digest, key.secret)
    items = [(digest, sig), (digest, sig[:64] + b"\x07"), (digest, sig[:40]),
             (digest, b"")]
    s = _sched()
    got = s.submit_wire_fn_sync("secp_recover", items)
    assert got == REF_ENGINES["secp_recover"](items)
    assert got[0] == secp256k1.eth_address(secp256k1.decompress_point(key.public_key().data))
    assert got[1:] == [b"", b"", b""]
    assert s.submit_wire_fn_sync("nope", [1], fallback=lambda: ["fb"]) == ["fb"]


def _bls_engine_items(engine: str, bls):
    """One valid and one malformed item for a BLS engine, built with the
    given package's bls_signatures (the same scalar and message)."""
    priv, msg = 0x5EED, b"engine-parity"
    key = bls._g2_mul_point(bls.c.G2_GEN, priv)
    sig = bls.g1_to_bytes(bls.sign(priv, msg))
    if engine == "bls_agg":
        pub = bls.public_key_to_bytes(bls.new_trusted_public_key(key))
        return [(pub, msg, sig), (pub[:-1] + b"\x00", msg, sig)]
    keys = bls.g2_to_bytes(key)
    return [(msg, sig, keys), (msg, sig, keys[:-1])]


@pytest.mark.parametrize("engine", ["bls_agg", "qc_verify"])
def test_bls_engines_match_reference(engine, monkeypatch):
    """The ported BLS engines return the reference engines' verdicts for a
    valid and a malformed item, through the scheduler's wire-engine lane
    (process verifier on the CPU: the plain versions of the kernels)."""
    from tendermint_tpu.crypto import bls_signatures as ref_bls
    from tendermint_tpu.parallel.engines import BUILTIN_ENGINES as REF_ENGINES
    from tendermint_tpu_torch.crypto import bls_signatures as bls

    monkeypatch.setattr(bv, "_default", BatchVerifier(device="cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of small tensor operations
    try:
        got = _sched().submit_wire_fn_sync(engine, _bls_engine_items(engine, bls))
    finally:
        torch.set_num_threads(threads)
    want = REF_ENGINES[engine](_bls_engine_items(engine, ref_bls))
    assert got == want == [True, False]


def test_bls_agg_malformed_signature_is_a_false_verdict(monkeypatch):
    """A malformed signature beside a valid key is a False verdict (the
    reference engine appends the key before the signature parses, and its
    lists then disagree in length)."""
    from tendermint_tpu_torch.crypto import bls_signatures as bls

    monkeypatch.setattr(bv, "_default", BatchVerifier(device="cpu"))
    good, _ = _bls_engine_items("bls_agg", bls)
    bad_sig = (good[0], good[1], b"\x11" * 96)
    assert _sched().submit_wire_fn_sync("bls_agg", [bad_sig]) == [False]
