"""ValidatorSet.verify_commit* of the port against the JAX package's.

The same validators sign the same precommits; both packages build their
own Commit from the same bytes and must agree on accept/reject and on the
error message. The port verifies on its BatchVerifier (device="cpu":
the kernels' plain versions, device path forced); the reference on its
host path, which gives the same verdicts without a JAX compile.
Tolerance: exact (verdicts and messages).
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import ed25519 as jhost
from tendermint_tpu.crypto.batch_verifier import BatchVerifier as JaxVerifier
from tendermint_tpu import types as jtypes
from tendermint_tpu_torch import types as ttypes
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.crypto.batch_verifier import BatchVerifier
from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry

CHAIN = "torch-parity"
N = 10


def _build(mod, keymod, seeds, powers, height, bid_seed, flags, ts0, sigs=None):
    """(valset, block_id, commit) in package `mod`; signs when sigs is None."""
    vset = mod.ValidatorSet(
        [mod.Validator(keymod.PrivKey(s).public_key(), p) for s, p in zip(seeds, powers)]
    )
    bid = mod.BlockID(
        hash=bytes(bid_seed * 32)[:32],
        part_set_header=mod.PartSetHeader(total=1, hash=bytes(reversed(bid_seed * 32))[:32]),
    )
    by_addr = {keymod.PrivKey(s).public_key().address(): s for s in seeds}
    cs = []
    for i, v in enumerate(vset.validators):
        if flags[i] == "absent":
            cs.append(mod.CommitSig.absent())
            continue
        flag = mod.BlockIDFlag.COMMIT if flags[i] == "commit" else mod.BlockIDFlag.NIL
        cs.append(mod.CommitSig(flag, v.address, ts0 + i))
    commit = mod.Commit(height, 0, bid, cs)
    made = []
    for i, v in enumerate(vset.validators):
        if cs[i].is_absent():
            made.append(b"")
            continue
        cs[i].signature = (
            sigs[i] if sigs is not None
            else keymod.PrivKey(by_addr[v.address]).sign(commit.vote_sign_bytes(CHAIN, i))
        )
        made.append(cs[i].signature)
    return vset, bid, commit, made


def _pair(height=5, flags=None, tamper=(), bid_seed=b"blk"):
    rng = np.random.default_rng(height)
    seeds = [rng.bytes(32) for _ in range(N)]
    powers = [int(p) for p in rng.integers(1, 50, N)]
    flags = flags or ["commit"] * N
    port = _build(ttypes, host, seeds, powers, height, bid_seed, flags, 1_700_000_000)
    sigs = list(port[3])
    for i in tamper:
        sigs[i] = sigs[i][:5] + bytes([sigs[i][5] ^ 1]) + sigs[i][6:]
        port[2].signatures[i].signature = sigs[i]
    ref = _build(jtypes, jhost, seeds, powers, height, bid_seed, flags, 1_700_000_000, sigs)
    assert ref[2].vote_sign_bytes(CHAIN, 0) == port[2].vote_sign_bytes(CHAIN, 0)
    return port, ref


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "ok"


def _verifiers():
    return (
        BatchVerifier(device="cpu", min_device_batch=0, shape_registry=ShapeRegistry()),
        JaxVerifier(min_device_batch=100),
    )


@pytest.mark.parametrize(
    "case",
    ["valid", "nil_and_absent", "tampered", "tampered_nil", "insufficient",
     "wrong_height", "wrong_block"],
)
def test_verify_commit_matches_reference(case):
    flags, tamper, height = None, (), 5
    if case == "nil_and_absent":
        flags = ["commit"] * 7 + ["nil", "absent", "nil"]
    elif case == "tampered":
        tamper = (3,)
    elif case == "tampered_nil":
        flags, tamper = ["commit"] * 8 + ["nil", "nil"], (9,)
    elif case == "insufficient":
        flags = ["commit"] * 3 + ["nil"] * 7
    (tv, tbid, tcommit, _), (jv, jbid, jcommit, _) = _pair(height, flags, tamper)
    vbid_t, vbid_j, vh = tbid, jbid, height
    if case == "wrong_height":
        vh = height + 1
    if case == "wrong_block":
        vbid_t = ttypes.BlockID(hash=bytes(32))
        vbid_j = jtypes.BlockID(hash=bytes(32))
    port_v, ref_v = _verifiers()
    for name in ("verify_commit", "verify_commit_light"):
        got = _outcome(lambda: getattr(tv, name)(CHAIN, vbid_t, vh, tcommit, verifier=port_v))
        want = _outcome(lambda: getattr(jv, name)(CHAIN, vbid_j, vh, jcommit, verifier=ref_v))
        assert got == want, (name, case)
    got = _outcome(lambda: tv.verify_commit_light_trusting(CHAIN, tcommit, verifier=port_v))
    want = _outcome(lambda: jv.verify_commit_light_trusting(CHAIN, jcommit, verifier=ref_v))
    assert got == want
    if case == "tampered":
        assert _outcome(
            lambda: tv.verify_commit(CHAIN, tbid, height, tcommit, verifier=port_v)
        ) == "ValueError: wrong signature at index 3"
    # the port's verdicts came from its device path, not the host fallback
    if case not in ("wrong_height", "wrong_block"):
        assert port_v._registry.dispatch_count() > 0


def test_valset_hash_and_encoding_match_reference():
    (tv, *_), (jv, *_) = _pair()
    assert tv.hash() == jv.hash()
    assert tv.encode() == jv.encode()
    assert tv.get_proposer().address == jv.get_proposer().address


def test_verify_commits_light_window_through_scheduler():
    """A blocksync window of 8 commits x 4 validators (32 rows, bigtable_min
    8: the big tier) verified as one batch, as blocksync's reactor does:
    from an executor thread through a started port VerifyScheduler and
    default_dispatch("blocksync"). Commit 5 has tampered signatures of
    validators holding more than 1/3 of the power (False); commit 7 one
    bad signature of the lightest validator (still True)."""
    import asyncio

    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import (
        VerifyScheduler, default_dispatch, set_default_scheduler,
    )

    rng = np.random.default_rng(64)
    seeds = [rng.bytes(32) for _ in range(4)]
    powers = [10, 20, 30, 40]
    port_entries, ref_entries = [], []
    for h in range(1, 9):
        bid_seed = b"w%d" % h
        tv, tbid, tcommit, sigs = _build(
            ttypes, host, seeds, powers, h, bid_seed, ["commit"] * 4, 1_700_000_000
        )
        pw = [v.voting_power for v in tv.validators]
        tamper = {5: (40, 30), 7: (10,)}.get(h, ())
        for i in (pw.index(p) for p in tamper):
            sigs[i] = sigs[i][:5] + bytes([sigs[i][5] ^ 1]) + sigs[i][6:]
            tcommit.signatures[i].signature = sigs[i]
        jv, jbid, jcommit, _ = _build(
            jtypes, jhost, seeds, powers, h, bid_seed, ["commit"] * 4,
            1_700_000_000, sigs,
        )
        port_entries.append((tbid, h, tcommit))
        ref_entries.append((jbid, h, jcommit))
    want = jv.verify_commits_light(CHAIN, ref_entries, verifier=JaxVerifier(min_device_batch=100))
    assert want == [True] * 4 + [False] + [True] * 3

    port_v = BatchVerifier(device="cpu", min_device_batch=0, bigtable_min=8,
                           shape_registry=ShapeRegistry())
    ledger = DispatchLedger()
    sched = VerifyScheduler(
        verifier=port_v, metrics=SchedulerMetrics(Registry("window")), ledger=ledger
    )
    set_default_scheduler(sched)
    try:
        async def run():
            await sched.start()
            verdicts = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: tv.verify_commits_light(
                    CHAIN, port_entries, verifier=default_dispatch("blocksync")
                ),
            )
            await sched.stop()
            return verdicts

        got = asyncio.run(run())
    finally:
        set_default_scheduler(None)
    assert got == want
    rounds = [e for e in ledger.entries() if e["engine"] == "sig"]
    assert [(e["rows"], e["dispatched"]) for e in rounds] == [({"blocksync": 32}, 32)]
    assert port_v._registry.buckets_by_tier() == {"build_big": (8,), "big": (32,)}
