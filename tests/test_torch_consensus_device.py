"""The live LastCommit path of the port's consensus core through the
verify scheduler to the small tier, on the CPU.

An 8-validator port net runs with a started ``VerifyScheduler`` as the
process default, over a ``device="cpu"`` verifier with
``min_device_batch=8``. Every proposal's LastCommit is checked in
``BlockExecutor.apply_block`` (``validate_block_off_loop`` ->
``default_dispatch("consensus")`` -> ``verify_commit_light``); the nodes'
checks coalesce into scheduler rounds, and rounds of 8 rows and up run
``verify_prehashed_table``'s plain version. Live single votes stay on the
host oracle. The JAX package's net, on the same seeds and clock, stays on
its host oracle (``min_device_batch`` above any round), so no JAX program
compiles.

Checks: the ledger's consensus-class device rounds (at least one per
height with a LastCommit), the small tier's calls, every stored
LastCommit's signatures against the host oracle ``crypto/ed25519.verify``,
and equal app hashes and header fields to the JAX package's net.
Tolerance: exact.
"""

from __future__ import annotations

import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
from tendermint_tpu_torch.obs.ledger import DispatchLedger
from tendermint_tpu_torch.ops import ed25519_batch
from tendermint_tpu_torch.parallel import scheduler as sched_mod

from .test_torch_consensus import (  # noqa: F401  (cpu_verifier: autouse)
    PORT,
    REF,
    assert_parity,
    cpu_verifier,
    make_validators,
    parity_net,
)

N_VALS, HEIGHTS = 8, 2


@pytest.fixture
def one_thread():
    """The plain small tier is many small tensor operations: one intra-op
    thread keeps it from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_eight_validator_lastcommit_rounds_reach_the_small_tier(monkeypatch, one_thread):
    verifier = PORT.bv.BatchVerifier(device="cpu", min_device_batch=8)
    monkeypatch.setattr(PORT.bv, "_default", verifier)
    ledger = DispatchLedger()
    sched = sched_mod.VerifyScheduler(verifier=verifier, ledger=ledger,
                                      metrics=SchedulerMetrics(Registry("net8")))
    small = []
    real = ed25519_batch.verify_prehashed_table
    monkeypatch.setattr(ed25519_batch, "verify_prehashed_table",
                        lambda *a: small.append(a[3].shape[0]) or real(*a))
    monkeypatch.setattr(sched_mod, "_default_scheduler", sched)
    # a generous wait: each height's rounds run the plain small tier
    port = parity_net(PORT, heights=HEIGHTS, n=N_VALS, scheduler=sched, timeout=300)
    monkeypatch.setattr(sched_mod, "_default_scheduler", None)

    rounds = [e for e in ledger.entries()
              if e["engine"] == "sig" and e["requested"] >= 8]
    assert all(set(e["rows"]) == {"consensus"} for e in rounds), rounds
    # heights 2..HEIGHTS+1 each check a LastCommit (the net ran to H+1)
    assert len(rounds) >= HEIGHTS, ledger.entries()
    assert len(small) >= len(rounds)
    assert all(b in (8, 32, 128, 512) for b in small), small

    assert port[0]["block"].last_commit is None  # height 1
    vs, _ = make_validators(PORT, N_VALS, seed=b"parity")  # parity_net's set
    pubs = {v.address: v.pub_key.data for v in vs.validators}
    for row in port[1:]:
        blk = row["block"]
        commit = blk.last_commit
        signed = [i for i, cs in enumerate(commit.signatures) if not cs.is_absent()]
        assert 3 * len(signed) > 2 * N_VALS
        for i in signed:
            cs = commit.signatures[i]
            assert host.verify(pubs[cs.validator_address],
                               commit.vote_sign_bytes(blk.header.chain_id, i),
                               cs.signature), (blk.header.height, i)

    ref_verifier = REF.bv.BatchVerifier(min_device_batch=1 << 30)
    monkeypatch.setattr(REF.bv, "_default", ref_verifier)
    assert_parity(port, parity_net(REF, heights=HEIGHTS, n=N_VALS))
