"""The port's blocksync reactor on a quorum-certificate chain: a fresh
node with ``qc_enabled`` blocksyncs a QC chain over encrypted p2p through
``BlocksyncReactor``, so its windows take the reactor's QC branch (one
``qc_verify`` round a window, ``blocksync/reactor.py``'s ``use_qc`` path).

- Every applied block is proven by its successor's aggregate:
  ``qc_verified_blocks`` equals the synced heights.
- The synced app hashes equal the JAX package's on the same seeded QC
  chain (each package's own single-validator chain).
- A window whose aggregate does not verify (its last QC's signature replaced by
  a valid G1 point over another message, as a relay or a proposer a
  mixed-mode committee did not check might ship it) falls back to the full
  commits: its blocks still apply, none of them counted as QC-verified.

The source chains run each package's consensus core on the CPU (the
port's process verifier on ``device="cpu"``); BLS takes the native route.
Tolerance: exact (app hashes, counts).
"""

from __future__ import annotations

import asyncio
import time

import pytest

from tendermint_tpu_torch.blocksync.reactor import BlocksyncReactor
from tendermint_tpu_torch.crypto import bls_signatures as bls
from tendermint_tpu_torch.types.quorum_cert import QuorumCertificate
from tendermint_tpu_torch.types.validator_set import ValidatorSet

from .test_torch_blocksync import build_switch
from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    PORT,
    REF,
    cpu_verifier,
    make_genesis,
    make_node,
    make_qc_validators,
    run_to,
)

HEIGHTS = 8  # the source chain; a client applies heights 1..HEIGHTS-1


def _qc_node(ns, vs, pv, genesis, privs, **kw):
    cfg = ns.ConsensusConfig.test_config()
    cfg.quorum_certificates = True
    node = make_node(ns, vs, pv, genesis, config=cfg,
                     bls_signer=ns.bls.signer_for(privs[pv.get_pub_key().address()]), **kw)
    node[0].executor.qc_enabled = True
    return node


def _source(ns):
    """A single-validator QC chain of package `ns` to HEIGHTS: the set,
    privval, BLS scalars, genesis and block store."""
    vs, pvs, privs = make_qc_validators(ns, 1, seed=b"qc-sync")
    genesis = make_genesis(ns, vs)
    cs, _app, _l2, bs, _ss = _qc_node(ns, vs, pvs[0], genesis, privs)
    asyncio.run(run_to([cs], HEIGHTS, timeout=60))
    return vs, pvs, privs, genesis, bs


async def _sync(src, timeout=60.0):
    """A server over the source store (inactive pool) and a fresh QC
    client syncing from genesis over p2p; returns the client's reactor
    and block store once it applied heights 1..HEIGHTS-1."""
    vs, pvs, privs, genesis, src_bs = src
    srv_cs, _, srv_l2, _, _ = _qc_node(PORT, vs, pvs[0], genesis, privs)
    server_r = BlocksyncReactor(srv_cs.state, srv_cs.executor, src_bs, srv_l2,
                                active=False, qc_enabled=True)
    snk, st, ssw = build_switch(PORT, {"blocksync": server_r})
    cli_cs, _, cli_l2, cli_bs, _ = _qc_node(PORT, vs, pvs[0], genesis, privs)
    client_r = BlocksyncReactor(cli_cs.state, cli_cs.executor, cli_bs, cli_l2,
                                active=False, qc_enabled=True)
    cnk, ct, csw = build_switch(PORT, {"blocksync": client_r})
    for t, sw in ((st, ssw), (ct, csw)):
        await t.listen()
        await sw.start()
    from tendermint_tpu_torch.p2p.transport import NetAddress

    await csw.dial_peer(NetAddress(snk.id, "127.0.0.1", st.listen_port))
    await asyncio.sleep(0.2)
    client_r.start_sync()
    deadline = time.monotonic() + timeout
    while client_r.blocks_applied < HEIGHTS - 1 and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
    for sw in (ssw, csw):
        await sw.stop()
    return client_r, cli_bs


@pytest.fixture(scope="module")
def chains():
    """The port's source chain and the JAX package's, on the same seeds."""
    from tendermint_tpu.parallel import scheduler as ref_sched
    from tendermint_tpu_torch.parallel import scheduler

    port_v = PORT.bv.BatchVerifier(device="cpu")
    ref_v = REF.bv.BatchVerifier(min_device_batch=1 << 30)
    saved = (PORT.bv._default, REF.bv._default, scheduler._default_scheduler,
             ref_sched._default_scheduler)
    PORT.bv._default, REF.bv._default = port_v, ref_v
    scheduler._default_scheduler = ref_sched._default_scheduler = None
    try:
        return _source(PORT), _source(REF)
    finally:
        (PORT.bv._default, REF.bv._default, scheduler._default_scheduler,
         ref_sched._default_scheduler) = saved


def _count_qc_rounds(monkeypatch, tamper: bool):
    """Record every verify_commits_qc and verify_commits_light call's
    heights; with `tamper`, the first QC round of a window (more than one
    entry) gets its last aggregate replaced by a valid G1 point over
    another message."""
    real_qc, real_light = ValidatorSet.verify_commits_qc, ValidatorSet.verify_commits_light
    seen = {"qc": [], "tampered": None, "light": []}

    def qc_round(self, chain_id, entries, engine=None):
        entries = list(entries)
        heights = [h for _, h, _ in entries]
        seen["qc"].append(heights)
        if tamper and len(entries) > 1 and seen["tampered"] is None:
            fid, h, qc = entries[-1]
            bad = QuorumCertificate.decode(qc.encode())
            bad.agg_signature = bls.g1_to_bytes(bls.sign(13, b"another message"))
            entries[-1] = (fid, h, bad)
            seen["tampered"] = heights
        return real_qc(self, chain_id, entries, engine=engine)

    def light_window(self, chain_id, entries, verifier=None):
        seen["light"].append([h for _, h, _ in entries])
        return real_light(self, chain_id, entries, verifier=verifier)

    monkeypatch.setattr(ValidatorSet, "verify_commits_qc", qc_round)
    monkeypatch.setattr(ValidatorSet, "verify_commits_light", light_window)
    return seen


def test_qc_chain_blocksyncs_over_p2p_through_the_reactor(chains, monkeypatch):
    """Every synced block is proven by an aggregate, a window of them in
    one qc_verify round, and the synced app hashes are the JAX package's."""
    port_src, ref_src = chains
    seen = _count_qc_rounds(monkeypatch, tamper=False)
    client_r, cli_bs = asyncio.run(_sync(port_src))
    synced = HEIGHTS - 1
    assert client_r.blocks_applied == synced
    assert client_r.qc_verified_blocks == synced
    assert any(len(hs) > 1 for hs in seen["qc"]), seen  # the window branch
    assert not seen["light"], seen  # no window fell back
    ref_bs = ref_src[4]
    for h in range(1, synced + 1):
        assert cli_bs.load_block(h).last_qc is not None or h == 1
        assert cli_bs.load_block(h).header.app_hash == ref_bs.load_block(h).header.app_hash
    assert client_r.state.app_hash == ref_bs.load_block(synced + 1).header.app_hash


def test_window_with_a_bad_aggregate_falls_back_to_the_full_commits(chains, monkeypatch):
    """The first window's qc_verify round, its last aggregate replaced by
    a valid point over another message, fails; the reactor re-judges that
    window on the full commits and applies it, and every other block is
    still proven by its aggregate."""
    port_src, _ = chains
    seen = _count_qc_rounds(monkeypatch, tamper=True)
    client_r, cli_bs = asyncio.run(_sync(port_src))
    synced = HEIGHTS - 1
    window = seen["tampered"]
    assert window is not None, seen
    assert seen["light"] == [window], seen  # re-judged on the full commits
    assert client_r.blocks_applied == synced
    assert client_r.qc_verified_blocks == synced - len(window)
    assert cli_bs.height == synced
