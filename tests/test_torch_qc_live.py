"""The port's live quorum-certificate chains against the contract of
``tests/test_qc.py``'s in-process chains:

- a QC-enabled single-validator chain ships and stores a QC for every
  block past the first (``test_live_chain_produces_and_stores_qcs``);
- a legacy consumer (quorum certificates off) follows that chain on the
  N-signature path and a QC consumer on the aggregates
  (``test_mixed_mode_interop_legacy_and_qc_consumers``). The JAX package
  drives a blocksync reactor's pool, which the port does not have yet;
  here each consumer verifies block h by block h+1's proof through the
  ``verify_commits_light`` / ``verify_commits_qc`` window calls, as that
  reactor does, and applies it with its own ``BlockExecutor``;
- a BLS key riding an L2 validator update flips the set QC-capable and the
  rotated member lands in the next QC's bitset
  (``test_l2_rotation_carries_bls_key_into_next_qc_bitset``).

Parity: a QC-mode 4-validator net of each package on the same seeds and
clock gives equal app hashes and header fields at heights 1-3. The port's
process verifier is on ``device="cpu"``; BLS takes the native route in
both packages. Tolerance: exact.
"""

from __future__ import annotations

import asyncio

from tendermint_tpu_torch.crypto import bls_signatures as bls
from tendermint_tpu_torch.types.block_id import BlockID

from .test_torch_consensus import (  # noqa: F401  (cpu_verifier: autouse)
    CHAIN_ID,
    PORT,
    REF,
    assert_parity,
    cpu_verifier,
    make_genesis,
    make_node,
    make_qc_validators,
    parity_net,
    run_to,
    wire_net,
)


def _qc_node(vs, pv, genesis, privs, qc=True, **kw):
    cfg = PORT.ConsensusConfig.test_config()
    cfg.quorum_certificates = qc
    node = make_node(PORT, vs, pv, genesis, config=cfg,
                     bls_signer=bls.signer_for(privs[pv.get_pub_key().address()]), **kw)
    node[0].executor.qc_enabled = qc
    return node


def test_live_chain_produces_and_stores_qcs():
    vs, pvs, privs = make_qc_validators(PORT, 1, seed=b"live1")
    genesis = make_genesis(PORT, vs)
    cs, app, l2, bs, ss = _qc_node(vs, pvs[0], genesis, privs)
    asyncio.run(run_to([cs], 4, timeout=30))
    for h in range(2, 4):
        blk = bs.load_block(h + 1)
        assert blk.last_qc is not None and blk.last_qc.height == h
        stored = bs.load_block_qc(h)
        assert stored is not None and stored.encode() == blk.last_qc.encode()
        vs.verify_commit_qc(CHAIN_ID, blk.last_qc.block_id, h, blk.last_qc)


def _consume(vs, pvs, privs, genesis, src_bs, n_heights, qc_enabled):
    """Verify blocks 1..n_heights-1 by their successors' proofs in one
    window (QCs when enabled and every proof carries one, else the full
    commits), then apply them in order. Returns (applied, qc_verified)."""
    cs, app, l2, bs, ss = _qc_node(vs, pvs[0], genesis, privs, qc=qc_enabled)
    blocks = [src_bs.load_block(h) for h in range(1, n_heights + 1)]
    window = []
    for first, second in zip(blocks, blocks[1:]):
        fid = BlockID(first.hash(), first.make_part_set().header)
        window.append((first, fid, second.last_commit, second.last_qc))
    if qc_enabled and all(qc is not None for *_, qc in window):
        verdicts = vs.verify_commits_qc(
            CHAIN_ID, [(fid, f.header.height, qc) for f, fid, _, qc in window])
        qc_verified = sum(verdicts)
    else:
        verdicts = vs.verify_commits_light(
            CHAIN_ID, [(fid, f.header.height, c) for f, fid, c, _ in window])
        qc_verified = 0
    assert all(verdicts), verdicts

    async def apply():
        state = cs.state
        for first, fid, commit, _ in window:
            bs.save_block(first, first.make_part_set(), commit)
            state = await cs.executor.apply_block(state, fid, first,
                                                  verify_klass="blocksync")
        return state

    state = asyncio.run(apply())
    assert state.last_block_height == len(window)
    return len(window), qc_verified


def test_mixed_mode_interop_legacy_and_qc_consumers():
    vs, pvs, privs = make_qc_validators(PORT, 1, seed=b"mixed")
    genesis = make_genesis(PORT, vs)
    heights = 6
    cs, app, l2, src_bs, ss = _qc_node(vs, pvs[0], genesis, privs)
    asyncio.run(run_to([cs], heights, timeout=40))
    assert src_bs.load_block(heights).last_qc is not None

    applied, qc_verified = _consume(vs, pvs, privs, genesis, src_bs, heights - 1, False)
    assert (applied, qc_verified) == (heights - 2, 0)
    applied, qc_verified = _consume(vs, pvs, privs, genesis, src_bs, heights - 1, True)
    assert applied == heights - 2 and qc_verified >= heights - 2


def test_l2_rotation_carries_bls_key_into_next_qc_bitset():
    """A validator without a BLS key at genesis gets one through an L2
    update at height 3: no QC before the set turns capable (height 5),
    then a QC whose bitset holds the rotated member and verifies."""
    vs, pvs, privs = make_qc_validators(PORT, 4, seed=b"rotate")
    bare = vs.validators[2]
    key_backfill = bare.bls_pub_key
    bare.bls_pub_key = b""
    genesis = make_genesis(PORT, vs)
    rotate_h, last_h = 3, 9
    capable_h = rotate_h + 2
    nodes = []
    for pv in pvs:
        l2 = PORT.MockL2Node()
        l2.validator_updates[rotate_h] = [
            ("ed25519", bare.pub_key.data, bare.voting_power, key_backfill)]
        nodes.append(_qc_node(vs, pv, genesis, privs, l2=l2))
    css = [n[0] for n in nodes]
    wire_net(css)
    asyncio.run(run_to(css, last_h, timeout=60))
    bs, ss = nodes[0][3], nodes[0][4]
    for h in range(2, capable_h):
        assert bs.load_block(h + 1).last_qc is None, f"height {h} got a QC pre-rotation"
    carried = [bs.load_block(h + 1).last_qc for h in range(capable_h, last_h - 1)
               if bs.load_block(h + 1) and bs.load_block(h + 1).last_qc]
    assert carried, "no QC produced after the rotation landed"
    qc = carried[0]
    set_at = ss.load_validators(qc.height)
    assert set_at is not None and set_at.qc_capable()
    assert set_at.validators[2].bls_pub_key == key_backfill
    assert qc.signers.get(2), "rotated-keyed validator missing from the QC bitset"
    set_at.verify_commit_qc(CHAIN_ID, qc.block_id, qc.height, qc)


def test_qc_net_matches_reference():
    """QC mode: equal app hashes and header fields at heights 1-3, and
    every port block past the second carries a verifying QC."""
    port = parity_net(PORT, qc=True)
    assert_parity(port, parity_net(REF, qc=True))
    for row in port[1:]:
        blk = row["block"]
        assert blk.last_qc is not None
        assert blk.last_qc.height == blk.header.height - 1
