"""qc_catchup bench harness — N-sig commit verify vs one QC pairing.

In-proc committee sweep (the acceptance shape for ROADMAP item 3): for
each committee size, build a real chain segment — every commit carries n
genuine ed25519 precommit signatures AND n genuine BLS QC dual-signs,
aggregated into a QuorumCertificate — then verify the same window both
ways through one running VerifyScheduler:

- **baseline** (the current blocksync path): `verify_commits_light`, one
  coalesced sig-plane round of n x blocks ed25519 rows — device cost
  linear in committee size;
- **qc**: `verify_commits_qc` through the `qc_verify` engine, the whole
  window as ONE random-linear-combination multi-pairing — cost per
  block ~flat in committee size (2 pairings + one G2 MSM per block).

The ledger brackets each phase so the artifact's device_cost block
carries honest per-engine rows (sig vs qc_verify), and the light-proof
compression ratio (full CommitSigs vs qc + bitset) is measured on the
same chain.
"""

from __future__ import annotations

import asyncio
import hashlib
import time


def _build_committee(n: int, seed: bytes = b"qcbench"):
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto.bls12_381 import R
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    keys, vals, bls_privs = [], [], {}
    for i in range(n):
        priv = ed25519.PrivKey.from_secret(seed + b"%d" % i)
        scalar = (
            int.from_bytes(
                hashlib.sha256(seed + b"bls%d" % i).digest(), "big"
            )
            % (R - 1)
            + 1
        )
        pub = bls.pubkey_from_priv(scalar)
        addr = priv.public_key().address()
        bls_privs[addr] = scalar
        keys.append(priv)
        vals.append(
            Validator(
                priv.public_key(), 10,
                bls_pub_key=bls.g2_to_bytes(pub.key),
            )
        )
    vs = ValidatorSet(vals)
    by_addr = {k.public_key().address(): k for k in keys}
    ordered = [by_addr[v.address] for v in vs.validators]
    return vs, ordered, bls_privs


def _build_chain(vs, keys, bls_privs, blocks: int, chain_id: str):
    """[(block_id, height, commit, qc, light_full, light_qc)] — a
    synthetic header chain whose commits carry real dual signatures."""
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.light.types import LightBlock
    from tendermint_tpu_torch.types.block import Data, Header
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.quorum_cert import assemble_qc, qc_sign_bytes
    from tendermint_tpu_torch.types.vote import Vote, VoteType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    t0 = 1_700_000_000_000_000_000
    out = []
    prev = BlockID()
    for h in range(1, blocks + 1):
        header = Header(
            chain_id=chain_id,
            height=h,
            time_ns=t0 + h * 10**9,
            last_block_id=prev,
            validators_hash=vs.hash(),
            next_validators_hash=vs.hash(),
            data_hash=Data().hash(),
        )
        bid = BlockID(header.hash(), PartSetHeader(1, bytes([h % 251]) * 32))
        votes = VoteSet(chain_id, h, 0, VoteType.PRECOMMIT, vs)
        qc_msg = qc_sign_bytes(chain_id, h, 0, bid)
        for i, key in enumerate(keys):
            v = Vote(
                type=VoteType.PRECOMMIT,
                height=h,
                round=0,
                block_id=bid,
                timestamp_ns=t0 + h * 10**9 + i,
                validator_address=key.public_key().address(),
                validator_index=i,
            )
            v.signature = key.sign(v.sign_bytes(chain_id))
            v.qc_signature = bls.g1_to_bytes(
                bls.sign(bls_privs[v.validator_address], qc_msg)
            )
            votes.add_vote(v, verified=True)
        commit = votes.make_commit()
        qc = assemble_qc(chain_id, commit, vs)
        assert qc is not None, "bench chain failed to aggregate a QC"
        out.append(
            (
                bid,
                h,
                commit,
                qc,
                LightBlock(header, commit, vs),
                LightBlock(header, None, vs, qc=qc),
            )
        )
        prev = bid
    return out


def _best_wall(fn, iters: int = 3) -> float:
    best = float("inf")
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def run_qc_catchup(
    sizes=(4, 32, 100), blocks: int = 8, chain_id: str = "qc-bench",
    device: str = "cuda",
) -> dict:
    """Per-size rows + the flatness/compression claims. Runs every
    verify through one VerifyScheduler (worker-thread submits, so both
    planes coalesce exactly like blocksync's executor path does). The
    process verifier the scheduler runs is built on `device`."""
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.obs.ledger import default_ledger
    from tendermint_tpu_torch.parallel.scheduler import VerifyScheduler

    default_verifier(device)
    rows = []
    for n in sizes:
        vs, keys, bls_privs = _build_committee(n)
        chain = _build_chain(vs, keys, bls_privs, blocks, chain_id)
        sig_entries = [(bid, h, commit) for bid, h, commit, *_ in chain]
        qc_entries = [(bid, h, qc) for bid, h, _c, qc, *_ in chain]

        sched = VerifyScheduler()
        ledger = default_ledger()

        async def measure():
            await sched.start()
            loop = asyncio.get_running_loop()
            from tendermint_tpu_torch.types.quorum_cert import qc_dispatch

            sig_verifier = sched.classed("blocksync")

            def baseline():
                verdicts = vs.verify_commits_light(
                    chain_id, sig_entries, verifier=sig_verifier
                )
                assert all(verdicts), "baseline window failed"

            engine = None

            def qc_path():
                verdicts = vs.verify_commits_qc(
                    chain_id, qc_entries, engine=engine
                )
                assert all(verdicts), "qc window failed"

            # warm both paths (compiles/tables), then bracket marks
            await loop.run_in_executor(None, baseline)
            base_mark = ledger.mark()
            base_wall = await loop.run_in_executor(
                None, _best_wall, baseline
            )
            base_cost = ledger.summary(since=base_mark)

            def scheduled_engine(items):
                return sched.submit_wire_fn_sync(
                    "qc_verify", items, "blocksync"
                )

            engine = scheduled_engine
            await loop.run_in_executor(None, qc_path)
            qc_mark = ledger.mark()
            qc_wall = await loop.run_in_executor(None, _best_wall, qc_path)
            qc_cost = ledger.summary(since=qc_mark)
            await sched.stop()
            return base_wall, base_cost, qc_wall, qc_cost

        base_wall, base_cost, qc_wall, qc_cost = asyncio.run(measure())
        full_bytes = chain[0][4].proof_bytes()
        qc_bytes = chain[0][5].proof_bytes()
        base_dev = sum(
            e.get("device_seconds", 0.0)
            for k, e in base_cost.get("per_engine", {}).items()
            if k == "sig"
        )
        qc_dev = qc_cost.get("per_engine", {}).get("qc_verify", {}).get(
            "device_seconds", 0.0
        )
        rows.append(
            {
                "validators": n,
                "blocks": blocks,
                "baseline_wall_s": round(base_wall, 6),
                "baseline_wall_per_block_ms": round(
                    base_wall / blocks * 1e3, 3
                ),
                "baseline_device_s": round(base_dev, 6),
                "qc_wall_s": round(qc_wall, 6),
                "qc_wall_per_block_ms": round(qc_wall / blocks * 1e3, 3),
                "qc_device_s": round(qc_dev, 6),
                "qc_commits_per_s": round(blocks / qc_wall, 1),
                "baseline_commits_per_s": round(blocks / base_wall, 1),
                "proof_bytes_full": full_bytes,
                "proof_bytes_qc": qc_bytes,
                "proof_compression": round(full_bytes / qc_bytes, 1),
                "qc_rounds": qc_cost.get("per_engine", {})
                .get("qc_verify", {})
                .get("rounds", 0),
            }
        )
    by_n = {r["validators"]: r for r in rows}
    lo, hi = min(sizes), max(sizes)
    return {
        "sizes": list(sizes),
        "rows": rows,
        # the flatness claim: per-block qc verify cost from the
        # smallest to the largest committee
        "qc_flatness": round(
            by_n[hi]["qc_wall_per_block_ms"]
            / max(by_n[lo]["qc_wall_per_block_ms"], 1e-9),
            2,
        ),
        "baseline_growth": round(
            by_n[hi]["baseline_wall_per_block_ms"]
            / max(by_n[lo]["baseline_wall_per_block_ms"], 1e-9),
            2,
        ),
        "proof_compression_at_max": by_n[hi]["proof_compression"],
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description="QC catch-up: N-sig commits vs one QC pairing")
    ap.add_argument("--device", default="cuda",
                    help="device the verifier runs on: cuda (default) or cpu")
    print(json.dumps(run_qc_catchup(device=ap.parse_args().device), indent=2))
