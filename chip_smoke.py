#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N] [--validators N] [--heights N]

Phases (any failure raises and the exit code is non-zero):

1. Build the ed25519, SHA-512, BLS12-381, secp256k1 and SHA-256 kernels from
   ``tendermint_tpu_torch/ops/csrc`` into ``tendermint_tpu_torch/_kbuild/``
   (a ``-Xptxas -v`` report of registers and spills per kernel runs beside
   the build), print the build seconds and the card's ``nvidia-smi`` name
   and power limit.
2. Hold each ed25519/SHA-512 kernel against its plain PyTorch version on
   the card, on the same inputs, with exact equality (bytes and bitmaps are
   integers): ``neg_pubkey_table`` and ``neg_pubkey_bigtable`` on 256 keys
   (valid plus adversarial: small order, non-canonical y, no square root,
   x = 0 with the sign bit), ``verify_prehashed_table`` and
   ``verify_prehashed`` on 256 mixed valid/invalid rows,
   ``verify_prehashed_bigcache`` and ``_mxu`` on 2048 such rows (each also
   held against the host oracle), ``challenge_batch`` on 2048 ragged rows
   (and against hashlib + % L), the reduction kernel alone on adversarial
   digests, ``dbl_chain`` on 8192 points x 256 doublings (bytes and affine
   coordinates, row 0 against 256 host ``point_double``). The four-lane
   ``verify_prehashed_table`` also at its small-tier shapes
   (``KERNEL3_SIZES``: b = 1, 23, 150 and 256, the last the commit path's
   150 rows padded to its bucket), with ``idx = -1``, ``idx`` past the
   store and padding rows inside warps of live rows, against its plain
   version and the host oracle.
3. Drive the main paths through their entry points, each with the launch
   counts zeroed just before and read just after:
   - commit verification: a seeded 150-validator ``ValidatorSet``
     verifies 5 heights of precommits through ``default_verifier()`` on
     CUDA, rejects a tampered signature with the reference's
     ``wrong signature at index i``, and a ``BatchVerifier`` whose table
     cache holds 64 keys verifies one 150-row round on the generic kernel,
     held against the host oracle;
   - the doubling chain: ``dbl_chain`` at the Pallas microbenchmark's
     workload (8192 points, 256 doublings);
   - bulk commit verification, as blocksync catches up: 64 commits of the
     150-validator set (9600 signatures, bucket 16384: the big tier), one
     with the signatures of validators holding more than 1/3 of the power
     tampered, verified by ``ValidatorSet.verify_commits_light`` from an
     executor thread through a started ``VerifyScheduler`` and
     ``default_dispatch("blocksync")``: twice with challenges hashed on
     the host (the first window builds the big tables), twice with
     challenges hashed on the card (``device_challenge_min=2048``), once
     under ``TM_TPU_MXU_GATHER=1``. Each run's verdicts, the per-row bitmap
     of the window (also a seeded sample against the host oracle) and the
     scheduler's ledger round are checked.
4. Time each kernel (median of 20 launches, CUDA events) and its plain
   version (median of 3) at the main paths' shapes, ``verify_commit`` per
   height (beside its figure with the one-thread kernel 3), and the bulk
   window's wall time with its host and device shares; work out each
   kernel's bound. Kernel 3 also at the buckets 8, 32, 128 and 256 (the
   ``kernel3:`` line, with its critical path and ``ptxas`` usage).
5. The quorum-certificate path (``qc_phase``): ``g1_aggregate`` and
   ``g2_aggregate`` on 256 points with duplicates, opposites and the
   identity and at the device route's shapes (150 signatures; 150 keys),
   ``miller`` and ``final_exp`` on the 2-pair
   verify shape and a 65-pair random-linear-combination shape, each
   against its plain version on the card and the host oracle, and bilinearity of
   ``pairing_value``; then BLS keys for the 150 validators (4 through
   ``pubkey_from_priv``, whose proof of possession is a native pairing; the
   rest trusted keys, as set-up), QC shares on the bulk window's 64
   commits, then both BLS routes of the JAX package's order, each with
   the launch counts read: the native route (``TM_TPU_BLS_PAIRING_DEVICE``
   unset: native pairing and MSM, no BLS kernel may launch) and the device
   route (the gate set: every pairing check on the card, and each QC's
   signature sum and signer-key sum again through
   ``aggregate_signatures_device`` / ``aggregate_public_keys_device``,
   equal to the native sums). On each route ``assemble_qc`` for each
   commit (the two routes' certificates equal), QC 40 replaced by a
   sub-quorum aggregate under the full bitset, and
   ``ValidatorSet.verify_commits_qc`` over the window from an executor
   thread through a started ``VerifyScheduler``'s ``qc_verify`` lane,
   twice: verdicts ``[True]*39 + [False] + [True]*24``, one ledger round
   each. Timings: each BLS kernel (median of 20) and its plain version
   (one call, the comparison at the device route's shape),
   ``check_pairs`` on the card against the native host library's
   ``pairing_check`` on the same pairs, each route's assembly per QC and
   its window walls split into signature and key parse, hash-to-G1,
   scalar multiplications and pairing checks.
6. The mixed-key path and the L2 block's merkle leaves (``mixed_phase``):
   ``secp_verify_prehashed`` on 64 crafted rows (valid, flipped s, wrong
   message, cross key, ``ok_in`` False, Q = G with u1 = u2, R at infinity,
   a point with x >= n taking the direct and the wrapped compare, the
   forged wrap r = x - n + 2^256, u1 = u2 = 0) and ``sha256_batch`` on
   one-block rows, 2-block inner rows and the leaf batch of the L2 block
   (ragged block counts), each against its plain version on the card, the
   JAX package's rule or hashlib. Then a validator set of the 150 keys in
   which every third holds a secp256k1 key (equal power), with
   ``TM_TPU_SECP_DEVICE=1``: ``verify_commit`` on 5 heights (the 50
   secp256k1 rows on the kernel, a tampered secp256k1 signature rejected
   with the reference's message) and ``verify_commits_light`` over a
   64-commit window (6,400 ed25519 rows on the big tier, 3,200 secp256k1
   rows on the kernel; commit 40 with tampered ed25519 and secp256k1
   signatures of more than 1/3 of the power) from an executor thread
   through a started ``VerifyScheduler``, twice, each wall split into
   secp256k1 host prep, the kernel with its copies, the ed25519 round and
   sign-bytes assembly; the secp256k1 rows against the native host route
   (also timed, as the yardstick), a sample against the host oracles. Then
   ``Data.hash()`` of an L2 block (4,000 transactions of 100-1,024 bytes
   and 2 payload leaves) with the device gate at 1,024 leaves, and
   ``merkle_root_pow2`` over 4,096 leaves, both equal to the host tree.
   Launch counts are read after each path; timings: both kernels (median
   of 20) at the path's shapes with their bounds, the per-height and
   window walls, the native and device routes of the 3,200 rows, the
   merkle block by the card (``pad_messages`` apart) and by hashlib.
7. The in-process consensus net (``consensus_phase``): ``NET_VALIDATORS``
   (32) validators in this process, wired with the full-mesh
   broadcast hook, each a ``ConsensusState`` over ``KVStoreApplication``
   through ``LocalClient``, ``MemKV`` stores, ``MockL2Node`` and ``MockPV``,
   on the process verifier (the card) behind one started
   ``VerifyScheduler`` as the process default. Mode (a), legacy commits,
   and mode (b), quorum certificates with batch points every 2 blocks
   whose precommits carry BLS dual-signatures checked by the L2 mock's
   registry verifier (the pairing gate unset), each run to
   ``NET_HEIGHTS`` (3) heights plus one. Checks: every node the same block (so
   the same app hash) at every height, every stored LastCommit signature
   true by the host oracle, the ledger's consensus-class rounds (mode a:
   signature rounds from ``min_device_batch`` rows, at least one per
   height; mode b: ``qc_verify`` rounds), small-tier launches in mode (a)
   (big-tier ones where a round reaches 512 rows), BLS data at every
   sealed batch point and no BLS launch in either mode; in mode (a) every
   small-tier round's verdicts, as the net got them, equal the plain
   version at the dispatched shape. Prints the walls per height, rows and
   buckets per round, and the device and host shares; the net's launches
   add to the kernels line.
8. The multi-device path (``mesh_phase``) over a ``Mesh`` of
   ``MESH_SHARDS`` (8) shards, all on ``cuda:0``: every line of the
   sharded path (the row split, the table store copied per distinct
   device, a launch per shard, the gather, the local trees and the XOR
   butterfly) with the JAX tests' shard count, on one card. Kernel 13,
   ``g1_aggregate_sharded`` and ``g2_aggregate_sharded`` (the trees of
   rows 11a/11b and the new ``g1_add``/``g2_add`` butterfly kernels), on
   the QC window's 150 signatures and 150 keys, the 256 adversarial points
   and 5 points, each against its plain version on the CPU (bytes) and the
   host sum. The blocksync window (the same 64 commits, 9,600 rows, bucket
   16,384, 2,048 rows a shard) through a started ``VerifyScheduler`` over
   ``BatchVerifier(mesh=...)``, host-hashed x2, card-hashed x2
   (``device_challenge_min=2048``) and MXU x1: verdicts and per-row bitmap
   equal to phase 3's 1-device window's, every round stamped
   ``devices=8`` and sharded, the ``verify_mesh_devices`` gauge 8; one
   150-row commit (below ``mesh_min_rows``) stamped ``devices=1``; the
   phase-3 commit round sharded on the small tier and the generic kernel
   (``mesh_min_rows=1``); ``prewarm_buckets`` with both device variants
   where the ladder allows; the secp256k1 kernel sharded over the mixed
   window's 8,192 rows (3,200 live), equal to the unsharded launch. Times:
   the add kernels, kernel 13 with its bound, the windows beside phase 3's,
   the secp256k1 rows sharded and not. Where ``torch.cuda.device_count()``
   is 2 or more, kernel 13, the host-hashed window and the secp256k1
   launch again over ``build_mesh(0, 1, "cuda")``; else it prints
   ``mesh: real multi-GPU mesh not run (1 device)``. The path's launches
   add to the kernels line, which gains ``g1_add`` and ``g2_add``.
9. Print the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA it exits non-zero before printing any result. The full
ptxas report is kept beside the build, in
``tendermint_tpu_torch/_kbuild/ptxas_report.txt``.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit integer
# multiply-adds/s, taken as a quarter of the 67 TFLOP/s float32 rate
# (IMAD issues at half the FFMA rate, and an FFMA counts two FLOPs). The
# SHA-512 kernel's logic, shift and add instructions are counted against
# the same rate.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# a 5 x 51-bit field multiply is 25 64x64->128-bit products, each four
# 32x32-bit multiply-adds
IMAD_PER_FE_MUL = 25 * 4

# field multiplications per row, counted from ops/csrc/ed25519_kernels.cu
FE_INVERT = 265
FE_POW22523 = 262
FE_DECOMPRESS = 13 + FE_POW22523
FE_TABLE_BUILD = 1 + 14 * 8 + 16  # to_cached(A), 14 cached adds, 16 to_cached
FE_VAR_MULT = 64 * (4 * 8 + 8)  # 64 windows of 4 doublings + 1 cached add
FE_BASE_MULT = 32 * 8
FE_FINISH = 1 + 8 + FE_INVERT + 2  # to_cached, add, compress
FE_VERIFY_TABLE = FE_VAR_MULT + FE_BASE_MULT + FE_FINISH
# the dependent multiplications of one row of the four-lane kernel 3: 2 a
# point operation (64 x 5 in [k](-A), 32 in [s]B, 1 in the finish), and
# the finish's to_cached, inversion and two products
FE_VERIFY_TABLE_PATH = 2 * (64 * 5 + 32 + 1) + 1 + FE_INVERT + 2
FE_DBL = 8
# the big table of one key: decompress, to_cached(-A), 14 cached adds for
# row 0, 63 x 4 doublings of the 16 columns, 64 x 16 to_cached (the work
# of the function; the kernel's 16 threads per key each decompress and
# repeat row 0's adds up to their column)
FE_BIGTABLE = FE_DECOMPRESS + 1 + 14 * 8 + 63 * 4 * 16 * FE_DBL + 64 * 16
FE_VERIFY_BIG = 64 * 8 + FE_BASE_MULT + FE_FINISH  # 64 cached adds, [s]B
# SHA-512, per 128-byte block, from ops/csrc/sha512_kernels.cu: 80 rounds
# of ~25 64-bit operations and 64 schedule steps of ~13, each 64-bit
# operation two 32-bit instructions
SHA512_OPS_PER_BLOCK = 2 * (80 * 25 + 64 * 13)
# sc_reduce: 14 folds of 6 64-bit multiply-adds, 46 carries, the limb
# loads and the packing; about a thousand 32-bit instructions
SC_REDUCE_OPS = 1000

# commits per blocksync window (VERIFY_WINDOW, tendermint_tpu/blocksync/
# reactor.py:243): the bulk path verifies one window as one batch
WINDOW = 64

# the in-process consensus net: the live size of the JAX package's
# committee_scale sweep (bench.py, _run_committee_net), and the heights
# each mode commits past the first
NET_VALIDATORS = 32
NET_HEIGHTS = 3

SOURCE = "tendermint_tpu_torch/ops/csrc/ed25519_kernels.cu"
SHA_SOURCE = "tendermint_tpu_torch/ops/csrc/sha512_kernels.cu"

# kernel 3's shapes, (rows, padding rows): one row group; a partial last
# warp with padding (a LastCommit round of the 32-validator net is 22-23
# rows); the commit path's 150 live rows alone and padded to its 256 bucket
KERNEL3_SIZES = ((1, 0), (23, 2), (150, 0), (256, 106))
KERNEL3_BUCKETS = (8, 32, 128, 256)
# verify_commit at 150 validators, ms a height after the first, with the
# one-thread kernel 3 (PERF.md section 5; NVIDIA H100 80GB HBM3, 700 W)
COMMIT_MS_ONE_THREAD = (5.67, 5.74)


def max_abs_err(a, b) -> int:
    """Largest elementwise difference of two integer/bool tensors."""
    return int((a.to(b.device).long() - b.long()).abs().max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def kernel_name(mangled: str) -> str:
    """The `*_kernel` identifier inside a mangled name: the one whose
    length prefix reads exactly its characters (an anonymous namespace
    puts the file's name before it)."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            name = mangled[m.end() : m.end() + n]
            if len(name) == n and re.fullmatch(r"[a-z]\w*_kernel", name):
                return name
    return mangled


def ptxas_usage(report: str) -> dict[str, str]:
    """kernel name -> its stack/spill and register lines of -Xptxas -v."""
    usage: dict[str, list[str]] = {}
    name = None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            usage[name] = []
        elif name and ("spill" in ln or "Used" in ln):
            usage[name].append(ln.replace("ptxas info    :", "").strip())
            if "Used" in ln:
                name = None
    return {k: "; ".join(v) for k, v in usage.items()}


def bound_ms(nbytes: int, imads: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_cuda(torch, fn, reps: int) -> float:
    """Median ms of `reps` calls, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_once(torch, fn, *args):
    """(result, ms) of one call fn(*args) between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def mixed_rows(host, keys, pubs, n_rows: int, n_pad: int, tag: bytes):
    """n_rows (pubkey, msg, sig) rows over the keys: valid, wrong message,
    flipped signature bit, s >= L, adversarial keys (rows 200.. of pubs),
    and the last n_pad rows padding. Returns (items, idx, want) with
    idx -1 on padding rows and want the host oracle's verdicts."""
    n_keys = len(keys)
    items, idx = [], []
    for i in range(n_rows):
        ki = i % n_keys
        msg = b"%s-%d" % (tag, i)
        sig = keys[ki].sign(msg)
        kind = i % 8
        pub = pubs[ki]
        if kind == 1:
            msg = msg + b"!"
        elif kind == 2:
            sig = sig[:7] + bytes([sig[7] ^ 4]) + sig[8:]
        elif kind == 3:
            s = int.from_bytes(sig[32:], "little") + host.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 4:
            ki = n_keys + (i // 8) % (len(pubs) - n_keys)
            pub = pubs[ki]
        items.append((pub, msg, sig))
        idx.append(-1 if i >= n_rows - n_pad else ki)
    want = [
        host.verify(p, m, s) and i < n_rows - n_pad
        for i, (p, m, s) in enumerate(items)
    ]
    return items, idx, want


def row_tensors(torch, host, items, idx, n_pad: int, dev):
    """R, S, K (host challenges), s_ok (False on the last n_pad rows) and
    idx as int32 of (pubkey, msg, sig) rows, on dev."""
    def T(rows):
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8, device=dev)

    R = T([sg[:32] for _, _, sg in items])
    S = T([sg[32:] for _, _, sg in items])
    K = T([host.challenge(sg[:32], p, m).to_bytes(32, "little") for p, m, sg in items])
    ok = torch.tensor([int.from_bytes(sg[32:], "little") < host.L for _, _, sg in items])
    ok[len(items) - n_pad:] = False
    return R, S, K, ok.to(dev), torch.tensor(idx, dtype=torch.int32, device=dev)


def kernel3_rows(torch, host, keys, pubs, tables, tvalid, b: int, n_pad: int,
                 tag: bytes):
    """Kernel 3's operands for b rows of mixed_rows over a table store of
    pubs on the card, the last n_pad padding; rows 3 and 9, where live,
    get idx -1 and idx past the store, inside warps of live rows (a warp
    holds 8 row groups of 4 lanes). Returns (operands, the host oracle's
    verdicts)."""
    items, idx, want = mixed_rows(host, keys, pubs, b, n_pad, tag)
    for row, v in ((3, -1), (9, tables.shape[0] + 5)):
        if row < b - n_pad:
            idx[row], want[row] = v, False
    R, S, K, ok, idx_t = row_tensors(torch, host, items, idx, n_pad, tables.device)
    return (tables, tvalid, idx_t, R, S, K, ok), want


def signed_window(host, types, vset, by_addr, chain_id, n_commits, bad_height, rng):
    """n_commits commits of vset for heights 1.., all validators signing
    for the block; at bad_height the signatures of the heaviest
    validators holding more than 1/3 of the power are tampered. Returns
    (entries [(block_id, height, commit)], tampered validator indices)."""
    vals = vset.validators
    total = sum(v.voting_power for v in vals)
    order = sorted(range(len(vals)), key=lambda i: -vals[i].voting_power)
    tampered, power = [], 0
    for i in order:
        if 3 * power > total:
            break
        tampered.append(i)
        power += vals[i].voting_power
    entries = []
    for h in range(1, n_commits + 1):
        bid = types.BlockID(
            hash=rng.bytes(32),
            part_set_header=types.PartSetHeader(total=1, hash=rng.bytes(32)),
        )
        sigs = [
            types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                            1_700_000_000_000_000_000 + h * 10**9 + i)
            for i, v in enumerate(vals)
        ]
        commit = types.Commit(h, 0, bid, sigs)
        for i, v in enumerate(vals):
            sig = by_addr[v.address].sign(commit.vote_sign_bytes(chain_id, i))
            if h == bad_height and i in tampered:
                sig = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
            sigs[i].signature = sig
        entries.append((bid, h, commit))
    return entries, tampered


def run_window(verifier, vset, chain_id, entries, reps: int, label: str,
               metrics=None):
    """verify_commits_light over the window, `reps` times, from an executor
    thread through a started VerifyScheduler installed as the process
    default (default_dispatch("blocksync")), as blocksync's reactor does;
    then the window's rows once more through the same adapter for the
    per-row bitmap. Each timed window starts after a full garbage
    collection, and the collector's pauses inside it are summed. Returns
    (verdicts per rep, wall seconds per rep, gc pause seconds per rep,
    bitmap, items, the scheduler's ledger entries). `metrics` (a
    SchedulerMetrics) is the scheduler's, one of its own when None."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import (
        VerifyScheduler, default_dispatch, set_default_scheduler,
    )

    items = [
        it for _, _, c in entries for it in vset._gather_items(chain_id, c, True)[0]
    ]
    ledger = DispatchLedger()
    sched = VerifyScheduler(
        verifier=verifier, ledger=ledger,
        metrics=metrics or SchedulerMetrics(Registry("smoke_" + label)),
    )

    gc_pause = [0.0, 0.0]  # summed seconds, start of the current pause

    def on_gc(phase, info):
        if phase == "start":
            gc_pause[1] = time.perf_counter()
        else:
            gc_pause[0] += time.perf_counter() - gc_pause[1]

    async def go():
        await sched.start()
        loop = asyncio.get_running_loop()
        verdicts, walls, gcs = [], [], []
        try:
            for _ in range(reps):
                gc.collect()
                gc_pause[0] = 0.0
                t0 = time.perf_counter()
                verdicts.append(await loop.run_in_executor(
                    None,
                    lambda: vset.verify_commits_light(
                        chain_id, entries, verifier=default_dispatch("blocksync")
                    ),
                ))
                walls.append(time.perf_counter() - t0)
                gcs.append(gc_pause[0])
            bitmap = await loop.run_in_executor(
                None, lambda: default_dispatch("blocksync").verify(items)
            )
        finally:
            await sched.stop()
        return verdicts, walls, gcs, bitmap

    set_default_scheduler(sched)
    gc.callbacks.append(on_gc)
    try:
        verdicts, walls, gcs, bitmap = asyncio.run(go())
    finally:
        gc.callbacks.remove(on_gc)
        set_default_scheduler(None)
    return (verdicts, walls, gcs, [bool(v) for v in bitmap], items,
            ledger.entries())


def check_window(host, verdicts, bitmap, items, entries_ledger, n_commits,
                 bad_height, tampered, n_vals, rng, label):
    """The contract of one bulk run: verdicts, the per-row bitmap False
    exactly on the tampered rows, a seeded sample against the host oracle,
    and every ledger round one blocksync round of the whole window."""
    want = [h != bad_height for h in range(1, n_commits + 1)]
    for v in verdicts:
        assert v == want, f"{label}: verdicts {v}"
    bad_rows = {(bad_height - 1) * n_vals + i for i in tampered}
    assert [i for i, ok in enumerate(bitmap) if not ok] == sorted(bad_rows), label
    for i in rng.choice(len(items), size=min(256, len(items)), replace=False):
        it = items[int(i)]
        assert bitmap[int(i)] == host.verify(it.pubkey, it.msg, it.sig), (label, i)
    for e in entries_ledger:
        assert e["engine"] == "sig" and e["rows"] == {"blocksync": len(items)}, e


# --- the quorum-certificate path (BLS12-381) --------------------------------

BLS_SOURCE = "tendermint_tpu_torch/ops/csrc/bls_kernels.cu"
# an Fp multiplication of bls12_381_device.cuh: Montgomery CIOS over 6 x
# 64-bit limbs, 72 64x64->128-bit products of four 32-bit multiply-adds
IMAD_PER_FP_MUL = 72 * 4
# Fp multiplications per operation, counted from bls12_381_device.cuh
FP_G1_ADD = 16
FP_G2_ADD = 5 * 2 + 11 * 3  # 5 Fp2 squarings, 11 Fp2 multiplications
FP_F12_MUL, FP_F12_SQR, FP_LINE = 54, 36, 54
FP_MILLER_DBL, FP_MILLER_ADD = 31, 43
FP_INV = 381 + 229  # Fermat: the bits and the set bits of p - 2
FP_CYCLO_SQR, FP_FROB = 18, 18
FP_EXP_X = 64 * FP_CYCLO_SQR + 6 * FP_F12_MUL
FP_F12_INV = 2 * FP_F12_MUL + 37 + FP_INV
FP_FINAL_EXP = (2 * FP_F12_MUL + FP_F12_INV + 2 * FP_FROB  # easy part
                + 5 * FP_EXP_X + 7 * FP_F12_MUL + FP_CYCLO_SQR + 3 * FP_FROB
                + 12 + 12 + 12)  # loads, stores, the gamma table
MILLER_BITS = 63  # bits of |x| after the leading one
MILLER_ADDS = 5  # set bits of |x| after the leading one
QC_BAD = 40  # the forged certificate's height in the 64-QC window


def miller_fp_muls(n_valid: int) -> int:
    """Fp multiplications of tm_miller that this data needs: each valid
    pair's loads, doubling/addition steps and line products, the f12
    squarings of each chunk that holds a valid pair, the product of those
    chunks and the store. Padding pairs and chunks (their value stays one)
    count nothing."""
    chunks = -(-n_valid // 2)
    per_pair = (6 + MILLER_BITS * (FP_MILLER_DBL + FP_LINE)
                + MILLER_ADDS * (FP_MILLER_ADD + FP_LINE))
    return (n_valid * per_pair + chunks * MILLER_BITS * FP_F12_SQR
            + (chunks - 1) * FP_F12_MUL + 12)


def f12_pow(c, a, e: int):
    r = c.F12_ONE
    for bit in bin(e)[2:]:
        r = c.f12_mul(r, r)
        if bit == "1":
            r = c.f12_mul(r, a)
    return r


def timed(module, names, acc):
    """Wrap module functions (or an object's methods) with host timers
    summed into acc[name]; returns the originals for restore()."""
    saved = {}
    for name in names:
        fn = getattr(module, name)
        saved[name] = fn

        def wrap(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t0

        setattr(module, name, wrap)
    return saved


def timed_async(cls, name, acc):
    """timed() for one coroutine method: its wall per call, awaits
    included, summed into acc[name]; returns the original for restore()."""
    fn = getattr(cls, name)

    async def wrap(*a, **k):
        t0 = time.perf_counter()
        try:
            return await fn(*a, **k)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(cls, name, wrap)
    return {name: fn}


def restore(module, saved):
    for name, fn in saved.items():
        if hasattr(fn, "__func__") and fn.__self__ is module:
            delattr(module, name)  # a bound method: drop the instance's wrapper
        else:
            setattr(module, name, fn)


BLS_GATE = "TM_TPU_BLS_PAIRING_DEVICE"


def qc_route(torch, ops, bls, qcm, qset, vals, privs, chain_id, entries,
             split_names, device):
    """One BLS route of the QC path: assemble_qc over the window's commits
    (launch counts read), QC QC_BAD replaced by a sub-quorum aggregate
    under the full bitset, then verify_commits_qc over the window from an
    executor thread through a started VerifyScheduler's qc_verify lane,
    twice (launch counts read). With `device`, each QC's signature sum and
    signer-key sum also go through the named device sums, held against
    the assembled (native) ones."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler

    ops.reset_launches()
    t0 = time.perf_counter()
    qcs = [qcm.assemble_qc(chain_id, commit, qset) for _, _, commit in entries]
    assemble_s = time.perf_counter() - t0
    assert all(q is not None and q.num_signers() == len(vals) for q in qcs)
    if device:
        for q, (_, _, commit) in zip(qcs, entries):
            shares = [bls.g1_from_bytes(commit.signatures[i].qc_signature)
                      for i in q.signers.ones()]
            got = bls.g1_to_bytes(bls.aggregate_signatures_device(shares))
            assert got == q.agg_signature, "aggregate_signatures_device != native"
            keys = [bls.new_trusted_public_key(
                bls.g2_from_bytes(qset.validators[i].bls_pub_key))
                for i in q.signers.ones()]
            got = bls.g2_to_bytes(bls.aggregate_public_keys_device(keys))
            assert got == bls.g2_to_bytes(bls.aggregate_public_keys(keys).key), \
                "aggregate_public_keys_device != native"
    torch.cuda.synchronize()
    asm_launches = ops.kernel_launches()
    bad = qcm.QuorumCertificate.decode(qcs[QC_BAD - 1].encode())
    hm = bls.hash_to_g1(bad.sign_bytes(chain_id))
    shares = [bls._g1_mul_point(hm, privs[v.address]) for v in vals[: len(vals) // 2]]
    bad.agg_signature = bls.g1_to_bytes(bls.aggregate_signatures(shares))
    window = [(bid, h, q) for (bid, h, _), q in zip(entries, qcs)]
    window[QC_BAD - 1] = (window[QC_BAD - 1][0], QC_BAD, bad)

    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(
        Registry(f"smoke_qc_{int(device)}")))
    splits, walls = [], []

    async def go():
        await sched.start()
        loop = asyncio.get_running_loop()
        out = []
        try:
            for _ in range(2):
                acc = {}
                saved = timed(bls, split_names, acc)
                try:
                    gc.collect()
                    t0 = time.perf_counter()
                    out.append(await loop.run_in_executor(
                        None, lambda: qset.verify_commits_qc(chain_id, window)))
                    walls.append(time.perf_counter() - t0)
                finally:
                    restore(bls, saved)
                splits.append(acc)
        finally:
            await sched.stop()
        return out

    ops.reset_launches()
    set_default_scheduler(sched)
    try:
        verdicts = asyncio.run(go())
    finally:
        set_default_scheduler(None)
    torch.cuda.synchronize()
    return {
        "qcs": qcs, "assemble_s": assemble_s, "asm_launches": asm_launches,
        "verdicts": verdicts, "walls": walls, "splits": splits,
        "win_launches": ops.kernel_launches(),
        "rounds": [e for e in ledger.entries() if e["engine"] == "qc_verify"],
    }


def qc_phase(torch, rng, dev, smi, ops, types, vset, chain_id, entries):
    """Phase 5: BLS kernels against their plain versions and the oracle,
    then a 64-QC window over the 150-validator set: proposer-side assembly
    (assemble_qc) and verify_commits_qc through a started VerifyScheduler's
    qc_verify lane, twice. Returns the four kernels' rows and, for the mesh
    phase, the point sets {"g1"|"g2": [(label, points, host points)]}."""
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.crypto import bls_native
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.ops import bls_g1, bls_g2
    from tendermint_tpu_torch.ops import bls_pairing as bp
    from tendermint_tpu_torch.types import quorum_cert as qcm

    assert bls_native.native_lib() is not None, "native BLS library did not build"

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "big") % (c.R - 1) + 1

    def g1(k):
        return bls._g1_mul_point(c.G1_GEN, k)

    def g2(k):
        return bls._g2_mul_point(c.G2_GEN, k)

    errs = {}

    # --- kernel vs plain: aggregates on 256 points with duplicates,
    # opposites and the identity among them (doubling and identity branches)
    g1s = [g1(scalar()) for _ in range(200)]
    g1s += g1s[:20] + [c.g1_neg(p) for p in g1s[20:40]] + [c.G1_INF] * 6 + [(0, 1, 0)] * 10
    g2s = [g2(scalar()) for _ in range(200)]
    g2s += g2s[:20] + [c.g2_neg(p) for p in g2s[20:40]] + [c.G2_INF] * 16
    p1 = torch.stack([bls_g1.g1_from_host(p) for p in g1s]).to(dev)
    p2 = torch.stack([bls_g2.g2_from_host(p) for p in g2s]).to(dev)
    for name, kern, plain, pts, add, inf, to_host, eq in (
        ("g1_aggregate", bls_g1.g1_aggregate, bls_g1.g1_aggregate_plain, p1,
         c.g1_add, c.G1_INF, bls_g1.g1_to_host, c.g1_eq),
        ("g2_aggregate", bls_g2.g2_aggregate, bls_g2.g2_aggregate_plain, p2,
         c.g2_add, c.G2_INF, bls_g2.g2_to_host, c.g2_eq),
    ):
        got, want = kern(pts), plain(pts)
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, want)
        assert errs[name] == 0, f"{name}: kernel != plain"
        acc = inf
        for p in (g1s if name == "g1_aggregate" else g2s):
            acc = add(acc, p)
        assert eq(to_host(got), acc), f"{name} != host oracle"

    # the pairing: the 2-pair verify shape and a 65-pair RLC shape whose
    # product is one (sum of a_i b_i cancelled by the last pair)
    a, b = [scalar() for _ in range(64)], [scalar() for _ in range(64)]
    rlc_pairs = [(g1(x), g2(y)) for x, y in zip(a, b)]
    rlc_pairs.append((g1(-sum(x * y for x, y in zip(a, b)) % c.R), c.G2_GEN))
    s = scalar()
    verify_pairs = [(g1(s), c.G2_GEN), (c.g1_neg(g1(1)), g2(s))]
    shapes = {"verify": verify_pairs, "rlc": rlc_pairs}
    chunks = {k: bp.prepare_pairs(v, dev) for k, v in shapes.items()}
    mill, plain_ms = {}, {}
    for k, ch in chunks.items():
        # the RLC shape is the timing shape: its one plain call is timed
        got = bp.miller(*ch)
        want, plain_ms["miller"] = time_once(torch, bp.miller_plain, *ch)
        fe_got = bp.final_exp(got.unsqueeze(0))
        fe_plain, plain_ms["final_exp"] = time_once(
            torch, bp.final_exp_plain, got.unsqueeze(0))
        torch.cuda.synchronize()
        errs["miller"] = max(errs.get("miller", 0), max_abs_err(got, want))
        errs["final_exp"] = max(errs.get("final_exp", 0), max_abs_err(fe_got, fe_plain))
        assert errs["miller"] == 0, f"tm_miller != plain ({k})"
        assert errs["final_exp"] == 0, f"tm_final_exp != plain ({k})"
        assert bp.f12_to_host(fe_got[0]) == c.F12_ONE, f"{k} product is not one"
        assert c.multi_pairing_is_one(shapes[k]), k
        mill[k] = got
    # bilinearity: e(aP, bQ) == e(P, Q)^(ab)
    x, y = scalar(), scalar()
    P0, Q0 = g1(scalar()), g2(scalar())
    e_ab = bp.pairing_value([(bls._g1_mul_point(P0, x), bls._g2_mul_point(Q0, y))], dev)
    e_1 = bp.pairing_value([(P0, Q0)], dev)
    assert e_ab == f12_pow(c, e_1, x * y % c.R), "bilinearity"
    assert e_1 == c.pairing(P0, Q0), "pairing_value != host oracle"
    print("kernel-vs-plain: g1_aggregate, g2_aggregate (256 points with "
          "duplicates, opposites, identity), miller and final_exp (2-pair "
          "verify shape, 65-pair RLC shape) equal their plain versions "
          "(tolerance: exact) and the host oracle; e(aP, bQ) = e(P, Q)^(ab)")

    # --- the window: BLS keys for the 150 validators. Four go through
    # pubkey_from_priv (proof of possession, one native pairing each); the
    # rest are trusted keys, as a genesis file carries them (set-up).
    t0 = time.perf_counter()
    vals = vset.validators
    privs = {v.address: scalar() for v in vals}
    pubs = {}
    for i, v in enumerate(vals):
        k = privs[v.address]
        pubs[v.address] = (bls.pubkey_from_priv(k) if i < 4 else
                           bls.new_trusted_public_key(g2(k))).key
    qset = types.ValidatorSet([
        types.Validator(v.pub_key, v.voting_power, bls_pub_key=bls.g2_to_bytes(pubs[v.address]))
        for v in vals
    ])
    assert [v.address for v in qset.validators] == [v.address for v in vals]
    n_win = len(entries)
    for h, (bid, _, commit) in enumerate(entries, start=1):
        hm = bls.hash_to_g1(qcm.qc_sign_bytes(chain_id, h, 0, bid))
        for cs, v in zip(commit.signatures, vals):
            cs.qc_signature = bls.g1_to_bytes(bls._g1_mul_point(hm, privs[v.address]))
    keys_s = time.perf_counter() - t0

    # the two routes of the JAX package's order: by default native pairing
    # and MSM on the host (no BLS kernel may launch); under
    # TM_TPU_BLS_PAIRING_DEVICE=1 every pairing check on the card, and the
    # named device sums (aggregate_signatures_device for each QC's shares,
    # aggregate_public_keys_device for its signer keys) beside assembly
    want = [h != QC_BAD for h in range(1, n_win + 1)]
    bls_kernels = ("g1_aggregate", "g2_aggregate", "miller", "final_exp")
    split_names = ("g1_from_bytes", "_qc_signer_key", "hash_to_g1", "_g1_mul_point",
                   "_pairing_is_one")
    routes = {}
    for route in ("native", "device"):
        if route == "device":
            os.environ[BLS_GATE] = "1"
        else:
            os.environ.pop(BLS_GATE, None)
        try:
            routes[route] = qc_route(
                torch, ops, bls, qcm, qset, vals, privs, chain_id, entries,
                split_names, route == "device")
        finally:
            os.environ.pop(BLS_GATE, None)
        r = routes[route]
        for v in r["verdicts"]:
            assert v == want, f"qc window verdicts ({route}) {v}"
        assert len(r["rounds"]) == 2 and all(
            e["rows"] == {"blocksync": n_win} for e in r["rounds"]), r["rounds"]
        if route == "native":
            for name in bls_kernels:
                assert r["asm_launches"][name] == r["win_launches"][name] == 0, \
                    f"{name} launched on the native route"
        else:
            for name in ("g1_aggregate", "g2_aggregate", "miller", "final_exp"):
                assert r["asm_launches"][name] > 0, f"{name} not launched assembling QCs"
            for name in ("miller", "final_exp"):
                assert r["win_launches"][name] > 0, f"{name} not launched on the QC window"
    assert [q.encode() for q in routes["native"]["qcs"]] == \
        [q.encode() for q in routes["device"]["qcs"]], "routes assembled other QCs"
    for route, r in routes.items():
        checks = r["win_launches"]["final_exp"] // 2
        print(f"main path: qc assembly ({route} route): {n_win} commits x {len(vals)} "
              f"validators through assemble_qc, every QC with all {len(vals)} signers"
              + (", each QC's signature sum and signer-key sum again through "
                 "aggregate_signatures_device / aggregate_public_keys_device, equal "
                 "to the native sums" if route == "device" else "")
              + f"; launches {json.dumps({k: v for k, v in r['asm_launches'].items() if v})}")
        print(f"main path: qc window ({route} route): verify_commits_qc over {n_win} QCs "
              f"(QC {QC_BAD} a sub-quorum aggregate under the full bitset) through a "
              f"started VerifyScheduler's qc_verify lane, x2; verdicts [True]*"
              f"{QC_BAD - 1} + [False] + [True]*{n_win - QC_BAD} each time; {checks} "
              f"card pairing checks per window; launches "
              f"{json.dumps({k: v for k, v in r['win_launches'].items() if v})}")
    dev_r = routes["device"]
    launches = {
        "g1_aggregate": dev_r["asm_launches"]["g1_aggregate"],
        "g2_aggregate": dev_r["asm_launches"]["g2_aggregate"],
        "miller": dev_r["asm_launches"]["miller"] + dev_r["win_launches"]["miller"],
        "final_exp": dev_r["asm_launches"]["final_exp"] + dev_r["win_launches"]["final_exp"],
    }

    # --- the aggregates at the device route's shapes, against their plain
    # versions (one timed call each) and the host oracle: each QC's 150
    # signatures (a tree padded to 256) and its 150 signer keys (one tree);
    # and the launch of the no-library QC engine (_g2_sums), 64 trees of
    # 150 keys in one grid (each tree padded, one block each), here each
    # tree the keys rotated by its index
    sigs = [bls.g1_from_bytes(cs.qc_signature) for cs in entries[0][2].signatures]
    sig_pts = torch.stack([bls_g1.g1_from_host(p) for p in sigs]).to(dev)
    key_pts = torch.stack([bls_g2.g2_from_host(pubs[v.address]) for v in vals])
    key_trees = key_pts.unsqueeze(0).to(dev)
    key_forest = torch.stack([key_pts.roll(t, 0) for t in range(n_win)]).to(dev)
    sig_sum, key_sum = c.G1_INF, c.G2_INF
    for p in sigs:
        sig_sum = c.g1_add(sig_sum, p)
    for v in vals:
        key_sum = c.g2_add(key_sum, pubs[v.address])
    sums = {}
    for name, kern, plain, pts in (
        ("g1_aggregate", bls_g1.g1_aggregate, bls_g1.g1_aggregate_plain, sig_pts),
        ("g2_aggregate", bls_g2.g2_aggregate, bls_g2.g2_aggregate_plain, key_trees),
        ("g2_forest", bls_g2.g2_aggregate, bls_g2.g2_aggregate_plain, key_forest),
    ):
        got = kern(pts)
        want, t_ms = time_once(torch, plain, pts)
        err = max_abs_err(got, want)
        assert err == 0, f"{name}: kernel != plain at shape {tuple(pts.shape)}"
        if name != "g2_forest":
            plain_ms[name] = t_ms
        kname = "g2_aggregate" if name == "g2_forest" else name
        errs[kname] = max(errs[kname], err)
        sums[name] = got.cpu()
    assert c.g1_eq(bls_g1.g1_to_host(sums["g1_aggregate"]), sig_sum), "g1 != host oracle"
    for name in ("g2_aggregate", "g2_forest"):
        assert len(sums[name]) == (n_win if name == "g2_forest" else 1)
        assert all(c.g2_eq(bls_g2.g2_to_host(t), key_sum) for t in sums[name]), \
            f"{name} trees != host oracle"
    print(f"kernel-vs-plain: g1_aggregate at {tuple(sig_pts.shape)}, "
          f"g2_aggregate at {tuple(key_trees.shape)} (the device route's shapes) "
          f"and at {tuple(key_forest.shape)} (the no-library QC engine's "
          f"{n_win}-tree launch) equal their plain versions (tolerance: exact) "
          f"and the host oracle")

    # --- timings at the main path's shapes
    rlc = chunks["rlc"]
    f_one = mill["rlc"].unsqueeze(0).contiguous()
    n_rlc_chunks = rlc[0].shape[0]
    work = {
        "g1_aggregate": (
            lambda: bls_g1.g1_aggregate(sig_pts),
            sig_pts.numel() + 144,
            ((len(vals) - 1) * FP_G1_ADD + 3 * len(vals) + 3) * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_g1.py:309",
        ),
        "g2_aggregate": (
            lambda: bls_g2.g2_aggregate(key_trees),
            key_trees.numel() + 288,
            ((len(vals) - 1) * FP_G2_ADD + 6 * len(vals) + 6) * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_g2.py:214",
        ),
        "miller": (
            lambda: bp.miller(*rlc),
            sum(t.numel() for t in rlc) + 576,
            miller_fp_muls(len(rlc_pairs)) * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_pairing.py:405",
        ),
        "final_exp": (
            lambda: bp.final_exp(f_one),
            2 * 576,
            FP_FINAL_EXP * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_pairing.py:443",
        ),
    }
    rows = []
    for name, (kern, nbytes, n_ops, replaces) in work.items():
        ms = time_cuda(torch, kern, 20)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": BLS_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms[name],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms[name]:.2f} ms "
              f"(one call) bound {b_ms:.5f} ms ({b_by}) | {smi}")
    vchunks = chunks["verify"]
    mv = time_cuda(torch, lambda: bp.miller(*vchunks), 20)
    print(f"time: miller at the 2-pair verify shape {mv:.4f} ms (1 chunk); "
          f"at the 65-pair RLC shape ({n_rlc_chunks} chunks) the miller row | {smi}")
    for k, pairs in shapes.items():
        g1b = b"".join(bls.g1_to_bytes(p) for p, _ in pairs)
        g2b = b"".join(bls.g2_to_bytes(q) for _, q in pairs)
        assert bls_native.pairing_check(g1b, g2b, len(pairs))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            bls_native.pairing_check(g1b, g2b, len(pairs))
            ts.append((time.perf_counter() - t0) * 1e3)
        card = []
        for _ in range(5):
            t0 = time.perf_counter()
            assert bp.check_pairs(pairs, dev)
            card.append((time.perf_counter() - t0) * 1e3)
        print(f"time: pairing check, {len(pairs)} pairs: native host library "
              f"(one CPU thread) median {statistics.median(ts):.3f} ms; "
              f"check_pairs on the card median {statistics.median(card):.3f} ms "
              f"(host prep, miller, final_exp, copies) | {smi}")
    print(f"time: qc set-up {keys_s:.1f} s ({len(vals)} BLS keys, 4 with a "
          f"proof-of-possession pairing; {n_win * len(vals)} signature shares, "
          f"host) | {smi}")
    labels = {"g1_from_bytes": "signature parse", "_qc_signer_key": "key parse",
              "hash_to_g1": "hash-to-G1", "_g1_mul_point": "scalar mults",
              "_pairing_is_one": "pairing checks"}
    for route, r in routes.items():
        print(f"time: qc assembly ({route} route) of {n_win} QCs "
              f"{r['assemble_s'] * 1e3:.1f} ms, {r['assemble_s'] * 1e3 / n_win:.2f} "
              f"ms per QC (assemble_qc alone) | {smi}")
        for rep, (wall, acc) in enumerate(zip(r["walls"], r["splits"]), start=1):
            parts = ", ".join(f"{labels[k]} {acc.get(k, 0.0) * 1e3:.2f} ms"
                              for k in split_names)
            rest = wall - sum(acc.values())
            print(f"time: qc window {rep} ({route} route): wall {wall * 1e3:.2f} ms, "
                  f"{n_win / wall:.1f} QCs/s; {parts}; rest (tally, signer-key "
                  f"sums, RLC sums, scheduler) {rest * 1e3:.2f} ms | {smi}")
    point_sets = {
        "g1": [("the QC window's 150 signatures", sig_pts, sigs),
               ("256 adversarial points", p1, g1s)],
        "g2": [("the QC window's 150 keys", key_pts.to(dev),
                [pubs[v.address] for v in vals]),
               ("256 adversarial points", p2, g2s)],
    }
    return rows, point_sets


# --- the mixed-key path (secp256k1) and the L2 block's merkle leaves --------

SECP_SOURCE = "tendermint_tpu_torch/ops/csrc/secp256k1_kernels.cu"
SHA256_SOURCE = "tendermint_tpu_torch/ops/csrc/sha256_kernels.cu"
# a field multiplication of secp256k1_device.cuh: 16 64x64->128-bit
# products and 5 in the fold, each four 32-bit multiply-adds
IMAD_PER_SECP_MUL = 21 * 4
# field multiplications of a doubling (2M + 5S) and an addition (12M + 4S)
FE_SECP_DBL, FE_SECP_ADD = 7, 16
# SHA-256, per 64-byte block, from ops/csrc/sha256_kernels.cu: 64 rounds of
# ~20 32-bit operations, 48 schedule steps of ~12, 16 word loads of ~7
SHA256_OPS_PER_BLOCK = 64 * 20 + 48 * 12 + 16 * 7


def secp_crafted_rows(host, secp_native, rng):
    """64 rows of the secp256k1 kernel's operands as host integers,
    (Q affine, u1, u2, r, ok_in), and each row's verdict by the JAX
    package's rule: ok_in, R = u1 G + u2 Q not at infinity, and x(R) == r
    or (x(R) >= n and x(R) - n == r). Valid signatures; flipped s, wrong
    message, cross key; ok_in False; Q = G with u1 = u2 (the ladder meets
    P == Q); u2 = n - u1 with Q = G (R at infinity); a point T with
    x(T) >= n as Q with u1 = 0, u2 = 1 (r = x(T) - n takes the wrapped
    branch); the forged wrap r = x(R) - n + 2^256 for x(R) < n; u1 = u2 = 0;
    zero padding rows."""
    n_ord, g = host.N, (host.GX, host.GY)
    keys = [host.PrivKey.from_secret(b"smoke-secp-%d" % i) for i in range(4)]
    pubs = [k.public_key().data for k in keys]
    rows = []

    def signed(pub, msg, sig, ok=True):
        prep = secp_native.prep_digest_item(pub, hashlib.sha256(msg).digest(), sig)
        if prep is None:
            rows.append(((0, 0), 0, 0, 0, False))
        else:
            r, pt, u1, u2 = prep
            rows.append((pt, u1, u2, r, ok))

    for i in range(16):  # valid; for 8 of them flipped s, wrong message, cross key
        msg = b"crafted-%d" % i
        sig = keys[i % 4].sign(msg)
        signed(pubs[i % 4], msg, sig)
        if i < 8:
            signed(pubs[i % 4], msg, sig[:62] + bytes([sig[62] ^ 2]) + sig[63:])
            signed(pubs[i % 4], msg + b"!", sig)
            signed(pubs[(i + 1) % 4], msg, sig)
    for i in range(4):  # valid, but the host pre-checks said no
        msg = b"crafted-ok-%d" % i
        signed(pubs[i], msg, keys[i].sign(msg), ok=False)
    for i in range(4):  # Q = G, u1 = u2: the first add doubles
        u = int.from_bytes(rng.bytes(32), "big") % (n_ord - 1) + 1
        x = host._to_affine(host._jmul(2 * u, (*g, 1)))[0]
        rows.append((g, u, u, x % n_ord + (i % 2), True))
    for _ in range(2):  # u2 = n - u1, Q = G: R at infinity
        u = int.from_bytes(rng.bytes(32), "big") % (n_ord - 1) + 1
        rows.append((g, u, n_ord - u, 1, True))
    xt = n_ord
    while host._lift_x(xt, 0) is None:
        xt += 1
    t_pt = host._lift_x(xt, 0)
    for r in (xt - n_ord, xt, xt - n_ord + 1):
        rows.append((t_pt, 0, 1, r, True))
    q_pt = host.decompress_point(pubs[0])
    assert q_pt[0] < n_ord
    rows.append((q_pt, 0, 1, q_pt[0] - n_ord + (1 << 256), True))  # forged wrap
    rows.append((q_pt, 0, 1, q_pt[0], True))
    rows.append((q_pt, 0, 0, 1, True))  # u1 = u2 = 0
    while len(rows) < 64:
        rows.append(((0, 0), 0, 0, 0, False))
    want = []
    for (qx, qy), u1, u2, r, ok in rows:
        R = host._to_affine(host._jadd(host._jmul(u1, (*g, 1)), host._jmul(u2, (qx, qy, 1))))
        want.append(bool(ok) and R is not None
                    and (R[0] == r or (R[0] >= n_ord and R[0] - n_ord == r)))
    return rows, want


def secp_row_arrays(np, fe, rows):
    """The kernel's operands of host-integer rows: qx, qy [B, 32] int32
    limbs; u1, u2, r [B, 32] uint8 big-endian; ok_in [B] bool."""
    b = len(rows)
    qx = np.zeros((b, 32), np.int32)
    qy = np.zeros((b, 32), np.int32)
    u1 = np.zeros((b, 32), np.uint8)
    u2 = np.zeros((b, 32), np.uint8)
    rb = np.zeros((b, 32), np.uint8)
    ok = np.zeros(b, bool)
    for i, ((x, y), a, c, r, o) in enumerate(rows):
        qx[i], qy[i] = fe.from_int(x), fe.from_int(y)
        for arr, v in ((u1, a), (u2, c), (rb, r)):
            arr[i] = np.frombuffer(v.to_bytes(32, "big"), np.uint8)
        ok[i] = o
    return qx, qy, u1, u2, rb, ok


def secp_fe_muls(u1: int, u2: int) -> int:
    """Field multiplications of tm_secp_verify for one live row with these
    scalars: the table of Q (7 doublings, 7 additions), then the ladder's
    doublings once the accumulator has left the identity and its
    additions of a nonzero digit onto a non-identity accumulator (the
    others return early), then the Z^2 check."""
    muls, started = 7 * FE_SECP_DBL + 7 * FE_SECP_ADD, False
    for k in range(64):
        if started:
            muls += 4 * FE_SECP_DBL
        for s in (u2, u1):
            if (s >> (4 * (63 - k))) & 15:
                muls += FE_SECP_ADD if started else 0
                started = True
    return muls + 3


def run_mixed_window(verifier, vset, chain_id, entries, reps, secp_native):
    """verify_commits_light over the mixed-key window `reps` times, from an
    executor thread through a started VerifyScheduler and
    default_dispatch("blocksync"), each rep's wall split by host timers
    (secp256k1 prep, the secp256k1 route, the ed25519 round, sign-bytes
    assembly); then the window's rows once more for the per-row bitmap.
    Returns (verdicts, walls, splits, bitmap, items, ledger entries)."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import (
        VerifyScheduler, default_dispatch, set_default_scheduler,
    )

    items = [it for _, _, c in entries for it in vset._gather_items(chain_id, c, True)[0]]
    ledger = DispatchLedger()
    sched = VerifyScheduler(verifier=verifier, ledger=ledger,
                            metrics=SchedulerMetrics(Registry("smoke_mixed")))
    verdicts, walls, splits = [], [], []

    async def go():
        await sched.start()
        loop = asyncio.get_running_loop()
        try:
            for _ in range(reps):
                acc = {}
                saved = [
                    (secp_native, timed(secp_native, ("prep_digest_item",), acc)),
                    (verifier, timed(verifier, ("verify", "_verify_secp_device"), acc)),
                    (vset, timed(vset, ("_gather_items",), acc)),
                ]
                try:
                    gc.collect()
                    t0 = time.perf_counter()
                    verdicts.append(await loop.run_in_executor(
                        None,
                        lambda: vset.verify_commits_light(
                            chain_id, entries, verifier=default_dispatch("blocksync")),
                    ))
                    walls.append(time.perf_counter() - t0)
                finally:
                    for obj, s in saved:
                        restore(obj, s)
                splits.append(acc)
            return await loop.run_in_executor(
                None, lambda: default_dispatch("blocksync").verify(items))
        finally:
            await sched.stop()

    set_default_scheduler(sched)
    try:
        bitmap = asyncio.run(go())
    finally:
        set_default_scheduler(None)
    return verdicts, walls, splits, [bool(v) for v in bitmap], items, ledger.entries()


def mixed_phase(torch, np, rng, dev, smi, ops, types, ed_keys, chain_id, heights):
    """Phase 6: the secp256k1 and SHA-256 kernels against their plain
    versions, then the mixed-key commit path (a 150-validator set, every
    third key secp256k1, equal power) per height and over a 64-commit
    blocksync window, the 4,002-leaf L2 block data hash and
    merkle_root_pow2 on the card. Returns the two kernels' rows and the
    secp256k1 kernel's operands at the window's shape (numpy)."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import ed25519 as ed_host
    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.crypto import secp256k1 as host
    from tendermint_tpu_torch.crypto import secp_native
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk
    from tendermint_tpu_torch.ops import sha256 as s2
    from tendermint_tpu_torch.types.block import Data

    assert secp_native.native_lib() is not None, "native secp256k1 library did not build"
    D = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    errs, plain_ms = {}, {}

    # --- kernel vs plain: tm_secp_verify on the 64 crafted rows
    rows, want = secp_crafted_rows(host, secp_native, rng)
    crafted = tuple(D(a) for a in secp_row_arrays(np, sk.fe, rows))
    got = sk.verify_prehashed(*crafted)
    plain = sk.verify_prehashed_plain(*crafted)
    torch.cuda.synchronize()
    errs["secp"] = max_abs_err(got, plain)
    assert errs["secp"] == 0, "tm_secp_verify != plain (crafted rows)"
    assert got.cpu().tolist() == want, "tm_secp_verify != the JAX package's rule (crafted rows)"

    # --- tm_sha256: one-block leaves, the 2-block inner shape, ragged rows
    def sha_check(buf, cnt, msgs, label):
        got = s2.sha256_batch(D(buf), D(cnt))
        plain, ms = time_once(torch, s2.sha256_batch_plain, D(buf), D(cnt))
        err = max_abs_err(got, plain)
        assert err == 0, f"tm_sha256 != plain ({label})"
        assert [bytes(r) for r in got.cpu().numpy()[: len(msgs)]] == [
            hashlib.sha256(m).digest() for m in msgs], f"tm_sha256 != hashlib ({label})"
        errs["sha256"] = max(errs.get("sha256", 0), err)
        return ms

    leaves32 = [rng.bytes(32) for _ in range(4096)]
    buf, cnt = s2.pad_messages(leaves32, prefix=b"\x00")
    sha_check(buf, cnt, [b"\x00" + x for x in leaves32], "one-block leaves")
    pairs = [rng.bytes(64) for _ in range(2048)]
    buf, cnt = s2.pad_messages(pairs, prefix=b"\x01")
    sha_check(buf, cnt, [b"\x01" + x for x in pairs], "2-block inner rows")

    # the L2 block: 4000 transactions of 100-1024 bytes and its two payload
    # leaves, as Data.hash() gives them to the leaf batch: 4002 rows padded
    # to the 4096 bucket, the block axis (17 for the longest) to 32
    txs = [rng.bytes(int(k)) for k in rng.integers(100, 1025, 4000)]
    data = Data(txs=txs, l2_block_meta=rng.bytes(256), l2_batch_header=rng.bytes(128))
    leaves = [b"\x00" + tx for tx in txs] + [b"\x01" + data.l2_block_meta,
                                              b"\x02" + data.l2_batch_header]
    msgs = leaves + [b""] * (4096 - len(leaves))
    leaf_buf, leaf_cnt = s2.pad_messages(msgs, prefix=b"\x00")
    nblk = leaf_buf.shape[1] // 64
    leaf_buf = np.pad(leaf_buf, ((0, 0), (0, ((1 << (nblk - 1).bit_length()) - nblk) * 64)))
    plain_ms["sha256"] = sha_check(leaf_buf, leaf_cnt, [b"\x00" + x for x in msgs],
                                   "the leaf batch")
    print(f"kernel-vs-plain: secp_verify_prehashed on 64 crafted rows (valid, flipped "
          f"s, wrong message, cross key, ok_in False, Q = G with u1 = u2, R at "
          f"infinity, x(T) >= n direct and wrapped, the forged wrap, u1 = u2 = 0, "
          f"padding: {sum(want)} accepted) and sha256_batch on {len(leaves32)} "
          f"one-block rows, {len(pairs)} 2-block rows and the leaf batch "
          f"{tuple(leaf_buf.shape)} (ragged n_blocks) equal their plain versions "
          f"(tolerance: exact), the JAX package's rule and hashlib")

    # --- the mixed-key set: every third validator holds a secp256k1 key
    t0 = time.perf_counter()
    signers = [host.PrivKey.from_secret(rng.bytes(32)) if i % 3 == 2 else k
               for i, k in enumerate(ed_keys)]
    vset = types.ValidatorSet([types.Validator(s.public_key(), 10) for s in signers])
    by_addr = {s.public_key().address(): s for s in signers}
    n_vals = len(vset.validators)
    is_secp = [v.pub_key.type_name == "secp256k1" for v in vset.validators]
    n_secp = sum(is_secp)

    def commit_at(height):
        bid = types.BlockID(hash=rng.bytes(32), part_set_header=types.PartSetHeader(
            total=1, hash=rng.bytes(32)))
        sigs = [types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                                1_700_000_000_000_000_000 + height * 10**9 + i)
                for i, v in enumerate(vset.validators)]
        commit = types.Commit(height, 0, bid, sigs)
        for i, v in enumerate(vset.validators):
            sigs[i].signature = by_addr[v.address].sign(commit.vote_sign_bytes(chain_id, i))
        return bid, commit

    commits = [commit_at(h) for h in range(1, heights + 2)]
    entries, tampered = signed_window(None, types, vset, by_addr, chain_id, WINDOW,
                                      QC_BAD, rng)
    setup_s = time.perf_counter() - t0
    assert {is_secp[i] for i in tampered} == {True, False}

    os.environ["TM_TPU_SECP_DEVICE"] = "1"  # the JAX package's gate, on
    try:
        # --- per height, through the process verifier on the card
        verifier = bv.default_verifier()
        ops.reset_launches()
        commit_ms = []
        for h, (bid, commit) in enumerate(commits[:heights], start=1):
            t0 = time.perf_counter()
            vset.verify_commit(chain_id, bid, h, commit)
            commit_ms.append((time.perf_counter() - t0) * 1e3)
        bid, commit = commits[-1]
        bad_i = max(i for i in range(n_vals) if is_secp[i])
        sig = commit.signatures[bad_i].signature
        commit.signatures[bad_i].signature = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
        try:
            vset.verify_commit(chain_id, bid, heights + 1, commit)
        except ValueError as e:
            assert str(e) == f"wrong signature at index {bad_i}", e
        else:
            raise AssertionError("tampered mixed-key commit verified")
        torch.cuda.synchronize()
        height_launches = ops.kernel_launches()
        for name in ("verify_prehashed_table", "secp_verify_prehashed"):
            assert height_launches[name] > 0, f"{name} was not launched per height"
        print(f"main path: mixed verify_commit x{heights} at {n_vals} validators "
              f"({n_vals - n_secp} ed25519, {n_secp} secp256k1, TM_TPU_SECP_DEVICE=1) "
              f"ok; tampered secp256k1 index {bad_i} rejected; launches "
              f"{json.dumps({k: v for k, v in height_launches.items() if v})}")

        # --- the blocksync window, twice
        wverifier = bv.BatchVerifier(shape_registry=ShapeRegistry())
        ops.reset_launches()
        verdicts, walls, splits, bitmap, items, ledger = run_mixed_window(
            wverifier, vset, chain_id, entries, 2, secp_native)
        torch.cuda.synchronize()
        win_launches = ops.kernel_launches()
    finally:
        del os.environ["TM_TPU_SECP_DEVICE"]
    for name in ("neg_pubkey_bigtable", "verify_prehashed_bigcache", "secp_verify_prehashed"):
        assert win_launches[name] > 0, f"{name} was not launched on the mixed window"
    want_v = [h != QC_BAD for h in range(1, WINDOW + 1)]
    assert all(v == want_v for v in verdicts), verdicts
    bad_rows = {(QC_BAD - 1) * n_vals + i for i in tampered}
    assert [i for i, ok in enumerate(bitmap) if not ok] == sorted(bad_rows)
    secp_rows = [i for i, it in enumerate(items) if it.key_type == "secp256k1"]
    secp_items = [items[i] for i in secp_rows]
    assert len(secp_rows) == WINDOW * n_secp
    # the native host route over the same rows: the yardstick, and the
    # same verdicts
    t0 = time.perf_counter()
    native = secp_native.verify_msgs_batch(
        [it.pubkey for it in secp_items], [it.msg for it in secp_items],
        [it.sig for it in secp_items])
    native_s = time.perf_counter() - t0
    assert native == [bitmap[i] for i in secp_rows], "secp256k1 rows: kernel != native route"
    for i in rng.choice(len(items), size=256, replace=False):
        it = items[int(i)]
        key = host.PubKey(it.pubkey) if it.key_type == "secp256k1" else ed_host.PubKey(it.pubkey)
        assert bitmap[int(i)] == key.verify(it.msg, it.sig), i
    tiers = wverifier._registry.buckets_by_tier()
    rounds = [e for e in ledger if e["engine"] == "sig"]
    assert len(rounds) == 3 and all(e["rows"] == {"blocksync": len(items)} for e in rounds)
    b_secp = wverifier._registry.bucket_for(len(secp_rows))
    print(f"main path: mixed window: {WINDOW} commits x {n_vals} validators = "
          f"{len(items)} rows ({len(items) - len(secp_rows)} ed25519, "
          f"{len(secp_rows)} secp256k1 padded to {b_secp}), "
          f"tiers {json.dumps({k: list(v) for k, v in tiers.items()})}; verdicts "
          f"[True]*{QC_BAD - 1} + [False] + [True]*{WINDOW - QC_BAD} x2 (commit "
          f"{QC_BAD}: {len(tampered)} tampered signatures, ed25519 and "
          f"secp256k1); bitmap False on exactly those rows; secp256k1 rows = "
          f"the native host route; 256-row sample = host oracles; launches "
          f"{json.dumps({k: v for k, v in win_launches.items() if v})}")

    # --- the L2 block's data hash: the 4,002 leaves on the card (the
    # commit hash's 150 leaves stay under the gate, on the host)
    host_root = merkle.hash_from_byte_slices(leaves)
    merkle.DEVICE_LEAF_MIN = 1024
    ops.reset_launches()
    pad_acc = {}
    saved = timed(s2, ("pad_messages",), pad_acc)
    try:
        gc.collect()
        t0 = time.perf_counter()
        card_root = data.hash()
        card_s = time.perf_counter() - t0
        assert len(commits[0][1].hash()) == 32
    finally:
        restore(s2, saved)
        merkle.DEVICE_LEAF_MIN = 0
    torch.cuda.synchronize()
    data_launches = ops.kernel_launches()["sha256_batch"]
    assert data_launches == 1, data_launches
    assert card_root == host_root, "Data.hash() on the card != the host tree"
    t0 = time.perf_counter()
    assert merkle.hash_from_byte_slices(leaves) == host_root
    hashlib_s = time.perf_counter() - t0
    # merkle_root_pow2: 4096 leaves of 32 bytes, one leaf and 12 inner levels
    ops.reset_launches()
    root = s2.merkle_root_pow2(D(np.array(leaves32, dtype="S32").view(np.uint8).reshape(-1, 32)))
    torch.cuda.synchronize()
    root_launches = ops.kernel_launches()["sha256_batch"]
    assert root_launches == 13, root_launches
    assert bytes(root.cpu().numpy()) == merkle.hash_from_byte_slices(leaves32)
    print(f"main path: Data.hash() of {len(txs)} transactions + 2 L2 leaves "
          f"(TM_TPU_DEVICE_MERKLE_MIN=1024) on the card = the host tree, "
          f"{data_launches} launch; merkle_root_pow2 over {len(leaves32)} leaves "
          f"= the host tree, {root_launches} launches")

    # --- the secp256k1 kernel at the window's shape: its rows padded on the
    # ladder, prepared as _verify_secp_device prepares them
    w_rows = []
    for it in secp_items:
        r, pt, a, c = secp_native.prep_digest_item(
            it.pubkey, hashlib.sha256(it.msg).digest(), it.sig)
        w_rows.append((pt, a, c, r, True))
    live_muls = sum(secp_fe_muls(a, c) for _, a, c, _, _ in w_rows)
    w_rows += [((0, 0), 0, 0, 0, False)] * (b_secp - len(w_rows))
    w_arrays = secp_row_arrays(np, sk.fe, w_rows)
    w_args = tuple(D(a) for a in w_arrays)
    got = sk.verify_prehashed(*w_args)
    plain, plain_ms["secp"] = time_once(torch, sk.verify_prehashed_plain, *w_args)
    err = max_abs_err(got, plain)
    assert err == 0, f"tm_secp_verify != plain at ({b_secp},)"
    errs["secp"] = max(errs["secp"], err)
    assert got.cpu().tolist()[: len(secp_items)] == native
    # the same rows through the whole device route and the native route
    t0 = time.perf_counter()
    assert wverifier._verify_secp_device(secp_items).tolist() == native
    route_s = time.perf_counter() - t0
    print(f"kernel-vs-plain: secp_verify_prehashed at the window's shape ({b_secp} rows, "
          f"{len(secp_items)} live) equals its plain version (tolerance: exact)")

    leaf_d, leaf_cnt_d = D(leaf_buf), D(leaf_cnt)
    work = {
        "secp_verify_prehashed": (
            lambda: sk.verify_prehashed(*w_args),
            len(secp_items) * (2 * 128 + 3 * 32 + 1) + b_secp + 16 * 3 * 32,
            live_muls * IMAD_PER_SECP_MUL,
            "tendermint_tpu/ops/secp256k1_kernel.py:161", SECP_SOURCE,
        ),
        "sha256_batch": (
            lambda: s2.sha256_batch(leaf_d, leaf_cnt_d),
            int(leaf_cnt.sum()) * 64 + 4 * len(leaf_cnt) + 32 * len(leaf_cnt),
            int(leaf_cnt.sum()) * SHA256_OPS_PER_BLOCK,
            "tendermint_tpu/ops/sha256.py:159", SHA256_SOURCE,
        ),
    }
    launches = {
        "secp_verify_prehashed": height_launches["secp_verify_prehashed"]
        + win_launches["secp_verify_prehashed"],
        "sha256_batch": data_launches + root_launches,
    }
    out_rows = []
    for name, (kern, nbytes, n_ops, replaces, source) in work.items():
        short = "secp" if name.startswith("secp") else "sha256"
        ms = time_cuda(torch, kern, 20)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        out_rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[short], "ms": ms,
            "plain_ms": plain_ms[short], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms[short]:.2f} ms "
              f"(one call) bound {b_ms:.5f} ms ({b_by}); launches {launches[name]} | {smi}")
    print(f"time: mixed set-up {setup_s:.1f} s ({heights + 1} heights and the "
          f"{WINDOW}-commit window signed on the host, {n_secp} secp256k1 keys) | {smi}")
    print(f"time: mixed verify_commit ms per height "
          f"{[round(x, 3) for x in commit_ms]} | {smi}")
    print(f"time: secp256k1 rows of the window ({len(secp_items)}): native host route "
          f"{native_s * 1e3:.2f} ms (one CPU thread, prep included); device route "
          f"(_verify_secp_device: prep, copies, tm_secp_verify) {route_s * 1e3:.2f} ms | {smi}")
    labels = (("prep_digest_item", "secp256k1 host prep"), ("_verify_secp_device", None),
              ("verify", "ed25519 round"), ("_gather_items", "sign-bytes assembly"))
    for rep, (wall, acc) in enumerate(zip(walls, splits), start=1):
        prep = acc.get("prep_digest_item", 0.0)
        kern = acc.get("_verify_secp_device", 0.0) - prep
        rest = wall - acc.get("_verify_secp_device", 0.0) - acc.get("verify", 0.0) \
            - acc.get("_gather_items", 0.0)
        parts = ", ".join(f"{lab} {acc.get(k, 0.0) * 1e3:.2f} ms"
                          for k, lab in labels if lab)
        print(f"time: mixed window {rep}: wall {wall * 1e3:.2f} ms, "
              f"{WINDOW / wall:.1f} commits/s; {parts}; secp256k1 kernel with its "
              f"array fills and copies {kern * 1e3:.2f} ms; rest (tally, "
              f"scheduler) {rest * 1e3:.2f} ms | {smi}")
    pad_s = pad_acc.get("pad_messages", 0.0)
    print(f"time: L2 block data hash ({len(leaves)} leaves): card {card_s * 1e3:.2f} ms "
          f"(pad_messages {pad_s * 1e3:.2f} ms, the rest {(card_s - pad_s) * 1e3:.2f} ms: "
          f"copies, tm_sha256, the host fold); hashlib {hashlib_s * 1e3:.2f} ms | {smi}")
    return out_rows, w_arrays


# --- the in-process consensus net --------------------------------------------


def committee_config(cls, n: int, **fields):
    """Static timeouts generous enough that a host-bound in-process
    committee never advances rounds on verify latency (the committee-scale
    configuration of the JAX package's benchmark); skip_timeout_commit."""
    scale = 1.0 + n / 25.0
    cfg = cls(timeout_propose=10.0 * scale, timeout_propose_delta=2.0,
              timeout_prevote=10.0 * scale, timeout_prevote_delta=2.0,
              timeout_precommit=10.0 * scale, timeout_precommit_delta=2.0,
              timeout_commit=0.05, skip_timeout_commit=True)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def run_net(torch, ops, seed: int, n_vals: int, heights: int, qc: bool):
    """One n_vals-validator net in this process, wired with the full-mesh
    broadcast hook, every node KVStoreApplication through LocalClient,
    MemKV stores, MockL2Node and MockPV, all on the process verifier (the
    card) behind one started VerifyScheduler as the process default. With
    `qc`: quorum certificates on, a BLS key per validator, batch points
    every 2 blocks with the L2 mock's registry verifier. Runs to
    heights + 1 and returns what the checks and the report need."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig, ConsensusState
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.crypto.bls12_381 import R
    from tendermint_tpu_torch.l2node.mock import MockL2Node
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.priv_validator import MockPV

    tag = b"%d-%s" % (seed, b"qc" if qc else b"legacy")
    pvs = [MockPV.from_secret(tag + b"-%d" % i) for i in range(n_vals)]
    scalars = [int.from_bytes(hashlib.sha256(tag + b"-bls%d" % i).digest(), "big")
               % (R - 1) + 1 for i in range(n_vals)]
    registry = bls.BLSKeyRegistry()
    gvals = []
    for pv, k in zip(pvs, scalars):
        bls_key = b""
        if qc:
            pub = bls.pubkey_from_priv(k)  # a native proof-of-possession check
            registry.register(pv.get_pub_key().data, pub)
            bls_key = bls.g2_to_bytes(pub.key)
        gvals.append(GenesisValidator("ed25519", pv.get_pub_key().data, 10,
                                      bls_pub_key=bls_key))
    genesis = GenesisDoc(chain_id="smoke-net", genesis_time_ns=1_700_000_000 * 10**9,
                         validators=gvals)
    genesis.validate_and_complete()
    config = committee_config(ConsensusConfig, n_vals, quorum_certificates=qc)
    nodes = []
    for pv, k in zip(pvs, scalars):
        l2 = (MockL2Node(batch_blocks_interval=2, bls_verifier=registry.verifier())
              if qc else MockL2Node())
        state = State.from_genesis(genesis)
        state_store = StateStore(MemKV())
        state_store.bootstrap(state)
        block_store = BlockStore(MemKV())
        executor = BlockExecutor(state_store, block_store,
                                 LocalClient(KVStoreApplication()), l2)
        executor.qc_enabled = qc
        cs = ConsensusState(config, state, executor, block_store, l2, priv_validator=pv,
                            bls_signer=bls.signer_for(k) if qc else None)
        nodes.append((cs, l2, block_store))
    css = [n[0] for n in nodes]
    for i, n in enumerate(css):
        def hook(msg, i=i):
            for j, other in enumerate(css):
                if j != i:
                    other.peer_msg_queue.put_nowait((msg, f"node{i}"))

        n.broadcast_hook = hook
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(
        Registry(f"smoke_net_{int(qc)}")))
    marks = []
    # CUDA events around every kernel wrapper call of the net, recorded
    # just before the call and just after it returns, before the verdict
    # copy: the card's time for the wrapper's work, host launch gaps
    # between the events included (an upper bound on busy time). The
    # ledger's device_s is a host clock around the whole round, GIL waits
    # behind the nodes' event loop included. The verifier's _dispatch is
    # wrapped, not the kernel wrappers, whose launch counters are their
    # module globals. Every small-tier round's inputs and verdicts are
    # kept (cloned) for the check against the plain version.
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier

    verifier = default_verifier()
    events = []
    kept = {}
    dispatch = verifier._dispatch

    def evented_dispatch(fn, tier, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        operands = []

        def evented(*a):
            start.record()
            got = fn(*a)
            end.record()
            operands.append(a)
            return got

        out = dispatch(evented, tier, *args, **kw)
        events.append((tier, start, end))
        if tier == "small":
            (a,) = operands  # one device: one launch
            kept.setdefault("small", []).append(([t.clone() for t in a], out.copy()))
        return out

    async def drive():
        await sched.start()
        for cs in css:
            await cs.start()
        marks.append(time.perf_counter())
        try:
            for h in range(1, heights + 2):
                await asyncio.gather(*(cs.wait_for_height(h, timeout=180) for cs in css))
                marks.append(time.perf_counter())
        finally:
            for cs in css:
                await cs.stop()
            await sched.stop()

    # where the host time goes: single-vote checks (on the event loop,
    # serial across nodes), LastCommit validation (executor threads,
    # scheduler waits included) and apply_block (awaits included)
    splits = {}
    saved_cs = timed(ConsensusState, ("_verify_vote",), splits)
    saved_ex = timed(BlockExecutor, ("validate_block",), splits)
    saved_ex.update(timed_async(BlockExecutor, "apply_block", splits))
    gc.collect()
    ops.reset_launches()
    set_default_scheduler(sched)
    verifier._dispatch = evented_dispatch
    try:
        asyncio.run(drive())
    finally:
        set_default_scheduler(None)
        del verifier._dispatch  # the instance attribute: the method shows again
        restore(ConsensusState, saved_cs)
        restore(BlockExecutor, saved_ex)
    torch.cuda.synchronize()
    kernel_ms = {}
    for name, start, end in events:
        kernel_ms[name] = kernel_ms.get(name, 0.0) + start.elapsed_time(end)
    return {"nodes": nodes, "pvs": pvs, "launches": ops.kernel_launches(),
            "ledger": ledger.entries(), "marks": marks, "kernel_ms": kernel_ms,
            "splits": splits, "kept": kept,
            "min_batch": css[0].verifier._min_device_batch}


def consensus_phase(torch, ops, host, smi, seed: int, n_vals: int, heights: int):
    """Phase 7: the live net, legacy commits (mode a) and QC heights with
    batch-point BLS dual-signing (mode b, the pairing gate unset). Checks
    agreement, the LastCommit signatures against the host oracle, the
    ledger's consensus rounds and the launch counts, and holds every
    small-tier LastCommit round, at the shape it was dispatched, against
    the plain version (the first also with one row's challenge flipped);
    prints the walls. Returns the launches of both modes,
    summed per kernel, and that check's max_abs_err per kernel."""
    from tendermint_tpu_torch.ops import ed25519_batch as ed

    assert os.environ.get(BLS_GATE) is None
    bls_kernels = ("g1_aggregate", "g2_aggregate", "miller", "final_exp")
    total, errs = {}, {}
    for mode, qc in (("legacy", False), ("qc", True)):
        r = run_net(torch, ops, seed, n_vals, heights, qc)
        nodes, launches, ledger = r["nodes"], r["launches"], r["ledger"]
        bs0 = nodes[0][2]
        pubs = {pv.get_pub_key().address(): pv.get_pub_key().data for pv in r["pvs"]}
        for h in range(1, heights + 2):
            hashes = {n[2].load_block(h).hash() for n in nodes}
            assert len(hashes) == 1, f"{mode}: nodes disagree on block {h}"
        for h in range(2, heights + 2):  # each header carries the app hash of h - 1
            blk = bs0.load_block(h)
            assert len({n[2].load_block(h).header.app_hash for n in nodes}) == 1
            commit = blk.last_commit
            bitmap = [host.verify(pubs[cs.validator_address],
                                  commit.vote_sign_bytes(blk.header.chain_id, i),
                                  cs.signature)
                      for i, cs in enumerate(commit.signatures) if not cs.is_absent()]
            assert all(bitmap) and 3 * len(bitmap) > 2 * n_vals, (mode, h, bitmap)
        rounds = [e for e in ledger if "consensus" in e["rows"]]
        sig_rounds = [e for e in rounds if e["engine"] == "sig"
                      and e["requested"] >= r["min_batch"]]
        qc_rounds = [e for e in rounds if e["engine"] == "qc_verify"]
        for name in bls_kernels:
            assert launches[name] == 0, f"{mode}: {name} launched with the gate unset"
        if qc:
            l2 = nodes[0][1]
            points = [h for h in range(1, heights + 2) if bs0.load_block(h).header.batch_hash]
            assert points and l2.committed_batches, "qc: no batch point sealed"
            assert all(datas for _, datas in l2.committed_batches), "qc: batch without BLS data"
            carried = [h for h in range(2, heights + 2) if bs0.load_block(h).last_qc]
            assert carried, "qc: no block carried a QC"
            assert len(rounds) >= heights, (mode, rounds)
        else:
            assert len(sig_rounds) >= heights, (mode, ledger)
            for name in ("neg_pubkey_table", "verify_prehashed_table"):
                assert launches[name] > 0, f"{name} was not launched on the live net"
            if any(e["dispatched"] >= 512 for e in sig_rounds):
                for name in ("neg_pubkey_bigtable", "verify_prehashed_bigcache"):
                    assert launches[name] > 0, f"{name} was not launched on the live net"
            # every small-tier round, as the net dispatched it, against the
            # plain version: the verdicts the net got are the kernel's
            rounds_err = 0
            for k_args, k_seen in r["kept"]["small"]:
                k_plain = ed.verify_prehashed_table_plain(*k_args)
                rounds_err = max(rounds_err,
                                 max_abs_err(torch.from_numpy(k_seen), k_plain))
            assert rounds_err == 0, "a small-tier round of the net != plain"
            n_kept = len(r["kept"]["small"])
            # the first again, launched here, and with row 0's challenge
            # flipped (every signature of the net is valid, so this is the
            # rejecting case)
            args, seen = r["kept"]["small"][0]
            n_rows = int(args[2].shape[0])
            assert seen[0], "first LastCommit round rejected its row 0"
            got = ed.verify_prehashed_table(*args)
            plain = ed.verify_prehashed_table_plain(*args)
            err = max(max_abs_err(got, plain),
                      max_abs_err(got, torch.from_numpy(seen)))
            bad_k = args[5].clone()
            bad_k[0, 0] ^= 1
            bad = args[:5] + [bad_k] + args[6:]
            got_bad = ed.verify_prehashed_table(*bad)
            plain_bad = ed.verify_prehashed_table_plain(*bad)
            err = max(err, max_abs_err(got_bad, plain_bad))
            assert err == 0, "verify_prehashed_table != plain on the net's round"
            assert not bool(got_bad[0]) and torch.equal(got_bad[1:].cpu(), got[1:].cpu()), \
                "the flipped challenge was not rejected alone"
            errs["verify_prehashed_table"] = max(err, rounds_err)
            print(f"kernel-vs-plain: verify_prehashed_table on all {n_kept} of "
                  f"the net's small-tier LastCommit rounds as dispatched: the "
                  f"verdicts the net got equal the plain version; the first "
                  f"({n_rows} rows over a store of {int(args[0].shape[0])} key "
                  f"tables; {int(seen.sum())} accepted) launched again, and with "
                  f"row 0's challenge flipped: equal to its plain version and to "
                  f"the verdicts the net got (tolerance: exact); the flipped row "
                  f"alone rejected")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        marks = r["marks"]
        walls = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        wall = marks[-1] - marks[0]
        sig_all = [e for e in rounds if e["engine"] == "sig"]
        device_s = sum(e["device_s"] for e in sig_rounds)
        prep_s = sum(e["host_prep_s"] for e in sig_rounds)
        oracle_s = sum(e["device_s"] for e in sig_all) - device_s
        qc_s = sum(e["device_s"] for e in qc_rounds)
        desc = ("quorum certificates, batch points every 2 blocks with BLS "
                "dual-signing through the registry verifier (pairing gate unset)"
                if qc else "legacy commits")
        extra = (f"; batch points at heights {points}, {len(l2.committed_batches)} "
                 f"batches committed to the L2 with {[len(d) for _, d in l2.committed_batches]} "
                 f"BLS datas; QCs carried by blocks {carried}" if qc else "")
        print(f"main path: consensus net ({mode}): {n_vals} validators in one "
              f"process, {desc}; {heights + 1} heights committed by every node, "
              f"same block (and app hash) on every node at every height; every "
              f"stored LastCommit signature true by the host oracle{extra}; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
        print(f"main path: consensus net ({mode}): {len(sig_all)} consensus-class "
              f"signature rounds, {len(sig_rounds)} of them from min_device_batch "
              f"({r['min_batch']}) rows up; rows per round "
              f"{[e['requested'] for e in sig_all]}; buckets "
              f"{[e['dispatched'] for e in sig_all]}; {len(qc_rounds)} qc_verify "
              f"rounds ({sum(e['requested'] for e in qc_rounds)} certificates, "
              f"native host pairing)")
        busy = sum(r["kernel_ms"].values()) / 1e3
        print(f"time: consensus net ({mode}) ms per height {[round(w, 1) for w in walls]} "
              f"(first height, then steady); wall {wall * 1e3:.1f} ms; verify "
              f"kernel wrapper calls on the card by tier (CUDA events around "
              f"the call, before the verdict copy; launch gaps included) "
              f"{json.dumps({k: round(v, 3) for k, v in r['kernel_ms'].items()})} ms, "
              f"device busy share at most {busy / wall:.5f}, idle share at "
              f"least {1 - busy / wall:.5f}; ledger (host clocks, GIL waits included): "
              f"signature rounds from min_device_batch rows device_s "
              f"{device_s * 1e3:.2f} ms + host prepare {prep_s * 1e3:.2f} ms, "
              f"smaller signature rounds (host oracle) {oracle_s * 1e3:.2f} ms, "
              f"qc_verify rounds (host) {qc_s * 1e3:.2f} ms | {smi}")
        sp = r["splits"]
        per = n_vals * (heights + 1)  # node-heights
        print(f"time: consensus net ({mode}) host split: single-vote checks "
              f"(host oracle, on the event loop) {sp.get('_verify_vote', 0.0) * 1e3:.1f} "
              f"ms = {sp.get('_verify_vote', 0.0) / wall:.3f} of the wall; "
              f"LastCommit validation (executor threads, scheduler waits "
              f"included) {sp.get('validate_block', 0.0) * 1e3:.1f} ms summed, "
              f"{sp.get('validate_block', 0.0) * 1e3 / per:.2f} ms per node-height; "
              f"apply_block (awaits included) {sp.get('apply_block', 0.0) * 1e3:.1f} "
              f"ms summed, {sp.get('apply_block', 0.0) * 1e3 / per:.2f} ms per "
              f"node-height | {smi}")
        del r, nodes
        gc.collect()
    return total, errs


# --- the multi-device path: a mesh of shards ---------------------------------

# shards of the mesh phase: the JAX tests' mesh size (tests/conftest.py)
MESH_SHARDS = 8


def counted(torch, ops, acc, fn, *args):
    """fn(*args) with the launch counts set to 0 just before and read just
    after (the card synchronised); they are added to acc."""
    ops.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    for name, n in ops.kernel_launches().items():
        acc[name] = acc.get(name, 0) + n
    return out


def sharded_sums(torch, ops, mesh, point_sets, acc, errs, label) -> None:
    """Kernel 13 (g1/g2_aggregate_sharded) over `mesh` at three sizes,
    held against its plain version (the same schedule on the CPU, byte
    for byte) and the host sum (affine)."""
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.ops import bls_g1, bls_g2

    groups = {
        "g1": (bls_g1.g1_aggregate_sharded, bls_g1.g1_aggregate_sharded_plain,
               bls_g1.g1_to_host, c.g1_add, c.G1_INF, c.g1_eq),
        "g2": (bls_g2.g2_aggregate_sharded, bls_g2.g2_aggregate_sharded_plain,
               bls_g2.g2_to_host, c.g2_add, c.G2_INF, c.g2_eq),
    }
    sizes = []
    for g, (kern, plain, to_host, add, inf, eq) in groups.items():
        first = point_sets[g][0]
        cases = point_sets[g] + [("5 points (fewer than the shards)",
                                  first[1][:5], first[2][:5])]
        for what, pts, host_pts in cases:
            got = counted(torch, ops, acc, kern, pts, mesh)
            err = max_abs_err(got, plain(pts.cpu(), mesh))
            errs[g + "_add"] = max(errs.get(g + "_add", 0), err)
            assert err == 0, f"{g}_aggregate_sharded != plain ({what}, {label})"
            want = inf
            for p in host_pts:
                want = add(want, p)
            assert eq(to_host(got), want), f"{g}_aggregate_sharded != host ({what}, {label})"
            sizes.append(f"{g} {what}")
    print(f"kernel-vs-plain: {label}: g1/g2_aggregate_sharded equal their plain "
          f"versions (the schedule on the CPU; tolerance: exact bytes) and the "
          f"host sums (affine) on {'; '.join(sizes)}")


def mesh_window(torch, ops, host, rng, acc, verifier, vset, chain_id, entries,
                tampered, bad_height, one, reps, label, shards):
    """The blocksync window through a started VerifyScheduler over a mesh
    verifier: run_window's checks, plus the verdicts and the per-row
    bitmap equal to the 1-device run's (`one`, byte for byte), every round
    stamped with the mesh's shards and sharded, and the scheduler's
    verify_mesh_devices gauge reading them. Returns the walls and the
    round's launches."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics

    metrics = SchedulerMetrics(Registry("smoke_" + label))
    ops.reset_launches()
    verdicts, walls, _, bitmap, items, ledger = run_window(
        verifier, vset, chain_id, entries, reps, label, metrics)
    torch.cuda.synchronize()
    counts = ops.kernel_launches()
    for name, n in counts.items():
        acc[name] = acc.get(name, 0) + n
    check_window(host, verdicts, bitmap, items, ledger, len(entries), bad_height,
                 tampered, len(vset.validators), rng, label)
    assert verdicts == one["verdicts"], f"{label}: verdicts != the 1-device window's"
    assert bitmap == one["bitmap"], f"{label}: bitmap != the 1-device window's"
    b = verifier._registry.bucket_for(len(items), multiple_of=shards)
    for e in ledger:
        assert e["devices"] == shards and e["sharded"] and e["dispatched"] == b, e
    assert metrics.mesh_devices.value() == shards, metrics.mesh_devices.value()
    return walls, {k: n for k, n in counts.items() if n}


def mesh_phase(torch, np, rng, dev, smi, ops, host, vset, chain_id, entries,
               tampered, bad_height, bulk, g_items, point_sets, secp_arrays):
    """Phase 8: the multi-device path over MESH_SHARDS shards on `dev`,
    then over every card where there are two or more. Returns the rows of
    the butterfly add kernels and the path's launches per kernel."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.ops import bls_g1, bls_g2
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk
    from tendermint_tpu_torch.parallel import build_mesh
    from tendermint_tpu_torch.parallel.mesh import Mesh, shard_rows

    mesh = Mesh([dev] * MESH_SHARDS)
    acc, errs = {}, {}
    label = f"mesh of {MESH_SHARDS} shards on {mesh.devices.flat[0]}"

    # --- kernel 13 at three sizes, against its plain version and the host
    sharded_sums(torch, ops, mesh, point_sets, acc, errs, label)

    # --- the blocksync window on the mesh, host- and card-hashed and MXU
    m_host = bv.BatchVerifier(mesh=mesh, shape_registry=ShapeRegistry())
    m_dev = bv.BatchVerifier(mesh=mesh, device_challenge_min=2048,
                             shape_registry=ShapeRegistry())
    os.environ["TM_TPU_MXU_GATHER"] = "1"
    m_mxu = bv.BatchVerifier(mesh=mesh, shape_registry=ShapeRegistry())
    del os.environ["TM_TPU_MXU_GATHER"]
    n_rows = len(entries) * len(vset.validators)
    walls = {}
    for name, verifier, reps, path_kernels in (
        ("host_hash", m_host, 2, ("neg_pubkey_bigtable", "verify_prehashed_bigcache")),
        ("device_hash", m_dev, 2, ("challenge_batch", "verify_prehashed_bigcache")),
        ("mxu_gather", m_mxu, 1, ("verify_prehashed_bigcache_mxu",)),
    ):
        if verifier is not m_host:
            verifier._big = m_host._big  # the window's tables, built once
        walls[name], counts = mesh_window(
            torch, ops, host, rng, acc, verifier, vset, chain_id, entries, tampered,
            bad_height, bulk[name], reps, "mesh_" + name, MESH_SHARDS)
        for k in path_kernels:
            assert counts.get(k, 0) >= MESH_SHARDS, f"{k} not launched per shard ({name})"
        print(f"main path: mesh bulk {name}: {len(entries)} commits x "
              f"{len(vset.validators)} validators = {n_rows} rows over {label}, "
              f"bucket {m_host._registry.bucket_for(n_rows, MESH_SHARDS)} "
              f"({m_host._registry.bucket_for(n_rows, MESH_SHARDS) // MESH_SHARDS} rows a "
              f"shard); verdicts and per-row bitmap = the 1-device window's x{reps}; "
              f"rounds stamped devices={MESH_SHARDS}, sharded; verify_mesh_devices "
              f"gauge {MESH_SHARDS}; launches {json.dumps(counts)}")

    # a 150-row round, below mesh_min_rows, stays on one device
    ops.reset_launches()
    verdicts, _, _, bitmap, items, ledger = run_window(
        m_host, vset, chain_id, entries[:1], 1, "mesh_one_commit")
    torch.cuda.synchronize()
    one_commit = {k: n for k, n in ops.kernel_launches().items() if n}
    for k, n in one_commit.items():
        acc[k] = acc.get(k, 0) + n
    assert verdicts == [[True]] and all(bitmap), verdicts
    assert bitmap == bulk["host_hash"]["bitmap"][: len(items)]
    for e in ledger:
        assert e["devices"] == 1 and not e["sharded"] and e["rows"] == {
            "blocksync": len(items)}, e
    assert one_commit.get("neg_pubkey_table", 0) == MESH_SHARDS, one_commit
    print(f"main path: mesh one commit ({len(items)} rows, below mesh_min_rows "
          f"{m_host._mesh_min_rows}): rounds stamped devices=1 on the small tier; "
          f"its table build sharded; launches {json.dumps(one_commit)}")

    # the small and generic families sharded (mesh_min_rows=1): the commit
    # round of phase 3 with its tampered row
    want = [host.verify(it.pubkey, it.msg, it.sig) for it in g_items]
    solo = bv.BatchVerifier(shape_registry=ShapeRegistry(), device=dev).verify(
        g_items).tolist()
    assert solo == want
    for tier, kw in (("small", {}), ("generic", {"table_cache_capacity": 64})):
        v = bv.BatchVerifier(mesh=mesh, mesh_min_rows=1, shape_registry=ShapeRegistry(), **kw)
        prep = v.prepare(g_items)
        assert prep.devices == MESH_SHARDS
        got = counted(torch, ops, acc, prep.run).tolist()
        assert got == want, f"sharded {tier} round != host oracle"
        (shape,) = v._registry.shapes_by_tier()[tier]
        assert shape[2] == MESH_SHARDS, shape
    print(f"main path: the {len(g_items)}-row commit round (one tampered row) "
          f"sharded over {label} on the small tier and the generic kernel "
          f"(mesh_min_rows=1) = the host oracle = the 1-device verifier")

    # prewarm_buckets on the mesh verifier: both device variants where the
    # ladder lets them
    entries_pw = counted(torch, ops, acc, m_host.prewarm_buckets)
    variants = {}
    for e in entries_pw:
        variants.setdefault(e["bucket"], set()).add(e["devices"])
    ladder = m_host._registry.ladder
    for i, b in enumerate(ladder):
        prev = ladder[i - 1] if i else 0
        want_v = {d for d, ok in ((1, prev + 1 < m_host._mesh_min_rows),
                                  (MESH_SHARDS, b >= m_host._mesh_min_rows)) if ok}
        assert variants[b] == want_v, (b, variants)
    assert any(len(v) == 2 for v in variants.values()), variants
    print(f"main path: prewarm_buckets on the mesh verifier (rungs {list(ladder)}, "
          f"mesh_min_rows {m_host._mesh_min_rows}): {json.dumps(entries_pw)}")

    # the sharded secp256k1 launch: the mixed window's rows
    n_live = int(secp_arrays[5].sum())
    one_dev = sk.verify_prehashed(*(torch.from_numpy(a).to(dev) for a in secp_arrays))
    got = counted(torch, ops, acc, shard_rows, sk.verify_prehashed, mesh, secp_arrays)
    assert got.tolist() == one_dev.cpu().tolist(), "sharded secp256k1 != unsharded"
    print(f"main path: secp_verify_prehashed sharded over {label}: "
          f"{len(got)} rows ({n_live} live) = the unsharded launch's bitmap")

    # --- timings
    sig_pts, key_pts = point_sets["g1"][0][1], point_sets["g2"][0][1]
    rows = []
    for g, add, add_plain, kern, plain, pts, fp_add, per_coord in (
        ("g1", bls_g1.g1_add, bls_g1.g1_add_plain, bls_g1.g1_aggregate_sharded,
         bls_g1.g1_aggregate_sharded_plain, sig_pts, FP_G1_ADD, 1),
        ("g2", bls_g2.g2_add, bls_g2.g2_add_plain, bls_g2.g2_aggregate_sharded,
         bls_g2.g2_aggregate_sharded_plain, key_pts, FP_G2_ADD, 2),
    ):
        b = pts.shape[0]
        # one butterfly launch: one pair, as every round adds per shard
        p, q = pts[:1].contiguous(), pts[1:2].contiguous()
        got = add(p, q)
        want, plain_ms = time_once(torch, add_plain, p, q)
        err = max_abs_err(got, want)
        assert err == 0, f"{g}_add != plain"
        errs[g + "_add"] = max(errs[g + "_add"], err)
        ms = time_cuda(torch, lambda: add(p, q), 20)
        point_bytes = p.numel()
        b_ms, b_by = bound_ms(3 * point_bytes, (fp_add + 9 * per_coord) * IMAD_PER_FP_MUL)
        rows.append({
            "name": f"{g}_add", "route": "cuda", "source": BLS_SOURCE,
            "replaces": "tendermint_tpu/ops/shard_reduce.py:48",
            "launches": acc.get(f"{g}_add", 0), "max_abs_err": errs[g + "_add"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        print(f"time: {g}_add kernel (one butterfly launch, 1 pair) {ms:.4f} ms plain "
              f"{plain_ms:.2f} ms (one call) bound {b_ms:.3g} ms ({b_by}) | {smi}")
        sum_ms = time_cuda(torch, lambda: kern(pts, mesh), 20)
        t0 = time.perf_counter()
        plain(pts.cpu(), mesh)
        sum_plain_ms = (time.perf_counter() - t0) * 1e3
        s_ms, s_by = bound_ms(pts.numel() + point_bytes,
                              ((b - 1) * fp_add + 3 * per_coord * (b + 1)) * IMAD_PER_FP_MUL)
        rounds = MESH_SHARDS.bit_length() - 1
        print(f"time: {g}_aggregate_sharded (kernel 13) of {b} points over {label}: "
              f"{sum_ms:.4f} ms ({MESH_SHARDS} tree launches + {MESH_SHARDS * rounds} "
              f"add launches, median of 20 by CUDA events); plain on the CPU "
              f"{sum_plain_ms:.2f} ms (one call, host clock); bound {s_ms:.3g} ms "
              f"({s_by}, the {b - 1} additions any sum of {b} points needs) | {smi}")
    win_1 = {k: [round(w * 1e3, 2) for w in bulk[k]["walls"]] for k in walls}
    win_m = {k: [round(w * 1e3, 2) for w in v] for k, v in walls.items()}
    print(f"time: blocksync window ms, {label} {json.dumps(win_m)} against one "
          f"device {json.dumps(win_1)} | {smi}")
    d_arrays = [torch.from_numpy(a).to(dev) for a in secp_arrays]
    secp_one = time_cuda(torch, lambda: sk.verify_prehashed(*d_arrays), 20)
    secp_sh = time_cuda(
        torch, lambda: shard_rows(sk.verify_prehashed, mesh, secp_arrays), 5)
    print(f"time: secp_verify_prehashed {len(secp_arrays[0])} rows: one launch "
          f"{secp_one:.4f} ms (operands on the card); sharded over {label} "
          f"{secp_sh:.4f} ms (copies, {MESH_SHARDS} launches, the gather; median of 5) "
          f"| {smi}")

    # --- a real mesh: every card, where there are two or more
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print("mesh: real multi-GPU mesh not run (1 device)")
        return rows, acc
    real = build_mesh(0, 1, "cuda")
    label = f"mesh of {real.size} cards"
    sharded_sums(torch, ops, real, point_sets, acc, errs, label)
    r_host = bv.BatchVerifier(mesh=real, shape_registry=ShapeRegistry())
    r_walls, counts = mesh_window(
        torch, ops, host, rng, acc, r_host, vset, chain_id, entries, tampered,
        bad_height, bulk["host_hash"], 2, "real_mesh_host_hash", real.size)
    got = counted(torch, ops, acc, shard_rows, sk.verify_prehashed, real, secp_arrays)
    assert got.tolist() == one_dev.cpu().tolist(), "sharded secp256k1 != unsharded (cards)"
    print(f"main path: {label}: kernel 13 at the three sizes, the host-hashed window "
          f"(= the 1-device window, rounds stamped devices={real.size}) and the "
          f"sharded secp256k1 launch pass; window walls "
          f"{[round(w * 1e3, 2) for w in r_walls]} ms; launches {json.dumps(counts)} "
          f"| {smi}")
    return rows, acc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--validators", type=int, default=150)
    ap.add_argument("--heights", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tendermint_tpu_torch import ops, types
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import ed25519 as host
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.ops import _build, curve25519 as curve
    from tendermint_tpu_torch.ops import dbl_chain as dc
    from tendermint_tpu_torch.ops import ed25519_batch as eb
    from tendermint_tpu_torch.ops import field25519 as fe
    from tendermint_tpu_torch.ops import sha512

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # --- 1. build -----------------------------------------------------------
    smi = nvidia_smi_line()
    ptxas = _build.start_ptxas_report()
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    report = _build.finish_ptxas_report(ptxas)
    with open(os.path.join(_build.BUILD_DIR, "ptxas_report.txt"), "w") as f:
        f.write(report)
    print(f"build: route={_build.BUILD_INFO['route']} seconds={build_s:.1f} | {smi}")
    usages = ptxas_usage(report)
    for name, usage in usages.items():
        print(f"ptxas: {name}: {usage}")

    def T(rows) -> torch.Tensor:
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8)

    # --- 2. kernel vs plain -------------------------------------------------
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(200)]
    adversarial = [
        (1).to_bytes(32, "little"),  # identity (small order)
        bytes(32),  # y = 0: order-4 point
        ((1 << 255) | 1).to_bytes(32, "little"),  # y = 1, x = 0, sign set
        host.P.to_bytes(32, "little"),  # y = p, non-canonical
        (host.P + 1).to_bytes(32, "little"),  # y = p + 1, non-canonical
        (2**255 - 1).to_bytes(32, "little"),  # y = 2^255 - 1
        (host.P - 1).to_bytes(32, "little"),  # y = -1: order-2 point
    ]
    pubs = [k.public_key().data for k in keys] + adversarial
    while len(pubs) < 256:
        pubs.append(rng.bytes(32))  # about half have no square root
    pub_d = T(pubs).to(dev)
    tables, tvalid = eb.neg_pubkey_table(pub_d)
    p_tables, p_tvalid = eb.neg_pubkey_table_plain(pub_d)
    torch.cuda.synchronize()
    errs = {"neg_pubkey_table": max(max_abs_err(tables, p_tables),
                                    max_abs_err(tvalid, p_tvalid))}
    assert errs["neg_pubkey_table"] == 0, "neg_pubkey_table: kernel != plain"
    want_valid = [host.point_decompress(p) is not None for p in pubs]
    assert tvalid.cpu().tolist() == want_valid, "neg_pubkey_table validity"

    # 256 verify rows over these keys, the last 8 padding
    n_rows = 256
    items, idx, want = mixed_rows(host, keys, pubs, n_rows, 8, b"smoke")
    R, S, K, s_ok, idx_t = row_tensors(torch, host, items, idx, 8, dev)
    vt = eb.verify_prehashed_table(tables, tvalid, idx_t, R, S, K, s_ok)
    vt_plain = eb.verify_prehashed_table_plain(tables, tvalid, idx_t, R, S, K, s_ok)
    torch.cuda.synchronize()
    errs["verify_prehashed_table"] = max_abs_err(vt, vt_plain)
    assert errs["verify_prehashed_table"] == 0, "verify_prehashed_table: kernel != plain"
    assert vt.cpu().tolist() == want, "verify_prehashed_table != host oracle"
    assert any(want) and not all(want)
    k3_checks = []
    for b, n_pad in KERNEL3_SIZES:
        k3_ops, k3_want = kernel3_rows(torch, host, keys, pubs, tables, tvalid,
                                       b, n_pad, b"k3-%d" % b)
        got = eb.verify_prehashed_table(*k3_ops)
        plain = eb.verify_prehashed_table_plain(*k3_ops)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        errs["verify_prehashed_table"] = max(errs["verify_prehashed_table"], err)
        assert err == 0, f"verify_prehashed_table: kernel != plain at b={b}"
        assert got.cpu().tolist() == k3_want, f"verify_prehashed_table != host oracle at b={b}"
        k3_checks.append({"b": b, "padding": n_pad, "accepted": sum(k3_want)})
    print(f"kernel-vs-plain: verify_prehashed_table (four lanes a row) at its "
          f"small-tier shapes, idx -1 and past the store inside warps of live "
          f"rows: equal to its plain version and the host oracle (tolerance: "
          f"exact) {json.dumps(k3_checks)}")
    G_pub = T([p for p, _, _ in items]).to(dev)
    vg = eb.verify_prehashed(G_pub, R, S, K, s_ok)
    vg_plain = eb.verify_prehashed_plain(G_pub, R, S, K, s_ok)
    torch.cuda.synchronize()
    errs["verify_prehashed"] = max_abs_err(vg, vg_plain)
    assert errs["verify_prehashed"] == 0, "verify_prehashed: kernel != plain"
    assert vg.cpu().tolist() == want, "verify_prehashed != host oracle"

    # the big tier: 256 tables, 2048 rows (the last 64 padding)
    btables, bvalid = eb.neg_pubkey_bigtable(pub_d)
    p_btables, p_bvalid = eb.neg_pubkey_bigtable_plain(pub_d)
    torch.cuda.synchronize()
    errs["neg_pubkey_bigtable"] = max(max_abs_err(btables, p_btables),
                                      max_abs_err(bvalid, p_bvalid))
    assert errs["neg_pubkey_bigtable"] == 0, "neg_pubkey_bigtable: kernel != plain"
    assert bvalid.cpu().tolist() == want_valid, "neg_pubkey_bigtable validity"
    del p_btables
    big_items, big_idx, big_want = mixed_rows(host, keys, pubs, 2048, 64, b"big")
    bR, bS, bK, b_ok, bidx_t = row_tensors(torch, host, big_items, big_idx, 64, dev)
    big_args = (btables, bvalid, bidx_t, bR, bS, bK, b_ok)
    for name, kern, plain in (
        ("verify_prehashed_bigcache", eb.verify_prehashed_bigcache,
         eb.verify_prehashed_bigcache_plain),
        ("verify_prehashed_bigcache_mxu", eb.verify_prehashed_bigcache_mxu,
         eb.verify_prehashed_bigcache_mxu_plain),
    ):
        got = kern(*big_args)
        got_plain = plain(*big_args)
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, got_plain)
        assert errs[name] == 0, f"{name}: kernel != plain"
        assert got.cpu().tolist() == big_want, f"{name} != host oracle"
    assert any(big_want) and not all(big_want)

    # challenges: 2048 ragged rows of R || A || M, 0..1000-byte messages
    ch_rows = [(rng.bytes(32), rng.bytes(32), rng.bytes(int(n)))
               for n in rng.integers(0, 1001, 2048)]
    ch_buf, ch_cnt = sha512.pad_messages(
        [m for _, _, m in ch_rows], prefix_pairs=[r + a for r, a, _ in ch_rows]
    )
    ch_buf_d = torch.from_numpy(ch_buf).to(dev)
    ch_cnt_d = torch.from_numpy(ch_cnt).to(dev)
    ch = sha512.challenge_batch(ch_buf_d, ch_cnt_d)
    ch_plain = sha512.challenge_batch_plain(ch_buf_d, ch_cnt_d)
    torch.cuda.synchronize()
    errs["challenge_batch"] = max_abs_err(ch, ch_plain)
    assert errs["challenge_batch"] == 0, "challenge_batch: kernel != plain"
    assert [bytes(r) for r in ch.cpu().tolist()] == [
        (int.from_bytes(hashlib.sha512(r + a + m).digest(), "little") % host.L)
        .to_bytes(32, "little") for r, a, m in ch_rows
    ], "challenge_batch != hashlib + % L"
    # the reduction alone, on digests SHA-512 cannot be made to give
    L = host.L
    digests = [2**512 - 1, L - 1, L, L + 1, 2 * L, 2 * L - 1, 2**252, 0, 1,
               2**256 - 1, (2**512 - 1) // L * L, (2**512 - 1) // L * L - 1]
    digests += [int.from_bytes(rng.bytes(64), "little") for _ in range(1012)]
    dig_d = T([v.to_bytes(64, "little") for v in digests]).to(dev)
    red = sha512.reduce_mod_l(dig_d)
    red_plain = sha512.reduce_mod_l_plain(dig_d)
    torch.cuda.synchronize()
    reduce_err = max_abs_err(red, red_plain)
    assert reduce_err == 0, "reduce_mod_l: kernel != plain"
    assert [int.from_bytes(bytes(r), "little") for r in red.cpu().tolist()] == [
        v % L for v in digests
    ], "reduce_mod_l != int % L"

    # 8192 points [c_i]B, doubled 256 times
    n_pts, n_dbl = 8192, dc.N_DBL
    scalars = torch.from_numpy(rng.integers(0, 256, (n_pts, 32), dtype=np.uint8))
    scalars[0] = 0
    scalars[0, 0] = 1  # row 0 is the basepoint
    pts = fe.to_bytes(curve.scalar_mult_base(scalars.to(dev))).contiguous()
    d_out = dc.dbl_chain(pts, n_dbl)
    d_plain = dc.dbl_chain_plain(pts, n_dbl)
    torch.cuda.synchronize()
    errs["dbl_chain"] = max_abs_err(d_out, d_plain)
    assert errs["dbl_chain"] == 0, "dbl_chain: kernel != plain (bytes)"

    def affine(p8):
        p = fe.from_bytes(p8)
        zi = fe.invert(p[:, 2])
        return fe.to_bytes(fe.mul(p[:, :2], zi.unsqueeze(1)))

    assert torch.equal(affine(d_out), affine(d_plain)), "dbl_chain affine"
    hq = host.BASEPOINT
    for _ in range(n_dbl):
        hq = host.point_double(hq)
    zi = pow(hq[2], host.P - 2, host.P)
    want0 = [hq[0] * zi % host.P, hq[1] * zi % host.P]
    got0 = [int.from_bytes(bytes(r), "little") for r in affine(d_out)[0].cpu().tolist()]
    assert got0 == want0, "dbl_chain row 0 != host oracle"
    print(f"kernel-vs-plain: all eight wrappers and the reduction kernel "
          f"equal their plain versions (tolerance: exact; reduce_mod_l on "
          f"{len(digests)} digests, max_abs_err {reduce_err})")

    # --- 3. main paths ------------------------------------------------------
    chain_id = "chip-smoke"
    vkeys = [host.PrivKey(rng.bytes(32)) for _ in range(args.validators)]
    powers = rng.integers(1, 100, args.validators).tolist()
    vset = types.ValidatorSet(
        [types.Validator(k.public_key(), int(p)) for k, p in zip(vkeys, powers)]
    )
    by_addr = {k.public_key().address(): k for k in vkeys}

    def signed_commit(height: int):
        bid = types.BlockID(
            hash=rng.bytes(32),
            part_set_header=types.PartSetHeader(total=1, hash=rng.bytes(32)),
        )
        sigs = [
            types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                            1_700_000_000_000_000_000 + height * 10**9 + i)
            for i, v in enumerate(vset.validators)
        ]
        commit = types.Commit(height, 0, bid, sigs)
        for i, v in enumerate(vset.validators):
            sigs[i].signature = by_addr[v.address].sign(
                commit.vote_sign_bytes(chain_id, i)
            )
        return bid, commit

    # commit verification
    commits = [signed_commit(h) for h in range(1, args.heights + 2)]
    ops.reset_launches()
    verifier = bv.default_verifier()
    assert verifier.device.type == "cuda"
    commit_ms = []
    for h, (bid, commit) in enumerate(commits[: args.heights], start=1):
        t0 = time.perf_counter()
        vset.verify_commit(chain_id, bid, h, commit)
        commit_ms.append((time.perf_counter() - t0) * 1e3)
    bid, commit = commits[-1]
    h_bad = args.heights + 1
    bad_i = int(rng.integers(0, args.validators))
    sig = commit.signatures[bad_i].signature
    commit.signatures[bad_i].signature = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
    try:
        vset.verify_commit(chain_id, bid, h_bad, commit)
    except ValueError as e:
        assert str(e) == f"wrong signature at index {bad_i}", e
    else:
        raise AssertionError("tampered commit verified")
    small = bv.BatchVerifier(table_cache_capacity=64)
    g_items = [
        bv.SigItem(vset.validators[i].pub_key.data,
                   commit.vote_sign_bytes(chain_id, i),
                   commit.signatures[i].signature)
        for i in range(args.validators)
    ]
    got = small.verify(g_items).tolist()
    assert got == [host.verify(it.pubkey, it.msg, it.sig) for it in g_items]
    assert got.count(False) == 1 and not got[bad_i]
    launches = {}
    commit_launches = ops.kernel_launches()
    for name in ("neg_pubkey_table", "verify_prehashed_table", "verify_prehashed"):
        assert commit_launches[name] > 0, f"{name} was not launched on its main path"
        launches[name] = commit_launches[name]
    print(f"main path: verify_commit x{args.heights} at {args.validators} "
          f"validators ok; tampered index {bad_i} rejected; generic round ok; "
          f"launches {json.dumps({k: v for k, v in commit_launches.items() if v})}")

    # the doubling chain
    ops.reset_launches()
    dc.dbl_chain(pts, n_dbl)
    torch.cuda.synchronize()
    launches["dbl_chain"] = ops.kernel_launches()["dbl_chain"]
    assert launches["dbl_chain"] > 0, "dbl_chain was not launched on its main path"

    # bulk commit verification: one blocksync window through the scheduler
    n_win = WINDOW
    bad_height = min(40, n_win)
    t0 = time.perf_counter()
    entries, tampered = signed_window(
        host, types, vset, by_addr, chain_id, n_win, bad_height, rng
    )
    sign_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, _, c in entries:
        vset._gather_items(chain_id, c, True)
    assembly_s = time.perf_counter() - t0
    n_sigs = n_win * args.validators
    os.environ.pop("TM_TPU_MXU_GATHER", None)
    v_host = bv.BatchVerifier(shape_registry=ShapeRegistry())
    v_dev = bv.BatchVerifier(device_challenge_min=2048, shape_registry=ShapeRegistry())
    os.environ["TM_TPU_MXU_GATHER"] = "1"
    v_mxu = bv.BatchVerifier(shape_registry=ShapeRegistry())
    del os.environ["TM_TPU_MXU_GATHER"]
    assert v_mxu._big_verify is eb.verify_prehashed_bigcache_mxu
    bulk = {}
    for label, bverifier, reps, tier, path_kernels in (
        ("host_hash", v_host, 2, "big",
         ("neg_pubkey_bigtable", "verify_prehashed_bigcache")),
        ("device_hash", v_dev, 2, "big_msgs",
         ("challenge_batch", "verify_prehashed_bigcache")),
        ("mxu_gather", v_mxu, 1, "big", ("verify_prehashed_bigcache_mxu",)),
    ):
        if bverifier is not v_host:
            bverifier._big = v_host._big  # the window's tables, built once
        ops.reset_launches()
        verdicts, walls, gcs, bitmap, items, ledger = run_window(
            bverifier, vset, chain_id, entries, reps, label
        )
        torch.cuda.synchronize()
        counts = ops.kernel_launches()
        for name in path_kernels:
            assert counts[name] > 0, f"{name} was not launched on the {label} path"
            launches[name] = launches.get(name, 0) + counts[name]
        check_window(host, verdicts, bitmap, items, ledger, n_win, bad_height,
                     tampered, args.validators, rng, label)
        b = bverifier._registry.bucket_for(n_sigs)
        assert all(e["dispatched"] == b for e in ledger), ledger
        tiers = bverifier._registry.buckets_by_tier()
        assert tiers[tier] == (b,), tiers
        bulk[label] = {"walls": walls, "gcs": gcs, "ledger": ledger, "tiers": tiers,
                       "launches": {k: v for k, v in counts.items() if v},
                       "verdicts": verdicts, "bitmap": bitmap}
        print(f"main path: bulk {label}: {n_win} commits x {args.validators} "
              f"validators = {n_sigs} rows, bucket {b}, tiers "
              f"{json.dumps({k: list(v) for k, v in tiers.items()})}; verdicts "
              f"[True]*{bad_height - 1} + [False] + [True]*{n_win - bad_height} "
              f"x{reps}; bitmap False on exactly the {len(tampered)} tampered "
              f"rows; 256-row sample = host oracle; launches "
              f"{json.dumps(bulk[label]['launches'])}")

    # --- 4. timings ---------------------------------------------------------
    rows_store = verifier._small.tables.shape[0]
    active_table = int(
        (s_ok & (idx_t >= 0) & tvalid[idx_t.clamp(min=0).long()]).sum()
    )
    # the generic rows carry the same keys and s as the table rows
    active_generic = active_table
    n_keys = pub_d.shape[0]

    # the bulk window's operands at the main path's shapes
    win_items = [
        it for _, _, c in entries for it in vset._gather_items(chain_id, c, True)[0]
    ]
    big_store = v_host._big
    b_win = v_host._registry.bucket_for(n_sigs)
    w_idx = np.full(b_win, -1, dtype=np.int32)
    w_r = np.zeros((b_win, 32), dtype=np.uint8)
    w_s = np.zeros((b_win, 32), dtype=np.uint8)
    w_k = np.zeros((b_win, 32), dtype=np.uint8)
    w_ok = np.zeros(b_win, dtype=bool)
    t0 = time.perf_counter()
    for it in win_items:
        int.from_bytes(hashlib.sha512(it.sig[:32] + it.pubkey + it.msg).digest(),
                       "little") % host.L
    host_hash_ms = (time.perf_counter() - t0) * 1e3
    for i, it in enumerate(win_items):
        w_idx[i] = big_store._idx[it.pubkey]
        w_r[i] = np.frombuffer(it.sig[:32], np.uint8)
        w_s[i] = np.frombuffer(it.sig[32:], np.uint8)
        w_k[i] = np.frombuffer(
            host.challenge(it.sig[:32], it.pubkey, it.msg).to_bytes(32, "little"),
            np.uint8)
        w_ok[i] = int.from_bytes(it.sig[32:], "little") < host.L
    msgs = [it.msg for it in win_items] + [b""] * (b_win - n_sigs)
    prefixes = [it.sig[:32] + it.pubkey for it in win_items] + [b""] * (b_win - n_sigs)
    w_buf, w_cnt = sha512.pad_messages(msgs, prefix_pairs=prefixes)
    D = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    w_args = (big_store.tables, big_store.valid, D(w_idx), D(w_r), D(w_s),
              D(w_k), D(w_ok))
    w_buf_d, w_cnt_d = D(w_buf), D(w_cnt)
    live_big = int((w_ok & (w_idx >= 0)).sum())  # every window key is valid
    used_keys = len(big_store._idx)
    # the table build at the path's shape: 150 keys padded to the bucket
    n_build = v_host._registry.bucket_for(len(vset.validators))
    build_pubs = np.zeros((n_build, 32), dtype=np.uint8)
    for i, v in enumerate(vset.validators):
        build_pubs[i] = np.frombuffer(v.pub_key.data, np.uint8)
    build_d = D(build_pubs)
    blocks = int(w_cnt.sum())
    base_bytes = curve.base_table_bytes().size
    verify_big_bytes = (used_keys * 64 * 16 * 128 + used_keys + base_bytes + 96
                        + b_win * (4 + 3 * 32 + 1 + 1))
    work = {
        "neg_pubkey_table": (
            lambda: eb.neg_pubkey_table(pub_d),
            lambda: eb.neg_pubkey_table_plain(pub_d),
            n_keys * (32 + 16 * 128 + 1),
            n_keys * (FE_DECOMPRESS + FE_TABLE_BUILD) * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:51", SOURCE,
        ),
        "verify_prehashed_table": (
            lambda: eb.verify_prehashed_table(tables, tvalid, idx_t, R, S, K, s_ok),
            lambda: eb.verify_prehashed_table_plain(tables, tvalid, idx_t, R, S, K, s_ok),
            tables.numel() + tvalid.numel() + 4 * n_rows + 3 * 32 * n_rows
            + 2 * n_rows + base_bytes + 96,
            active_table * FE_VERIFY_TABLE * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:65", SOURCE,
        ),
        "verify_prehashed": (
            lambda: eb.verify_prehashed(G_pub, R, S, K, s_ok),
            lambda: eb.verify_prehashed_plain(G_pub, R, S, K, s_ok),
            4 * 32 * n_rows + 2 * n_rows + base_bytes + 96,
            (n_rows * FE_DECOMPRESS
             + active_generic * (FE_TABLE_BUILD + FE_VERIFY_TABLE)) * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:36", SOURCE,
        ),
        "dbl_chain": (
            lambda: dc.dbl_chain(pts, n_dbl),
            lambda: dc.dbl_chain_plain(pts, n_dbl),
            2 * pts.numel(),
            n_pts * n_dbl * FE_DBL * IMAD_PER_FE_MUL,
            "tools/microbench_pallas.py:106", SOURCE,
        ),
        "neg_pubkey_bigtable": (
            lambda: eb.neg_pubkey_bigtable(build_d),
            lambda: eb.neg_pubkey_bigtable_plain(build_d),
            n_build * (32 + 64 * 16 * 128 + 1),
            n_build * FE_BIGTABLE * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:80", SOURCE,
        ),
        "verify_prehashed_bigcache": (
            lambda: eb.verify_prehashed_bigcache(*w_args),
            lambda: eb.verify_prehashed_bigcache_plain(*w_args),
            verify_big_bytes,
            live_big * FE_VERIFY_BIG * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:96", SOURCE,
        ),
        "verify_prehashed_bigcache_mxu": (
            lambda: eb.verify_prehashed_bigcache_mxu(*w_args),
            lambda: eb.verify_prehashed_bigcache_mxu_plain(*w_args),
            verify_big_bytes,
            live_big * FE_VERIFY_BIG * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:115", SOURCE,
        ),
        "challenge_batch": (
            lambda: sha512.challenge_batch(w_buf_d, w_cnt_d),
            lambda: sha512.challenge_batch_plain(w_buf_d, w_cnt_d),
            w_buf.size + 4 * b_win + 32 * b_win,
            blocks * SHA512_OPS_PER_BLOCK + b_win * SC_REDUCE_OPS,
            "tendermint_tpu/ops/sha512.py:394", SHA_SOURCE,
        ),
    }
    rows = []
    for name, (kern, plain, nbytes, n_ops, replaces, source) in work.items():
        ms = time_cuda(torch, kern, 20)
        plain_ms = time_cuda(torch, plain, 3)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms:.2f} ms "
              f"bound {b_ms:.5f} ms ({b_by}) | {smi}")
    k3_ms = {}
    for b in KERNEL3_BUCKETS:
        k3_b = (tables, tvalid) + tuple(t[:b] for t in (idx_t, R, S, K, s_ok))
        k3_ms[b] = time_cuda(torch, lambda: eb.verify_prehashed_table(*k3_b), 20)
    print(f"kernel3: verify_table_kernel, four lanes a row, median ms of 20 "
          f"launches at buckets {json.dumps(k3_ms)} (the first b of the 256 "
          f"mixed rows); critical path {FE_VERIFY_TABLE_PATH} dependent field "
          f"multiplications a row (one thread a row: {FE_VERIFY_TABLE}); "
          f"checked at b = {[b for b, _ in KERNEL3_SIZES]}; ptxas: "
          f"{usages.get('verify_table_kernel', 'not reported')} | {smi}")
    print(f"time: verify_commit {args.validators} validators ms per height "
          f"{[round(x, 3) for x in commit_ms]} (first includes the table "
          f"build, store rows {rows_store}; with the one-thread kernel 3 "
          f"{COMMIT_MS_ONE_THREAD[0]}-{COMMIT_MS_ONE_THREAD[1]} ms after the "
          f"first, NVIDIA H100 80GB HBM3, 700 W) | {smi}")
    print(f"time: host hashlib + % L over the window's {n_sigs} rows "
          f"{host_hash_ms:.2f} ms (one CPU thread; tm_challenge at the same "
          f"rows is the challenge_batch line) | {smi}")
    print(f"time: bulk window signing {sign_s:.1f} s (host, set-up); sign-bytes "
          f"assembly of the window alone, first call {assembly_s * 1e3:.2f} ms")
    for label, rec in bulk.items():
        for rep, (wall, gc_s, e) in enumerate(
            zip(rec["walls"], rec["gcs"], rec["ledger"])
        ):
            # the ledger's queue wait runs from the submission to the
            # dispatch, so it holds the prepare; what lies outside the
            # round is verify_commits_light's own work: sign-bytes assembly,
            # the tally, and the thread hand-offs into the scheduler
            outside_s = wall - e["queue_wait_s"] - e["device_s"]
            host_s = outside_s + e["host_prep_s"]
            print(f"time: bulk {label} window {rep + 1}: wall {wall * 1e3:.2f} ms, "
                  f"{n_win / wall:.1f} commits/s; outside the round (sign-bytes "
                  f"assembly, tally) {outside_s * 1e3:.2f} ms + prepare "
                  f"{e['host_prep_s'] * 1e3:.2f} ms = host share "
                  f"{host_s / wall:.3f}; device round {e['device_s'] * 1e3:.2f} ms "
                  f"= device share {e['device_s'] / wall:.3f}; scheduler hand-off "
                  f"{(e['queue_wait_s'] - e['host_prep_s']) * 1e3:.2f} ms; gc pauses "
                  f"{gc_s * 1e3:.2f} ms | {smi}")

    # --- 5. the quorum-certificate path -------------------------------------
    qc_rows, point_sets = qc_phase(torch, rng, dev, smi, ops, types, vset,
                                   chain_id, entries)
    rows += qc_rows

    # --- 6. the mixed-key path and the L2 block's merkle leaves ----------
    mix_rows, secp_arrays = mixed_phase(torch, np, rng, dev, smi, ops, types,
                                          vkeys, chain_id, args.heights)
    rows += mix_rows

    # --- 7. the in-process consensus net -------------------------------------
    net, net_errs = consensus_phase(torch, ops, host, smi, args.seed,
                                    NET_VALIDATORS, NET_HEIGHTS)
    for row in rows:
        row["launches"] += net.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], net_errs.get(row["name"], 0))
    print(f"main path: consensus net launches per kernel, both modes "
          f"{json.dumps({k: v for k, v in net.items() if v})} (added to the "
          f"kernels line's launches)")

    # --- 8. the multi-device path -------------------------------------------
    mesh_rows, mesh_launches = mesh_phase(
        torch, np, rng, dev, smi, ops, host, vset, chain_id, entries, tampered,
        bad_height, bulk, g_items, point_sets, secp_arrays)
    for row in rows:
        row["launches"] += mesh_launches.get(row["name"], 0)
    rows += mesh_rows
    for name in ("neg_pubkey_table", "verify_prehashed_table", "verify_prehashed",
                 "neg_pubkey_bigtable", "verify_prehashed_bigcache",
                 "verify_prehashed_bigcache_mxu", "challenge_batch",
                 "secp_verify_prehashed", "g1_aggregate", "g2_aggregate",
                 "g1_add", "g2_add"):
        assert mesh_launches.get(name, 0) > 0, f"{name} was not launched on the mesh path"
    print(f"main path: mesh path launches per kernel "
          f"{json.dumps({k: v for k, v in mesh_launches.items() if v})} (added to "
          f"the kernels line's launches)")

    # --- 9. result lines ----------------------------------------------------
    kernels_line = json.dumps({"kernels": rows})
    last = json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    print(kernels_line)
    print(smi)
    print(last)
    return 0


if __name__ == "__main__":
    sys.exit(main())
