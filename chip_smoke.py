#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N] [--validators N] [--heights N]

Phases (any failure raises and the exit code is non-zero):

1. Build the four ed25519 kernels from ``tendermint_tpu_torch/ops/csrc``
   into ``tendermint_tpu_torch/_kbuild/`` (a ``-Xptxas -v`` report of
   registers and spills runs beside the build), print the build seconds
   and the card's ``nvidia-smi`` name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs, with exact equality (bytes and bitmaps are integers):
   ``neg_pubkey_table`` on 256 keys (valid plus adversarial: small order,
   non-canonical y, no square root, x = 0 with the sign bit),
   ``verify_prehashed_table`` and ``verify_prehashed`` on 256 mixed
   valid/invalid rows (also held against the host oracle), ``dbl_chain``
   on 8192 points x 256 doublings (bytes and affine coordinates, row 0
   against 256 host ``point_double``).
3. Drive the main paths through their entry points, each with the launch
   counts zeroed just before and read just after:
   - commit verification: a seeded 150-validator ``ValidatorSet``
     verifies 5 heights of precommits through ``default_verifier()`` on
     CUDA, rejects a tampered signature with the reference's
     ``wrong signature at index i``, and a ``BatchVerifier`` whose table
     cache holds 64 keys verifies one 150-row round on the generic kernel,
     held against the host oracle;
   - the doubling chain: ``dbl_chain`` at the Pallas microbenchmark's
     workload (8192 points, 256 doublings).
4. Time each kernel (median of 20 launches, CUDA events) and its plain
   version (median of 3) at the main path's shapes, and
   ``verify_commit`` per height; work out each kernel's bound.
5. Print the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA it exits non-zero before printing any result. The full
ptxas report is kept beside the build, in
``tendermint_tpu_torch/_kbuild/ptxas_report.txt``.
"""

from __future__ import annotations

import argparse
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
# (IMAD issues at half the FFMA rate, and an FFMA counts two FLOPs).
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
FE_DBL = 8


SOURCE = "tendermint_tpu_torch/ops/csrc/ed25519_kernels.cu"


def max_abs_err(a, b) -> int:
    """Largest elementwise difference of two integer/bool tensors."""
    return int((a.to(b.device).long() - b.long()).abs().max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_usage(report: str) -> dict[str, str]:
    """kernel name -> its stack/spill and register lines of -Xptxas -v."""
    usage: dict[str, list[str]] = {}
    name = None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '.*?([a-z][a-z_]*_kernel)", ln)
        if m:
            name = m.group(1)
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
    from tendermint_tpu_torch import ops
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import ed25519 as host
    from tendermint_tpu_torch.ops import _build, curve25519 as curve
    from tendermint_tpu_torch.ops import dbl_chain as dc
    from tendermint_tpu_torch.ops import ed25519_batch as eb
    from tendermint_tpu_torch.ops import field25519 as fe
    from tendermint_tpu_torch.types import (
        BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader, Validator,
        ValidatorSet,
    )

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
    for name, usage in ptxas_usage(report).items():
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

    # 256 verify rows over these keys: valid, wrong msg, flipped sig bit,
    # s >= L, adversarial keys, padding rows (idx -1, s_ok False)
    n_rows = 256
    items, idx = [], []
    for i in range(n_rows):
        ki = i % 200
        msg = b"smoke-%d" % i
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
            ki = 200 + (i // 8) % 56
            pub = pubs[ki]
        items.append((pub, msg, sig))
        idx.append(-1 if i >= 248 else ki)
    R = T([s[:32] for _, _, s in items]).to(dev)
    S = T([s[32:] for _, _, s in items]).to(dev)
    K = T([host.challenge(s[:32], p, m).to_bytes(32, "little")
           for p, m, s in items]).to(dev)
    s_ok = torch.tensor(
        [int.from_bytes(s[32:], "little") < host.L for _, _, s in items]
    )
    s_ok[248:] = False
    s_ok = s_ok.to(dev)
    idx_t = torch.tensor(idx, dtype=torch.int32, device=dev)
    want = [
        host.verify(p, m, s) and i < 248 for i, (p, m, s) in enumerate(items)
    ]
    vt = eb.verify_prehashed_table(tables, tvalid, idx_t, R, S, K, s_ok)
    vt_plain = eb.verify_prehashed_table_plain(tables, tvalid, idx_t, R, S, K, s_ok)
    torch.cuda.synchronize()
    errs["verify_prehashed_table"] = max_abs_err(vt, vt_plain)
    assert errs["verify_prehashed_table"] == 0, "verify_prehashed_table: kernel != plain"
    assert vt.cpu().tolist() == want, "verify_prehashed_table != host oracle"
    assert any(want) and not all(want)
    G_pub = T([p for p, _, _ in items]).to(dev)
    vg = eb.verify_prehashed(G_pub, R, S, K, s_ok)
    vg_plain = eb.verify_prehashed_plain(G_pub, R, S, K, s_ok)
    torch.cuda.synchronize()
    errs["verify_prehashed"] = max_abs_err(vg, vg_plain)
    assert errs["verify_prehashed"] == 0, "verify_prehashed: kernel != plain"
    assert vg.cpu().tolist() == want, "verify_prehashed != host oracle"

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
    print("kernel-vs-plain: all four kernels equal their plain versions "
          "(tolerance: exact)")

    # --- 3. main paths ------------------------------------------------------
    chain_id = "chip-smoke"
    vkeys = [host.PrivKey(rng.bytes(32)) for _ in range(args.validators)]
    powers = rng.integers(1, 100, args.validators).tolist()
    vset = ValidatorSet(
        [Validator(k.public_key(), int(p)) for k, p in zip(vkeys, powers)]
    )
    by_addr = {k.public_key().address(): k for k in vkeys}

    def signed_commit(height: int):
        bid = BlockID(
            hash=rng.bytes(32),
            part_set_header=PartSetHeader(total=1, hash=rng.bytes(32)),
        )
        sigs = [
            CommitSig(BlockIDFlag.COMMIT, v.address,
                      1_700_000_000_000_000_000 + height * 10**9 + i)
            for i, v in enumerate(vset.validators)
        ]
        commit = Commit(height, 0, bid, sigs)
        for i, v in enumerate(vset.validators):
            sigs[i].signature = by_addr[v.address].sign(
                commit.vote_sign_bytes(chain_id, i)
            )
        return bid, commit

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
    launches = ops.kernel_launches()
    del launches["dbl_chain"]
    ops.reset_launches()
    dc.dbl_chain(pts, n_dbl)
    torch.cuda.synchronize()
    launches["dbl_chain"] = ops.kernel_launches()["dbl_chain"]
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on its main path"
    print(f"main path: verify_commit x{args.heights} at {args.validators} "
          f"validators ok; tampered index {bad_i} rejected; generic round ok; "
          f"launches {json.dumps(launches)}")

    # --- 4. timings ---------------------------------------------------------
    rows_store = verifier._small.tables.shape[0]
    active_table = int(
        (s_ok & (idx_t >= 0) & tvalid[idx_t.clamp(min=0).long()]).sum()
    )
    # the generic rows carry the same keys and s as the table rows
    active_generic = active_table
    n_keys = pub_d.shape[0]
    work = {
        "neg_pubkey_table": (
            lambda: eb.neg_pubkey_table(pub_d),
            lambda: eb.neg_pubkey_table_plain(pub_d),
            n_keys * (32 + 16 * 128 + 1),
            n_keys * (FE_DECOMPRESS + FE_TABLE_BUILD),
            "tendermint_tpu/ops/ed25519_batch.py:51",
        ),
        "verify_prehashed_table": (
            lambda: eb.verify_prehashed_table(tables, tvalid, idx_t, R, S, K, s_ok),
            lambda: eb.verify_prehashed_table_plain(tables, tvalid, idx_t, R, S, K, s_ok),
            tables.numel() + tvalid.numel() + 4 * n_rows + 3 * 32 * n_rows
            + 2 * n_rows + curve.base_table_bytes().size + 96,
            active_table * FE_VERIFY_TABLE,
            "tendermint_tpu/ops/ed25519_batch.py:65",
        ),
        "verify_prehashed": (
            lambda: eb.verify_prehashed(G_pub, R, S, K, s_ok),
            lambda: eb.verify_prehashed_plain(G_pub, R, S, K, s_ok),
            4 * 32 * n_rows + 2 * n_rows + curve.base_table_bytes().size + 96,
            n_rows * FE_DECOMPRESS
            + active_generic * (FE_TABLE_BUILD + FE_VERIFY_TABLE),
            "tendermint_tpu/ops/ed25519_batch.py:36",
        ),
        "dbl_chain": (
            lambda: dc.dbl_chain(pts, n_dbl),
            lambda: dc.dbl_chain_plain(pts, n_dbl),
            2 * pts.numel(),
            n_pts * n_dbl * FE_DBL,
            "tools/microbench_pallas.py:106",
        ),
    }
    rows = []
    for name, (kern, plain, nbytes, fe_muls, replaces) in work.items():
        ms = time_cuda(torch, kern, 20)
        plain_ms = time_cuda(torch, plain, 3)
        b_ms, b_by = bound_ms(nbytes, fe_muls * IMAD_PER_FE_MUL)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms:.2f} ms "
              f"bound {b_ms:.5f} ms ({b_by}) | {smi}")
    print(f"time: verify_commit {args.validators} validators ms per height "
          f"{[round(x, 3) for x in commit_ms]} (first includes the table "
          f"build, store rows {rows_store}) | {smi}")

    # --- 5. result lines ----------------------------------------------------
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
