#!/usr/bin/env python3
"""Kernel 3 alone on one NVIDIA GPU: ``tm_verify_table`` (the small-tier
verify) against its plain PyTorch version, and against the same kernel of
another tree of this repository.

    python3 chip_kernel3.py [--parent DIR] [--seed N]

Builds ``tendermint_tpu_torch/ops/csrc/ed25519_kernels.cu`` with ``nvcc``
into a plain shared library (no PyTorch headers) under
``tendermint_tpu_torch/_kbuild/``, with ``-Xptxas -v`` for the kernel's
registers, stack and spills; with ``--parent``, the same file of the tree
at DIR too (e.g. the parent commit unpacked with ``git archive``), both
nvcc runs started together. Each build's ``tm_verify_table`` is held
against ``verify_prehashed_table_plain`` on the card and the host oracle
at b = 1, 23, 150 and 256 rows (valid rows, wrong messages, flipped
signature bits, s >= L, invalid keys, ``idx = -1`` and ``idx`` past the
store inside warps of live rows; 256 = the commit path's 150 live rows
padded to its bucket). Then it times each build at the buckets 8, 32, 128
and 256 (median of 20 launches between CUDA events, on the first
b of 256 mixed rows), in turns parent, this tree, this tree, parent, so
that both are measured on one card in one call. With ``--parent`` it
then times the commit path of each tree in the same turns: a child
process (``--commit-tree ROOT``) imports that tree's package, builds its
kernels and verifies 8 commits of a seeded 150-validator set
through ``ValidatorSet.verify_commit`` on the card, as ``chip_smoke.py``
does, printing its ms a height. Prints a ``kernel3:`` line per build, a
``commit:`` line per tree, every number again as one JSON object on a
line of its own, the ``nvidia-smi`` name and power limit, and last the
``{"ok": true, ...}`` object. Exits non-zero without CUDA or on any
disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL = os.path.join("tendermint_tpu_torch", "ops", "csrc", "ed25519_kernels.cu")
REPS = 20  # launches per median, as chip_smoke.py times its kernels
COMMIT_HEIGHTS = 8  # commits a tree verifies in each commit turn


def start_build(torch_build, src: str, tag: str):
    """(nvcc -shared process, nvcc -cubin -Xptxas -v process, .so path)."""
    out_dir = torch_build.BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"kernel3_{tag}.so")
    flags = [torch_build._nvcc(), torch_build.ARCH, "-std=c++17", "-O3"]
    shared = subprocess.Popen(
        flags + ["-shared", "-Xcompiler", "-fPIC", "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    cubin = subprocess.Popen(
        flags + ["-cubin", "-Xptxas", "-v", "-o",
                 os.path.join(out_dir, f"kernel3_{tag}.cubin"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return shared, cubin, so


def finish_build(shared, cubin, so: str, ptxas_usage):
    """(verify_table launcher, the kernel's ptxas line)."""
    outs = [proc.communicate()[0] for proc in (shared, cubin)]
    for proc, out in zip((shared, cubin), outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
    usage = ptxas_usage(outs[1]).get("verify_table_kernel", "not reported")
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_verify_table.argtypes = [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i, vp]
    lib.tm_verify_table.restype = i
    lib.tm_error_string.argtypes = [i]
    lib.tm_error_string.restype = ctypes.c_char_p

    def verify_table(torch, tables, tvalid, idx, r, s, k, s_ok, base, kc):
        out = torch.empty(idx.shape[0], dtype=torch.bool, device=idx.device)
        err = lib.tm_verify_table(
            tables.data_ptr(), tvalid.data_ptr(), tables.shape[0],
            idx.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(),
            s_ok.data_ptr(), base.data_ptr(), kc.data_ptr(), out.data_ptr(),
            idx.shape[0], torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"launch failed: {lib.tm_error_string(err).decode()}")
        return out

    return verify_table, usage


def commit_ms(tree: str, n_vals: int, heights: int, seed: int) -> list[float]:
    """ms of each ValidatorSet.verify_commit of `heights` commits of a
    seeded n_vals-validator set, by the package of the tree at `tree`."""
    sys.path.insert(0, tree)
    import numpy as np

    from tendermint_tpu_torch import types
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import ed25519 as host

    assert types.__file__.startswith(tree), types.__file__
    rng = np.random.default_rng(seed)
    chain_id = "chip-kernel3"
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(n_vals)]
    vset = types.ValidatorSet([
        types.Validator(k.public_key(), int(p))
        for k, p in zip(keys, rng.integers(1, 100, n_vals).tolist())
    ])
    by_addr = {k.public_key().address(): k for k in keys}
    assert bv.default_verifier().device.type == "cuda"
    out = []
    for h in range(1, heights + 1):
        bid = types.BlockID(
            hash=rng.bytes(32),
            part_set_header=types.PartSetHeader(total=1, hash=rng.bytes(32)),
        )
        sigs = [types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                                1_700_000_000_000_000_000 + h * 10**9 + i)
                for i, v in enumerate(vset.validators)]
        commit = types.Commit(h, 0, bid, sigs)
        for i, v in enumerate(vset.validators):
            sigs[i].signature = by_addr[v.address].sign(commit.vote_sign_bytes(chain_id, i))
        t0 = time.perf_counter()
        vset.verify_commit(chain_id, bid, h, commit)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of another tree whose kernel is timed beside this one")
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--commit-tree", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.commit_tree:
        print(json.dumps(commit_ms(args.commit_tree, 150, COMMIT_HEIGHTS, args.seed)))
        return 0

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel3: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tendermint_tpu_torch.crypto import ed25519 as host
    from tendermint_tpu_torch.ops import _build, curve25519 as curve
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    smi = cs.nvidia_smi_line()

    trees = {"this": ROOT}
    if args.parent:
        trees["parent"] = os.path.abspath(args.parent)
    t0 = time.perf_counter()
    procs = {tag: start_build(_build, os.path.join(root, KERNEL), tag)
             for tag, root in trees.items()}
    built = {tag: finish_build(*p, cs.ptxas_usage) for tag, p in procs.items()}
    print(f"build: {len(built)} nvcc builds of {KERNEL} in parallel, "
          f"{time.perf_counter() - t0:.1f} s | {smi}")

    keys = [host.PrivKey(rng.bytes(32)) for _ in range(200)]
    pubs = [k.public_key().data for k in keys]
    pubs += [(1).to_bytes(32, "little"), host.P.to_bytes(32, "little")]
    while len(pubs) < 256:
        pubs.append(rng.bytes(32))
    pub_d = torch.tensor([list(p) for p in pubs], dtype=torch.uint8, device=dev)
    tables, tvalid = eb.neg_pubkey_table_plain(pub_d)
    tables = tables.contiguous()
    base = curve.base_table(dev)
    kc = eb.kernel_consts(dev)

    def operands(b: int, n_pad: int, tag: bytes):
        return cs.kernel3_rows(torch, host, keys, pubs, tables, tvalid, b, n_pad, tag)

    checks = []
    for b, n_pad in cs.KERNEL3_SIZES:
        ops_b, want = operands(b, n_pad, b"k3-%d" % b)
        plain = eb.verify_prehashed_table_plain(*ops_b)
        for tag, (fn, _) in built.items():
            got = fn(torch, *ops_b, base, kc)
            torch.cuda.synchronize()
            err = cs.max_abs_err(got, plain)
            assert err == 0, f"{tag}: kernel 3 != plain at b={b}"
            assert got.cpu().tolist() == want, f"{tag}: kernel 3 != host oracle at b={b}"
        checks.append({"b": b, "padding": n_pad, "accepted": sum(want)})
    print(f"kernel-vs-plain: kernel 3 of {sorted(built)} equal to the plain "
          f"version and the host oracle at b = {[b for b, _ in cs.KERNEL3_SIZES]} "
          f"(tolerance: exact) {json.dumps(checks)}")

    ops256, _ = operands(256, 8, b"k3-time")
    plain_ms = cs.time_cuda(torch, lambda: eb.verify_prehashed_table_plain(*ops256), 3)
    order = ["parent", "this", "this", "parent"] if "parent" in built else ["this"]
    times: dict[str, dict[int, list[float]]] = {
        t: {b: [] for b in cs.KERNEL3_BUCKETS} for t in built}
    for tag in order:
        fn = built[tag][0]
        for b in cs.KERNEL3_BUCKETS:
            sl = (tables, tvalid) + tuple(t[:b] for t in ops256[2:])
            times[tag][b].append(
                cs.time_cuda(torch, lambda: fn(torch, *sl, base, kc), REPS))
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "plain_ms_256": plain_ms, "checks": checks, "builds": {}}
    for tag in built:
        result["builds"][tag] = {"ptxas": built[tag][1],
                                 "ms": {str(b): times[tag][b] for b in cs.KERNEL3_BUCKETS}}
        print(f"kernel3: {tag} tree, median ms of {REPS} launches at buckets "
              f"{json.dumps({b: times[tag][b] for b in cs.KERNEL3_BUCKETS})} (one list entry "
              f"per turn); ptxas: {built[tag][1]} | {smi}")
    print(f"time: verify_prehashed_table_plain at 256 rows {plain_ms:.2f} ms | {smi}")
    if "parent" in trees:
        commits: dict[str, list[list[float]]] = {t: [] for t in trees}
        for tag in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--commit-tree",
                 trees[tag], "--seed", str(args.seed)],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"commit turn of {tag} failed:\n{proc.stderr[-4000:]}")
            commits[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        result["commit_ms"] = commits
        for tag, turns in commits.items():
            print(f"commit: {tag} tree, verify_commit at 150 validators ms a height "
                  f"per turn {json.dumps([[round(x, 3) for x in t] for t in turns])} "
                  f"(the first of a turn builds the key tables) | {smi}")
    print(json.dumps({"kernel3": result}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
