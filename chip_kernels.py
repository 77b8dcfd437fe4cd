#!/usr/bin/env python3
"""The redesigned kernels alone on one NVIDIA GPU, each against its plain
PyTorch version and against the same kernel of another tree of this
repository: the four-lane ed25519 kernels 2 (``tm_neg_pubkey_table``, the
small-tier table build), 3 (``tm_verify_table``, the
small-tier verify), 4 (``tm_verify_generic``, the cache-overflow verify), 6
(``tm_verify_bigcache``, the big-tier verify) and 5
(``tm_neg_pubkey_bigtable``, the big-tier table build), kernel 8's hash
(``tm_challenge``, a lane a row, warp-staged blocks), and the warp-wide
BLS12-381 kernels: the G2 key sums, kernel 11 (``tm_g2_aggregate``, row
11b) and kernel 13's G2 half (``tm_g2_add`` and the sharded sum), and the
pairing, kernel 12 (``tm_miller`` and ``tm_final_exp``); the four-lane
secp256k1 verify, kernel 10 (``tm_secp_verify``); kernel 9's SHA-256
(``tm_sha256``, a lane a row, warp-staged blocks) and kernel 1, the
doubling chain (``tm_dbl_chain``, four lanes a point).

    python3 chip_kernels.py [--kernel 1 2 3 4 5 6 8 9 10 11 12 13] [--parent DIR] [--seed N]

Builds ``tendermint_tpu_torch/ops/csrc/ed25519_kernels.cu`` (kernels 1, 2,
3, 4, 5, 6), ``sha512_kernels.cu`` (kernel 8), ``sha256_kernels.cu``
(kernel 9), ``secp256k1_kernels.cu`` (kernel 10) and ``bls_kernels.cu``
(kernels 11, 12, 13) with ``nvcc`` into plain
shared libraries (no PyTorch headers) under ``tendermint_tpu_torch/_kbuild/``,
with ``-Xptxas -v`` for each kernel's registers, stack and spills (the
whole report beside the library, as ``chip_kernels_<tree>.ptxas.txt``,
``chip_kernels_secp_<tree>.ptxas.txt`` and
``chip_kernels_bls_<tree>.ptxas.txt``); with ``--parent``, the same files
of the tree at DIR too (e.g. the parent commit unpacked with ``git
archive``), all nvcc runs started together. Then, for each kernel asked
for (all twelve by default), every build is held against the plain version
on the card and the host oracle, and timed (median of 20 launches between
CUDA events) in turns parent, this tree, this tree, parent, so that both
are measured on one card in one call:

- kernel 1 at 1, 150 and 8,192 points x 256 doublings (``K1_SIZES``; 150
  points leave a partial last warp) and at 150 points x 1 and 16
  doublings, byte for byte against the plain version, rows 0-3 against
  256 host ``point_double`` (affine); timed at those sizes per launch and
  queued. Where its time goes: this tree's ``ed25519_kernels.cu`` built
  with the exchange emptied (``K1_EXCHANGE``: the shuffles of ``Shfl4``
  gone, the four lanes' products kept), queued beside the full build at
  8,192 points (``kernel1 split:``), and each build's ``cuobjdump -sass``
  counts of its rolled loop, one doubling a thread (``sass_loop_counts``,
  ``kernel1 sass:``; the one-thread chain's is ``chip_smoke.py``'s
  ``DBL_OPS``);
- kernel 9 at the L2 block's leaf batch ([4,096, 32 x 64], 1-17 blocks a
  row), its first 1,000 rows, 4,096 one-block merkle leaves and 2,048
  two-block inner rows (``k9_shapes``), against the plain version and
  hashlib; timed there per launch and queued; this tree's build at 64
  threads a block (``SHA256_BLOCK_VARIANTS``) checked and timed in turns
  beside its 32 (``kernel9 block:``); each tree's build with the rounds
  or the global loads emptied (``SHA256_SPLITS``, an alternative for the
  one-thread source; ``fitting_patches``), queued at the leaf batch
  (``kernel9 split:``), and the SASS counts of ``sha256_kernel`` and a
  round (``kernel9 sass:``), from which ``chip_smoke.py``'s
  ``SHA256_OPS_PER_BLOCK`` is taken;

- kernel 2 at 1, 23, 150 and 256 keys (``K2_SIZES``: a valid key, then the
  adversarial keys and random bytes, then valid keys), its tables byte
  for byte against the plain version and its validity against the host
  oracle; timed at those sizes, also queued (``time_queued``:
  20 launches back to back behind a spin kernel, the card's time without
  the launch latency, the ``kernel2 queued:`` line);
- kernel 8's hash at the blocksync window's 16,384 rows (9,600 live
  rows of sign-bytes-sized messages, 2 blocks each, then padding), the
  smoke's 2,048 ragged rows (0-1,000-byte messages, 1-9 blocks) and their
  first 1,000 (a partial last warp), against the plain version and
  hashlib with % L; timed there per launch and queued. Where its time
  goes: each tree's ``sha512_kernels.cu`` also built with the rounds
  emptied (the loads alone), with the global loads emptied (the rounds
  alone) and with the reduction emptied (``SHA_SPLITS``; a tree whose
  source they do not fit stops the call), queued at 16,384 and 2,048 rows
  (``kernel8 split:``), and each build's ``cuobjdump -sass`` counts of
  ``challenge_kernel``: the total, some opcodes, a round's (the full
  build's less the rounds-emptied build's, over 80) and the reduction's
  (the full build's less the reduce-emptied build's; ``kernel8 sass:``),
  from which ``chip_smoke.py``'s ``SHA512_OPS_PER_BLOCK`` and
  ``SC_REDUCE_OPS`` are taken;

- kernel 3 at b = 1, 23, 150 and 256 rows (valid rows, wrong messages,
  flipped signature bits, s >= L, invalid keys, ``idx = -1`` and ``idx``
  past the store inside warps of live rows; 256 = the commit path's 150
  live rows padded to its bucket), timed at the buckets 8, 32, 128, 256;
- kernel 4 at the same b (``chip_smoke.kernel4_rows``: the same kinds of
  rows with a zero padding row and a valid signature under ``s_ok`` False
  inside warps of live rows), timed at the same buckets, at 256 and
  16,384 all-rejected rows (the prewarm's zero rows at two of its rungs)
  and beside kernel 3 at 256 rows of each build (``kernel 3 at 256``), to
  show kernel 3 unmoved;
- kernel 6 on a store of 256 big tables at b = 1, 23 and 2,048 rows of the
  same kinds, and at 16,384 rows: the first 9,600 tiled from the 2,048
  (a blocksync window's live rows), the rest padding; timed at 2,048 (one
  mesh shard of the window) and 16,384 (the window's bucket);
- kernel 5 on 16 and 256 keys (valid, small order, non-canonical, no
  square root), its tables byte for byte against the plain version and
  its validity against the host oracle; timed at both sizes;
- kernel 10 on ``chip_smoke.secp_crafted_rows``' 64 rows (each build
  against the plain version and the JAX package's rule) and at the mixed
  window's shape (``K10_LIVE`` = 3,200 live rows, 400 seeded signatures
  of 50 keys tiled 8 times, a quarter of them invalid, padded to
  ``K10_BUCKET`` = 8,192; against the plain version and the host
  oracle), timed at 64, 1,024 (400 live, a mesh shard's share) and 8,192
  rows and at 8,192 all-rejected rows. Where its time goes: this tree's
  ``secp256k1_kernels.cu`` built with the product stages, then the
  addition stages of ``run_program`` emptied (``SECP_SPLITS``), timed at
  8,192 rows beside the full build (the ``kernel10 split:`` line), and the
  latency of one ``fs_mul`` and one ``fs_add_sub`` in a dependent chain on
  one warp (``kernel10 latency:``);
- kernel 12: ``tm_miller`` at the 2-pair verify shape (one chunk) and the
  65-pair RLC shape (64 chunks), ``tm_final_exp`` on one element, each
  byte for byte against its plain version, the products against the host
  oracle (both shapes' pairing products are one), and on
  ``chip_smoke.pairing_operands``' adversarial operands; timed at those
  shapes. Where its time goes: this tree's ``bls_kernels.cu`` is also
  built with the product stages, the addition stages or the inversion of
  ``run_program`` emptied (``SPLITS``), and each variant's time at the
  verify shape and of ``tm_final_exp`` is printed beside the full build's
  (the ``kernel12 split:`` line).
- kernel 11: ``tm_g2_aggregate`` at (1, 150) (one QC's 150 signer keys,
  the device route's assembly), the (64, 150) forest (the no-library QC
  engine's launch, each tree the keys rotated) and 256 adversarial points
  (duplicates, opposites, identities), byte for byte against the plain
  version and the sums against the host oracle; timed at (1, 150) and
  (64, 150). This tree's ``bls_kernels.cu`` is also built with
  ``kG2TreeWarps`` at each of ``TREE_WARPS`` (the ``kernel11 warps:``
  line: each build checked at the three shapes and timed beside the
  full one).
- kernel 13: ``g2_aggregate_sharded``'s schedule (``ops/shard_reduce.py``
  of this tree) over ``chip_smoke.MESH_SHARDS`` (8) shards on the card
  with each build's ``tm_g2_aggregate`` and ``tm_g2_add``, at the 150
  keys, the 256 adversarial points and 5 points, against the plain
  schedule on the CPU byte for byte and the host sum; ``tm_g2_add`` in
  one launch of ``chip_smoke.BRANCH_PAIRS`` (a pair for each branch: p or
  q at infinity, p = q in two representations, p = -q, y = 0), against
  ``g2_add_plain``: this tree must agree, another tree's pairs that
  differ are printed. Timed: the sharded sum at 150 keys and
  ``tm_g2_add`` at one pair.

With ``--parent``, a child process per turn (``--turn-tree ROOT``)
imports that tree's package, builds its kernels and times its main
paths on the card as ``chip_smoke.py`` does: with kernel 2 or 3,
``ValidatorSet.verify_commit`` of 8 commits of a seeded 150-validator
set (after 2 commits of another set, so the first timed height holds the
key tables' build and nothing of the process's set-up); with kernel 8,
the 64 x 150 blocksync window hashed on the card (``blocksync_dev:``,
with its host share); with kernel 4, 32 commits through
``BatchVerifier(table_cache_capacity=64)`` (one generic launch a height,
its count checked) and that verifier's
``prewarm_buckets(tiers=("generic",))`` (without ``--parent``, one turn of
this tree); with kernel 5 or 6, the 64-commit x 150-validator blocksync
window with host-hashed challenges through a started ``VerifyScheduler``, 3
times (the first builds the big tables), its verdicts and bitmap checked;
with kernel 10, the 3,200 rows through ``BatchVerifier._verify_secp_device``
(host prep, copies, the kernel; median of 3 after a first call, the
verdicts checked); with kernel 11 or 12, ``check_pairs`` at 2 pairs on the card (median
of 5) beside the native host library's ``pairing_check`` on the same
pairs, and the 64-QC window over the 150 validators on the device route
(``TM_TPU_BLS_PAIRING_DEVICE=1``): its assembly (``assemble_qc``, then
each QC's signature and signer-key sums on the card, timed apart) and
its check through a started ``VerifyScheduler``, twice, its verdicts
checked (without ``--parent``, one turn of this tree). Prints a
``kernelN:`` line per kernel and build, a ``commit:``, ``generic:``,
``secp:``, ``blocksync:`` and ``pairing:`` line per tree, every number again as one
JSON object on a line of its own, the ``nvidia-smi`` name and power
limit, and last the ``{"ok": true, ...}`` object. Exits non-zero without
CUDA or on any disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL = os.path.join("tendermint_tpu_torch", "ops", "csrc", "ed25519_kernels.cu")
REPS = 20  # launches per median, as chip_smoke.py times its kernels
COMMIT_HEIGHTS = 8  # commits a tree verifies in each commit turn
WARM_HEIGHTS = 2  # commits of another validator set verified before them
GENERIC_HEIGHTS = 32  # commits a tree verifies on the generic kernel a turn
WINDOW_REPS = 3  # blocksync windows a tree verifies in each turn
N_VALS = 150
# kernel 6: (rows, padding rows) checked, and the sizes timed
K6_SIZES = ((1, 0), (23, 2), (2048, 64))
K6_LIVE, K6_BUCKET = 9600, 16384  # the blocksync window's rows and bucket
# kernel 5: keys checked and timed
K5_SIZES = (16, 256)
# kernel 2: keys checked and timed (one group; a partial last warp; the
# commit path's 150 validators; the smoke's 256 keys)
K2_SIZES = (1, 23, 150, 256)
SHA_KERNEL = os.path.join("tendermint_tpu_torch", "ops", "csrc", "sha512_kernels.cu")
# kernel 8: the blocksync window's live rows (R || A || sign bytes of
# K8_MSG_LEN bytes, 2 blocks a row) and bucket (padding rows, 1 block), the
# smoke's ragged rows (0-1,000-byte messages, 1-9 blocks) and a batch of
# them that leaves a partial last warp
K8_LIVE, K8_BUCKET, K8_RAGGED, K8_PARTIAL = 9600, 16384, 2048, 1000
K8_MSG_LEN = (113, 118)
# kernel 8's time split: sha512_device.cuh with the rounds emptied (the
# loads alone: each block's words folded into the state), the global loads
# emptied (the rounds on words made in registers) or the reduction emptied
# (k the digest's first words), timed beside the full build (their values
# wrong); a variant is the list of patches it makes
SHA_DEVICE_H = "sha512_device.cuh"
SHA_SPLITS = {
    "rounds emptied": [(SHA_DEVICE_H, "  for (int i = 0; i < 80; i++) {\n    if (i >= 16) {",
                        "  for (int i = 0; i < 16; i++) {\n    a ^= w[i];\n    continue;"
                        "\n    if (i >= 16) {")],
    "loads emptied": [(SHA_DEVICE_H, "      r[q] = reinterpret_cast<const w128*>(\n"
                       "          msg + ((size_t)(row0 + row) * nblk + blk) * 128)[lane & 7];",
                       "      r[q].x = row0 + row;\n      r[q].y = blk;\n      r[q].z = lane;\n"
                       "      r[q].w = q;")],
    "reduce emptied": [(SHA_DEVICE_H, "  sc_reduce(k, dig);",
                        "  for (int j = 0; j < 4; j++) k[j] = st[j];")],
}
# opcodes counted in kernel 8's, 9's and 1's SASS
SASS_OPS = ("SHF", "PRMT", "LOP3", "IADD3", "IMAD", "LDG", "LDS", "STS", "STG", "SHFL",
            "REDUX")
SHA256_KERNEL = os.path.join("tendermint_tpu_torch", "ops", "csrc", "sha256_kernels.cu")
# kernel 9: the L2 block's leaf batch (K9_TXS transactions of K9_TX_LEN bytes
# and two payload leaves, padded to K9_LEAF rows and the block axis to 32),
# its first K9_PARTIAL rows (a partial last warp), merkle_leaf_hash's
# one-block rows and merkle_inner_hash's two-block rows
K9_LEAF, K9_TXS, K9_TX_LEN, K9_PARTIAL = 4096, 4000, (100, 1024), 1000
K9_INNER = 2048
# kernel 9's variants: each is a list of alternatives, a list of patches
# (file, old, new) each, and a tree takes the first alternative that fits
# it (fitting_patches): this tree's sha256_device.cuh, or the one-thread
# sha256_kernels.cu it replaced. The splits empty the rounds (the loads
# alone: each block's words folded into the state) or the global loads
# (the rounds on words made in registers), timed beside the full build
# (their values wrong).
SHA256_H, SHA256_CU = "sha256_device.cuh", "sha256_kernels.cu"
SHA256_ROUNDS = ("  for (int i = 0; i < 64; i++) {\n    if (i >= 16) {",
                 "  for (int i = 0; i < 16; i++) {\n    a ^= w[i];\n    continue;"
                 "\n    if (i >= 16) {")
SHA256_SPLITS = {
    "rounds emptied": [[(SHA256_H, *SHA256_ROUNDS)], [(SHA256_CU, *SHA256_ROUNDS)]],
    "loads emptied": [
        [(SHA256_H, "      r[q] = reinterpret_cast<const w128*>(\n"
          "          msg + ((size_t)(row0 + row) * nblk + blk) * 64)[lane & 3];",
          "      r[q].x = row0 + row;\n      r[q].y = blk;\n      r[q].z = lane;\n"
          "      r[q].w = q;")],
        [(SHA256_CU, "  for (int i = 0; i < 16; i++) w[i] = load_be32(blk + 4 * i);",
          "  for (int i = 0; i < 16; i++) w[i] = (uint32_t)(size_t)blk + i;")]],
}
# kernel 9's block size: this tree's sha256_kernels.cu at 64 threads (two
# warps) a block, checked and timed in turns beside its own
SHA256_BLOCK_VARIANTS = {"64 threads": [[(SHA256_CU, "constexpr int kThreads = 32;",
                                          "constexpr int kThreads = 64;")]]}
# kernel 1: points checked and timed (one group; the smoke's partial last
# warp; the Pallas microbenchmark's 8,192), doublings a chain, and the
# shorter chains checked at K1_SIZES[1] points
K1_SIZES, K1_DBL, K1_SHORT = (1, 150, 8192), 256, (1, 16)
# kernel 1's exchange emptied (this tree: the four lanes' products kept,
# the shuffles of Shfl4 gone; timing only), alternatives as kernel 9's
ED_CU = "ed25519_kernels.cu"
K1_EXCHANGE = {"exchange emptied": [[(ED_CU, "      o0.v[j] = __shfl_sync(mask, v, 0, 4);\n"
                                      "      o1.v[j] = __shfl_sync(mask, v, 1, 4);\n"
                                      "      o2.v[j] = __shfl_sync(mask, v, 2, 4);\n"
                                      "      o3.v[j] = __shfl_sync(mask, v, 3, 4);",
                                      "      o0.v[j] = v;\n      o1.v[j] = v + 1;\n"
                                      "      o2.v[j] = v + 2;\n      o3.v[j] = v + 3;")]]}
BLS_KERNEL = os.path.join("tendermint_tpu_torch", "ops", "csrc", "bls_kernels.cu")
SECP_KERNEL = os.path.join("tendermint_tpu_torch", "ops", "csrc", "secp256k1_kernels.cu")
# kernel 10: the mixed window's live rows and bucket, the distinct signed
# rows tiled to them, a shard's rows, and the _verify_secp_device calls a turn
K10_LIVE, K10_BUCKET, K10_SIGNED, K10_SHARD = 3200, 8192, 400, 1024
SECP_REPS = 3
KERNEL_NAMES = {1: ("dbl_chain_kernel",),
                2: ("neg_pubkey_table_kernel",),
                3: ("verify_table_kernel",),
                4: ("verify_generic_kernel", "verify_table_kernel"),
                5: ("neg_pubkey_bigtable_kernel",),
                6: ("verify_bigcache_kernel",),
                8: ("challenge_kernel",),
                9: ("sha256_kernel",),
                10: ("secp_verify_kernel",),
                11: ("g1_aggregate_kernel", "g2_aggregate_kernel"),
                12: ("miller_kernel", "chunk_product_kernel", "final_exp_kernel"),
                13: ("g1_add_kernel", "g2_add_kernel")}
BLS_KERNELS = (11, 12, 13)  # the kernels of bls_kernels.cu
ALL_KERNELS = (1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13)
PAIRING_REPS = 5  # check_pairs and native pairing_check calls per turn
# kernel 12's time split: builds of this tree's bls_kernels.cu with one part
# of run_program (bls12_381_device.cuh) emptied, timed beside the full one
# (their values are wrong; only their times are read)
DEVICE_H, KERNELS_CU = "bls12_381_device.cuh", "bls_kernels.cu"
SPLITS = {
    "product stages emptied": [
        (DEVICE_H, "        fq_mul_n<2>(r, a, b);",
         "        r[0] = a[0];\n        r[1] = a[1];"),
        (DEVICE_H, "        fq_mul(r, a, b);", "        r = a;")],
    "addition stages emptied": [
        (DEVICE_H, "      if (l < nj) alu_job(w, j0, flags);\n"
         "      if (l + 32 < nj) alu_job(w, j1, flags);", "")],
    "inversion emptied": [
        (DEVICE_H, "      fq_inv(r, w.ld(job_a(j0)));", "      r = w.ld(job_a(j0));")],
}
# kernel 10's time split: builds of this tree's secp256k1_kernels.cu with
# the product or the addition stages of run_program (secp256k1_device.cuh)
# emptied, timed beside the full one
SECP_DEVICE_H = "secp256k1_device.cuh"
SECP_SPLITS = {
    "product stages emptied": [
        (SECP_DEVICE_H, "      fs_mul(r, w.ld(job_a(j0)), w.ld(job_b(j0)));",
         "      r = w.ld(job_a(j0));")],
    "addition stages emptied": [
        (SECP_DEVICE_H, "    alu_chain<st, 0>(w, l);\n", "")],
}
# kernel 10's latencies: one warp, each lane a chain of LATENCY_OPS dependent
# fs_mul (v 0) or fs_add_sub (v 1) of secp256k1_device.cuh, to set a
# product stage's and an addition stage's cost beside their arithmetic
LATENCY_OPS = 4096
SECP_LATENCY_CU = r"""
#include <cuda_runtime.h>
#include "{header}"
using namespace sdev;
template <int V>
__global__ void chain(fs* io, int n) {{
  fs x = io[threadIdx.x], y = io[32 + threadIdx.x];
  for (int k = 0; k < n; k++) {{
    if (V == 0) fs_mul(x, x, y);
    else fs_add_sub(x, x, y, k & 1);
  }}
  io[threadIdx.x] = x;
}}
extern "C" int tm_secp_latency(void* io, int n, int v, void* stream) {{
  if (v == 0) chain<0><<<1, 32, 0, (cudaStream_t)stream>>>((fs*)io, n);
  else chain<1><<<1, 32, 0, (cudaStream_t)stream>>>((fs*)io, n);
  return (int)cudaGetLastError();
}}
"""
# kernel 11's warps a tree: builds of this tree's bls_kernels.cu with
# kG2TreeWarps set to each, checked and timed beside the full build
TREE_WARPS = (8, 32)
G2_WARPS_LINE = "constexpr int kG2TreeWarps = 16;"
WARP_VARIANTS = {f"{n} warps": [(KERNELS_CU, G2_WARPS_LINE, G2_WARPS_LINE.replace("16", str(n)))]
                 for n in TREE_WARPS}
# the G1 sums' lanes a group (kernels 11 and 13): this tree's bls_kernels.cu
# with the tree's and the pair sum's group widths swapped (8 and 4), checked
# and timed beside the full build (4 and 8)
LANE_VARIANTS = {"tree 8 lanes, add 4 lanes": [
    (KERNELS_CU, "kG1TreeLanes = 4;", "kG1TreeLanes = 8;"),
    (KERNELS_CU, "kG1AddLanes = 8;", "kG1AddLanes = 4;")]}
N_SHARDED_SMALL = 5  # kernel 13's case of fewer points than shards


def chip_smoke():
    """This tree's chip_smoke.py as a module (its helpers import the
    package lazily, from whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_build(torch_build, src: str, tag: str):
    """(nvcc -shared process, nvcc -cubin -Xptxas -v process, .so path)."""
    out_dir = torch_build.BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"chip_kernels_{tag}.so")
    flags = [torch_build._nvcc(), torch_build.ARCH, "-std=c++17", "-O3"]
    shared = subprocess.Popen(
        flags + ["-shared", "-Xcompiler", "-fPIC", "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    cubin = subprocess.Popen(
        flags + ["-cubin", "-Xptxas", "-v", "-o",
                 os.path.join(out_dir, f"chip_kernels_{tag}.cubin"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return shared, cubin, so


def start_variant_builds(torch_build, variants: dict, tag: str,
                         kernel: str = BLS_KERNEL, root: str = ROOT) -> dict:
    """{variant: (nvcc process, .so path)}: the `kernel` (a .cu file of
    ops/csrc) of the tree at `root` with each variant's patches (file, old,
    new), each in a directory of its own under _kbuild."""
    csrc = os.path.join(root, os.path.dirname(kernel))
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        d = os.path.join(torch_build.BUILD_DIR, f"chip_kernels_{tag}{i}")
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                with open(os.path.join(csrc, f)) as src, open(os.path.join(d, f), "w") as dst:
                    dst.write(src.read())
        for fname, old, new in patches:
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            assert text.count(old) == 1, f"variant {name!r}: {old!r} not found once"
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        so = os.path.join(d, "variant.so")
        procs[name] = (subprocess.Popen(
            [torch_build._nvcc(), torch_build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", so, os.path.join(d, os.path.basename(kernel))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return procs


def fitting_patches(root: str, alternatives: list) -> list:
    """The first of a variant's alternatives (lists of patches) that fits
    the tree at `root`: each old text once in its file of ops/csrc. A
    tree none fits stops the call."""
    csrc = os.path.join(root, os.path.dirname(SHA_KERNEL))
    for patches in alternatives:
        if all(os.path.exists(os.path.join(csrc, f))
               and open(os.path.join(csrc, f)).read().count(old) == 1
               for f, old, _ in patches):
            return patches
    raise RuntimeError(f"no alternative of a variant fits the tree at {root}")


def sass_lines(torch_build, path: str, kernel: str) -> list:
    """(address, opcode, line) of each instruction of `kernel` in the SASS
    of a cubin or shared library (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(torch_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], check=True,
                         capture_output=True, text=True).stdout
    cs = chip_smoke()
    lines = []
    current = None
    for ln in out.splitlines():
        if "Function : " in ln:
            current = cs.kernel_name(ln.split("Function : ")[1].strip())
            continue
        if current != kernel:
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m:
            lines.append((int(m.group(1), 16), m.group(2), ln))
    return lines


def op_counts(lines) -> dict:
    """The total and the SASS_OPS opcodes of sass_lines' instructions."""
    counts = {"total": len(lines)}
    for _, op, _ in lines:
        op = op.split(".")[0]
        if op in SASS_OPS:
            counts[op] = counts.get(op, 0) + 1
    return counts


def sass_counts(torch_build, path: str, kernel: str) -> dict:
    """Instructions of `kernel` in the SASS of a cubin or shared library
    (cuobjdump -sass): the total and the SASS_OPS opcodes."""
    return op_counts(sass_lines(torch_build, path, kernel))


def sass_loop_counts(torch_build, path: str, kernel: str) -> dict:
    """op_counts of `kernel`'s first loop: the instructions from the lowest
    target of a backward branch to that branch (a rolled loop's body;
    code a branch out of it reaches, as the divergent path of a shuffle,
    lies after it and is not counted)."""
    lines = sass_lines(torch_build, path, kernel)
    back = []
    for addr, op, ln in lines:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", ln)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    if not back:
        raise RuntimeError(f"{kernel} has no loop in {path}")
    lo, hi = min(back)
    return op_counts([x for x in lines if lo <= x[0] <= hi])


def bind(lib):
    """Set the argument and result types of the launchers `lib` has."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "tm_neg_pubkey_table": [vp, vp, vp, vp, i, vp],
        "tm_challenge": [vp, i, vp, vp, i, vp],
        "tm_sha256": [vp, i, vp, vp, i, vp],
        "tm_dbl_chain": [vp, vp, i, i, vp],
        "tm_verify_table": [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
        "tm_verify_generic": [vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
        "tm_verify_bigcache": [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
        "tm_neg_pubkey_bigtable": [vp, vp, vp, vp, i, vp],
        "tm_secp_verify": [vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
        "tm_miller": [vp, vp, vp, vp, vp, vp, vp, i, vp],
        "tm_final_exp": [vp, vp, i, vp],
        "tm_g1_aggregate": [vp, vp, vp, i, i, i, vp],
        "tm_g1_add": [vp, vp, vp, i, vp],
        "tm_g2_aggregate": [vp, vp, vp, i, i, i, vp],
        "tm_g2_add": [vp, vp, vp, i, vp],
    }
    for name, args in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
    if hasattr(lib, "tm_error_string"):
        lib.tm_error_string.argtypes = [i]
        lib.tm_error_string.restype = ctypes.c_char_p
    return lib


def start_latency_build(torch_build):
    """(nvcc process, .so path) of SECP_LATENCY_CU over this tree's
    secp256k1_device.cuh, in _kbuild."""
    os.makedirs(torch_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(torch_build.BUILD_DIR, "chip_kernels_secp_latency.cu")
    with open(src, "w") as f:
        f.write(SECP_LATENCY_CU.format(header=os.path.join(
            ROOT, os.path.dirname(SECP_KERNEL), SECP_DEVICE_H)))
    so = src[:-3] + ".so"
    return subprocess.Popen(
        [torch_build._nvcc(), torch_build.ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def secp_latency_ns(torch, proc, so: str, cs) -> dict:
    """ns a dependent fs_mul and fs_add_sub on one warp (median of REPS
    launches of LATENCY_OPS each, CUDA events)."""
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out}")
    lib = ctypes.CDLL(so)
    lib.tm_secp_latency.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    io = torch.randint(0, 1 << 31, (64 * 8,), dtype=torch.int32, device="cuda")
    ns = {}
    for v, name in enumerate(("fs_mul", "fs_add_sub")):
        def run():
            assert lib.tm_secp_latency(io.data_ptr(), LATENCY_OPS, v,
                                       torch.cuda.current_stream().cuda_stream) == 0
        ns[name] = cs.time_cuda(torch, run, REPS) * 1e6 / LATENCY_OPS
    return ns


class Build:
    """One tree's build of ed25519_kernels.cu (kernels 1-6),
    sha512_kernels.cu (kernel 8), sha256_kernels.cu (kernel 9),
    secp256k1_kernels.cu (kernel 10) or bls_kernels.cu (kernels 11, 12,
    13), loaded: its launchers on torch tensors, and each kernel's ptxas
    line."""

    def __init__(self, shared, cubin, so: str, ptxas_usage, kernels):
        outs = [proc.communicate()[0] for proc in (shared, cubin)]
        for proc, out in zip((shared, cubin), outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{out}")
        with open(so.replace(".so", ".ptxas.txt"), "w") as f:
            f.write(outs[1])
        self.so, self.cubin = so, so.replace(".so", ".cubin")
        usage = ptxas_usage(outs[1])
        self.ptxas = {n: "; ".join(f"{name}: {usage.get(name, 'not reported')}"
                                   for name in KERNEL_NAMES[n]) for n in kernels}
        self.lib = bind(ctypes.CDLL(so))

    def _check(self, err: int) -> None:
        if err:
            msg = (self.lib.tm_error_string(err).decode()
                   if hasattr(self.lib, "tm_error_string") else f"CUDA error {err}")
            raise RuntimeError(f"launch failed: {msg}")

    def verify(self, name: str, torch, tables, tvalid, idx, r, s, k, s_ok, base, kc):
        """tm_verify_table or tm_verify_bigcache -> [b] bool."""
        out = torch.empty(idx.shape[0], dtype=torch.bool, device=idx.device)
        self._check(getattr(self.lib, name)(
            tables.data_ptr(), tvalid.data_ptr(), tables.shape[0],
            idx.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(),
            s_ok.data_ptr(), base.data_ptr(), kc.data_ptr(), out.data_ptr(),
            idx.shape[0], torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def generic(self, torch, pub, r, s, k, s_ok, base, kc):
        """tm_verify_generic -> [b] bool."""
        out = torch.empty(pub.shape[0], dtype=torch.bool, device=pub.device)
        self._check(self.lib.tm_verify_generic(
            pub.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(),
            s_ok.data_ptr(), base.data_ptr(), kc.data_ptr(), out.data_ptr(),
            pub.shape[0], torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def secp(self, torch, qx, qy, u1, u2, r, ok_in, gtab):
        """tm_secp_verify on ops/secp256k1_kernel's operands -> [b] bool."""
        out = torch.empty(qx.shape[0], dtype=torch.bool, device=qx.device)
        self._check(self.lib.tm_secp_verify(
            qx.data_ptr(), qy.data_ptr(), u1.data_ptr(), u2.data_ptr(), r.data_ptr(),
            ok_in.data_ptr(), gtab.data_ptr(), out.data_ptr(), qx.shape[0],
            torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def table(self, torch, pub, kc):
        """tm_neg_pubkey_table -> (tables [n, 16, 4, 32], valid [n])."""
        n = pub.shape[0]
        tables = torch.empty((n, 16, 4, 32), dtype=torch.uint8, device=pub.device)
        valid = torch.empty(n, dtype=torch.bool, device=pub.device)
        self._check(self.lib.tm_neg_pubkey_table(
            pub.data_ptr(), tables.data_ptr(), valid.data_ptr(), kc.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        ))
        return tables, valid

    def challenge(self, torch, buf, cnt):
        """tm_challenge on [b, nblk * 128] u8 (16-byte aligned) and [b]
        int32 -> [b, 32] canonical k."""
        assert buf.data_ptr() % 16 == 0
        out = torch.empty((buf.shape[0], 32), dtype=torch.uint8, device=buf.device)
        self._check(self.lib.tm_challenge(
            buf.data_ptr(), buf.shape[1] // 128, cnt.data_ptr(), out.data_ptr(),
            buf.shape[0], torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def sha256(self, torch, buf, cnt):
        """tm_sha256 on [b, nblk * 64] u8 (16-byte aligned) and [b] int32 ->
        [b, 32] digests."""
        assert buf.data_ptr() % 16 == 0
        out = torch.empty((buf.shape[0], 32), dtype=torch.uint8, device=buf.device)
        self._check(self.lib.tm_sha256(
            buf.data_ptr(), buf.shape[1] // 64, cnt.data_ptr(), out.data_ptr(),
            buf.shape[0], torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def dbl_chain(self, torch, pts, n_dbl: int):
        """tm_dbl_chain on [b, 4, 32] u8 points -> [b, 4, 32]."""
        out = torch.empty_like(pts)
        self._check(self.lib.tm_dbl_chain(
            pts.data_ptr(), out.data_ptr(), pts.shape[0], n_dbl,
            torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def bigtable(self, torch, pub, kc):
        """tm_neg_pubkey_bigtable -> (tables [n, 64, 16, 4, 32], valid [n])."""
        n = pub.shape[0]
        tables = torch.empty((n, 64, 16, 4, 32), dtype=torch.uint8, device=pub.device)
        valid = torch.empty(n, dtype=torch.bool, device=pub.device)
        self._check(self.lib.tm_neg_pubkey_bigtable(
            pub.data_ptr(), tables.data_ptr(), valid.data_ptr(), kc.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        ))
        return tables, valid

    def miller(self, torch, xp, yp, xq, yq, valid):
        """tm_miller on chunk tensors (ops/bls_pairing.miller's operands) ->
        the product of the chunks' Miller values, [6, 2, 48] bytes."""
        c = xp.shape[0]
        out = torch.empty((6, 2, 48), dtype=torch.uint8, device=xp.device)
        scratch = torch.empty(c * 72, dtype=torch.int64, device=xp.device)
        self._check(self.lib.tm_miller(
            xp.data_ptr(), yp.data_ptr(), xq.data_ptr(), yq.data_ptr(),
            valid.data_ptr(), scratch.data_ptr(), out.data_ptr(), c,
            torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def final_exp(self, torch, f):
        """tm_final_exp on [N, 6, 2, 48] bytes."""
        out = torch.empty_like(f)
        self._check(self.lib.tm_final_exp(
            f.data_ptr(), out.data_ptr(), f.shape[0],
            torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def aggregate(self, g: str, torch, pts):
        """tm_g1_aggregate or tm_g2_aggregate (`g` "g1", "g2") on [T, B,
        *point] bytes -> [T, *point] (ops/bls_g*.g*_aggregate's operands
        and scratch: three Fp or Fp2 elements a leaf)."""
        t, b = pts.shape[:2]
        nb = 1 << max(1, (b - 1).bit_length())
        out = torch.empty((t, *pts.shape[2:]), dtype=torch.uint8, device=pts.device)
        scratch = torch.empty(t * nb * (18 if g == "g1" else 36), dtype=torch.int64,
                              device=pts.device)
        self._check(getattr(self.lib, f"tm_{g}_aggregate")(
            pts.data_ptr(), scratch.data_ptr(), out.data_ptr(), t, b, nb,
            torch.cuda.current_stream().cuda_stream,
        ))
        return out

    def add(self, g: str, torch, p, q):
        """tm_g1_add or tm_g2_add on two [n, *point] batches."""
        out = torch.empty_like(p)
        self._check(getattr(self.lib, f"tm_{g}_add")(
            p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[0],
            torch.cuda.current_stream().cuda_stream,
        ))
        return out


class VariantBuild(Build):
    """A SPLITS, WARP_VARIANTS or LANE_VARIANTS build of bls_kernels.cu, a
    SECP_SPLITS build of secp256k1_kernels.cu, a SHA_SPLITS build of
    sha512_kernels.cu, a SHA256_SPLITS or SHA256_BLOCK_VARIANTS build of
    sha256_kernels.cu or a K1_EXCHANGE build of ed25519_kernels.cu,
    loaded: Build's launchers."""

    def __init__(self, proc, so: str):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out}")
        self.so = so
        self.lib = bind(ctypes.CDLL(so))


def _validator_set(tree: str, seed: int):
    """(types, host, vset, by_addr, rng) of the seeded 150-validator set,
    by the package of the tree at `tree`."""
    sys.path.insert(0, tree)
    import numpy as np

    from tendermint_tpu_torch import types
    from tendermint_tpu_torch.crypto import ed25519 as host

    assert types.__file__.startswith(tree), types.__file__
    rng = np.random.default_rng(seed)
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(N_VALS)]
    vset = types.ValidatorSet([
        types.Validator(k.public_key(), int(p))
        for k, p in zip(keys, rng.integers(1, 100, N_VALS).tolist())
    ])
    by_addr = {k.public_key().address(): k for k in keys}
    return types, host, vset, by_addr, rng


def commit_ms(types, vset, by_addr, rng, chain_id: str, verifier=None,
              heights: int = COMMIT_HEIGHTS) -> list[float]:
    """ms of each ValidatorSet.verify_commit of `heights` commits, through
    `verifier` (the process default when None)."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv

    assert (verifier or bv.default_verifier()).device.type == "cuda"
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
        vset.verify_commit(chain_id, bid, h, commit, verifier=verifier)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def generic_turn(types, vset, by_addr, rng, chain_id: str) -> dict:
    """Kernel 4's main paths: commit_ms of GENERIC_HEIGHTS commits through a
    BatchVerifier whose table cache holds 64 keys (each 150-row round on
    the generic kernel, one launch a height), then that verifier's
    prewarm_buckets on the generic tier alone (one launch a rung,
    all-rejected rows): ms a height, the prewarm's wall ms and each
    launch's (bucket, ms)."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    verifier = bv.BatchVerifier(table_cache_capacity=64)
    n0 = eb.verify_prehashed.launches
    commit = commit_ms(types, vset, by_addr, rng, chain_id, verifier, GENERIC_HEIGHTS)
    assert eb.verify_prehashed.launches - n0 == GENERIC_HEIGHTS, "not the generic kernel"
    t0 = time.perf_counter()
    entries = verifier.prewarm_buckets(tiers=("generic",))
    wall = (time.perf_counter() - t0) * 1e3
    assert entries and all(e["tier"] == "generic" for e in entries), entries
    return {"commit": commit, "prewarm_ms": wall,
            "prewarm": [[e["bucket"], e["seconds"] * 1e3] for e in entries]}


def blocksync_ms(types, host, vset, by_addr, rng, chain_id: str,
                 device_hash: bool = False) -> dict:
    """The 64-commit window through a started VerifyScheduler, WINDOW_REPS
    times on a fresh BatchVerifier, host-hashed (or hashed on the card:
    device_challenge_min=2048, the smoke's device_hash path), checked as
    chip_smoke.py checks it: wall ms, device-round ms and the host share
    (the wall outside the device round) per window."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry

    cs = chip_smoke()
    bad = 40
    entries, tampered = cs.signed_window(host, types, vset, by_addr, chain_id,
                                         cs.WINDOW, bad, rng)
    os.environ.pop("TM_TPU_MXU_GATHER", None)
    verifier = bv.BatchVerifier(shape_registry=ShapeRegistry(),
                                device_challenge_min=2048 if device_hash else None)
    assert verifier.device.type == "cuda"
    verdicts, walls, _, bitmap, items, ledger = cs.run_window(
        verifier, vset, chain_id, entries, WINDOW_REPS, "blocksync")
    cs.check_window(host, verdicts, bitmap, items, ledger, cs.WINDOW, bad,
                    tampered, N_VALS, rng, "blocksync")
    rounds = ledger[:WINDOW_REPS]
    return {"wall_ms": [w * 1e3 for w in walls],
            "device_ms": [e["device_s"] * 1e3 for e in rounds],
            "host_share": [(w - e["queue_wait_s"] - e["device_s"] + e["host_prep_s"]) / w
                           for w, e in zip(walls, rounds)]}


def pairing_turn(types, host, vset, by_addr, rng, chain_id: str) -> dict:
    """check_pairs at 2 pairs on the card beside the native library's
    pairing_check on the same pairs (ms, PAIRING_REPS calls each), then the
    64-QC window on the device route (chip_smoke.qc_route, twice, its
    verdicts checked): the assembly's ms (assemble_qc, and the signature
    and signer-key sums on the card), wall ms per window and the pairing
    checks' ms."""
    import torch

    from tendermint_tpu_torch import ops
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.crypto import bls_native
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.ops import bls_pairing as bp
    from tendermint_tpu_torch.types import quorum_cert as qcm

    cs = chip_smoke()
    dev = torch.device("cuda")

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "big") % (c.R - 1) + 1

    def g2(k):
        return bls._g2_mul_point(c.G2_GEN, k)

    k = scalar()
    pairs = [(bls._g1_mul_point(c.G1_GEN, k), c.G2_GEN),
             (c.g1_neg(c.G1_GEN), g2(k))]
    g1b = b"".join(bls.g1_to_bytes(p) for p, _ in pairs)
    g2b = b"".join(bls.g2_to_bytes(q) for _, q in pairs)
    assert bls_native.pairing_check(g1b, g2b, len(pairs))
    assert bp.check_pairs(pairs, dev)  # the first call builds the kernels
    native, card = [], []
    for _ in range(PAIRING_REPS):
        t0 = time.perf_counter()
        assert bls_native.pairing_check(g1b, g2b, len(pairs))
        native.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        assert bp.check_pairs(pairs, dev)
        card.append((time.perf_counter() - t0) * 1e3)
    entries, _ = cs.signed_window(host, types, vset, by_addr, chain_id, cs.WINDOW,
                                  0, rng)
    qset, vals, privs, _ = cs.qc_keys(types, bls, qcm, vset, chain_id, entries,
                                      scalar, g2)
    os.environ[cs.BLS_GATE] = "1"
    try:
        r = cs.qc_route(torch, ops, bls, qcm, qset, vals, privs, chain_id, entries,
                        ("_pairing_is_one",), True)
    finally:
        os.environ.pop(cs.BLS_GATE, None)
    want = [h != cs.QC_BAD for h in range(1, cs.WINDOW + 1)]
    assert all(v == want for v in r["verdicts"]), "qc window verdicts"
    return {"check_pairs_ms": card, "native_ms": native,
            "assemble_ms": r["assemble_s"] * 1e3,
            "sums_ms": {g: t * 1e3 for g, t in r["sums_s"].items()},
            "qc_wall_ms": [w * 1e3 for w in r["walls"]],
            "qc_pairing_ms": [a.get("_pairing_is_one", 0.0) * 1e3 for a in r["splits"]],
            "qc_checks": r["win_launches"]["final_exp"] // 2}


def sharded_turn(rng) -> dict:
    """Kernel 13 through this package's wrappers: g1/g2_aggregate_sharded
    of N_VALS seeded points over MESH_SHARDS shards of the card, each
    checked against the host sum, then median ms of REPS calls (CUDA
    events)."""
    import torch

    from tendermint_tpu_torch.parallel.mesh import Mesh

    cs = chip_smoke()
    dev = torch.device("cuda")
    mesh = Mesh([dev] * cs.MESH_SHARDS)
    out = {}
    for g in ("g1", "g2"):
        keys = seeded_points(rng, g, N_VALS)
        pts = point_stack(torch, g, keys, dev)
        eq, mod = group(g)[3:]
        kern = getattr(mod, g + "_aggregate_sharded")
        assert eq(getattr(mod, g + "_to_host")(kern(pts, mesh)), host_sum(g, keys)), g
        out[g] = cs.time_cuda(torch, lambda: kern(pts, mesh), REPS)
    return out


def secp_signed(rng) -> tuple[list, list[bool]]:
    """K10_SIGNED seeded secp256k1 rows (pubkey, msg, sig) of 50 keys, one
    in four invalid (a flipped s, a wrong message, another key), and each
    row's verdict by the host oracle."""
    from tendermint_tpu_torch.crypto import secp256k1 as host

    keys = [host.PrivKey.from_secret(rng.bytes(32)) for _ in range(50)]
    rows, want = [], []
    for i in range(K10_SIGNED):
        k = keys[i % 50]
        msg = rng.bytes(40)
        sig = k.sign(msg)
        pub = k.public_key().data
        if i % 8 == 1:
            sig = sig[:60] + bytes([sig[60] ^ 4]) + sig[61:]
        elif i % 8 == 3:
            msg += b"!"
        elif i % 8 == 5:
            pub = keys[(i + 1) % 50].public_key().data
        rows.append((pub, msg, sig))
        want.append(host.PubKey(pub).verify(msg, sig))
    return rows, want


def secp_turn(rng) -> dict:
    """Kernel 10's main path: the K10_LIVE rows (secp_signed tiled) through
    BatchVerifier._verify_secp_device (host prep, padding to the shape
    registry's bucket, copies, tm_secp_verify), once, then SECP_REPS timed
    calls, each checked against the host oracle, one launch each."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk

    signed, want = secp_signed(rng)
    reps = K10_LIVE // K10_SIGNED
    items = [bv.SigItem(pub, msg, sig, "secp256k1") for pub, msg, sig in signed] * reps
    verifier = bv.BatchVerifier()
    n0 = sk.verify_prehashed.launches
    assert verifier._verify_secp_device(items).tolist() == want * reps
    ms = []
    for _ in range(SECP_REPS):
        t0 = time.perf_counter()
        out = verifier._verify_secp_device(items)
        ms.append((time.perf_counter() - t0) * 1e3)
        assert out.tolist() == want * reps
    assert sk.verify_prehashed.launches - n0 == SECP_REPS + 1, "not one launch a call"
    return {"ms": ms, "bucket": verifier._registry.bucket_for(len(items))}


def turn(tree: str, seed: int, what: list[str]) -> dict:
    """One child's turn: the main paths of the tree at `tree`. The commit
    path first verifies WARM_HEIGHTS commits of a set of other keys, so
    the first timed height holds the key tables' build and not the
    kernels' compile, the card's set-up or the base tables."""
    types, host, vset, by_addr, rng = _validator_set(tree, seed)
    out = {}
    if "commit" in what:
        warm = _validator_set(tree, seed + 1)
        commit_ms(warm[0], warm[2], warm[3], warm[4], "chip-kernels", heights=WARM_HEIGHTS)
        out["commit"] = commit_ms(types, vset, by_addr, rng, "chip-kernels")
    if "generic" in what:
        out["generic"] = generic_turn(types, vset, by_addr, rng, "chip-kernels")
    if "secp" in what:
        out["secp"] = secp_turn(rng)
    if "blocksync" in what:
        out["blocksync"] = blocksync_ms(types, host, vset, by_addr, rng, "chip-kernels")
    if "blocksync_dev" in what:
        from tendermint_tpu_torch.ops import sha512

        n0 = sha512.challenge_batch.launches
        out["blocksync_dev"] = blocksync_ms(types, host, vset, by_addr, rng,
                                            "chip-kernels", device_hash=True)
        assert sha512.challenge_batch.launches - n0 >= WINDOW_REPS, "not hashed on the card"
    if "pairing" in what:
        out["pairing"] = pairing_turn(types, host, vset, by_addr, rng, "chip-kernels")
    if "sharded" in what:
        out["sharded"] = sharded_turn(rng)
    return out


def group(g: str):
    """(host oracle's add, identity, negation and equality, the package's
    module of the group) of G1 (`g` "g1") or G2 ("g2")."""
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.ops import bls_g1, bls_g2

    if g == "g1":
        return c.g1_add, c.G1_INF, c.g1_neg, c.g1_eq, bls_g1
    return c.g2_add, c.G2_INF, c.g2_neg, c.g2_eq, bls_g2


def point_stack(torch, g: str, pts, dev):
    mod = group(g)[4]
    return torch.stack([getattr(mod, g + "_from_host")(p) for p in pts]).to(dev)


def host_sum(g: str, pts) -> tuple:
    add, acc = group(g)[:2]
    for p in pts:
        acc = add(acc, p)
    return acc


def seeded_points(rng, g: str, n: int) -> list:
    """n multiples of the group's generator by seeded scalars."""
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.crypto import bls_signatures as bls

    mul, gen = ((bls._g1_mul_point, c.G1_GEN) if g == "g1"
                else (bls._g2_mul_point, c.G2_GEN))
    return [mul(gen, int.from_bytes(rng.bytes(32), "big") % (c.R - 1) + 1)
            for _ in range(n)]


def sum_operands(torch, cs, rng, dev, g: str) -> dict:
    """Kernels 11 and 13's operands of one group on `dev`: N_VALS points
    (signatures or keys), 256 adversarial points (duplicates, opposites,
    identities), the trees of kernel 11 ({name: [T, B, *point]}) and the
    host sums."""
    _, inf, neg, _, _ = group(g)
    keys = seeded_points(rng, g, N_VALS)
    adv = seeded_points(rng, g, 200)
    adv += adv[:20] + [neg(p) for p in adv[20:40]] + [inf] * 16
    key_pts, adv_pts = point_stack(torch, g, keys, dev), point_stack(torch, g, adv, dev)
    trees = {f"1x{N_VALS}": key_pts.unsqueeze(0),
             f"{cs.WINDOW}x{N_VALS}": torch.stack(
                 [key_pts.roll(t, 0) for t in range(cs.WINDOW)]).contiguous(),
             "adversarial 256": adv_pts.unsqueeze(0)}
    return {"keys": keys, "key_pts": key_pts, "adv_pts": adv_pts, "trees": trees,
            "key_sum": host_sum(g, keys), "adv_sum": host_sum(g, adv)}


def run_kernel11(torch, cs, sums, bls_built, variants, timed_turns, report, smi) -> dict:
    """Kernel 11, both halves (tm_g1_aggregate, row 11a; tm_g2_aggregate,
    row 11b): every build and variant held against the plain version and
    the host sums at each group's trees, timed in turns at the first two,
    the variants ({group: {name: build}}) beside this tree's build."""
    out = {"plain_ms": {}, "variants_ms": {}}
    timed = []
    for g, ops in sums.items():
        eq, mod = group(g)[3:]
        plain_fn, to_host = getattr(mod, g + "_aggregate_plain"), getattr(mod, g + "_to_host")
        for name, pts in ops["trees"].items():
            t0 = time.perf_counter()
            plain = plain_fn(pts)
            if pts.is_cuda:
                torch.cuda.synchronize()
            out["plain_ms"][f"{g} {name}"] = (time.perf_counter() - t0) * 1e3
            want = ops["adv_sum"] if name == "adversarial 256" else ops["key_sum"]
            assert all(eq(to_host(t), want) for t in plain.cpu()), (g, name)
            for tag, bld in list(bls_built.items()) + list(variants[g].items()):
                got = bld.aggregate(g, torch, pts)
                if pts.is_cuda:
                    torch.cuda.synchronize()
                assert cs.max_abs_err(got, plain) == 0, \
                    f"{tag}: tm_{g}_aggregate != plain ({name})"
        timed += [f"{g} {n}" for n in list(ops["trees"])[:2]]
        print(f"kernel-vs-plain: kernel 11 of {sorted(bls_built)} and the "
              f"{sorted(variants[g])} builds: tm_{g}_aggregate at {list(ops['trees'])} "
              f"equal the plain version byte for byte and the host oracle's sums")

    def call(bld, n):
        g, name = n.split(" ", 1)
        return bld.aggregate(g, torch, sums[g]["trees"][name])

    out["ms"] = timed_turns(timed, call, bls_built)
    one1, lanes = cs.g1_tree_paths(N_VALS)
    one2, warp = cs.g2_tree_paths(N_VALS)
    report(11, "trees", out["ms"],
           f"critical paths of a tree of {N_VALS} points: G1 {lanes} on groups of "
           f"{cs.G1_TREE_LANES} lanes (one thread an addition: {one1}), G2 {warp} on "
           f"warps (one thread: {one2}); at most {cs.G1_TREE_WARPS} and "
           f"{cs.G2_TREE_WARPS} warps a tree", bls_built)
    for g, what, this in (("g1", "lanes", f"tree {cs.G1_TREE_LANES} lanes, add "
                                          f"{cs.G1_ADD_LANES} lanes"),
                          ("g2", "warps", f"{cs.G2_TREE_WARPS} warps")):
        builds = {this: bls_built["this"], **variants[g]}
        ms = out["variants_ms"][g] = {name: {
            n: cs.time_cuda(torch, lambda: call(bld, n), REPS)
            for n in timed if n.startswith(g)} for name, bld in builds.items()}
        print(f"kernel11 {what}: this tree, median ms of 20 launches of tm_{g}_aggregate "
              f"at {[n for n in timed if n.startswith(g)]} with each build: " + "; ".join(
                  f"{name} " + " / ".join(f"{t:.4f}" for t in v.values())
                  for name, v in ms.items()) + f" | {smi}")
    print(f"time: g1/g2_aggregate_plain on the card (one call, host clock) "
          f"{json.dumps({k: round(v, 2) for k, v in out['plain_ms'].items()})} | {smi}")
    return out


def run_kernel13(torch, cs, sums, bls_built, variants, timed_turns, report, smi) -> dict:
    """Kernel 13, both halves: the sharded sum's schedule (this tree's
    ops/shard_reduce.py) over MESH_SHARDS shards with each build's
    tm_g*_aggregate and tm_g*_add (and G1's lane variants), against the
    plain schedule on the CPU and the host sums; tm_g*_add on pairs of
    every branch against g*_add_plain; both timed in turns, the G1 lane
    variants beside this tree's build."""
    from tendermint_tpu_torch.ops import shard_reduce
    from tendermint_tpu_torch.parallel.mesh import Mesh

    out = {"differ": {}, "plain_sharded_cpu_ms": {}, "add_plain_ms": {}}
    sizes, one = [], {}
    for g, ops in sums.items():
        add, _, _, eq, mod = group(g)
        key_pts, keys = ops["key_pts"], ops["keys"]
        dev = key_pts.device
        mesh = Mesh([dev] * cs.MESH_SHARDS)
        ident = getattr(mod, g + "_identity")()
        sharded_plain = getattr(mod, g + "_aggregate_sharded_plain")
        add_plain, to_host = getattr(mod, g + "_add_plain"), getattr(mod, g + "_to_host")
        cases = {f"{N_VALS} points": (key_pts, ops["key_sum"]),
                 "adversarial 256": (ops["adv_pts"], ops["adv_sum"]),
                 f"{N_SHARDED_SMALL} points": (key_pts[:N_SHARDED_SMALL].contiguous(),
                                               host_sum(g, keys[:N_SHARDED_SMALL]))}

        def sharded(bld, pts, g=g, mesh=mesh, ident=ident):
            return shard_reduce.aggregate_sharded(
                pts, mesh, lambda x: bld.aggregate(g, torch, x),
                lambda p, q: bld.add(g, torch, p, q), ident)

        for name, (pts, want) in cases.items():
            plain = sharded_plain(pts.cpu(), mesh)
            assert eq(to_host(plain), want), (g, name)
            for tag, bld in list(bls_built.items()) + list(variants[g].items()):
                got = sharded(bld, pts).cpu()
                assert cs.max_abs_err(got, plain) == 0, \
                    f"{tag}: sharded {g} sum != plain ({name})"
        # tm_g*_add on pairs of every branch of the addition, in one launch
        ps, qs = cs.branch_pairs(g, keys[0], keys[1])
        p_add, q_add = point_stack(torch, g, ps, dev), point_stack(torch, g, qs, dev)
        plain = add_plain(p_add.cpu(), q_add.cpu())
        assert eq(to_host(plain[0]), add(keys[0], keys[1]))
        differ = out["differ"][g] = {}
        for tag, bld in list(bls_built.items()) + list(variants[g].items()):
            got = bld.add(g, torch, p_add, q_add).cpu()
            differ[tag] = [cs.BRANCH_PAIRS[i] for i in range(len(ps))
                           if not torch.equal(got[i], plain[i])]
        assert not differ["this"], f"this tree's tm_{g}_add != plain on {differ['this']}"
        for name, d in differ.items():
            assert name == "parent" or not d, f"{name}: tm_{g}_add != plain on {d}"
        print(f"kernel-vs-plain: kernel 13 of {sorted(bls_built)} and the "
              f"{sorted(variants[g])} builds: the sharded {g} sum over {cs.MESH_SHARDS} "
              f"shards at {list(cases)} equal to the plain schedule on the CPU byte for "
              f"byte and the host sums; tm_{g}_add on one launch of the pairs "
              f"{list(cs.BRANCH_PAIRS)} against {g}_add_plain: "
              + "; ".join(f"{tag} " + (f"differs on {d}" if d else "equal")
                          for tag, d in differ.items()))
        one[g] = (key_pts[:1].contiguous(), key_pts[1:2].contiguous(), sharded)
        sizes += [f"{g} sharded {N_VALS}", f"{g}_add 1 pair"]
        t0 = time.perf_counter()
        sharded_plain(key_pts.cpu(), mesh)
        out["plain_sharded_cpu_ms"][g] = (time.perf_counter() - t0) * 1e3
        out["add_plain_ms"][g] = cs.time_cuda(torch, lambda: add_plain(*one[g][:2]), 3)

    def call(bld, n):
        g = n[:2]
        p, q, sharded = one[g]
        return (sharded(bld, sums[g]["key_pts"]) if "sharded" in n
                else bld.add(g, torch, p, q))

    out["ms"] = timed_turns(sizes, call, bls_built)
    rounds = cs.MESH_SHARDS.bit_length() - 1
    report(13, "shapes", out["ms"],
           f"{cs.MESH_SHARDS} tree launches + {cs.MESH_SHARDS * rounds} add launches a "
           f"sharded sum; critical paths of g1_add {cs.FP_G1_ADD_KERNEL_PATH} (one "
           f"thread: {cs.FP_G1_ADD_THREAD}), g2_add {cs.FP_G2_ADD_KERNEL_PATH} (one "
           f"thread: {cs.FP_G2_ADD_THREAD})", bls_built)
    builds = {f"tree {cs.G1_TREE_LANES} lanes, add {cs.G1_ADD_LANES} lanes": bls_built["this"],
              **variants["g1"]}
    out["variants_ms"] = {name: {n: cs.time_cuda(torch, lambda: call(bld, n), REPS)
                                 for n in sizes if n.startswith("g1")}
                          for name, bld in builds.items()}
    print("kernel13 lanes: this tree, median ms of 20 of the G1 sharded sum / "
          "tm_g1_add at 1 pair with each build: " + "; ".join(
              f"{name} " + " / ".join(f"{t:.4f}" for t in v.values())
              for name, v in out["variants_ms"].items()) + f" | {smi}")
    print(f"time: g1/g2_aggregate_sharded_plain on the CPU "
          f"{json.dumps({k: round(v, 2) for k, v in out['plain_sharded_cpu_ms'].items()})} "
          f"ms (one call, host clock); g1/g2_add_plain on the card "
          f"{json.dumps({k: round(v, 2) for k, v in out['add_plain_ms'].items()})} ms | {smi}")
    return out


# cycles of the spin kernel that keeps the card busy while time_queued's
# calls are enqueued (~10 ms at the H100's 1.98 GHz boost clock)
SPIN_CYCLES = 20_000_000


def time_queued(torch, fn, reps: int) -> float:
    """ms a call of `reps` calls queued back to back behind a spin kernel,
    between two CUDA events: the card's time a call without the host's
    launch latency, which chip_smoke.time_cuda's one call between two
    events holds (tens of microseconds, the floor of a short kernel's
    time there)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def report_queued(kernel: int, what: str, times, builds, smi: str) -> None:
    for tag in builds:
        print(f"kernel{kernel} queued: {tag} tree, ms a launch of {REPS} queued back to "
              f"back behind a spin kernel at {what} {json.dumps(times[tag])} (one list "
              f"entry per turn; the card's time without the launch latency) | {smi}")


def run_kernel2(torch, cs, host, eb, pubs, pub_d, kc, built, timed_turns, report,
                smi) -> dict:
    """Kernel 2: each build's tables byte for byte against the plain version
    and its validity against the plain version and the host oracle at
    K2_SIZES keys (a valid key first, then the adversarial keys and random
    bytes, about half of them with no square root, then valid keys; 256
    all of them), timed in turns at those sizes."""
    order = [0] + list(range(200, len(pubs))) + list(range(1, 200))
    key_sets = {n: pub_d[torch.tensor(order[:n], device=pub_d.device)] for n in K2_SIZES}
    want_valid = [host.point_decompress(p) is not None for p in pubs]
    checks = []
    for n, pk in key_sets.items():
        plain_t, plain_v = eb.neg_pubkey_table_plain(pk)
        want = [want_valid[i] for i in order[:n]]
        assert plain_v.cpu().tolist() == want, f"plain validity != host oracle at {n} keys"
        for tag, bld in built.items():
            got_t, got_v = bld.table(torch, pk, kc)
            torch.cuda.synchronize()
            assert torch.equal(got_t, plain_t), f"{tag}: kernel 2 != plain at {n} keys"
            assert torch.equal(got_v, plain_v), f"{tag}: kernel 2 validity at {n} keys"
        checks.append({"keys": n, "valid": sum(want)})
    print(f"kernel-vs-plain: kernel 2 of {sorted(built)} equal to the plain version "
          f"byte for byte and its validity to the host oracle at {list(key_sets)} keys "
          f"(adversarial keys and keys with no square root included; tolerance: "
          f"exact) {json.dumps(checks)}")
    plain_ms = cs.time_cuda(torch, lambda: eb.neg_pubkey_table_plain(pub_d), 3)
    times = timed_turns(K2_SIZES, lambda bld, n: bld.table(torch, key_sets[n], kc))
    report(2, "keys", times,
           f"critical path {cs.FE_TABLE_PATH} (one thread: "
           f"{cs.FE_DECOMPRESS + cs.FE_TABLE_BUILD})")
    queued = timed_turns(K2_SIZES, lambda bld, n: bld.table(torch, key_sets[n], kc),
                         timer=time_queued)
    report_queued(2, "keys", queued, built, smi)
    print(f"time: neg_pubkey_table_plain at 256 keys {plain_ms:.2f} ms | {smi}")
    return {"checks": checks, "plain_ms_256": plain_ms, "ms": times, "queued_ms": queued}


def k8_rows(np, rng):
    """Kernel 8's shapes as R || A || M rows: the blocksync window's
    (K8_LIVE rows of sign-bytes-sized messages, then empty padding rows to
    K8_BUCKET, as batch_verifier pads), the smoke's K8_RAGGED rows of
    0-1,000-byte messages, and the first K8_PARTIAL of those."""
    window = [rng.bytes(64) + rng.bytes(int(n))
              for n in rng.integers(K8_MSG_LEN[0], K8_MSG_LEN[1] + 1, K8_LIVE)]
    window += [b""] * (K8_BUCKET - K8_LIVE)
    ragged = [rng.bytes(64) + rng.bytes(int(n)) for n in rng.integers(0, 1001, K8_RAGGED)]
    return {K8_BUCKET: window, K8_RAGGED: ragged, K8_PARTIAL: ragged[:K8_PARTIAL]}


def run_kernel8(torch, np, cs, rng, dev, torch_build, sha_built, sha_splits, timed_turns,
                report, smi) -> dict:
    """Kernel 8's hash: each build against the plain version and hashlib
    with % L at k8_rows' shapes, timed in turns at them; each tree's split
    (SHA_SPLITS) timed beside its full build in the same order of turns;
    and each build's SASS: instructions of challenge_kernel, a round's
    (the full build's less the rounds-emptied build's, over 80) and the
    reduction's (the full build's less the reduce-emptied build's)."""
    from tendermint_tpu_torch.crypto import ed25519 as host
    from tendermint_tpu_torch.ops import sha512

    shapes = {}
    for n, rows in k8_rows(np, rng).items():
        buf, cnt = sha512.pad_messages(rows)
        want = [list((int.from_bytes(hashlib.sha512(r).digest(), "little") % host.L)
                     .to_bytes(32, "little")) for r in rows]
        shapes[n] = (torch.from_numpy(buf).to(dev), torch.from_numpy(cnt).to(dev),
                     torch.tensor(want, dtype=torch.uint8, device=dev), int(cnt.sum()))
    for n, (buf, cnt, want, _) in shapes.items():
        plain = sha512.challenge_batch_plain(buf, cnt)
        assert torch.equal(plain, want), f"plain != hashlib % L at {n} rows"
        for tag, bld in sha_built.items():
            got = bld.challenge(torch, buf, cnt)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{tag}: kernel 8 != plain at {n} rows"
    print(f"kernel-vs-plain: kernel 8's hash of {sorted(sha_built)} equal to the plain "
          f"version and hashlib + % L at {list(shapes)} rows (the window's "
          f"{K8_LIVE} live rows padded, the ragged rows, a partial last warp; "
          f"tolerance: exact); blocks "
          f"{json.dumps({n: v[3] for n, v in shapes.items()})} of nblk "
          f"{json.dumps({n: v[0].shape[1] // 128 for n, v in shapes.items()})}")
    plain_ms = cs.time_cuda(torch, lambda: sha512.challenge_batch_plain(*shapes[K8_BUCKET][:2]), 3)

    def call(bld, n):
        return bld.challenge(torch, *shapes[n][:2])

    times = timed_turns(list(shapes), call, sha_built)
    blocks = shapes[K8_BUCKET][3]
    b_ms, b_by = cs.bound_ms(K8_BUCKET * (shapes[K8_BUCKET][0].shape[1] + 4 + 32),
                             blocks * cs.SHA512_OPS_PER_BLOCK + K8_BUCKET * cs.SC_REDUCE_OPS)
    report(8, "rows", times,
           f"bound at {K8_BUCKET} rows ({blocks} blocks) {b_ms:.5f} ms ({b_by})", sha_built)
    queued = timed_turns(list(shapes), call, sha_built, timer=time_queued)
    report_queued(8, "rows", queued, sha_built, smi)
    print(f"time: challenge_batch_plain at {K8_BUCKET} rows {plain_ms:.2f} ms | {smi}")
    split_ms = {tag: {name: {n: [] for n in (K8_BUCKET, K8_RAGGED)}
                      for name in ("full", *SHA_SPLITS)} for tag in sha_built}
    order = [t for t in ("parent", "this", "this", "parent") if t in sha_built]
    for tag in order:
        for name, bld in {"full": sha_built[tag], **sha_splits[tag]}.items():
            for n in (K8_BUCKET, K8_RAGGED):
                split_ms[tag][name][n].append(time_queued(torch, lambda: call(bld, n), REPS))
    sass = {tag: {"full": sass_counts(torch_build, sha_built[tag].cubin, "challenge_kernel"),
                  **{name: sass_counts(torch_build, bld.so, "challenge_kernel")
                     for name, bld in sha_splits[tag].items()}} for tag in sha_built}
    for tag in sha_built:
        full, empty = sass[tag]["full"], sass[tag]["rounds emptied"]
        per_round = {op: round((full.get(op, 0) - empty.get(op, 0)) / 80, 2)
                     for op in ("total", *SASS_OPS) if full.get(op, 0) != empty.get(op, 0)}
        sass[tag]["per_round"] = per_round
        reduce = full["total"] - sass[tag]["reduce emptied"]["total"]
        sass[tag]["reduce"] = reduce
        print(f"kernel8 split: {tag} tree, ms a launch of {REPS} queued back to back "
              f"at [{K8_BUCKET}, {K8_RAGGED}] rows per turn, the full build and builds with "
              f"one part emptied (their values wrong): " + "; ".join(
                  f"{name} {json.dumps(t)}" for name, t in split_ms[tag].items()) + f" | {smi}")
        print(f"kernel8 sass: {tag} tree, challenge_kernel instructions (cuobjdump -sass): "
              f"full {json.dumps(full)}; rounds emptied {json.dumps(empty)}; a round "
              f"(full less rounds emptied, over 80) {json.dumps(per_round)}; the "
              f"reduction with its digest bytes (full less reduce emptied) {reduce}; "
              f"the bound counts {cs.SHA512_OPS_PER_BLOCK} a block and "
              f"{cs.SC_REDUCE_OPS} a row | {smi}")
    return {"plain_ms": plain_ms, "ms": times, "queued_ms": queued, "bound_ms": b_ms,
            "split_ms": split_ms, "sass": sass}


def k9_shapes(np, rng, sha256) -> dict:
    """Kernel 9's shapes as {name: (buf, counts, messages)}: the L2 block's
    leaf batch as Data.hash() builds it (K9_TXS transactions and two
    payload leaves under the 0x00 prefix, empty rows to K9_LEAF, the block
    axis to a power of two), its first K9_PARTIAL rows,
    merkle_leaf_hash's K9_LEAF one-block rows and merkle_inner_hash's
    K9_INNER two-block rows (their helpers' buffers, padded alike)."""
    txs = [rng.bytes(int(k)) for k in rng.integers(K9_TX_LEN[0], K9_TX_LEN[1] + 1, K9_TXS)]
    leaves = ([b"\x00" + tx for tx in txs] + [b"\x01" + rng.bytes(256), b"\x02" + rng.bytes(128)])
    leaves += [b""] * (K9_LEAF - len(leaves))
    buf, cnt = sha256.pad_messages(leaves, prefix=b"\x00")
    nblk = buf.shape[1] // 64
    buf = np.pad(buf, ((0, 0), (0, ((1 << (nblk - 1).bit_length()) - nblk) * 64)))
    msgs = [b"\x00" + m for m in leaves]
    one = [b"\x00" + rng.bytes(32) for _ in range(K9_LEAF)]
    two = [b"\x01" + rng.bytes(64) for _ in range(K9_INNER)]
    return {"leaf batch": (buf, cnt, msgs),
            f"{K9_PARTIAL} rows": (buf[:K9_PARTIAL], cnt[:K9_PARTIAL], msgs[:K9_PARTIAL]),
            "one-block leaves": (*sha256.pad_messages(one), one),
            "two-block inner": (*sha256.pad_messages(two), two)}


def run_kernel9(torch, np, cs, rng, dev, torch_build, s256_built, s256_variants,
                timed_turns, report, smi) -> dict:
    """Kernel 9: each build (and this tree's 64-thread build) against the
    plain version and hashlib at k9_shapes, timed in turns per launch and
    queued; the block sizes in turns; each tree's split (SHA256_SPLITS)
    queued beside its full build; each build's SASS: instructions of
    sha256_kernel and a round's (the full build's less the rounds-emptied
    build's, over 64)."""
    from tendermint_tpu_torch.ops import sha256

    shapes = {}
    for name, (buf, cnt, msgs) in k9_shapes(np, rng, sha256).items():
        want = torch.tensor([list(hashlib.sha256(m).digest()) for m in msgs],
                            dtype=torch.uint8, device=dev)
        shapes[name] = (torch.from_numpy(np.ascontiguousarray(buf)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(cnt)).to(dev), want,
                        int(cnt.sum()))
    blocks_builds = {"32 threads": s256_built["this"],
                     **{n: v for n, v in s256_variants["this"].items()
                        if n in SHA256_BLOCK_VARIANTS}}
    for name, (buf, cnt, want, _) in shapes.items():
        plain = sha256.sha256_batch_plain(buf, cnt)
        assert torch.equal(plain, want), f"plain != hashlib ({name})"
        for tag, bld in {**s256_built, **blocks_builds}.items():
            got = bld.sha256(torch, buf, cnt)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{tag}: kernel 9 != plain ({name})"
    print(f"kernel-vs-plain: kernel 9 of {sorted(s256_built)} (and this tree at "
          f"{sorted(blocks_builds)}) equal to the plain version and hashlib at "
          f"{json.dumps({n: list(v[0].shape) for n, v in shapes.items()})} "
          f"(tolerance: exact); blocks {json.dumps({n: v[3] for n, v in shapes.items()})}")
    leaf = shapes["leaf batch"]
    plain_ms = cs.time_cuda(torch, lambda: sha256.sha256_batch_plain(*leaf[:2]), 3)

    def call(bld, n):
        return bld.sha256(torch, *shapes[n][:2])

    times = timed_turns(list(shapes), call, s256_built)
    b_ms, b_by = cs.bound_ms(leaf[3] * 64 + 4 * K9_LEAF + 32 * K9_LEAF,
                             leaf[3] * cs.SHA256_OPS_PER_BLOCK)
    report(9, "shapes", times, f"bound at the leaf batch ({leaf[3]} blocks) "
           f"{b_ms:.5f} ms ({b_by})", s256_built)
    queued = timed_turns(list(shapes), call, s256_built, timer=time_queued)
    report_queued(9, "shapes", queued, s256_built, smi)
    print(f"time: sha256_batch_plain at the leaf batch {plain_ms:.2f} ms | {smi}")
    sizes = ["leaf batch", "two-block inner"]
    block_order = ["32 threads", "64 threads", "64 threads", "32 threads"]
    block_ms = {t: {n: {"launch": [], "queued": []} for n in sizes} for t in blocks_builds}
    for tag in block_order:
        for n in sizes:
            block_ms[tag][n]["launch"].append(
                cs.time_cuda(torch, lambda: call(blocks_builds[tag], n), REPS))
            block_ms[tag][n]["queued"].append(
                time_queued(torch, lambda: call(blocks_builds[tag], n), REPS))
    print(f"kernel9 block: this tree, sha256_kernel at 32 and 64 threads a block in "
          f"turns {block_order}, ms per launch and queued at {sizes}: "
          f"{json.dumps(block_ms)} | {smi}")
    split_ms = {tag: {name: [] for name in ("full", *SHA256_SPLITS)} for tag in s256_built}
    order = [t for t in ("parent", "this", "this", "parent") if t in s256_built]
    for tag in order:
        for name, bld in {"full": s256_built[tag], **s256_variants[tag]}.items():
            if name in split_ms[tag]:
                split_ms[tag][name].append(time_queued(torch, lambda: call(bld, "leaf batch"),
                                                       REPS))
    sass = {tag: {"full": sass_counts(torch_build, s256_built[tag].cubin, "sha256_kernel"),
                  "rounds emptied": sass_counts(torch_build,
                                                s256_variants[tag]["rounds emptied"].so,
                                                "sha256_kernel")} for tag in s256_built}
    for tag in s256_built:
        full, empty = sass[tag]["full"], sass[tag]["rounds emptied"]
        per_round = {op: round((full.get(op, 0) - empty.get(op, 0)) / 64, 2)
                     for op in ("total", *SASS_OPS) if full.get(op, 0) != empty.get(op, 0)}
        sass[tag]["per_round"] = per_round
        print(f"kernel9 split: {tag} tree, ms a launch of {REPS} queued back to back at "
              f"the leaf batch per turn, the full build and builds with one part emptied "
              f"(their values wrong): " + "; ".join(
                  f"{name} {json.dumps(t)}" for name, t in split_ms[tag].items()) + f" | {smi}")
        print(f"kernel9 sass: {tag} tree, sha256_kernel instructions (cuobjdump -sass): "
              f"full {json.dumps(full)}; rounds emptied {json.dumps(empty)}; a round "
              f"(full less rounds emptied, over 64) {json.dumps(per_round)}; the bound "
              f"counts {cs.SHA256_OPS_PER_BLOCK} a block | {smi}")
    return {"plain_ms": plain_ms, "ms": times, "queued_ms": queued, "bound_ms": b_ms,
            "block_ms": block_ms, "split_ms": split_ms, "sass": sass}


def run_kernel1(torch, cs, host, dev, torch_build, built, k1_variants, timed_turns, report,
                smi) -> dict:
    """Kernel 1: each build against the plain version on the card at
    K1_SIZES points x K1_DBL doublings and K1_SHORT doublings, rows 0-3
    against the host oracle; timed in turns per launch and queued; this
    tree's exchange-emptied build queued beside its full one; each
    build's SASS of a doubling (its rolled loop's body)."""
    from tendermint_tpu_torch.ops import curve25519 as curve
    from tendermint_tpu_torch.ops import dbl_chain as dc
    from tendermint_tpu_torch.ops import field25519 as fe

    n_pts = max(K1_SIZES)
    gen = torch.Generator().manual_seed(K1_DBL)
    scalars = torch.randint(0, 256, (n_pts, 32), dtype=torch.uint8, generator=gen)
    scalars[0] = 0
    scalars[0, 0] = 1  # row 0 is the basepoint
    pts = fe.to_bytes(curve.scalar_mult_base(scalars.to(dev))).contiguous()
    t0 = time.perf_counter()
    plain = dc.dbl_chain_plain(pts, K1_DBL)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    short = {d: dc.dbl_chain_plain(pts[:K1_SIZES[1]], d) for d in K1_SHORT}
    for tag, bld in built.items():
        for n in K1_SIZES:
            got = bld.dbl_chain(torch, pts[:n], K1_DBL)
            torch.cuda.synchronize()
            assert torch.equal(got, plain[:n]), f"{tag}: kernel 1 != plain at {n} points"
        for d, want in short.items():
            got = bld.dbl_chain(torch, pts[:K1_SIZES[1]], d)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{tag}: kernel 1 != plain at {d} doublings"
    p8 = plain[:4].cpu()
    for i in range(4):
        x, y, z, t = (int.from_bytes(bytes(c.tolist()), "little") for c in pts[i].cpu())
        hq = (x, y, z, t)
        for _ in range(K1_DBL):
            hq = host.point_double(hq)
        got = [int.from_bytes(bytes(c.tolist()), "little") for c in p8[i]]
        zi, gzi = pow(hq[2], host.P - 2, host.P), pow(got[2], host.P - 2, host.P)
        assert [hq[0] * zi % host.P, hq[1] * zi % host.P] == [
            got[0] * gzi % host.P, got[1] * gzi % host.P], f"plain row {i} != host oracle"
    print(f"kernel-vs-plain: kernel 1 of {sorted(built)} equal to the plain version byte "
          f"for byte at {list(K1_SIZES)} points x {K1_DBL} doublings and at "
          f"{K1_SIZES[1]} points x {list(K1_SHORT)}; rows 0-3 (affine) equal to "
          f"{K1_DBL} host point_double (tolerance: exact)")
    times = timed_turns(K1_SIZES, lambda bld, n: bld.dbl_chain(torch, pts[:n], K1_DBL))
    b_ms, b_by = cs.bound_ms(2 * pts.numel(), n_pts * K1_DBL * cs.DBL_OPS)
    report(1, "points", times, f"{K1_DBL} doublings a point; bound at {n_pts} points "
           f"{b_ms:.5f} ms ({b_by}); critical path {K1_DBL * 2} dependent field "
           f"multiplications a point (one thread: {K1_DBL * cs.FE_DBL})")
    queued = timed_turns(K1_SIZES, lambda bld, n: bld.dbl_chain(torch, pts[:n], K1_DBL),
                         timer=time_queued)
    report_queued(1, "points", queued, built, smi)
    print(f"time: dbl_chain_plain at {n_pts} points x {K1_DBL} {plain_ms:.2f} ms (one "
          f"call) | {smi}")
    split = {"full": built["this"], **k1_variants}
    split_ms = {name: [] for name in split}
    for _ in range(2):
        for name, bld in split.items():
            split_ms[name].append(time_queued(
                torch, lambda: bld.dbl_chain(torch, pts, K1_DBL), REPS))
    print(f"kernel1 split: this tree, ms a launch of {REPS} queued back to back at "
          f"{n_pts} points x {K1_DBL} doublings, the full build and the exchange emptied "
          f"(its values wrong), two rounds: " + "; ".join(
              f"{name} {json.dumps(t)}" for name, t in split_ms.items()) + f" | {smi}")
    sass = {tag: sass_loop_counts(torch_build, bld.cubin, "dbl_chain_kernel")
            for tag, bld in built.items()}
    for tag, counts in sass.items():
        print(f"kernel1 sass: {tag} tree, dbl_chain_kernel's rolled loop, one thread's "
              f"instructions a doubling (cuobjdump -sass) {json.dumps(counts)}; the bound "
              f"counts {cs.DBL_OPS} a doubling, the one-thread chain's | {smi}")
    return {"plain_ms": plain_ms, "ms": times, "queued_ms": queued, "bound_ms": b_ms,
            "split_ms": split_ms, "sass": sass}


def run_kernel10(torch, np, cs, rng, dev, secp_built, secp_splits, timed_turns, report,
                 smi) -> dict:
    """Kernel 10: each build against the plain version and the JAX
    package's rule on the crafted rows, and against the plain version and
    the host oracle at the window's shape; timed in turns at 64, 1,024
    (400 live) and 8,192 rows and 8,192 all-rejected rows; the split."""
    from tendermint_tpu_torch.crypto import secp256k1 as host
    from tendermint_tpu_torch.crypto import secp_native
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk

    gtab = sk._G_WORDS.get(dev)

    def operands(rows):
        return tuple(torch.from_numpy(a).to(dev) for a in cs.secp_row_arrays(np, sk.fe, rows))

    crafted, crafted_want = cs.secp_crafted_rows(host, secp_native, rng)
    signed, signed_want = secp_signed(rng)
    live = []
    for pub, msg, sig in signed:
        prep = secp_native.prep_digest_item(pub, hashlib.sha256(msg).digest(), sig)
        live.append(((0, 0), 0, 0, 0, False) if prep is None
                    else (prep[1], prep[2], prep[3], prep[0], True))
    reps = K10_LIVE // K10_SIGNED
    pad = ((0, 0), 0, 0, 0, False)
    shard_live = K10_LIVE * K10_SHARD // K10_BUCKET
    shapes = {
        64: (operands(crafted), crafted_want),
        K10_SHARD: (operands(live * (shard_live // K10_SIGNED) + live[:shard_live % K10_SIGNED]
                             + [pad] * (K10_SHARD - shard_live)),
                    (signed_want * reps)[:shard_live] + [False] * (K10_SHARD - shard_live)),
        K10_BUCKET: (operands(live * reps + [pad] * (K10_BUCKET - K10_LIVE)),
                     signed_want * reps + [False] * (K10_BUCKET - K10_LIVE)),
    }
    plain_ms = {}
    for n, (ops, want) in shapes.items():
        t0 = time.perf_counter()
        plain = sk.verify_prehashed_plain(*ops)
        torch.cuda.synchronize()
        plain_ms[n] = (time.perf_counter() - t0) * 1e3
        assert plain.cpu().tolist() == want, f"plain != the rule at {n} rows"
        for tag, bld in secp_built.items():
            got = bld.secp(torch, *ops, gtab)
            torch.cuda.synchronize()
            assert cs.max_abs_err(got, plain) == 0, f"{tag}: kernel 10 != plain at {n} rows"
    print(f"kernel-vs-plain: kernel 10 of {sorted(secp_built)} equal to the plain version "
          f"and the rule (the JAX package's on the crafted rows, the host oracle's on "
          f"the signed ones) at {list(shapes)} rows (tolerance: exact); accepted "
          f"{[sum(w) for _, w in shapes.values()]}")
    rejected = tuple(torch.zeros_like(t) for t in shapes[K10_BUCKET][0])
    sizes = [64, K10_SHARD, K10_BUCKET, f"{K10_BUCKET} rejected"]

    def call(bld, n):
        return bld.secp(torch, *(rejected if isinstance(n, str) else shapes[n][0]), gtab)

    times = timed_turns(sizes, call, secp_built)
    lane = [cs.secp_lane_path(r[1], r[2]) for r in live if r[4]]
    thread = [cs.secp_fe_muls(r[1], r[2]) for r in live if r[4]]
    report(10, "rows", times,
           f"{K10_LIVE} live rows of {K10_BUCKET} ({K10_SIGNED} signed tiled), "
           f"{shard_live} of {K10_SHARD}; critical path {statistics.mean(lane):.1f} "
           f"dependent product stages a row (one thread: {statistics.mean(thread):.1f} "
           f"dependent multiplications)", secp_built)
    print(f"time: verify_prehashed_plain on the card, one call, ms "
          f"{json.dumps({n: round(v, 2) for n, v in plain_ms.items()})} | {smi}")
    split = {"full": secp_built["this"], **secp_splits}
    split_ms = {name: cs.time_cuda(torch, lambda: call(bld, K10_BUCKET), REPS)
                for name, bld in split.items()}
    print(f"kernel10 split: this tree, median ms of {REPS} launches at {K10_BUCKET} rows "
          f"({K10_LIVE} live), the full build and builds with one part of run_program "
          f"emptied (their values wrong; each difference from the full build is that "
          f"part's time): " + "; ".join(f"{name} {t:.4f}" for name, t in split_ms.items())
          + f" | {smi}")
    return {"plain_ms": plain_ms, "ms": times, "split_ms": split_ms}


def tile_rows(torch, ops, want, live: int, total: int):
    """ops (tables, tvalid, idx, R, S, K, s_ok) of b rows tiled to `live`
    rows, then padding (idx -1, s_ok False) to `total`."""
    tables, tvalid, *rows = ops
    reps = -(-live // rows[0].shape[0])
    pad = total - live
    out = []
    for t in rows:
        body = t.repeat((reps,) + (1,) * (t.dim() - 1))[:live]
        tail = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        out.append(torch.cat([body, tail]))
    out[0][live:] = -1
    return (tables, tvalid, *out), (want * reps)[:live] + [False] * pad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", type=int, nargs="+", choices=ALL_KERNELS,
                    default=list(ALL_KERNELS), help="kernels to check and time")
    ap.add_argument("--parent", default=None,
                    help="root of another tree whose kernels are timed beside this one's")
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--turn-tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--turn", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn_tree:
        print(json.dumps(turn(args.turn_tree, args.seed, args.turn.split(","))))
        return 0

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_kernels: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    cs = chip_smoke()
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
    ed_kernels = [k for k in args.kernel if k not in BLS_KERNELS and k not in (8, 9, 10)]
    bls_kernels = [k for k in args.kernel if k in BLS_KERNELS]
    procs = {}
    if ed_kernels:
        procs.update({tag: start_build(_build, os.path.join(root, KERNEL), tag)
                      for tag, root in trees.items()})
    if 10 in args.kernel:
        procs.update({"secp_" + tag: start_build(_build, os.path.join(root, SECP_KERNEL),
                                                 "secp_" + tag)
                      for tag, root in trees.items()})
    if 8 in args.kernel:
        procs.update({"sha_" + tag: start_build(_build, os.path.join(root, SHA_KERNEL),
                                                "sha_" + tag)
                      for tag, root in trees.items()})
    if 9 in args.kernel:
        procs.update({"s256_" + tag: start_build(_build, os.path.join(root, SHA256_KERNEL),
                                                 "s256_" + tag)
                      for tag, root in trees.items()})
    if bls_kernels:
        procs.update({"bls_" + tag: start_build(_build, os.path.join(root, BLS_KERNEL),
                                                "bls_" + tag)
                      for tag, root in trees.items()})
    splits = start_variant_builds(_build, SPLITS, "split") if 12 in args.kernel else {}
    warp_builds = (start_variant_builds(_build, WARP_VARIANTS, "warps")
                   if 11 in args.kernel else {})
    lane_builds = (start_variant_builds(_build, LANE_VARIANTS, "lanes")
                   if {11, 13} & set(args.kernel) else {})
    secp_splits = (start_variant_builds(_build, SECP_SPLITS, "secpsplit", SECP_KERNEL)
                   if 10 in args.kernel else {})
    latency = start_latency_build(_build) if 10 in args.kernel else None
    sha_splits = {}
    if 8 in args.kernel:
        for tag, root in trees.items():
            variants = {name: fitting_patches(root, [p]) for name, p in SHA_SPLITS.items()}
            sha_splits[tag] = start_variant_builds(_build, variants, "shasplit_" + tag,
                                                   SHA_KERNEL, root)

    # kernel 9: each tree's splits that fit it, and this tree's block size;
    # kernel 1: this tree's exchange emptied
    s256_variants, k1_variants = {}, {}
    for tag, root in trees.items():
        if 9 in args.kernel:
            variants = {**SHA256_SPLITS, **(SHA256_BLOCK_VARIANTS if tag == "this" else {})}
            s256_variants[tag] = start_variant_builds(
                _build, {n: fitting_patches(root, alts) for n, alts in variants.items()},
                "s256var_" + tag, SHA256_KERNEL, root)
    if 1 in args.kernel:
        k1_variants = start_variant_builds(
            _build, {n: fitting_patches(ROOT, alts) for n, alts in K1_EXCHANGE.items()},
            "k1var", KERNEL)

    def kernels_of(tag):
        return (bls_kernels if tag.startswith("bls_") else [10] if tag.startswith("secp_")
                else [8] if tag.startswith("sha_") else [9] if tag.startswith("s256_")
                else ed_kernels)

    builds = {tag: Build(*p, cs.ptxas_usage, kernels_of(tag)) for tag, p in procs.items()}
    splits = {name: VariantBuild(*p) for name, p in splits.items()}
    warp_builds = {name: VariantBuild(*p) for name, p in warp_builds.items()}
    lane_builds = {name: VariantBuild(*p) for name, p in lane_builds.items()}
    secp_splits = {name: VariantBuild(*p) for name, p in secp_splits.items()}
    sha_splits = {tag: {name: VariantBuild(*p) for name, p in v.items()}
                  for tag, v in sha_splits.items()}
    s256_variants = {tag: {name: VariantBuild(*p) for name, p in v.items()}
                     for tag, v in s256_variants.items()}
    k1_variants = {name: VariantBuild(*p) for name, p in k1_variants.items()}
    built = {tag: b for tag, b in builds.items()
             if not tag.startswith(("bls_", "secp_", "sha_", "s256_"))}
    sha_built = {tag[4:]: b for tag, b in builds.items() if tag.startswith("sha_")}
    s256_built = {tag[5:]: b for tag, b in builds.items() if tag.startswith("s256_")}
    bls_built = {tag[4:]: b for tag, b in builds.items() if tag.startswith("bls_")}
    secp_built = {tag[5:]: b for tag, b in builds.items() if tag.startswith("secp_")}
    n_builds = (len(builds) + len(splits) + len(warp_builds) + len(lane_builds)
                + len(secp_splits) + sum(len(v) for v in sha_splits.values())
                + sum(len(v) for v in s256_variants.values()) + len(k1_variants))
    sources = ((KERNEL, ed_kernels), (SHA_KERNEL, sha_built), (SHA256_KERNEL, s256_built),
               (SECP_KERNEL, secp_built), (BLS_KERNEL, bls_built))
    print(f"build: {n_builds} nvcc builds of "
          f"{' and '.join(src for src, on in sources if on)}"
          f" in parallel, {time.perf_counter() - t0:.1f} s | {smi}")
    order = ["parent", "this", "this", "parent"] if "parent" in trees else ["this"]

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
    pub_d = torch.tensor([list(p) for p in pubs], dtype=torch.uint8, device=dev)
    base = curve.base_table(dev)
    kc = eb.kernel_consts(dev)
    result = {"device": torch.cuda.get_device_name(0), "smi": smi,
              "ptxas": {tag: b.ptxas for tag, b in builds.items()}}

    def timed_turns(sizes, call, builds=built, timer=cs.time_cuda):
        """{tag: {size: [ms per turn]}}: call(build, size) timed in turns
        (by `timer`: cs.time_cuda, or time_queued for the card's time a call
        without the launch latency)."""
        times = {t: {n: [] for n in sizes} for t in builds}
        for tag in order:
            for n in sizes:
                times[tag][n].append(timer(torch, lambda: call(builds[tag], n), REPS))
        return times

    def report(kernel: int, what: str, times, extra: str, builds=built) -> None:
        for tag in builds:
            print(f"kernel{kernel}: {tag} tree, median ms of {REPS} launches at "
                  f"{what} {json.dumps(times[tag])} (one list entry per turn); "
                  f"{extra}; ptxas: {builds[tag].ptxas[kernel]} | {smi}")

    if 2 in args.kernel:
        result["kernel2"] = run_kernel2(torch, cs, host, eb, pubs, pub_d, kc, built,
                                        timed_turns, report, smi)

    if 1 in args.kernel:
        result["kernel1"] = run_kernel1(torch, cs, host, dev, _build, built, k1_variants,
                                        timed_turns, report, smi)

    if 9 in args.kernel:
        result["kernel9"] = run_kernel9(torch, np, cs, rng, dev, _build, s256_built,
                                        s256_variants, timed_turns, report, smi)

    if 8 in args.kernel:
        result["kernel8"] = run_kernel8(torch, np, cs, rng, dev, _build, sha_built,
                                        sha_splits, timed_turns, report, smi)

    if 3 in args.kernel:
        tables, tvalid = eb.neg_pubkey_table_plain(pub_d)
        tables = tables.contiguous()
        checks = []
        for b, n_pad in cs.KERNEL3_SIZES:
            ops_b, want = cs.kernel3_rows(torch, host, keys, pubs, tables, tvalid,
                                          b, n_pad, b"k3-%d" % b)
            plain = eb.verify_prehashed_table_plain(*ops_b)
            for tag, bld in built.items():
                got = bld.verify("tm_verify_table", torch, *ops_b, base, kc)
                torch.cuda.synchronize()
                assert cs.max_abs_err(got, plain) == 0, f"{tag}: kernel 3 != plain at b={b}"
                assert got.cpu().tolist() == want, f"{tag}: kernel 3 != host oracle at b={b}"
            checks.append({"b": b, "padding": n_pad, "accepted": sum(want)})
        print(f"kernel-vs-plain: kernel 3 of {sorted(built)} equal to the plain "
              f"version and the host oracle at b = {[b for b, _ in cs.KERNEL3_SIZES]} "
              f"(tolerance: exact) {json.dumps(checks)}")
        ops256, _ = cs.kernel3_rows(torch, host, keys, pubs, tables, tvalid, 256, 8,
                                    b"k3-time")
        plain_ms = cs.time_cuda(torch, lambda: eb.verify_prehashed_table_plain(*ops256), 3)
        times = timed_turns(cs.KERNEL3_BUCKETS, lambda bld, b: bld.verify(
            "tm_verify_table", torch, tables, tvalid, *(t[:b] for t in ops256[2:]),
            base, kc))
        report(3, "buckets", times,
               f"critical path {cs.FE_VERIFY_TABLE_PATH} (one thread: {cs.FE_VERIFY_TABLE})")
        print(f"time: verify_prehashed_table_plain at 256 rows {plain_ms:.2f} ms | {smi}")
        result["kernel3"] = {"checks": checks, "plain_ms_256": plain_ms, "ms": times}

    if 4 in args.kernel:
        checks = []
        for b, n_pad in cs.KERNEL3_SIZES:
            ops_b, want = cs.kernel4_rows(torch, host, keys, pubs, b, n_pad,
                                          b"k4-%d" % b, dev)
            plain = eb.verify_prehashed_plain(*ops_b)
            for tag, bld in built.items():
                got = bld.generic(torch, *ops_b, base, kc)
                torch.cuda.synchronize()
                assert cs.max_abs_err(got, plain) == 0, f"{tag}: kernel 4 != plain at b={b}"
                assert got.cpu().tolist() == want, f"{tag}: kernel 4 != host oracle at b={b}"
            checks.append({"b": b, "padding": n_pad, "accepted": sum(want)})
        print(f"kernel-vs-plain: kernel 4 of {sorted(built)} equal to the plain "
              f"version and the host oracle at b = {[b for b, _ in cs.KERNEL3_SIZES]} "
              f"(tolerance: exact) {json.dumps(checks)}")
        ops4, _ = cs.kernel4_rows(torch, host, keys, pubs, 256, 8, b"k4-time", dev)
        rejected = {n: tuple(torch.zeros((n, *t.shape[1:]), dtype=t.dtype, device=dev)
                             for t in ops4) for n in (256, 16384)}
        k3_tables, k3_tvalid = eb.neg_pubkey_table_plain(pub_d)
        ops3, _ = cs.kernel3_rows(torch, host, keys, pubs, k3_tables.contiguous(),
                                  k3_tvalid, 256, 8, b"k3-time")
        plain_ms = cs.time_cuda(torch, lambda: eb.verify_prehashed_plain(*ops4), 3)
        sizes = [*cs.KERNEL3_BUCKETS, "256 rejected", "16384 rejected", "kernel 3 at 256"]

        def call4(bld, n):
            if n == "kernel 3 at 256":
                return bld.verify("tm_verify_table", torch, *ops3, base, kc)
            ops = (rejected[int(n.split()[0])] if str(n).endswith("rejected")
                   else tuple(t[:n] for t in ops4))
            return bld.generic(torch, *ops, base, kc)

        times = timed_turns(sizes, call4)
        report(4, "buckets", times,
               f"critical path {cs.FE_VERIFY_GENERIC_PATH} (one thread: "
               f"{cs.FE_VERIFY_GENERIC}); kernel 3's {cs.FE_VERIFY_TABLE_PATH}")
        print(f"time: verify_prehashed_plain at 256 rows {plain_ms:.2f} ms | {smi}")
        result["kernel4"] = {"checks": checks, "plain_ms_256": plain_ms, "ms": times}

    if 6 in args.kernel:
        bt, bv = eb.neg_pubkey_bigtable_plain(pub_d)
        bt = bt.contiguous()
        checks, ops = [], {}
        for b, n_pad in K6_SIZES:
            ops[b] = cs.kernel3_rows(torch, host, keys, pubs, bt, bv, b, n_pad, b"k6-%d" % b)
        ops[K6_BUCKET] = tile_rows(torch, *ops[2048], K6_LIVE, K6_BUCKET)
        for b, (ops_b, want) in ops.items():
            plain = eb.verify_prehashed_bigcache_plain(*ops_b)
            for tag, bld in built.items():
                got = bld.verify("tm_verify_bigcache", torch, *ops_b, base, kc)
                torch.cuda.synchronize()
                assert cs.max_abs_err(got, plain) == 0, f"{tag}: kernel 6 != plain at b={b}"
                assert got.cpu().tolist() == want, f"{tag}: kernel 6 != host oracle at b={b}"
            checks.append({"b": b, "accepted": sum(want)})
        print(f"kernel-vs-plain: kernel 6 of {sorted(built)} equal to the plain "
              f"version and the host oracle at b = {list(ops)} (tolerance: exact) "
              f"{json.dumps(checks)}")
        plain_ms = cs.time_cuda(
            torch, lambda: eb.verify_prehashed_bigcache_plain(*ops[K6_BUCKET][0]), 3)
        times = timed_turns((2048, K6_BUCKET), lambda bld, b: bld.verify(
            "tm_verify_bigcache", torch, *ops[b][0], base, kc))
        report(6, "rows", times,
               f"{K6_LIVE} rows of {K6_BUCKET} tiled from 2048 mixed rows; critical "
               f"path {cs.FE_VERIFY_BIG_PATH} (one thread: {cs.FE_VERIFY_BIG})")
        print(f"time: verify_prehashed_bigcache_plain at {K6_BUCKET} rows "
              f"{plain_ms:.2f} ms | {smi}")
        result["kernel6"] = {"checks": checks, f"plain_ms_{K6_BUCKET}": plain_ms,
                             "ms": times}
        del bt, ops

    if 5 in args.kernel:
        key_sets = {16: pub_d[torch.tensor(list(range(9)) + list(range(200, 207)), device=dev)],
                    256: pub_d}
        want_valid = [host.point_decompress(p) is not None for p in pubs]
        want = {16: want_valid[:9] + want_valid[200:207], 256: want_valid}
        for n, pk in key_sets.items():
            plain_t, plain_v = eb.neg_pubkey_bigtable_plain(pk)
            for tag, bld in built.items():
                got_t, got_v = bld.bigtable(torch, pk, kc)
                torch.cuda.synchronize()
                assert torch.equal(got_t, plain_t), f"{tag}: kernel 5 != plain at {n} keys"
                assert torch.equal(got_v, plain_v), f"{tag}: kernel 5 validity at {n} keys"
                assert got_v.cpu().tolist() == want[n], f"{tag}: kernel 5 != host oracle"
            del plain_t, got_t
        print(f"kernel-vs-plain: kernel 5 of {sorted(built)} equal to the plain "
              f"version byte for byte and its validity to the host oracle at "
              f"{list(key_sets)} keys (tolerance: exact)")
        plain_ms = cs.time_cuda(torch, lambda: eb.neg_pubkey_bigtable_plain(pub_d), 3)
        times = timed_turns(K5_SIZES, lambda bld, n: bld.bigtable(torch, key_sets[n], kc))
        report(5, "keys", times,
               f"critical path {cs.FE_BIGTABLE_PATH} a thread (one thread a key "
               f"and column: {cs.FE_BIGTABLE_THREAD})")
        print(f"time: neg_pubkey_bigtable_plain at 256 keys {plain_ms:.2f} ms | {smi}")
        result["kernel5"] = {"plain_ms_256": plain_ms, "ms": times}

    if 10 in args.kernel:
        result["kernel10"] = run_kernel10(torch, np, cs, rng, dev, secp_built, secp_splits,
                                          timed_turns, report, smi)
        ns = secp_latency_ns(torch, *latency, cs)
        result["kernel10"]["latency_ns"] = ns
        print(f"kernel10 latency: this tree, one warp, each lane a chain of {LATENCY_OPS} "
              f"dependent operations, median of {REPS} launches: fs_mul {ns['fs_mul']:.2f} ns, "
              f"fs_add_sub {ns['fs_add_sub']:.2f} ns an operation | {smi}")

    if 12 in args.kernel:
        from tendermint_tpu_torch.crypto import bls12_381 as c
        from tendermint_tpu_torch.crypto import bls_signatures as bls
        from tendermint_tpu_torch.ops import bls_pairing as bp

        def scalar() -> int:
            return int.from_bytes(rng.bytes(32), "big") % (c.R - 1) + 1

        def g1(k):
            return bls._g1_mul_point(c.G1_GEN, k)

        def g2(k):
            return bls._g2_mul_point(c.G2_GEN, k)

        a, b = [scalar() for _ in range(64)], [scalar() for _ in range(64)]
        rlc_pairs = [(g1(x), g2(y)) for x, y in zip(a, b)]
        rlc_pairs.append((g1(-sum(x * y for x, y in zip(a, b)) % c.R), c.G2_GEN))
        k = scalar()
        shapes = {"verify": [(g1(k), c.G2_GEN), (c.g1_neg(g1(1)), g2(k))],
                  "rlc": rlc_pairs}
        chunks = {name: bp.prepare_pairs(pairs, dev) for name, pairs in shapes.items()}
        adv_miller, adv_f12 = cs.pairing_operands(torch, rng, dev)
        mill = {}
        for name, ch in list(chunks.items()) + [(f"adversarial {i}", ch)
                                                 for i, ch in enumerate(adv_miller)]:
            plain = bp.miller_plain(*ch)
            for tag, bld in bls_built.items():
                got = bld.miller(torch, *ch)
                torch.cuda.synchronize()
                assert cs.max_abs_err(got, plain) == 0, f"{tag}: tm_miller != plain ({name})"
            mill[name] = plain
        for f in [mill["verify"].unsqueeze(0), mill["rlc"].unsqueeze(0), adv_f12]:
            plain = bp.final_exp_plain(f)
            for tag, bld in bls_built.items():
                got = bld.final_exp(torch, f)
                torch.cuda.synchronize()
                assert cs.max_abs_err(got, plain) == 0, f"{tag}: tm_final_exp != plain"
            if f.shape[0] == 1:
                assert bp.f12_to_host(plain[0]) == c.F12_ONE, "a pairing product is not one"
        print(f"kernel-vs-plain: kernel 12 of {sorted(bls_built)}: tm_miller at the "
              f"verify shape ({chunks['verify'][0].shape[0]} chunk), the RLC shape "
              f"({chunks['rlc'][0].shape[0]} chunks) and the adversarial operands, "
              f"tm_final_exp on their products and the adversarial elements, equal "
              f"their plain versions byte for byte; both products' pairings are one")
        f_one = mill["rlc"].unsqueeze(0).contiguous()
        plain_ms = {"miller": cs.time_cuda(torch, lambda: bp.miller_plain(*chunks["rlc"]), 1),
                    "final_exp": cs.time_cuda(torch, lambda: bp.final_exp_plain(f_one), 1)}
        times = timed_turns(("miller_verify", "miller_rlc", "final_exp"), lambda bld, n: (
            bld.final_exp(torch, f_one) if n == "final_exp"
            else bld.miller(torch, *chunks[n.split("_")[1]])), bls_built)
        report(12, "shapes", times,
               f"critical paths miller {cs.FP_MILLER_PATH} (+1 a chunk-product level; "
               f"one thread: {cs.FP_MILLER_THREAD}), final_exp {cs.FP_FINAL_EXP_PATH} "
               f"(one thread: {cs.FP_FINAL_EXP})", bls_built)
        print(f"time: miller_plain at the RLC shape {plain_ms['miller']:.2f} ms, "
              f"final_exp_plain {plain_ms['final_exp']:.2f} ms (one call) | {smi}")
        split = {"full": bls_built["this"], **splits}
        split_ms = {name: {
            "miller_verify": cs.time_cuda(torch, lambda: bld.miller(torch, *chunks["verify"]), REPS),
            "final_exp": cs.time_cuda(torch, lambda: bld.final_exp(torch, f_one), REPS),
        } for name, bld in split.items()}
        print("kernel12 split: this tree, median ms of 20 launches of tm_miller at "
              "the verify shape / tm_final_exp, the full build and builds with one "
              "part of run_program emptied (their values wrong; each difference "
              "from the full build is that part's time): " + "; ".join(
                  f"{name} {t['miller_verify']:.4f} / {t['final_exp']:.4f}"
                  for name, t in split_ms.items()) + f" | {smi}")
        result["kernel12"] = {"plain_ms": plain_ms, "ms": times, "split_ms": split_ms}

    if {11, 13} & set(args.kernel):
        sums = {g: sum_operands(torch, cs, rng, dev, g) for g in ("g1", "g2")}
    if 11 in args.kernel:
        result["kernel11"] = run_kernel11(torch, cs, sums, bls_built,
                                          {"g1": lane_builds, "g2": warp_builds},
                                          timed_turns, report, smi)
    if 13 in args.kernel:
        result["kernel13"] = run_kernel13(torch, cs, sums, bls_built,
                                          {"g1": lane_builds, "g2": {}},
                                          timed_turns, report, smi)

    # kernel 2's main path is the first height of verify_commit (the table
    # build), kernel 8's the blocksync window hashed on the card; kernels 1
    # and 9 have no turn (kernel 1's path is the microbenchmark itself,
    # kernel 9's Data.hash() is host work, out of its kernel's reach)
    what = (["commit"] if {2, 3} & set(args.kernel) and "parent" in trees else []) + (
        ["blocksync_dev"] if 8 in args.kernel and "parent" in trees else []) + (
        ["generic"] if 4 in args.kernel else []) + (
        ["secp"] if 10 in args.kernel else []) + (
        ["blocksync"] if {5, 6} & set(args.kernel) and "parent" in trees else []) + (
        ["pairing"] if {11, 12} & set(args.kernel) else []) + (
        ["sharded"] if 13 in args.kernel else [])
    if what:
        turns: dict[str, list[dict]] = {t: [] for t in trees}
        for tag in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn-tree",
                 trees[tag], "--turn", ",".join(what), "--seed", str(args.seed)],
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"turn of {tag} failed:\n{proc.stderr[-4000:]}")
            turns[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        result["turns"] = turns
        for tag, ts in turns.items():
            if "commit" in what:
                print(f"commit: {tag} tree, verify_commit at {N_VALS} validators ms a "
                      f"height per turn {json.dumps([[round(x, 3) for x in t['commit']] for t in ts])} "
                      f"(the first of a turn builds the key tables, after {WARM_HEIGHTS} "
                      f"heights of another set) | {smi}")
            if "generic" in what:
                gr = [t["generic"] for t in ts]
                print(f"generic: {tag} tree, verify_commit at {N_VALS} validators "
                      f"through BatchVerifier(table_cache_capacity=64), one generic "
                      f"launch a height, ms a height per turn "
                      f"{json.dumps([[round(x, 3) for x in t['commit']] for t in gr])}; "
                      f"prewarm_buckets(tiers=('generic',)) wall ms per turn "
                      f"{json.dumps([round(t['prewarm_ms'], 2) for t in gr])}, "
                      f"[bucket, ms] a launch {json.dumps(gr[-1]['prewarm'])} | {smi}")
            if "secp" in what:
                sr = [t["secp"] for t in ts]
                print(f"secp: {tag} tree, {K10_LIVE} secp256k1 rows through "
                      f"_verify_secp_device (host prep, padding to {sr[0]['bucket']}, "
                      f"copies, one tm_secp_verify launch), ms per call per turn "
                      f"{json.dumps([[round(x, 2) for x in t['ms']] for t in sr])}, median "
                      f"per turn {json.dumps([round(statistics.median(t['ms']), 2) for t in sr])}"
                      f" | {smi}")
            if "pairing" in what:
                pr = [t["pairing"] for t in ts]
                print(f"pairing: {tag} tree, check_pairs at 2 pairs on the card ms per "
                      f"turn {json.dumps([[round(x, 3) for x in t['check_pairs_ms']] for t in pr])}, "
                      f"the native host library's pairing_check on the same pairs (one "
                      f"CPU thread) {json.dumps([[round(x, 3) for x in t['native_ms']] for t in pr])}; "
                      f"the 64-QC window on the device route: assembly ms "
                      f"(assemble_qc, then the signature / signer-key sums on the card) "
                      f"{json.dumps([[round(t['assemble_ms'], 2), round(t['sums_ms']['g1'], 2), round(t['sums_ms']['g2'], 2)] for t in pr])}, "
                      f"check wall ms "
                      f"{json.dumps([[round(x, 2) for x in t['qc_wall_ms']] for t in pr])}, "
                      f"of which pairing checks "
                      f"{json.dumps([[round(x, 2) for x in t['qc_pairing_ms']] for t in pr])} "
                      f"({pr[0]['qc_checks']} checks a window) | {smi}")
            if "sharded" in what:
                print(f"sharded: {tag} tree, kernel 13 through its wrappers "
                      f"(g1_aggregate_sharded / g2_aggregate_sharded of {N_VALS} points "
                      f"over {cs.MESH_SHARDS} shards of the card), median ms of {REPS} per turn "
                      f"{json.dumps([[round(t['sharded'][g], 4) for g in ('g1', 'g2')] for t in ts])} "
                      f"| {smi}")
            if "blocksync_dev" in what:
                print(f"blocksync_dev: {tag} tree, the 64 x {N_VALS} window hashed on the "
                      f"card (device_challenge_min=2048: tm_challenge, then kernel 6), "
                      f"wall ms per window per turn "
                      f"{json.dumps([[round(x, 2) for x in t['blocksync_dev']['wall_ms']] for t in ts])}, "
                      f"device round ms "
                      f"{json.dumps([[round(x, 2) for x in t['blocksync_dev']['device_ms']] for t in ts])}, "
                      f"host share "
                      f"{json.dumps([[round(x, 3) for x in t['blocksync_dev']['host_share']] for t in ts])} "
                      f"(the first of a turn builds the big tables) | {smi}")
            if "blocksync" in what:
                print(f"blocksync: {tag} tree, the 64 x {N_VALS} window host-hashed, "
                      f"wall ms per window per turn "
                      f"{json.dumps([[round(x, 2) for x in t['blocksync']['wall_ms']] for t in ts])}, "
                      f"device round ms "
                      f"{json.dumps([[round(x, 2) for x in t['blocksync']['device_ms']] for t in ts])} "
                      f"(the first of a turn builds the big tables) | {smi}")
    print(json.dumps({"chip_kernels": result}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
