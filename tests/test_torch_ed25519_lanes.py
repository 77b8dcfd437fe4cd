"""The four-lane schedule of kernel 3 (``tm_verify_table``) on the CPU.

The kernel itself runs only on the card, but its row code is plain C++:
``verify_table_x4`` and the ``_x4`` point operations of
``ops/csrc/ed25519_device.cuh``. g++ builds that header with the host
harness ``tests/ed25519_lanes_host.cpp`` into ``tendermint_tpu_torch/_kbuild/``,
where four host threads run the 4 lanes of a group in lock-step through
the same source (an exchange is a slot array with a barrier on each side,
and the lanes must agree on the row and the count of exchanges). Its
verdicts are held byte for byte against the port's plain version
(``eb.verify_prehashed_table_plain``), the JAX package's
``verify_prehashed_table`` with ``_verify_cached_small``'s gather, and the
host oracle; its point operations limb for limb against the one-thread
``ge_dbl``, ``ge_add_cached`` and ``ge_to_cached`` of the same header.
Tolerance: exact.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import curve25519 as curve
from tendermint_tpu_torch.ops import ed25519_batch as eb
from tendermint_tpu_torch.ops import field25519 as fe

ROOT = pathlib.Path(__file__).resolve().parent.parent
HARNESS = ROOT / "tests" / "ed25519_lanes_host.cpp"
HEADER = ROOT / "tendermint_tpu_torch" / "ops" / "csrc" / "ed25519_device.cuh"
BUILD_DIR = ROOT / "tendermint_tpu_torch" / "_kbuild"

N_ROWS = 64
P = host.P


@pytest.fixture(scope="module")
def lib():
    """The harness, built once per source content (g++, about a second)."""
    digest = hashlib.sha256(HARNESS.read_bytes() + HEADER.read_bytes()).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"ed25519_lanes_host.{digest[:16]}.so"
    if not so.exists():
        tmp = so.with_suffix(f".build.{os.getpid()}")
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-pthread", "-shared", "-fPIC",
             "-Wno-unknown-pragmas", "-o", str(tmp), str(HARNESS)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_host_verify_table.argtypes = [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i]
    lib.tm_host_verify_table.restype = i
    lib.tm_host_point_ops.argtypes = [vp, vp, vp, vp, i]
    lib.tm_host_point_ops.restype = i
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _kbytes() -> np.ndarray:
    return eb.kernel_consts(torch.device("cpu")).numpy()


def host_verify_table(lib, tables, tvalid, idx, r, s, k, s_ok) -> list[bool]:
    """The harness on numpy operands shaped as the wrapper's."""
    args = [np.ascontiguousarray(a) for a in (tables, tvalid, idx, r, s, k, s_ok)]
    tables, tvalid, idx, r, s, k, s_ok = args
    base = curve.base_table_bytes()
    kb = _kbytes()
    out = np.full(idx.shape[0], 7, dtype=np.uint8)
    rc = lib.tm_host_verify_table(
        _ptr(tables), _ptr(tvalid), tables.shape[0], _ptr(idx), _ptr(r),
        _ptr(s), _ptr(k), _ptr(s_ok), _ptr(base), _ptr(kb), _ptr(out),
        idx.shape[0],
    )
    assert rc != -1, "the 4 lanes fell out of lock-step"
    assert rc != -2, "the 4 lanes of a row reached different verdicts"
    assert rc == 0
    assert set(out.tolist()) <= {0, 1}, "a row's verdict was not written"
    return [bool(v) for v in out]


def _rows():
    """N_ROWS rows over a store of 16 key tables: 12 valid keys, then an
    identity key (small order), y = p (non-canonical), and two key byte
    strings with no square root. Row i's kind is i % 8: valid, wrong
    message, tampered R, s >= L, a key whose table is invalid, idx = -1,
    idx past the store, valid on the identity key (row 6 of a 16-row
    block) or on another key. Returns (pubs, items, idx, want)."""
    rng = np.random.default_rng(2026)
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(12)]
    pubs = [kk.public_key().data for kk in keys]
    pubs.append((1).to_bytes(32, "little"))  # identity
    pubs.append(P.to_bytes(32, "little"))  # y = p
    while len(pubs) < 16:
        cand = rng.bytes(32)
        if host.point_decompress(cand) is None:
            pubs.append(cand)
    n_store = len(pubs)
    ident_s = 12345
    ident_sig = host.point_compress(
        host.scalar_mult(ident_s, host.BASEPOINT)
    ) + ident_s.to_bytes(32, "little")
    items, idx = [], []
    for i in range(N_ROWS):
        kind = i % 8
        ki = (i // 8 + 3 * (i % 3)) % len(keys)
        msg = b"lane row %d" % i
        pub, sig = pubs[ki], keys[ki].sign(msg)
        row = ki
        if kind == 1:
            msg += b"?"
        elif kind == 2:
            sig = bytes([sig[0] ^ 0x10]) + sig[1:]
        elif kind == 3:
            s_big = int.from_bytes(sig[32:], "little") + host.L
            sig = sig[:32] + s_big.to_bytes(32, "little")
        elif kind == 4:
            row = 13 + (i // 8) % 3  # y = p or no square root
            pub = pubs[row]
        elif kind == 5:
            row = -1
        elif kind == 6:
            if (i // 8) % 2 == 0:
                row = n_store + i // 8  # past the store
            else:
                row, pub, sig = 12, pubs[12], ident_sig
        items.append((pub, msg, sig))
        idx.append(row)
    want = [
        0 <= row < n_store and host.verify(p, m, sg)
        for row, (p, m, sg) in zip(idx, items)
    ]
    return pubs, items, np.array(idx, dtype=np.int32), want


def _u8(rows) -> np.ndarray:
    return np.array([list(x) for x in rows], dtype=np.uint8)


@pytest.fixture(scope="module")
def batch():
    pubs, items, idx, want = _rows()
    tables, tvalid = eb.neg_pubkey_table(torch.from_numpy(_u8(pubs)))
    r = _u8(sg[:32] for _, _, sg in items)
    s = _u8(sg[32:] for _, _, sg in items)
    k = _u8(host.challenge(sg[:32], p, m).to_bytes(32, "little") for p, m, sg in items)
    s_ok = np.array([int.from_bytes(sg[32:], "little") < host.L for _, _, sg in items])
    assert any(want) and not all(want)
    return tables.numpy(), tvalid.numpy(), idx, r, s, k, s_ok, want, pubs


def test_lanes_verdicts_match_plain_jax_and_oracle(lib, batch):
    tables, tvalid, idx, r, s, k, s_ok, want, pubs = batch
    got = host_verify_table(lib, tables, tvalid, idx, r, s, k, s_ok)
    plain = eb.verify_prehashed_table_plain(
        *map(torch.from_numpy, (tables, tvalid, idx, r, s, k, s_ok))
    ).tolist()
    # the JAX package's small tier: its own tables, gathered and masked as
    # _verify_cached_small does (a row past the store masked the same way)
    jt, jv = jax.jit(jeb.neg_pubkey_table)(jnp.asarray(_u8(pubs)))
    np.testing.assert_array_equal(np.asarray(jt), tables)
    rows = tables.shape[0]
    live = (idx >= 0) & (idx < rows)
    safe = np.where(live, idx, 0)
    jgot = np.asarray(jax.jit(jeb.verify_prehashed_table)(
        jnp.take(jt, safe, axis=0), jnp.take(jv, safe, axis=0) & live,
        *map(jnp.asarray, (r, s, k, s_ok)),
    )).tolist()
    assert got == plain == jgot == want
    kinds = {i % 8 for i, w in enumerate(want) if w}
    assert kinds == {0, 6, 7}, kinds  # the identity key's signature verifies


@pytest.mark.parametrize("b", [1, 23, 40])
def test_lanes_verdicts_on_row_prefixes(lib, batch, b):
    """Batches of 1, 23 and 40 rows (one row group; a LastCommit-sized
    round, which on the card ends in a partial warp; more than a warp's 8
    rows) give each row its verdict in the 64-row batch."""
    tables, tvalid, idx, r, s, k, s_ok, want, _ = batch
    ops = (idx[:b], r[:b], s[:b], k[:b], s_ok[:b])
    got = host_verify_table(lib, tables, tvalid, *ops)
    plain = eb.verify_prehashed_table_plain(
        *map(torch.from_numpy, (tables, tvalid, *ops))
    ).tolist()
    assert got == plain == want[:b]


def test_lanes_reject_one_flipped_challenge_alone(lib, batch):
    tables, tvalid, idx, r, s, k, s_ok, want, _ = batch
    k_bad = k.copy()
    k_bad[0, 0] ^= 1
    assert want[0]
    got = host_verify_table(lib, tables, tvalid, idx, r, s, k_bad, s_ok)
    assert got == [False] + want[1:]


def _point_bytes(p) -> list[list[int]]:
    return [list((c % P).to_bytes(32, "little")) for c in p]


def _limbs_to_int(v) -> int:
    return sum(int(x) << (51 * j) for j, x in enumerate(v)) % P


def test_x4_point_ops_equal_one_thread_limb_for_limb(lib):
    """ge_dbl_x4, ge_add_cached_x4 and ge_to_cached_lane against the
    one-thread functions: every lane ends with the one-thread limbs, and
    the values equal the plain PyTorch double/add_cached/to_cached."""
    rng = np.random.default_rng(7)
    pts, cached = [], []
    for j in range(12):
        p = host.scalar_mult(int(rng.integers(1, 2**62)), host.BASEPOINT)
        if j % 3 == 0:  # Z != 1
            p = host.point_add(p, host.scalar_mult(3 + j, host.BASEPOINT))
        q = host.IDENTITY if j == 5 else host.scalar_mult(
            int(rng.integers(1, 2**62)), host.BASEPOINT)
        pts.append(_point_bytes(host.IDENTITY if j == 4 else p))
        cached.append(curve.from_host_point_cached(q).tolist())
    pts = np.array(pts, dtype=np.uint8)
    cached = np.array(cached, dtype=np.uint8)
    n = pts.shape[0]
    out = np.zeros((n, 12, 4, 5), dtype=np.uint64)
    kb = _kbytes()
    assert lib.tm_host_point_ops(_ptr(pts), _ptr(cached), _ptr(kb), _ptr(out), n) == 0
    for lane in range(4):
        np.testing.assert_array_equal(out[:, 3 + lane], out[:, 0])  # dbl
        np.testing.assert_array_equal(out[:, 7 + lane], out[:, 1])  # add
    np.testing.assert_array_equal(out[:, 11], out[:, 2])  # to_cached lanes
    p_t = fe.from_bytes(torch.from_numpy(pts))
    c_t = fe.from_bytes(torch.from_numpy(cached))
    for slot, val in ((0, curve.double(p_t)), (1, curve.add_cached(p_t, c_t)),
                      (2, curve.to_cached(p_t))):
        want = fe.to_bytes(val).numpy()
        got = [[list(_limbs_to_int(out[i, slot, c]).to_bytes(32, "little"))
                for c in range(4)] for i in range(n)]
        np.testing.assert_array_equal(np.array(got, dtype=np.uint8), want)
