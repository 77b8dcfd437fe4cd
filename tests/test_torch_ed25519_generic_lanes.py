"""The four-lane schedule of kernel 4 (``tm_verify_generic``) on the CPU.

The kernel runs only on the card, but its row code is plain C++:
``verify_generic_x4``, ``neg_table_x4`` and the chain it shares with
kernel 3 (``table_points_x4``, ``verify_chain_x4``) in
``ops/csrc/ed25519_device.cuh``. The host harness
``tests/ed25519_lanes_host.cpp`` (built by the fixture of
``test_torch_ed25519_lanes.py``) runs the 4 lanes of a group in lock-step
through that source, with the tagged exchange that fails a call whose
lanes disagree, and a host array laid out as the card's shared-memory
table. The verdicts are held against the JAX package's
``verify_prehashed`` on the CPU backend, the port's plain version
(``eb.verify_prehashed_plain``) and the host oracle; each lane's table
components and its points (``[k](-A)``, ``[s]B`` and their sum) limb for
limb against the one-thread ``ge_to_cached``, ``ge_add_cached`` and
``ge_dbl`` of the same header, and as canonical bytes against the plain
PyTorch ``window_table`` and ``double_scalar_mult_base``; and
``chip_smoke.kernel4_rows``, the rows the card is checked on, through the
lanes. Tolerance: exact.
"""

import ctypes
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import curve25519 as curve
from tendermint_tpu_torch.ops import ed25519_batch as eb
from tendermint_tpu_torch.ops import field25519 as fe

from .test_torch_ed25519_lanes import (  # noqa: F401 (lib is a fixture)
    _kbytes, _limbs_to_int, _ptr, _u8, lib,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_ROWS = 48
P = host.P
# keys that are not a valid point: y = p (non-canonical), y = p + 1,
# y = 2^255 - 1, x = 0 with the sign bit set (y = 1); two keys with no
# square root are drawn from the seed
BAD_KEYS = [P.to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
            (2**255 - 1).to_bytes(32, "little"),
            ((1 << 255) | 1).to_bytes(32, "little")]
# small-order keys: the identity (y = 1), order 4 (y = 0), order 2 (y = -1)
SMALL_KEYS = [(1).to_bytes(32, "little"), bytes(32), (P - 1).to_bytes(32, "little")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def glib(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_host_verify_generic.argtypes = [vp] * 8 + [i, i]
    lib.tm_host_verify_generic.restype = i
    lib.tm_host_generic_points.argtypes = [vp] * 6 + [i]
    lib.tm_host_generic_points.restype = i
    return lib


def host_verify_generic(glib, pub, r, s, k, s_ok, fault: int = 0) -> int | list[bool]:
    """The harness's four-lane generic verify on numpy operands shaped as
    the wrapper's: the verdicts, or with `fault` the harness's return code."""
    pub, r, s, k, s_ok = (np.ascontiguousarray(a) for a in (pub, r, s, k, s_ok))
    base = curve.base_table_bytes()
    kb = _kbytes()
    out = np.full(pub.shape[0], 7, dtype=np.uint8)
    rc = glib.tm_host_verify_generic(
        _ptr(pub), _ptr(r), _ptr(s), _ptr(k), _ptr(s_ok), _ptr(base), _ptr(kb),
        _ptr(out), pub.shape[0], fault,
    )
    if fault:
        return rc
    assert rc != -1, "the 4 lanes fell out of lock-step"
    assert rc != -2, "the 4 lanes of a row reached different verdicts"
    assert rc == 0
    assert set(out.tolist()) <= {0, 1}, "a row's verdict was not written"
    return [bool(v) for v in out]


def _rows():
    """N_ROWS rows; row i's kind is i % 8: valid, wrong message, a flipped
    signature bit, s >= L, an invalid key (BAD_KEYS and two with no square
    root, in turn), a zero padding row (s_ok False), a small-order key
    (SMALL_KEYS in turn) signing with R = [s]B, and valid on another key.
    Returns (items, padding row indices, want)."""
    rng = np.random.default_rng(2027)
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(10)]
    bad = list(BAD_KEYS)
    while len(bad) < 6:
        cand = rng.bytes(32)
        if host.point_decompress(cand) is None and cand[31] < 0x7F:
            bad.append(cand)
    items, pad = [], []
    for i in range(N_ROWS):
        kind = i % 8
        key = keys[(i // 8 + 3 * (kind == 7)) % len(keys)]
        pub, msg = key.public_key().data, b"generic row %d" % i
        sig = key.sign(msg)
        if kind == 1:
            msg += b"?"
        elif kind == 2:
            sig = sig[:9] + bytes([sig[9] ^ 0x20]) + sig[10:]
        elif kind == 3:
            s_big = int.from_bytes(sig[32:], "little") + host.L
            sig = sig[:32] + s_big.to_bytes(32, "little")
        elif kind == 4:
            pub = bad[(i // 8) % len(bad)]
        elif kind == 5:
            pub, msg, sig = bytes(32), b"", bytes(64)
            pad.append(i)
        elif kind == 6:
            s_int = 1000 + i
            pub = SMALL_KEYS[(i // 8) % len(SMALL_KEYS)]
            sig = host.point_compress(host.scalar_mult(s_int, host.BASEPOINT)) + \
                s_int.to_bytes(32, "little")
        items.append((pub, msg, sig))
    want = [i not in pad and host.verify(p, m, sg) for i, (p, m, sg) in enumerate(items)]
    return items, pad, want


@pytest.fixture(scope="module")
def batch():
    items, pad, want = _rows()
    pub = _u8(p for p, _, _ in items)
    r = _u8(sg[:32] for _, _, sg in items)
    s = _u8(sg[32:] for _, _, sg in items)
    k = _u8(host.challenge(sg[:32], p, m).to_bytes(32, "little") for p, m, sg in items)
    s_ok = np.array([int.from_bytes(sg[32:], "little") < host.L for _, _, sg in items])
    for i in pad:
        k[i] = 0
        s_ok[i] = False
    kinds = {i % 8 for i, w in enumerate(want) if w}
    assert kinds == {0, 6, 7}, kinds  # the small-order keys' signatures verify
    return pub, r, s, k, s_ok, want


@pytest.fixture(scope="module")
def jax_verdicts(batch):
    pub, r, s, k, s_ok, _ = batch
    return np.asarray(jeb.verify_prehashed_jit(
        *map(jnp.asarray, (pub, r, s, k, s_ok)))).tolist()


def test_generic_lanes_verdicts_match_plain_jax_and_oracle(glib, batch, jax_verdicts):
    pub, r, s, k, s_ok, want = batch
    got = host_verify_generic(glib, pub, r, s, k, s_ok)
    plain = eb.verify_prehashed_plain(*map(torch.from_numpy, (pub, r, s, k, s_ok))).tolist()
    assert got == plain == jax_verdicts == want


@pytest.mark.parametrize("b", [1, 23, 40])
def test_generic_lanes_verdicts_on_row_prefixes(glib, batch, jax_verdicts, b):
    """Batches of 1, 23 and 40 rows (one row group; a partial last warp on
    the card; more than a warp's 8 rows), padding rows between live ones,
    give each row its verdict in the whole batch: the JAX package's, the
    plain version's and the host oracle's."""
    pub, r, s, k, s_ok, want = batch
    ops = tuple(a[:b] for a in (pub, r, s, k, s_ok))
    got = host_verify_generic(glib, *ops)
    plain = eb.verify_prehashed_plain(*map(torch.from_numpy, ops)).tolist()
    assert got == plain == jax_verdicts[:b] == want[:b]


def test_generic_lanes_reject_one_flipped_challenge_alone(glib, batch):
    pub, r, s, k, s_ok, want = batch
    k_bad = k.copy()
    k_bad[8, 0] ^= 1
    assert want[8]
    got = host_verify_generic(glib, pub, r, s, k_bad, s_ok)
    assert got == want[:8] + [False] + want[9:]


@pytest.mark.parametrize("fault", [1, 2], ids=["lane leaves early", "extra exchange"])
def test_harness_fails_a_lane_out_of_step(glib, batch, fault):
    """A lane that leaves its group before the others, or makes one
    exchange more than they do, fails the call."""
    pub, r, s, k, s_ok, want = batch
    assert want[0]
    ops = tuple(a[:2] for a in (pub, r, s, k, s_ok))
    assert host_verify_generic(glib, *ops, fault=fault) == -1


def _canon(limbs: np.ndarray) -> np.ndarray:
    """[..., 5] uint64 limbs -> [..., 32] canonical bytes."""
    flat = limbs.reshape(-1, 5)
    out = [list(_limbs_to_int(v).to_bytes(32, "little")) for v in flat]
    return np.array(out, dtype=np.uint8).reshape(limbs.shape[:-1] + (32,))


def test_generic_lanes_table_and_points_equal_one_thread_limb_for_limb(glib, batch):
    """Each lane's component of the 16 table entries, and each lane's acc,
    sb and q, equal the one-thread kernel's limbs; as values they equal the
    plain PyTorch window table of -A and double_scalar_mult_base."""
    pub, _, s, k, _, _ = batch
    live = [i for i in range(N_ROWS)
            if i % 8 not in (4, 5) and host.point_decompress(bytes(pub[i])) is not None]
    assert len(live) >= 30
    pub, s, k = (np.ascontiguousarray(a[live]) for a in (pub, s, k))
    n = len(live)
    out = np.zeros((n, 47, 4, 5), dtype=np.uint64)
    rc = glib.tm_host_generic_points(_ptr(pub), _ptr(s), _ptr(k),
                                     _ptr(curve.base_table_bytes()), _ptr(_kbytes()),
                                     _ptr(out), n)
    assert rc == 0
    np.testing.assert_array_equal(out[:, 19:35], out[:, 0:16])  # the table
    for lane in range(4):
        np.testing.assert_array_equal(out[:, 35 + 3 * lane:38 + 3 * lane], out[:, 16:19])
    a_point, a_valid = curve.decompress(torch.from_numpy(pub))
    assert bool(a_valid.all())
    neg_a = curve.neg(a_point)
    table = fe.to_bytes(curve.window_table(neg_a)).numpy()
    np.testing.assert_array_equal(_canon(out[:, 0:16]), table)
    q = curve.double_scalar_mult_base(torch.from_numpy(s), torch.from_numpy(k), neg_a)
    # q is projective: compare the affine points
    got = _canon(out[:, 18])
    want = fe.to_bytes(q).numpy()
    for g, w in zip(got, want):
        gx, gy, gz = (int.from_bytes(bytes(c), "little") for c in g[:3])
        wx, wy, wz = (int.from_bytes(bytes(c), "little") for c in w[:3])
        assert gx * wz % P == wx * gz % P and gy * wz % P == wy * gz % P


@pytest.mark.parametrize("b,n_pad", [(1, 0), (23, 2)])
def test_chip_smoke_kernel4_rows_through_the_lanes(glib, b, n_pad):
    """chip_smoke.py's kernel 4 rows (mixed_rows with a padding row and a
    valid signature under s_ok False inside the batch, the last n_pad rows
    padding) get the host oracle's verdicts from the four lanes and the
    plain version, on the CPU."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(16)]
    pubs = [kk.public_key().data for kk in keys] + SMALL_KEYS + BAD_KEYS
    ops, want = cs.kernel4_rows(torch, host, keys, pubs, b, n_pad, b"k4-%d" % b,
                                torch.device("cpu"))
    got = host_verify_generic(glib, *(t.numpy() for t in ops))
    assert got == eb.verify_prehashed_plain(*ops).tolist() == want
    if b > 8:
        assert not ops[4][3] and not ops[4][8] and not want[8]
        assert not ops[0][3].any()  # a zero padding row between live ones
