"""The four-lane secp256k1 verify kernel (``tm_secp_verify``) on the CPU.

Each live row runs on a group of 4 lanes of a warp, 8 rows a warp:
``secp_row_g`` of ``ops/csrc/secp256k1_device.cuh`` builds the row's table
of Q and runs the radix-16 ladder with ``dbl_g`` and ``add_g``, which run
the one-thread ``pt_double``/``pt_add`` as the stage programs ``S_DBL``,
``S_HR`` and ``S_ADD_FIN`` (``ops/secp_lane_gen.py`` compiles them from the
G1 graph functions of ``ops/bls_warp_gen.py``) over the 32-bit-limb field
``fs``, with the one-thread branches between them. The host harness
``tests/secp_lanes_host.cpp`` (g++, into ``tendermint_tpu_torch/_kbuild/``)
runs them with 4 host threads a group in lock-step, each group over its
own slots, several groups at once; a run fails when a group's lanes
disagree on the count of stages, a lane syncs with another mask than its
group's, touches a slot outside its group's region, or a stage lets one
lane read or overwrite a slot another lane writes.

Held, exactly (both cores keep every value canonical):
- ``fs`` against Python integers and the one-thread ``fe`` limb for limb,
  on operands at 0, 1, p - 1, p, 2^256 - 1, seeded ones and products
  whose fold carries past 2^256 twice; ``fs_from_limbs`` against
  ``fe_from_limbs`` on any int32 limbs;
- the programs through ``simulate(..., p=P, lanes=4)`` (a lane's chain of
  additions in order, the stage rule checked) against the port's host
  oracle ``crypto/secp256k1._jdouble`` and ``_jadd`` (add-2007-bl's sum is
  the oracle's with Z scaled by 2), and the merged programs as the same
  jobs and product stages as the unmerged ones;
- ``add_g`` and ``dbl_g`` against the one-thread ``pt_add`` and
  ``pt_double`` limb for limb in every branch, the groups of one call on
  different branches at once, and as values against the JAX package's
  ``add_points`` and ``double`` (run op by op on the CPU backend);
- whole rows (tables of Q and R limb for limb, verdicts) against the
  one-thread kernel's row, ``verify_prehashed_plain`` and the JAX
  package's rule on ``chip_smoke.secp_crafted_rows``' 64 rows, and on 128
  seeded rows with padding against the host oracle. The JAX package's
  ``verify_prehashed`` itself runs a row op by op for over ten minutes on
  this CPU (its jitted form is the slow-marked test of
  ``tests/test_torch_secp_verify.py``), so its verdicts enter through its
  rule on its host modules;
- the harness failing a group out of lock-step, and ``chip_smoke.py``'s
  lane constants against the programs and the kernel's source.
"""

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.crypto import secp_native as jnative
from tendermint_tpu_torch.crypto import secp256k1 as host
from tendermint_tpu_torch.crypto import secp_native
from tendermint_tpu_torch.ops import bls_warp_gen as gen
from tendermint_tpu_torch.ops import secp256k1_kernel as sk
from tendermint_tpu_torch.ops import secp_lane_gen as sgen

ROOT = pathlib.Path(__file__).resolve().parent.parent
HARNESS = ROOT / "tests" / "secp_lanes_host.cpp"
CSRC = ROOT / "tendermint_tpu_torch" / "ops" / "csrc"
SOURCES = [HARNESS, CSRC / "secp256k1_device.cuh", CSRC / "secp256k1_programs.cuh"]
BUILD_DIR = ROOT / "tendermint_tpu_torch" / "_kbuild"

P, N = sk.P, sk.N
RNG = np.random.default_rng(20261017)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are thousands of small tensor operations: one
    intra-op thread keeps them from contending with other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lib():
    """The harness, built once per source content (g++, a few seconds)."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"secp_lanes_host.{digest[:16]}.so"
    if not so.exists():
        tmp = so.with_suffix(f".build.{os.getpid()}")
        subprocess.run(
            ["g++", "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC",
             "-Wno-unknown-pragmas", "-o", str(tmp), str(HARNESS)],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("tm_host_fs_ops", [vp, vp, i, vp]),
        ("tm_host_fs_from_limbs", [vp, i, vp]),
        ("tm_host_secp_ops", [vp, vp, i, vp]),
        ("tm_host_secp_rows", [vp, vp, vp, vp, vp, vp, vp, i, vp, vp, vp]),
        ("tm_host_secp_selftest", [vp, vp, i]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _b32(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)


def _int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _below(bound: int) -> int:
    return int.from_bytes(RNG.bytes(40), "little") % bound


@pytest.fixture(scope="module")
def progs():
    return sgen.compile_all()


# --- the generator ----------------------------------------------------------


def test_programs_header_is_the_generators_output():
    """The committed tables are what secp_lane_gen writes today."""
    assert sgen.HEADER.read_text() == sgen.generate()


def test_programs_fit_a_group_of_four_lanes(progs):
    """At most 4 products a stage, and no merged addition stage longer than
    the stages it replaced; an addition takes 16 products on a path of 5,
    a doubling 7 on a path of 3 (the one-thread counts,
    chip_smoke.FE_SECP_ADD and FE_SECP_DBL); every slot below S_SLOTS."""
    for name, build in sgen.PROGRAMS.items():
        unmerged = gen.compile_program(name, build, sgen.S_TEMP, sgen.JOBS_PER_STAGE,
                                       reuse_slots=False)["stages"]
        merged = progs[name]["stages"]
        assert [k for k, _ in merged if k == "mul"] == [k for k, _ in unmerged if k == "mul"]
        assert sorted(w for _, js in merged for w in js if w) == sorted(
            w for _, js in unmerged for w in js)
        assert len(merged) <= len(unmerged)
        for kind, js in merged:
            if kind == "mul":
                assert len(js) <= sgen.LANES, name
    assert progs["S_HR"]["muls"] + progs["S_ADD_FIN"]["muls"] == chip_smoke.FE_SECP_ADD
    assert progs["S_DBL"]["muls"] == chip_smoke.FE_SECP_DBL
    assert progs["S_HR"]["path"] + progs["S_ADD_FIN"]["path"] == 5
    assert progs["S_DBL"]["path"] == 3
    slots = int(re.search(r"S_SLOTS = (\d+);", sgen.HEADER.read_text()).group(1))
    assert slots == max(p["temps"] for p in progs.values())


# --- the field core -------------------------------------------------------------


def _fold_wraps(a: int, b: int) -> bool:
    """Whether fs_mul's second fold of a b carries past 2^256."""
    t = a * b
    v1 = (t % (1 << 256)) + (t >> 256) * ((1 << 32) + 977)
    v2 = (v1 % (1 << 256)) + (v1 >> 256) * ((1 << 32) + 977)
    return v2 >> 256 != 0


def _wrapping_pairs():
    """Pairs (2^256 - 1, b) whose product folds past 2^256 twice: with a =
    2^256 - 1, the first fold is 2^256 + b m - F (F = 2^32 + 977, m = F -
    1 = 16 (2^28 + 61)); it wraps into [2^256 - x, 2^256) for b m = F - x
    mod 2^256, x = 17 (F - x must be a multiple of 16)."""
    a, f = (1 << 256) - 1, (1 << 32) + 977
    base = (f - 17) // 16 * pow((1 << 28) + 61, -1, 1 << 252) % (1 << 252)
    pairs = [(a, base + k * (1 << 252)) for k in range(16)]
    assert all(_fold_wraps(x, y) for x, y in pairs)
    return pairs


def test_fs_core_equals_python_and_fe_limb_for_limb(lib):
    """fs_mul of any 256-bit operands, fs_add and fs_sub of canonical ones,
    against Python's integers and the one-thread fe_mul, fe_add, fe_sub."""
    edges = [0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 256) - 1, (1 << 255) + 3]
    vals = edges + [_below(1 << 256) for _ in range(24)]
    pairs = [(a, b) for a in vals for b in vals] + _wrapping_pairs()
    assert sum(_fold_wraps(a, b) for a, b in pairs) >= 16
    for ps, canonical in ((pairs, False), ([(a % P, b % P) for a, b in pairs], True)):
        a = np.stack([_b32(x) for x, _ in ps])
        b = np.stack([_b32(y) for _, y in ps])
        out = np.zeros((len(ps), 6, 8), dtype=np.uint32)
        assert lib.tm_host_fs_ops(_ptr(a), _ptr(b), len(ps), _ptr(out)) == 0
        for k, (x, y) in enumerate(ps):
            assert _int(out[k, 0]) == _int(out[k, 1]) == x * y % P, (hex(x), hex(y))
            if canonical:
                assert _int(out[k, 2]) == _int(out[k, 3]) == (x + y) % P
                assert _int(out[k, 4]) == _int(out[k, 5]) == (x - y) % P
        if canonical:
            assert np.array_equal(out[:, 2], out[:, 3]) and np.array_equal(out[:, 4], out[:, 5])
        assert np.array_equal(out[:, 0], out[:, 1])


def test_fs_from_limbs_equals_fe_from_limbs(lib):
    """The coordinates' radix-2^8 limbs, in the kernel's [0, 2^11) and any
    int32 values, to fs and fe: the same canonical limbs, the value mod p."""
    limbs = np.concatenate([
        RNG.integers(0, 1 << 11, (16, 32)),
        RNG.integers(-(1 << 31), 1 << 31, (16, 32)),
        np.stack([sk.fe.from_int(v) for v in (0, 1, P - 1, sk.GX)]),
        np.full((2, 32), -1), np.full((2, 32), (1 << 31) - 1),
    ]).astype(np.int32)
    out = np.zeros((len(limbs), 2, 8), dtype=np.uint32)
    assert lib.tm_host_fs_from_limbs(_ptr(limbs), len(limbs), _ptr(out)) == 0
    assert np.array_equal(out[:, 0], out[:, 1])
    for k, row in enumerate(limbs):
        assert _int(out[k, 0]) == sum(int(v) << (8 * i) for i, v in enumerate(row)) % P
    assert _int(out[35, 0]) == sk.GX


# --- the programs -------------------------------------------------------------


def _rescale(pt, lam):
    """The same point in another Jacobian representation: (x l^2, y l^3, z l)."""
    x, y, z = pt
    return (x * lam * lam % P, y * pow(lam, 3, P) % P, z * lam % P)


def _rand_point():
    k = _below(N - 1) + 1
    return _rescale(host._jmul(k, (sk.GX, sk.GY, 1)), _below(P - 1) + 1)


@pytest.mark.parametrize("op", ["add", "dbl"])
def test_programs_compute_the_host_oracles_operation(progs, op):
    """S_HR then S_ADD_FIN (or S_DBL) in Python mod p, against the port's
    host oracle: _jdouble's coordinates exactly; _jadd's sum with Z scaled
    by 2 (add-2007-bl's z3 = 2 z1 z2 h, the oracle's z1 z2 h)."""
    for _ in range(8):
        p, q = _rand_point(), _rand_point()
        slots = {0: 0, 1: 1}
        slots.update({sgen.S_P + c: v for c, v in enumerate(p)})
        slots.update({sgen.S_Q + c: v for c, v in enumerate(q)})
        if op == "dbl":
            gen.simulate(progs["S_DBL"], slots, p=P, lanes=sgen.LANES)
            want = host._jdouble(p)
        else:
            gen.simulate(progs["S_HR"], slots, p=P, lanes=sgen.LANES)
            assert slots[sgen.S_H] != 0
            gen.simulate(progs["S_ADD_FIN"], slots, p=P, lanes=sgen.LANES)
            want = _rescale(host._jadd(p, q), 2)
        assert tuple(slots[sgen.S_P + c] for c in range(3)) == want


# --- the group functions --------------------------------------------------------


def _pt_bytes(pt) -> np.ndarray:
    return np.concatenate([_b32(v % P) for v in pt])


def _pair_cases():
    """(label, p, q) of every branch of pt_add and pt_double."""
    inf = (0, 1, 0)
    fp = lambda: _below(P - 1) + 1  # noqa: E731
    on = lambda pt: (pt, _rescale(pt, fp()))  # noqa: E731
    pts = [_rand_point() for _ in range(8)]
    cases = [(f"seeded {i}", pts[i], pts[-1 - i]) for i in range(3)]
    cases += [(f"off-curve {i}", (fp(), fp(), fp()), (fp(), fp(), fp())) for i in range(2)]
    cases += [
        ("special limbs", (P - 1, 1, P - 1), (1, P - 1, 2)),
        ("affine q (z = 1)", pts[3], (pts[4][0] * pow(pts[4][2], -2, P) % P,
                                      pts[4][1] * pow(pts[4][2], -3, P) % P, 1)),
        ("p at infinity", inf, pts[1]),
        ("q at infinity", pts[2], inf),
        ("p at infinity, other x y", (fp(), fp(), 0), pts[3]),
        ("both at infinity", inf, (5, 7, 0)),
        ("p = q", pts[5], pts[5]),
        ("p = q, two representations", *on(pts[6])),
        ("p = q off the curve", *on((fp(), fp(), fp()))),
        ("p = -q", pts[7], _rescale((pts[7][0], P - pts[7][1], pts[7][2]), fp())),
        ("doubling with y = 0", *on((fp(), 0, fp()))),
    ]
    return cases


CASES = _pair_cases()
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def op_results(lib):
    """All pairs at once, pair i on group i: [n, 4, 24] words (pt_add,
    add_g, pt_double, dbl_g)."""
    p = np.stack([_pt_bytes(c[1]) for c in CASES])
    q = np.stack([_pt_bytes(c[2]) for c in CASES])
    words = np.zeros((len(CASES), 4, 24), dtype=np.uint32)
    assert lib.tm_host_secp_ops(_ptr(p), _ptr(q), len(CASES), _ptr(words)) == 0
    return words


@pytest.mark.parametrize("label", LABELS)
def test_group_ops_equal_one_thread_limb_for_limb(op_results, label):
    """add_g and dbl_g on a group of 4 lanes against pt_add and pt_double,
    in every branch (p or q at infinity, both, p = q in two
    representations, p = -q, y = 0), the groups of one call on different
    branches at once."""
    k = LABELS.index(label)
    w = op_results[k]
    assert np.array_equal(w[1], w[0]), f"add_g != pt_add ({label})"
    assert np.array_equal(w[3], w[2]), f"dbl_g != pt_double ({label})"
    _, p, q = CASES[k]
    if label == "p = -q":
        assert _int(w[1][16:]) == 0 and _int(w[1][8:16]) == 1
    if label == "doubling with y = 0":
        assert [_int(w[3][8 * c:8 * c + 8]) for c in range(3)] == [0, 1, 0]


def _coords(words) -> tuple:
    return tuple(_int(words[8 * c:8 * c + 8]) for c in range(3))


def test_group_ops_equal_the_jax_packages_add_points_and_double(op_results):
    """The same pairs through the JAX package's add_points and double
    (tendermint_tpu/ops/secp256k1_kernel.py, its masks and formulas) on the
    CPU backend, op by op: the same field elements, coordinate for
    coordinate."""
    import jax
    import jax.numpy as jnp

    from tendermint_tpu.ops import secp256k1_kernel as jk

    def limbs(pts):
        return jnp.asarray(np.stack([np.stack([jk.fe.from_int(c % P) for c in pt])
                                     for pt in pts]).astype(np.int32))

    with jax.disable_jit():
        s = np.asarray(jk.add_points(limbs([c[1] for c in CASES]), limbs([c[2] for c in CASES])))
        d = np.asarray(jk.double(limbs([c[1] for c in CASES])))
    for k, label in enumerate(LABELS):
        got_s = tuple(jk.fe.to_int(s[k, c]) % P for c in range(3))
        got_d = tuple(jk.fe.to_int(d[k, c]) % P for c in range(3))
        assert _coords(op_results[k, 1]) == got_s, label
        assert _coords(op_results[k, 3]) == got_d, label


@pytest.mark.parametrize("fault", [0, 1, 2, 3, 4])
def test_harness_fails_a_group_out_of_lock_step(lib, fault):
    """add_g of p = q in two representations (the doubling branch) on group
    0 of two: clean it passes; a lane that syncs once more, a lane that
    reads a slot of the neighbour group, a lane that syncs with the whole
    warp's mask, and a lane that writes h in the stage where every lane
    reads it each fail the run."""
    _, p, q = CASES[LABELS.index("p = q, two representations")]
    assert lib.tm_host_secp_selftest(_ptr(_pt_bytes(p)), _ptr(_pt_bytes(q)), fault) == (
        0 if fault == 0 else -1)


# --- whole rows -----------------------------------------------------------------


def _harness_rows(lib, arrays):
    """(verdicts [b, 2], tables [b, 2, 16, 24], R [b, 2, 24]): the lanes'
    then the one-thread row's."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    gtab = np.ascontiguousarray(sk._G_WORDS.get("cpu").numpy())
    b = len(arrays[0])
    ver = np.zeros((b, 2), dtype=np.uint8)
    tab = np.zeros((b, 2, 16, 24), dtype=np.uint32)
    acc = np.zeros((b, 2, 24), dtype=np.uint32)
    assert lib.tm_host_secp_rows(*(_ptr(a) for a in arrays), _ptr(gtab), b, _ptr(ver),
                                 _ptr(tab), _ptr(acc)) == 0
    return ver.astype(bool), tab, acc


def _check_rows(lib, arrays, want):
    ver, tab, acc = _harness_rows(lib, arrays)
    assert np.array_equal(tab[:, 0], tab[:, 1]), "the lanes' tables of Q != tab[d]"
    assert np.array_equal(acc[:, 0], acc[:, 1]), "the lanes' R != the one-thread R"
    assert ver[:, 1].tolist() == want, "the one-thread row != the rule"
    assert ver[:, 0].tolist() == want, "the lanes != the rule"
    plain = sk.verify_prehashed_plain(*(torch.from_numpy(a) for a in arrays))
    assert plain.tolist() == want, "verify_prehashed_plain != the rule"
    live = np.asarray(arrays[5])
    assert not tab[~live].any() and tab[live, 0, 1].any()
    return ver


def test_harness_crafted_rows_equal_one_thread_plain_and_the_jax_rule(lib):
    """chip_smoke's 64 crafted rows (valid, flipped s, wrong message, cross
    key, ok_in False, Q = G with u1 = u2, R at infinity, x(R) >= n direct
    and wrapped, the forged wrap, u1 = u2 = 0, padding) on blocks of 16
    groups: every table entry and R limb for limb, and the verdicts equal
    the one-thread row's, the plain version's and the JAX package's rule
    on its host modules."""
    rows, want = chip_smoke.secp_crafted_rows(host, secp_native, np.random.default_rng(11))
    jrows, jwant = chip_smoke.secp_crafted_rows(jsecp, jnative, np.random.default_rng(11))
    assert rows == jrows and want == jwant
    _check_rows(lib, chip_smoke.secp_row_arrays(np, sk.fe, rows), want)


def test_harness_seeded_rows_with_padding_equal_the_host_oracle(lib):
    """128 seeded rows: signatures of 8 keys, a quarter of them with a
    flipped s, a wrong message or another key, every eighth row padding
    (ok_in False) inside blocks of live rows; verdicts against the host
    oracle's verify and the plain version."""
    keys = [host.PrivKey.from_secret(b"secp-lanes-%d" % i) for i in range(8)]
    rows, want = [], []
    for i in range(128):
        if i % 8 == 7:
            rows.append(((0, 0), 0, 0, 0, False))
            want.append(False)
            continue
        k = keys[i % 8]
        msg = b"lanes-%d" % i
        sig = k.sign(msg)
        pub = k.public_key().data
        if i % 16 == 3:
            sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
        elif i % 16 == 5:
            msg += b"?"
        elif i % 16 == 9:
            pub = keys[(i + 1) % 8].public_key().data
        prep = secp_native.prep_digest_item(pub, hashlib.sha256(msg).digest(), sig)
        assert prep is not None
        r, pt, u1, u2 = prep
        rows.append((pt, u1, u2, r, True))
        want.append(host.PubKey(pub).verify(msg, sig))
    assert 64 < sum(want) < 112
    _check_rows(lib, chip_smoke.secp_row_arrays(np, sk.fe, rows), want)


# --- the kernel and chip_smoke.py -------------------------------------------------


def test_no_kernel_runs_the_one_thread_point_code():
    """secp256k1_kernels.cu launches secp_row_g, whose point operations are
    the group functions; pt_add and pt_double stay as the harness's
    reference."""
    src = (CSRC / "secp256k1_kernels.cu").read_text()
    dev = (CSRC / "secp256k1_device.cuh").read_text()
    row = dev[dev.index("__device__ __forceinline__ void secp_row_g("):]
    assert "secp_row_g(w, row," in src
    for text in (src, row):
        assert not re.search(r"\bpt_(add|double)\(", text)
        assert not re.search(r"\bfe_(mul|sqr|add|sub)\(", text)


def test_chip_smokes_lane_constants_are_the_programs_and_kernel(progs):
    """chip_smoke.py's lane path constants are the programs' paths; its
    group width is the kernel's; the lane path of a row is the one-thread
    count's walk with a doubling 3 and an addition 5."""
    assert chip_smoke.SECP_DBL_PATH == progs["S_DBL"]["path"]
    assert chip_smoke.SECP_ADD_PATH == progs["S_HR"]["path"] + progs["S_ADD_FIN"]["path"]
    dev = (CSRC / "secp256k1_device.cuh").read_text()
    assert int(re.search(r"kRowLanes = (\d+);", dev).group(1)) == chip_smoke.SECP_ROW_LANES
    assert chip_smoke.SECP_ROW_LANES == sgen.LANES
    u1, u2 = _below(N), _below(N)
    assert chip_smoke.secp_lane_path(0, 0) == 7 * 3 + 7 * 5 + 2
    assert chip_smoke.secp_fe_muls(0, 0) == 7 * 7 + 7 * 16 + 3
    one, four = chip_smoke.secp_fe_muls(u1, u2), chip_smoke.secp_lane_path(u1, u2)
    assert 3500 < one < 4000 and 1300 < four < 1500


def test_chip_kernels_split_patches_match_the_sources():
    """chip_kernels.py's kernel 10 split builds patch run_program: each
    patch's text is in this tree's sources once."""
    import chip_kernels

    for name, patches in chip_kernels.SECP_SPLITS.items():
        for fname, old, _ in patches:
            assert (CSRC / fname).read_text().count(old) == 1, name
