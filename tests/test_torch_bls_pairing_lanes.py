"""The warp-wide pairing kernels (``tm_miller``, ``tm_final_exp``) on the CPU.

The kernels run only on the card, but their bodies are plain C++: the
32-bit-limb Fp core (``fq``), the stage-program interpreter
``run_program`` and ``miller_chunk_w``, ``chunk_product_w`` and
``final_exp_w`` of ``ops/csrc/bls12_381_device.cuh``, over the programs
that ``ops/bls_warp_gen.py`` writes to ``ops/csrc/bls12_381_programs.cuh``.
g++ builds that header with the host harness ``tests/bls_pairing_host.cpp``
into ``tendermint_tpu_torch/_kbuild/``, where 32 host threads run the lanes
of a warp in lock-step through the same source; the harness fails a run
whose lanes disagree on the count of stages, or whose stage lets one lane
read or overwrite a slot another lane writes.

Held, exactly (the core reduces fully, so no value is compared mod p):
- the fq core against the one-thread 64-bit ``fp_mul``, ``fp_add``,
  ``fp_sub`` (``fq_add_sub``), ``fp_load``, ``fp_inv`` and ``fp_store`` on seeded and edge
  operands (0, 1, p - 1, p - 2, R mod p, 2^384 - 1), limb for limb, and
  against Python's Montgomery product;
- each warp-wide f12 operation (``MUL12``, and the test programs of
  ``f12_sqr``, ``f12_mul_line``, ``f12_cyclo_sqr``, ``f12_frob``,
  ``f12_inv``) against its one-thread function, limb for limb; the stage
  tables, and the G2 sums' (``G2_HR``, ``G2_ADD_FIN``, ``G2_DBL``, whose
  warp functions ``tests/test_torch_bls_g2_lanes.py`` holds), against the
  host oracle in Python;
- one Miller bit (``M_DBL``, ``M_ADD``) against the one-thread steps;
- the harness's Miller value and final exponentiation against
  ``miller_plain``/``final_exp_plain`` byte for byte and the host
  oracle's pairing, at the 2-pair verify shape, a 10-pair shape (an
  identity pair dropped, 9 pairs in 5 chunks padded to 8) and adversarial
  operands; the slow-marked test against the JAX package's ``miller_jit``
  and ``final_exponentiation`` themselves (they compile for tens of
  minutes on the CPU).
"""

import ctypes
import hashlib
import importlib.util
import os
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls12_381 as ref
from tendermint_tpu_torch.ops import bls_pairing as bp
from tendermint_tpu_torch.ops import bls_warp_gen as gen

ROOT = pathlib.Path(__file__).resolve().parent.parent
HARNESS = ROOT / "tests" / "bls_pairing_host.cpp"
CSRC = ROOT / "tendermint_tpu_torch" / "ops" / "csrc"
SOURCES = [HARNESS, CSRC / "bls12_381_device.cuh", CSRC / "bls12_381_programs.cuh"]
BUILD_DIR = ROOT / "tendermint_tpu_torch" / "_kbuild"

P = ref.P
R_MONT = 1 << 384
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
    so = BUILD_DIR / f"bls_pairing_host.{digest[:16]}.so"
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
        ("tm_host_fq_ops", [vp, vp, i, vp]),
        ("tm_host_f12_ops", [vp, vp, i, vp]),
        ("tm_host_miller_bit", [vp, vp, i, i, vp]),
        ("tm_host_miller", [vp, vp, vp, vp, vp, vp, vp, i]),
        ("tm_host_final_exp", [vp, vp, i]),
        ("tm_host_final_exp_one_thread", [vp, vp, i]),
        ("tm_host_lockstep_selftest", [i]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _b48(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(48, "little"), dtype=np.uint8)


def _int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _below(bound: int) -> int:
    return int.from_bytes(RNG.bytes(56), "little") % bound


SPECIAL = [0, 1, P - 1, P, P + 1, R_MONT - 1]


def _limb() -> int:
    """0, 1, p - 1, p, p + 1, 2^384 - 1, a value >= p or one below p."""
    k = int(RNG.integers(0, len(SPECIAL) + 3))
    if k < len(SPECIAL):
        return SPECIAL[k]
    if k == len(SPECIAL):
        return P + _below(R_MONT - P)
    return _below(P)


def _f12(values) -> np.ndarray:
    return np.stack([_b48(v) for v in values]).reshape(6, 2, 48)


# --- the generator ----------------------------------------------------------


def test_programs_header_is_the_generators_output():
    """The committed tables are what bls_warp_gen writes today."""
    assert gen.HEADER.read_text() == gen.generate()


@pytest.fixture(scope="module")
def progs():
    return gen.compile_all()


def _slots_f12(base, v):
    return {base + 2 * i + c: v[i][c] % P for i in range(6) for c in range(2)}


def _get_f12(slots, base):
    return tuple((slots[base + 2 * i], slots[base + 2 * i + 1]) for i in range(6))


def _rand_f12():
    return tuple((_below(P), _below(P)) for _ in range(6))


def _g2_program_values(progs, name):
    """(got, want) of a G2 program's simulate run on two points of the
    subgroup: G2_HR's z1z1, z2z2, u1, s1, h, r; G2_HR then G2_ADD_FIN's sum;
    G2_DBL's double of P. The oracle's g2_add/g2_double are the one-thread
    formulas, so the coordinates themselves agree."""
    p, q = (ref.g2_mul(ref.G2_GEN, _below(ref.R - 1) + 1) for _ in range(2))
    slots = gen.const_slots()
    for base, pt in ((gen.G2_P, p), (gen.G2_Q, q)):
        slots.update({base + 2 * c + k: pt[c][k] for c in range(3) for k in range(2)})
    for prog in {"G2_HR": ["G2_HR"], "G2_ADD_FIN": ["G2_HR", "G2_ADD_FIN"],
                 "G2_DBL": ["G2_DBL"]}[name]:
        gen.simulate(progs[prog], slots)
    if name == "G2_HR":
        (x1, y1, z1), (x2, y2, z2) = p, q
        z1z1, z2z2 = ref.f2_sqr(z1), ref.f2_sqr(z2)
        u1 = ref.f2_mul(x1, z2z2)
        s1 = ref.f2_mul(ref.f2_mul(y1, z2), z2z2)
        h = ref.f2_sub(ref.f2_mul(x2, z1z1), u1)
        r = ref.f2_sub(ref.f2_mul(ref.f2_mul(y2, z1), z1z1), s1)
        bases = (gen.G2_Z1Z1, gen.G2_Z2Z2, gen.G2_U1, gen.G2_S1, gen.G2_H, gen.G2_R)
        return [(slots[b], slots[b + 1]) for b in bases], [z1z1, z2z2, u1, s1, h, r]
    got = tuple((slots[gen.G2_O + 2 * c], slots[gen.G2_O + 2 * c + 1]) for c in range(3))
    return got, ref.g2_add(p, q) if name == "G2_ADD_FIN" else ref.g2_double(p)


@pytest.mark.parametrize("name", ["MUL12", "T_SQR", "T_LINE", "T_CYC", "T_FROB", "T_INV",
                                  "G2_HR", "G2_ADD_FIN", "G2_DBL"])
def test_program_tables_compute_the_oracles_operation(progs, name):
    """A Python run of each operation's stage table (its stage rules
    checked) against the host oracle; the cyclotomic squaring on an element
    of the cyclotomic subgroup, where it is the square; the G2 programs of
    the point sums on points of the subgroup."""
    if name.startswith("G2_"):
        got, want = _g2_program_values(progs, name)
        assert got == want
        return
    x, y = _rand_f12(), _rand_f12()
    if name == "T_CYC":  # f^((p^6 - 1)(p^2 + 1)), the easy part
        x = ref.f12_mul(ref.f12_conj(x), ref.f12_inv(x))
        x = ref.f12_mul(ref.f12_frob_n(x, 2), x)
    slots = gen.const_slots()
    slots.update(_slots_f12(gen.C_X, x))
    slots.update(_slots_f12(gen.C_Y, y))
    gen.simulate(progs[name], slots)
    z = (0, 0)
    line = (y[0], z, y[1], y[2], z, z)
    want = {
        "MUL12": ref.f12_mul(x, y), "T_SQR": ref.f12_sqr(x),
        "T_LINE": ref.f12_mul(x, line), "T_CYC": ref.f12_sqr(x),
        "T_FROB": ref.f12_frob(x), "T_INV": ref.f12_inv(x),
    }[name]
    assert _get_f12(slots, gen.C_Z) == want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_critical_paths_are_chip_smokes(progs):
    """chip_smoke.py's path constants are the stage programs' paths."""
    cs = _chip_smoke()
    assert progs["M_DBL"]["path"] == cs.FP_MILLER_DBL_PATH
    assert progs["M_ADD"]["path"] == cs.FP_MILLER_ADD_PATH
    assert progs["FE_EASY"]["path"] == cs.FP_EASY_PATH
    assert progs["FE_CYC"]["path"] == progs["FE_MULX"]["path"] == 1
    assert cs.FP_EXP_X_PATH == 64 * progs["FE_CYC"]["path"] + 6 * progs["FE_MULX"]["path"]
    assert cs.FP_GLUE_PATH == sum(progs[g]["path"] for g in
                                  ("FE_G1", "FE_G2", "FE_G3", "FE_G4", "FE_G5"))
    assert bin(ref.X_ABS).count("1") - 1 == cs.MILLER_ADDS
    assert (cs.FP_MILLER_THREAD, cs.FP_MILLER_PATH, cs.FP_FINAL_EXP,
            cs.FP_FINAL_EXP_PATH) == (13972, 332, 8765, 373)


# --- the harness --------------------------------------------------------------


@pytest.mark.parametrize("fault", [0, 1, 2, 3])
def test_harness_fails_lanes_out_of_lock_step(lib, fault):
    """The harness's checks: a clean stage passes; a lane with one extra
    sync, a lane reading a slot another lane writes in the same stage, and
    two lanes writing one slot each fail the run."""
    assert lib.tm_host_lockstep_selftest(fault) == (0 if fault == 0 else -1)


def test_fq_core_equals_fp_mul_limb_for_limb(lib):
    """fq (12 x 32-bit limbs) against the one-thread fp (6 x 64-bit) on
    edge and seeded operands: a any value below 2^384, b below p."""
    edges_a = [0, 1, P - 1, P - 2, R_MONT % P, R_MONT - 1, P, P + 1]
    edges_b = [0, 1, P - 1, P - 2, R_MONT % P]
    pairs = [(a, b) for a in edges_a for b in edges_b]
    pairs += [(_below(R_MONT), _below(P)) for _ in range(64)]
    a = np.stack([_b48(x) for x, _ in pairs])
    b = np.stack([_b48(y) for _, y in pairs])
    out = np.zeros((len(pairs), 12, 12), dtype=np.uint32)
    assert lib.tm_host_fq_ops(_ptr(a), _ptr(b), len(pairs), _ptr(out)) == 0
    for k, name in enumerate(("mul", "add", "sub", "load", "inv", "store")):
        assert np.array_equal(out[:, 2 * k], out[:, 2 * k + 1]), f"fq {name} != fp_{name}"
    rinv = pow(R_MONT, -1, P)
    for i, (x, y) in enumerate(pairs):
        assert _int(out[i, 1]) == x * y * rinv % P
        assert _int(out[i, 3]) == (x + y) % P
        assert _int(out[i, 5]) == (x - y) % P
        assert _int(out[i, 7]) == x * R_MONT % P
        assert _int(out[i, 9]) == (pow(y * rinv, P - 2, P) * R_MONT % P)
        assert _int(out[i, 11]) == y * rinv % P


F12_OPS = ["mul", "sqr", "mul_line", "cyclo_sqr", "frob", "inv"]


@pytest.fixture(scope="module")
def f12_results(lib):
    """The six operations by both sides on seeded elements, elements of
    special limbs (0, 1, p - 1, >= p; read mod p) and the zero element."""
    n_rand, n_special = 3, 3
    xs = [[_below(P) for _ in range(12)] for _ in range(n_rand)]
    xs += [[_limb() for _ in range(12)] for _ in range(n_special)]
    xs.append([0] * 12)
    ys = [[_below(P) for _ in range(12)] for _ in range(len(xs) - 1)] + [[_limb() for _ in range(12)]]
    x = np.stack([_f12(v) for v in xs])
    y = np.stack([_f12(v) for v in ys])
    out = np.zeros((len(xs), 2, 6, 144), dtype=np.uint32)
    assert lib.tm_host_f12_ops(_ptr(x), _ptr(y), len(xs), _ptr(out)) == 0, \
        "a warp run failed its lock-step or slot checks"
    return out


@pytest.mark.parametrize("op", F12_OPS)
def test_warp_f12_op_equals_one_thread(f12_results, op):
    k = F12_OPS.index(op)
    assert np.array_equal(f12_results[:, 0, k], f12_results[:, 1, k])


@pytest.mark.parametrize("with_add", [0, 1])
def test_miller_bit_program_equals_one_thread_steps(lib, with_add):
    """M_DBL / M_ADD against f12_sqr, each pair's miller_dbl_step (and
    miller_add_step) and f12_mul_line where the pair is valid, on states
    of arbitrary field elements (off every curve), under each validity."""
    n = 8
    state = np.stack([
        np.stack([_b48(_limb() if i % 2 else _below(P)) for _ in range(36)]).reshape(-1)
        for i in range(n)
    ])
    flags = np.array([i % 4 for i in range(n)], dtype=np.uint8)
    out = np.zeros((n, 2, 288), dtype=np.uint32)
    assert lib.tm_host_miller_bit(_ptr(state), _ptr(flags), n, with_add, _ptr(out)) == 0
    assert np.array_equal(out[:, 0], out[:, 1])


def _g1(k):
    return ref.g1_mul(ref.G1_GEN, k)


def _g2(k):
    return ref.g2_mul(ref.G2_GEN, k)


def _scalar() -> int:
    return _below(ref.R - 1) + 1


def _pair_shapes():
    s = _scalar()
    verify = [(_g1(s), ref.G2_GEN), (ref.g1_neg(ref.G1_GEN), _g2(s))]
    ks = [(_scalar(), _scalar()) for _ in range(8)]
    ten = [(_g1(a), _g2(b)) for a, b in ks]
    ten.insert(3, (ref.G1_INF, _g2(5)))  # the identity: dropped
    ten.append((_g1(-sum(a * b for a, b in ks) % ref.R), ref.G2_GEN))
    return {"verify": verify, "ten_pairs": ten}


PAIRS = _pair_shapes()


def _harness_miller(lib, chunks):
    arrs = [np.ascontiguousarray(t.numpy()) for t in chunks]
    c = arrs[0].shape[0]
    scratch = np.zeros((c, 144), dtype=np.uint32)
    out = np.zeros((6, 2, 48), dtype=np.uint8)
    assert lib.tm_host_miller(*(_ptr(a) for a in arrs), _ptr(scratch), _ptr(out), c) == 0, \
        "a warp run failed its lock-step or slot checks"
    return out


def _harness_final_exp(lib, f: np.ndarray) -> np.ndarray:
    f = np.ascontiguousarray(f)
    out = np.zeros_like(f)
    assert lib.tm_host_final_exp(_ptr(f), _ptr(out), f.shape[0]) == 0, \
        "a warp run failed its lock-step or slot checks"
    return out


@pytest.mark.parametrize("shape", sorted(PAIRS))
def test_harness_pairing_equals_plain_and_oracle(lib, shape):
    pairs = PAIRS[shape]
    chunks = bp.prepare_pairs(pairs, "cpu")
    assert chunks[0].shape[0] == {"verify": 1, "ten_pairs": 8}[shape]
    m = _harness_miller(lib, chunks)
    assert np.array_equal(m, bp.miller_plain(*chunks).numpy())
    fe = _harness_final_exp(lib, m[None])
    assert np.array_equal(fe, bp.final_exp_plain(torch.from_numpy(m[None])).numpy())
    assert bp.f12_to_host(torch.from_numpy(fe[0])) == ref.final_exponentiation(
        ref.miller_loop(pairs)) == ref.F12_ONE


def test_harness_pairing_value_equals_oracle(lib):
    p, q = _g1(_scalar()), _g2(_scalar())
    m = _harness_miller(lib, bp.prepare_pairs([(p, q)], "cpu"))
    fe = _harness_final_exp(lib, m[None])
    assert bp.f12_to_host(torch.from_numpy(fe[0])) == ref.pairing(p, q)


def _adversarial_chunks(valid, zero=()):
    n = len(valid)
    coords = [[0 if k in zero else _limb() for _ in range(12)] for k in range(n)]

    def t(vals, *shape):
        return torch.from_numpy(np.stack([_b48(v) for v in vals]).reshape(*shape, 48))

    return (t([v for c in coords for v in c[0:2]], n, 2),
            t([v for c in coords for v in c[2:4]], n, 2),
            t([v for c in coords for v in c[4:8]], n, 2, 2),
            t([v for c in coords for v in c[8:12]], n, 2, 2),
            torch.tensor(valid, dtype=torch.bool))


@pytest.mark.parametrize("case", ["mixed", "all_invalid"])
def test_harness_miller_on_adversarial_operands_equals_plain(lib, case):
    """Coordinates 0, 1, p - 1, >= p (read mod p), off every curve; a pair
    invalid, a chunk all invalid, a chunk of zeros."""
    chunks = {
        "mixed": _adversarial_chunks(
            [[True, True], [True, False], [False, False], [True, True]], zero=(3,)),
        "all_invalid": _adversarial_chunks([[False, False]]),
    }[case]
    assert np.array_equal(_harness_miller(lib, chunks), bp.miller_plain(*chunks).numpy())


def test_harness_final_exp_on_adversarial_elements(lib):
    """The zero element, one, limbs all p - 1 or 2^384 - 1, mixed special
    limbs, a random element: the warp final exponentiation, the one-thread
    final_exponentiation and the plain version agree byte for byte."""
    rows = [[0] * 12, [1] + [0] * 11, [P - 1] * 12, [R_MONT - 1] * 12,
            [_limb() for _ in range(12)], [_below(P) for _ in range(12)]]
    f = np.stack([_f12(r) for r in rows])
    got = _harness_final_exp(lib, f)
    one = np.zeros_like(f)
    assert lib.tm_host_final_exp_one_thread(_ptr(f), _ptr(one), f.shape[0]) == 0
    assert np.array_equal(got, one)
    assert np.array_equal(got, bp.final_exp_plain(torch.from_numpy(f)).numpy())
    assert not got[0].any()  # 0 maps to 0


@pytest.mark.slow
def test_harness_equals_jax_miller_and_final_exponentiation(lib):
    """Against the JAX package's device programs on the CPU backend:
    miller_jit with its chunk product (f12_mul_jit) and
    final_exponentiation, on the 10-pair shape's chunks."""
    import jax.numpy as jnp

    from tendermint_tpu.ops import bls_pairing as jbp

    pairs = PAIRS["ten_pairs"]
    m = _harness_miller(lib, bp.prepare_pairs(pairs, "cpu"))
    jf = jbp.miller_jit(*(jnp.asarray(a) for a in jbp._prepare_pairs(pairs)))
    while jf.shape[0] > 1:
        jf = jbp.f12_mul_jit(jf[0::2], jf[1::2])
    assert bp.f12_to_host(torch.from_numpy(m)) == jbp.f12_to_host(jf[0])
    fe = _harness_final_exp(lib, m[None])
    assert bp.f12_to_host(torch.from_numpy(fe[0])) == jbp.f12_to_host(
        jbp.final_exponentiation(jf)[0])
