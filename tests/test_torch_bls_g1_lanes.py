"""The G1 point sums on lane groups (``tm_g1_aggregate``, ``tm_g1_add``) on the CPU.

Each G1 addition of the signature sums runs on a group of G lanes of a
warp (G = 4 or 8, several groups a warp): ``g1_add_g`` of
``ops/csrc/bls12_381_device.cuh`` runs ``jac_add<fp>`` as the stage
programs ``G1_HR`` and ``G1_ADD_FIN`` (or ``G1_DBL``) that
``ops/bls_warp_gen.py`` writes from the one-thread formulas, with the
one-thread branches between them; ``g1_tree_g`` is the tree kernel's body
and ``g1_add_bytes_g`` the pair kernel's. The host harness
``tests/bls_pairing_host.cpp`` (g++, the build of
``tests/test_torch_bls_pairing_lanes.py``) runs them with G host threads a
group in lock-step, each group over its own slots, and a barrier of all
threads for the block's ``__syncthreads``; a run fails when a group's lanes
disagree on the count of stages, a lane syncs with another mask than its
group's lanes, touches a slot outside its group's region, or a stage lets
one lane read or overwrite a slot another lane writes.

Held, exactly:
- the G1 programs through ``simulate`` against the host oracle's
  ``g1_add``/``g1_double`` (the same formulas, so the same Jacobian
  coordinates);
- ``g1_add_g`` and ``g1_dbl_g`` against the one-thread ``jac_add<fp>`` and
  ``jac_double<fp>``, limb for limb, in every branch, the groups of one
  warp on different branches at once, and the pair kernel's bytes against
  ``jac_add<fp>``'s and ``g1_add_plain``'s;
- the tree on 1, 3 and 16 warps of groups against ``g1_aggregate_plain``
  byte for byte and the host oracle's sum, at 1, 2, 3, 150 and 256
  adversarial leaves and a 4-tree forest; on 4-leaf trees also against the
  JAX package's ``g1_aggregate`` (``tendermint_tpu/ops/bls_g1.py:309``) on
  the CPU backend, run op by op (each of its level shapes would compile
  for tens of seconds under ``jit``);
- the regenerated header's pairing and G2 tables against their pinned
  digest, and ``chip_smoke.py``'s G1 constants against the programs.
"""

import ctypes
import hashlib
import re

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls12_381 as ref
from tendermint_tpu_torch.ops import bls_g1
from tendermint_tpu_torch.ops import bls_warp_gen as gen

from .test_torch_bls_pairing_lanes import (  # noqa: F401 (fixtures)
    CSRC, P, R_MONT, RNG, _b48, _below, _chip_smoke, _int, _limb, _ptr, lib,
    one_thread, progs,
)

LANES = (4, 8)


@pytest.fixture(scope="module")
def g1lib(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("tm_host_g1_ops", [vp, vp, i, i, vp, vp]),
        ("tm_host_g1_aggregate", [vp, i, i, i, i, i, vp]),
        ("tm_host_g1_selftest", [vp, vp, i, i]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _point_bytes(pt) -> np.ndarray:
    """Host Jacobian (x, y, z) of any integers below 2^384 -> [3, 48]
    uint8 (not reduced: the kernels read mod p)."""
    return np.stack([_b48(v) for v in pt])


def _rescale(pt, lam):
    """The same point in another Jacobian representation: (x l^2, y l^3, z l)."""
    x, y, z = pt
    return (x * lam * lam % P, y * pow(lam, 3, P) % P, z * lam % P)


def _rand_point():
    return ref.g1_mul(ref.G1_GEN, _below(ref.R - 1) + 1)


# points of the subgroup, z != 1; the rest are sums of them
BASE = [_rand_point() for _ in range(8)]
POINTS = BASE + [ref.g1_add(BASE[i], BASE[(i + 3) % 8]) for i in range(8)]


def _pair_cases():
    """(label, p, q) of every branch of jac_add."""
    inf = (0, 1, 0)
    fp = lambda: _below(P)  # noqa: E731
    on = lambda pt: (pt, _rescale(pt, fp()))  # noqa: E731
    cases = [(f"seeded {i}", POINTS[i], POINTS[-1 - i]) for i in range(6)]
    cases += [(f"off-curve {i}", (fp(), fp(), fp()), (fp(), fp(), fp())) for i in range(2)]
    cases += [(f"special limbs {i}", (_limb(), _limb(), _limb()), (_limb(), _limb(), _limb()))
              for i in range(4)]
    cases += [
        ("p at infinity", inf, POINTS[1]),
        ("q at infinity", POINTS[2], inf),
        ("p at infinity, other x y", (fp(), fp(), 0), POINTS[3]),
        ("q at infinity, z limbs p", POINTS[4], (fp(), fp(), P)),
        ("both at infinity", inf, (5, 7, 0)),
        ("p = q", POINTS[5], POINTS[5]),
        ("p = q, two representations", *on(POINTS[6])),
        ("p = q off the curve", *on((fp(), fp(), fp()))),
        ("p = -q", POINTS[7], ref.g1_neg(_rescale(POINTS[7], fp()))),
        ("doubling with y = 0", *on((fp(), 0, fp()))),
        ("doubling with y limbs p", *on((fp(), P, fp()))),
    ]
    return cases


CASES = _pair_cases()
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def g1_results(g1lib):
    """{lanes: (p, q, words, bytes)}: every case on its own group, all the
    groups in one run."""
    p = np.stack([_point_bytes(c[1]) for c in CASES])
    q = np.stack([_point_bytes(c[2]) for c in CASES])
    out = {}
    for lanes in LANES:
        words = np.zeros((len(CASES), 4, 36), dtype=np.uint32)
        got = np.zeros((len(CASES), 2, 144), dtype=np.uint8)
        assert g1lib.tm_host_g1_ops(_ptr(p), _ptr(q), len(CASES), lanes, _ptr(words),
                                    _ptr(got)) == 0, \
            "a lane group failed its lock-step, mask, region or slot checks"
        out[lanes] = (p, q, words, got)
    return out


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("k", range(len(CASES)), ids=LABELS)
def test_group_g1_add_equals_one_thread_jac_add(g1_results, k, lanes):
    """g1_add_g against jac_add<fp> limb for limb, and g1_add_bytes_g (the
    pair kernel's body) against its canonical bytes and g1_add_plain."""
    p, q, words, out = g1_results[lanes]
    assert np.array_equal(words[k, 0], words[k, 1]), "g1_add_g != jac_add<fp>"
    assert np.array_equal(out[k, 0], out[k, 1]), "g1_add_bytes_g != jac_add<fp>"
    plain = bls_g1.g1_add_plain(torch.from_numpy(p[k:k + 1]), torch.from_numpy(q[k:k + 1]))
    assert np.array_equal(out[k, 1], plain.numpy().reshape(144)), "!= g1_add_plain"


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("k", range(len(CASES)), ids=LABELS)
def test_group_g1_dbl_equals_one_thread_jac_double(g1_results, k, lanes):
    """g1_dbl_g of p against jac_double<fp> limb for limb (the identity
    where y or z is zero)."""
    words = g1_results[lanes][2]
    assert np.array_equal(words[k, 2], words[k, 3])


def _sum_words(row):
    """36 Montgomery words -> host Jacobian point (plain integers)."""
    rinv = pow(R_MONT, -1, P)
    return tuple(_int(row[12 * i:12 * i + 12]) * rinv % P for i in range(3))


@pytest.mark.parametrize("lanes", LANES)
def test_group_g1_add_branches_equal_the_oracle(g1_results, lanes):
    """On the subgroup's points the groups' sums are the host oracle's: the
    same Jacobian coordinates where no branch is taken (the same
    formulas), the same point in every branch."""
    words = g1_results[lanes][2]
    for k, (label, p, q) in enumerate(CASES):
        if not (label.startswith("seeded") or label in (
                "p = q", "p = q, two representations", "p = -q", "p at infinity",
                "q at infinity")):
            continue
        got, want = _sum_words(words[k, 1]), ref.g1_add(p, q)
        if label.startswith("seeded"):
            assert got == want, label
        assert ref.g1_eq(got, want), label
    assert _sum_words(words[LABELS.index("p = -q"), 1]) == (0, 1, 0)


def _g1_program_values(progs, name):
    """(got, want) of a G1 program's simulate run on two points of the
    subgroup, as the G2 programs' test does."""
    p, q = _rand_point(), _rand_point()
    slots = gen.const_slots()
    for base, pt in ((gen.G1_P, p), (gen.G1_Q, q)):
        slots.update({base + c: pt[c] for c in range(3)})
    for prog in {"G1_HR": ["G1_HR"], "G1_ADD_FIN": ["G1_HR", "G1_ADD_FIN"],
                 "G1_DBL": ["G1_DBL"]}[name]:
        gen.simulate(progs[prog], slots)
    if name == "G1_HR":
        (x1, y1, z1), (x2, y2, z2) = p, q
        z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
        u1, s1 = x1 * z2z2 % P, y1 * z2 * z2z2 % P
        h, r = (x2 * z1z1 - u1) % P, (y2 * z1 * z1z1 - s1) % P
        bases = (gen.G1_Z1Z1, gen.G1_Z2Z2, gen.G1_U1, gen.G1_S1, gen.G1_H, gen.G1_R)
        return [slots[b] for b in bases], [z1z1, z2z2, u1, s1, h, r]
    got = tuple(slots[gen.G1_O + c] for c in range(3))
    return got, ref.g1_add(p, q) if name == "G1_ADD_FIN" else ref.g1_double(p)


@pytest.mark.parametrize("name", ["G1_HR", "G1_ADD_FIN", "G1_DBL"])
def test_g1_program_tables_compute_the_oracles_operation(progs, name):
    """A Python run of each G1 stage table (its stage rules checked) on
    points of the subgroup against the host oracle; each stage holds at
    most G1_JOBS_PER_STAGE jobs, and reads no constant but zero and one."""
    got, want = _g1_program_values(progs, name)
    assert got == want
    prog = progs[name]
    assert all(len(js) <= gen.G1_JOBS_PER_STAGE for _, js in prog["stages"])
    srcs = {(w >> sh) & 1023 for _, js in prog["stages"] for w in js for sh in (12, 22)}
    assert not srcs & set(range(2, gen.G1_P)), "a constant other than 0 and 1"


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("fault", [0, 1, 2, 3, 4])
def test_harness_fails_g1_groups_out_of_lock_step(g1lib, fault, lanes):
    """The harness's checks on a G1 group run (p = q, the doubling branch,
    on two groups of one warp): clean it passes; a lane with one extra
    sync, a lane reading the neighbour group's slot, a lane syncing with
    the whole warp's mask, and a lane writing h where every lane reads it
    each fail the run."""
    pt = POINTS[0]
    p, q = _point_bytes(pt), _point_bytes(_rescale(pt, _below(P)))
    assert g1lib.tm_host_g1_selftest(_ptr(p), _ptr(q), lanes, fault) == (
        0 if fault == 0 else -1)


def _tree_points(case: str) -> list:
    if case == "adversarial_256":
        pts = list(POINTS) * 8 + [_rescale(p, _below(P)) for p in POINTS] * 4
        pts += [ref.g1_neg(p) for p in POINTS] * 2
        pts += [ref.g1_neg(_rescale(p, _below(P))) for p in POINTS]
        pts += [(0, 1, 0)] * 8 + [ref.G1_INF] * 8
        assert len(pts) == 256
        order = RNG.permutation(256)
        return [pts[i] for i in order]
    n = int(case.split("_")[1])
    return [POINTS[i % len(POINTS)] if i < len(POINTS) else
            ref.g1_add(POINTS[i % len(POINTS)], POINTS[(i * 5 + 1) % len(POINTS)])
            for i in range(n)]


def _harness_tree(g1lib, trees: np.ndarray, nwarps: int, lanes: int) -> np.ndarray:
    """[T, B, 3, 48] -> [T, 3, 48] through g1_tree_g."""
    t, b = trees.shape[:2]
    nb = 1 << max(1, (b - 1).bit_length())
    trees = np.ascontiguousarray(trees)
    out = np.zeros((t, 3, 48), dtype=np.uint8)
    assert g1lib.tm_host_g1_aggregate(_ptr(trees), t, b, nb, nwarps, lanes, _ptr(out)) == 0, \
        "a lane group failed its lock-step, mask, region or slot checks"
    return out


def _host_sum(pts):
    want = ref.G1_INF
    for p in pts:
        want = ref.g1_add(want, p)
    return want


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("case,nwarps", [
    ("leaves_1", 1), ("leaves_2", 1), ("leaves_3", 3), ("leaves_150", 1),
    ("leaves_150", 3), ("leaves_150", 16), ("adversarial_256", 1), ("adversarial_256", 16),
])
def test_harness_tree_equals_plain_and_oracle(g1lib, case, nwarps, lanes):
    """The tree kernel's body on nwarps warps of groups against
    g1_aggregate_plain byte for byte, and the host oracle's sum: the JAX
    package's pairing of neighbours, identity padding, duplicates (the
    doubling branch), opposites and identities among the leaves."""
    pts = _tree_points(case)
    leaves = np.stack([_point_bytes(p) for p in pts])[None]
    got = _harness_tree(g1lib, leaves, nwarps, lanes)
    plain = bls_g1.g1_aggregate_plain(torch.from_numpy(leaves)).numpy()
    assert np.array_equal(got, plain)
    assert ref.g1_eq(bls_g1.g1_to_host(torch.from_numpy(got[0])), _host_sum(pts))


@pytest.mark.parametrize("lanes", LANES)
def test_harness_forest_equals_plain(g1lib, lanes):
    """Four trees of 23 leaves in one call (the forest launch's layout, each
    tree on its own block of 3 warps) against the plain version's
    ``[T, B, ...]`` sum."""
    pts = _tree_points("leaves_150")
    trees = np.stack([np.stack([_point_bytes(p) for p in pts[23 * t:23 * t + 23]])
                      for t in range(4)])
    got = _harness_tree(g1lib, trees, 3, lanes)
    assert np.array_equal(got, bls_g1.g1_aggregate_plain(torch.from_numpy(trees)).numpy())


# 4-leaf trees for the JAX package: a sum and a doubling, then a sum; an
# opposite pair and the identity, then two infinities' branches
JAX_TREES = {
    "sum_and_double": [POINTS[0], POINTS[1], POINTS[2], POINTS[2]],
    "opposite_and_identity": [POINTS[3], ref.g1_neg(POINTS[3]), ref.G1_INF, POINTS[4]],
}


def test_harness_tree_equals_the_jax_packages_g1_aggregate(g1lib):
    """The tree body at both group widths on 4-leaf trees against the JAX
    package's g1_aggregate on the CPU backend, as affine points and as the
    same canonical Jacobian coordinates."""
    import jax
    import jax.numpy as jnp

    from tendermint_tpu.ops import bls_g1 as jg1

    for name, pts in JAX_TREES.items():
        with jax.disable_jit():
            want = jg1.g1_to_host(jg1.g1_aggregate(
                jnp.asarray(np.stack([jg1.g1_from_host(p) for p in pts]))))
        leaves = np.stack([_point_bytes(p) for p in pts])[None]
        for lanes in LANES:
            for nwarps in (1, 16):
                got = bls_g1.g1_to_host(torch.from_numpy(
                    _harness_tree(g1lib, leaves, nwarps, lanes)[0]))
                assert got == want, (name, lanes, nwarps)
                assert ref.g1_to_affine(got) == ref.g1_to_affine(want)
        assert ref.g1_eq(want, _host_sum(pts)), name


# sha256 of the pairing and G2 tables of bls12_381_programs.cuh (every
# `constexpr int` of the header not named G1_*, the constant table, and each
# of those programs' stage words and jobs) as the header stood before the G1
# programs were added
PAIRING_G2_TABLES_SHA256 = "13eb5e6e9d391fcad8a68c55b96914bef5444542a027ea16b8f72527eac724c7"


def _pairing_and_g2_digest(text: str) -> str:
    arrays = {n: [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body)]
              for n, body in re.findall(
                  r"(CONSTS|STAGES|JOBS)\[[^\]]*\](?:\[12\])? = \{(.*?)\};", text, re.S)}
    consts = [(n, int(v)) for line in re.findall(r"^constexpr int (.*);", text, re.M)
              for n, v in re.findall(r"(\w+) = (\d+)", line) if not n.startswith("G1_")]
    h = hashlib.sha256(repr(consts).encode())
    h.update(np.array(arrays["CONSTS"], dtype=np.uint32).tobytes())
    for name, v in consts:
        if name.endswith("_FIRST"):
            st = arrays["STAGES"][v:v + dict(consts)[name[:-6] + "_N"]]
            jobs = [w for s in st for w in arrays["JOBS"][s >> 9:(s >> 9) + ((s >> 2) & 127)]]
            h.update(np.array(st + jobs, dtype=np.uint32).tobytes())
    return h.hexdigest()


def test_regenerated_header_keeps_pairing_and_g2_tables():
    """Regenerating bls12_381_programs.cuh with the G1 programs leaves every
    pairing and G2 table, slot constant and program index byte-identical,
    and the G1 programs follow them in the tables."""
    text = gen.generate()
    assert _pairing_and_g2_digest(text) == PAIRING_G2_TABLES_SHA256
    firsts = dict(re.findall(r"constexpr int (\w+)_FIRST = (\d+)", text))
    g1_first = min(int(v) for n, v in firsts.items() if n.startswith("G1_"))
    assert all(int(v) < g1_first for n, v in firsts.items() if not n.startswith("G1_"))


def test_g1_critical_paths_and_groups_are_chip_smokes(progs):
    """chip_smoke.py's G1 constants are the programs' paths and the
    kernels' group width and warps."""
    cs = _chip_smoke()
    assert progs["G1_HR"]["path"] + progs["G1_ADD_FIN"]["path"] == cs.FP_G1_ADD_PATH == 5
    assert progs["G1_DBL"]["path"] == cs.FP_G1_DBL_PATH == 3
    assert sum(progs[n]["muls"] for n in ("G1_HR", "G1_ADD_FIN")) == cs.FP_G1_ADD == 16
    assert progs["G1_DBL"]["muls"] == 7
    src = (CSRC / "bls_kernels.cu").read_text()
    for name, value in (("kG1TreeLanes", cs.G1_TREE_LANES), ("kG1AddLanes", cs.G1_ADD_LANES),
                        ("kG1TreeWarps", cs.G1_TREE_WARPS)):
        assert int(re.search(name + r" = (\d+);", src).group(1)) == value, name
    assert {cs.G1_TREE_LANES, cs.G1_ADD_LANES} <= set(LANES)
    assert (cs.FP_G1_ADD_THREAD, cs.FP_G1_ADD_KERNEL_PATH) == (25, 7)
    assert cs.g1_tree_paths(150) == (137, 42)
