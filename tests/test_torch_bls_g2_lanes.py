"""The warp-wide G2 point sums (``tm_g2_aggregate``, ``tm_g2_add``) on the CPU.

Each G2 addition of the public-key sums runs on one warp: ``g2_add_w`` of
``ops/csrc/bls12_381_device.cuh`` runs ``jac_add<fp2>`` as the stage
programs ``G2_HR`` and ``G2_ADD_FIN`` (or ``G2_DBL``) that
``ops/bls_warp_gen.py`` writes from the one-thread formulas, with the
one-thread branches between them; ``g2_tree_w`` is the tree kernel's body
and ``g2_add_bytes_w`` the pair kernel's. The host harness
``tests/bls_pairing_host.cpp`` (g++, the build of
``tests/test_torch_bls_pairing_lanes.py``) runs them with 32 host threads a
warp in lock-step and a barrier of all threads for the block's
``__syncthreads``; a run fails when a warp's lanes disagree on the count of
stages or a stage lets one lane read or overwrite a slot another lane
writes.

Held, exactly:
- the G2 programs through ``simulate`` against the host oracle's
  ``g2_add``/``g2_double`` (the same formulas, so the same Jacobian
  coordinates), in ``test_program_tables_compute_the_oracles_operation``;
- ``g2_add_w`` and ``g2_dbl_w`` against the one-thread ``jac_add<fp2>`` and
  ``jac_double<fp2>``, limb for limb, in every branch, and the pair
  kernel's bytes against ``jac_add<fp2>``'s and ``g2_add_plain``'s;
- the tree on one and on several warps against ``g2_aggregate_plain``, byte
  for byte, at 1, 2, 3 and 150 leaves, 256 adversarial leaves and a
  4-tree forest; the sums against the host oracle.

The JAX package's ``g2_add``/``g2_aggregate`` stay compared with the plain
versions in the slow-marked
``tests/test_torch_bls_ops.py::test_plain_versions_equal_jax_device_programs``.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls12_381 as ref
from tendermint_tpu_torch.ops import bls_g2

from .test_torch_bls_pairing_lanes import (  # noqa: F401 (fixtures)
    CSRC, P, R_MONT, RNG, _b48, _below, _chip_smoke, _int, _limb, _ptr, lib,
    one_thread, progs,
)


@pytest.fixture(scope="module")
def g2lib(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("tm_host_g2_ops", [vp, vp, i, vp, vp]),
        ("tm_host_g2_aggregate", [vp, i, i, i, i, vp]),
        ("tm_host_g2_selftest", [vp, vp, i]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _point_bytes(pt) -> np.ndarray:
    """Host Jacobian ((x0, x1), (y0, y1), (z0, z1)) of any integers below
    2^384 -> [3, 2, 48] uint8 (not reduced: the kernels read mod p)."""
    return np.stack([_b48(v) for c in pt for v in c]).reshape(3, 2, 48)


def _rescale(pt, lam):
    """The same point in another Jacobian representation: (x l^2, y l^3, z l)."""
    x, y, z = pt
    l2 = ref.f2_sqr(lam)
    return (ref.f2_mul(x, l2), ref.f2_mul(y, ref.f2_mul(l2, lam)), ref.f2_mul(z, lam))


def _f2() -> tuple:
    return (_below(P), _below(P))


def _rand_point():
    return ref.g2_mul(ref.G2_GEN, _below(ref.R - 1) + 1)


# points of the subgroup, z != 1; the rest are sums of them
BASE = [_rand_point() for _ in range(8)]
POINTS = BASE + [ref.g2_add(BASE[i], BASE[(i + 3) % 8]) for i in range(8)]


def _pair_cases():
    """(label, p, q) of every branch of jac_add."""
    inf = ((0, 0), (1, 0), (0, 0))
    cases = [(f"seeded {i}", POINTS[i], POINTS[-1 - i]) for i in range(6)]
    cases += [(f"off-curve {i}", (_f2(), _f2(), _f2()), (_f2(), _f2(), _f2()))
              for i in range(2)]
    cases += [(f"special limbs {i}",
               tuple((_limb(), _limb()) for _ in range(3)),
               tuple((_limb(), _limb()) for _ in range(3))) for i in range(4)]
    cases += [
        ("p at infinity", inf, POINTS[1]),
        ("q at infinity", POINTS[2], inf),
        ("p at infinity, other x y", (_f2(), _f2(), (0, 0)), POINTS[3]),
        ("q at infinity, z limbs p", POINTS[4], (_f2(), _f2(), (P, P))),
        ("both at infinity", inf, ((5, 0), (7, 1), (0, 0))),
        ("p = q", POINTS[5], POINTS[5]),
        ("p = q, two representations", POINTS[6], _rescale(POINTS[6], _f2())),
        ("p = q off the curve", *(lambda pt: (pt, _rescale(pt, _f2())))((_f2(), _f2(), _f2()))),
        ("p = -q", POINTS[7], ref.g2_neg(_rescale(POINTS[7], _f2()))),
        ("doubling with y = 0", *(lambda pt: (pt, _rescale(pt, _f2())))((_f2(), (0, 0), _f2()))),
        ("doubling with y limbs p", *(lambda pt: (pt, _rescale(pt, _f2())))(
            (_f2(), (P, 0), _f2()))),
    ]
    return cases


CASES = _pair_cases()


@pytest.fixture(scope="module")
def g2_results(g2lib):
    p = np.stack([_point_bytes(c[1]) for c in CASES])
    q = np.stack([_point_bytes(c[2]) for c in CASES])
    words = np.zeros((len(CASES), 4, 72), dtype=np.uint32)
    out = np.zeros((len(CASES), 2, 288), dtype=np.uint8)
    assert g2lib.tm_host_g2_ops(_ptr(p), _ptr(q), len(CASES), _ptr(words), _ptr(out)) == 0, \
        "a warp run failed its lock-step or slot checks"
    return p, q, words, out


@pytest.mark.parametrize("k", range(len(CASES)), ids=[c[0] for c in CASES])
def test_warp_g2_add_equals_one_thread_jac_add(g2_results, k):
    """g2_add_w against jac_add<fp2> limb for limb, and g2_add_bytes_w (the
    pair kernel's body) against its canonical bytes and g2_add_plain."""
    p, q, words, out = g2_results
    assert np.array_equal(words[k, 0], words[k, 1]), "g2_add_w != jac_add<fp2>"
    assert np.array_equal(out[k, 0], out[k, 1]), "g2_add_bytes_w != jac_add<fp2>"
    plain = bls_g2.g2_add_plain(torch.from_numpy(p[k:k + 1]), torch.from_numpy(q[k:k + 1]))
    assert np.array_equal(out[k, 1], plain.numpy().reshape(288)), "!= g2_add_plain"


@pytest.mark.parametrize("k", range(len(CASES)), ids=[c[0] for c in CASES])
def test_warp_g2_dbl_equals_one_thread_jac_double(g2_results, k):
    """g2_dbl_w of p against jac_double<fp2> limb for limb (the identity
    where y or z is zero)."""
    _, _, words, _ = g2_results
    assert np.array_equal(words[k, 2], words[k, 3])


def _sum_words(words_row):
    """72 Montgomery words -> host Jacobian point (plain integers)."""
    rinv = pow(R_MONT, -1, P)
    v = [_int(words_row[12 * i:12 * i + 12]) * rinv % P for i in range(6)]
    return ((v[0], v[1]), (v[2], v[3]), (v[4], v[5]))


def test_warp_g2_add_branches_equal_the_oracle(g2_results):
    """On the subgroup's points the warp's sums are the host oracle's: the
    same Jacobian coordinates where no branch is taken (the same
    formulas), the same point in every branch."""
    _, _, words, _ = g2_results
    for k, (label, p, q) in enumerate(CASES):
        if not (label.startswith("seeded") or label in (
                "p = q", "p = q, two representations", "p = -q", "p at infinity",
                "q at infinity")):
            continue
        got, want = _sum_words(words[k, 1]), ref.g2_add(p, q)
        if label.startswith("seeded"):
            assert got == want, label
        assert ref.g2_eq(got, want), label
    assert _sum_words(words[[c[0] for c in CASES].index("p = -q"), 1]) == (
        (0, 0), (1, 0), (0, 0))


@pytest.mark.parametrize("fault", [0, 1, 2, 3])
def test_harness_fails_g2_lanes_out_of_lock_step(g2lib, fault):
    """The harness's checks on a G2 program run (p = q, the doubling
    branch): clean it passes; a lane with one extra sync, a lane that
    takes the other branch (G2_ADD_FIN where the warp runs G2_DBL), and a
    lane writing h where every lane reads it each fail the run."""
    pt = POINTS[0]
    p, q = _point_bytes(pt), _point_bytes(_rescale(pt, _f2()))
    assert g2lib.tm_host_g2_selftest(_ptr(p), _ptr(q), fault) == (0 if fault == 0 else -1)


def _tree_points(case: str) -> list:
    if case == "adversarial_256":
        pts = list(POINTS) * 8 + [_rescale(p, _f2()) for p in POINTS] * 4
        pts += [ref.g2_neg(p) for p in POINTS] * 2
        pts += [ref.g2_neg(_rescale(p, _f2())) for p in POINTS]
        pts += [((0, 0), (1, 0), (0, 0))] * 8 + [ref.G2_INF] * 8
        assert len(pts) == 256
        order = RNG.permutation(256)
        return [pts[i] for i in order]
    n = int(case.split("_")[1])
    return [POINTS[i % len(POINTS)] if i < len(POINTS) else
            ref.g2_add(POINTS[i % len(POINTS)], POINTS[(i * 5 + 1) % len(POINTS)])
            for i in range(n)]


def _harness_tree(g2lib, trees: np.ndarray, nwarps: int) -> np.ndarray:
    """[T, B, 3, 2, 48] -> [T, 3, 2, 48] through g2_tree_w."""
    t, b = trees.shape[:2]
    nb = 1 << max(1, (b - 1).bit_length())
    trees = np.ascontiguousarray(trees)
    out = np.zeros((t, 3, 2, 48), dtype=np.uint8)
    assert g2lib.tm_host_g2_aggregate(_ptr(trees), t, b, nb, nwarps, _ptr(out)) == 0, \
        "a warp run failed its lock-step or slot checks"
    return out


@pytest.mark.parametrize("case,nwarps", [
    ("leaves_1", 1), ("leaves_2", 1), ("leaves_3", 1), ("leaves_3", 3),
    ("leaves_150", 1), ("leaves_150", 3), ("adversarial_256", 1), ("adversarial_256", 16),
])
def test_harness_tree_equals_plain_and_oracle(g2lib, case, nwarps):
    """The tree kernel's body on nwarps warps against g2_aggregate_plain
    byte for byte, and the host oracle's sum: the JAX package's pairing of
    neighbours, identity padding, duplicates (the doubling branch),
    opposites and identities among the leaves."""
    pts = _tree_points(case)
    leaves = np.stack([_point_bytes(p) for p in pts])[None]
    got = _harness_tree(g2lib, leaves, nwarps)
    plain = bls_g2.g2_aggregate_plain(torch.from_numpy(leaves)).numpy()
    assert np.array_equal(got, plain)
    want = ref.G2_INF
    for p in pts:
        want = ref.g2_add(want, p)
    assert ref.g2_eq(bls_g2.g2_to_host(torch.from_numpy(got[0])), want)


def test_harness_forest_equals_plain(g2lib):
    """Four trees of 23 leaves in one call (the forest launch's layout, each
    tree on its own block of 3 warps) against the plain version's
    ``[T, B, ...]`` sum."""
    pts = _tree_points("leaves_150")
    trees = np.stack([np.stack([_point_bytes(p) for p in pts[23 * t:23 * t + 23]])
                      for t in range(4)])
    got = _harness_tree(g2lib, trees, 3)
    assert np.array_equal(got, bls_g2.g2_aggregate_plain(torch.from_numpy(trees)).numpy())


def test_g2_critical_paths_and_warps_are_chip_smokes(progs):
    """chip_smoke.py's G2 constants are the programs' paths and the tree
    kernel's warps."""
    cs = _chip_smoke()
    assert progs["G2_HR"]["path"] + progs["G2_ADD_FIN"]["path"] == cs.FP_G2_ADD_PATH == 5
    assert progs["G2_DBL"]["path"] == cs.FP_G2_DBL_PATH == 3
    assert sum(progs[n]["muls"] for n in ("G2_HR", "G2_ADD_FIN")) == cs.FP_G2_ADD == 43
    assert progs["G2_DBL"]["muls"] == 16
    src = (CSRC / "bls_kernels.cu").read_text()
    assert int(re.search(r"kG2TreeWarps = (\d+);", src).group(1)) == cs.G2_TREE_WARPS
    assert (cs.FP_G2_ADD_THREAD, cs.FP_G2_ADD_KERNEL_PATH) == (61, 7)
    assert cs.g2_tree_paths(150) == (362, 43)
