"""The port's BLS12-381 plain versions against the JAX package.

``ops/bls_g1.g1_aggregate``, ``ops/bls_g2.g2_aggregate`` and
``ops/bls_pairing`` (Miller loop, final exponentiation, ``pairing_value``,
``check_pairs``) run here on CPU tensors, i.e. their plain PyTorch versions,
on the same seeded inputs as the JAX package's host oracle
``tendermint_tpu/crypto/bls12_381.py`` (the reference its device programs
are pinned to). The slow-marked test holds them against the jitted JAX
programs ``tendermint_tpu/ops/bls_{g1,g2,pairing}.py`` themselves, which
compile for minutes on the CPU. Also: ``crypto/convert.py`` carries the
JAX package's radix-2^8 arrays into the port's tensors. Tolerance: exact
(integers mod p).
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls12_381 as ref
from tendermint_tpu_torch import ops
from tendermint_tpu_torch.crypto import convert
from tendermint_tpu_torch.ops import bls_field as fp
from tendermint_tpu_torch.ops import bls_g1, bls_g2
from tendermint_tpu_torch.ops import bls_pairing as bp

RNG = np.random.default_rng(20261016)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are thousands of small tensor operations: one
    intra-op thread keeps them from contending with other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scalar() -> int:
    return int.from_bytes(RNG.bytes(32), "big") % (ref.R - 1) + 1


G1S = [ref.g1_mul(ref.G1_GEN, _scalar()) for _ in range(6)]
G2S = [ref.g2_mul(ref.G2_GEN, _scalar()) for _ in range(5)]


def _host_sum(add, inf, pts):
    acc = inf
    for p in pts:
        acc = add(acc, p)
    return acc


G1_CASES = {
    "odd": G1S[:5],
    "duplicate": [G1S[0], G1S[1], G1S[0]],
    "double_only": [G1S[2], G1S[2]],
    "opposite": [G1S[3], ref.g1_neg(G1S[3]), G1S[4]],
    "cancel_all": [G1S[3], ref.g1_neg(G1S[3])],
    "identity_leaves": [ref.G1_INF, G1S[0], (0, 1, 0), G1S[5]],
    "single": [G1S[1]],
}


@pytest.mark.parametrize("case", sorted(G1_CASES))
def test_g1_aggregate_plain_equals_oracle(case):
    pts = G1_CASES[case]
    got = bls_g1.g1_aggregate(torch.stack([bls_g1.g1_from_host(p) for p in pts]))
    assert got.dtype == torch.uint8 and got.shape == (3, 48)
    assert ref.g1_eq(bls_g1.g1_to_host(got), _host_sum(ref.g1_add, ref.G1_INF, pts))


G2_CASES = {
    "odd": G2S[:5],
    "duplicate_opposite": [G2S[0], G2S[1], G2S[0], ref.g2_neg(G2S[1]), ref.G2_INF],
}


@pytest.mark.parametrize("case", sorted(G2_CASES))
def test_g2_aggregate_plain_equals_oracle(case):
    pts = G2_CASES[case]
    got = bls_g2.g2_aggregate(torch.stack([bls_g2.g2_from_host(p) for p in pts]))
    assert got.shape == (3, 2, 48)
    assert ref.g2_eq(bls_g2.g2_to_host(got), _host_sum(ref.g2_add, ref.G2_INF, pts))


def test_aggregate_trees_stack_and_wrappers_take_plain_on_cpu():
    """Leading dims are independent trees: one call sums each exactly as
    its own call does; a CPU tensor never launches."""
    ops.reset_launches()
    trees = [G1S[:4], [G1S[4], G1S[4], ref.G1_INF, G1S[0]]]
    stacked = torch.stack(
        [torch.stack([bls_g1.g1_from_host(p) for p in t]) for t in trees]
    )
    both = bls_g1.g1_aggregate(stacked)
    for k in range(2):
        assert torch.equal(both[k], bls_g1.g1_aggregate(stacked[k]))
    assert not any(ops.kernel_launches().values())


def test_field_mul_bounds_worst_case():
    """mul's documented input bound (limbs < 2^26, weight 128) holds
    exactly, and norm reduces long lazy sums."""
    big = torch.full((3, fp.NLIMBS), (1 << 26) - 1, dtype=torch.int64)
    big[1] *= -1
    big[2, ::2] *= -1
    vals = [sum(v << (16 * i) for i, v in enumerate(r)) for r in big.tolist()]
    got = fp.mul(big, big.flip(0))
    assert fp.to_ints(got) == [a * b % fp.P for a, b in zip(vals, vals[::-1])]
    assert int(got.abs().max()) < 1 << 19
    assert fp.to_ints(fp.norm(big * 4096)) == [4096 * v % fp.P for v in vals]


PAIRS = [(ref.g1_mul(ref.G1_GEN, _scalar()), ref.g2_mul(ref.G2_GEN, _scalar()))
         for _ in range(3)]


def test_pairing_value_equals_oracle():
    p, q = PAIRS[0]
    assert bp.pairing_value([(p, q)], "cpu") == ref.pairing(p, q)


@pytest.mark.parametrize(
    "case",
    ["cancel", "mismatch", "infinity_pairs", "empty", "all_infinity", "three_chunks"],
)
def test_check_pairs_matches_multi_pairing_is_one(case):
    (p0, q0), (p1, q1), (p2, q2) = PAIRS
    pairs = {
        "cancel": [(p0, q0), (ref.g1_neg(p0), q0)],
        "mismatch": [(p0, q0), (ref.g1_neg(p1), q0)],
        "infinity_pairs": [(p0, q0), (ref.G1_INF, q1), (ref.g1_neg(p0), q0),
                           (p1, ref.G2_INF)],
        "empty": [],
        "all_infinity": [(ref.G1_INF, q0)],
        # 5 pairs: 3 chunks padded to 4, one product over chunks
        "three_chunks": [(p0, q0), (p1, q1), (p2, q2), (ref.g1_neg(p1), q1),
                         (ref.g1_neg(p0), q0)],
    }[case]
    assert bp.check_pairs(pairs, "cpu") == ref.multi_pairing_is_one(pairs)


def test_miller_and_final_exp_plain_match_oracle_stages():
    """The two kernel boundaries: the port's Miller value through the
    port's final exponentiation is the oracle's pairing product, and so
    is the oracle's own Miller value through it."""
    pairs = PAIRS[:3]
    chunks = bp.prepare_pairs(pairs, "cpu")
    assert chunks[0].shape == (2, bp.NPAIRS, 48) and chunks[4].tolist() == [
        [True, True], [True, False]]
    f = bp.miller(*chunks)
    fe = bp.final_exp(f.unsqueeze(0))[0]
    assert bp.f12_to_host(fe) == ref.final_exponentiation(ref.miller_loop(pairs))
    # the Miller values differ from the oracle's by an Fp2 scale, which the
    # final exponentiation removes: the oracle's own Miller value through
    # the port's final exponentiation gives the same result
    mref = torch.stack([torch.stack([
        torch.tensor(list(v.to_bytes(48, "little")), dtype=torch.uint8)
        for v in c]) for c in ref.miller_loop(pairs)])
    assert torch.equal(bp.final_exp(mref.unsqueeze(0))[0], fe)


def test_convert_round_trips_from_jax_limbs():
    from tendermint_tpu.ops import bls_g1 as jg1
    from tendermint_tpu.ops import bls_g2 as jg2
    from tendermint_tpu.ops import bls_pairing as jbp

    g1 = np.stack([jg1.g1_from_host(p) for p in G1S[:3]])  # [3, 3, 48]
    got = convert.bls_from_jax(g1)
    want = torch.stack([bls_g1.g1_from_host(p) for p in G1S[:3]])
    assert torch.equal(got, want)
    assert np.array_equal(convert.bls_to_jax(got), g1)
    g2 = np.stack([jg2.g2_from_host(p) for p in G2S[:2]])  # [2, 3, 2, 48]
    assert torch.equal(
        convert.bls_from_jax(g2), torch.stack([bls_g2.g2_from_host(p) for p in G2S[:2]])
    )
    # loose limbs (a limb above 255, the value p + 5) read mod p
    loose = np.zeros((1, 48), dtype=np.int32)
    loose[0] = jg1.from_int(5)
    loose[0] += jg1.P_LIMBS
    loose[0, 0] += 256
    loose[0, 1] -= 1
    assert fp.to_ints(fp.from_bytes(convert.bls_from_jax(loose))) == [5]
    # the JAX package's pairing chunks are the port's chunks
    jchunks = jbp._prepare_pairs(PAIRS[:3])
    for a, b in zip(convert.bls_chunks_from_jax(*jchunks), bp.prepare_pairs(PAIRS[:3], "cpu")):
        assert torch.equal(a, b)


@pytest.mark.slow
@pytest.mark.parametrize("program", ["g1_aggregate", "g2_aggregate", "pairing"])
def test_plain_versions_equal_jax_device_programs(program):
    """The plain versions against the JAX device programs themselves
    (jitted on the CPU backend; the pairing's stages compile for tens of
    minutes). Two leaves make one tree level, so each aggregate compiles
    one addition and runs it on a sum, a doubling and a cancellation."""
    import jax.numpy as jnp

    from tendermint_tpu.ops import bls_g1 as jg1
    from tendermint_tpu.ops import bls_g2 as jg2
    from tendermint_tpu.ops import bls_pairing as jbp

    if program == "pairing":
        assert bp.pairing_value(PAIRS[:1], "cpu") == jbp.pairing_value(PAIRS[:1])
        return
    jmod, pmod, pts = {
        "g1_aggregate": (jg1, bls_g1, G1S),
        "g2_aggregate": (jg2, bls_g2, G2S),
    }[program]
    neg = ref.g1_neg if program == "g1_aggregate" else ref.g2_neg
    from_host = getattr(pmod, program[:2] + "_from_host")
    to_host = getattr(pmod, program[:2] + "_to_host")
    jfrom, jto = getattr(jmod, program[:2] + "_from_host"), getattr(jmod, program[:2] + "_to_host")
    jagg, pagg = getattr(jmod, program), getattr(pmod, program)
    for pair in ([pts[0], pts[1]], [pts[2], pts[2]], [pts[3], neg(pts[3])]):
        want = jto(jagg(jnp.asarray(np.stack([jfrom(p) for p in pair]))))
        got = to_host(pagg(torch.stack([from_host(p) for p in pair])))
        assert got == want  # the same canonical Jacobian representative
