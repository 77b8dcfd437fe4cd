"""Parity of the port's plain field and curve code with the JAX package.

Inputs come from a seeded numpy generator and go through both; results
are compared as canonical bytes. Tolerance: exact equality (field and
group elements are integers mod p).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops import curve25519 as jcurve
from tendermint_tpu.ops import field25519 as jfe
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import curve25519 as curve
from tendermint_tpu_torch.ops import field25519 as fe

P = host.P
_EDGE = [0, 1, 2, 19, P - 1, P, P + 1, P + 19, 2**255 - 1, 2**256 - 1]


def _field_bytes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    for i, v in enumerate(_EDGE):
        out[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return out


def _jax_bytes(x) -> np.ndarray:
    return np.asarray(jfe.to_bytes(x))


def _port_bytes(x) -> np.ndarray:
    return fe.to_bytes(x).numpy()


@pytest.fixture(scope="module")
def operands():
    a = _field_bytes(24, seed=1)
    b = _field_bytes(24, seed=2)[::-1].copy()
    return (
        (jfe.from_bytes(jnp.asarray(a)), jfe.from_bytes(jnp.asarray(b))),
        (fe.from_bytes(torch.from_numpy(a)), fe.from_bytes(torch.from_numpy(b))),
        a,
    )


@pytest.mark.parametrize(
    "name, jax_fn, port_fn",
    [
        ("mul", jfe.mul, fe.mul),
        ("add", jfe.add, fe.add),
        ("sub", jfe.sub, fe.sub),
        ("sqr", lambda a, b: jfe.sqr(a), lambda a, b: fe.sqr(a)),
        ("neg", lambda a, b: jfe.neg(a), lambda a, b: fe.neg(a)),
        ("mul_small_2", lambda a, b: jfe.mul_small(a, 2), lambda a, b: fe.mul_small(a, 2)),
        (
            "mul_small_121666",
            lambda a, b: jfe.mul_small(a, 121666),
            lambda a, b: fe.mul_small(a, 121666),
        ),
        ("invert", lambda a, b: jax.jit(jfe.invert)(a), lambda a, b: fe.invert(a)),
        (
            "pow22523",
            lambda a, b: jax.jit(jfe.pow22523)(a),
            lambda a, b: fe.pow22523(a),
        ),
        ("chain", lambda a, b: jfe.mul(jfe.sub(a, b), jfe.add(b, jfe.neg(a))),
         lambda a, b: fe.mul(fe.sub(a, b), fe.add(b, fe.neg(a)))),
    ],
)
def test_field_op_bytes_match_jax(operands, name, jax_fn, port_fn):
    (ja, jb), (ta, tb), _ = operands
    np.testing.assert_array_equal(_port_bytes(port_fn(ta, tb)), _jax_bytes(jax_fn(ja, jb)))


def test_field_predicates_match_jax(operands):
    (ja, jb), (ta, tb), raw = operands
    np.testing.assert_array_equal(fe.canonical(ta).numpy() >= 0, True)
    np.testing.assert_array_equal(_port_bytes(ta), _jax_bytes(ja))
    ints = [int.from_bytes(bytes(r), "little") % P for r in raw]
    assert [int.from_bytes(bytes(r), "little") for r in _port_bytes(ta)] == ints
    np.testing.assert_array_equal(fe.is_zero(ta).numpy(), np.asarray(jfe.is_zero(ja)))
    np.testing.assert_array_equal(fe.parity(ta).numpy(), np.asarray(jfe.parity(ja)))
    # a == a + p (non-canonical encodings of one value compare equal)
    np.testing.assert_array_equal(fe.eq(ta, tb).numpy(), np.asarray(jfe.eq(ja, jb)))
    np.testing.assert_array_equal(fe.eq(ta, ta).numpy(), True)
    assert bool(fe.eq(fe.from_bytes(torch.tensor([list(P.to_bytes(32, "little"))],
                                                 dtype=torch.uint8)),
                      fe.zeros((1,)))[0])


def _pubkey_bytes() -> np.ndarray:
    """Valid keys, small-order / non-canonical / no-root / x=0-with-sign
    encodings, and random bytes."""
    rng = np.random.default_rng(7)
    keys = [host.PrivKey(rng.bytes(32)).public_key().data for _ in range(6)]
    adv = [
        (1).to_bytes(32, "little"),
        bytes(32),
        ((1 << 255) | 1).to_bytes(32, "little"),
        P.to_bytes(32, "little"),
        (P + 1).to_bytes(32, "little"),
        (2**255 - 1).to_bytes(32, "little"),
        (P - 1).to_bytes(32, "little"),
    ]
    rnd = [rng.bytes(32) for _ in range(3)]
    return np.array([list(k) for k in keys + adv + rnd], dtype=np.uint8)


@pytest.fixture(scope="module")
def points():
    pk = _pubkey_bytes()
    jpt, jvalid = jax.jit(jcurve.decompress)(jnp.asarray(pk))
    tpt, tvalid = curve.decompress(torch.from_numpy(pk))
    return pk, (jpt, jvalid), (tpt, tvalid)


def test_decompress_matches_jax_and_oracle(points):
    pk, (jpt, jvalid), (tpt, tvalid) = points
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tvalid.tolist() == [host.point_decompress(bytes(r)) is not None for r in pk]
    np.testing.assert_array_equal(_port_bytes(tpt), _jax_bytes(jpt))


def test_double_and_compress_match_jax(points):
    _, (jpt, _), (tpt, _) = points
    jd = jcurve.double(jcurve.double(jpt))
    td = curve.double(curve.double(tpt))
    np.testing.assert_array_equal(_port_bytes(td), _jax_bytes(jd))
    np.testing.assert_array_equal(
        curve.compress(td).numpy(), np.asarray(jax.jit(jcurve.compress)(jd))
    )
    np.testing.assert_array_equal(
        curve.compress(curve.add(td, tpt)).numpy(),
        np.asarray(jax.jit(jcurve.compress)(jcurve.add(jd, jpt))),
    )


def test_window_table_matches_jax(points):
    _, (jpt, _), (tpt, _) = points
    jt = jax.jit(lambda p: jfe.to_bytes(jcurve.window_table(jcurve.neg(p))))(jpt)
    tt = fe.to_bytes(curve.window_table(curve.neg(tpt)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_base_table_matches_jax():
    np.testing.assert_array_equal(curve.base_table_bytes(), jcurve._base_table())


def test_nibbles_match_jax():
    s = np.random.default_rng(3).integers(0, 256, (4, 32), dtype=np.uint8)
    np.testing.assert_array_equal(
        curve.nibbles(torch.from_numpy(s)).numpy(), np.asarray(jcurve.nibbles(jnp.asarray(s)))
    )


def test_big_window_table_scalar_mults_match_host():
    """[k]P from the fixed-window table, three forms: the per-element table,
    the shared store gathered by index, and the one-hot float32 product."""
    rng = np.random.default_rng(31)
    pts = [host.scalar_mult(int(rng.integers(1, 2**62)), host.BASEPOINT) for _ in range(3)]
    enc = torch.tensor([list(host.point_compress(p)) for p in pts], dtype=torch.uint8)
    a, valid = curve.decompress(enc)
    assert valid.all()
    table = curve.big_window_table(a)  # [3, 64, 16, 4, 16]
    scalars = [0, host.L - 1, 2**256 - 19]
    sb = torch.tensor([list(s.to_bytes(32, "little")) for s in scalars], dtype=torch.uint8)
    want = [host.point_compress(host.scalar_mult(s, p)) for s, p in zip(scalars, pts)]
    got = curve.compress(curve.scalar_mult_var_bigtable(sb, table))
    assert [bytes(r) for r in got.tolist()] == want
    # store rows permuted; idx gathers them back
    store = fe.to_bytes(table)[[2, 0, 1]]
    idx = torch.tensor([1, 2, 0], dtype=torch.int32)
    for mult in (curve.scalar_mult_var_bigcache, curve.scalar_mult_var_bigcache_mxu):
        got = curve.compress(mult(sb, store, idx))
        assert [bytes(r) for r in got.tolist()] == want, mult.__name__
