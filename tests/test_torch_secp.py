"""The port's secp256k1 field (ops/vecfield.py) and group law
(ops/secp256k1_kernel.py double / add_points) against the JAX package's.

The same seeded numpy limbs go through the jitted JAX functions and the
port's plain PyTorch versions; the limbs must be equal, not only the
values mod p (tolerance: exact). Inputs include the worst-case loose limbs
(every limb 2^11 - 1) and the group law's exceptional cases: P == Q,
P == -Q, either input at infinity, y == 0 and z == 0.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import secp256k1 as jhost
from tendermint_tpu.ops import secp256k1_kernel as jk
from tendermint_tpu_torch.ops import secp256k1_kernel as tk

jfe, tfe = jk.fe, tk.fe
P = jk.P
WORST = (1 << 11) - 1

# one compiled program per function and shape (eager JAX dispatch of the
# limb arithmetic is pathologically slow)
_J = {
    name: jax.jit(getattr(jfe, name))
    for name in ("mul", "add", "sub", "neg", "canonical", "invert_many")
}
_J["mul_small"] = jax.jit(lambda a: jfe.mul_small(a, 8))
_J_DOUBLE = jax.jit(jk.double)
_J_ADD = jax.jit(jk.add_points)


@pytest.fixture(autouse=True)
def one_thread():
    # thousands of small tensor operations: threads only add overhead
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(rng, n, hi=1 << 11):
    return rng.integers(0, hi, (n, 32)).astype(np.int32)


_T = {name: getattr(tfe, name) for name in _J}
_T["mul_small"] = lambda a: tfe.mul_small(a, 8)


def _port(name, *args):
    return _T[name](*(torch.from_numpy(a) for a in args)).numpy()


def _jax(name, *args):
    return np.asarray(_J[name](*(jnp.asarray(a) for a in args)))


def test_field_ops_match_jax_limb_for_limb():
    rng = np.random.default_rng(1)
    a, b = _limbs(rng, 24), _limbs(rng, 24)
    a[0] = b[1] = WORST  # every limb at the loose bound
    a[2] = b[2] = 0
    canon = np.stack([jfe.from_int(random.Random(i).randrange(P)) for i in range(24)])
    for name, args in (
        ("mul", (a, b)), ("add", (a, b)), ("sub", (a, b)), ("neg", (a,)),
        ("canonical", (a,)), ("canonical", (canon,)), ("mul_small", (a,)),
    ):
        np.testing.assert_array_equal(_port(name, *args), _jax(name, *args), err_msg=name)
    for row, x in zip(_port("canonical", a), a):
        assert jfe.to_int(row) == jfe.to_int(x) % P


def test_mul_chain_at_the_loose_bound_matches_jax():
    x = np.full((1, 32), WORST, dtype=np.int32)
    jx, tx = x, torch.from_numpy(x)
    val = jfe.to_int(x[0]) % P
    for _ in range(6):
        jx = _jax("mul", jx, jx)
        tx = tfe.mul(tx, tx)
        val = val * val % P
        np.testing.assert_array_equal(tx.numpy(), jx)
        assert int(tx.max()) < 1 << 11, "loose bound violated"
    assert tfe.to_int(tfe.canonical(tx)[0].numpy()) == val


def test_invert_many_matches_jax_limb_for_limb():
    """The batched inversion repeats jax.lax.associative_scan's product
    tree, so its limbs (not only its values) equal the JAX package's; zero
    rows invert to zero."""
    # 6 rows: the scan's recursion meets an even (6) and an odd (3) length
    z = _limbs(np.random.default_rng(2), 6)
    z[3] = 0
    got = _port("invert_many", z)
    np.testing.assert_array_equal(got, _jax("invert_many", z))
    for row, v in zip(tfe.canonical(torch.from_numpy(got)).numpy(), z):
        iv = jfe.to_int(v) % P
        assert tfe.to_int(row) == (pow(iv, P - 2, P) if iv else 0)


def test_scan_carry_matches_jax_on_signed_values():
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 20), 1 << 20, (16, 63)).astype(np.int32)
    x[0] = -1  # a borrow that ripples through every limb
    x[1] = 255
    x[1, 0] = 256  # a carry that ripples through every limb
    jl, jt = jax.jit(jfe._scan_carry)(jnp.asarray(x))
    tl, tt = tfe._scan_carry(torch.from_numpy(x))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _points(seed: int):
    """Jacobian test points [K, 3, 32]: random multiples of G in affine and
    scaled Jacobian form, their negatives, the identity, and a z == 0
    and a y == 0 point."""
    r = random.Random(seed)
    pts, affine = [], []
    for _ in range(4):
        x, y = jhost._to_affine(jhost._jmul(r.randrange(1, jhost.N), (jk.GX, jk.GY, 1)))
        affine.append((x, y))
        lam = r.randrange(1, P)
        pts.append(jk.from_affine_host(x, y))
        pts.append(np.stack([jfe.from_int(x * lam * lam), jfe.from_int(y * lam ** 3),
                             jfe.from_int(lam)]))
    for x, y in affine[:2]:
        pts.append(jk.from_affine_host(x, P - y))
    ident = np.zeros((3, 32), np.int32)
    ident[1, 0] = 1
    y0 = jk.from_affine_host(affine[0][0], 0)
    return np.stack(pts + [ident, y0])


def test_double_matches_jax():
    pts = _points(4)
    got = tk.double(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_J_DOUBLE(jnp.asarray(pts))))


def test_add_points_matches_jax_on_every_branch():
    """All pairs of the test points: the general case, P == Q (affine and
    rescaled Jacobian forms of one point), P == -Q, the identity on
    either side, and the y == 0 point."""
    pts = _points(5)
    k = len(pts)
    p = np.repeat(pts, k, axis=0)
    q = np.tile(pts, (k, 1, 1))
    got = tk.add_points(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_J_ADD(jnp.asarray(p), jnp.asarray(q))))


def test_scalar_digits_and_g_table_match_jax():
    rng = np.random.default_rng(6)
    s = rng.integers(0, 256, (5, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        tk.nibbles(torch.from_numpy(s)).numpy(), np.asarray(jk.nibbles(jnp.asarray(s)))
    )
    np.testing.assert_array_equal(tk._g_table(), jk._g_table())
