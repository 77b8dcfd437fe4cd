"""Parity of the port's ed25519 batch functions with the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its jitted programs on the CPU backend. Inputs: seeded keys plus
the adversarial rows of the reference's differential tests (small-order
and non-canonical keys, s >= L, wrong message, zero R). Tolerance: exact
equality of table bytes, bitmaps and canonical affine coordinates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops import curve25519 as jcurve
from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu.ops import field25519 as jfe
from tendermint_tpu_torch import ops
from tendermint_tpu_torch.crypto import convert
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import dbl_chain as dc
from tendermint_tpu_torch.ops import ed25519_batch as eb
from tendermint_tpu_torch.ops import field25519 as fe

B = 8


def _rows():
    """B (pubkey, msg, sig) rows: valid and adversarial."""
    rng = np.random.default_rng(11)
    k = host.PrivKey(rng.bytes(32))
    k2 = host.PrivKey(rng.bytes(32))
    pub, msg = k.public_key().data, b"vote sign bytes"
    sig = k.sign(msg)
    s_int = int.from_bytes(sig[32:], "little")
    ident_s = 777
    ident_sig = host.point_compress(
        host.scalar_mult(ident_s, host.BASEPOINT)
    ) + ident_s.to_bytes(32, "little")
    return [
        (pub, msg, sig),  # valid
        (pub, msg, sig[:32] + (s_int + host.L).to_bytes(32, "little")),
        (pub, b"other", sig),  # wrong msg
        (pub, msg, bytes(32) + sig[32:]),  # zero R
        ((1).to_bytes(32, "little"), b"torsion", ident_sig),  # small order
        (host.P.to_bytes(32, "little"), msg, sig),  # y = p
        (k2.public_key().data, b"m2", k2.sign(b"m2")),  # valid
        (rng.bytes(32), msg, sig),  # random key bytes
    ]


def _arrays(rows):
    def a(xs):
        return np.array([list(x) for x in xs], dtype=np.uint8)

    pubs = a(p for p, _, _ in rows)
    r = a(s[:32] for _, _, s in rows)
    s = a(s[32:] for _, _, s in rows)
    k = a(
        host.challenge(sig[:32], p, m).to_bytes(32, "little")
        for p, m, sig in rows
    )
    s_ok = np.array(
        [int.from_bytes(sig[32:], "little") < host.L for _, _, sig in rows]
    )
    return pubs, r, s, k, s_ok


@pytest.fixture(scope="module")
def batch():
    rows = _rows()
    pubs, r, s, k, s_ok = _arrays(rows)
    want = [host.verify(p, m, sig) for p, m, sig in rows]
    assert any(want) and not all(want)
    jt, jv = jax.jit(jeb.neg_pubkey_table)(jnp.asarray(pubs))
    return rows, (pubs, r, s, k, s_ok), want, (np.array(jt), np.array(jv))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_neg_pubkey_table_bytes_match_jax(batch):
    _, (pubs, *_), _, (jt, jv) = batch
    before = ops.kernel_launches()
    tables, valid = eb.neg_pubkey_table(torch.from_numpy(pubs))
    assert ops.kernel_launches() == before  # CPU tensors: plain version
    np.testing.assert_array_equal(tables.numpy(), jt)
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert tables.dtype == torch.uint8 and tables.shape == (B, 16, 4, 32)


def test_verify_prehashed_table_bitmap_matches_jax(batch):
    _, (pubs, r, s, k, s_ok), want, (jt, jv) = batch
    jgot = np.asarray(
        jax.jit(jeb.verify_prehashed_table)(
            jnp.asarray(jt), jnp.asarray(jv), *map(jnp.asarray, (r, s, k, s_ok))
        )
    )
    idx = torch.arange(B, dtype=torch.int32)
    got = eb.verify_prehashed_table(*_t(jt, jv), idx, *_t(r, s, k, s_ok))
    assert got.tolist() == jgot.tolist() == want


def test_verify_prehashed_table_idx_gather_and_padding(batch):
    """Rows gather their table by idx; idx < 0 and idx past the store
    reject (the reference clamps to row 0 and masks)."""
    _, (pubs, r, s, k, s_ok), want, (jt, jv) = batch
    perm = np.array([6, 0, 3, 1, 2, 5, 4, 7])
    idx = torch.from_numpy(perm.astype(np.int32))
    got = eb.verify_prehashed_table(
        *_t(jt[np.argsort(perm)], jv[np.argsort(perm)]), idx, *_t(r, s, k, s_ok)
    )
    assert got.tolist() == want
    idx_pad = torch.tensor([0, -1, 2, 3, 4, 5, 6, B], dtype=torch.int32)
    got = eb.verify_prehashed_table(*_t(jt, jv), idx_pad, *_t(r, s, k, s_ok))
    assert got.tolist() == [w and i not in (1, 7) for i, w in enumerate(want)]


def test_verify_prehashed_bitmap_matches_jax(batch):
    _, (pubs, r, s, k, s_ok), want, _ = batch
    jgot = np.asarray(
        jeb.verify_prehashed_jit(*map(jnp.asarray, (pubs, r, s, k, s_ok)))
    )
    got = eb.verify_prehashed(*_t(pubs, r, s, k, s_ok))
    assert got.tolist() == jgot.tolist() == want


def _affine(p_bytes: torch.Tensor) -> np.ndarray:
    """[B, 4, 32] bytes -> canonical affine (x, y) bytes [B, 2, 32]."""
    p = fe.from_bytes(p_bytes)
    zi = fe.invert(p[:, 2])
    return fe.to_bytes(fe.mul(p[:, :2], zi.unsqueeze(1))).numpy()


def test_dbl_chain_matches_jax_double_as_affine():
    """The port's plain dbl_chain against N=16 applications of the JAX
    package's curve25519.double (the Pallas kernel's formula)."""
    n_dbl, n = 16, 4
    rng = np.random.default_rng(5)
    pts = []
    for _ in range(n):
        pt = host.scalar_mult(int(rng.integers(1, 2**62)), host.BASEPOINT)
        pts.append([list((c % host.P).to_bytes(32, "little")) for c in pt])
    pts = np.array(pts, dtype=np.uint8)
    jp = jfe.from_bytes(jnp.asarray(pts))
    for _ in range(n_dbl):
        jp = jcurve.double(jp)
    got = dc.dbl_chain(torch.from_numpy(pts), n_dbl)
    want = torch.from_numpy(np.asarray(jfe.to_bytes(jp)))
    np.testing.assert_array_equal(_affine(got), _affine(want))
    # the Pallas layout: JAX's loose limbs as [4, 32, B] float32
    pallas = np.asarray(jp).transpose(1, 2, 0).astype(np.float32)
    np.testing.assert_array_equal(
        _affine(convert.points_from_pallas(pallas)), _affine(got)
    )
    # row 0 against the host oracle
    hq = tuple(int.from_bytes(bytes(c), "little") for c in pts[0])
    for _ in range(n_dbl):
        hq = host.point_double(hq)
    zi = pow(hq[2], host.P - 2, host.P)
    assert [int.from_bytes(bytes(c), "little") for c in _affine(got)[0]] == [
        hq[0] * zi % host.P,
        hq[1] * zi % host.P,
    ]


def test_pallas_layout_round_trip():
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 256, (6, 4, 32), dtype=np.uint8)
    vals[..., 31] &= 0x7F  # canonical inputs are < 2^255
    pts = fe.to_bytes(fe.from_bytes(torch.from_numpy(vals)))
    pallas = convert.points_to_pallas(pts)
    assert pallas.shape == (4, 32, 6) and pallas.dtype == np.float32
    np.testing.assert_array_equal(convert.points_from_pallas(pallas).numpy(), pts.numpy())
    with pytest.raises(ValueError):
        convert.points_from_pallas(pallas[:3])
