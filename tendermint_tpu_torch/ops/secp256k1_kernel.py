"""Batched secp256k1 ECDSA verification: the CUDA kernel and its plain version.

Counterpart of ``tendermint_tpu/ops/secp256k1_kernel.py``. The host does
the cheap bignum work (signature parse, low-S, u1 = z/s and u2 = r/s mod
n, pubkey decompression: ``crypto/secp_native.prep_digest_item``) and the
device verifies B signatures at once: R = u1 G + u2 Q as a joint radix-16
Straus ladder (64 steps of 4 doublings and 2 additions, most significant
digit first), then x(R) mod n == r.

- ``verify_prehashed_plain``: the JAX package's program in plain PyTorch
  over ``ops/vecfield`` (radix-2^8 limbs): ``double`` (dbl-2009-l),
  ``add_points`` (add-2007-bl with the doubling, opposite and infinity
  masks), ``nibbles``, ``_g_table``, the per-row table of Q (even entries
  by doubling, odd by one addition), the ladder, the batched inversion and
  the mod-n compare with its borrow guard. Limbs equal the JAX package's.
- ``verify_prehashed``: the wrapper; ``tm_secp_verify``
  (``csrc/secp256k1_kernels.cu``) on CUDA tensors, the plain version on
  CPU ones. It counts its launches in ``verify_prehashed.launches``.

The operands are the JAX package's, so no converter is needed:
``qx``, ``qy`` ``[B, 32]`` int32 radix-2^8 limbs of Q's affine coordinates
(limbs in [0, 2^11), the field's loose bound; the host gives canonical
bytes), ``u1``, ``u2``, ``r_bytes`` ``[B, 32]`` uint8 big-endian, ``ok_in``
``[B]`` bool (the host pre-checks); the result is a ``[B]`` bool bitmap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vecfield
from ._build import DeviceCache, check_operand, launch, on_cuda

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

fe = vecfield.make_field(P, 32)
NLIMBS = fe.NLIMBS

# n as byte limbs for the mod-n comparison (n < p < 2n, so x mod n is x
# or x - n)
_N_LIMBS = np.array(list(N.to_bytes(32, "little")), dtype=np.int64)


# --- Jacobian group law (a = 0) -------------------------------------------


def identity(shape=(), device="cpu") -> torch.Tensor:
    z = torch.zeros((*shape, 3, NLIMBS), dtype=torch.int64, device=device)
    z[..., 1, 0] = 1  # (0, 1, 0)
    return z


def is_inf(p: torch.Tensor) -> torch.Tensor:
    return fe.is_zero(p[..., 2, :])


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None, None], a, b)


def double(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a = fe.sqr(x)
    b = fe.sqr(y)
    c = fe.sqr(b)
    xb = fe.add(x, b)
    d = fe.mul_small(fe.sub(fe.sub(fe.sqr(xb), a), c), 2)
    e = fe.mul_small(a, 3)
    f = fe.sqr(e)
    x3 = fe.sub(f, fe.mul_small(d, 2))
    y3 = fe.sub(fe.mul(e, fe.sub(d, x3)), fe.mul_small(c, 8))
    z3 = fe.mul_small(fe.mul(y, z), 2)
    bad = fe.is_zero(y) | fe.is_zero(z)
    out = torch.stack([x3, y3, z3], -2)
    return _where(bad, identity(p.shape[:-2], p.device), out)


def add_points(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete masked addition: add-2007-bl, P == Q as a doubling,
    P == -Q as the identity, an input at infinity gives the other."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    z1z1 = fe.sqr(z1)
    z2z2 = fe.sqr(z2)
    u1 = fe.mul(x1, z2z2)
    u2 = fe.mul(x2, z1z1)
    s1 = fe.mul(fe.mul(y1, z2), z2z2)
    s2 = fe.mul(fe.mul(y2, z1), z1z1)
    h = fe.sub(u2, u1)
    r = fe.mul_small(fe.sub(s2, s1), 2)
    same_x = fe.is_zero(h)
    same_y = fe.is_zero(fe.sub(s2, s1))
    i = fe.sqr(fe.mul_small(h, 2))
    j = fe.mul(h, i)
    v = fe.mul(u1, i)
    x3 = fe.sub(fe.sub(fe.sqr(r), j), fe.mul_small(v, 2))
    y3 = fe.sub(fe.mul(r, fe.sub(v, x3)), fe.mul_small(fe.mul(s1, j), 2))
    z3 = fe.mul_small(fe.mul(fe.mul(z1, z2), h), 2)
    gen = torch.stack([x3, y3, z3], -2)
    p_inf = is_inf(p)
    q_inf = is_inf(q)
    out = _where(same_x & same_y, double(p), gen)
    out = _where(
        same_x & ~same_y & ~p_inf & ~q_inf, identity(out.shape[:-2], p.device), out
    )
    out = _where(p_inf, q.expand_as(out), out)
    return _where(q_inf, p.expand_as(out), out)


# --- scalar digits and the G table ----------------------------------------


def nibbles(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """[..., 32] u8 big-endian scalar -> [..., 64] radix-16 digits, most
    significant first."""
    s = scalar_bytes.to(torch.int64)
    return torch.stack([s >> 4, s & 15], -1).reshape(*s.shape[:-1], 64)


def _g_affine() -> list[tuple[int, int, int]]:
    """[d]G for d in 0..15 as (x, y, z) integers, (0, 1, 0) for d = 0."""
    from ..crypto import secp256k1 as host

    rows = [(0, 1, 0)]
    for d in range(1, 16):
        x, y = host._to_affine(host._jmul(d, (GX, GY, 1)))
        rows.append((x, y, 1))
    return rows


def _g_table() -> np.ndarray:
    """The G table of the plain ladder: [16, 3, 32] radix-2^8 limbs."""
    return np.stack([np.stack([fe.from_int(c) for c in row]) for row in _g_affine()])


_G_LIMBS = DeviceCache(
    lambda dev: torch.from_numpy(_g_table().astype(np.int64)).to(dev)
)


def _words(c: int) -> list[int]:
    """c as 4 little-endian 64-bit words, each as a signed int64."""
    ws = [(c >> (64 * w)) & ((1 << 64) - 1) for w in range(4)]
    return [w - (1 << 64) if w >> 63 else w for w in ws]


# the kernel's G table: [16, 3, 4] 64-bit words per coordinate
_G_WORDS = DeviceCache(
    lambda dev: torch.tensor(
        [[_words(c) for c in row] for row in _g_affine()], dtype=torch.int64
    ).to(dev)
)


# --- the verify program ----------------------------------------------------


def verify_prehashed_plain(qx, qy, u1, u2, r_bytes, ok_in) -> torch.Tensor:
    """[B] bool accept bitmap: x(u1 G + u2 Q) mod n == r, and ok_in."""
    b, dev = qx.shape[0], qx.device
    q = torch.stack([qx.to(torch.int64), qy.to(torch.int64), fe.ones((b,), dev)], -2)
    # per-row radix-16 table of Q: even entries by doubling, odd by one add
    entries: list = [None] * 16
    entries[0] = identity((b,), dev)
    entries[1] = q
    for d in range(2, 16):
        entries[d] = (
            double(entries[d // 2]) if d % 2 == 0 else add_points(entries[d - 1], q)
        )
    qtab = torch.stack(entries, 1)  # [B, 16, 3, 32]
    gtab = _G_LIMBS.get(dev)  # [16, 3, 32]
    d1 = nibbles(u1)  # G digits
    d2 = nibbles(u2)  # Q digits
    rows = torch.arange(b, device=dev)
    acc = identity((b,), dev)
    for i in range(64):
        acc = double(double(double(double(acc))))
        acc = add_points(acc, qtab[rows, d2[:, i]])
        acc = add_points(acc, gtab[d1[:, i]])
    # x(R) = X / Z^2 with one batched inversion (zero rows invert to zero)
    zinv = fe.invert_many(acc[:, 2])
    x_aff = fe.canonical(fe.mul(acc[:, 0], fe.sqr(zinv)))
    # mod n: the wrapped branch requires x >= n (no borrow out of x - n),
    # or a forged r = x - n + 2^256 would match the wrapped difference
    r_le = r_bytes.flip(-1).to(torch.int64)
    direct = (x_aff == r_le).all(-1)
    x_min_n, borrow = fe._scan_carry(x_aff - torch.from_numpy(_N_LIMBS).to(dev))
    wrapped = (borrow == 0) & (x_min_n == r_le).all(-1)
    return ok_in & ~is_inf(acc) & (direct | wrapped)


def verify_prehashed(qx, qy, u1, u2, r_bytes, ok_in) -> torch.Tensor:
    """``tm_secp_verify`` on CUDA tensors, ``verify_prehashed_plain`` on CPU
    ones; same operands and result."""
    if not on_cuda(qx):
        return verify_prehashed_plain(qx, qy, u1, u2, r_bytes, ok_in)
    dev, b = qx.device, qx.shape[0]
    check_operand(qx, "qx", torch.int32, (b, NLIMBS), dev)
    check_operand(qy, "qy", torch.int32, (b, NLIMBS), dev)
    for name, t in (("u1", u1), ("u2", u2), ("r_bytes", r_bytes)):
        check_operand(t, name, torch.uint8, (b, 32), dev)
    check_operand(ok_in, "ok_in", torch.bool, (b,), dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        launch("secp_verify", qx, qy, u1, u2, r_bytes, ok_in,
               _G_WORDS.get(dev), out)
        verify_prehashed.launches += 1
    return out


verify_prehashed.launches = 0
