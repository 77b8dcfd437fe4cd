"""BLS12-381 pairing: the Miller-loop and final-exponentiation kernels and
their plain versions.

Counterpart of ``tendermint_tpu/ops/bls_pairing.py``, the same
construction:

- Fp12 = Fp2[w]/(w^6 - xi), xi = 1 + u, the flat sextic tower of the host
  oracle (``crypto/bls12_381.py``), not the 2-3-2 tower of blst/kilic;
  an element is ``[..., 6, 2, 48]`` canonical bytes at the boundary.
- Miller loop over the bits of |x|, T in Jacobian coordinates, lines
  scaled by their denominators (2 Y Z^3 for doubling, Z lambda for
  addition; ``_dbl_step``/``_add_step`` of the JAX package), so no
  inversion runs in the loop; the result is conjugated for x < 0. Pairs
  come two to a chunk (``NPAIRS``), chunks padded to a power of two, and
  the chunk values multiply before one final exponentiation.
- Final exponentiation: the easy part (conj * inverse, frobenius^2), then
  the hard part's chain (x-1)^2 (x+p) (x^2+p^2-1) + 3 with cyclotomic
  squaring, which gives the cube of the ate pairing, as the oracle does.

Kernels (``ops/csrc/bls_kernels.cu``): ``miller`` launches ``tm_miller``
(one thread per chunk, then the product of the chunks) and ``final_exp``
launches ``tm_final_exp`` (one thread per element). Each wrapper runs its
plain version (``miller_plain``, ``final_exp_plain``) on a CPU tensor and
counts its launches in ``<wrapper>.launches``. Internal Miller values
depend on the line scaling, so kernel and plain version agree exactly on
the Miller output; ``pairing_value`` and ``check_pairs`` agree with the
oracle and the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..crypto import bls12_381 as host
from . import bls_field as fp
from ._build import DeviceCache, check_operand, launch, on_cuda

P = host.P
X_ABS = host.X_ABS
NPAIRS = 2  # pairs per Miller chunk: the aggregate-verify check shape

_XBITS_TAIL = [int(b) for b in bin(X_ABS)[3:]]  # T starts at Q
_XBITS_ALL = [int(b) for b in bin(X_ABS)[2:]]  # r starts at one


def _make_consts(device: torch.device) -> dict:
    one = torch.zeros(6, 2, fp.NLIMBS, dtype=torch.int64)
    one[0, 0, 0] = 1
    return {
        "gamma": fp.from_ints([list(g) for g in host._GAMMA], device),
        "one12": one.to(device),
        "conj": torch.tensor([1, -1, 1, -1, 1, -1], dtype=torch.int64)
        .reshape(6, 1, 1).to(device),
    }


_CONSTS = DeviceCache(_make_consts)


# --- Fp12 plain arithmetic: [..., 6, 2, 25] -------------------------------


def _antidiag(prod: torch.Tensor) -> torch.Tensor:
    """``[..., 6, 6, E...]`` products -> ``[..., 11, E...]`` sums over
    i + j = k (row i shifted by i through a pad-and-view)."""
    lead, tail = prod.shape[:-4], prod.shape[-2:]
    x = prod.flatten(-2)  # [..., 6, 6, E]
    e = x.shape[-1]
    x = F.pad(x, (0, 0, 0, 6))  # [..., 6, 12, E]
    x = x.reshape(*lead, 72, e)[..., :66, :].reshape(*lead, 6, 11, e)
    return x.sum(-3).unflatten(-1, tail)


def f12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook over w: 36 Fp2 products in one batched multiply, the
    w^6 = xi fold, one reduction."""
    prod = fp.f2_mul(a.unsqueeze(-3), b.unsqueeze(-4))  # [..., 6, 6, 2, 25]
    cols = _antidiag(prod)
    out = cols[..., :6, :, :] + F.pad(
        fp.f2_mul_xi(cols[..., 6:, :, :]), (0, 0, 0, 0, 0, 1)
    )
    return fp.norm(out)


def f12_conj(a: torch.Tensor) -> torch.Tensor:
    """w -> -w (frobenius^6)."""
    return a * _CONSTS.get(a.device)["conj"]


def f12_frob(a: torch.Tensor) -> torch.Tensor:
    """a^p: conjugate each Fp2 coefficient, twist by gamma_i."""
    return fp.norm(fp.f2_mul(fp.f2_conj(a), _CONSTS.get(a.device)["gamma"]))


def _f6_inv(a0, a1, a2):
    """Fp6 = Fp2[v]/(v^3 - xi) inversion (JAX bls_pairing._f6_inv)."""
    sq = fp.f2_sqr(torch.stack([a0, a2, a1]))
    pr = fp.f2_mul(torch.stack([a1, a0, a0]), torch.stack([a2, a1, a2]))
    c0 = sq[0] - fp.f2_mul_xi(pr[0])
    c1 = fp.f2_mul_xi(sq[1]) - pr[1]
    c2 = sq[2] - pr[2]
    t3 = fp.f2_mul(torch.stack([a1, a2, a0]), torch.stack([c2, c1, c0]))
    t = fp.norm(fp.f2_mul_xi(t3[0] + t3[1]) + t3[2])
    ti = fp.f2_inv(t)
    return fp.norm(fp.f2_mul(torch.stack([c0, c1, c2]), ti))


def f12_inv(a: torch.Tensor) -> torch.Tensor:
    """Via the even subalgebra: n = a conj(a) lies in Fp2[w^2]."""
    ac = f12_conj(a)
    n = f12_mul(a, ac)
    i0, i1, i2 = _f6_inv(n[..., 0, :, :], n[..., 2, :, :], n[..., 4, :, :])
    z = torch.zeros_like(i0)
    return f12_mul(ac, torch.stack([i0, z, i1, z, i2, z], -3))


def f12_cyclo_sqr(a: torch.Tensor) -> torch.Tensor:
    """Granger-Scott squaring, valid in the cyclotomic subgroup only."""
    c = a.unbind(-3)
    x = torch.stack([c[0], c[1], c[2]], -3)
    y = torch.stack([c[3], c[4], c[5]], -3)
    t0, t1, s = fp.f2_sqr(torch.stack([x, y, x + y])).unbind(0)
    sq0 = t0 + fp.f2_mul_xi(t1)  # (x^2 + xi y^2): A0, B0, C0
    sq1 = s - t0 - t1  # 2xy: A1, B1, C1
    A0, B0, C0 = sq0.unbind(-3)
    A1, B1, C1 = sq1.unbind(-3)
    o0 = 2 * (A0 - c[0]) + A0
    o3 = 2 * (A1 + c[3]) + A1
    o2 = 2 * (B0 - c[2]) + B0
    o5 = 2 * (B1 + c[5]) + B1
    re = fp.f2_mul_xi(C1)
    o1 = 2 * (re + c[1]) + re
    o4 = 2 * (C0 - c[4]) + C0
    return fp.norm(torch.stack([o0, o1, o2, o3, o4, o5], -3))


def _exp_x_signed(a: torch.Tensor) -> torch.Tensor:
    """a^x for the negative BLS parameter (a unitary)."""
    r = _CONSTS.get(a.device)["one12"].expand_as(a)
    for bit in _XBITS_ALL:
        r = f12_cyclo_sqr(r)
        if bit:
            r = f12_mul(r, a)
    return f12_conj(r)


def _final_exp_limbs(f: torch.Tensor) -> torch.Tensor:
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frob(f12_frob(f1)), f1)
    a = f12_mul(_exp_x_signed(f), f12_conj(f))
    a = f12_mul(_exp_x_signed(a), f12_conj(a))
    b = f12_mul(_exp_x_signed(a), f12_frob(a))
    c = f12_mul(
        f12_mul(_exp_x_signed(_exp_x_signed(b)), f12_frob(f12_frob(b))),
        f12_conj(b),
    )
    return f12_mul(c, f12_mul(f12_cyclo_sqr(f), f))


# --- Miller loop plain ----------------------------------------------------


def _dbl_step(X, Y, Z, xp, yp):
    """Line scaled by 2 Y Z^3, and T <- 2T (JAX bls_pairing._dbl_step)."""
    A, B, Zsq = fp.f2_sqr(torch.stack([X, Y, Z])).unbind(0)
    C, XB2, YZ = fp.f2_mul(
        torch.stack([B, X + B, Y]), torch.stack([B, X + B, Z])
    ).unbind(0)
    D = 2 * (XB2 - A - C)
    E = 3 * A
    Z3 = 2 * YZ
    Fq, EX, EZ, ZZ = fp.f2_mul(
        torch.stack([E, E, E, Z3]), torch.stack([E, X, Zsq, Zsq])
    ).unbind(0)
    l0 = EX - 2 * B
    l2, l3 = fp.f2_scale(torch.stack([EZ, ZZ]), torch.stack([xp, yp])).unbind(0)
    X3 = Fq - 2 * D
    Y3 = fp.f2_mul(E, D - X3) - 8 * C
    T = fp.norm(torch.stack([X3, Y3, Z3]))
    return fp.norm(torch.stack([l0, -l2, l3])), T


def _add_step(X, Y, Z, xq, yq, xp, yp):
    """Line through T and Q scaled by Z lambda, and T <- T + Q
    (JAX bls_pairing._add_step)."""
    Zsq = fp.f2_sqr(Z)
    Zcu = fp.f2_mul(Zsq, Z)
    yZ, xZ = fp.f2_mul(torch.stack([yq, xq]), torch.stack([Zcu, Zsq])).unbind(0)
    theta = Y - yZ
    lam = X - xZ
    Zlam = fp.f2_mul(Z, lam)
    tx, zy = fp.f2_mul(torch.stack([theta, Zlam]), torch.stack([xq, yq])).unbind(0)
    l0 = tx - zy
    l2, l3 = fp.f2_scale(torch.stack([theta, Zlam]), torch.stack([xp, yp])).unbind(0)
    h = -lam
    i = 4 * fp.f2_sqr(h)
    r = -2 * theta
    j, v, r2, Zh = fp.f2_mul(
        torch.stack([h, X, r, Z]), torch.stack([i, i, r, h])
    ).unbind(0)
    X3 = r2 - j - 2 * v
    Yj = fp.f2_mul(Y, j)
    Y3 = fp.f2_mul(r, v - X3) - 2 * Yj
    Z3 = 2 * Zh
    T = fp.norm(torch.stack([X3, Y3, Z3]))
    return fp.norm(torch.stack([l0, -l2, l3])), T


def _fold_lines(f, lines, valid):
    """f times each pair's line l0 + l2 w^2 + l3 w^3; invalid pairs fold
    the identity line."""
    one = _CONSTS.get(f.device)["one12"]
    z = torch.zeros_like(lines[0])
    full = torch.stack([lines[0], z, lines[1], lines[2], z, z], -3)  # [C, 2, 6, 2, 25]
    full = torch.where(valid[..., None, None, None], full, one)
    for i in range(NPAIRS):
        f = f12_mul(f, full[:, i])
    return f


def _miller_limbs(xp, yp, xq, yq, valid) -> torch.Tensor:
    """Per-chunk Miller values ``[C, 6, 2, 25]``."""
    c = xp.shape[0]
    consts = _CONSTS.get(xp.device)
    f = consts["one12"].expand(c, 6, 2, fp.NLIMBS)
    X, Y = xq, yq
    Z = torch.zeros_like(xq)
    Z[..., 0, 0] = 1
    for bit in _XBITS_TAIL:
        f = f12_mul(f, f)
        lines, T = _dbl_step(X, Y, Z, xp, yp)
        X, Y, Z = T.unbind(0)
        f = _fold_lines(f, lines, valid)
        if bit:
            lines, T = _add_step(X, Y, Z, xq, yq, xp, yp)
            X, Y, Z = T.unbind(0)
            f = _fold_lines(f, lines, valid)
    return f12_conj(f)


def _check_chunks(xp, yp, xq, yq, valid) -> None:
    c, dev = xp.shape[0], xp.device
    for name, t in (("xp", xp), ("yp", yp)):
        check_operand(t, name, torch.uint8, (c, NPAIRS, 48), dev)
    for name, t in (("xq", xq), ("yq", yq)):
        check_operand(t, name, torch.uint8, (c, NPAIRS, 2, 48), dev)
    check_operand(valid, "valid", torch.bool, (c, NPAIRS), dev)
    if c < 1 or c & (c - 1):
        raise ValueError(f"chunk count must be a power of two, got {c}")


def miller_plain(xp, yp, xq, yq, valid) -> torch.Tensor:
    """Chunks xp/yp ``[C, 2, 48]``, xq/yq ``[C, 2, 2, 48]`` uint8 (affine),
    valid ``[C, 2]`` -> the product of the chunks' Miller values,
    ``[6, 2, 48]`` canonical bytes."""
    f = _miller_limbs(
        fp.from_bytes(xp), fp.from_bytes(yp), fp.from_bytes(xq),
        fp.from_bytes(yq), valid,
    )
    while f.shape[0] > 1:
        f = f12_mul(f[0::2], f[1::2])
    return fp.to_bytes(f[0])


def miller(xp, yp, xq, yq, valid) -> torch.Tensor:
    """The Miller loop and the chunk product; same operands as the plain
    version."""
    if not on_cuda(xp):
        return miller_plain(xp, yp, xq, yq, valid)
    _check_chunks(xp, yp, xq, yq, valid)
    c = xp.shape[0]
    out = torch.empty((6, 2, 48), dtype=torch.uint8, device=xp.device)
    scratch = torch.empty(c * 72, dtype=torch.int64, device=xp.device)
    launch("miller", xp, yp, xq, yq, valid, scratch, out)
    miller.launches += 1
    return out


miller.launches = 0


def final_exp_plain(f: torch.Tensor) -> torch.Tensor:
    """``[N, 6, 2, 48]`` uint8 -> f^((p^12 - 1)/r * 3), canonical bytes."""
    return fp.to_bytes(_final_exp_limbs(fp.from_bytes(f)))


def final_exp(f: torch.Tensor) -> torch.Tensor:
    """The final exponentiation; same operands as the plain version."""
    if not on_cuda(f):
        return final_exp_plain(f)
    n = f.shape[0]
    check_operand(f, "f", torch.uint8, (n, 6, 2, 48), f.device)
    out = torch.empty_like(f)
    if n:
        launch("final_exp", f, out)
        final_exp.launches += 1
    return out


final_exp.launches = 0


# --- host-facing API ------------------------------------------------------


def _le(v: int) -> list[int]:
    return list((v % P).to_bytes(48, "little"))


def prepare_pairs(pairs, device) -> tuple:
    """Host Jacobian pairs -> chunk tensors (xp, yp, xq, yq, valid) on
    ``device``: infinity pairs dropped (their factor is 1), NPAIRS pairs a
    chunk, the chunk count padded to a power of two (the JAX package's
    ``_prepare_pairs`` contract)."""
    prepared = []
    for gp, gq in pairs:
        pa = host.g1_to_affine(gp)
        qa = host.g2_to_affine(gq)
        if pa is None or qa is None:
            continue
        prepared.append((pa, qa))
    n = len(prepared)
    nchunks = max(1, -(-n // NPAIRS))
    nchunks = 1 << (nchunks - 1).bit_length()
    slots = nchunks * NPAIRS
    zero = [0] * 48
    xp = [_le(pa[0]) for pa, _ in prepared] + [zero] * (slots - n)
    yp = [_le(pa[1]) for pa, _ in prepared] + [zero] * (slots - n)
    xq = [[_le(c) for c in qa[0]] for _, qa in prepared] + [[zero, zero]] * (slots - n)
    yq = [[_le(c) for c in qa[1]] for _, qa in prepared] + [[zero, zero]] * (slots - n)

    def t(rows, *shape):
        return torch.tensor(rows, dtype=torch.uint8).reshape(*shape).to(device)

    valid = torch.tensor([True] * n + [False] * (slots - n))
    return (
        t(xp, nchunks, NPAIRS, 48), t(yp, nchunks, NPAIRS, 48),
        t(xq, nchunks, NPAIRS, 2, 48), t(yq, nchunks, NPAIRS, 2, 48),
        valid.reshape(nchunks, NPAIRS).to(device),
    )


def f12_to_host(f: torch.Tensor) -> tuple:
    """``[6, 2, 48]`` uint8 -> host coefficient tuple."""
    rows = f.cpu().reshape(6, 2, 48).tolist()
    return tuple(
        tuple(int.from_bytes(bytes(v), "little") for v in c) for c in rows
    )


def _value(pairs, device) -> torch.Tensor | None:
    chunks = prepare_pairs(pairs, device)
    if not bool(chunks[4].any()):
        return None  # the empty product
    return final_exp(miller(*chunks).unsqueeze(0))[0]


def pairing_value(pairs, device) -> tuple:
    """prod e(P_i, Q_i) as host Fp12 coefficients (the cube of the ate
    pairing, the normalization of crypto/bls12_381.pairing)."""
    f = _value(pairs, device)
    if f is None:
        return host.F12_ONE
    return f12_to_host(f)


def check_pairs(pairs, device) -> bool:
    """prod e(P_i, Q_i) == 1 — the verification primitive."""
    f = _value(pairs, device)
    return f is None or f12_to_host(f) == host.F12_ONE
