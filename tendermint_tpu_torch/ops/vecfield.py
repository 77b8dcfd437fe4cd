"""Plain PyTorch radix-2^8 prime-field arithmetic (the secp256k1 field).

The port's counterpart of ``tendermint_tpu/ops/vecfield.py:29``
``make_field`` (the ``"slices"`` style; the ``"matmul"`` style computes the
same limbs and served only the JAX package's pairing): limbs of 8 bits,
loose invariant limbs < 2^11, carry passes whose top carry wraps through
F0 = 2^(8 NLIMBS) mod p, multiplication as a full limb convolution folded
by the table F[i] = 2^(8 (NLIMBS + i)) mod p, canonicalization by a
Barrett-style quotient estimate, Fermat inversion and the batched
(Montgomery-trick) inversion over axis 0.

Every function returns the JAX package's limbs exactly, not only the same
value mod p: the operations are the same integer operations in the same
order. Three choices keep it exact without copying the TPU's shape of
the code:

- limbs are ``int64`` (the JAX package's ``int32`` columns stay below
  2^31, so the wider lanes change no value), and any integer tensor is
  taken as input;
- the sequential base-256 carry (``_scan_carry``) is done by parallel
  carry passes repeated until every limb lies in [0, 256): the limbs and
  the top carry of that form are unique, so they equal the sequential
  scan's;
- ``invert_many`` repeats ``jax.lax.associative_scan``'s recursion, so its
  products are the JAX package's products in the same tree.

It carries the plain version of the secp256k1 verify kernel
(``ops/secp256k1_kernel.py``) on any torch device; the CUDA kernel keeps
4 x 64-bit limbs instead, and only the accept bitmap crosses.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ._build import DeviceCache


def make_field(P: int, nlimbs: int) -> SimpleNamespace:
    NLIMBS = nlimbs

    def _limbs_of(x: int, n: int = NLIMBS) -> np.ndarray:
        return np.array(list(x.to_bytes(n, "little")), dtype=np.int32)

    P_LIMBS = _limbs_of(P)
    F_FOLD = np.stack(
        [_limbs_of(pow(2, 8 * (NLIMBS + i), P)) for i in range(NLIMBS + 2)]
    )
    F0 = F_FOLD[0]

    # additive bias = 0 (mod p) with every limb >= 2048, so that `sub` stays
    # limb-wise non-negative for loose subtrahends: 128 p written as 2048 in
    # every limb plus a remainder, whose overflow above 2^(8 NLIMBS) folds
    # through F0 (the JAX package's construction)
    def _bias_limbs() -> np.ndarray:
        base_val = sum(2048 << (8 * i) for i in range(NLIMBS))
        rest = 128 * P - base_val
        if rest <= 0:
            raise ValueError("prime too small for the bias construction")
        top = rest >> (8 * NLIMBS)
        db = (rest - (top << (8 * NLIMBS))).to_bytes(NLIMBS, "little")
        out = np.array([2048 + db[i] for i in range(NLIMBS)], dtype=np.int64)
        out += int(top) * F0.astype(np.int64)
        return out.astype(np.int32)

    BIAS = _bias_limbs()
    MU = (1 << (8 * NLIMBS + 8)) // P

    # the square-and-multiply bits of p - 2 below the leading one
    E_BITS = [(P - 2) >> i & 1 for i in range((P - 2).bit_length() - 2, -1, -1)]

    # per-device constants: F0, BIAS, P limbs, the fold rows, and the
    # scatter index of the product convolution
    def _make_consts(device: torch.device) -> SimpleNamespace:
        t = lambda a: torch.as_tensor(a, dtype=torch.int64).to(device)  # noqa: E731
        idx = np.add.outer(np.arange(NLIMBS), np.arange(NLIMBS)).reshape(-1)
        return SimpleNamespace(
            f0=t(F0), bias=t(BIAS), p=t(P_LIMBS), fold=t(F_FOLD[: NLIMBS + 1]),
            conv_idx=t(idx),
        )

    _consts = DeviceCache(_make_consts)

    def from_int(x: int) -> np.ndarray:
        return _limbs_of(x % P)

    def to_int(limbs) -> int:
        arr = np.asarray(limbs, dtype=np.int64)
        return int(sum(int(v) << (8 * i) for i, v in enumerate(arr.tolist())))

    def zeros(shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros((*shape, NLIMBS), dtype=torch.int64, device=device)

    def ones(shape=(), device="cpu") -> torch.Tensor:
        z = zeros(shape, device)
        z[..., 0] = 1
        return z

    def _i64(x: torch.Tensor) -> torch.Tensor:
        return x if x.dtype == torch.int64 else x.to(torch.int64)

    def _carry_pass(x):
        x = _i64(x)
        c = x >> 8
        r = x - (c << 8)
        wrap = F.pad(c[..., :-1], (1, 0))
        return r + wrap + c[..., -1:] * _consts.get(x.device).f0

    def add(a, b):
        return _carry_pass(_i64(a) + _i64(b))

    def sub(a, b):
        x = _i64(a) + _consts.get(a.device).bias - _i64(b)
        return _carry_pass(_carry_pass(x))

    def neg(a):
        x = _consts.get(a.device).bias - _i64(a)
        return _carry_pass(_carry_pass(x))

    def _scan_carry(x):
        """(limbs in [0, 256), top carry) of the base-256 value of x, as the
        sequential scan gives them; signed-safe (>> is a floor division)."""
        x = _i64(x)
        top = torch.zeros_like(x[..., 0])
        while True:
            c = x >> 8
            if not bool(c.any()):
                return x, top
            x = x - (c << 8) + F.pad(c[..., :-1], (1, 0))
            top = top + c[..., -1]

    def mul(a, b):
        a, b = torch.broadcast_tensors(_i64(a), _i64(b))
        k = _consts.get(a.device)
        shape = a.shape[:-1]
        outer = (a[..., :, None] * b[..., None, :]).reshape(*shape, NLIMBS * NLIMBS)
        conv = torch.zeros((*shape, 2 * NLIMBS - 1), dtype=torch.int64, device=a.device)
        conv.scatter_add_(-1, k.conv_idx.expand(*shape, NLIMBS * NLIMBS), outer)
        limbs, top = _scan_carry(conv)
        hi_bytes = torch.cat(
            [limbs[..., NLIMBS:], (top & 255)[..., None], (top >> 8)[..., None]], -1
        )
        x = limbs[..., :NLIMBS] + (hi_bytes[..., :, None] * k.fold).sum(-2)
        for _ in range(5):
            x = _carry_pass(x)
        return x

    def sqr(a):
        return mul(a, a)

    def mul_small(a, k: int):
        if not 0 <= k <= 1 << 14:
            raise ValueError(f"mul_small: k={k} outside [0, 2^14]")
        x = _i64(a) * k
        return _carry_pass(_carry_pass(_carry_pass(x)))

    def select(cond, a, b):
        return torch.where(cond[..., None], a, b)

    def canonical(x):
        k = _consts.get(x.device)
        limbs, top = _scan_carry(x)
        for _ in range(4):
            limbs, top = _scan_carry(limbs + top[..., None] * k.f0)
        t16 = (limbs[..., NLIMBS - 1] << 8) | limbs[..., NLIMBS - 2]
        q = ((t16 * MU) >> 24).clamp(min=0)
        limbs, _ = _scan_carry(limbs - q[..., None] * k.p)
        for _ in range(3):
            diff = limbs - k.p
            nz = diff != 0
            # the most significant nonzero limb of limbs - p
            first = (NLIMBS - 1) - nz.flip(-1).to(torch.int64).argmax(-1, keepdim=True)
            ms = diff.gather(-1, first).squeeze(-1)
            geq = torch.where(nz.any(-1), ms > 0, torch.ones_like(ms, dtype=torch.bool))
            limbs, _ = _scan_carry(limbs - k.p * geq[..., None].to(torch.int64))
        return limbs

    def is_zero(x):
        return (canonical(x) == 0).all(-1)

    def invert(z):
        """z^(p - 2), the JAX package's square-and-multiply chain."""
        r = _i64(z)
        for bit in E_BITS:
            r = sqr(r)
            if bit:
                r = mul(r, z)
        return r

    def _assoc_scan(x):
        """Inclusive product scan over axis 0 in jax.lax.associative_scan's
        recursion (pairs, the scan of the pairs, then the even elements)."""
        n = x.shape[0]
        if n < 2:
            return x
        odd = _assoc_scan(mul(x[0 : n - 1 : 2], x[1::2]))
        even = mul(odd[:-1] if n % 2 == 0 else odd, x[2::2])
        out = torch.empty((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        out[0::2] = torch.cat([x[:1], even])
        out[1::2] = odd
        return out

    def invert_many(z):
        """Batched inversion over axis 0: prefix and suffix product scans and
        one Fermat chain for the total. Zero rows invert to zero."""
        z = _i64(z)
        zero = is_zero(z)
        one = ones(z.shape[:-1], z.device)
        safe = select(zero, one, z)
        prefix = _assoc_scan(safe)
        suffix = _assoc_scan(safe.flip(0)).flip(0)
        total_inv = invert(prefix[-1])
        one_row = ones((1,), z.device)
        excl_p = torch.cat([one_row, prefix[:-1]], 0)
        excl_s = torch.cat([suffix[1:], one_row], 0)
        inv = mul(mul(excl_p, excl_s), total_inv.expand(z.shape))
        return select(zero, zeros(z.shape[:-1], z.device), inv)

    return SimpleNamespace(
        P=P,
        NLIMBS=NLIMBS,
        from_int=from_int,
        to_int=to_int,
        zeros=zeros,
        ones=ones,
        add=add,
        sub=sub,
        neg=neg,
        mul=mul,
        sqr=sqr,
        mul_small=mul_small,
        select=select,
        canonical=canonical,
        is_zero=is_zero,
        invert=invert,
        invert_many=invert_many,
        _scan_carry=_scan_carry,
    )
