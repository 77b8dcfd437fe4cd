"""Plain PyTorch arithmetic mod the BLS12-381 prime: Fp and Fp2.

The port's counterpart of ``tendermint_tpu/ops/vecfield.py:29``
``make_field`` and of the Fp layer of ``tendermint_tpu/ops/bls_g1.py``. It
carries the plain versions of the BLS kernels (``ops/bls_g1.py``,
``ops/bls_g2.py``, ``ops/bls_pairing.py``) on any torch device; the CUDA
kernels (``ops/csrc/bls12_381_device.cuh``) use Montgomery 6 x 64-bit limbs
instead. The two agree on values mod p, and only canonical bytes cross
between them.

Representation: an Fp element is ``[..., 25]`` int64, radix-2^16 limbs
(400 bits), limbs signed and not reduced ("loose"). The JAX package kept
radix-2^8 int32 limbs because a TPU has no 64-bit integers; here the
wider lanes leave room for lazy sums:

- ``mul`` takes limbs of magnitude < 2^26 and values of magnitude
  < 2^408 ("weight" up to 128: a sum of up to 128 reduced elements) and
  returns a reduced element: limbs < 2^19, value < 2^401 in magnitude.
  Bounds: 25 products of < 2^52 stay < 2^56.6 per column; four carry
  passes bring the 51 columns to digits in [-1, 2^16]; the digits above
  2^400 fold through F[k] = 2^(16(25+k)) mod p (< 2^36.8 per limb), three
  passes and one fold of the 2^400 digit through F[0] finish.
- ``+``, ``-`` and small integer multiples are plain tensor operations;
  the caller keeps every input of ``mul`` within weight 128 and calls
  ``norm`` (the reduction alone) where a chain of sums grows.
- Canonical form (``to_ints``, ``to_bytes``, ``is_zero``) is exact: the
  limbs go to host integers and are reduced mod p there. It runs only at
  the boundary and in the aggregation masks.

The byte form at the boundary is canonical little-endian ``[..., 48]``
uint8 (the JAX package's 48 radix-2^8 limbs, frozen to [0, p)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import DeviceCache

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
NLIMBS = 25
BITS = 16
MASK = (1 << BITS) - 1
_COLS = 2 * NLIMBS + 1  # product columns, with room for the top carries
_FOLD_ROWS = _COLS - NLIMBS  # digits at or above 2^400


def _digits(x: int, n: int = NLIMBS) -> list[int]:
    return [(x >> (BITS * i)) & MASK for i in range(n)]


def _make_fold(device: torch.device) -> torch.Tensor:
    """F[k] = 2^(16 (25 + k)) mod p as limbs, [26, 25] int64."""
    return torch.tensor(
        [_digits(pow(2, BITS * (NLIMBS + k), P)) for k in range(_FOLD_ROWS)],
        dtype=torch.int64,
    ).to(device)


_FOLD = DeviceCache(_make_fold)


# --- conversions ----------------------------------------------------------


def from_ints(values, device) -> torch.Tensor:
    """Python ints (any nesting, as torch.tensor takes) -> limbs."""
    flat, shape = _flatten(values)
    out = torch.tensor([_digits(v % P) for v in flat], dtype=torch.int64)
    return out.reshape(*shape, NLIMBS).to(device)


def _flatten(values):
    if isinstance(values, int):
        return [values], ()
    flat, shape = [], None
    for v in values:
        f, s = _flatten(v)
        flat += f
        shape = s
    return flat, (len(values), *shape)


def to_ints(x: torch.Tensor) -> list[int]:
    """Flattened canonical values in [0, p) of ``x [..., 25]``."""
    rows = x.reshape(-1, NLIMBS).tolist()
    return [sum(v << (BITS * i) for i, v in enumerate(r)) % P for r in rows]


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """``[..., 48]`` uint8 little-endian -> limbs (the value as is, < 2^384)."""
    w = b.to(torch.int64)
    limbs = w[..., 0::2] | (w[..., 1::2] << 8)
    return F.pad(limbs, (0, NLIMBS - 24))


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Canonical ``[..., 48]`` uint8 little-endian of ``x [..., 25]``."""
    vals = to_ints(x)
    raw = b"".join(v.to_bytes(48, "little") for v in vals)
    out = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return out.reshape(*x.shape[:-1], 48).to(x.device)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """``x ≡ 0 (mod p)``, one bool per element."""
    flags = [v == 0 for v in to_ints(x)]
    return torch.tensor(flags, dtype=torch.bool).reshape(x.shape[:-1]).to(x.device)


# --- reduction and multiplication ----------------------------------------


def _carry(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass; the top column keeps what reaches it."""
    c = x[..., :-1] >> BITS
    y = x.clone()
    y[..., :-1] -= c << BITS
    y[..., 1:] += c
    return y


def _reduce_cols(cols: torch.Tensor) -> torch.Tensor:
    """``[..., 51]`` signed columns of weight 2^(16 i) -> a reduced element."""
    for _ in range(4):
        cols = _carry(cols)
    fold = _FOLD.get(cols.device)
    hi = cols[..., NLIMBS:]
    x = cols[..., :NLIMBS] + (hi.unsqueeze(-1) * fold).sum(-2)
    x = F.pad(x, (0, 1))
    for _ in range(3):
        x = _carry(x)
    return x[..., :NLIMBS] + x[..., NLIMBS:] * fold[0]


def norm(x: torch.Tensor) -> torch.Tensor:
    """Reduce a lazy sum (weight up to 2^37) to a reduced element."""
    return _reduce_cols(F.pad(x, (0, _COLS - NLIMBS)))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p, broadcasting over the leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., 25, 25]
    # shift row i by i columns: pad rows to 52 and view them as 51 wide
    rows = F.pad(outer, (0, _COLS + 1 - NLIMBS))
    rows = rows.reshape(*lead, NLIMBS * (_COLS + 1))[..., : NLIMBS * _COLS]
    cols = rows.reshape(*lead, NLIMBS, _COLS).sum(-2)
    return _reduce_cols(cols)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


_INV_BITS = bin(P - 2)[3:]


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) (Fermat; the inverse, and 0 for 0)."""
    r = a
    for bit in _INV_BITS:
        r = sqr(r)
        if bit == "1":
            r = mul(r, a)
    return r


# --- Fp2 = Fp[u]/(u^2 + 1): [..., 2, 25] (c0, c1) ---------------------------


def f2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba, one batched ``mul`` of three products; weight <= 3 out."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    t = mul(torch.stack([a0, a1, a0 + a1], -2), torch.stack([b0, b1, b0 + b1], -2))
    t0, t1, m = t.unbind(-2)
    return torch.stack([t0 - t1, m - t0 - t1], -2)


def f2_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1)(a0 - a1), 2 a0 a1; weight <= 2 out."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = mul(torch.stack([a0 + a1, a0], -2), torch.stack([a0 - a1, a1], -2))
    return torch.stack([t[..., 0, :], 2 * t[..., 1, :]], -2)


def f2_scale(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Fp2 times an Fp element ``k [..., 25]``."""
    return mul(a, k.unsqueeze(-2))


def f2_mul_xi(a: torch.Tensor) -> torch.Tensor:
    """(c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([a0 - a1, a0 + a1], -2)


def f2_conj(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 0, :], -a[..., 1, :]], -2)


def f2_inv(a: torch.Tensor) -> torch.Tensor:
    """1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = mul(torch.stack([a0, a1], -2), torch.stack([a0, a1], -2))
    ni = inv(norm(sq[..., 0, :] + sq[..., 1, :]))
    return mul(torch.stack([a0, -a1], -2), ni.unsqueeze(-2))


class Fp:
    """The field interface the Jacobian formulas of ``ops/bls_g1.py`` take."""

    shape = (NLIMBS,)
    mul = staticmethod(mul)
    sqr = staticmethod(sqr)
    norm = staticmethod(norm)
    is_zero = staticmethod(is_zero)
    from_bytes = staticmethod(from_bytes)
    to_bytes = staticmethod(to_bytes)

    @staticmethod
    def zero_one(device):
        return from_ints(0, device), from_ints(1, device)


class Fp2:
    """The same interface over Fp2 (``[..., 2, 25]``, bytes ``[..., 2, 48]``)."""

    shape = (2, NLIMBS)
    mul = staticmethod(f2_mul)
    sqr = staticmethod(f2_sqr)
    norm = staticmethod(norm)

    @staticmethod
    def is_zero(x):
        z = is_zero(x)
        return z[..., 0] & z[..., 1]

    from_bytes = staticmethod(from_bytes)
    to_bytes = staticmethod(to_bytes)

    @staticmethod
    def zero_one(device):
        return from_ints([0, 0], device), from_ints([1, 0], device)
