"""GF(2^255-19) in plain PyTorch: the reference version of the CUDA field code.

Counterpart of ``tendermint_tpu/ops/field25519.py``. The JAX package keeps
32 radix-2^8 int32 limbs because a TPU has no 64-bit integers; here a field
element is ``[..., 16] int64``, 16 limbs of 16 bits, little-endian. Only the
bytes at the boundary (``to_bytes`` / ``from_bytes``) are the contract: both
packages give the same canonical 32 bytes for the same value mod p.

Loose invariant: every op takes and returns limbs in [0, 2^17).
- ``mul``: limb products < 2^34, a column of 16 < 2^38; folding the high
  columns by 38 (2^256 = 38 mod p) keeps columns < 2^43.3; three carry
  passes bring them back under 2^16 + 114.
- ``sub``/``neg`` add a multiple of p whose every limb is >= 2^17
  (``_bias``), so limb-wise differences stay non-negative.
- ``canonical`` runs exact sequential carries and is used only at the
  boundary (encoding, equality, parity).

Everything is branch-free tensor code that runs on the CPU and on the card
alike; the CUDA kernels in ``ops/csrc`` are compared against it.
"""

from __future__ import annotations

import torch

NLIMBS = 16
RADIX = 16
MASK = (1 << RADIX) - 1
P = 2**255 - 19

_CONSTS: dict[tuple[str, int | None], dict[str, torch.Tensor]] = {}


def _int_limbs(x: int) -> list[int]:
    return [(x >> (RADIX * i)) & MASK for i in range(NLIMBS)]


def _bias_limbs() -> list[int]:
    """8p as 16 limbs each in [2^17, 2^17 + 2^16) (top limb ~2^18)."""
    rem = 8 * P
    out = []
    for _ in range(NLIMBS - 1):
        limb = (1 << 17) + (rem & MASK)
        out.append(limb)
        rem = (rem - limb) >> RADIX
    out.append(rem)
    assert all(v >= 1 << 17 for v in out)
    assert sum(v << (RADIX * i) for i, v in enumerate(out)) == 8 * P
    return out


_BIAS = _bias_limbs()


def _consts(device: torch.device) -> dict[str, torch.Tensor]:
    key = (device.type, device.index)
    c = _CONSTS.get(key)
    if c is None:
        i = torch.arange(NLIMBS, device=device)
        c = {
            # column of each limb product a_i * b_j in the 31-column sum
            "cols": (i[:, None] + i[None, :]).reshape(-1),
            "bias": torch.tensor(_BIAS, dtype=torch.int64, device=device),
        }
        _CONSTS[key] = c
    return c


def from_int(x: int, device="cpu") -> torch.Tensor:
    """Python int -> canonical limb vector [16] int64."""
    return torch.tensor(_int_limbs(x % P), dtype=torch.int64, device=device)


def constant(x: int, shape=(), device="cpu") -> torch.Tensor:
    return from_int(x, device).expand(*shape, NLIMBS)


def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, NLIMBS), dtype=torch.int64, device=device)


def ones(shape=(), device="cpu") -> torch.Tensor:
    z = zeros(shape, device)
    z[..., 0] = 1
    return z


def _carry(x: torch.Tensor) -> torch.Tensor:
    """One vectorized carry pass with the mod-p wrap (2^256 = 38)."""
    c = x >> RADIX
    r = x & MASK
    return r + torch.cat([c[..., -1:] * 38, c[..., :-1]], dim=-1)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + _consts(a.device)["bias"] - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _carry(_consts(a.device)["bias"] - a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 16x16 limb product, fold by 38, three carry passes."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)  # [..., 256]
    cols = torch.zeros(
        (*prod.shape[:-1], 2 * NLIMBS), dtype=torch.int64, device=a.device
    )
    cols.index_add_(-1, _consts(a.device)["cols"], prod)
    x = cols[..., :NLIMBS] + 38 * cols[..., NLIMBS:]
    for _ in range(3):
        x = _carry(x)
    return x


def sqr(x: torch.Tensor) -> torch.Tensor:
    return mul(x, x)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    assert 0 <= k <= 1 << 17, "mul_small constant out of verified range"
    return _carry(_carry(a * k))


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, limb-wise; cond is [...] bool broadcast over limbs."""
    return torch.where(cond.unsqueeze(-1), a, b)


def _sqr_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = mul(x, x)
    return x


def _pow_2_250_minus_1(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """z^(2^250 - 1) and z^11 — the shared prefix of invert and pow22523."""
    z2 = sqr(z)
    z9 = mul(sqr(sqr(z2)), z)
    z11 = mul(z9, z2)
    z2_5_0 = mul(sqr(z11), z9)
    z2_10_0 = mul(_sqr_n(z2_5_0, 5), z2_5_0)
    z2_20_0 = mul(_sqr_n(z2_10_0, 10), z2_10_0)
    z2_40_0 = mul(_sqr_n(z2_20_0, 20), z2_20_0)
    z2_50_0 = mul(_sqr_n(z2_40_0, 10), z2_10_0)
    z2_100_0 = mul(_sqr_n(z2_50_0, 50), z2_50_0)
    z2_200_0 = mul(_sqr_n(z2_100_0, 100), z2_100_0)
    z2_250_0 = mul(_sqr_n(z2_200_0, 50), z2_50_0)
    return z2_250_0, z11


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2). Returns 0 for z = 0."""
    z2_250_0, z11 = _pow_2_250_minus_1(z)
    return mul(_sqr_n(z2_250_0, 5), z11)


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3), the sqrt-ratio exponent."""
    z2_250_0, _ = _pow_2_250_minus_1(z)
    return mul(_sqr_n(z2_250_0, 2), z)


def _carry_exact(limbs: list[torch.Tensor]):
    """Sequential carry over the limb list: strict limbs + the top carry."""
    out, c = [], 0
    for v in limbs:
        v = v + c
        c = v >> RADIX
        out.append(v & MASK)
    return out, c


def canonical(x: torch.Tensor) -> torch.Tensor:
    """The unique representative in [0, p) as strict 16-bit limbs."""
    limbs = list(x.unbind(-1))
    # three wrapped rounds: value < 2^256, every limb strict
    for _ in range(3):
        limbs, c = _carry_exact(limbs)
        limbs[0] = limbs[0] + 38 * c
    # fold bit 255 (2^255 = 19) twice: value < 2^255
    for _ in range(2):
        q = limbs[-1] >> (RADIX - 1)
        limbs[-1] = limbs[-1] & (MASK >> 1)
        limbs[0] = limbs[0] + 19 * q
        limbs, _ = _carry_exact(limbs)
    # subtract p once if value >= p, i.e. if value + 19 reaches 2^255
    t, _ = _carry_exact([limbs[0] + 19] + limbs[1:])
    ge = (t[-1] >> (RADIX - 1)).bool()
    t[-1] = t[-1] & (MASK >> 1)
    return torch.where(ge.unsqueeze(-1), torch.stack(t, -1), torch.stack(limbs, -1))


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Canonical little-endian 32-byte encoding as [..., 32] uint8."""
    c = canonical(x)
    return torch.stack([c & 0xFF, c >> 8], dim=-1).flatten(-2).to(torch.uint8)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 little-endian -> loose limbs (all 256 bits kept)."""
    b = b.to(torch.int64)
    return b[..., 0::2] | (b[..., 1::2] << 8)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canonical(a) == canonical(b)).all(-1)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (canonical(x) == 0).all(-1)


def parity(x: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical value (the ed25519 sign bit)."""
    return canonical(x)[..., 0] & 1
