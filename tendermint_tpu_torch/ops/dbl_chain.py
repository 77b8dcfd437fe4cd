"""Chains of ed25519 point doublings: the port of the repo's one Pallas
kernel, ``dbl_chain`` (``tools/microbench_pallas.py:106``).

The Pallas kernel keeps a batch tile of points as loose f32 limbs in VMEM
and doubles each 256 times without touching HBM. Here a point is
``[4, 32]`` canonical bytes (X, Y, Z, T, each < p) and a batch is
``[B, 4, 32] uint8``; the CUDA kernel runs a point on a group of four
lanes (``dbl_chain_x4``), each holding the whole point in registers (5 x
51-bit limbs) for the whole chain and computing one of each stage's four
independent products; lane l writes coordinate l. The formula is the
Pallas kernel's own (``curve25519.double``), so the projective output is
the same value mod p; ``crypto/convert.py`` maps the Pallas ``[4, 32, B]``
f32 layout to and from this one.
"""

from __future__ import annotations

import torch

from . import curve25519 as curve
from . import field25519 as fe
from ._build import launch

N_DBL = 256


def dbl_chain_plain(points: torch.Tensor, n_dbl: int = N_DBL) -> torch.Tensor:
    """[B, 4, 32] u8 -> [B, 4, 32] u8: n_dbl doublings per point."""
    p = fe.from_bytes(points)
    for _ in range(n_dbl):
        p = curve.double(p)
    return fe.to_bytes(p)


def dbl_chain(points: torch.Tensor, n_dbl: int = N_DBL) -> torch.Tensor:
    """The CUDA kernel on a CUDA tensor, the plain version on a CPU one."""
    if points.device.type == "cpu":
        return dbl_chain_plain(points, n_dbl)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if points.dtype != torch.uint8 or points.dim() != 3 or tuple(
        points.shape[1:]
    ) != (4, 32):
        raise ValueError(
            f"points must be [B, 4, 32] uint8, got {tuple(points.shape)} "
            f"{points.dtype}"
        )
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    if not 0 <= n_dbl < 2**31:
        raise ValueError(f"n_dbl out of range: {n_dbl}")
    out = torch.empty_like(points)
    if points.shape[0]:
        launch("dbl_chain", points, out, n_dbl)
        dbl_chain.launches += 1
    return out


dbl_chain.launches = 0
