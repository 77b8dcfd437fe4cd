"""BLS12-381 G2 aggregation: the CUDA kernel and its plain version.

Counterpart of ``tendermint_tpu/ops/bls_g2.py``. ``g2_aggregate`` is the
public-key sum of ``crypto/bls_signatures`` (``aggregate_public_keys``
and the signer-key aggregate of ``verify_qc_items``): the tree and the
formulas of ``ops/bls_g1.py`` one tower level up, over
``[..., B, 3, 2, 48]`` Jacobian points on the twist (Fp2 coordinates as
(c0, c1) canonical little-endian bytes). Leading dimensions are
independent trees, so one launch sums the signer keys of a whole window
of quorum certificates.

``g2_add`` and ``g2_aggregate_sharded`` are the G2 twins of
``ops/bls_g1.py``'s ``g1_add`` and ``g1_aggregate_sharded``.

Each wrapper launches its kernel (``tm_g2_aggregate``, ``tm_g2_add``) on
a CUDA tensor and runs its plain version (``*_plain``) on a CPU one; it
counts its launches in ``<wrapper>.launches``. Both kernels run each
addition on one warp (``g2_add_w`` in ``ops/csrc/bls12_381_device.cuh``):
the tree a block of warps per tree, the pair sum a warp per pair.
"""

from __future__ import annotations

import torch

from ..crypto import bls12_381 as host
from . import bls_field as fp
from . import shard_reduce
from ._build import check_operand, launch, on_cuda
from .bls_g1 import add_plain, aggregate_plain, check_pair, padded_size


def g2_from_host(p) -> torch.Tensor:
    """Host Jacobian ((x0, x1), (y0, y1), (z0, z1)) -> ``[3, 2, 48]`` uint8."""
    raw = b"".join((v % host.P).to_bytes(48, "little") for c in p for v in c)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).reshape(3, 2, 48)


def g2_identity() -> torch.Tensor:
    """The identity ((0, 0), (1, 0), (0, 0)) as ``[3, 2, 48]`` uint8."""
    return g2_from_host(((0, 0), (1, 0), (0, 0)))


def g2_to_host(pt: torch.Tensor) -> tuple:
    """``[3, 2, 48]`` uint8 -> host Jacobian over Fp2."""
    rows = pt.cpu().reshape(3, 2, 48).tolist()
    return tuple(
        tuple(int.from_bytes(bytes(v), "little") for v in c) for c in rows
    )


def g2_aggregate_plain(points: torch.Tensor) -> torch.Tensor:
    """``[..., B, 3, 2, 48]`` uint8 -> ``[..., 3, 2, 48]`` canonical sum."""
    return aggregate_plain(fp.Fp2, points)


def g2_aggregate(points: torch.Tensor) -> torch.Tensor:
    """The tree sum; same operands as the plain version."""
    if not on_cuda(points):
        return g2_aggregate_plain(points)
    if points.dim() < 4:
        raise ValueError(
            f"points must be [..., B, 3, 2, 48], got {tuple(points.shape)}"
        )
    lead, b = points.shape[:-4], points.shape[-4]
    check_operand(points, "points", torch.uint8, (*lead, b, 3, 2, 48), points.device)
    ntrees = 1
    for n in lead:
        ntrees *= n
    nb = padded_size(b)
    out = torch.empty((*lead, 3, 2, 48), dtype=torch.uint8, device=points.device)
    if ntrees:
        scratch = torch.empty(
            ntrees * nb * 3 * 2 * 6, dtype=torch.int64, device=points.device
        )
        launch("g2_aggregate", points, scratch, out, ntrees, b, nb)
        g2_aggregate.launches += 1
    return out


g2_aggregate.launches = 0


def g2_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``[n, 3, 2, 48]`` + ``[n, 3, 2, 48]`` uint8 -> canonical sums."""
    return add_plain(fp.Fp2, p, q)


def g2_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The row-wise addition; same operands as the plain version."""
    if not on_cuda(p):
        return g2_add_plain(p, q)
    n = check_pair(p, q, (3, 2, 48))
    out = torch.empty_like(p)
    if n:
        launch("g2_add", p, q, out)
        g2_add.launches += 1
    return out


g2_add.launches = 0


def g2_aggregate_sharded(points, mesh) -> torch.Tensor:
    """``[B, 3, 2, 48]`` -> ``[3, 2, 48]``: the point sum over a device
    mesh (``ops/shard_reduce.py``)."""
    return shard_reduce.aggregate_sharded(
        points, mesh, g2_aggregate, g2_add, g2_identity()
    )


def g2_aggregate_sharded_plain(points, mesh) -> torch.Tensor:
    """The plain version: the same schedule on the CPU."""
    return shard_reduce.aggregate_sharded_plain(
        points, mesh, g2_aggregate_plain, g2_add_plain, g2_identity()
    )
