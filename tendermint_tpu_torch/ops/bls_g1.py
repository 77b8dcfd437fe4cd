"""BLS12-381 G1 aggregation: the CUDA kernel and its plain version.

Counterpart of ``tendermint_tpu/ops/bls_g1.py``. ``g1_aggregate`` is the
signature-aggregation sum (``crypto/bls_signatures.aggregate_signatures``):
a tree over ``[..., B, 3, 48]`` Jacobian points, ``B`` padded to a power
of two with the identity, each level adding element ``2i`` to ``2i + 1``
as the JAX package does. The formulas are the JAX package's (add-2007-bl,
dbl-2009-l, masks for infinity, equal and opposite inputs, identity
``(0, 1, 0)``), so the canonical Jacobian result equals its
``g1_to_host`` exactly, and the kernel's equals the plain version's.

Leading dimensions are independent trees: ``[T, B, 3, 48]`` sums T trees
in one launch. Points are canonical little-endian bytes per coordinate
(``uint8``); any 48-byte value is read mod p.

``g1_add`` is the complete addition of two point batches (the same
formulas, one sum per row): the combiner of ``g1_aggregate_sharded``,
the mesh-wide sum of ``ops/shard_reduce.py`` (local trees of
``g1_aggregate`` and an XOR butterfly of ``g1_add``).

Each wrapper launches its kernel (``tm_g1_aggregate``, ``tm_g1_add``) on
a CUDA tensor and runs its plain version (``*_plain``) on a CPU one; it
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ..crypto import bls12_381 as host
from . import bls_field as fp
from . import shard_reduce
from ._build import check_operand, launch, on_cuda


def padded_size(b: int) -> int:
    """The tree's leaf count: b padded to a power of two, at least 2."""
    return 1 << max(1, (b - 1).bit_length())


# --- Jacobian formulas over a field interface (bls_field.Fp / Fp2) --------


def _identity(field, shape, device) -> torch.Tensor:
    zero, one = field.zero_one(device)
    pt = torch.stack([zero, one, zero])
    return pt.expand(*shape, *pt.shape)


def _where(mask, a, b, nfield):
    return torch.where(mask.reshape(*mask.shape, *([1] * (nfield + 1))), a, b)


def jac_double(field, p: torch.Tensor) -> torch.Tensor:
    """2p (tendermint_tpu/ops/bls_g1.py g1_double); identity when y or z
    is zero."""
    k = len(field.shape)
    x, y, z = p.unbind(-1 - k)
    a, b = field.sqr(torch.stack([x, y])).unbind(0)
    c, xb2, yz = field.mul(torch.stack([b, x + b, y]), torch.stack([b, x + b, z])).unbind(0)
    d = 2 * (xb2 - a - c)
    e = 3 * a
    f = field.sqr(e)
    x3 = f - 2 * d
    y3 = field.mul(e, d - x3) - 8 * c
    z3 = 2 * yz
    out = field.norm(torch.stack([x3, y3, z3], -1 - k))
    bad = field.is_zero(y) | field.is_zero(z)
    return _where(bad, _identity(field, bad.shape, p.device), out, k)


def jac_add(field, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q with the masks of tendermint_tpu/ops/bls_g1.py g1_add."""
    k = len(field.shape)
    x1, y1, z1 = p.unbind(-1 - k)
    x2, y2, z2 = q.unbind(-1 - k)
    z1z1, z2z2 = field.sqr(torch.stack([z1, z2])).unbind(0)
    u1, u2, y1z2, y2z1 = field.mul(
        torch.stack([x1, x2, y1, y2]), torch.stack([z2z2, z1z1, z2, z1])
    ).unbind(0)
    s1, s2 = field.mul(torch.stack([y1z2, y2z1]), torch.stack([z2z2, z1z1])).unbind(0)
    h = u2 - u1
    r2 = s2 - s1
    i = field.sqr(2 * h)
    j, v = field.mul(torch.stack([h, u1]), i).unbind(0)
    rr = 2 * r2
    rr2, s1j, zz = field.mul(
        torch.stack([rr, s1, z1 + z2]), torch.stack([rr, j, z1 + z2])
    ).unbind(0)
    x3 = rr2 - j - 2 * v
    y3 = field.mul(rr, v - x3) - 2 * s1j
    z3 = field.mul(zz - z1z1 - z2z2, h)
    added = field.norm(torch.stack([x3, y3, z3], -1 - k))

    same_x = field.is_zero(h)
    same_y = field.is_zero(r2)
    ident = _identity(field, same_x.shape, p.device)
    out = _where(same_x & ~same_y, ident, added, k)
    if bool((same_x & same_y).any()):
        out = _where(same_x & same_y, jac_double(field, p), out, k)
    out = _where(field.is_zero(z2), p, out, k)
    return _where(field.is_zero(z1), q, out, k)


def aggregate_plain(field, points: torch.Tensor) -> torch.Tensor:
    """Tree sum over the leaves axis of ``[..., B, 3, *field bytes]``."""
    k = len(field.shape)
    leaf_axis = points.dim() - 2 - k
    x = field.from_bytes(points)
    b = x.shape[leaf_axis]
    nb = padded_size(b)
    if nb != b:
        lead = x.shape[:leaf_axis]
        pad = _identity(field, (*lead, nb - b), x.device)
        x = torch.cat([x, pad], dim=leaf_axis)
    while x.shape[leaf_axis] > 1:
        x = x.unflatten(leaf_axis, (-1, 2))
        even, odd = x.select(leaf_axis + 1, 0), x.select(leaf_axis + 1, 1)
        x = jac_add(field, even, odd)
    return field.to_bytes(x.select(leaf_axis, 0))


# --- host conversions -----------------------------------------------------


def g1_from_host(p) -> torch.Tensor:
    """Host Jacobian (x, y, z) ints -> ``[3, 48]`` uint8."""
    raw = b"".join((c % host.P).to_bytes(48, "little") for c in p)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).reshape(3, 48)


def g1_identity() -> torch.Tensor:
    """The identity (0, 1, 0) as ``[3, 48]`` uint8."""
    return g1_from_host((0, 1, 0))


def g1_to_host(pt: torch.Tensor) -> tuple:
    """``[3, 48]`` uint8 -> host Jacobian ints."""
    rows = pt.cpu().reshape(3, 48).tolist()
    return tuple(int.from_bytes(bytes(r), "little") for r in rows)


# --- g1_aggregate ---------------------------------------------------------


def g1_aggregate_plain(points: torch.Tensor) -> torch.Tensor:
    """``[..., B, 3, 48]`` uint8 -> ``[..., 3, 48]`` canonical sum."""
    return aggregate_plain(fp.Fp, points)


def g1_aggregate(points: torch.Tensor) -> torch.Tensor:
    """The tree sum; same operands as the plain version."""
    if not on_cuda(points):
        return g1_aggregate_plain(points)
    if points.dim() < 3:
        raise ValueError(f"points must be [..., B, 3, 48], got {tuple(points.shape)}")
    lead, b = points.shape[:-3], points.shape[-3]
    check_operand(points, "points", torch.uint8, (*lead, b, 3, 48), points.device)
    ntrees = 1
    for n in lead:
        ntrees *= n
    nb = padded_size(b)
    out = torch.empty((*lead, 3, 48), dtype=torch.uint8, device=points.device)
    if ntrees:
        scratch = torch.empty(ntrees * nb * 3 * 6, dtype=torch.int64, device=points.device)
        launch("g1_aggregate", points, scratch, out, ntrees, b, nb)
        g1_aggregate.launches += 1
    return out


g1_aggregate.launches = 0


# --- g1_add and the mesh-wide sum -----------------------------------------


def add_plain(field, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row-wise p + q of two ``[n, 3, *field bytes]`` batches."""
    return field.to_bytes(jac_add(field, field.from_bytes(p), field.from_bytes(q)))


def check_pair(p: torch.Tensor, q: torch.Tensor, point_shape) -> int:
    """Raise unless p and q are ``[n, *point_shape]`` uint8 on one device;
    returns n."""
    if p.dim() != 1 + len(point_shape):
        raise ValueError(f"p must be [n, {point_shape}], got {tuple(p.shape)}")
    n = p.shape[0]
    check_operand(p, "p", torch.uint8, (n, *point_shape), p.device)
    check_operand(q, "q", torch.uint8, (n, *point_shape), p.device)
    return n


def g1_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``[n, 3, 48]`` + ``[n, 3, 48]`` uint8 -> ``[n, 3, 48]`` canonical."""
    return add_plain(fp.Fp, p, q)


def g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The row-wise addition; same operands as the plain version."""
    if not on_cuda(p):
        return g1_add_plain(p, q)
    n = check_pair(p, q, (3, 48))
    out = torch.empty_like(p)
    if n:
        launch("g1_add", p, q, out)
        g1_add.launches += 1
    return out


g1_add.launches = 0


def g1_aggregate_sharded(points, mesh) -> torch.Tensor:
    """``[B, 3, 48]`` -> ``[3, 48]``: the point sum over a device mesh, a
    ``g1_aggregate`` tree per shard and an XOR butterfly of ``g1_add``
    (``ops/shard_reduce.py``)."""
    return shard_reduce.aggregate_sharded(
        points, mesh, g1_aggregate, g1_add, g1_identity()
    )


def g1_aggregate_sharded_plain(points, mesh) -> torch.Tensor:
    """The plain version: the same schedule on the CPU."""
    return shard_reduce.aggregate_sharded_plain(
        points, mesh, g1_aggregate_plain, g1_add_plain, g1_identity()
    )
