"""Mesh-wide point aggregation: a local tree per shard, then an XOR
butterfly.

Counterpart of ``tendermint_tpu/ops/shard_reduce.py:48``
``aggregate_sharded``, with the same schedule:

1. pad B points with the identity to ``per * n`` (n the mesh size, per
   the next power of two >= ceil(B / n)); shard i takes points
   ``[i * per, (i + 1) * per)`` onto ``mesh.devices.flat[i]``;
2. each shard sums its points by the halving tree (the ``tree`` wrapper:
   ``g1_aggregate`` / ``g2_aggregate``, one launch per shard);
3. for every mesh axis and ``step = 1, 2, ...`` below its size, every
   shard adds the partial of the shard whose coordinate on that axis is
   its own XOR ``step``: a copy of the partner's point to this shard's
   device (a peer copy between two cards, none on one) and one launch of
   the ``add`` wrapper (``g1_add`` / ``g2_add``, the complete addition of
   two point batches);
4. every shard now holds the sum; shard 0's is returned.

Every axis must be a power of two. Each shard's launches run on its own
device, and every shard of a round is launched before the next round
reads any result. Points are canonical bytes, ``[B, 3, 48]`` (G1) or
``[B, 3, 2, 48]`` (G2). Within a package the bytes are exact (the kernel
and the plain version run the same operations in the same order);
across packages parity is the affine point: the JAX package keeps its
own limb form of the Jacobian coordinates.
"""

from __future__ import annotations

import numpy as np
import torch


def shard_size(b: int, n: int) -> int:
    """Points per shard: the next power of two >= ceil(b / n)."""
    per = max(1, -(-b // n))
    return 1 << (per - 1).bit_length()


def butterfly_partners(mesh) -> list[list[int]]:
    """One list per butterfly round: round r maps shard i (flat,
    major-to-minor) to its partner. Raises unless every axis is a power
    of two."""
    grid = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    rounds = []
    for k, ax in enumerate(mesh.axis_names):
        size = int(mesh.shape[ax])
        if size & (size - 1):
            raise ValueError(
                f"butterfly all-reduce needs power-of-two axes, got {ax}={size}"
            )
        step = 1
        while step < size:
            rounds.append(np.take(grid, np.arange(size) ^ step, axis=k).ravel().tolist())
            step *= 2
    return rounds


def _schedule(points, mesh, tree, add, identity, devices) -> torch.Tensor:
    pts = torch.as_tensor(points)
    n = int(mesh.devices.size)
    rounds = butterfly_partners(mesh)
    b = pts.shape[0]
    per = shard_size(b, n)
    if per * n != b:
        pad = identity.to(pts.device).expand(per * n - b, *identity.shape)
        pts = torch.cat([pts, pad])
    # the local trees: every shard launched before any result is read
    x = [
        tree(pts[i * per : (i + 1) * per].unsqueeze(0).to(d))
        for i, d in enumerate(devices)
    ]
    for partner in rounds:
        moved = [x[p].to(d, non_blocking=True) for p, d in zip(partner, devices)]
        x = [add(mine, theirs) for mine, theirs in zip(x, moved)]
    return x[0][0]


def aggregate_sharded(points, mesh, tree, add, identity) -> torch.Tensor:
    """Sum ``[B, *point]`` uint8 points over the mesh -> ``[*point]`` on
    the mesh's first device. `tree` sums ``[1, per, *point]`` to
    ``[1, *point]``, `add` adds two ``[1, *point]`` batches, `identity` is
    the ``[*point]`` identity."""
    return _schedule(points, mesh, tree, add, identity, list(mesh.devices.flat))


def aggregate_sharded_plain(points, mesh, tree, add, identity) -> torch.Tensor:
    """The same schedule with every shard on the CPU: with the plain tree
    and add, the plain version of ``aggregate_sharded`` for the mesh's
    shape."""
    cpu = [torch.device("cpu")] * int(mesh.devices.size)
    return _schedule(torch.as_tensor(points).cpu(), mesh, tree, add, identity, cpu)
