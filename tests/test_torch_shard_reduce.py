"""Kernel 13, the mesh-wide BLS point sum (``ops/shard_reduce.py``,
``bls_g1.g1_aggregate_sharded``, ``bls_g2.g2_aggregate_sharded``), on the
CPU: the port on 8 CPU shards (the kernels' plain versions) against the
JAX package's host oracle, ``tendermint_tpu.crypto.bls12_381``, and the
port's own 1-device tree. Counterparts of ``test_multichip.py``'s
``test_g1_aggregate_sharded_matches_host`` and
``test_g2_aggregate_sharded_matches_host``, plus the butterfly's
schedule, uneven and tiny batches, a 2-axis mesh and the add kernels'
plain versions on every branch. The JAX package's sharded programs
compile for minutes on the CPU: the slow-marked test compares them.
Tolerance: exact (affine points; bytes within the port).
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import bls12_381 as h
from tendermint_tpu_torch.ops import bls_g1, bls_g2, shard_reduce
from tendermint_tpu_torch.parallel import build_mesh
from tendermint_tpu_torch.parallel.mesh import Mesh

G1 = dict(
    mul=lambda k: h.g1_mul(h.G1_GEN, k), neg=h.g1_neg, add=h.g1_add, inf=h.G1_INF,
    affine=h.g1_to_affine, from_host=bls_g1.g1_from_host, to_host=bls_g1.g1_to_host,
    sharded=bls_g1.g1_aggregate_sharded, plain=bls_g1.g1_aggregate_sharded_plain,
    tree=bls_g1.g1_aggregate, add_points=bls_g1.g1_add,
)
G2 = dict(
    mul=lambda k: h.g2_mul(h.G2_GEN, k), neg=h.g2_neg, add=h.g2_add, inf=h.G2_INF,
    affine=h.g2_to_affine, from_host=bls_g2.g2_from_host, to_host=bls_g2.g2_to_host,
    sharded=bls_g2.g2_aggregate_sharded, plain=bls_g2.g2_aggregate_sharded_plain,
    tree=bls_g2.g2_aggregate, add_points=bls_g2.g2_add,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # the plain versions are many small operations


def _mesh8():
    return build_mesh(8, 1, "cpu")


def _host_sum(g, pts):
    acc = g["inf"]
    for p in pts:
        acc = g["add"](acc, p)
    return g["affine"](acc)


def _stack(g, pts):
    return torch.stack([g["from_host"](p) for p in pts])


@pytest.mark.parametrize("g, ks", [
    (G1, [3, 5, 7, 11, 13, 17, 19, 23]),
    (G2, [2, 9, 31, 4, 8, 15, 16, 42]),
], ids=["g1", "g2"])
def test_aggregate_sharded_matches_host(g, ks):
    """test_multichip's inputs over 8 shards: the host sum of k_i G, the
    plain schedule byte for byte, and the port's 1-device tree."""
    pts = _stack(g, [g["mul"](k) for k in ks])
    out = g["sharded"](pts, _mesh8())
    assert out.shape == pts.shape[1:]
    assert g["affine"](g["to_host"](out)) == g["affine"](g["mul"](sum(ks)))
    assert torch.equal(out, g["plain"](pts, _mesh8()))
    assert g["affine"](g["to_host"](g["tree"](pts))) == g["affine"](g["to_host"](out))


@pytest.mark.parametrize("g", [G1, G2], ids=["g1", "g2"])
@pytest.mark.parametrize("n", [1, 5, 13, 40])
def test_aggregate_sharded_sizes_and_branches(g, n):
    """Fewer points than shards, sizes that do not split evenly, and
    duplicates, opposites and the identity among the points (the add's
    doubling and identity branches, in the trees and the butterfly)."""
    rng = np.random.default_rng(n)
    base = [g["mul"](int(k)) for k in rng.integers(1, 1 << 30, max(1, n // 2))]
    pts = (base + base[: n // 4] + [g["neg"](p) for p in base[: n // 8]] + [g["inf"]] * 3)[:n]
    rng.shuffle(pts)
    t = _stack(g, pts)
    out = g["sharded"](t, _mesh8())
    assert g["affine"](g["to_host"](out)) == _host_sum(g, pts)
    assert torch.equal(out, g["plain"](t, _mesh8()))


@pytest.mark.parametrize("g", [G1, G2], ids=["g1", "g2"])
def test_aggregate_sharded_dcn_mesh(g):
    """A 2-axis ("dcn", "batch") mesh: the butterfly runs over both axes."""
    pts = [g["mul"](k) for k in range(1, 20)]
    out = g["sharded"](_stack(g, pts), build_mesh(4, 2, "cpu"))
    assert g["affine"](g["to_host"](out)) == _host_sum(g, pts)


def test_butterfly_schedule():
    """Shard sizes and the XOR partners of each round, major-to-minor;
    non-power-of-two axes raise, as the reference asserts."""
    assert [shard_reduce.shard_size(b, 8) for b in (1, 8, 9, 150, 256)] == [1, 1, 2, 32, 32]
    assert shard_reduce.butterfly_partners(_mesh8()) == [
        [i ^ s for i in range(8)] for s in (1, 2, 4)
    ]
    assert shard_reduce.butterfly_partners(build_mesh(4, 2, "cpu")) == [
        [i ^ 4 for i in range(8)], [i ^ 1 for i in range(8)], [i ^ 2 for i in range(8)]
    ]
    assert shard_reduce.butterfly_partners(Mesh(["cpu"])) == []
    for mesh in (Mesh(["cpu"] * 6), Mesh([["cpu"] * 2] * 3, ("dcn", "batch"))):
        with pytest.raises(ValueError, match="power-of-two"):
            bls_g1.g1_aggregate_sharded(_stack(G1, [h.G1_GEN]), mesh)


@pytest.mark.parametrize("g", [G1, G2], ids=["g1", "g2"])
def test_add_plain_every_branch(g):
    """g1_add / g2_add on a CPU tensor (the plain version): general
    sums, p + p, p + (-p), and the identity on either side, against the
    host adds; no launch is counted."""
    p, q = g["mul"](5), g["mul"](11)
    lhs = [p, p, p, g["inf"], p]
    rhs = [q, p, g["neg"](p), q, g["inf"]]
    before = g["add_points"].launches
    out = g["add_points"](_stack(g, lhs), _stack(g, rhs))
    assert g["add_points"].launches == before
    for row, a, b in zip(out, lhs, rhs):
        assert g["affine"](g["to_host"](row)) == g["affine"](g["add"](a, b))


@pytest.mark.slow
@pytest.mark.parametrize("g", ["g1", "g2"])
def test_aggregate_sharded_matches_jax_mesh_program(g):
    """Against the JAX package's g1/g2_aggregate_sharded on its 8-device
    CPU mesh (shard_map of the local trees and the ppermute butterfly):
    the same affine point, on 13 points (an uneven tail)."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from tendermint_tpu.ops import bls_g1 as jg1
    from tendermint_tpu.ops import bls_g2 as jg2

    jmesh = JaxMesh(np.array(jax.devices("cpu")[:8]), ("batch",))
    spec = G1 if g == "g1" else G2
    jmod = jg1 if g == "g1" else jg2
    pts = [spec["mul"](k) for k in range(3, 16)]
    ref = getattr(jmod, f"{g}_aggregate_sharded")(
        np.stack([getattr(jmod, f"{g}_from_host")(p) for p in pts]), jmesh)
    want = spec["affine"](getattr(jmod, f"{g}_to_host")(np.asarray(ref)))
    out = spec["sharded"](_stack(spec, pts), _mesh8())
    assert spec["affine"](spec["to_host"](out)) == want == _host_sum(spec, pts)
