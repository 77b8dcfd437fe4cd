"""The port's big tier against the JAX package's BatchVerifier.

Twenty rows (bucket 32) with ``bigtable_min=8`` go through the port
(device="cpu": the kernels' plain versions) and the reference, with
challenges hashed on the host and on the device (``device_challenge_min=0``),
and through the port on big-tier tables that JAX built and
``crypto/convert`` carried over. Rows: valid, tampered, s >= L, a
non-canonical and a small-order key. Tolerance: exact bitmap equality,
also against the host oracle.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.batch_verifier import BatchVerifier as JaxVerifier
from tendermint_tpu_torch.crypto import convert

from .test_torch_batch_verifier import _items, _jax_items, _oracle, _port


@pytest.fixture(scope="module")
def big_ref():
    """Twenty rows (bucket 32) and two JAX verifiers with bigtable_min=8
    sharing one big-tier store: host challenges, and device challenges
    (device_challenge_min=0)."""
    items = _items(20, seed=21)
    host_hash = JaxVerifier(min_device_batch=0, bigtable_min=8)
    want_host = host_hash.verify(_jax_items(items))
    dev_hash = JaxVerifier(min_device_batch=0, bigtable_min=8, device_challenge_min=0)
    dev_hash._big = host_hash._big
    want_dev = dev_hash.verify(_jax_items(items))
    return items, host_hash, want_host.tolist(), want_dev.tolist()


@pytest.mark.parametrize("dcm, tier", [(None, "big"), (0, "big_msgs")])
def test_big_tier_matches_reference(big_ref, dcm, tier):
    items, _, want_host, want_dev = big_ref
    port = _port(min_device_batch=0, bigtable_min=8, device_challenge_min=dcm)
    got = port.verify(items).tolist()
    assert got == (want_host if dcm is None else want_dev) == _oracle(items)
    assert any(got) and not all(got)
    tiers = port._registry.buckets_by_tier()
    assert tiers == {"build_big": (32,), tier: (32,)}
    assert port._big.tables.shape == (128, 64, 16, 4, 32)
    assert port._small.tables is None  # the big tier built no small table


def test_big_tier_on_tables_jax_built(big_ref):
    items, ref, want, _ = big_ref
    port = _port(min_device_batch=0, bigtable_min=8)
    cache = ref._big
    convert.install_table_cache(
        port, dict(cache._idx), np.asarray(cache.tables), np.asarray(cache.valid)
    )
    port._big._build_fn = None  # any table build would fail loudly
    assert port.verify(items).tolist() == want
    assert port._registry.buckets_by_tier() == {"big": (32,)}
    assert torch.equal(port._big.tables, torch.from_numpy(np.array(cache.tables)))
