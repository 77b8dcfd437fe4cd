"""The port's BLS routes follow the JAX package's order at every call site.

- Pairing checks run ``ops/bls_pairing.check_pairs`` only under
  ``TM_TPU_BLS_PAIRING_DEVICE=1``; otherwise the native library's
  ``pairing_check`` (host bigints without it). Counterpart of
  ``tests/test_ops_bls_pairing.py::test_bls_verify_routes_through_device``.
- Point sums take the native MSM when the library is present; without it
  the device tree from ``DEVICE_AGGREGATE_MIN`` points (and for every
  multi-key signer sum of a QC round), the exact host loop below.
- Where the device route is taken, a failure raises: no fallback.

Entry points of ``ops/bls_g1``, ``ops/bls_g2`` and ``ops/bls_pairing`` are
counted with a monkeypatch. The port runs with its process verifier on
``device="cpu"`` (plain versions); the JAX package on its default route.
Verdicts, certificates and sums must be equal. Tolerance: exact.
"""

import inspect

import pytest
import torch

from tendermint_tpu.crypto import bls_signatures as ref_bls
from tendermint_tpu_torch import ops
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import bls_native
from tendermint_tpu_torch.crypto import bls_signatures as bls
from tendermint_tpu_torch.ops import bls_g1, bls_g2, bls_pairing

from .test_torch_qc import CHAIN, PORT, REF, _commit, _committee, _scalar

GATE = "TM_TPU_BLS_PAIRING_DEVICE"


@pytest.fixture(scope="module", autouse=True)
def cpu_verifier():
    """The process verifier on the CPU, one intra-op thread (the plain
    pairing is thousands of small tensor operations)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(GATE, raising=False)
        v = bv.BatchVerifier(device="cpu")
        mp.setattr(bv, "_default", v)
        yield v
    torch.set_num_threads(threads)


@pytest.fixture
def calls(monkeypatch):
    """Counts every call of a function defined in the three device
    modules; each wrapper delegates to the original."""
    counts: dict[str, int] = {}
    for mod in (bls_g1, bls_g2, bls_pairing):
        for name, fn in list(vars(mod).items()):
            if not inspect.isfunction(fn) or fn.__module__ != mod.__name__:
                continue
            key = f"{mod.__name__.rsplit('.', 1)[1]}.{name}"

            def wrap(*a, _fn=fn, _key=key, **k):
                counts[_key] = counts.get(_key, 0) + 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, wrap)
    return counts


@pytest.fixture
def no_library(monkeypatch):
    """The native library hidden from the port's BLS module."""
    monkeypatch.setattr(bls.native, "native_lib", lambda build=True: None)


def _g1(ns, k):
    return ns["bls"]._g1_mul_point(ns["bls"].c.G1_GEN, k)


def _g2(ns, k):
    return ns["bls"]._g2_mul_point(ns["bls"].c.G2_GEN, k)


def test_gate_routes_scheme_checks_through_check_pairs(monkeypatch, calls):
    """Gate set: the 2-pairing verify runs check_pairs (plain on the CPU),
    good signature verifies, bad rejects. Gate unset: the same checks
    reach no device entry point. Both routes give the JAX package's
    verdicts."""
    sk = 0x42424242424242424242424242424242
    msg = b"device-pairing-route"
    rpk, rsig = ref_bls.new_trusted_public_key(_g2(REF, sk)), ref_bls.sign(sk, msg)
    want = [ref_bls.verify(rsig, m, rpk) for m in (msg, msg + b"!")]
    assert want == [True, False]
    pk = bls.new_trusted_public_key(_g2(PORT, sk))
    sig = bls.sign(sk, msg)

    assert [bls.verify(sig, m, pk) for m in (msg, msg + b"!")] == want
    assert not calls, calls

    monkeypatch.setenv(GATE, "1")
    ops.reset_launches()
    assert [bls.verify(sig, m, pk) for m in (msg, msg + b"!")] == want
    assert calls["bls_pairing.check_pairs"] == 2
    assert not any(ops.kernel_launches().values())  # CPU: plain versions


def test_gate_unset_qc_window_and_assembly_reach_no_device_entry_point(calls):
    """With the library present and the gate unset: QC assembly, the
    qc_verify engine over a window with a forged aggregate, a batch-point
    dual-sign batch and 64-point sums launch nothing on the device, and
    equal the JAX package's certificates, verdicts and sums."""
    got = {}
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, keys = _committee(ns)
        qcs = []
        for h in (1, 2, 3):
            _, commit = _commit(ns, vs, keys, h)
            qcs.append(ns["qc"].assemble_qc(CHAIN, commit, vs))
        items = []
        for qc in qcs:
            ks = b"".join(vs.validators[i].bls_pub_key for i in qc.signers.ones())
            items.append((qc.sign_bytes(CHAIN), qc.agg_signature, ks))
        forged = ns["bls"].g1_to_bytes(ns["bls"].sign(5, items[1][0]))
        items[1] = (items[1][0], forged, items[1][2])
        verdicts = ns["bls"].verify_qc_items(items)
        # the batch-point dual-sign check: registry keys over one batch hash
        registry = ns["bls"].BLSKeyRegistry()
        sigs = []
        for i, v in enumerate(vs.validators):
            s = _scalar(i)
            registry.register(v.pub_key.data, ns["bls"].new_trusted_public_key(_g2(ns, s)))
            sigs.append(ns["bls"].g1_to_bytes(ns["bls"].sign(s, b"batch-hash")))
        sigs[3] = sigs[4]
        dual = registry.batch_verifier()(
            [v.pub_key.data for v in vs.validators], b"batch-hash", sigs)
        pts = [_g1(ns, _scalar(100 + i)) for i in range(bls.DEVICE_AGGREGATE_MIN)]
        kps = [ns["bls"].new_trusted_public_key(_g2(ns, _scalar(200 + i)))
               for i in range(bls.DEVICE_AGGREGATE_MIN)]
        sums = (ns["bls"].g1_to_bytes(ns["bls"].aggregate_signatures(pts)),
                ns["bls"].g2_to_bytes(ns["bls"].aggregate_public_keys(kps).key))
        got[name] = ([q.encode() for q in qcs], verdicts, dual, sums)
    assert bls_native.native_lib() is not None
    assert not calls, calls
    assert got["port"] == got["ref"]
    assert got["port"][1] == [True, False, True]
    assert got["port"][2] == [True] * 3 + [False] + [True] * 4


def test_gate_failure_raises_no_fallback(monkeypatch):
    """Under the gate a device pairing failure raises out of verify; the
    JAX package would fall through to the host here."""
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setenv(GATE, "1")
    monkeypatch.setattr(bls_pairing, "check_pairs", broken)
    pk = bls.new_trusted_public_key(_g2(PORT, 7))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bls.verify(bls.sign(7, b"m"), b"m", pk)


def test_without_library_sums_take_the_device_tree(calls, no_library):
    """No native library: sums of DEVICE_AGGREGATE_MIN points and up run
    the device trees (ops/bls_g1, ops/bls_g2; their named entry points
    aggregate_signatures_device and aggregate_public_keys_device), smaller
    ones the host loop, and the QC engine's multi-key signer sums one
    device launch per round. The pairing runs on host bigints. Sums and
    verdicts equal the JAX package's (on its native route)."""
    n = bls.DEVICE_AGGREGATE_MIN
    scal = [_scalar(300 + i) for i in range(n)]
    ref_pts = [_g1(REF, s) for s in scal]
    ref_keys = [ref_bls.new_trusted_public_key(_g2(REF, s)) for s in scal]
    want_sig = ref_bls.g1_to_bytes(ref_bls.aggregate_signatures(ref_pts))
    want_key = ref_bls.g2_to_bytes(ref_bls.aggregate_public_keys(ref_keys).key)
    want_small = ref_bls.g1_to_bytes(ref_bls.aggregate_signatures(ref_pts[:3]))
    pts = list(ref_pts)  # host points are int tuples in both packages
    keys = [bls.new_trusted_public_key(k.key) for k in ref_keys]

    assert bls.g1_to_bytes(bls.aggregate_signatures(pts[:3])) == want_small
    assert not calls, calls
    assert bls.g1_to_bytes(bls.aggregate_signatures(pts)) == want_sig
    assert bls.g2_to_bytes(bls.aggregate_public_keys(keys).key) == want_key
    assert calls["bls_g1.g1_aggregate"] == 1 and calls["bls_g2.g2_aggregate"] == 1
    assert bls.g1_to_bytes(bls.aggregate_signatures_device(pts[:3])) == want_small
    assert bls.g2_to_bytes(bls.aggregate_public_keys_device(keys)) == want_key

    # the QC engine: two multi-key items, one launch
    calls.clear()
    msg = b"qc-no-library"
    h = bls.hash_to_g1(msg)
    ks = b"".join(bls.g2_to_bytes(k.key) for k in keys[:5])
    agg = bls.g1_to_bytes(bls.c.g1_mul(h, sum(scal[:5]) % bls.c.R))
    bad = bls.g1_to_bytes(bls.c.g1_mul(h, sum(scal[:4]) % bls.c.R))
    items = [(msg, agg, ks), (msg, bad, ks)]
    assert bls.verify_qc_items(items) == ref_bls.verify_qc_items(items) == [True, False]
    assert calls["bls_g2.g2_aggregate"] == 1
    assert "bls_pairing.check_pairs" not in calls


def test_without_library_device_sum_failure_raises(monkeypatch, no_library):
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(bls_g1, "g1_aggregate", broken)
    pts = [_g1(PORT, _scalar(400 + i)) for i in range(bls.DEVICE_AGGREGATE_MIN)]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bls.aggregate_signatures(pts)
