"""The port's quorum-certificate path against the JAX package's, at small
size: 8 QC-capable validators, a window of 4 QCs.

Mirrors ``tests/test_qc.py``: the codec golden, assembly that isolates a
corrupt contribution, forged-aggregate and sub-quorum rejections, the
``qc_verify`` engine directly and through a started ``VerifyScheduler``'s
fn lane (``ValidatorSet.verify_commits_qc`` -> ``qc_dispatch`` -> engine).
Both packages take the same route by default (native pairing and MSM);
the port's process verifier is on ``device="cpu"``, so where a case sets
``TM_TPU_BLS_PAIRING_DEVICE=1`` or hides the native library its pairings
and sums take the plain versions of its BLS kernels. Both get the same
seeded keys and signatures, and the verdicts, certificates and error
messages must be equal. Tolerance: exact.
"""

import asyncio
import hashlib

import pytest
import torch

from tendermint_tpu.crypto import bls_signatures as ref_bls
from tendermint_tpu.crypto import ed25519 as ref_ed
from tendermint_tpu.libs.bits import BitArray as RefBitArray
from tendermint_tpu.types import block as ref_block
from tendermint_tpu.types import quorum_cert as ref_qc
from tendermint_tpu.types.block_id import BlockID as RefBlockID
from tendermint_tpu.types.part_set import PartSetHeader as RefPSH
from tendermint_tpu.types.validator import Validator as RefValidator
from tendermint_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from tendermint_tpu_torch import ops
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import bls_signatures as bls
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
from tendermint_tpu_torch.obs.ledger import DispatchLedger
from tendermint_tpu_torch.parallel.scheduler import VerifyScheduler, set_default_scheduler
from tendermint_tpu_torch.types import (
    BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader, Validator, ValidatorSet,
)
from tendermint_tpu_torch.types import quorum_cert as port_qc
from tendermint_tpu_torch.types.quorum_cert import QuorumCertificate

CHAIN = "qc-parity"
N_VALS = 8
N_QCS = 4

PORT = dict(ed=ed, bls=bls, BlockID=BlockID, PSH=PartSetHeader, Validator=Validator,
            ValidatorSet=ValidatorSet, Commit=Commit, CommitSig=CommitSig,
            Flag=BlockIDFlag, qc=port_qc)
REF = dict(ed=ref_ed, bls=ref_bls, BlockID=RefBlockID, PSH=RefPSH, Validator=RefValidator,
           ValidatorSet=RefValidatorSet, Commit=ref_block.Commit,
           CommitSig=ref_block.CommitSig, Flag=ref_block.BlockIDFlag, qc=ref_qc)


def _scalar(i: int) -> int:
    h = hashlib.sha256(b"qc-parity-bls%d" % i).digest()
    return int.from_bytes(h, "big") % (bls.c.R - 1) + 1


def _committee(ns):
    """(valset, {address: (ed25519 key, bls scalar)}) in one package. Keys
    are trusted G2 points (no proof-of-possession pairing), as a genesis
    file carries them; one key goes through pubkey_from_priv's PoP."""
    vals, keys = [], {}
    for i in range(N_VALS):
        k = ns["ed"].PrivKey.from_secret(b"qc-parity-%d" % i)
        s = _scalar(i)
        if i == 0:
            pub = ns["bls"].pubkey_from_priv(s).key
        else:
            pub = ns["bls"]._g2_mul_point(ns["bls"].c.G2_GEN, s)
        vals.append(ns["Validator"](k.public_key(), 10 + i,
                                    bls_pub_key=ns["bls"].g2_to_bytes(pub)))
        keys[k.public_key().address()] = (k, s)
    return ns["ValidatorSet"](vals), keys


def _bid(ns, tag: int):
    return ns["BlockID"](bytes([tag]) * 32, ns["PSH"](1, bytes([tag + 1]) * 32))


def _commit(ns, vs, keys, height: int, corrupt=None):
    """Every validator precommits with an ed25519 signature and a QC
    contribution; `corrupt` maps a validator index to replacement bytes."""
    bid = _bid(ns, height)
    msg = ns["qc"].qc_sign_bytes(CHAIN, height, 0, bid)
    h = ns["bls"].hash_to_g1(msg)
    sigs = []
    for i, v in enumerate(vs.validators):
        k, s = keys[v.address]
        sigs.append(ns["CommitSig"](ns["Flag"].COMMIT, v.address, 1_700_000_000 + i))
    commit = ns["Commit"](height, 0, bid, sigs)
    for i, v in enumerate(vs.validators):
        k, s = keys[v.address]
        sigs[i].signature = k.sign(commit.vote_sign_bytes(CHAIN, i))
        sigs[i].qc_signature = (corrupt or {}).get(i) or ns["bls"].g1_to_bytes(
            ns["bls"]._g1_mul_point(h, s)
        )
    return bid, commit


@pytest.fixture(scope="module")
def cpu_verifier():
    """The process verifier on the CPU, for this module only. The plain
    versions are thousands of small tensor operations: one intra-op
    thread keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        v = bv.BatchVerifier(device="cpu")
        mp.setattr(bv, "_default", v)
        yield v
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def window(cpu_verifier):
    """Both packages' committees and 4 assembled QCs; the port's QC 3
    then carries the valid aggregate of a sub-quorum subset under the full
    bitset (a forgery only the pairing check catches)."""
    out = {}
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, keys = _committee(ns)
        entries = []
        for h in range(1, N_QCS + 1):
            bid, commit = _commit(ns, vs, keys, h)
            qc = ns["qc"].assemble_qc(CHAIN, commit, vs)
            entries.append((bid, h, qc))
        out[name] = (vs, keys, entries)
    return out


def _forge_subquorum(ns, vs, keys, qc):
    """QC `qc` with the aggregate of only its first 4 signers' shares."""
    forged = ns["qc"].QuorumCertificate.decode(qc.encode())
    msg = qc.sign_bytes(CHAIN)
    h = ns["bls"].hash_to_g1(msg)
    shares = [ns["bls"]._g1_mul_point(h, keys[vs.validators[i].address][1])
              for i in range(4)]
    forged.agg_signature = ns["bls"].g1_to_bytes(ns["bls"].aggregate_signatures(shares))
    return forged


def test_qc_codec_roundtrip_golden():
    qc = QuorumCertificate(
        height=9, round=1, block_id=_bid(PORT, 2),
        signers=BitArray.from_indices(5, [0, 2, 4]), agg_signature=bytes(range(96)),
    )
    enc = qc.encode()
    golden = (
        "080910021a480a20" + "02" * 32 + "122408011220" + "03" * 32
        + "20052a011532" + "60" + bytes(range(96)).hex()
    )
    assert enc.hex() == golden
    ref = ref_qc.QuorumCertificate(
        height=9, round=1, block_id=_bid(REF, 2),
        signers=RefBitArray.from_indices(5, [0, 2, 4]), agg_signature=bytes(range(96)),
    )
    assert ref.encode() == enc
    back = QuorumCertificate.decode(enc)
    assert back == qc and back.signers.ones() == [0, 2, 4]


def test_assembled_certificates_equal_reference(window):
    pvs, _, pentries = window["port"]
    rvs, _, rentries = window["ref"]
    assert pvs.hash() == rvs.hash()
    for (_, _, pqc), (_, _, rqc) in zip(pentries, rentries):
        assert pqc is not None and pqc.num_signers() == N_VALS
        assert pqc.encode() == rqc.encode()


def _run_in_scheduler(sched, fn):
    async def go():
        await sched.start()
        try:
            return await asyncio.get_running_loop().run_in_executor(None, fn)
        finally:
            await sched.stop()

    set_default_scheduler(sched)
    try:
        return asyncio.run(go())
    finally:
        set_default_scheduler(None)


def test_verify_commits_qc_window_through_scheduler_lane(window, cpu_verifier):
    """The window as blocksync verifies it: one qc_verify engine round
    through a started scheduler, RLC multi-pairing and bisection; the
    sub-quorum forgery is the one False verdict, as in the JAX package."""
    verdicts = {}
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, keys, entries = window[name]
        entries = list(entries)
        bid, h, qc = entries[2]
        entries[2] = (bid, h, _forge_subquorum(ns, vs, keys, qc))
        if name == "ref":
            verdicts[name] = vs.verify_commits_qc(
                CHAIN, entries, engine=ref_qc.qc_verify_items_direct
            )
            continue
        ledger = DispatchLedger()
        sched = VerifyScheduler(verifier=cpu_verifier, ledger=ledger,
                                metrics=SchedulerMetrics(Registry("qc_parity")))
        ops.reset_launches()
        verdicts[name] = _run_in_scheduler(
            sched, lambda: vs.verify_commits_qc(CHAIN, entries)
        )
        rounds = [e for e in ledger.entries() if e["engine"] == "qc_verify"]
        assert len(rounds) == 1 and rounds[0]["rows"] == {"blocksync": N_QCS}
        assert not any(ops.kernel_launches().values())  # CPU: plain versions
    assert verdicts["port"] == verdicts["ref"] == [True, True, False, True]


def test_qc_window_gate_on_runs_plain_pairing(window, cpu_verifier, monkeypatch):
    """TM_TPU_BLS_PAIRING_DEVICE=1: the qc_verify engine's RLC checks and
    bisection run the plain pairing (check_pairs on the CPU) and give the
    JAX package's verdicts on the window with the sub-quorum forgery."""
    from tendermint_tpu_torch.ops import bls_pairing

    vs, keys, entries = window["port"]
    entries = list(entries)
    bid, h, qc = entries[2]
    entries[2] = (bid, h, _forge_subquorum(PORT, vs, keys, qc))
    checks = []
    real = bls_pairing.check_pairs
    monkeypatch.setattr(bls_pairing, "check_pairs",
                        lambda pairs, dev: checks.append(len(pairs)) or real(pairs, dev))
    monkeypatch.setenv("TM_TPU_BLS_PAIRING_DEVICE", "1")
    ops.reset_launches()
    got = vs.verify_commits_qc(CHAIN, entries, engine=port_qc.qc_verify_items_direct)
    assert not any(ops.kernel_launches().values())  # CPU: plain versions
    assert checks and checks[0] == N_QCS + 1  # one RLC check first
    assert got == [True, True, False, True]


def test_forged_aggregate_rejected(window):
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, _, entries = window[name]
        bid, h, qc = entries[0]
        forged = ns["qc"].QuorumCertificate.decode(qc.encode())
        forged.agg_signature = ns["bls"].g1_to_bytes(
            ns["bls"]._g1_mul_point(ns["bls"].hash_to_g1(qc.sign_bytes(CHAIN)), 12345)
        )
        engine = ns["qc"].qc_verify_items_direct
        with pytest.raises(ValueError, match="invalid quorum certificate aggregate"):
            vs.verify_commit_qc(CHAIN, bid, h, forged, engine=engine)
        forged.agg_signature = b"\xff" * 96  # garbage: False, not an error
        assert vs.verify_commits_qc(CHAIN, [(bid, h, forged)], engine=engine) == [False]
        vs.verify_commit_qc(CHAIN, bid, h, qc, engine=engine)
        vs.verify_commit_qc_trusting(CHAIN, qc, vs, engine=engine)


def test_sub_quorum_bitset_rejected(window):
    msgs = {}
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, _, entries = window[name]
        bid, h, qc = entries[1]
        sub = ns["qc"].QuorumCertificate.decode(qc.encode())
        bits = BitArray if name == "port" else RefBitArray
        sub.signers = bits.from_indices(N_VALS, [0, 1, 2, 3, 4])
        with pytest.raises(ValueError, match="voting power") as e1:
            vs.verify_commit_qc(CHAIN, bid, h, sub)
        sub.signers = bits.from_indices(N_VALS + 1, list(range(N_VALS)))
        with pytest.raises(ValueError, match="bitset size") as e2:
            vs.verify_commit_qc(CHAIN, bid, h, sub)
        msgs[name] = (str(e1.value), str(e2.value))
    assert msgs["port"] == msgs["ref"]


def test_assemble_isolates_corrupt_contribution(window, cpu_verifier):
    """A garbage contribution is bisected out (the QC ships with 7/8), and
    unparseable ones from the three heaviest validators (48 of 108) leave
    no quorum: the JAX package's certificates."""
    got = {}
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, keys, _ = window[name]
        wrong = ns["bls"].g1_to_bytes(ns["bls"].sign(999, b"wrong message"))
        _, commit = _commit(ns, vs, keys, 7, corrupt={1: wrong})
        qc = ns["qc"].assemble_qc(CHAIN, commit, vs)
        assert qc is not None and qc.num_signers() == N_VALS - 1
        assert not qc.signers.get(1)
        heaviest = sorted(range(N_VALS), key=lambda i: -vs.validators[i].voting_power)
        junk = {i: b"\x00" * 95 for i in heaviest[:3]}
        _, commit = _commit(ns, vs, keys, 7, corrupt=junk)
        got[name] = (qc.encode(), ns["qc"].assemble_qc(CHAIN, commit, vs))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] is None and got["ref"][1] is None


@pytest.mark.parametrize("n", [3, bls.DEVICE_AGGREGATE_MIN])
def test_aggregate_public_keys_equals_host_sum(n, cpu_verifier, monkeypatch):
    """Without the native library: below DEVICE_AGGREGATE_MIN the exact
    host loop, from it the plain G2 tree (the device route); a duplicate
    and the point at infinity among the keys. The sum equals the JAX
    package's host sum and verifies the matching aggregate signature."""
    from tendermint_tpu.crypto import bls12_381 as ref_c

    scalars = [_scalar(100 + i) for i in range(n - 2)]
    keys = [bls._g2_mul_point(bls.c.G2_GEN, s) for s in scalars]
    keys += [keys[0], bls.c.G2_INF]
    want = ref_c.G2_INF
    for k in keys:
        want = ref_c.g2_add(want, k)
    ops.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(bls.native, "native_lib", lambda build=True: None)
        agg = bls.aggregate_public_keys([bls.new_trusted_public_key(k) for k in keys])
    assert not any(ops.kernel_launches().values())  # CPU: plain versions
    assert ref_c.g2_eq(agg.key, want)
    msg = b"aggregate-keys"
    sig = bls.sign((sum(scalars) + scalars[0]) % bls.c.R, msg)
    pubs = [bls.new_trusted_public_key(k) for k in keys]
    assert bls.verify_aggregated_same_message(sig, msg, pubs)
    assert not bls.verify_aggregated_same_message(sig, msg, pubs[:-2])


def test_qc_engine_direct_batch_verdicts(window):
    """verify_qc_items over good, forged and unparseable items: one RLC
    round, bisection isolating the forged one."""
    got = {}
    for name, ns in (("port", PORT), ("ref", REF)):
        vs, _, entries = window[name]
        _, _, qc = entries[3]
        keys = b"".join(vs.validators[i].bls_pub_key for i in qc.signers.ones())
        good = (qc.sign_bytes(CHAIN), qc.agg_signature, keys)
        bad = (good[0], ns["bls"].g1_to_bytes(ns["bls"].sign(4, good[0])), keys)
        unparseable = (good[0], b"\x11" * 96, keys)
        got[name] = ns["bls"].verify_qc_items([good, bad, unparseable])
    assert got["port"] == got["ref"] == [True, False, False]
