"""secp256k1 verification in the port against the JAX package: the plain
verify program (ops/secp256k1_kernel.verify_prehashed_plain) on crafted
rows, the BatchVerifier's mixed-key routes, and the mixed-key commit path
end to end (verify_commit, and a blocksync window through a started
VerifyScheduler).

The rows come from numpy seeds and fixed key seeds. The port runs with
``TM_TPU_SECP_DEVICE=1`` where a test says so, so its secp256k1 rows take
the kernel's plain version on the CPU; the JAX package runs its host
routes (native secp256k1 batch, host ed25519), which give the JAX
package's verdicts without compiling its device program (about seven
minutes on this CPU; the slow-marked test does compile it). Tolerance:
exact (bitmaps, verdicts, error messages).
"""

import asyncio
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tendermint_tpu import types as jtypes
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.crypto import secp_native as jnative
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.crypto.batch_verifier import BatchVerifier as JaxVerifier
from tendermint_tpu.crypto.batch_verifier import SigItem as JItem
from tendermint_tpu_torch import types as ttypes
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.crypto import secp_native as tnative
from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
from tendermint_tpu_torch.ops import secp256k1_kernel as tk

CHAIN = "torch-secp"


@pytest.fixture(autouse=True)
def one_thread():
    # the plain ladder is thousands of small tensor operations
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crafted():
    """The 64 crafted rows of chip_smoke, built with the port's modules,
    and their verdicts by the JAX package's rule on its host modules."""
    rows, _ = chip_smoke.secp_crafted_rows(tsecp, tnative, np.random.default_rng(11))
    jrows, want = chip_smoke.secp_crafted_rows(jsecp, jnative, np.random.default_rng(11))
    assert rows == jrows
    return chip_smoke.secp_row_arrays(np, tk.fe, rows), want


def test_verify_prehashed_plain_on_crafted_rows():
    """Every branch of the kernel's verdict: valid, flipped s, wrong
    message, cross key, ok_in False, P == Q in the ladder, R at infinity,
    x(R) >= n taken directly and through the wrapped compare, the forged
    wrap r = x - n + 2^256 (rejected), u1 = u2 = 0, padding."""
    arrs, want = _crafted()
    got = tk.verify_prehashed(*(torch.from_numpy(a) for a in arrs))
    assert got.dtype == torch.bool and got.tolist() == want
    assert 10 < sum(want) < 54


@pytest.mark.slow
def test_verify_prehashed_plain_matches_jitted_jax_program():
    """The same rows through the JAX package's jitted verify_prehashed (a
    compile of about seven minutes on this CPU)."""
    from tendermint_tpu.ops import secp256k1_kernel as jk

    arrs, want = _crafted()
    got = np.asarray(jk.verify_prehashed_jit(*(jnp.asarray(a) for a in arrs)))
    assert got.tolist() == want


def _mixed_items(n_secp: int):
    """ed25519 rows (one bad), n_secp secp256k1 rows (valid, flipped s,
    wrong message, cross key; a short signature and a non-point key among
    them), sr25519 rows (one bad), and a row of an unknown key type, as
    (key_type, pubkey, msg, sig) tuples."""
    rows = []
    for i in range(6):
        k = ted.PrivKey(bytes([i + 1]) * 32)
        msg = b"ed-%d" % i
        sig = k.sign(msg if i != 2 else b"other")
        rows.append(("ed25519", k.public_key().data, msg, sig))
    secp = [tsecp.PrivKey.from_secret(b"secp-%d" % i) for i in range(5)]
    for i in range(n_secp - 2):
        k = secp[i % 5]
        msg = b"secp-%d" % i
        sig = k.sign(msg)
        pub = k.public_key().data
        if i % 7 == 3:
            sig = sig[:63] + bytes([sig[63] ^ 4])
        elif i % 7 == 5:
            msg += b"!"
        elif i % 7 == 6:
            pub = secp[(i + 1) % 5].public_key().data
        rows.append(("secp256k1", pub, msg, sig))
    rows.append(("secp256k1", secp[0].public_key().data, b"m", b"\x01" * 10))
    rows.append(("secp256k1", b"\x02" + b"\x00" * 32, b"m", secp[0].sign(b"m")))
    sr = jsr.PrivKey.from_secret(b"sr-0")
    rows.append(("sr25519", sr.public_key().data, b"sr", sr.sign(b"sr")))
    rows.append(("sr25519", sr.public_key().data, b"sr!", sr.sign(b"sr")))
    rows.append(("foo", b"k" * 32, b"m", b"s" * 64))
    return rows


def _oracle(rows) -> list[bool]:
    mods = {"ed25519": jed, "secp256k1": jsecp, "sr25519": jsr}
    return [t in mods and mods[t].PubKey(p).verify(m, s) for t, p, m, s in rows]


def _set_gate(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("TM_TPU_SECP_DEVICE", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_SECP_DEVICE", value)


@pytest.mark.parametrize(
    "n_secp, env, jax_env",
    [
        (32, "1", None),  # at the gate: the port's kernel route, the JAX native route
        (31, "1", "1"),  # under the gate: both native, same env
        (32, None, None),  # gate off: both native, same env
    ],
)
def test_mixed_batch_matches_jax_verifier(monkeypatch, n_secp, env, jax_env):
    """A mixed batch through the port's BatchVerifier (ed25519 rows on the
    device path's plain versions) and the JAX package's: bitmaps equal,
    and equal to the host oracles."""
    rows = _mixed_items(n_secp)
    port = bv.BatchVerifier(device="cpu", min_device_batch=0,
                            shape_registry=ShapeRegistry())
    routes = []
    kernel_route = port._verify_secp_device
    monkeypatch.setattr(port, "_verify_secp_device",
                        lambda items: routes.append(len(items)) or kernel_route(items))
    _set_gate(monkeypatch, env)
    got = port.verify([bv.SigItem(p, m, s, t) for t, p, m, s in rows]).tolist()
    assert routes == ([n_secp] if env == "1" and n_secp >= 32 else [])
    _set_gate(monkeypatch, jax_env)
    ref = JaxVerifier(min_device_batch=100)
    want = ref.verify([JItem(p, m, s, t) for t, p, m, s in rows]).tolist()
    assert got == want == _oracle(rows)
    assert not all(want[6 : 6 + n_secp]) and any(want[6 : 6 + n_secp])


# --- the slice end to end: a 12-validator set, every third key secp256k1


def _signers(mod_ed, mod_secp):
    return [mod_secp.PrivKey.from_secret(b"val-%d" % i) if i % 3 == 2
            else mod_ed.PrivKey(bytes([40 + i]) * 32) for i in range(12)]


def _commit(mod, vset, signers, height, sigs=None):
    """(block_id, commit) of vset at height, signed by `signers` (by
    address) unless the signatures are given."""
    by_addr = {s.public_key().address(): s for s in signers or ()}
    bid = mod.BlockID(hash=hashlib.sha256(b"b%d" % height).digest(),
                      part_set_header=mod.PartSetHeader(
                          total=1, hash=hashlib.sha256(b"p%d" % height).digest()))
    cs = [mod.CommitSig(mod.BlockIDFlag.COMMIT, v.address, 1_700_000_000 + i)
          for i, v in enumerate(vset.validators)]
    commit = mod.Commit(height, 0, bid, cs)
    for i, v in enumerate(vset.validators):
        cs[i].signature = (sigs[i] if sigs is not None
                           else by_addr[v.address].sign(commit.vote_sign_bytes(CHAIN, i)))
    return bid, commit


def _pair_sets():
    tsig, jsig = _signers(ted, tsecp), _signers(jed, jsecp)
    tv = ttypes.ValidatorSet([ttypes.Validator(s.public_key(), 10 + i)
                              for i, s in enumerate(tsig)])
    jv = jtypes.ValidatorSet([jtypes.Validator(s.public_key(), 10 + i)
                              for i, s in enumerate(jsig)])
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    return tv, jv, tsig


def _tamper(sig: bytes) -> bytes:
    return sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]


def test_mixed_window_through_the_scheduler_matches_jax(monkeypatch):
    """8 commits of the mixed set (64 ed25519 and 32 secp256k1 rows, the
    secp256k1 rows on the kernel's plain version) as one blocksync batch
    from an executor thread through a started port VerifyScheduler;
    commit 5 carries tampered signatures of the heaviest validators (more
    than 1/3 of the power, secp256k1 among them). Verdicts equal the JAX
    package's. Then verify_commit on a commit with one tampered secp256k1
    signature fails with the JAX package's message."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import (
        VerifyScheduler, default_dispatch, set_default_scheduler,
    )

    tv, jv, tsig = _pair_sets()
    heavy = sorted(range(12), key=lambda i: -tv.validators[i].voting_power)[:5]
    assert any(tv.validators[i].pub_key.type_name == "secp256k1" for i in heavy)
    port_entries, ref_entries = [], []
    for h in range(1, 9):
        bid, commit = _commit(ttypes, tv, tsig, h)
        if h == 5:
            for i in heavy:
                commit.signatures[i].signature = _tamper(commit.signatures[i].signature)
        jbid, jcommit = _commit(jtypes, jv, None, h,
                                [c.signature for c in commit.signatures])
        port_entries.append((bid, h, commit))
        ref_entries.append((jbid, h, jcommit))
    monkeypatch.delenv("TM_TPU_SECP_DEVICE", raising=False)
    want = jv.verify_commits_light(CHAIN, ref_entries, verifier=JaxVerifier(min_device_batch=100))
    assert want == [True] * 4 + [False] + [True] * 3

    monkeypatch.setenv("TM_TPU_SECP_DEVICE", "1")
    port_v = bv.BatchVerifier(device="cpu", min_device_batch=0,
                              shape_registry=ShapeRegistry())
    routes = []
    kernel_route = port_v._verify_secp_device
    monkeypatch.setattr(port_v, "_verify_secp_device",
                        lambda items: routes.append(len(items)) or kernel_route(items))
    ledger = DispatchLedger()
    sched = VerifyScheduler(verifier=port_v, metrics=SchedulerMetrics(Registry("secp")),
                            ledger=ledger)
    set_default_scheduler(sched)
    try:
        async def run():
            await sched.start()
            try:
                return await asyncio.get_running_loop().run_in_executor(
                    None,
                    lambda: tv.verify_commits_light(
                        CHAIN, port_entries, verifier=default_dispatch("blocksync")),
                )
            finally:
                await sched.stop()

        got = asyncio.run(run())
    finally:
        set_default_scheduler(None)
    assert got == want
    assert routes == [32]
    rounds = [e for e in ledger.entries() if e["engine"] == "sig"]
    assert [e["rows"] for e in rounds] == [{"blocksync": 96}]

    # verify_commit: one tampered secp256k1 signature, the JAX message
    bad = max(i for i in range(12) if tv.validators[i].pub_key.type_name == "secp256k1")
    bid, commit = _commit(ttypes, tv, tsig, 9)
    commit.signatures[bad].signature = _tamper(commit.signatures[bad].signature)
    jbid, jcommit = _commit(jtypes, jv, None, 9, [c.signature for c in commit.signatures])
    with pytest.raises(ValueError) as ref_err:
        jv.verify_commit(CHAIN, jbid, 9, jcommit, verifier=JaxVerifier(min_device_batch=100))
    with pytest.raises(ValueError) as port_err:
        tv.verify_commit(CHAIN, bid, 9, commit, verifier=port_v)
    assert str(port_err.value) == str(ref_err.value) == f"wrong signature at index {bad}"
