"""The port's harnesses and operator tools of ``tools/`` held against the
reference's, on the CPU: ``verify_service_bench``, ``qc_bench``,
``bench_replay``, ``soak``, ``signer_harness`` and ``fsync_bench`` of
``tendermint_tpu_torch.tools`` (``lightserve_bench`` holds in
``test_torch_lightserve.py`` and ``test_torch_evidence.py``,
``pacing_report`` in ``test_torch_pacing.py``).

- ``verify_service_bench``: the seeded committee fixture byte for byte in
  both packages; the port's ``python -m tendermint_tpu_torch verify-service``
  child across a real process boundary (the twin of
  ``test_verify_service.py``'s end-to-end test); ``run_size`` across real
  OS processes at a tiny committee (the twin of its slow harness smoke,
  quick here: ~10 s);
- ``qc_bench.run_qc_catchup`` at 4 validators and 2 blocks in both
  packages: every verdict true (the tool asserts it) and the same proof
  sizes, compression and QC rounds;
- ``bench_replay`` at 4 commits x 8 validators in both packages, each as
  its command line: every window and per-block verdict true (the tool
  asserts them) over the same 32 signatures;
- ``soak`` for one seeded iteration in a child: converged;
- ``signer_harness`` in-proc: all six conformance checks;
- ``fsync_bench`` at 16 records: one JSON object with the reference's keys;
- the card-facing tools default to ``cuda`` and raise without it.

The port verifies on ``device="cpu"``; the JAX package on its host oracle
where a verifier can be handed in. Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

from .test_torch_consensus import cpu_verifier  # noqa: F401 (autouse)
from .test_torch_light import ref_host_verifier  # noqa: F401 (a fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NO_CUDA = "torch.cuda.is_available() is False"


def _run(args, timeout: float, **kw):
    return subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, **kw)


def _port_tool(name: str, *args: str, timeout: float = 120):
    return _run([sys.executable, "-m", f"tendermint_tpu_torch.tools.{name}", *args], timeout)


@pytest.fixture
def sock_dir():
    """A short directory for unix sockets (paths stay under 107 bytes)."""
    with tempfile.TemporaryDirectory(prefix="vsb") as d:
        yield d


# --- verify_service_bench ---------------------------------------------------------


def test_committee_fixture_is_byte_identical_in_both_packages():
    from tendermint_tpu_torch.tools import verify_service_bench as port
    from tools import verify_service_bench as ref

    p_ed, p_bls = port.committee_fixture(4)
    r_ed, r_bls = ref.committee_fixture(4)
    assert [(i.pubkey, i.msg, i.sig, i.key_type) for i in p_ed] == [
        (i.pubkey, i.msg, i.sig, i.key_type) for i in r_ed]
    assert p_bls == r_bls
    assert port.BATCH_HASH == ref.BATCH_HASH
    assert port.DEFAULT_SERVICE_MAX_BATCH == ref.DEFAULT_SERVICE_MAX_BATCH == 2048


def test_cli_service_process_end_to_end(sock_dir):
    """`python -m tendermint_tpu_torch verify-service --device cpu` across
    a real process boundary: readiness handshake, real ed25519 verdicts
    over the wire, and the service-side dump."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto.batch_verifier import SigItem
    from tendermint_tpu_torch.tools.verify_service_bench import _service_dump, _spawn_service

    from .test_torch_verify_service import connect

    sock = os.path.join(sock_dir, "cli.sock")
    proc = _spawn_service(sock, max_batch=256, timeout=120, device="cpu")
    try:

        async def run():
            remote = await connect(sock)
            pk = ed25519.PrivKey.from_secret(b"cli-e2e")
            msg = b"vote-bytes" + b"\x00" * 22
            good = SigItem(pk.public_key().data, msg, pk.sign(msg))
            bad = SigItem(pk.public_key().data, msg, b"\x00" * 64)
            v = await asyncio.wait_for(remote.submit([good, bad, good], "consensus"), 240)
            dump = await _service_dump(sock)
            await remote.stop()
            return v, dump

        v, dump = asyncio.run(run())
        assert v.tolist() == [True, False, True]
        assert dump["summary"]["rows_requested"] >= 3
        assert dump["per_client"]
        assert dump["service"]["pid"] == proc.pid
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_verify_service_bench_harness_smoke(sock_dir):
    """run_size across real OS processes at a tiny committee: real
    ed25519 + BLS verdicts, zero degrades, service ledger attached."""
    from tendermint_tpu_torch.tools.verify_service_bench import run_size

    row = run_size(2, heights=1, warm=1, max_procs=2, sock_dir=sock_dir, device="cpu")
    assert "error" not in row, row
    assert row["sig_verify"] == "real"
    assert row["processes"] == 2
    assert row["degrades"] == 0
    # measured window only (the warm height is excluded by design)
    assert row["remote_submissions"] >= 4  # 2 nodes x 2 lanes x 1 h
    assert row["service_ledger"]["rows_requested"] >= 8  # incl. warm
    assert row["per_client_tenants"] >= 2


def test_service_child_defaults_to_cuda(sock_dir):
    """Without `device` the service child asks for CUDA, which it does not
    find here: it never signals ready, and the error carries its reason."""
    from tendermint_tpu_torch.tools.verify_service_bench import _spawn_service

    with pytest.raises(RuntimeError, match="never signaled ready") as e:
        _spawn_service(os.path.join(sock_dir, "cuda.sock"), max_batch=256, timeout=60)
    assert NO_CUDA in str(e.value)


# --- qc_bench -----------------------------------------------------------------------


def test_qc_catchup_matches_the_reference(ref_host_verifier):  # noqa: F811
    """run_qc_catchup(sizes=(4,), blocks=2) on both packages: both windows
    verify both ways (the tool asserts every verdict), with the same proof
    sizes, compression and QC rounds."""
    from tendermint_tpu_torch.tools.qc_bench import run_qc_catchup as port_run
    from tools.qc_bench import run_qc_catchup as ref_run

    port = port_run(sizes=(4,), blocks=2, device="cpu")
    ref = ref_run(sizes=(4,), blocks=2)
    keys = ("validators", "blocks", "proof_bytes_full", "proof_bytes_qc",
            "proof_compression", "qc_rounds")
    assert [{k: r[k] for k in keys} for r in port["rows"]] == [
        {k: r[k] for k in keys} for r in ref["rows"]]
    assert port["proof_compression_at_max"] == ref["proof_compression_at_max"] == 4.9
    assert port["sizes"] == ref["sizes"] == [4]
    assert set(port) == set(ref) and set(port["rows"][0]) == set(ref["rows"][0])


# --- bench_replay -------------------------------------------------------------------


def test_bench_replay_verdicts_match_the_reference():
    """4 commits x 8 validators through each package's tool: the window
    and the per-block loop verify every commit (the tool asserts it) over
    the same 32 signatures."""
    port = _port_tool("bench_replay", "4", "8", "--device", "cpu", timeout=300)
    ref = _run([sys.executable, "tools/bench_replay.py", "4", "8"], 600)
    for out in (port, ref):
        assert out.returncode == 0, out.stderr[-3000:]
        lines = out.stdout.splitlines()
        assert lines[0] == "# building 4 commits x 8 validators..."
        assert "for 32 sigs" in lines[1] and lines[2].startswith("per-block (1 call/commit):")
        assert lines[3].startswith("speedup:")


# --- soak, signer_harness, fsync_bench -------------------------------------------


def test_soak_one_seeded_iteration_converges():
    out = _port_tool("soak", "--iters", "1", "--nodes", "4", "--height", "3",
                     "--seed", "0", "--device", "cpu", timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["ok"] is True and doc["iterations"] == 1, doc
    res = doc["results"][0]
    assert res["ok"] and res["forks"] == 1 and res["seed"] == 0
    assert set(res["heights"]) == {"n0", "n1", "n2", "n3"}
    assert all(h >= 3 for h in res["heights"].values())
    assert set(res["health"]) == set(res["heights"])


def test_signer_harness_in_proc_passes_every_check():
    out = _port_tool("signer_harness", timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PASSED 6/6 conformance checks" in out.stdout
    assert "4. double-sign refused ok" in out.stdout


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_fsync_bench_prints_the_references_keys(tmp_path):
    port = _port_tool("fsync_bench", "16", str(tmp_path / "port"), timeout=120)
    ref = _run([sys.executable, "tools/fsync_bench.py", "16", str(tmp_path / "ref")], 120)
    assert port.returncode == 0 and ref.returncode == 0, (port.stderr, ref.stderr)
    p, r = json.loads(port.stdout), json.loads(ref.stdout)
    assert _keys(p) == _keys(r)
    assert p["tool"] == "fsync_bench" and p["records"] == 16
    assert p["serial_write_sync"]["fsyncs"] == 16  # one fsync a record
    assert p["group_concurrent_c8"]["fsyncs"] <= 16


# --- the card is the default ------------------------------------------------------


@pytest.mark.parametrize("tool,args", [
    ("bench_replay", ["1", "1"]),
    ("qc_bench", []),
    ("soak", ["--iters", "1"]),
    ("lightserve_bench", ["--clients", "1", "--heights", "2"]),
])
def test_card_facing_tools_default_to_cuda(tool, args):
    """Without --device the tool verifies on CUDA, which it does not find
    here: it exits non-zero with the reason, and never falls back to the
    CPU."""
    out = _port_tool(tool, *args, timeout=120)
    assert out.returncode != 0
    assert NO_CUDA in out.stderr, out.stderr[-3000:]
