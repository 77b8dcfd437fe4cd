"""The port's ``abci/cli.py`` against the contract of
``tests/test_cli_debug.py:112``: the kvstore app server runs as a separate
process through the CLI's ``kvstore`` command (``python -c`` with a parser
built by ``abci.cli.register``: the port has no ``__main__`` yet), and the
commands echo, info, check_tx, deliver_tx, commit and query reach it over
the ABCI socket through the CLI. Interop on the same wire both ways: the
port's CLI against the JAX package's server and that package's CLI
against the port's, the same commands giving the same output lines (the
app hash after commit included). Every wait is bounded: the server's
listening line by ``select``, each CLI call by a thread join. Tolerance:
exact (output lines)."""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json
import os
import re
import select
import subprocess
import sys
import threading

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0

SERVE = r"""
import argparse, sys
from {root}.abci import cli
p = argparse.ArgumentParser()
cli.register(p.add_subparsers(dest="cmd"))
a = p.parse_args(["abci-cli", "kvstore", "--port", "0"])
sys.exit(a.fn(a))
"""

# the commands and what each prints first (as test_cli_debug.py checks)
SESSION = [
    (("echo", "hello-abci"), "hello-abci"),
    (("check_tx", "mykey=myvalue"), "code=0"),
    (("check_tx", "no-equals-sign"), "code=1"),
    (("deliver_tx", "mykey=myvalue"), "code=0"),
    (("deliver_tx", "0x6f746865723d3432"), "code=0"),  # other=42, hex
    (("commit",), "data=0x"),
    (("query", "mykey"), "myvalue"),
    (("query", "other"), "value=b'42'"),
    (("query", "absent"), "code=1"),
    (("info",), "last_block_height=1"),
]


@contextlib.contextmanager
def kvstore_server(root: str):
    """A child process serving the kvstore app through root's CLI on a
    free port; yields the port; killed on exit."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    srv = subprocess.Popen([sys.executable, "-c", SERVE.format(root=root)], cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    try:
        ready, _, _ = select.select([srv.stdout], [], [], WAIT_S)
        assert ready, f"{root}: the kvstore server never printed its listening line"
        line = srv.stdout.readline().decode()
        m = re.search(r"listening on (\d+) \(socket\)", line)
        assert m, line
        yield int(m.group(1))
    finally:
        srv.kill()
        srv.wait(timeout=WAIT_S)


def cli(root: str, port: int, *args: str) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of root's CLI command, run in this
    process through a parser built by abci.cli.register, bounded by a
    thread join."""
    mod = importlib.import_module(f"{root}.abci.cli")
    import argparse

    p = argparse.ArgumentParser()
    mod.register(p.add_subparsers(dest="cmd"))
    ns = p.parse_args(["abci-cli", *args, "--port", str(port)])
    out, err, rc = io.StringIO(), io.StringIO(), []

    def run():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc.append(ns.fn(ns))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WAIT_S)
    assert rc, f"{root} CLI {args} did not return inside {WAIT_S} s"
    return rc[0], out.getvalue(), err.getvalue()


def session(root: str, port: int) -> list[str]:
    lines = []
    for args, want in SESSION:
        rc, out, err = cli(root, port, *args)
        assert rc == 0, (args, err)
        assert want in out, (args, out)
        lines.append(out)
    return lines


@pytest.mark.parametrize("root", ["tendermint_tpu_torch", "tendermint_tpu"], ids=["port", "ref"])
def test_abci_cli_against_kvstore_server(root):
    """abci-cli parity: the package's kvstore server in a separate
    process, the commands through the same package's CLI."""
    with kvstore_server(root) as port:
        lines = session(root, port)
        rc, out, _ = cli(root, port, "info")
        assert rc == 0 and "data=kvstore" in out
    # the server is gone: the CLI reports it and fails
    rc, _, err = cli(root, port, "echo", "x")
    assert rc == 1 and "cannot reach ABCI server" in err
    # the kvstore's app hash after one commit of the two keys
    blob = json.dumps({"kv": {"mykey": "myvalue", "other": "42"}, "h": 1}, sort_keys=True)
    assert lines[5] == f"data=0x{hashlib.sha256(blob.encode()).hexdigest()}\n"


def test_cli_interop_both_ways_gives_the_same_lines():
    """The port's CLI against the JAX package's server and that package's
    CLI against the port's server: every command succeeds and both
    sessions print the same lines."""
    with kvstore_server("tendermint_tpu") as ref_port, \
            kvstore_server("tendermint_tpu_torch") as port_port:
        port_cli = session("tendermint_tpu_torch", ref_port)
        ref_cli = session("tendermint_tpu", port_port)
    assert port_cli == ref_cli
