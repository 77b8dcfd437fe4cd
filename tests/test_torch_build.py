"""The port's kernel build and per-device caches under concurrent first
use: the verify scheduler calls the verifier from its prep and dispatch
threads, so two threads can race into the first build; and the device
guard of every kernel launch. Runs on the CPU with the build function and
the CUDA device context replaced (no nvcc, no card here)."""

import contextlib
import pathlib
import re
import sys
import threading
import time

import torch

from tendermint_tpu_torch.ops import _build


def _race(fn, n_threads: int = 16):
    """Run fn from n_threads threads released together; their results."""
    start = threading.Barrier(n_threads)
    out = [None] * n_threads

    def worker(i):
        start.wait(timeout=10)
        out[i] = fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return out


def test_first_build_runs_once_under_threads(monkeypatch):
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)  # a build takes a while: every thread arrives
        return object(), "stub"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_build", slow_build)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    libs = _race(_build.kernels)
    assert len(calls) == 1
    assert all(lib is libs[0] for lib in libs)
    assert _build.BUILD_INFO["route"] == "stub"
    assert _build.kernels() is libs[0]  # later calls do not build


def test_device_cache_makes_once_per_device_under_threads():
    made = []

    def make(dev):
        made.append(dev)
        time.sleep(0.02)
        return torch.zeros(3, device=dev)

    cache = _build.DeviceCache(make)
    got = _race(lambda: cache.get("cpu"))
    assert len(made) == 1
    assert all(t is got[0] for t in got)
    assert cache.get(torch.device("cpu")) is got[0]


def test_launch_runs_under_the_operands_device(monkeypatch):
    """launch() makes the first operand's device current around the
    launcher call and passes that device's stream, on either build route
    (the route is whatever kernels() returned)."""
    events = []

    @contextlib.contextmanager
    def device(dev):
        events.append(("enter", dev))
        yield
        events.append(("exit", dev))

    class Launchers:
        def g1_add(self, *args):
            events.append(("launch", args))

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "kernels", Launchers)
    monkeypatch.setattr(_build, "stream_of", lambda t: ("stream", t.device))
    p = torch.empty(1, device="meta")
    _build.launch("g1_add", p, "q", "out")
    assert events == [
        ("enter", p.device),
        ("launch", (p, "q", "out", ("stream", p.device))),
        ("exit", p.device),
    ]


def test_every_wrapper_launches_through_the_guard():
    """No kernel wrapper calls a launcher but through _build.launch."""
    ops = pathlib.Path(_build.__file__).parent
    for path in sorted(ops.glob("*.py")):
        if path.name == "_build.py":
            continue
        src = path.read_text()
        assert not re.search(r"kernels\(\)\.|stream_of\(", src), path.name
    launched = {
        m for path in ops.glob("*.py")
        for m in re.findall(r'launch\(\s*"(\w+)"', path.read_text())
    }
    assert launched == {
        "neg_pubkey_table", "verify_table", "verify_generic", "dbl_chain",
        "neg_pubkey_bigtable", "verify_bigcache", "challenge", "reduce_mod_l",
        "g1_aggregate", "g2_aggregate", "g1_add", "g2_add", "miller",
        "final_exp", "secp_verify", "sha256",
    }
