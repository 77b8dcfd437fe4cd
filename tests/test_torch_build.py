"""The port's kernel build and per-device caches under concurrent first
use: the verify scheduler calls the verifier from its prep and dispatch
threads, so two threads can race into the first build. Runs on the CPU
with the build function replaced (no nvcc here)."""

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
