"""The kernel build cache across processes (``libs/kernel_cache.py``,
``ops/_build.py``'s ``nvcc_ctypes`` route): several node processes started
together from one checkout build the kernel library once and load the same
file, and a later start runs no build.

There is no ``nvcc`` here, so each process's ``_build._nvcc`` names a Python
stand-in that logs every call (``--version``, ``-c`` and ``-shared``) and
links a real shared library with g++ whose ``tm_*`` launchers return 0; its
``-c`` sleeps, so the builds of processes released together overlap. Each
process builds into an empty directory of the test's own (``_build.BUILD_DIR``
rebound) with ``is_ninja_available`` patched to False, the route the smoke
exercises. With ``_build_ctypes``'s earlier lines (no key, no lock, fixed
object and library paths) every process runs its own build."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_PROCS = 4

NVCC_STUB = r'''
import os, subprocess, sys, time
log = sys.argv[0] + ".log"
args = sys.argv[1:]
def note(what):
    with open(log, "a") as f:
        f.write(f"{what} {os.getpid()}\n")
if args == ["--version"]:
    print("stand-in nvcc, release 0.0")
    sys.exit(0)
out = args[args.index("-o") + 1]
if "-shared" in args:
    note("shared")
    src = f"{out}.{os.getpid()}.c"
    names = """tm_neg_pubkey_table tm_verify_table tm_verify_generic tm_dbl_chain
    tm_neg_pubkey_bigtable tm_verify_bigcache tm_challenge tm_reduce_mod_l
    tm_g1_aggregate tm_g2_aggregate tm_g1_add tm_g2_add tm_miller tm_final_exp
    tm_secp_verify tm_sha256""".split()
    with open(src, "w") as f:
        for n in names:
            f.write(f"int {n}(void) {{ return 0; }}\n")
        f.write('const char *tm_error_string(int e) { return "stand-in"; }\n')
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, src], check=True)
    os.unlink(src)
else:
    note("compile")
    time.sleep(0.5)
    with open(out, "wb") as f:
        f.write(open(args[-1], "rb").read()[:64])
'''

# _build_ctypes as it stood before the build cache: every process compiles
# every source into the same object paths and links the same library path
OLD_BUILD_CTYPES = '''
def _build_ctypes() -> _CtypesKernels:
    objs = []
    procs = []
    for src in KERNEL_SOURCES:
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
             "-o", obj, src],
        ))
    if any(proc.wait() != 0 for proc in procs):
        raise RuntimeError("nvcc failed on a kernel source")
    path = os.path.join(BUILD_DIR, "libtm_kernels.so")
    subprocess.run([_nvcc(), ARCH, "-shared", "-o", path, *objs], check=True)
    return _CtypesKernels(path)
'''

CHILD = r'''
import json, os, sys, time
sys.modules["jax"] = None
build_dir, nvcc, lines, ready, go = sys.argv[1:6]
import torch.utils.cpp_extension as ce
ce.is_ninja_available = lambda: False
from tendermint_tpu_torch.ops import _build
_build.BUILD_DIR = build_dir
_build._nvcc = lambda: nvcc
if lines == "old":
    exec(OLD, _build.__dict__)
open(ready + "." + str(os.getpid()), "w").close()
deadline = time.monotonic() + 60
while not os.path.exists(go) and time.monotonic() < deadline:
    time.sleep(0.01)
lib = _build.kernels()
lib.neg_pubkey_table  # a bound launcher
print(json.dumps({"path": lib._lib._name, "reused": _build.BUILD_INFO.get("reused"),
                  "route": _build.BUILD_INFO["route"]}))
'''


def _start(tmp: pathlib.Path, lines: str, n: int) -> list[dict | None]:
    """Start n processes against tmp/kbuild, release them together, and
    return what each loaded (None for a process that failed)."""
    ready = tmp / f"ready{time.monotonic_ns()}"
    go = tmp / f"go{time.monotonic_ns()}"
    code = CHILD.replace("OLD", repr(OLD_BUILD_CTYPES))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / "kbuild"), str(tmp / "nvcc"),
             lines, str(ready), str(go)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(n)
    ]
    deadline = time.monotonic() + 90
    while len(list(tmp.glob(ready.name + ".*"))) < n and time.monotonic() < deadline:
        time.sleep(0.05)
    go.touch()
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0 or lines == "old", stderr[-3000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]) if p.returncode == 0 else None)
    return out


def _log(tmp: pathlib.Path) -> list[str]:
    path = tmp / "nvcc.log"
    return path.read_text().split()[::2] if path.exists() else []


@pytest.fixture
def stub(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + NVCC_STUB)
    nvcc.chmod(0o755)
    (tmp_path / "kbuild").mkdir()
    return tmp_path


@pytest.mark.parametrize("lines", ["port", "old"])
def test_concurrent_starts_build_once_and_a_restart_builds_nothing(stub, lines):
    """N_PROCS processes released together against one empty build
    directory: with the port's lines exactly one build runs (one
    ``nvcc -c`` per kernel source, one ``-shared``), every process loads
    the same file, one of them reports the build and the rest a reuse;
    a second start runs no ``nvcc`` but ``--version``. With the earlier
    lines every process builds, at every start."""
    from tendermint_tpu_torch.ops import _build

    first = _start(stub, lines, N_PROCS)
    calls = _log(stub)
    sources = len(_build.KERNEL_SOURCES)
    if lines == "old":
        # every process compiled (one that overwrote another's objects
        # mid-link may have failed), and a restart builds again
        assert calls.count("compile") == N_PROCS * sources, calls
        again = _start(stub, lines, 1)
        assert _log(stub).count("compile") == (N_PROCS + 1) * sources
        assert again[0] is None or again[0]["reused"] is None
        return
    assert {r["route"] for r in first} == {"nvcc_ctypes"}
    assert calls.count("shared") == 1, calls
    assert calls.count("compile") == sources, calls
    paths = {r["path"] for r in first}
    assert len(paths) == 1, paths
    path = pathlib.Path(paths.pop())
    assert path.parent == stub / "kbuild" and path.name.startswith("libtm_kernels.")
    assert sorted(r["reused"] for r in first) == [False] + [True] * (N_PROCS - 1)
    # no object or temporary directory is left beside the library
    assert sorted(p.name for p in (stub / "kbuild").iterdir()) == [path.name, path.name + ".lock"]

    again = _start(stub, lines, 2)
    assert _log(stub) == calls
    assert [r["path"] for r in again] == [str(path)] * 2
    assert all(r["reused"] for r in again)


def test_build_key_follows_sources_flags_and_compiler(tmp_path):
    from tendermint_tpu_torch.libs import kernel_cache

    a, b = tmp_path / "a.cu", tmp_path / "b.cuh"
    a.write_text("kernel a")
    b.write_text("header b")
    key = kernel_cache.build_key([a, b], ["-O3"], "nvcc 12.8")
    assert key == kernel_cache.build_key([a, b], ["-O3"], "nvcc 12.8")
    assert key != kernel_cache.build_key([a, b], ["-O2"], "nvcc 12.8")
    assert key != kernel_cache.build_key([a, b], ["-O3"], "nvcc 12.9")
    b.write_text("header b, edited")
    assert key != kernel_cache.build_key([a, b], ["-O3"], "nvcc 12.8")


def test_build_once_leaves_nothing_behind_a_failed_build(tmp_path):
    """A build that raises leaves no artifact and no work directory, and
    the next caller builds."""
    from tendermint_tpu_torch.libs import kernel_cache

    target = tmp_path / "lib.so"

    def fails(out, workdir):
        pathlib.Path(workdir, "half.o").write_text("x")
        raise RuntimeError("compiler failed")

    with pytest.raises(RuntimeError):
        kernel_cache.build_once(str(target), fails)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["lib.so.lock"]
    path, reused = kernel_cache.build_once(
        str(target), lambda out, workdir: pathlib.Path(out).write_text("ok")
    )
    assert (path, reused) == (str(target), False) and target.read_text() == "ok"
    assert kernel_cache.build_once(str(target), None) == (str(target), True)


def test_native_libraries_and_kernels_share_the_port_build_directory():
    from tendermint_tpu_torch.libs import kernel_cache
    from tendermint_tpu_torch.ops import _build

    assert _build.BUILD_DIR == kernel_cache.cache_dir()
    assert pathlib.Path(kernel_cache.cache_dir()) == ROOT / "tendermint_tpu_torch" / "_kbuild"
    assert pathlib.Path(kernel_cache.repo_root()) == ROOT


# torch's protocol around a build of `load` (cpp_extension._jit_compile):
# the baton file `lock` in the build directory, then ninja writes the
# library; `die` stops inside the build, as a process killed mid-build does
EXT_CHILD = r'''
import json, os, sys, time
sys.modules["jax"] = None
build_dir, mode, ready = sys.argv[1:4]
import torch.utils.cpp_extension as ce
from torch.utils.file_baton import FileBaton

def load(name, sources, build_directory, **kw):
    baton = FileBaton(os.path.join(build_directory, "lock"))
    if baton.try_acquire():
        try:
            with open(os.path.join(build_directory, name + ".so"), "wb") as f:
                f.write(b"half")
                if mode == "die":
                    f.flush()
                    open(ready, "w").close()
                    time.sleep(600)
                f.write(b" and whole")
        finally:
            baton.release()
    else:
        baton.wait()
    return name

ce.load = load
ce.is_ninja_available = lambda: True
from tendermint_tpu_torch.ops import _build
_build.BUILD_DIR = build_dir
_build.kernels()
print(json.dumps(_build.BUILD_INFO))
'''


def test_a_start_after_a_build_killed_midway_builds(tmp_path):
    """The torch_extension route: a process SIGKILLed inside torch's
    ``load`` leaves its baton file and a half-written library behind. The
    next start builds the library whole and leaves no baton, where with
    the baton taken as live it would wait for ever."""
    import signal

    kbuild, ready = tmp_path / "kbuild", tmp_path / "ready"
    kbuild.mkdir()

    def start(mode):
        return subprocess.Popen(
            [sys.executable, "-c", EXT_CHILD, str(kbuild), mode, str(ready)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

    dying = start("die")
    deadline = time.monotonic() + 60
    while not ready.exists() and time.monotonic() < deadline and dying.poll() is None:
        time.sleep(0.05)
    assert ready.exists(), dying.communicate()[1][-3000:]
    os.kill(dying.pid, signal.SIGKILL)
    dying.communicate()
    assert (kbuild / "lock").exists() and (kbuild / "tm_kernels.so").read_bytes() == b"half"

    restart = start("build")
    try:
        out, err = restart.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        restart.kill()
        restart.communicate()
        pytest.fail("the start after the killed build waited on its baton")
    assert restart.returncode == 0, err[-3000:]
    info = json.loads(out.strip().splitlines()[-1])
    assert info["route"] == "torch_extension" and info["reused"] is False
    assert (kbuild / "tm_kernels.so").read_bytes() == b"half and whole"
    assert not (kbuild / "lock").exists()
