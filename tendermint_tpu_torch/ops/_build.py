"""Builds the CUDA kernels of ``ops/csrc`` on first use, from the repo's
sources, into ``tendermint_tpu_torch/_kbuild/`` (git-ignored).

Two routes, both for sm_90a:
- ``torch.utils.cpp_extension.load`` with every source in one call, when
  ``ninja`` is present (ninja compiles the sources in parallel), under the
  build cache's lock, so a process killed mid-build leaves no baton that
  holds the next one. Only ``binding.cpp`` includes ``torch/extension.h``
  and it goes to the host compiler; nvcc sees only the plain-C ``.cu``
  files.
- otherwise one ``nvcc -c`` per ``.cu`` file, all started together, then
  ``nvcc -shared`` over the objects into a plain shared library bound with
  ``ctypes``. The library is named by its build key (the sources and
  headers of ``csrc/``, the flags, ``nvcc --version``) and built through
  ``libs/kernel_cache.build_once``: one build per key across processes,
  under a file lock, renamed into place when whole; a process that finds
  it loads it and runs no ``nvcc``. The nodes of a testnet started from
  one checkout, or a verify service and its tenants, share it.

Both expose the same launchers (``neg_pubkey_table``, ``verify_table``,
``verify_generic``, ``dbl_chain``, ``neg_pubkey_bigtable``,
``verify_bigcache``, ``challenge``, ``reduce_mod_l``, ``g1_aggregate``,
``g2_aggregate``, ``g1_add``, ``g2_add``, ``miller``, ``final_exp``,
``secp_verify``, ``sha256``), which take tensors and the raw CUDA stream
and raise when the launch is refused. The wrappers call them through
``launch``, which makes the operands' device the current one: a
``<<<...>>>`` launch runs on the current device, and a shard on
``cuda:1`` must not launch on ``cuda:0`` with a stream of ``cuda:1``.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only when a kernel is first called on the card. The
first build holds a lock, so threads that race into it (the verify
scheduler's prep and dispatch pools) build once and share the result.
``BUILD_INFO`` records the route, whether the build was reused and the
wall seconds.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import threading
import time

import torch

from ..libs import kernel_cache

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = kernel_cache.cache_dir()
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
KERNEL_SOURCES = [
    os.path.join(CSRC, "ed25519_kernels.cu"),
    os.path.join(CSRC, "sha512_kernels.cu"),
    os.path.join(CSRC, "bls_kernels.cu"),
    os.path.join(CSRC, "secp256k1_kernels.cu"),
    os.path.join(CSRC, "sha256_kernels.cu"),
]
BINDING_SOURCE = os.path.join(CSRC, "binding.cpp")

# route, reuse and wall seconds of the build, filled by kernels()
BUILD_INFO: dict = {}
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3"]

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = CUDA_HOME or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class _CtypesKernels:
    """The plain-C launchers through ctypes: pointers and the stream go in
    as c_void_p, ints as c_int; a nonzero return is the launch's error."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        vp, i = ctypes.c_void_p, ctypes.c_int
        verify_sig = [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i, vp]
        sig = {
            "tm_neg_pubkey_table": [vp, vp, vp, vp, i, vp],
            "tm_verify_table": verify_sig,
            "tm_verify_generic": [vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
            "tm_dbl_chain": [vp, vp, i, i, vp],
            "tm_neg_pubkey_bigtable": [vp, vp, vp, vp, i, vp],
            "tm_verify_bigcache": verify_sig,
            "tm_challenge": [vp, i, vp, vp, i, vp],
            "tm_reduce_mod_l": [vp, vp, i, vp],
            "tm_g1_aggregate": [vp, vp, vp, i, i, i, vp],
            "tm_g2_aggregate": [vp, vp, vp, i, i, i, vp],
            "tm_g1_add": [vp, vp, vp, i, vp],
            "tm_g2_add": [vp, vp, vp, i, vp],
            "tm_miller": [vp, vp, vp, vp, vp, vp, vp, i, vp],
            "tm_final_exp": [vp, vp, i, vp],
            "tm_secp_verify": [vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
            "tm_sha256": [vp, i, vp, vp, i, vp],
        }
        for name, args in sig.items():
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        lib.tm_error_string.argtypes = [i]
        lib.tm_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def _launched(self, err: int) -> None:
        if err != 0:
            msg = self._lib.tm_error_string(err).decode()
            raise RuntimeError(f"kernel launch failed: {msg}")

    def neg_pubkey_table(self, pub, tables, valid, kbytes, stream):
        self._launched(self._lib.tm_neg_pubkey_table(
            pub.data_ptr(), tables.data_ptr(), valid.data_ptr(),
            kbytes.data_ptr(), pub.shape[0], stream,
        ))

    def _verify_cached(self, fn, tables, tvalid, idx, r, s, k, s_ok, base,
                       kbytes, out, stream):
        self._launched(fn(
            tables.data_ptr(), tvalid.data_ptr(), tables.shape[0],
            idx.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(),
            s_ok.data_ptr(), base.data_ptr(), kbytes.data_ptr(),
            out.data_ptr(), out.shape[0], stream,
        ))

    def verify_table(self, *args):
        self._verify_cached(self._lib.tm_verify_table, *args)

    def verify_generic(self, pub, r, s, k, s_ok, base, kbytes, out, stream):
        self._launched(self._lib.tm_verify_generic(
            pub.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(),
            s_ok.data_ptr(), base.data_ptr(), kbytes.data_ptr(),
            out.data_ptr(), out.shape[0], stream,
        ))

    def dbl_chain(self, inp, out, n_dbl, stream):
        self._launched(self._lib.tm_dbl_chain(
            inp.data_ptr(), out.data_ptr(), inp.shape[0], n_dbl, stream,
        ))

    def neg_pubkey_bigtable(self, pub, tables, valid, kbytes, stream):
        self._launched(self._lib.tm_neg_pubkey_bigtable(
            pub.data_ptr(), tables.data_ptr(), valid.data_ptr(),
            kbytes.data_ptr(), pub.shape[0], stream,
        ))

    def verify_bigcache(self, *args):
        self._verify_cached(self._lib.tm_verify_bigcache, *args)

    def challenge(self, msg, n_blocks, out, stream):
        self._launched(self._lib.tm_challenge(
            msg.data_ptr(), msg.shape[1] // 128, n_blocks.data_ptr(),
            out.data_ptr(), out.shape[0], stream,
        ))

    def reduce_mod_l(self, digest, out, stream):
        self._launched(self._lib.tm_reduce_mod_l(
            digest.data_ptr(), out.data_ptr(), out.shape[0], stream,
        ))

    def _aggregate(self, fn, points, scratch, out, ntrees, b, nb, stream):
        self._launched(fn(
            points.data_ptr(), scratch.data_ptr(), out.data_ptr(), ntrees, b,
            nb, stream,
        ))

    def g1_aggregate(self, *args):
        self._aggregate(self._lib.tm_g1_aggregate, *args)

    def g2_aggregate(self, *args):
        self._aggregate(self._lib.tm_g2_aggregate, *args)

    def _add(self, fn, p, q, out, stream):
        self._launched(fn(
            p.data_ptr(), q.data_ptr(), out.data_ptr(), out.shape[0], stream,
        ))

    def g1_add(self, *args):
        self._add(self._lib.tm_g1_add, *args)

    def g2_add(self, *args):
        self._add(self._lib.tm_g2_add, *args)

    def miller(self, xp, yp, xq, yq, valid, scratch, out, stream):
        self._launched(self._lib.tm_miller(
            xp.data_ptr(), yp.data_ptr(), xq.data_ptr(), yq.data_ptr(),
            valid.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            xp.shape[0], stream,
        ))

    def final_exp(self, f, out, stream):
        self._launched(self._lib.tm_final_exp(
            f.data_ptr(), out.data_ptr(), f.shape[0], stream,
        ))

    def secp_verify(self, qx, qy, u1, u2, r, ok_in, gtab, out, stream):
        self._launched(self._lib.tm_secp_verify(
            qx.data_ptr(), qy.data_ptr(), u1.data_ptr(), u2.data_ptr(),
            r.data_ptr(), ok_in.data_ptr(), gtab.data_ptr(), out.data_ptr(),
            out.shape[0], stream,
        ))

    def sha256(self, msg, n_blocks, out, stream):
        self._launched(self._lib.tm_sha256(
            msg.data_ptr(), msg.shape[1] // 64, n_blocks.data_ptr(),
            out.data_ptr(), out.shape[0], stream,
        ))


def _csrc_files() -> list[str]:
    """Every file a kernel source may include: the build key hashes them."""
    return sorted(
        os.path.join(CSRC, name) for name in os.listdir(CSRC)
        if name.endswith((".cu", ".cuh", ".h"))
    )


def _build_ctypes() -> _CtypesKernels:
    nvcc = _nvcc()
    version = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True,
    ).stdout
    key = kernel_cache.build_key(_csrc_files(), NVCC_FLAGS, version)

    def build(out: str, workdir: str) -> None:
        objs = []
        procs = []
        for src in KERNEL_SOURCES:
            obj = os.path.join(workdir, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-Xcompiler", "-fPIC", "-o", obj, src],
            ))
        if any(proc.wait() != 0 for proc in procs):
            raise RuntimeError("nvcc failed on a kernel source")
        subprocess.run([nvcc, ARCH, "-shared", "-o", out, *objs], check=True)

    path, reused = kernel_cache.build_once(
        os.path.join(BUILD_DIR, f"libtm_kernels.{key}.so"), build
    )
    BUILD_INFO.update(reused=reused, path=path)
    return _CtypesKernels(path)


def _build_extension():
    """torch's ``load``, which reuses a finished build of the same sources
    and flags through its own hash and file baton. It runs under the build
    cache's ``fcntl`` lock, which the OS drops when its holder dies. torch's
    baton is a file (``lock`` in the build directory) that a process killed
    mid-build leaves behind, and every later ``load`` would wait on it for
    ever; under the lock no live process holds it, so a baton found there
    is a dead process's and is removed (ninja rebuilds the outputs whose
    commands its log does not record as finished)."""
    from torch.utils.cpp_extension import load

    so = os.path.join(BUILD_DIR, "tm_kernels.so")
    with kernel_cache.build_lock(so):
        with contextlib.suppress(FileNotFoundError):
            os.unlink(os.path.join(BUILD_DIR, "lock"))
        before = os.path.getmtime(so) if os.path.exists(so) else None
        lib = load(
            name="tm_kernels",
            sources=[BINDING_SOURCE, *KERNEL_SOURCES],
            build_directory=BUILD_DIR,
            extra_cflags=["-O2"],
            extra_cuda_cflags=["-O3", ARCH, "-std=c++17"],
            verbose=False,
        )
        after = os.path.getmtime(so) if os.path.exists(so) else None
    BUILD_INFO.update(reused=before is not None and before == after, path=so)
    return lib


def _build():
    """(launchers, route): one build from the sources."""
    from torch.utils.cpp_extension import is_ninja_available

    os.makedirs(BUILD_DIR, exist_ok=True)
    if is_ninja_available():
        return _build_extension(), "torch_extension"
    return _build_ctypes(), "nvcc_ctypes"


def kernels():
    """The built kernel launchers; builds once per process."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                t0 = time.perf_counter()
                lib, route = _build()
                BUILD_INFO.update(route=route, seconds=time.perf_counter() - t0)
                _lib = lib
    return _lib


def start_ptxas_report() -> list[subprocess.Popen]:
    """Start ``nvcc -Xptxas -v`` on each kernel source (registers, spills
    per kernel) in the background; read them with ``finish_ptxas_report``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in KERNEL_SOURCES:
        cubin = os.path.splitext(os.path.basename(src))[0] + ".cubin"
        procs.append(subprocess.Popen(
            [_nvcc(), ARCH, "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
             "-o", os.path.join(BUILD_DIR, cubin), src],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        ))
    return procs


def finish_ptxas_report(procs: list[subprocess.Popen]) -> str:
    outs = []
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{out}")
        outs.append(out)
    return "".join(outs)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call launcher `name` on `args` and the current stream of the device
    of the first, a tensor, with that device current (both build
    routes)."""
    with torch.cuda.device(args[0].device):
        getattr(kernels(), name)(*args, stream_of(args[0]))


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                  device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class DeviceCache:
    """Per-device tensors made once (constants, the basepoint table), safe
    to fill from several threads: the first caller on a device makes the
    tensor under a lock, every later one reads it."""

    def __init__(self, make):
        self._make = make
        self._by_device: dict[tuple[str, int | None], torch.Tensor] = {}
        self._lock = threading.Lock()

    def get(self, device) -> torch.Tensor:
        device = torch.device(device)
        key = (device.type, device.index)
        t = self._by_device.get(key)
        if t is None:
            with self._lock:
                t = self._by_device.get(key)
                if t is None:
                    t = self._make(device)
                    self._by_device[key] = t
        return t
