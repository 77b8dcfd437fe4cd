"""Builds the CUDA kernels of ``ops/csrc`` on first use, from the repo's
sources, into ``tendermint_tpu_torch/_kbuild/`` (git-ignored).

Two routes, both for sm_90a:
- ``torch.utils.cpp_extension.load`` with every source in one call, when
  ``ninja`` is present. Only ``binding.cpp`` includes ``torch/extension.h``
  and it goes to the host compiler; nvcc sees only the plain-C ``.cu``.
- otherwise ``nvcc -shared`` into a plain shared library bound with
  ``ctypes``.

Both expose the same four launchers (``neg_pubkey_table``,
``verify_table``, ``verify_generic``, ``dbl_chain``), which take tensors
and the raw CUDA stream and raise when the launch is refused. Nothing here
runs at import: the CPU tests import every module, and ``nvcc`` is needed
only when a kernel is first called on the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_kbuild"
)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
KERNEL_SOURCE = os.path.join(CSRC, "ed25519_kernels.cu")
BINDING_SOURCE = os.path.join(CSRC, "binding.cpp")

# route and wall seconds of the build, filled by kernels()
BUILD_INFO: dict = {}

_lib = None


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
        sig = {
            "tm_neg_pubkey_table": [vp, vp, vp, vp, i, vp],
            "tm_verify_table": [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
            "tm_verify_generic": [vp, vp, vp, vp, vp, vp, vp, vp, i, vp],
            "tm_dbl_chain": [vp, vp, i, i, vp],
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
            raise RuntimeError(f"ed25519 kernel launch failed: {msg}")

    def neg_pubkey_table(self, pub, tables, valid, kbytes, stream):
        self._launched(self._lib.tm_neg_pubkey_table(
            pub.data_ptr(), tables.data_ptr(), valid.data_ptr(),
            kbytes.data_ptr(), pub.shape[0], stream,
        ))

    def verify_table(self, tables, tvalid, idx, r, s, k, s_ok, base, kbytes,
                     out, stream):
        self._launched(self._lib.tm_verify_table(
            tables.data_ptr(), tvalid.data_ptr(), tables.shape[0],
            idx.data_ptr(), r.data_ptr(), s.data_ptr(), k.data_ptr(),
            s_ok.data_ptr(), base.data_ptr(), kbytes.data_ptr(),
            out.data_ptr(), out.shape[0], stream,
        ))

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


def _build_ctypes() -> _CtypesKernels:
    path = os.path.join(BUILD_DIR, "libtm_ed25519.so")
    subprocess.run(
        [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-o", path, KERNEL_SOURCE],
        check=True,
    )
    return _CtypesKernels(path)


def _build_extension():
    from torch.utils.cpp_extension import load

    return load(
        name="tm_ed25519_kernels",
        sources=[BINDING_SOURCE, KERNEL_SOURCE],
        build_directory=BUILD_DIR,
        extra_cflags=["-O2"],
        extra_cuda_cflags=["-O3", ARCH, "-std=c++17"],
        verbose=False,
    )


def kernels():
    """The built kernel launchers; builds once per process."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import is_ninja_available

        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        if is_ninja_available():
            _lib, route = _build_extension(), "torch_extension"
        else:
            _lib, route = _build_ctypes(), "nvcc_ctypes"
        BUILD_INFO.update(route=route, seconds=time.perf_counter() - t0)
    return _lib


def start_ptxas_report() -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v`` on the kernel source (registers, spills
    per kernel) in the background; read it with ``finish_ptxas_report``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return subprocess.Popen(
        [_nvcc(), ARCH, "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
         "-o", os.path.join(BUILD_DIR, "ptxas_report.cubin"), KERNEL_SOURCE],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def finish_ptxas_report(proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{out}")
    return out


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
