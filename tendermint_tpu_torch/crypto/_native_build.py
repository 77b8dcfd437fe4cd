"""Shared build-or-load machinery for the native C++ fast paths.

The port's native libraries (_tmbls.so, the BLS12-381 host fast path;
_tmsecp.so, the secp256k1 host verify route; _tmcrypto.so, the
ChaCha20-Poly1305 AEAD of the p2p secret connection) are compiled from the
repo's native/<name>.cpp on first use, into the port's
own build directory tendermint_tpu_torch/_kbuild/ (git-ignored): the JAX
package's libraries are never loaded. Staleness is decided by a SHA-256
of the source embedded in a sidecar file (<so>.srchash), not by mtimes:
a fresh clone gives source and .so identical checkout mtimes, which
under an mtime rule would silently keep loading a stale committed
binary after source edits (advisor finding, round 3). Content hashing
makes the decision deterministic and clone-safe.

Loads return None when neither a matching .so nor a compiler is
available; callers fall back to pure Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence


_host_tag_cache: Optional[str] = None


def _host_tag() -> str:
    """ISA fingerprint folded into the build hash: -march=native emits
    host-specific instructions, so a .so built on one CPU must not be
    dlopen'd from a shared checkout (NFS home, multi-node testnet dir)
    by a host with different CPU features — that's a SIGILL, not a
    catchable exception."""
    global _host_tag_cache
    if _host_tag_cache is None:
        feat = ""
        try:
            with open("/proc/cpuinfo", "r") as f:
                for line in f:
                    if line.startswith(("flags", "Features")):
                        feat = line
                        break
        except OSError:
            pass
        if not feat:
            import platform

            feat = platform.machine() + platform.processor()
        _host_tag_cache = hashlib.sha256(feat.encode()).hexdigest()[:16]
    return _host_tag_cache


def _src_hash(src: str) -> Optional[str]:
    """Hash of the translation unit: the .cpp plus every native/*.h it
    could include (generated asm headers live there) — a header edit
    must invalidate the cached .so just like a .cpp edit."""
    try:
        h = hashlib.sha256()
        with open(src, "rb") as f:
            h.update(f.read())
        import glob

        for hdr in sorted(glob.glob(os.path.join(os.path.dirname(src), "*.h"))):
            with open(hdr, "rb") as f:
                h.update(f.read())
        return h.hexdigest()
    except OSError:
        return None


def _stored_hash(so_path: str) -> Optional[str]:
    try:
        with open(so_path + ".srchash", "r") as f:
            return f.read().strip()
    except OSError:
        return None


def build_or_load(so_name: str, src_name: str, timeout: int = 180) -> Optional[ctypes.CDLL]:
    """Compile native/<src_name> into tendermint_tpu_torch/_kbuild/
    <base>.<hosttag>.so if the source hash differs from the recorded one,
    then dlopen it.

    The host-ISA tag lives in the FILENAME, making the artifact per-host:
    on a shared checkout (NFS home, multi-node testnet dir) two
    different-CPU hosts each keep their own .so instead of clobbering a
    shared one — and a host can never dlopen another host's
    -march=native machine code (SIGILL, not a catchable error). A .so
    without this host's tag is never loaded, even as a fallback."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(pkg_root)
    build_dir = os.path.join(pkg_root, "_kbuild")
    base, ext = os.path.splitext(so_name)
    so_path = os.path.join(build_dir, f"{base}.{_host_tag()}{ext}")
    src = os.path.join(repo_root, "native", src_name)

    want = _src_hash(src)
    if want is not None:
        os.makedirs(build_dir, exist_ok=True)
    have_so = os.path.exists(so_path)
    fresh = have_so and want is not None and _stored_hash(so_path) == want
    if not fresh:
        if want is None and not have_so:
            return None
        if want is not None:
            # compile to a pid-suffixed temp and rename into place: the
            # .so lives in the shared package dir, so a concurrent
            # process (multi-node testnet from one checkout) must never
            # dlopen a half-written file or interleave two g++ links
            tmp = so_path + f".build.{os.getpid()}"
            built = False
            # -march=native is a measurable win for the 6x64 Montgomery
            # chains; fall back to plain -O3 where the toolchain rejects it
            for extra in (["-march=native", "-funroll-loops"], []):
                try:
                    subprocess.run(
                        ["g++", "-O3", *extra, "-shared", "-fPIC",
                         "-o", tmp, src],
                        check=True,
                        capture_output=True,
                        timeout=timeout,
                    )
                    os.replace(tmp, so_path)
                    with open(so_path + ".srchash", "w") as f:
                        f.write(want)
                    built = True
                    break
                except (subprocess.SubprocessError, OSError):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
            if not built and not os.path.exists(so_path):
                # no compiler at all: an existing .so is still usable
                # as a best-effort fast path
                return None
    try:
        return ctypes.CDLL(so_path)
    except OSError:
        return None


class NativeLoader:
    """Lazy, cached, non-blocking loader for one native library.

    First call compiles+loads under a lock and sets each function's
    restype to c_int; while that (up to `timeout` seconds of g++) is in
    flight, other threads get None immediately and use the pure-Python
    fallback instead of stalling on the lock.

    `funcs` must all resolve or the load fails; `optional_funcs` may be
    absent (a stale .so on a compiler-less host predating a new symbol
    keeps serving the functions it does have — per-function wrappers
    fall back to python for the missing ones).
    """

    def __init__(self, so_name: str, src_name: str,
                 funcs: Sequence[str], timeout: int = 180,
                 optional_funcs: Sequence[str] = ()):
        self.so_name = so_name
        self.src_name = src_name
        self.funcs = tuple(funcs)
        self.optional_funcs = tuple(optional_funcs)
        self.timeout = timeout
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        self._lock = threading.Lock()

    def get(self, build: bool = True) -> Optional[ctypes.CDLL]:
        """The loaded library, or None. build=False never compiles: it
        returns the library only if a previous call already loaded it —
        for callers (e.g. keccak) where a multi-second inline g++ build
        is never worth one hash."""
        if self._tried:
            return self._lib
        if not build:
            return None
        if not self._lock.acquire(blocking=False):
            return None
        try:
            if self._tried:
                return self._lib
            lib = build_or_load(self.so_name, self.src_name, self.timeout)
            if lib is not None:
                try:
                    for name in self.funcs:
                        getattr(lib, name).restype = ctypes.c_int
                    self._lib = lib
                except AttributeError:
                    self._lib = None
                for name in self.optional_funcs:
                    try:
                        getattr(lib, name).restype = ctypes.c_int
                    except AttributeError:
                        pass
            self._tried = True
            return self._lib
        finally:
            self._lock.release()


def preload_in_background() -> threading.Thread:
    """Warm all native libraries from a daemon thread so entry points
    other than the node (light proxy, tools, RPC-driven verification)
    never pay a multi-second synchronous g++ compile inline; the pure-
    Python fallbacks serve until each loader's first-use lock clears."""

    def _warm() -> None:
        from . import aead, bls_native, secp_native

        bls_native.native_lib()
        secp_native.native_lib()
        aead._native_lib()

    t = threading.Thread(target=_warm, name="native-preload", daemon=True)
    t.start()
    return t
