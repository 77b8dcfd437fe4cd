"""ctypes loader for the native BLS12-381 host library.

native/bls12_381.cpp re-implements crypto/bls12_381.py's exact
construction (same flat-sextic tower, same wire format) in C++ with
Montgomery 6x64 arithmetic — the framework's native equivalent of the
reference's Go kilic dependency (blssignatures/bls_signatures.go imports;
SURVEY.md §7.1 budgeted this host fast path). ~10x over the pure-Python
pairing on this box.

All entry points return None when the library is unavailable (no
compiler); callers fall back to the pure-Python path. In the port this
library takes the JAX package's host routes: pairing checks
(crypto/bls_signatures._pairing_is_one calls pairing_check unless
TM_TPU_BLS_PAIRING_DEVICE=1 sends them to the port's Miller-loop and
final-exponentiation kernels), the aggregation sums of two or more points
(aggregate_signatures, aggregate_public_keys; the named *_device sums, and
every sum without this library, run on the port's device, ops/bls_g1 and
ops/bls_g2), subgroup checks, the field inversion and square root of
hash-to-G1, and the random-coefficient scalar multiplications.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from ._native_build import NativeLoader

_loader = NativeLoader(
    "_tmbls.so",
    "bls12_381.cpp",
    funcs=(
        "tmbls_pairing_check",
        "tmbls_g1_mul",
        "tmbls_g2_mul",
        "tmbls_g1_msm",
        "tmbls_g2_msm",
        "tmbls_g1_check",
        "tmbls_g2_check",
    ),
    # late additions: a stale .so without these keeps its core functions
    optional_funcs=(
        "tmbls_fp_inv48",
        "tmbls_fp_sqrt48",
        "tmbls_keccak256",
    ),
)


def native_lib(build: bool = True) -> Optional[ctypes.CDLL]:
    lib = _loader.get(build=build)
    if lib is not None and not getattr(lib, "_tm_argtypes_set", False):
        # declare size_t counts explicitly — default ctypes int conversion
        # truncates through c_int, corrupting lengths >= 2^31
        cp, sz = ctypes.c_char_p, ctypes.c_size_t
        lib.tmbls_pairing_check.argtypes = [cp, cp, sz]
        lib.tmbls_g1_msm.argtypes = [cp, cp, cp, sz]
        lib.tmbls_g2_msm.argtypes = [cp, cp, cp, sz]
        lib._tm_argtypes_set = True
    return lib


def pairing_check(g1s: bytes, g2s: bytes, n: int) -> Optional[bool]:
    """prod e(P_i, Q_i) == 1 over wire-format point arrays; None = no lib,
    raises ValueError on malformed points (callers validated already)."""
    lib = native_lib()
    if lib is None:
        return None
    rc = lib.tmbls_pairing_check(g1s, g2s, n)
    if rc < 0:
        raise ValueError("malformed point passed to native pairing")
    return bool(rc)


def g1_mul(point96: bytes, scalar32: bytes) -> Optional[bytes]:
    lib = native_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(96)
    if lib.tmbls_g1_mul(out, point96, scalar32) < 0:
        raise ValueError("malformed G1 point")
    return out.raw


def g2_mul(point192: bytes, scalar32: bytes) -> Optional[bytes]:
    lib = native_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(192)
    if lib.tmbls_g2_mul(out, point192, scalar32) < 0:
        raise ValueError("malformed G2 point")
    return out.raw


def g1_msm(points: bytes, scalars: Optional[bytes], n: int) -> Optional[bytes]:
    """sum k_i * P_i (scalars None => plain sum). Wire-format in/out."""
    lib = native_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(96)
    if lib.tmbls_g1_msm(out, points, scalars, n) < 0:
        raise ValueError("malformed G1 point in MSM")
    return out.raw


def g2_msm(points: bytes, scalars: Optional[bytes], n: int) -> Optional[bytes]:
    lib = native_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(192)
    if lib.tmbls_g2_msm(out, points, scalars, n) < 0:
        raise ValueError("malformed G2 point in MSM")
    return out.raw


def fp_inv48(v48: bytes) -> Optional[bytes]:
    """a^-1 mod p over 48-byte BE; inv(0) = 0 (matching pow(0, p-2, p));
    None = no library; raises on non-canonical input."""
    lib = native_lib()
    if lib is None or not hasattr(lib, "tmbls_fp_inv48"):
        return None
    out = ctypes.create_string_buffer(48)
    rc = lib.tmbls_fp_inv48(out, v48)
    if rc < 0:
        raise ValueError("fp_inv48: input not a canonical field element")
    if rc == 0:
        return b"\x00" * 48
    return out.raw


def fp_sqrt48(v48: bytes) -> Optional[bytes]:
    """sqrt mod p over 48-byte BE; b"" = non-square; None = no library."""
    lib = native_lib()
    if lib is None or not hasattr(lib, "tmbls_fp_sqrt48"):
        return None
    out = ctypes.create_string_buffer(48)
    rc = lib.tmbls_fp_sqrt48(out, v48)
    if rc < 0:
        raise ValueError("fp_sqrt48: input not a canonical field element")
    if rc == 0:
        return b""
    return out.raw


def keccak256(data: bytes) -> Optional[bytes]:
    """build=False: hashing must never pay an inline g++ build — general
    hash callers (ethutil, address derivation, CLI tools) get the fast
    path only once the library is loaded (node/light preload, or any
    prior BLS operation)."""
    lib = native_lib(build=False)
    if lib is None or not hasattr(lib, "tmbls_keccak256"):
        return None
    fn = lib.tmbls_keccak256
    if fn.argtypes is None:
        # without argtypes ctypes would truncate len(data) through c_int,
        # silently corrupting the length for >= 2 GiB inputs
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    out = ctypes.create_string_buffer(32)
    fn(out, data, len(data))
    return out.raw


def g1_check(point96: bytes) -> Optional[bool]:
    """on-curve + subgroup; None = no lib; False = bad subgroup;
    raises on malformed encoding."""
    lib = native_lib()
    if lib is None:
        return None
    rc = lib.tmbls_g1_check(point96)
    if rc < 0:
        raise ValueError("malformed G1 encoding")
    return bool(rc)


def g2_check(point192: bytes) -> Optional[bool]:
    lib = native_lib()
    if lib is None:
        return None
    rc = lib.tmbls_g2_check(point192)
    if rc < 0:
        raise ValueError("malformed G2 encoding")
    return bool(rc)
