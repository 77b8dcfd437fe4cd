"""Batched ed25519 verification: CUDA kernels and their plain versions.

Counterpart of ``tendermint_tpu/ops/ed25519_batch.py``. Three functions,
each a wrapper that launches its hand-written kernel (``ops/csrc``) on a
CUDA tensor and runs its plain PyTorch version (``*_plain``, same
signature) on a CPU tensor. A CUDA call never runs the plain version: it
launches or raises.

- ``neg_pubkey_table``: decompress A, negate, radix-16 cached window table
  of -A as canonical bytes — the per-validator table build.
- ``verify_prehashed_table``: the small-tier verify. Unlike the JAX
  function it takes the whole table store plus per-row ``idx`` and does
  the gather of ``crypto/batch_verifier._verify_cached_small`` itself:
  rows with ``idx < 0`` (or past the store) are rejected without a read.
- ``verify_prehashed``: the generic verify, decompressing in-batch.

Challenges k = SHA-512(R || A || M) mod L and the s < L mask (``s_ok``)
come from the host. The verdict is cofactorless, per signature:
encode([s]B + [k](-A)) == R, as the host oracle and the JAX package.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ..crypto import ed25519 as host
from . import curve25519 as curve
from . import field25519 as fe
from ._build import kernels, stream_of

_KCONSTS: dict[tuple[str, int | None], torch.Tensor] = {}


def kernel_consts(device: torch.device) -> torch.Tensor:
    """d, 2d, sqrt(-1) as [3, 32] canonical bytes, from the host oracle."""
    key = (device.type, device.index)
    t = _KCONSTS.get(key)
    if t is None:
        vals = [host.D, (2 * host.D) % host.P, host.SQRT_M1]
        t = torch.tensor(
            [list(v.to_bytes(32, "little")) for v in vals], dtype=torch.uint8
        ).to(device)
        _KCONSTS[key] = t
    return t


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _r_match(q: torch.Tensor, r_bytes: torch.Tensor) -> torch.Tensor:
    return (curve.compress(q) == r_bytes).all(-1)


# --- neg_pubkey_table ---------------------------------------------------


def neg_pubkey_table_plain(pubkeys: torch.Tensor):
    """[N, 32] u8 -> (tables [N, 16, 4, 32] u8, valid [N] bool)."""
    a_point, a_valid = curve.decompress(pubkeys)
    table = curve.window_table(curve.neg(a_point))
    return fe.to_bytes(table), a_valid


def neg_pubkey_table(pubkeys: torch.Tensor):
    """[N, 32] u8 -> (tables [N, 16, 4, 32] u8 canonical bytes, valid [N])."""
    if not _on_cuda(pubkeys):
        return neg_pubkey_table_plain(pubkeys)
    dev = pubkeys.device
    n = pubkeys.shape[0]
    _check(pubkeys, "pubkeys", torch.uint8, (n, 32), dev)
    tables = torch.empty((n, 16, 4, 32), dtype=torch.uint8, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        kernels().neg_pubkey_table(
            pubkeys, tables, valid, kernel_consts(dev), stream_of(pubkeys)
        )
        neg_pubkey_table.launches += 1
    return tables, valid


neg_pubkey_table.launches = 0


# --- verify_prehashed_table (small tier) --------------------------------


def verify_prehashed_table_plain(
    tables, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
) -> torch.Tensor:
    """tables [rows, 16, 4, 32] u8, table_valid [rows] bool, idx [B] int32,
    r/s/k [B, 32] u8, s_ok [B] bool -> [B] bool."""
    rows = tables.shape[0]
    idx = idx.to(torch.int64)
    in_range = (idx >= 0) & (idx < rows)
    safe = torch.where(in_range, idx, torch.zeros_like(idx))
    tv = table_valid[safe] & in_range
    t = fe.from_bytes(tables[safe])
    q = curve.double_scalar_mult_base_table(s_bytes, k_bytes, t)
    return tv & s_ok & _r_match(q, r_bytes)


def verify_prehashed_table(
    tables, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
) -> torch.Tensor:
    """The cached-pubkey verify; same operands as the plain version."""
    if not _on_cuda(tables):
        return verify_prehashed_table_plain(
            tables, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
        )
    dev = tables.device
    rows, b = tables.shape[0], idx.shape[0]
    _check(tables, "tables", torch.uint8, (rows, 16, 4, 32), dev)
    _check(table_valid, "table_valid", torch.bool, (rows,), dev)
    _check(idx, "idx", torch.int32, (b,), dev)
    for name, t in (("r_bytes", r_bytes), ("s_bytes", s_bytes), ("k_bytes", k_bytes)):
        _check(t, name, torch.uint8, (b, 32), dev)
    _check(s_ok, "s_ok", torch.bool, (b,), dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        kernels().verify_table(
            tables, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok,
            curve.base_table(dev), kernel_consts(dev), out, stream_of(tables),
        )
        verify_prehashed_table.launches += 1
    return out


verify_prehashed_table.launches = 0


# --- verify_prehashed (generic) -----------------------------------------


def verify_prehashed_plain(pubkeys, r_bytes, s_bytes, k_bytes, s_ok):
    """pubkeys/r/s/k [B, 32] u8, s_ok [B] bool -> [B] bool."""
    a_point, a_valid = curve.decompress(pubkeys)
    q = curve.double_scalar_mult_base(s_bytes, k_bytes, curve.neg(a_point))
    return a_valid & s_ok & _r_match(q, r_bytes)


def verify_prehashed(pubkeys, r_bytes, s_bytes, k_bytes, s_ok) -> torch.Tensor:
    """The generic verify (no table cache); same operands as the plain
    version."""
    if not _on_cuda(pubkeys):
        return verify_prehashed_plain(pubkeys, r_bytes, s_bytes, k_bytes, s_ok)
    dev = pubkeys.device
    b = pubkeys.shape[0]
    for name, t in (
        ("pubkeys", pubkeys), ("r_bytes", r_bytes), ("s_bytes", s_bytes),
        ("k_bytes", k_bytes),
    ):
        _check(t, name, torch.uint8, (b, 32), dev)
    _check(s_ok, "s_ok", torch.bool, (b,), dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        kernels().verify_generic(
            pubkeys, r_bytes, s_bytes, k_bytes, s_ok, curve.base_table(dev),
            kernel_consts(dev), out, stream_of(pubkeys),
        )
        verify_prehashed.launches += 1
    return out


verify_prehashed.launches = 0
