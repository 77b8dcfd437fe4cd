"""Batched ed25519 verification: CUDA kernels and their plain versions.

Counterpart of ``tendermint_tpu/ops/ed25519_batch.py``. Each function is a
wrapper that launches its hand-written kernel (``ops/csrc``) on a CUDA
tensor and runs its plain PyTorch version (``*_plain``, same signature) on
a CPU tensor. A CUDA call never runs the plain version: it launches or
raises.

- ``neg_pubkey_table``: decompress A, negate, radix-16 cached window table
  of -A as canonical bytes — the per-validator table build.
- ``verify_prehashed_table``: the small-tier verify. Unlike the JAX
  function it takes the whole table store plus per-row ``idx`` and does
  the gather of ``crypto/batch_verifier._verify_cached_small`` itself:
  rows with ``idx < 0`` (or past the store) are rejected without a read.
- ``verify_prehashed``: the generic verify, decompressing in-batch.
- ``neg_pubkey_bigtable``: the big tier's 64 x 16 fixed-window cached
  table of -A (128 KiB of canonical bytes per key).
- ``verify_prehashed_bigcache``: the big-tier verify, 64 cached adds and
  no doublings, against the whole store plus per-row ``idx``, with the
  masking of ``crypto/batch_verifier._verify_cached_big`` (``idx < 0`` or
  past the store rejects without a read).
- ``verify_prehashed_bigcache_mxu``: the same verify whose plain version
  gathers with the JAX package's one-hot float32 product (the TPU's
  matrix-unit gather). On the card it launches the same kernel as
  ``verify_prehashed_bigcache``: Hopper gathers by address, and a one-hot
  product would read cap*16 times the bytes for the same entries.
- ``verify_msgs_bigcache``: the challenges hashed on the card
  (``ops/sha512.challenge_batch``), then ``verify_prehashed_bigcache``.

Except in ``verify_msgs_bigcache``, challenges k = SHA-512(R || A || M)
mod L come from the host; the s < L mask (``s_ok``) always does. The verdict is cofactorless, per signature:
encode([s]B + [k](-A)) == R, as the host oracle and the JAX package.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ..crypto import ed25519 as host
from . import curve25519 as curve
from . import field25519 as fe
from . import sha512
from ._build import DeviceCache, launch
from ._build import check_operand as _check
from ._build import on_cuda as _on_cuda


def _make_consts(device: torch.device) -> torch.Tensor:
    vals = [host.D, (2 * host.D) % host.P, host.SQRT_M1]
    return torch.tensor(
        [list(v.to_bytes(32, "little")) for v in vals], dtype=torch.uint8
    ).to(device)


_KCONSTS = DeviceCache(_make_consts)


def kernel_consts(device: torch.device) -> torch.Tensor:
    """d, 2d, sqrt(-1) as [3, 32] canonical bytes, from the host oracle."""
    return _KCONSTS.get(device)


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
        launch("neg_pubkey_table", pubkeys, tables, valid, kernel_consts(dev))
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
        launch(
            "verify_table", tables, table_valid, idx, r_bytes, s_bytes, k_bytes,
            s_ok, curve.base_table(dev), kernel_consts(dev), out,
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
        launch(
            "verify_generic", pubkeys, r_bytes, s_bytes, k_bytes,
            s_ok, curve.base_table(dev), kernel_consts(dev), out,
        )
        verify_prehashed.launches += 1
    return out


verify_prehashed.launches = 0


# --- neg_pubkey_bigtable (big tier) ---------------------------------------


def neg_pubkey_bigtable_plain(pubkeys: torch.Tensor):
    """[N, 32] u8 -> (tables [N, 64, 16, 4, 32] u8, valid [N] bool)."""
    a_point, a_valid = curve.decompress(pubkeys)
    table = curve.big_window_table(curve.neg(a_point))
    return fe.to_bytes(table), a_valid


def neg_pubkey_bigtable(pubkeys: torch.Tensor):
    """[N, 32] u8 -> (tables [N, 64, 16, 4, 32] u8 canonical bytes,
    valid [N] bool)."""
    if not _on_cuda(pubkeys):
        return neg_pubkey_bigtable_plain(pubkeys)
    dev = pubkeys.device
    n = pubkeys.shape[0]
    _check(pubkeys, "pubkeys", torch.uint8, (n, 32), dev)
    tables = torch.empty((n, 64, 16, 4, 32), dtype=torch.uint8, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        launch("neg_pubkey_bigtable", pubkeys, tables, valid, kernel_consts(dev))
        neg_pubkey_bigtable.launches += 1
    return tables, valid


neg_pubkey_bigtable.launches = 0


# --- verify_prehashed_bigcache (big tier) ---------------------------------


def _bigcache_plain(mult, tables_cache, table_valid, idx, r_bytes, s_bytes,
                    k_bytes, s_ok):
    rows = tables_cache.shape[0]
    idx = idx.to(torch.int64)
    in_range = (idx >= 0) & (idx < rows)
    safe = torch.where(in_range, idx, torch.zeros_like(idx))
    tv = table_valid[safe] & in_range
    q = curve.add(
        curve.scalar_mult_base(s_bytes), mult(k_bytes, tables_cache, safe)
    )
    return tv & s_ok & _r_match(q, r_bytes)


def verify_prehashed_bigcache_plain(
    tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
) -> torch.Tensor:
    """tables_cache [rows, 64, 16, 4, 32] u8, table_valid [rows] bool, idx
    [B] int32, r/s/k [B, 32] u8, s_ok [B] bool -> [B] bool."""
    return _bigcache_plain(
        curve.scalar_mult_var_bigcache, tables_cache, table_valid, idx,
        r_bytes, s_bytes, k_bytes, s_ok,
    )


def verify_prehashed_bigcache_mxu_plain(
    tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
) -> torch.Tensor:
    """verify_prehashed_bigcache_plain with the one-hot float32 gather."""
    return _bigcache_plain(
        curve.scalar_mult_var_bigcache_mxu, tables_cache, table_valid, idx,
        r_bytes, s_bytes, k_bytes, s_ok,
    )


def _launch_bigcache(tables_cache, table_valid, idx, r_bytes, s_bytes,
                     k_bytes, s_ok) -> torch.Tensor:
    dev = tables_cache.device
    rows, b = tables_cache.shape[0], idx.shape[0]
    _check(tables_cache, "tables_cache", torch.uint8, (rows, 64, 16, 4, 32), dev)
    _check(table_valid, "table_valid", torch.bool, (rows,), dev)
    _check(idx, "idx", torch.int32, (b,), dev)
    for name, t in (("r_bytes", r_bytes), ("s_bytes", s_bytes), ("k_bytes", k_bytes)):
        _check(t, name, torch.uint8, (b, 32), dev)
    _check(s_ok, "s_ok", torch.bool, (b,), dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        launch(
            "verify_bigcache", tables_cache, table_valid, idx, r_bytes, s_bytes,
            k_bytes, s_ok, curve.base_table(dev), kernel_consts(dev), out,
        )
    return out


def verify_prehashed_bigcache(
    tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
) -> torch.Tensor:
    """The big-tier verify; same operands as the plain version."""
    if not _on_cuda(tables_cache):
        return verify_prehashed_bigcache_plain(
            tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
        )
    out = _launch_bigcache(
        tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
    )
    if idx.shape[0]:
        verify_prehashed_bigcache.launches += 1
    return out


verify_prehashed_bigcache.launches = 0


def verify_prehashed_bigcache_mxu(
    tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
) -> torch.Tensor:
    """The big-tier verify selected by TM_TPU_MXU_GATHER=1: the one-hot
    plain version on a CPU tensor, ``tm_verify_bigcache`` on a CUDA one
    (counted here, not under ``verify_prehashed_bigcache``)."""
    if not _on_cuda(tables_cache):
        return verify_prehashed_bigcache_mxu_plain(
            tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
        )
    out = _launch_bigcache(
        tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
    )
    if idx.shape[0]:
        verify_prehashed_bigcache_mxu.launches += 1
    return out


verify_prehashed_bigcache_mxu.launches = 0


# --- verify_msgs_bigcache (big tier, challenges on the card) ---------------


def verify_msgs_bigcache_plain(
    tables_cache, table_valid, idx, r_bytes, s_bytes, msg_buf, n_blocks, s_ok
) -> torch.Tensor:
    """msg_buf [B, NBLK*128] u8 prepadded R||A||M, n_blocks [B] int32;
    the other operands as verify_prehashed_bigcache_plain."""
    k_bytes = sha512.challenge_batch_plain(msg_buf, n_blocks)
    return verify_prehashed_bigcache_plain(
        tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
    )


def verify_msgs_bigcache(
    tables_cache, table_valid, idx, r_bytes, s_bytes, msg_buf, n_blocks, s_ok
) -> torch.Tensor:
    """``tm_challenge`` then ``tm_verify_bigcache`` on one stream (each
    counted by its own wrapper) on a CUDA tensor; the plain version on a
    CPU one."""
    if not _on_cuda(tables_cache):
        return verify_msgs_bigcache_plain(
            tables_cache, table_valid, idx, r_bytes, s_bytes, msg_buf,
            n_blocks, s_ok,
        )
    k_bytes = sha512.challenge_batch(msg_buf, n_blocks)
    return verify_prehashed_bigcache(
        tables_cache, table_valid, idx, r_bytes, s_bytes, k_bytes, s_ok
    )
