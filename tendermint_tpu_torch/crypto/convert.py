"""Carries state from the JAX package's layouts into the port's.

- Table caches: each of the JAX verifier's stores is a pubkey -> row dict
  plus canonical uint8 ``tables`` (``[rows, 16, 4, 32]`` small tier,
  ``[rows, 64, 16, 4, 32]`` big tier) and ``valid [rows]`` bool. The port
  keeps the same bytes, so conversion is a copy onto the port's device
  (``install_table_cache``), after which a ``BatchVerifier`` verifies on
  tables that JAX built.
- ``dbl_chain`` points: the Pallas kernel holds a batch as ``[4, 32, B]``
  float32 radix-2^8 limbs (loose: a limb may exceed 255); the port as
  ``[B, 4, 32]`` canonical uint8 bytes.
- BLS12-381 values: the JAX package holds an Fp element as ``[..., 48]``
  int32 radix-2^8 limbs, loose (a limb may exceed 255, the value p); G1
  points ``[B, 3, 48]``, G2 ``[B, 3, 2, 48]``, Fp12 ``[..., 6, 2, 48]``,
  pairing chunks as ``_prepare_pairs`` makes them. The port keeps the
  same shapes as canonical little-endian uint8 bytes (``bls_from_jax``,
  ``bls_to_jax``, ``bls_chunks_from_jax``).

Inputs are numpy arrays; this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field25519 as fe
from .batch_verifier import BatchVerifier, _TableCache


def install_table_cache(
    verifier: BatchVerifier, idx: dict[bytes, int], tables, valid
) -> None:
    """Replace one of `verifier`'s table stores with a JAX store's state
    (pubkey -> row, canonical uint8 ``tables``, ``valid`` [rows]): the
    small tier for ``[rows, 16, 4, 32]`` tables, the big tier for
    ``[rows, 64, 16, 4, 32]``. The store goes on building new keys with
    the port's kernel."""
    tables = np.asarray(tables)
    valid = np.asarray(valid)
    tiers = {(16, 4, 32): "_small", (64, 16, 4, 32): "_big"}
    if tables.dtype != np.uint8 or tables.shape[1:] not in tiers:
        raise ValueError(
            f"tables must be [rows, 16, 4, 32] or [rows, 64, 16, 4, 32] "
            f"uint8, got {tables.shape} {tables.dtype}"
        )
    if valid.shape != tables.shape[:1]:
        raise ValueError("valid must have one entry per table row")
    if idx and max(idx.values()) >= tables.shape[0]:
        raise ValueError("a pubkey's row lies past the table store")
    attr = tiers[tables.shape[1:]]
    old = getattr(verifier, attr)
    cache = _TableCache(
        old._lock, old._build_fn, old._entry_shape, old._capacity,
        verifier.device, registry=old._registry, tier=old._tier,
    )
    cache._idx = dict(idx)
    cache.tables = torch.from_numpy(tables.copy()).to(verifier.device)
    cache.valid = torch.from_numpy(valid.astype(bool)).to(verifier.device)
    setattr(verifier, attr, cache)


def points_from_pallas(pts: np.ndarray) -> torch.Tensor:
    """``[4, 32, B]`` float32 loose limbs -> ``[B, 4, 32]`` canonical bytes."""
    pts = np.asarray(pts)
    if pts.ndim != 3 or pts.shape[:2] != (4, 32):
        raise ValueError(f"expected [4, 32, B], got {pts.shape}")
    limbs8 = np.rint(pts).astype(np.int64)
    if not np.array_equal(limbs8, pts) or (limbs8 < 0).any():
        raise ValueError("limbs must be non-negative integers")
    l8 = torch.from_numpy(np.ascontiguousarray(limbs8.transpose(2, 0, 1)))
    return fe.to_bytes(l8[..., 0::2] + (l8[..., 1::2] << 8))


def points_to_pallas(points: torch.Tensor) -> np.ndarray:
    """``[B, 4, 32]`` uint8 bytes -> ``[4, 32, B]`` float32 limbs."""
    if points.dtype != torch.uint8 or tuple(points.shape[1:]) != (4, 32):
        raise ValueError(f"expected [B, 4, 32] uint8, got {tuple(points.shape)}")
    return np.ascontiguousarray(
        points.cpu().numpy().transpose(1, 2, 0).astype(np.float32)
    )


_BLS_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB


def bls_from_jax(limbs) -> torch.Tensor:
    """``[..., 48]`` int32 radix-2^8 limbs (loose) -> ``[..., 48]``
    canonical uint8 bytes of the value mod p."""
    arr = np.asarray(limbs)
    if arr.ndim < 1 or arr.shape[-1] != 48 or arr.dtype.kind not in "iu":
        raise ValueError(f"expected [..., 48] integer limbs, got {arr.shape} {arr.dtype}")
    if (arr < 0).any():
        raise ValueError("limbs must be non-negative")
    rows = arr.reshape(-1, 48).tolist()
    raw = b"".join(
        (sum(int(v) << (8 * i) for i, v in enumerate(r)) % _BLS_P).to_bytes(48, "little")
        for r in rows
    )
    out = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return out.reshape(arr.shape).clone()


def bls_to_jax(values: torch.Tensor) -> np.ndarray:
    """``[..., 48]`` uint8 bytes -> ``[..., 48]`` int32 limbs (canonical)."""
    if values.dtype != torch.uint8 or values.shape[-1] != 48:
        raise ValueError(f"expected [..., 48] uint8, got {tuple(values.shape)}")
    return values.cpu().numpy().astype(np.int32)


def bls_chunks_from_jax(xp, yp, xq, yq, valid) -> tuple:
    """The JAX package's ``_prepare_pairs`` arrays -> the port's chunk
    tensors for ``ops/bls_pairing.miller``."""
    return (
        bls_from_jax(xp), bls_from_jax(yp), bls_from_jax(xq), bls_from_jax(yq),
        torch.from_numpy(np.asarray(valid, dtype=bool).copy()),
    )
