"""Carries state from the JAX package's layouts into the port's.

- Table cache: the JAX verifier's small-tier store is a pubkey -> row dict
  plus ``tables [rows, 16, 4, 32]`` canonical uint8 bytes and ``valid
  [rows]`` bool. The port keeps the same bytes, so conversion is a copy
  onto the port's device (``install_table_cache``), after which a
  ``BatchVerifier`` verifies on tables that JAX built.
- ``dbl_chain`` points: the Pallas kernel holds a batch as ``[4, 32, B]``
  float32 radix-2^8 limbs (loose: a limb may exceed 255); the port as
  ``[B, 4, 32]`` canonical uint8 bytes.

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
    """Replace `verifier`'s small-tier store with a JAX store's state
    (pubkey -> row, ``tables`` [rows, 16, 4, 32] uint8, ``valid`` [rows]);
    the store goes on building new keys with the port's kernel."""
    tables = np.asarray(tables)
    valid = np.asarray(valid)
    if tables.dtype != np.uint8 or tables.shape[1:] != (16, 4, 32):
        raise ValueError(f"tables must be [rows, 16, 4, 32] uint8, got "
                         f"{tables.shape} {tables.dtype}")
    if valid.shape != tables.shape[:1]:
        raise ValueError("valid must have one entry per table row")
    if idx and max(idx.values()) >= tables.shape[0]:
        raise ValueError("a pubkey's row lies past the table store")
    old = verifier._small
    cache = _TableCache(
        old._lock, old._build_fn, old._capacity, verifier.device,
        registry=old._registry,
    )
    cache._idx = dict(idx)
    cache.tables = torch.from_numpy(tables.copy()).to(verifier.device)
    cache.valid = torch.from_numpy(valid.astype(bool)).to(verifier.device)
    verifier._small = cache


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
