"""Batched SHA-256 and the RFC 6962 merkle hashes on the card.

Counterpart of ``tendermint_tpu/ops/sha256.py``: the leaf hashes of a
block's transactions (thousands of rows of ragged length) as one batch
instead of one host thread hashing every leaf.

- ``pad_messages``: host numpy padding of ``prefix + m`` rows into one
  ``[B, NBLK*64]`` buffer plus per-row block counts; byte for byte the
  JAX package's buffers, with one slice copy per row and the 0x80
  markers and length fields of all rows set at once.
- ``sha256_batch_plain``: the plain PyTorch SHA-256 over such a buffer,
  each 32-bit word held in an int64 lane and masked (``>>`` is a logical
  shift because every word is non-negative), as ``ops/sha512.py`` holds
  64-bit words. Rows keep their state past their block count.
- ``sha256_batch``: the wrapper; ``tm_sha256`` (``csrc/sha256_kernels.cu``,
  a lane a row, each warp's blocks staged in shared memory, so ``data``
  must be 16-byte aligned, as a fresh tensor is) on CUDA tensors, the
  plain version on CPU ones. It counts its launches in
  ``sha256_batch.launches``.
- ``merkle_leaf_hash``, ``merkle_inner_hash``, ``merkle_root_pow2``: the
  RFC 6962 domain-separated hashes (leaf 0x00, inner 0x01), each a
  buffer built on the tensor's device and one ``sha256_batch`` call per
  level, so a device-built tree equals the host tree byte for byte.

The JAX package's choice between a scanned and an unrolled round loop
(``TM_TPU_SHA_SCAN``) picks a trace shape for XLA and changes no result;
it has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check_operand, launch, on_cuda

M32 = 0xFFFFFFFF

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, w16):
    """One SHA-256 compression. state: [B, 8]; w16: [B, 16] words."""
    w = list(w16.unbind(-1))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + _K[i] + w[i]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + s0 + maj) & M32
    return (state + torch.stack([a, b, c, d, e, f, g, h], -1)) & M32


def sha256_batch_plain(data: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """data: [B, NBLK*64] u8 prepadded; n_blocks: [B] int32.
    Returns [B, 32] u8 digests (big-endian words, the standard encoding)."""
    nblk = data.shape[-1] // 64
    by = data.to(torch.int64).reshape(*data.shape[:-1], -1, 4)
    words = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]
    state = torch.tensor(_H0, dtype=torch.int64, device=data.device).expand(
        *data.shape[:-1], 8
    )
    nb = n_blocks.to(torch.int64)
    for i in range(nblk):
        new = _compress(state, words[..., 16 * i : 16 * i + 16])
        state = torch.where((i < nb)[..., None], new, state)
    w = state[..., None]
    out = torch.cat([w >> 24, w >> 16, w >> 8, w], -1) & 0xFF
    return out.reshape(*data.shape[:-1], 32).to(torch.uint8)


def sha256_batch(data: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """``tm_sha256`` on a CUDA tensor, ``sha256_batch_plain`` on a CPU one;
    same operands and result."""
    if not on_cuda(data):
        return sha256_batch_plain(data, n_blocks)
    dev = data.device
    b, width = data.shape[0], data.shape[-1]
    if data.dim() != 2 or width % 64 or width == 0:
        raise ValueError(
            f"data must be [B, NBLK*64] with NBLK >= 1, got {tuple(data.shape)}"
        )
    check_operand(data, "data", torch.uint8, (b, width), dev)
    check_operand(n_blocks, "n_blocks", torch.int32, (b,), dev)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned (the kernel reads "
                         "16-byte pieces)")
    out = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    if b:
        launch("sha256", data, n_blocks, out)
        sha256_batch.launches += 1
    return out


sha256_batch.launches = 0


def pad_messages(msgs: list[bytes], prefix: bytes = b"") -> tuple:
    """Host helper: SHA-256 pad ``prefix + m`` for each m into one
    [B, NBLK*64] uint8 buffer + [B] int32 block counts (NBLK the longest
    row's blocks). Byte for byte the JAX package's ``pad_messages``."""
    n = len(msgs)
    lens = np.array([len(prefix) + len(m) for m in msgs], dtype=np.int64)
    blocks = (lens + 9 + 63) // 64
    nblk = max(1, int(blocks.max())) if n else 1
    buf = np.zeros((n, nblk * 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        buf[i, : lens[i]] = np.frombuffer(prefix + m, dtype=np.uint8)
    rows = np.arange(n)
    buf[rows, lens] = 0x80
    # the bit length, big-endian, in the last 8 bytes of the row's blocks
    bits = (lens * 8).astype(">u8").view(np.uint8).reshape(n, 8)
    buf[rows[:, None], blocks[:, None] * 64 - 8 + np.arange(8)] = bits
    return buf, blocks.astype(np.int32)


# --- RFC 6962 merkle on the device -----------------------------------------


def _length_block(total: int, device) -> torch.Tensor:
    """The last 8 bytes of a padded message of `total` bytes."""
    return torch.tensor(list((total * 8).to_bytes(8, "big")), dtype=torch.uint8,
                        device=device)


def merkle_leaf_hash(leaves: torch.Tensor) -> torch.Tensor:
    """[B, N] u8 fixed-size leaves -> [B, 32] u8 SHA-256(0x00 || leaf)
    (the host tree's leaf rule; one block, so N <= 54)."""
    b, n = leaves.shape
    total = 1 + n
    if total + 9 > 64:
        raise ValueError(f"leaves of {n} bytes do not fit one block (at most 54)")
    buf = torch.zeros((b, 64), dtype=torch.uint8, device=leaves.device)
    buf[:, 1 : 1 + n] = leaves
    buf[:, total] = 0x80
    buf[:, 56:64] = _length_block(total, leaves.device)
    return sha256_batch(buf, torch.ones(b, dtype=torch.int32, device=leaves.device))


def merkle_inner_hash(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[B, 32] x [B, 32] -> [B, 32] SHA-256(0x01 || l || r) (2 blocks)."""
    b = left.shape[0]
    buf = torch.zeros((b, 128), dtype=torch.uint8, device=left.device)
    buf[:, 0] = 1
    buf[:, 1:33] = left
    buf[:, 33:65] = right
    buf[:, 65] = 0x80
    buf[:, 120:128] = _length_block(65, left.device)
    return sha256_batch(buf, torch.full((b,), 2, dtype=torch.int32, device=left.device))


def merkle_root_pow2(leaves: torch.Tensor) -> torch.Tensor:
    """The RFC 6962 root of a power-of-two batch of fixed-size leaves:
    [B, N] u8 -> [32] u8, one leaf launch and log2(B) inner levels (the
    unbalanced general case stays on the host in crypto/merkle.py)."""
    b = leaves.shape[0]
    if b == 0 or b & (b - 1):
        raise ValueError(f"the device tree needs a power-of-two leaf count, got {b}")
    level = merkle_leaf_hash(leaves)
    while level.shape[0] > 1:
        level = merkle_inner_hash(level[0::2], level[1::2])
    return level[0]
