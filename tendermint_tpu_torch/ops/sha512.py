"""Batched SHA-512 and the ed25519 challenge reduction mod L.

Counterpart of ``tendermint_tpu/ops/sha512.py``: the per-signature
challenge k = SHA-512(R || A || M) mod L computed on the card for bulk
batches, instead of one host thread hashing every row.

- ``pad_messages``: host numpy padding of R || A || M rows into one
  ``[B, NBLK*128]`` buffer (NBLK a power of two) plus per-row block counts;
  a copy of the reference's.
- ``sha512_batch``: the plain PyTorch SHA-512 over such a buffer. As in the
  JAX package a 64-bit word is a (hi, lo) pair of 32-bit halves, here held
  in int64 and masked; ``>>`` is a logical shift because every half is
  non-negative.
- ``reduce_mod_l``: the exact, canonical k = digest mod L of a 64-byte
  little-endian digest (a k' = k mod L but >= L would verify differently
  on keys with a small-order component). The wrapper launches the CUDA
  reduction on a CUDA tensor and runs ``reduce_mod_l_plain`` on a CPU one.
- ``challenge_batch``: SHA-512 then the reduction, one CUDA kernel
  (``csrc/sha512_kernels.cu``, ``tm_challenge``: one lane a row, each
  warp staging its rows' blocks through shared memory with 16-byte loads,
  so ``data`` must be 16-byte aligned, as a fresh tensor is) on a CUDA
  tensor and ``challenge_batch_plain`` on a CPU one.

The JAX package's choice between a scanned and an unrolled round loop
(``TM_TPU_SHA_SCAN``) picks a trace shape for XLA and changes no result;
it has no counterpart here.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check_operand, launch, on_cuda

L = (1 << 252) + 27742317777372353535851937790883648493

M32 = 0xFFFFFFFF

_K64 = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]

_H0_64 = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]



def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _rotr64(h, l, n: int):
    if n < 32:
        return ((h >> n) | (l << (32 - n))) & M32, ((l >> n) | (h << (32 - n))) & M32
    if n == 32:
        return l, h
    m = n - 32
    return ((l >> m) | (h << (32 - m))) & M32, ((h >> m) | (l << (32 - m))) & M32


def _shr64(h, l, n: int):
    return h >> n, ((l >> n) | (h << (32 - n))) & M32  # n < 32 here


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _compress512(sh, sl, wh, wl):
    """One SHA-512 compression. sh/sl: [B, 8]; wh/wl: [B, 16] halves."""
    whs = list(wh.unbind(-1))
    wls = list(wl.unbind(-1))
    for i in range(16, 80):
        s0 = _xor3(
            _rotr64(whs[i - 15], wls[i - 15], 1),
            _rotr64(whs[i - 15], wls[i - 15], 8),
            _shr64(whs[i - 15], wls[i - 15], 7),
        )
        s1 = _xor3(
            _rotr64(whs[i - 2], wls[i - 2], 19),
            _rotr64(whs[i - 2], wls[i - 2], 61),
            _shr64(whs[i - 2], wls[i - 2], 6),
        )
        h, l = _add64(whs[i - 16], wls[i - 16], *s0)
        h, l = _add64(h, l, whs[i - 7], wls[i - 7])
        h, l = _add64(h, l, *s1)
        whs.append(h)
        wls.append(l)
    regs = [(sh[..., i], sl[..., i]) for i in range(8)]
    a, b, c, d, e, f, g, hh = regs
    for i in range(80):
        s1 = _xor3(_rotr64(*e, 14), _rotr64(*e, 18), _rotr64(*e, 41))
        ch = (
            (e[0] & f[0]) ^ ((e[0] ^ M32) & g[0]),
            (e[1] & f[1]) ^ ((e[1] ^ M32) & g[1]),
        )
        t1 = _add64(*hh, *s1)
        t1 = _add64(*t1, *ch)
        t1 = _add64(*t1, _K64[i] >> 32, _K64[i] & M32)
        t1 = _add64(*t1, whs[i], wls[i])
        s0 = _xor3(_rotr64(*a, 28), _rotr64(*a, 34), _rotr64(*a, 39))
        maj = (
            (a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
            (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]),
        )
        t2 = _add64(*s0, *maj)
        hh, g, f = g, f, e
        e = _add64(*d, *t1)
        d, c, b = c, b, a
        a = _add64(*t1, *t2)
    outs = [_add64(*o, sh[..., i], sl[..., i]) for i, o in enumerate(
        [a, b, c, d, e, f, g, hh])]
    return (torch.stack([o[0] for o in outs], -1),
            torch.stack([o[1] for o in outs], -1))


def _bytes_to_words64(blocks_u8: torch.Tensor):
    """[B, N*8] u8 big-endian -> ([B, N] hi, [B, N] lo) int64 halves."""
    b = blocks_u8.to(torch.int64).reshape(*blocks_u8.shape[:-1], -1, 8)
    hi = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    lo = (b[..., 4] << 24) | (b[..., 5] << 16) | (b[..., 6] << 8) | b[..., 7]
    return hi, lo


def sha512_batch(data: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """data: [B, NBLK*128] u8 prepadded; n_blocks: [B] int32.
    Returns [B, 64] u8 digests (big-endian words, standard encoding).
    Rows keep their state past their block count."""
    nblk = data.shape[-1] // 128
    wh, wl = _bytes_to_words64(data)
    batch = data.shape[:-1]
    sh = torch.tensor([h >> 32 for h in _H0_64], dtype=torch.int64,
                      device=data.device).expand(*batch, 8)
    sl = torch.tensor([h & M32 for h in _H0_64], dtype=torch.int64,
                      device=data.device).expand(*batch, 8)
    nb = n_blocks.to(torch.int64)
    for i in range(nblk):
        nh, nl = _compress512(
            sh, sl, wh[..., 16 * i : 16 * i + 16], wl[..., 16 * i : 16 * i + 16]
        )
        active = (i < nb)[..., None]
        sh, sl = torch.where(active, nh, sh), torch.where(active, nl, sl)
    words = torch.stack([sh, sl], -1).reshape(*batch, 16)[..., None]
    out = torch.cat([w_ >> s for w_, s in ((words, 24), (words, 16),
                                            (words, 8), (words, 0))], -1) & 0xFF
    return out.reshape(*batch, 64).to(torch.uint8)


def pad_messages(msgs: list[bytes], prefix_pairs=None) -> tuple:
    """Host helper: SHA-512 pad each message into one [B, NBLK*128]
    buffer + [B] block counts. `prefix_pairs[i]` (optional bytes) is
    prepended to msgs[i] — the verify path passes R||A per row.

    NBLK is bucketed to a power of two so the fused verify program
    compiles for a handful of shapes, not one per max-length class
    (shape discipline as in crypto/batch_verifier.BUCKETS)."""
    full = [
        (prefix_pairs[i] if prefix_pairs else b"") + m
        for i, m in enumerate(msgs)
    ]
    lens = [len(f) for f in full]
    needed = max(1, max((l + 17 + 127) // 128 for l in lens))
    nblk = 1
    while nblk < needed:
        nblk *= 2
    buf = np.zeros((len(full), nblk * 128), dtype=np.uint8)
    counts = np.zeros(len(full), dtype=np.int32)
    for i, f in enumerate(full):
        l = len(f)
        buf[i, :l] = np.frombuffer(f, dtype=np.uint8)
        buf[i, l] = 0x80
        blocks = (l + 17 + 127) // 128
        bits = l * 8
        buf[i, blocks * 128 - 8 : blocks * 128] = np.frombuffer(
            bits.to_bytes(8, "big"), dtype=np.uint8
        )
        counts[i] = blocks
    return buf, counts


# --- reduction mod L -------------------------------------------------------

NLIMBS = 32


def _limbs_of(x: int, n: int = NLIMBS) -> list[int]:
    return list(x.to_bytes(n, "little"))


# T[i] = 2^(8*(32+i)) mod L as 32 radix-2^8 limbs: the fold table for bytes
# 32.. of a little-endian integer
_T_FOLD = np.array(
    [_limbs_of(pow(2, 8 * (32 + i), L)) for i in range(NLIMBS)], dtype=np.int64
)
_L_LIMBS = np.array(_limbs_of(L), dtype=np.int64)


def _scan_carry(x: torch.Tensor):
    """Exact base-256 carry over the limb axis (signed-safe: >> on int64
    is a floor division by 256). Returns (limbs, carry out of the top)."""
    out = []
    carry = torch.zeros_like(x[..., 0])
    for limb in x.unbind(-1):
        v = limb + carry
        carry = v >> 8
        out.append(v - (carry << 8))
    return torch.stack(out, -1), carry


def reduce_mod_l_plain(digest: torch.Tensor) -> torch.Tensor:
    """[B, 64] u8 digest (little-endian integer) -> [B, 32] u8 canonical
    digest mod L; the JAX package's byte-fold algorithm."""
    d = digest.to(torch.int64)
    lo, hi = d[..., :NLIMBS], d[..., NLIMBS:]
    t = torch.from_numpy(_T_FOLD).to(d.device)
    l_l = torch.from_numpy(_L_LIMBS).to(d.device)
    # value(lo) + hi @ T, as a broadcast product (no int64 matmul on CUDA)
    acc = lo + (hi[..., :, None] * t).sum(-2)
    # normalize and fold the carry out of 2^256 until it dies (8 rounds
    # cover the worst case, as in the reference)
    for _ in range(8):
        limbs, top = _scan_carry(acc)
        acc = limbs + top[..., None] * t[0]
    limbs, _ = _scan_carry(acc)
    # value < 2^256: subtract (top nibble - 1) * L, then L once more if
    # still >= L (big-endian compare)
    q = (limbs[..., 31] >> 4).sub(1).clamp(min=0)
    limbs, _ = _scan_carry(limbs - q[..., None] * l_l)
    diff = limbs - l_l
    nz = diff != 0
    first = (NLIMBS - 1) - nz.flip(-1).to(torch.int64).argmax(-1, keepdim=True)
    ms = diff.gather(-1, first).squeeze(-1)
    geq = torch.where(nz.any(-1), ms > 0, torch.ones_like(ms, dtype=torch.bool))
    limbs, _ = _scan_carry(limbs - geq[..., None].to(torch.int64) * l_l)
    return limbs.to(torch.uint8)


def reduce_mod_l(digest: torch.Tensor) -> torch.Tensor:
    """The reduction alone: ``tm_reduce_mod_l`` on a CUDA tensor, the plain
    version on a CPU one. [B, 64] u8 -> [B, 32] u8."""
    if not on_cuda(digest):
        return reduce_mod_l_plain(digest)
    b = digest.shape[0]
    check_operand(digest, "digest", torch.uint8, (b, 64), digest.device)
    out = torch.empty((b, 32), dtype=torch.uint8, device=digest.device)
    if b:
        launch("reduce_mod_l", digest, out)
        reduce_mod_l.launches += 1
    return out


reduce_mod_l.launches = 0


def challenge_batch_plain(data: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """Prepadded R||A||M buffers [B, NBLK*128] u8 and block counts [B]
    int32 -> [B, 32] u8 canonical k = SHA-512(R||A||M) mod L."""
    return reduce_mod_l_plain(sha512_batch(data, n_blocks))


def challenge_batch(data: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """The fused challenge: ``tm_challenge`` on a CUDA tensor, the plain
    version on a CPU one; same operands and result."""
    if not on_cuda(data):
        return challenge_batch_plain(data, n_blocks)
    dev = data.device
    b, width = data.shape[0], data.shape[-1]
    if data.dim() != 2 or width % 128 or width == 0:
        raise ValueError(
            f"data must be [B, NBLK*128] with NBLK >= 1, got {tuple(data.shape)}"
        )
    check_operand(data, "data", torch.uint8, (b, width), dev)
    check_operand(n_blocks, "n_blocks", torch.int32, (b,), dev)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned (the kernel reads "
                         "16-byte pieces)")
    out = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    if b:
        launch("challenge", data, n_blocks, out)
        challenge_batch.launches += 1
    return out


challenge_batch.launches = 0
