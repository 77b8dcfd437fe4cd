"""Batched edwards25519 group arithmetic in plain PyTorch.

Counterpart of ``tendermint_tpu/ops/curve25519.py`` and the reference for
the CUDA kernels' curve code. A point is ``[..., 4, 16] int64``: extended
homogeneous (X, Y, Z, T), each a field element of ``field25519``. Addends
use the cached form (Y-X, Y+X, 2d*T, 2Z); addition is add-2008-hwcd-3 and
doubling the ref10 ``ge_p2_dbl`` shape, with the same operation order as
the JAX package, so projective coordinates (and hence the canonical table
bytes of ``window_table``) agree with it value for value mod p.

Constants (d, 2d, sqrt(-1)) and the 32 x 256 basepoint table are built
from the host oracle ``crypto/ed25519.py``. The big tier's per-key
64 x 16 fixed-window tables (``big_window_table``) make a variable-base
multiplication 64 cached adds with no doublings; the gather from a shared
store has two forms, an index (``scalar_mult_var_bigcache``) and the JAX
package's one-hot float32 product (``scalar_mult_var_bigcache_mxu``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..crypto import ed25519 as host
from . import field25519 as fe
from ._build import DeviceCache

NLIMBS = fe.NLIMBS
D = host.D
D2 = (2 * host.D) % host.P
SQRT_M1 = host.SQRT_M1


def _split(p: torch.Tensor):
    return p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]


def identity(shape=(), device="cpu") -> torch.Tensor:
    z = torch.zeros((*shape, 4, NLIMBS), dtype=torch.int64, device=device)
    z[..., 1, 0] = 1
    z[..., 2, 0] = 1
    return z


def neg(p: torch.Tensor) -> torch.Tensor:
    x, y, z, t = _split(p)
    return torch.stack([fe.neg(x), y, z, fe.neg(t)], dim=-2)


def to_cached(p: torch.Tensor) -> torch.Tensor:
    """Extended -> cached (Y-X, Y+X, 2d*T, 2Z)."""
    x, y, z, t = _split(p)
    k = torch.stack(
        [fe.constant(D2, device=p.device), fe.constant(2, device=p.device)]
    )
    td2_z2 = fe.mul(torch.stack([t, z], dim=-2), k)
    return torch.stack(
        [fe.sub(y, x), fe.add(y, x), td2_z2[..., 0, :], td2_z2[..., 1, :]],
        dim=-2,
    )


def add_cached(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Complete unified addition p + c, c in cached form (2 packed muls)."""
    x1, y1, z1, t1 = _split(p)
    lhs = torch.stack([fe.sub(y1, x1), fe.add(y1, x1), t1, z1], dim=-2)
    a, b, cc, d = _split(fe.mul(lhs, c))
    e = fe.sub(b, a)
    f = fe.sub(d, cc)
    g = fe.add(d, cc)
    h = fe.add(b, a)
    lo = torch.stack([e, g, f, e], dim=-2)
    hi = torch.stack([f, h, g, h], dim=-2)
    return fe.mul(lo, hi)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return add_cached(p, to_cached(q))


def double(p: torch.Tensor) -> torch.Tensor:
    """Dedicated doubling; the formula of the Pallas ``dbl_chain`` too."""
    x1, y1, z1, _ = _split(p)
    sq_in = torch.stack([x1, y1, z1, fe.add(x1, y1)], dim=-2)
    xx, yy, zz, aa = _split(fe.mul(sq_in, sq_in))
    y3 = fe.add(yy, xx)
    z3 = fe.sub(yy, xx)
    x3 = fe.sub(aa, y3)
    t3 = fe.sub(fe.mul_small(zz, 2), z3)
    lo = torch.stack([x3, y3, z3, x3], dim=-2)
    hi = torch.stack([t3, z3, t3, y3], dim=-2)
    return fe.mul(lo, hi)


def compress(p: torch.Tensor) -> torch.Tensor:
    """Canonical 32-byte encoding, y with sign(x) on bit 255. [..., 32] u8.

    One Fermat inversion per point; Z = 0 inverts to 0, so such rows
    encode as all-zero bytes, as the JAX package's ``invert_many`` gives."""
    x, y, z, _ = _split(p)
    zinv = fe.invert(z)
    xy = fe.mul(torch.stack([x, y], dim=-2), zinv.unsqueeze(-2))
    xa = fe.canonical(xy[..., 0, :])
    ya = fe.canonical(xy[..., 1, :]).clone()
    ya[..., -1] += (xa[..., 0] & 1) << 15
    return torch.stack([ya & 0xFF, ya >> 8], dim=-1).flatten(-2).to(torch.uint8)


def _lt_p(y_bytes: torch.Tensor) -> torch.Tensor:
    """[..., 32] int64 bytes (bit 255 clear) -> y < p, as a big-endian
    compare against p's bytes."""
    p_bytes = torch.tensor(
        list(host.P.to_bytes(32, "little")), dtype=torch.int64,
        device=y_bytes.device,
    )
    diff = (y_bytes - p_bytes).flip(-1)  # most significant first
    nz = diff != 0
    first = nz.to(torch.int64).argmax(-1, keepdim=True)
    ms = diff.gather(-1, first).squeeze(-1)
    return nz.any(-1) & (ms < 0)


def decompress(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 32] uint8 -> (point [..., 4, 16], valid [...] bool).

    Rejects y >= p, x^2 without a square root, and x = 0 with the sign bit
    set — the host oracle's ``_recover_x``. Invalid rows still carry the
    point the formulas give, as in the JAX package, so table bytes built
    from them agree too."""
    bi = b.to(torch.int64)
    sign = bi[..., 31] >> 7
    yb = bi.clone()
    yb[..., 31] &= 0x7F
    y_lt_p = _lt_p(yb)
    y = fe.from_bytes(yb)
    one = fe.ones(y.shape[:-1], device=b.device)
    yy = fe.sqr(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.constant(D, device=b.device)), one)
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))
    vx2 = fe.mul(v, fe.sqr(x))
    ok_direct = fe.eq(vx2, u)
    ok_flipped = fe.eq(vx2, fe.neg(u))
    x = fe.select(ok_flipped, fe.mul(x, fe.constant(SQRT_M1, device=b.device)), x)
    has_root = ok_direct | ok_flipped
    x_is_zero = fe.is_zero(x)
    sign_ok = ~(x_is_zero & (sign == 1))
    x = fe.select((fe.parity(x) != sign) & ~x_is_zero, fe.neg(x), x)
    valid = y_lt_p & has_root & sign_ok
    pt = torch.stack([x, y, one, fe.mul(x, y)], dim=-2)
    return pt, valid


def nibbles(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """[..., 32] u8 little-endian -> [..., 64] int64 radix-16 digits, LSB
    first."""
    s = scalar_bytes.to(torch.int64)
    return torch.stack([s & 15, s >> 4], dim=-1).flatten(-2)


def window_table(p: torch.Tensor) -> torch.Tensor:
    """cached(0, P, 2P, ..., 15P) as [..., 16, 4, 16]; 14 adds + to_cached."""
    pc = to_cached(p)
    entries = [identity(p.shape[:-2], device=p.device), p]
    for _ in range(14):
        entries.append(add_cached(entries[-1], pc))
    return to_cached(torch.stack(entries, dim=-3))


def _select_entry(table: torch.Tensor, dig: torch.Tensor) -> torch.Tensor:
    """table [..., 16, 4, L], dig [...] in [0, 16) -> [..., 4, L]."""
    i = dig[..., None, None, None].expand(*dig.shape, 1, *table.shape[-2:])
    return table.gather(-3, i).squeeze(-3)


def from_host_point_cached(p: host.Point) -> np.ndarray:
    """Host extended point -> cached form as [4, 32] canonical bytes."""
    x, y, z, t = p
    P = host.P
    vals = [(y - x) % P, (y + x) % P, t * D2 % P, 2 * z % P]
    return np.array([list(v.to_bytes(32, "little")) for v in vals], np.uint8)


_BASE_TABLE_NP: np.ndarray | None = None
_BASE_TABLE_LOCK = threading.Lock()


def base_table_bytes() -> np.ndarray:
    """T[i, j] = cached([j * 256^i]B) as [32, 256, 4, 32] uint8 (host, once).

    The same host point chain as the JAX package, so entries agree with it
    byte for byte; the CUDA kernels read it from device memory."""
    global _BASE_TABLE_NP
    with _BASE_TABLE_LOCK:
        if _BASE_TABLE_NP is None:
            rows = []
            base = host.BASEPOINT
            for _ in range(32):
                row = [host.IDENTITY]
                for _ in range(255):
                    row.append(host.point_add(row[-1], base))
                rows.append([from_host_point_cached(p) for p in row])
                for _ in range(8):
                    base = host.point_double(base)
            _BASE_TABLE_NP = np.asarray(rows, dtype=np.uint8)
    return _BASE_TABLE_NP


_BASE_TABLES = DeviceCache(lambda dev: torch.from_numpy(base_table_bytes()).to(dev))


def base_table(device) -> torch.Tensor:
    """The basepoint table as a [32, 256, 4, 32] uint8 tensor on `device`."""
    return _BASE_TABLES.get(device)


def scalar_mult_base(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """[s]B for s: [..., 32] u8: 32 cached adds over the byte-digit rows."""
    table = base_table(scalar_bytes.device)
    digs = scalar_bytes.to(torch.int64)
    acc = identity(digs.shape[:-1], device=digs.device)
    for i in range(32):
        entry = fe.from_bytes(table[i][digs[..., i]])
        acc = add_cached(acc, entry)
    return acc


def scalar_mult_var_table(
    scalar_bytes: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """[s]P from a cached window table ([..., 16, 4, 16] limbs), 4-bit
    windows MSB first: 64 x (4 doublings + 1 cached add)."""
    digs = nibbles(scalar_bytes)
    acc = identity(digs.shape[:-1], device=digs.device)
    for i in range(63, -1, -1):
        acc = double(double(double(double(acc))))
        acc = add_cached(acc, _select_entry(table, digs[..., i]))
    return acc


def double_scalar_mult_base(
    s_bytes: torch.Tensor, k_bytes: torch.Tensor, a: torch.Tensor
) -> torch.Tensor:
    """[s]B + [k]A."""
    return double_scalar_mult_base_table(s_bytes, k_bytes, window_table(a))


def double_scalar_mult_base_table(
    s_bytes: torch.Tensor, k_bytes: torch.Tensor, a_table: torch.Tensor
) -> torch.Tensor:
    """[s]B + [k]A with A's window table prebuilt."""
    return add(scalar_mult_base(s_bytes), scalar_mult_var_table(k_bytes, a_table))


def big_window_table(p: torch.Tensor) -> torch.Tensor:
    """T[i, j] = cached([j * 16^i]P) as [..., 64, 16, 4, 16].

    The JAX package's operation order, so the projective values (and the
    canonical bytes the big-tier store keeps) agree with it: row 0 is
    0, P, then 14 adds of P; each step emits to_cached(row) before four
    doublings of the whole row; the last row is emitted after step 63."""
    entries = [identity(p.shape[:-2], device=p.device), p]
    for _ in range(14):
        entries.append(add(entries[-1], p))
    row = torch.stack(entries, dim=-3)
    rows = []
    for _ in range(63):
        rows.append(to_cached(row))
        row = double(double(double(double(row))))
    rows.append(to_cached(row))
    return torch.stack(rows, dim=-4)


def scalar_mult_var_bigtable(
    scalar_bytes: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """[s]P from a fixed-window table [..., 64, 16, 4, 16]: 64 cached adds,
    radix-16 digits LSB first, no doublings."""
    digs = nibbles(scalar_bytes)
    acc = identity(digs.shape[:-1], device=digs.device)
    for i in range(64):
        acc = add_cached(acc, _select_entry(table[..., i, :, :, :], digs[..., i]))
    return acc


def scalar_mult_var_bigcache(
    scalar_bytes: torch.Tensor, tables_cache: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """[s] T[idx] against a shared store of canonical bytes
    ([cap, 64, 16, 4, 32] u8, idx [B] in range): one entry gathered per
    window, never the whole 128 KiB table of a row."""
    digs = nibbles(scalar_bytes)
    idx = idx.to(torch.int64)
    acc = identity(digs.shape[:-1], device=digs.device)
    for i in range(64):
        acc = add_cached(acc, fe.from_bytes(tables_cache[idx, i, digs[:, i]]))
    return acc


def scalar_mult_var_bigcache_mxu(
    scalar_bytes: torch.Tensor, tables_cache: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """scalar_mult_var_bigcache with each window's gather written as the
    JAX package writes it for the TPU's matrix unit: a [B, cap*16] one-hot
    float32 matrix times the window's [cap*16, 128] table bytes. Exact in
    float32: one product of 1.0 and a byte (< 2^8) per output."""
    digs = nibbles(scalar_bytes)
    idx = idx.to(torch.int64)
    cap = tables_cache.shape[0]
    flat = tables_cache.to(torch.float32).reshape(cap, 64, 16, 128)
    cols = torch.arange(cap * 16, device=digs.device)
    acc = identity(digs.shape[:-1], device=digs.device)
    for i in range(64):
        tab_w = flat[:, i].reshape(cap * 16, 128)
        sel = idx * 16 + digs[:, i]
        onehot = (sel[:, None] == cols[None, :]).to(torch.float32)
        ent = (onehot @ tab_w).to(torch.int64).reshape(-1, 4, 32)
        acc = add_cached(acc, fe.from_bytes(ent))
    return acc
