"""Legacy Keccak-256 (Ethereum variant, 0x01 padding — NOT NIST SHA3).

The reference hashes messages with go-ethereum's crypto.Keccak256 before
mapping to the BLS12-381 G1 curve (blssignatures/bls_signatures.go:179-188
in the reference). Python's hashlib only ships NIST SHA3 (0x06 padding),
so the permutation is implemented here. Round constants and rotation
offsets are generated from the Keccak specification's LFSR / position
recurrences rather than hardcoded tables.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _gen_round_constants() -> list[int]:
    def rc_bit(t: int) -> int:
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171  # x^8 + x^6 + x^5 + x^4 + 1
        return r & 1

    consts = []
    for ir in range(24):
        c = 0
        for j in range(7):
            if rc_bit(7 * ir + j):
                c |= 1 << ((1 << j) - 1)
        consts.append(c)
    return consts


def _gen_rotations() -> list[list[int]]:
    r = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        r[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


_RC = _gen_round_constants()
_ROT = _gen_rotations()


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    """In-place keccak-f[1600] on a 25-lane state, A[x][y] = state[x + 5y]."""
    for rnd in range(24):
        # theta
        c = [
            state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(state[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK
                )
        # iota
        state[0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    # native absorb when the BLS host library is loaded (~1 us vs ~500 us
    # here); identical legacy-padding semantics, golden-tested
    try:
        from . import bls_native

        out = bls_native.keccak256(data)
        if out is not None:
            return out
    except Exception:
        pass
    return _keccak256_py(data)


def _keccak256_py(data: bytes) -> bytes:
    rate = 136  # bytes, for 256-bit output
    state = [0] * 25
    # absorb with legacy multi-rate padding 0x01 .. 0x80
    padded = data + b"\x01" + b"\x00" * ((-len(data) - 2) % rate) + b"\x80"
    if (len(data) + 1) % rate == 0:
        # single byte of padding: 0x01 | 0x80 = 0x81
        padded = data + b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f(state)
    # squeeze 32 bytes
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
