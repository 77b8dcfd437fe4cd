"""Merlin transcripts over STROBE-128 (host side).

The sr25519 signature scheme (schnorrkel) binds all signing/verification
state into a Merlin transcript. The reference consumes this through
ChainSafe/go-schnorrkel (crypto/sr25519/pubkey.go:51 in the reference);
here it is implemented from the STROBE-128 / Merlin specifications on top
of the repo's keccak-f[1600] permutation (crypto/keccak.py).

Validated against the published Merlin conformance vector ("test protocol"
/ "some label" / "some data" — tests/test_sr25519.py).
"""

from __future__ import annotations

import struct

from .keccak import _keccak_f

_R = 166  # STROBE-128 rate (200 - 2*16/8*... per spec: N - (2*sec)/8 - 2)

_FLAG_I = 1
_FLAG_A = 2
_FLAG_C = 4
_FLAG_T = 8
_FLAG_M = 16
_FLAG_K = 32


def _bytes_to_lanes(b: bytearray) -> list[int]:
    return [
        int.from_bytes(b[8 * i : 8 * i + 8], "little") for i in range(25)
    ]


def _lanes_to_bytes(lanes: list[int]) -> bytearray:
    out = bytearray(200)
    for i, v in enumerate(lanes):
        out[8 * i : 8 * i + 8] = v.to_bytes(8, "little")
    return out


class Strobe128:
    """Minimal STROBE-128 duplex: exactly the subset Merlin uses
    (meta-AD / AD / PRF / KEY), matching merlin's strobe.rs."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        lanes = _bytes_to_lanes(st)
        _keccak_f(lanes)
        self._state = _lanes_to_bytes(lanes)
        self._pos = 0
        self._pos_begin = 0
        self._cur_flags = 0
        self.meta_ad(protocol_label, False)

    # --- sponge plumbing --------------------------------------------------

    def _run_f(self) -> None:
        self._state[self._pos] ^= self._pos_begin
        self._state[self._pos + 1] ^= 0x04
        self._state[_R + 1] ^= 0x80
        lanes = _bytes_to_lanes(self._state)
        _keccak_f(lanes)
        self._state = _lanes_to_bytes(lanes)
        self._pos = 0
        self._pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self._state[self._pos] ^= byte
            self._pos += 1
            if self._pos == _R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self._state[self._pos] = byte
            self._pos += 1
            if self._pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self._state[self._pos])
            self._state[self._pos] = 0
            self._pos += 1
            if self._pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self._cur_flags:
                raise ValueError("flag mismatch in continued operation")
            return
        if flags & _FLAG_T:
            raise ValueError("transport operations unsupported")
        old_begin = self._pos_begin
        self._pos_begin = self._pos + 1
        self._cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_FLAG_C | _FLAG_K) and self._pos != 0:
            self._run_f()

    # --- operations -------------------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)


class Transcript:
    """Merlin transcript: labeled absorb/challenge over Strobe128."""

    def __init__(self, label: bytes):
        self._strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", len(message)), True)
        self._strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", n), True)
        return self._strobe.prf(n)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        s = Strobe128.__new__(Strobe128)
        s._state = bytearray(self._strobe._state)
        s._pos = self._strobe._pos
        s._pos_begin = self._strobe._pos_begin
        s._cur_flags = self._strobe._cur_flags
        t._strobe = s
        return t
