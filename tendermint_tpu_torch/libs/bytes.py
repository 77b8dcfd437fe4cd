"""HexBytes — bytes with upper-hex JSON form (reference libs/bytes/bytes.go).

The reference encodes binary fields (hashes, addresses) as uppercase hex
strings in JSON (`MarshalJSON`, bytes.go:24-31) and accepts hex back.
"""

from __future__ import annotations


class HexBytes(bytes):
    """bytes subclass whose string/JSON form is uppercase hex."""

    def __str__(self) -> str:  # reference String(), bytes.go:55
        return self.hex().upper()

    def __repr__(self) -> str:
        return f"HexBytes({self.hex().upper()})"

    def to_json(self) -> str:
        return self.hex().upper()

    @classmethod
    def from_json(cls, s: str) -> "HexBytes":
        return cls(bytes.fromhex(s))

    def fingerprint(self) -> "HexBytes":
        """First 6 bytes, zero-padded (reference Fingerprint, byteslice.go)."""
        return HexBytes((bytes(self) + b"\x00" * 6)[:6])
