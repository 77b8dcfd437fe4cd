"""Protobuf wire primitives + varint-delimited framing.

Reference: libs/protoio (305 LoC) — varint length-delimited proto framing
used for sign-bytes (`MarshalDelimited`, types/vote.go:95) and the p2p /
privval / abci wire. This framework does not use generated protobuf code;
messages are hand-encoded with these primitives, which keeps the canonical
sign-bytes byte-for-byte well defined (spec/core/encoding.md in the
reference) without a codegen step.
"""

from __future__ import annotations

import struct
from io import BytesIO

# --- varints --------------------------------------------------------------


def write_uvarint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uvarint must be non-negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_varint(n: int) -> bytes:
    """Protobuf zigzag-less signed varint (two's complement, 10 bytes max)."""
    return write_uvarint(n & 0xFFFFFFFFFFFFFFFF) if n < 0 else write_uvarint(n)


def read_uvarint(buf: BytesIO) -> int:
    shift = 0
    result = 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise EOFError("truncated uvarint")
        b = raw[0]
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result
        shift += 7
        if shift > 70:
            raise ValueError("uvarint too long")


# --- protobuf field encoding ----------------------------------------------

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5


def tag(field_num: int, wire_type: int) -> bytes:
    return write_uvarint((field_num << 3) | wire_type)


def field_varint(field_num: int, value: int) -> bytes:
    """Encodes 0 as absent (proto3 default), like the reference encoders."""
    if value == 0:
        return b""
    return tag(field_num, WIRE_VARINT) + write_varint(value)


def field_bytes(field_num: int, value: bytes) -> bytes:
    if not value:
        return b""
    return tag(field_num, WIRE_BYTES) + write_uvarint(len(value)) + value


def field_message(field_num: int, encoded: bytes) -> bytes:
    """Embedded message: length-delimited even when empty body is meaningful
    — callers decide whether to emit empty messages."""
    return tag(field_num, WIRE_BYTES) + write_uvarint(len(encoded)) + encoded


def field_sfixed64(field_num: int, value: int) -> bytes:
    return tag(field_num, WIRE_FIXED64) + struct.pack("<q", value)


# --- delimited framing (MarshalDelimited / protoio.Writer) ----------------


def marshal_delimited(payload: bytes) -> bytes:
    """Length-prefixed message — the exact shape of reference sign-bytes
    (types/vote.go:95-103: protoio.MarshalDelimited of the canonical proto)."""
    return write_uvarint(len(payload)) + payload


def read_delimited(buf: BytesIO, max_size: int = 1 << 22) -> bytes:
    n = read_uvarint(buf)
    if n > max_size:
        raise ValueError(f"delimited message too large: {n}")
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated delimited message")
    return data


# --- minimal decoder ------------------------------------------------------


def iter_fields(data: bytes):
    """Yields (field_num, wire_type, value) — ints for varint/fixed, bytes
    for length-delimited. Enough to decode our own hand-encoded messages."""
    buf = BytesIO(data)
    while buf.tell() < len(data):
        t = read_uvarint(buf)
        fnum, wt = t >> 3, t & 7
        if wt == WIRE_VARINT:
            yield fnum, wt, read_uvarint(buf)
        elif wt == WIRE_BYTES:
            n = read_uvarint(buf)
            # a 10-byte uvarint encodes up to 2^70: bound-check BEFORE
            # read(n) or a hostile length raises OverflowError/MemoryError
            # instead of a clean decode failure (wire fuzz finding)
            if n > len(data):
                raise EOFError("bytes field length exceeds buffer")
            chunk = buf.read(n)
            if len(chunk) != n:
                raise EOFError("truncated bytes field")
            yield fnum, wt, chunk
        elif wt == WIRE_FIXED64:
            chunk = buf.read(8)
            if len(chunk) != 8:
                raise EOFError("truncated fixed64 field")
            yield fnum, wt, struct.unpack("<q", chunk)[0]  # sfixed64 signed
        elif wt == WIRE_FIXED32:
            chunk = buf.read(4)
            if len(chunk) != 4:
                raise EOFError("truncated fixed32 field")
            yield fnum, wt, struct.unpack("<I", chunk)[0]
        else:
            raise ValueError(f"unsupported wire type {wt}")


def decode_fields(data: bytes) -> dict[int, list]:
    out: dict[int, list] = {}
    for fnum, _, val in iter_fields(data):
        out.setdefault(fnum, []).append(val)
    return out
