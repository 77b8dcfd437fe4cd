"""Amino-compatible JSON (reference libs/json/).

Mirrors the reference's wire rules (libs/json/doc.go):

- 64-bit integers encode as strings ("64"), 32-bit as numbers; Python
  ints are untyped so the amino default (string) applies unless a field
  is annotated `Int32`.
- bytes encode as base64; `HexBytes` as uppercase hex (its own codec).
- `datetime` encodes RFC3339Nano in UTC.
- Types registered with `register_type(cls, name)` encode wrapped:
  `{"type": "<name>", "value": <fields>}` — the amino interface
  envelope (libs/json/types.go:17-31) — and decode back to the
  registered class from the envelope alone.

The Go original drives this with reflection over struct tags; the
Python-idiomatic equivalent is dataclass introspection with type hints.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import typing
from datetime import datetime, timezone
from typing import Any, Optional, get_args, get_origin

from .bytes import HexBytes


class Int32(int):
    """Annotation marker: encode this field as a JSON number."""


_by_class: dict[type, str] = {}
_by_name: dict[str, type] = {}


def register_type(cls: type, name: str) -> None:
    """Register a class for interface-envelope encoding (types.go:23)."""
    if not name:
        raise ValueError("name cannot be empty")
    if name in _by_name and _by_name[name] is not cls:
        raise ValueError(f"type name {name!r} already registered")
    _by_class[cls] = name
    _by_name[name] = cls


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, float, str)):
        return obj
    if isinstance(obj, Int32):
        return int(obj)
    if isinstance(obj, int):
        return str(obj)  # amino: 64-bit ints as strings
    if isinstance(obj, HexBytes):
        return obj.to_json()
    if isinstance(obj, (bytes, bytearray)):
        return base64.b64encode(bytes(obj)).decode()
    if isinstance(obj, datetime):
        # naive datetimes are UTC by convention — astimezone() alone
        # would read them as LOCAL time, making the wire bytes depend
        # on the host timezone
        if obj.tzinfo is None:
            obj = obj.replace(tzinfo=timezone.utc)
        ts = obj.astimezone(timezone.utc)
        return ts.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key must be str, got {type(k)}")
            out[k] = _encode(v)
        return out
    body: Any
    if dataclasses.is_dataclass(obj):
        body = {}
        for f in dataclasses.fields(obj):
            name = f.metadata.get("json", f.name)
            if f.metadata.get("int32"):
                body[name] = int(getattr(obj, f.name))
            else:
                body[name] = _encode(getattr(obj, f.name))
    elif hasattr(obj, "to_json"):
        body = obj.to_json()
    else:
        raise TypeError(f"cannot amino-encode {type(obj)}")
    name = _by_class.get(type(obj))
    if name is not None:
        return {"type": name, "value": body}
    return body


def marshal(obj: Any) -> bytes:
    return json.dumps(_encode(obj), separators=(",", ":")).encode()


def marshal_indent(obj: Any) -> bytes:
    return json.dumps(_encode(obj), indent=2).encode()


def _decode(data: Any, hint: Optional[type]) -> Any:
    # interface envelope takes priority: registered type wins
    if (
        isinstance(data, dict)
        and set(data) == {"type", "value"}
        and data["type"] in _by_name
    ):
        cls = _by_name[data["type"]]
        return _decode_into(data["value"], cls)
    if hint is None:
        return data
    return _decode_into(data, hint)


def _decode_into(data: Any, cls: type) -> Any:
    origin = get_origin(cls)
    if origin in (list, tuple):
        (elem,) = get_args(cls) or (None,)
        seq = [_decode(v, elem) for v in (data or [])]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        _, vt = get_args(cls) or (None, None)
        return {k: _decode(v, vt) for k, v in (data or {}).items()}
    if origin is not None:  # Optional[...] and friends
        args = [a for a in get_args(cls) if a is not type(None)]
        if data is None:
            return None
        return _decode(data, args[0] if args else None)
    if cls is Any or cls is None:
        return data
    if cls in (int, Int32):
        return cls(data)
    if cls in (bool, float, str):
        return cls(data)
    if cls is HexBytes:
        return HexBytes.from_json(data)
    if cls in (bytes, bytearray):
        return cls(base64.b64decode(data))
    if cls is datetime:
        return datetime.fromisoformat(data.replace("Z", "+00:00"))
    if dataclasses.is_dataclass(cls):
        # resolve postponed annotations (`from __future__ import
        # annotations` leaves f.type as a string) so typed decoding
        # works; unresolvable hints fall back to raw values
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = {}
        kwargs = {}
        for f in dataclasses.fields(cls):
            jname = f.metadata.get("json", f.name)
            if jname in data:
                ftype = hints.get(f.name)
                if ftype is None and not isinstance(f.type, str):
                    ftype = f.type
                kwargs[f.name] = _decode(data[jname], ftype)
        return cls(**kwargs)
    if hasattr(cls, "from_json"):
        return cls.from_json(data)
    return data


def unmarshal(raw: bytes | str, cls: Optional[type] = None) -> Any:
    return _decode(json.loads(raw), cls)
