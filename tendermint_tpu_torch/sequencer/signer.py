"""Sequencer signer + verifier ports.

Reference: sequencer/interfaces.go:17-29 — `Signer` (Sign(data),
Address(), IsActiveSequencer()) and `SequencerVerifier`
(IsSequencer(addr)). The reference signs with go-ethereum ECDSA
(recoverable, 65 bytes) over the 32-byte block hash.
"""

from __future__ import annotations

from typing import Iterable, Protocol, runtime_checkable

from ..crypto import secp256k1


class ErrInvalidSignature(Exception):
    """Block signature verification failed (sequencer/interfaces.go:12)."""


@runtime_checkable
class Signer(Protocol):
    def sign(self, data: bytes) -> bytes: ...

    def address(self) -> bytes: ...

    def is_active_sequencer(self) -> bool: ...


@runtime_checkable
class SequencerVerifier(Protocol):
    def is_sequencer(self, addr: bytes) -> bool: ...


class LocalSigner:
    """In-process secp256k1 signer (the reference's production signer talks
    to an external keystore; tests and single-binary deployments use this)."""

    def __init__(self, priv: secp256k1.PrivKey, active: bool = True):
        self._priv = priv
        self._active = active
        pt = secp256k1.decompress_point(priv.public_key().data)
        self._address = secp256k1.eth_address(pt)

    def sign(self, data: bytes) -> bytes:
        return secp256k1.eth_sign(data, self._priv.secret)

    def address(self) -> bytes:
        return self._address

    def is_active_sequencer(self) -> bool:
        return self._active


class StaticSequencerVerifier:
    """Fixed allow-list verifier (the reference resolves sequencers from an
    L1 contract; the port is the same `IsSequencer(addr)` question)."""

    def __init__(self, addresses: Iterable[bytes]):
        self._allowed = {bytes(a) for a in addresses}

    def is_sequencer(self, addr: bytes) -> bool:
        return bytes(addr) in self._allowed
