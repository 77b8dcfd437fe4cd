"""Observability: the span tracer and the device-cost ledger, as much of
them as the verifier, the dispatch scheduler and the verify service use."""

from .ledger import DispatchLedger, default_ledger, set_default_ledger
from .tracer import Tracer, default_tracer, set_default_tracer

__all__ = [
    "DispatchLedger",
    "Tracer",
    "default_ledger",
    "default_tracer",
    "set_default_ledger",
    "set_default_tracer",
]
