"""Observability: the span tracer and the device-cost ledger, as much of
them as the verifier and the dispatch scheduler use."""

from .ledger import DispatchLedger, default_ledger, set_default_ledger
from .tracer import default_tracer

__all__ = [
    "DispatchLedger",
    "default_ledger",
    "default_tracer",
    "set_default_ledger",
]
