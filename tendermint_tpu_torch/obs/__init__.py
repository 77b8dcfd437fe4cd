"""Observability: the span tracer, as much of it as the verifier uses."""

from .tracer import default_tracer

__all__ = ["default_tracer"]
