"""Blocksync (fast-sync) — bulk block download + batched verify-then-apply
(SURVEY.md layer 7; BASELINE config 4 lives here)."""

from .pool import BlockPool  # noqa: F401
from .reactor import BlocksyncReactor  # noqa: F401
