"""State layer: the replicated state value, its durable store, and the
block executor (SURVEY.md layer 4 + the app/execution bridge glue)."""

from .state import State  # noqa: F401
from .store import StateStore  # noqa: F401
