"""Light client (SURVEY.md layer 9): header verification by trust
propagation with bisection; BASELINE config 5's workload."""

from .types import LightBlock  # noqa: F401
from .verifier import verify_adjacent, verify_non_adjacent  # noqa: F401
from .client import LightClient, TrustOptions  # noqa: F401
