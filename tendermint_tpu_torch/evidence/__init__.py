"""Evidence subsystem: pool + gossip reactor + verification.

Reference: evidence/ (pool.go, reactor.go, verify.go). Byzantine behavior
(duplicate votes, light-client attacks) is captured, verified against
historical validator sets, gossiped, proposed into blocks, and marked
committed/expired.
"""

from .pool import EvidencePool
from .reactor import EVIDENCE_CHANNEL, EvidenceReactor
from .verify import verify_duplicate_vote, verify_light_client_attack

__all__ = [
    "EvidencePool",
    "EvidenceReactor",
    "EVIDENCE_CHANNEL",
    "verify_duplicate_vote",
    "verify_light_client_attack",
]
