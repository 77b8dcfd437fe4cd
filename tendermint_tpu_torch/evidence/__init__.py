"""Evidence verification (the pool and the gossip reactor come with the
bulk consumers).

Reference: evidence/verify.go. Duplicate-vote and light-client-attack
evidence is verified against historical validator sets on the port's
batch verifier.
"""

from .verify import verify_duplicate_vote, verify_light_client_attack

__all__ = [
    "verify_duplicate_vote",
    "verify_light_client_attack",
]
