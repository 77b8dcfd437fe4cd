"""Core chain types for commit verification (copies of the JAX package's,
with ValidatorSet bound to the port's BatchVerifier)."""

from .block import BlockIDFlag, Commit, CommitSig  # noqa: F401
from .block_id import BlockID  # noqa: F401
from .part_set import PartSetHeader  # noqa: F401
from .validator import Validator  # noqa: F401
from .validator_set import ValidatorSet  # noqa: F401
from .vote import Vote, VoteType  # noqa: F401
