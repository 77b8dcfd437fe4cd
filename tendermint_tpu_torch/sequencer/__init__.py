"""Sequencer mode — post-upgrade centralized block production.

Reference: sequencer/ (state_v2.go, broadcast_reactor.go, block_cache.go,
pending_cache.go, hash_set.go, interfaces.go). At UpgradeBlockHeight the
node stops BFT consensus and switches to this mode: a single sequencer
produces ECDSA-signed BlockV2 blocks on a timer, gossips them over a
dedicated channel pair, and followers verify-recover the signer address
and apply.
"""

from .caches import BlockRingBuffer, HashSet, PeerHashSet, PendingBlockCache
from .signer import LocalSigner, StaticSequencerVerifier
from .state_v2 import StateV2
from .verify import SequencerVerifyBatcher
from .broadcast_reactor import (
    BLOCK_BROADCAST_CHANNEL,
    SEQUENCER_SYNC_CHANNEL,
    BlockBroadcastReactor,
)

__all__ = [
    "BlockRingBuffer",
    "HashSet",
    "PeerHashSet",
    "PendingBlockCache",
    "LocalSigner",
    "StaticSequencerVerifier",
    "SequencerVerifyBatcher",
    "StateV2",
    "BlockBroadcastReactor",
    "BLOCK_BROADCAST_CHANNEL",
    "SEQUENCER_SYNC_CHANNEL",
]
