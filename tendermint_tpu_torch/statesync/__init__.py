"""Statesync — snapshot-based node bootstrap.

Reference: statesync/ (syncer.go, reactor.go, chunks.go,
stateprovider.go). A fresh node discovers snapshots from peers over
channel 0x60, offers them to the local app, fetches chunks over 0x61,
and builds its consensus state from light-client-verified headers.
"""

from .chunks import ChunkQueue
from .reactor import CHUNK_CHANNEL, SNAPSHOT_CHANNEL, StateSyncReactor
from .stateprovider import LightClientStateProvider, StateProvider
from .syncer import Syncer

__all__ = [
    "ChunkQueue",
    "StateSyncReactor",
    "SNAPSHOT_CHANNEL",
    "CHUNK_CHANNEL",
    "LightClientStateProvider",
    "StateProvider",
    "Syncer",
]
