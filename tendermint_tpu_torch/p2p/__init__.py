"""P2P layer (SURVEY.md layer 6, reference p2p/ ~9k LoC): encrypted
authenticated transport, multiplexed connections, peer lifecycle, PEX."""

from .key import NodeKey  # noqa: F401
from .node_info import NodeInfo  # noqa: F401
