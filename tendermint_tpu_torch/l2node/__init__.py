"""L2 execution-node bridge (SURVEY.md layer 5, the morph fork's defining
delta: no mempool — transactions are pulled from the L2 node).

Reference: l2node/l2node.go:13-117 (L2Node + Batcher), notifier.go:25-107
(the txNotifier that wakes consensus), mock.go:22-41 (MockL2Node).
"""

from .l2node import BlockData, BlsData, L2Node  # noqa: F401
from .mock import MockL2Node  # noqa: F401
from .notifier import Notifier  # noqa: F401
