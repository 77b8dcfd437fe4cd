"""ABCI — the application/consensus bridge (SURVEY.md layer 5).

Reference: abci/ (~20k LoC, mostly generated protobuf). Here the protocol
is a Python Protocol class plus dataclass request/responses; clients come
in local (in-proc, the reference's local_client.go) and socket (asyncio,
the reference's socket_client.go pipelined pair of routines) flavors.
"""

from .types import (  # noqa: F401
    Application,
    BaseApplication,
    Event,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseInfo,
    ResponseInitChain,
    ResponseQuery,
    Snapshot,
    ValidatorUpdate,
)
