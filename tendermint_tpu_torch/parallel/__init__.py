"""The verify dispatch scheduler, the fn-lane engine table and the device
mesh.

Counterpart of ``tendermint_tpu/parallel``. The scheduler is a verbatim
copy; ``mesh`` turns the ``[tpu]`` axes into the port's ``Mesh`` of CUDA
devices, whose batch axis a ``BatchVerifier`` row-shards.
"""

from .mesh import build_mesh, mesh_from_env
from .scheduler import (
    VerifyScheduler,
    default_dispatch,
    default_scheduler,
    set_default_scheduler,
)

__all__ = [
    "build_mesh",
    "mesh_from_env",
    "VerifyScheduler",
    "default_dispatch",
    "default_scheduler",
    "set_default_scheduler",
]
