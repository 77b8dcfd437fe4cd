"""The verify dispatch scheduler and the fn-lane engine table.

Counterpart of ``tendermint_tpu/parallel``. The scheduler is a verbatim
copy; the device mesh is not ported (a multi-GPU slice): ``mesh_from_env``
returns None for one device and raises when the environment asks for more.
"""

from __future__ import annotations

import os

from .scheduler import (
    VerifyScheduler,
    default_dispatch,
    default_scheduler,
    set_default_scheduler,
)

_ROADMAP_MESH = "ROADMAP multi-GPU slice (kernel 13)"


def mesh_from_env():
    """None when TM_TPU_{ICI,DCN}_PARALLELISM ask for one device (the
    default); a request for more raises NotImplementedError."""
    ici = int(os.environ.get("TM_TPU_ICI_PARALLELISM", "1") or 1)
    dcn = int(os.environ.get("TM_TPU_DCN_PARALLELISM", "1") or 1)
    if ici * dcn > 1:
        raise NotImplementedError(
            f"a {ici}x{dcn} device mesh: {_ROADMAP_MESH}"
        )
    return None


__all__ = [
    "mesh_from_env",
    "VerifyScheduler",
    "default_dispatch",
    "default_scheduler",
    "set_default_scheduler",
]
