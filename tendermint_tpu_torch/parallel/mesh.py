"""Build the verification mesh from config, and run row-sharded launches.

Counterpart of ``tendermint_tpu/parallel/mesh.py``. ``[tpu]
ici_parallelism`` / ``dcn_parallelism`` (exported as
``TM_TPU_{ICI,DCN}_PARALLELISM``; ``[scheduler] mesh_enable`` exports
``ici=0``) pick how many cards the batch axis of every verify round
shards over, and the process-wide ``default_verifier()`` builds its mesh
from them. ``ici=0`` means every visible device, divided by ``dcn``.

``Mesh`` stands in for ``jax.sharding.Mesh``: an ndarray of
``torch.device``s (``devices``) with ``axis_names`` and ``shape`` (axis
name -> size). A 1-axis ``("batch",)`` mesh for one host; a 2-axis
``("dcn", "batch")`` mesh of contiguous rows when ``dcn > 1`` (one
process holds every device here; a dcn axis across hosts is node
assembly's, with ``torch.distributed``). Consumers shard over every axis
major-to-minor, so both layouts read as ``devices.flat``.

Backends: ``"cuda"`` (the default, also ``""``) is
``torch.cuda.device_count()`` real cards, never repeated; ``"cpu"`` is
``CPU_MESH_DEVICES`` entries of the CPU device, the counterpart of the
JAX tests' 8 virtual host devices (``--xla_force_host_platform_device_count=8``).
A ``Mesh`` built by hand may repeat a device (8 shards on ``cuda:0``):
every line of the sharded path then runs on one card.

``shard_rows`` is the row-sharded launch the verify families and the
sharded secp256k1 launch share: split, copy, launch every shard, then
gather the results to the host in shard order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# the "cpu" backend's device count: the JAX tests' virtual host devices
CPU_MESH_DEVICES = 8


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ndarray of torch devices with one name per axis."""

    def __init__(self, devices, axis_names=("batch",)):
        grid = np.array(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [_device(d) for d in grid.flat]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(
                f"mesh of shape {grid.shape} with axes {self.axis_names}"
            )
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _backend_devices(mesh_backend: str = "") -> list[torch.device]:
    """The visible devices of a mesh backend."""
    if mesh_backend in ("", "cuda"):
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if mesh_backend == "cpu":
        return [torch.device("cpu")] * CPU_MESH_DEVICES
    raise ValueError(f"unknown mesh backend {mesh_backend!r}")


def build_mesh(
    ici_parallelism: int = 1,
    dcn_parallelism: int = 1,
    mesh_backend: str = "",
):
    """Mesh per the [tpu] config section, or None for the 1-device path.

    ici_parallelism=0 means every visible device of the backend (divided
    by dcn_parallelism when > 1). Raises if the device count cannot
    satisfy the requested axes: a silently smaller mesh would hide a
    deployment error."""
    devs = _backend_devices(mesh_backend)
    ici = ici_parallelism
    dcn = dcn_parallelism
    if ici == 0:
        ici = max(1, len(devs) // dcn)
    if ici * dcn <= 1:
        return None
    if len(devs) < ici * dcn:
        raise ValueError(
            f"[tpu] mesh wants {ici}x{dcn} devices, backend "
            f"{mesh_backend or 'cuda'} has {len(devs)}"
        )
    if dcn == 1:
        return Mesh(devs[:ici], ("batch",))
    flat = devs[: ici * dcn]
    return Mesh(
        [flat[i * ici : (i + 1) * ici] for i in range(dcn)], ("dcn", "batch")
    )


def mesh_from_env():
    """Mesh from TM_TPU_{ICI,DCN}_PARALLELISM / TM_TPU_MESH_BACKEND, the
    env mirror of the [tpu] config section."""
    ici = int(os.environ.get("TM_TPU_ICI_PARALLELISM", "1") or 1)
    dcn = int(os.environ.get("TM_TPU_DCN_PARALLELISM", "1") or 1)
    backend = os.environ.get("TM_TPU_MESH_BACKEND", "")
    if ici == 1 and dcn == 1:
        return None
    return build_mesh(ici, dcn, backend)


def shard_rows(fn, devices, arrays, replicated=None) -> np.ndarray:
    """Row-sharded launch of a kernel wrapper.

    Each of `arrays` (numpy, [b, ...], b a multiple of the shard count)
    is split into equal chunks, chunk i copied to ``devices[i]`` (a list,
    or a ``Mesh`` read major-to-minor). ``fn(*replicated(dev), *chunks)``
    then runs once per shard, every shard launched before any result is
    read, and the per-shard results are gathered to the host in shard
    order. ``replicated(dev)`` gives the operands every shard reads whole
    (the table store's copy on that device)."""
    if isinstance(devices, Mesh):
        devices = list(devices.devices.flat)
    n = len(devices)
    b = arrays[0].shape[0]
    if b % n:
        raise ValueError(f"{b} rows do not split over {n} shards")
    c = b // n
    shards = [
        [torch.from_numpy(a[i * c : (i + 1) * c]).to(d) for a in arrays]
        for i, d in enumerate(devices)
    ]
    outs = [
        fn(*(replicated(d) if replicated else ()), *chunks)
        for d, chunks in zip(devices, shards)
    ]
    return np.concatenate([o.cpu().numpy() for o in outs])
