"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``; the default is ``"cuda"``.
Without a usable GPU that default raises — the port never carries on on
the CPU unless the caller asked for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch.device to run on; raises if CUDA is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tendermint_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
