"""Resolve and check the device an entry point runs on.

Every entry point of the port takes ``device``. ``None`` means the card:
the port is written for one NVIDIA H100, and a run that silently landed on
the CPU would report CPU numbers under the card's name. So a missing GPU
without an explicit ``device="cpu"`` raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` / ``"cuda"`` / ``"cuda:i"`` / ``"cpu"`` / a ``torch.device``
    -> a checked ``torch.device``. Raises ``RuntimeError`` for a CUDA device
    when no GPU is visible, ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
