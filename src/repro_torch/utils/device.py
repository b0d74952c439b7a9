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


def fp32_products() -> None:
    """The reference's f32 products are full f32 and its bf16 products sum
    in f32; on the card that means TF32 off and no reduced-precision bf16
    reductions in cuBLAS (process-wide settings)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
