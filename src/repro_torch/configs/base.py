"""Architecture specs: full config, reduced config and the input-shape set
each arch supports (the port of ``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import ModelConfig

# The assigned input-shape set (all LM archs share it; long_500k only for
# sub-quadratic archs).
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}

ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
QUADRATIC_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig            # the published full-size config
    reduced: ModelConfig           # same family, CPU-smoke-test sized
    shapes: tuple                  # supported shape ids
    notes: str = ""
    momentum_dtype: Any = torch.float32
    center_dtype: Any = torch.float32
    train_microbatches: int = 8

    def supports(self, shape_id: str) -> bool:
        return shape_id in self.shapes
