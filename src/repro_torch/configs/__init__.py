"""Architecture registry (the port of ``repro/configs/__init__.py``).

The registry knows every arch id of the reference, and all ten are
ported: the dense, audio, vision-language, SSM, hybrid and MoE families
(grok-1-314b, and deepseek-v2-236b with MLA).
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, gemma3_4b, gemma3_27b,
                                 grok1_314b, mamba2_780m, musicgen_medium,
                                 phi3_mini, qwen2_vl_72b, qwen15_4b,
                                 recurrentgemma_2b)
from repro_torch.configs.base import (ALL_SHAPES, QUADRATIC_SHAPES, SHAPES,
                                      ArchSpec)

ARCH_IDS = ("gemma3-4b", "qwen1.5-4b", "phi3-mini-3.8b", "gemma3-27b",
            "qwen2-vl-72b", "mamba2-780m", "musicgen-medium",
            "recurrentgemma-2b", "grok-1-314b", "deepseek-v2-236b")

ARCHS = {spec.arch_id: spec
         for spec in (gemma3_4b.SPEC, qwen15_4b.SPEC, phi3_mini.SPEC,
                      gemma3_27b.SPEC, qwen2_vl_72b.SPEC, mamba2_780m.SPEC,
                      musicgen_medium.SPEC, recurrentgemma_2b.SPEC,
                      grok1_314b.SPEC, deepseek_v2_236b.SPEC)}

__all__ = ["ALL_SHAPES", "ARCHS", "ARCH_IDS", "ArchSpec", "QUADRATIC_SHAPES",
           "SHAPES", "get"]


def get(arch_id: str) -> ArchSpec:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    raise ValueError(f"unknown arch '{arch_id}'; have: {sorted(ARCH_IDS)}")
